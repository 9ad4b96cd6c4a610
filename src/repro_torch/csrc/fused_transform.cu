// fused_transform.fused_bucketize: every bucketize column in one launch.
// out[i] = the number of boundaries of value i's own column that are <= v,
// v = vals[i], the column's boundaries being bounds[lo : hi] (sorted
// ascending) with lo = offs[norm(c)], hi = offs[norm(c + 1)], c = cids[i]:
// right-open bins, the index within the column, as int64, 0 where hi <= lo.
// norm(i) = clamp(i + (C + 1 if i < 0 else 0), 0, C) is how jnp indexes the
// (C+1,) offsets, so a column id outside [0, C) gives the reference's answer.
//
// Replaces the TPU kernel repro/kernels/fused_transform/fused_transform.py::
// fused_bucketize_padded (_kernel), which streams (TR, 128) value tiles
// through the VPU, keeps the whole boundary table in VMEM and runs a
// branch-free binary search with a fixed trip count, so a tile advances in
// lock step.
//
// Bound on H100: bytes. A value costs 16 B of traffic (4 B value, 4 B
// column id, 8 B result) against about log2(column width) compares, so the
// least time is N * 16 B (+ the table, read once) over 3.35 TB/s: 6.3 us at
// the MSE step's 1.3 M values, 1 us at the operator benchmark's 200,000.
// At such sizes one DRAM round trip, the launch ramp and any wait on the
// L2 are a large part of the time. What the earlier kernel lost: every
// block copied the whole table into shared memory before it looked at a
// value (11 MB of L2 reads for 3.2 MB of work at the operator shape), and
// each thread had one value's loads in flight at a time. The design:
//
// - A thread owns 4 consecutive values of a tile of 1,024 and issues their
//   loads together, 16 bytes of values and 16 of column ids, and stores
//   the results 16 bytes at a time. Values or ids at an address off a
//   16-byte boundary (a view), and the tile that N cuts short, are read and
//   written element by element.
// - A table of at most 1,024 words (C + 1 offsets and B boundaries; the MSE
//   model's 361) is staged whole by every block: eight blocks an SM stride
//   over the tiles, so it is read once a block, not once a tile, and
//   nothing waits on a reduction first (fused_bucketize_kernel_whole).
// - Any other table (the operator benchmark's 3,694 words): a block takes
//   one tile. It stages the C + 1 offsets (at most 1,024) while its loads
//   are in flight, then reduces the least and greatest boundary its values
//   read (warp __reduce_min/max_sync, then shared memory) and stages the
//   boundaries between them where they fit 1,024 words: one round trip to
//   the L2 once the values are in. The engine lays each column's values
//   out contiguously, so that is one or two columns (at most 126
//   boundaries at the operator shape). A tile whose boundaries do not fit
//   (ids in any order) reads them through the read-only cache: the staged
//   path and the cached path. Staging the whole table for such a tile, as
//   the earlier kernel did, measured slower than the cache (PERF.md).
// - Lock-step search: each warp runs ceil(log2(w + 1)) halvings, w the
//   widest column among its lanes' values, so every lane of a warp runs the
//   same count (a width-0 column gives 0); the trip count needs nothing
//   from the host. The halving is the TPU kernel's, branch-free, its index
//   clamped into the staged (or whole) table so it never reads outside it;
//   a thread's 4 searches advance together, independent, so their reads
//   overlap. Every block writes its own values: no atomics, two launches
//   are bit-equal.
// - Each launch records on the card which paths its blocks ran (a flag a
//   path, spread over 32 copies so that no one line takes every block's
//   store); repro_bucketize_path_launches counts them on the C side.
//
// The compare is `v >= b`, as there: a value equal to a boundary goes
// right, -inf gives 0, +inf the column's width, NaN 0 (every compare is
// false), and -0.0 compares equal to 0.0. Subnormal values and boundaries
// compare as zero, as XLA (on the CPU, where the reference's tests run) and
// the TPU compare them: the kernel flushes them itself as it loads or
// stages them, so its answer does not depend on the build's -ftz setting.
// Offsets are read clamped into [0, B], so no input makes it read outside
// the table.
#include <cuda_runtime.h>

#include <cfloat>
#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kV = 4;                // consecutive values a thread takes from a tile
constexpr int64_t kTile = static_cast<int64_t>(kThreads) * kV;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kStageWords = 1024;    // a block's staging room: the whole table, or offsets and boundaries
constexpr int kFlagSlots = 4096;     // launches whose paths the card records between two reads
constexpr int kFlagLanes = 32;       // flag copies, so that blocks storing one flag spread over the L2

// which paths each launch ran: [block % kFlagLanes][launch serial %
// kFlagSlots][staged, cached], set to 1 by the blocks that ran them (plain
// stores of one value; a copy a block lane, so no one line takes every
// block's store)
__device__ uint8_t g_path_flag[kFlagLanes][kFlagSlots][2];
int64_t g_serial = 0;                 // launches so far
int64_t g_read = 0;                   // launches whose flags were counted
int64_t g_path_launches[2] = {0, 0};  // launches that ran the staged, the cached path

__device__ __forceinline__ float flush_subnormal(float x) {
  return fabsf(x) < FLT_MIN ? 0.0f : x;  // NaN and the infinities pass
}

// the entry of the (C+1,) offsets that jnp's offsets[i] reads
__device__ __forceinline__ int offset_index(int64_t i, int C) {
  if (i < 0) i += C + 1;
  return static_cast<int>(i < 0 ? 0 : (i > C ? C : i));
}

__device__ __forceinline__ int clamp_to(int x, int lo, int hi) { return min(max(x, lo), hi); }

// one thread's kV consecutive values of a tile and their column ids
struct Chunk {
  float v[kV];
  int c[kV];
};

// every load of a chunk at once: kFast (the chunk lies below N, the
// pointers 16-byte aligned) two 16-byte loads, else the n values below N
// element by element
template <bool kFast>
__device__ __forceinline__ void load_chunk(Chunk& ch, const float* __restrict__ vals, const int32_t* __restrict__ cids,
                                           int64_t i0, int n) {
  if (kFast) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(vals + i0));
    const int4 ci = __ldg(reinterpret_cast<const int4*>(cids + i0));
    ch.v[0] = a.x, ch.v[1] = a.y, ch.v[2] = a.z, ch.v[3] = a.w;
    ch.c[0] = ci.x, ch.c[1] = ci.y, ch.c[2] = ci.z, ch.c[3] = ci.w;
  } else {
#pragma unroll
    for (int j = 0; j < kV; ++j) {
      ch.v[j] = j < n ? __ldg(vals + i0 + j) : 0.0f;
      ch.c[j] = j < n ? __ldg(cids + i0 + j) : 0;
    }
  }
}

// one halving of the TPU kernel for each of a thread's kV searches;
// kStaged reads the block's staged boundaries, else the table through the
// read-only cache. The index is clamped to `last`, so it never leaves them.
template <bool kStaged>
__device__ __forceinline__ void halve(int (&lo)[kV], int (&hi)[kV], const float (&v)[kV], const float* b, int last) {
#pragma unroll
  for (int j = 0; j < kV; ++j) {
    const int mid = static_cast<int>((static_cast<unsigned>(lo[j]) + static_cast<unsigned>(hi[j])) >> 1);
    const int at = min(mid, last);
    const float bnd = kStaged ? b[at] : flush_subnormal(__ldg(b + at));
    const bool right = (mid < hi[j]) & (v[j] >= bnd);
    lo[j] = right ? mid + 1 : lo[j];
    hi[j] = right ? hi[j] : min(mid, hi[j]);
  }
}

// The range [lo, hi) of each of a chunk's values, 0 where it is empty:
// offsets from shared memory (kSmem, already clamped) or through the
// read-only cache; the least lo and the greatest hi of the non-empty ones.
template <bool kSmem, bool kFast>
__device__ __forceinline__ void ranges(const Chunk& ch, int n, const int32_t* o, int B, int C, int (&lo)[kV],
                                       int (&hi)[kV], int& need_lo, int& need_hi) {
#pragma unroll
  for (int j = 0; j < kV; ++j) {
    int l = 0, h = 0;
    if (kFast || j < n) {
      const int e0 = offset_index(ch.c[j], C), e1 = offset_index(static_cast<int64_t>(ch.c[j]) + 1, C);
      l = kSmem ? o[e0] : clamp_to(__ldg(o + e0), 0, B);
      h = kSmem ? o[e1] : clamp_to(__ldg(o + e1), 0, B);
    }
    if (h <= l) l = h = 0;  // an empty range reads nothing
    else need_lo = min(need_lo, l), need_hi = max(need_hi, h);
    lo[j] = l, hi[j] = h;
  }
}

// Search a chunk and store its buckets (kFast as load_chunk; else the n
// values below N), given each value's range [lo, hi) of boundaries: a
// lock-step search, its trip count from the warp's widest column, over
// the boundaries from index `base` on (b[k] is boundary base + k: staged
// in shared memory where kStaged, else read through the read-only cache).
template <bool kStaged, bool kFast>
__device__ __forceinline__ void search_chunk(const Chunk& ch, int n, int (&lo)[kV], int (&hi)[kV], const float* b,
                                             int base, int last, int64_t* __restrict__ out, int64_t i0) {
  int start[kV];
  float x[kV];
  int wmax = 0;
#pragma unroll
  for (int j = 0; j < kV; ++j) {
    if (hi[j] > lo[j]) lo[j] -= base, hi[j] -= base;
    start[j] = lo[j];
    x[j] = flush_subnormal(ch.v[j]);
    wmax = max(wmax, hi[j] - lo[j]);
  }
  wmax = __reduce_max_sync(kFull, wmax);
  const int steps = 32 - __clz(wmax);  // ceil(log2(wmax + 1)); 0 for wmax 0
  for (int s = 0; s < steps; ++s) halve<kStaged>(lo, hi, x, b, last);
  if (kFast) {
    longlong2* o2 = reinterpret_cast<longlong2*>(out + i0);
    o2[0] = make_longlong2(lo[0] - start[0], lo[1] - start[1]);
    o2[1] = make_longlong2(lo[2] - start[2], lo[3] - start[3]);
  } else {
#pragma unroll
    for (int j = 0; j < kV; ++j) {
      if (j < n) out[i0 + j] = lo[j] - start[j];
    }
  }
}

// the values of a thread's chunk at i0 that lie below N (0 to kV)
__device__ __forceinline__ int below(int64_t N, int64_t i0) {
  const int64_t left = N - i0;
  return left >= kV ? kV : (left > 0 ? static_cast<int>(left) : 0);
}

// The whole table (C + 1 offsets and B boundaries) fits kStageWords: every
// block stages it once, then takes tiles blockIdx.x, + gridDim.x, ... of
// kThreads * kV values; the tile that N cuts short (if any) last, element
// by element. Lean, so that eight blocks fill an SM.
template <bool kVec>
__global__ void __launch_bounds__(kThreads, 8)
fused_bucketize_kernel_whole(const float* __restrict__ vals, const int32_t* __restrict__ cids,
                             const float* __restrict__ bounds, const int32_t* __restrict__ offs,
                             int64_t* __restrict__ out, int64_t N, int B, int C, int slot) {
  __shared__ int32_t win[kStageWords];  // the offsets, clamped into [0, B], then the boundaries
  for (int i = threadIdx.x; i <= C; i += kThreads) win[i] = clamp_to(__ldg(offs + i), 0, B);
  for (int i = threadIdx.x; i < B; i += kThreads) win[C + 1 + i] = __float_as_int(flush_subnormal(__ldg(bounds + i)));
  __syncthreads();
  const float* wb = reinterpret_cast<const float*>(win + C + 1);
  const int last = max(B - 1, 0), mine = threadIdx.x * kV;
  const int whole_tiles = kVec ? static_cast<int>(N / kTile) : 0;  // tiles read 16 bytes at a time
  int t = blockIdx.x;
  for (; t < whole_tiles; t += gridDim.x) {
    const int64_t i0 = static_cast<int64_t>(t) * kTile + mine;
    Chunk ch;
    load_chunk<true>(ch, vals, cids, i0, kV);
    int lo[kV], hi[kV], need_lo = INT_MAX, need_hi = 0;
    ranges<true, true>(ch, kV, win, B, C, lo, hi, need_lo, need_hi);
    search_chunk<true, true>(ch, kV, lo, hi, wb, 0, last, out, i0);
  }
  for (; static_cast<int64_t>(t) * kTile < N; t += gridDim.x) {
    const int64_t i0 = static_cast<int64_t>(t) * kTile + mine;
    const int n = below(N, i0);
    Chunk ch;
    load_chunk<false>(ch, vals, cids, i0, n);
    int lo[kV], hi[kV], need_lo = INT_MAX, need_hi = 0;
    ranges<true, false>(ch, n, win, B, C, lo, hi, need_lo, need_hi);
    search_chunk<true, false>(ch, n, lo, hi, wb, 0, last, out, i0);
  }
  if (threadIdx.x == 0) g_path_flag[blockIdx.x % kFlagLanes][slot][0] = 1;
}

// Any other table: a block takes one tile of kThreads * kV values. With
// `stage` and C + 1 <= kStageWords, it stages the offsets while its loads
// are in flight, reduces the least and greatest boundary its values read
// and stages the boundaries between them where they fit kStageWords (one
// round trip to the L2 after the values arrive); else it reads the
// boundaries, and any offsets it did not stage, through the read-only
// cache.
template <bool kFast>
__device__ __forceinline__ void bucketize_tile(const float* __restrict__ vals, const int32_t* __restrict__ cids,
                                               const float* __restrict__ bounds, const int32_t* __restrict__ offs,
                                               int64_t* __restrict__ out, int64_t N, int B, int C, bool stage,
                                               int slot, int32_t* s_offs, float* s_win, int (*red)[kWarps]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t i0 = static_cast<int64_t>(blockIdx.x) * kTile + threadIdx.x * kV;
  const int n = kFast ? kV : below(N, i0);
  Chunk ch;
  load_chunk<kFast>(ch, vals, cids, i0, n);
  int lo[kV], hi[kV], need_lo = INT_MAX, need_hi = 0;
  bool staged = false;
  if (stage && C + 1 <= kStageWords) {
    for (int i = threadIdx.x; i <= C; i += kThreads) s_offs[i] = clamp_to(__ldg(offs + i), 0, B);
    __syncthreads();
    ranges<true, kFast>(ch, n, s_offs, B, C, lo, hi, need_lo, need_hi);
    need_lo = __reduce_min_sync(kFull, need_lo);
    need_hi = __reduce_max_sync(kFull, need_hi);
    if (lane == 0) red[0][warp] = need_lo, red[1][warp] = need_hi;
    __syncthreads();
    need_lo = red[0][0], need_hi = red[1][0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) need_lo = min(need_lo, red[0][w]), need_hi = max(need_hi, red[1][w]);
    if (need_hi - need_lo <= kStageWords) {  // the same in every thread (true where every range is empty)
      for (int i = threadIdx.x; i < need_hi - need_lo; i += kThreads) {
        s_win[i] = flush_subnormal(__ldg(bounds + need_lo + i));
      }
      __syncthreads();
      staged = true;
      search_chunk<true, kFast>(ch, n, lo, hi, s_win, need_lo, max(need_hi - need_lo - 1, 0), out, i0);
    } else {
      search_chunk<false, kFast>(ch, n, lo, hi, bounds, 0, max(B - 1, 0), out, i0);
    }
  } else {
    ranges<false, kFast>(ch, n, offs, B, C, lo, hi, need_lo, need_hi);
    search_chunk<false, kFast>(ch, n, lo, hi, bounds, 0, max(B - 1, 0), out, i0);
  }
  if (threadIdx.x == 0) g_path_flag[blockIdx.x % kFlagLanes][slot][staged ? 0 : 1] = 1;
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads, 4)
fused_bucketize_kernel(const float* __restrict__ vals, const int32_t* __restrict__ cids,
                       const float* __restrict__ bounds, const int32_t* __restrict__ offs,
                       int64_t* __restrict__ out, int64_t N, int B, int C, bool stage, int slot) {
  __shared__ int32_t s_offs[kStageWords];  // the offsets, clamped into [0, B]
  __shared__ float s_win[kStageWords];     // the boundaries [need_lo, need_hi)
  __shared__ int red[2][kWarps];
  if (kVec && (static_cast<int64_t>(blockIdx.x) + 1) * kTile <= N) {
    bucketize_tile<true>(vals, cids, bounds, offs, out, N, B, C, stage, slot, s_offs, s_win, red);
  } else {
    bucketize_tile<false>(vals, cids, bounds, offs, out, N, B, C, stage, slot, s_offs, s_win, red);
  }
}

cudaError_t launch(bool whole, bool vec, int64_t blocks, cudaStream_t st, const float* v, const int32_t* c,
                   const float* b, const int32_t* o, int64_t* r, int64_t N, int B, int C, bool stage, int slot) {
  const dim3 grid(static_cast<unsigned>(blocks));
  if (whole && vec) {
    fused_bucketize_kernel_whole<true><<<grid, kThreads, 0, st>>>(v, c, b, o, r, N, B, C, slot);
  } else if (whole) {
    fused_bucketize_kernel_whole<false><<<grid, kThreads, 0, st>>>(v, c, b, o, r, N, B, C, slot);
  } else if (vec) {
    fused_bucketize_kernel<true><<<grid, kThreads, 0, st>>>(v, c, b, o, r, N, B, C, stage, slot);
  } else {
    fused_bucketize_kernel<false><<<grid, kThreads, 0, st>>>(v, c, b, o, r, N, B, C, stage, slot);
  }
  return cudaGetLastError();
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// vals (N,) fp32, cids (N,) int32, bounds (B,) fp32 sorted within each
// column, offs (C+1,) int32 ascending in [0, B], out (N,) int64; each
// contiguous on the device, at any 4-byte (out: 8-byte) alignment. The plan
// is the launcher's: with `stage` and a table of at most 1,024 words,
// `blocks` blocks (at most one a tile of 1,024 values) stage it whole;
// else one block a tile (`stage` 0 reads every tile's offsets and
// boundaries through the read-only cache: for measurements). Launches on
// `stream`, does not synchronise.
extern "C" int repro_fused_bucketize(const void* vals, const void* cids, const void* bounds,
                                     const void* offs, void* out, int64_t N, int64_t B, int64_t C, int64_t blocks,
                                     int stage, void* stream) {
  const int64_t tiles = N > 0 ? (N + kTile - 1) / kTile : 0;
  const bool whole = stage != 0 && C >= 0 && B >= 0 && B + C + 1 <= kStageWords;
  if (tiles <= 0 || tiles > INT_MAX || B < 0 || C <= 0 || B > INT_MAX / 2 || C >= INT_MAX / 2 || blocks <= 0 ||
      blocks > tiles || (!whole && blocks != tiles)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool vec = aligned16(vals) && aligned16(cids) && aligned16(out);
  const int slot = static_cast<int>(g_serial % kFlagSlots);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* pv = static_cast<const float*>(vals);
  const int32_t* pc = static_cast<const int32_t*>(cids);
  const float* pb = static_cast<const float*>(bounds);
  const int32_t* po = static_cast<const int32_t*>(offs);
  int64_t* pr = static_cast<int64_t*>(out);
  const int b = static_cast<int>(B), c = static_cast<int>(C);
  const cudaError_t err = launch(whole, vec, blocks, st, pv, pc, pb, po, pr, N, b, c, stage != 0, slot);
  if (err == cudaSuccess) ++g_serial;
  return static_cast<int>(err);
}

// Launches that ran the staged (which 0) or the cached (1) path since the
// library was loaded: synchronises the card, counts the flags of the
// launches since the last call (the last kFlagSlots of them) and clears them.
extern "C" int64_t repro_bucketize_path_launches(int which) {
  static uint8_t flags[kFlagLanes][kFlagSlots][2];
  if (g_serial > g_read && cudaDeviceSynchronize() == cudaSuccess &&
      cudaMemcpyFromSymbol(flags, g_path_flag, sizeof(flags)) == cudaSuccess) {
    for (int64_t s = g_serial - 1; s >= g_read && s >= g_serial - kFlagSlots; --s) {
      for (int p = 0; p < 2; ++p) {
        uint8_t ran = 0;
        for (int l = 0; l < kFlagLanes; ++l) ran |= flags[l][s % kFlagSlots][p];
        g_path_launches[p] += ran;
      }
    }
    void* dev_flags = nullptr;
    if (cudaGetSymbolAddress(&dev_flags, g_path_flag) == cudaSuccess) cudaMemset(dev_flags, 0, sizeof(flags));
    cudaDeviceSynchronize();
    g_read = g_serial;
  }
  return g_path_launches[which != 0];
}
