// segment_reduce.segment_sum: the forward, out[s] = sum of the value rows
// [bounds[s], bounds[s+1]), the CSR form of a sum over sorted segment ids;
// its gradient, segment_expand_csr (below the forward); and both again for
// all the sum-pooled features of one embedding dim group in one launch
// (segment_sum_group_kernel, segment_expand_group_kernel; their C entries
// at the end of the file).
//
// Replaces the TPU kernel repro/kernels/segment_reduce/segment_reduce.py::
// segment_sum_padded (_kernel, _kernel_skip), which builds a one-hot
// (segment x value) tile and reduces it on the MXU, carrying partial sums
// across a sequential grid. That device is not carried over: on this card
// the sum is a streaming read.
//
// Bound on H100: bytes. One add per value element against 4 B read; least
// time = (live rows * D + S * D) * 4 B (+ the bounds) over 3.35 TB/s.
//
// Design: the caller passes CSR bounds (S+1, int32 or int64): a Ragged
// column's row_splits as they are, or searchsorted over sorted ids. Segment
// s owns the contiguous value rows [bounds[s], bounds[s+1]), clamped to
// [0, N], so rows past bounds[S] (a padding tail) are never read. One warp
// per output segment walks its run with 16-byte float4 loads (a 128-wide
// row is one coalesced 512 B warp load), accumulates in fp32 registers and
// writes its row once. No atomics, one writer per output, and a fixed
// summation order: results are deterministic. Empty segments write zeros.
// A scalar loop in the same kernel serves D % 4 != 0 or unaligned pointers.
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kWarpsPerBlock = 8;

template <typename Idx>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
segment_sum_sorted_kernel(const float* __restrict__ vals, const Idx* __restrict__ bounds,
                          float* __restrict__ out, int64_t N, int64_t S, int64_t D, bool vec4) {
  const int lane = threadIdx.x & 31;
  const int64_t s = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (s >= S) return;
  const int64_t begin = min(max(static_cast<int64_t>(bounds[s]), int64_t{0}), N);
  const int64_t end = max(min(static_cast<int64_t>(bounds[s + 1]), N), begin);
  if (vec4) {
    const int64_t d4 = D / 4;
    float4* o4 = reinterpret_cast<float4*>(out) + s * d4;
    for (int64_t c = lane; c < d4; c += 32) {
      const float4* p = reinterpret_cast<const float4*>(vals) + begin * d4 + c;
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int64_t r = begin; r < end; ++r, p += d4) {
        const float4 x = __ldg(p);
        acc.x += x.x;
        acc.y += x.y;
        acc.z += x.z;
        acc.w += x.w;
      }
      o4[c] = acc;
    }
  } else {
    for (int64_t c = lane; c < D; c += 32) {
      const float* p = vals + begin * D + c;
      float acc = 0.f;
      for (int64_t r = begin; r < end; ++r, p += D) acc += __ldg(p);
      out[s * D + c] = acc;
    }
  }
}

// Gradient of the CSR segment sum (the VJP of repro/kernels/segment_reduce/
// ops.py::segment_sum, _bwd: dv[j] = g[seg(j)], zero where seg(j) is out of
// range): out[j] = g[s] for every row j in [bounds[s], bounds[s+1]), and
// zero for the rows outside [bounds[0], bounds[S]) (the padding tail).
//
// Bound on H100: bytes. A pure copy: least time = (S * D + N * D) * 4 B (+
// the bounds) over 3.35 TB/s.
//
// Design: warps [0, S) take one segment each: each lane holds its float4
// chunks of g[s] in registers and stores them to every row of the run, so g
// is read once. Warps [S, S + ceil(N / kZeroRows)) each own kZeroRows
// consecutive rows and write zeros to those outside [bounds[0], bounds[S]).
// With ascending bounds every output row has exactly one writer: no
// atomics, deterministic, and no separate fill pass. g may have a row
// stride (a column of a stacked gradient) as long as its rows are dense.
constexpr int64_t kZeroRows = 32;

template <typename Idx>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
segment_expand_csr_kernel(const float* __restrict__ g, int64_t g_stride,
                          const Idx* __restrict__ bounds, float* __restrict__ out, int64_t N,
                          int64_t S, int64_t D, bool vec4) {
  const int lane = threadIdx.x & 31;
  const int64_t w = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (w < S) {
    const int64_t begin = min(max(static_cast<int64_t>(bounds[w]), int64_t{0}), N);
    const int64_t end = max(min(static_cast<int64_t>(bounds[w + 1]), N), begin);
    if (vec4) {
      const int64_t d4 = D / 4;
      const float4* src = reinterpret_cast<const float4*>(g + w * g_stride);
      for (int64_t c = lane; c < d4; c += 32) {
        const float4 x = __ldg(src + c);
        float4* p = reinterpret_cast<float4*>(out) + begin * d4 + c;
        for (int64_t r = begin; r < end; ++r, p += d4) *p = x;
      }
    } else {
      for (int64_t c = lane; c < D; c += 32) {
        const float x = __ldg(g + w * g_stride + c);
        float* p = out + begin * D + c;
        for (int64_t r = begin; r < end; ++r, p += D) *p = x;
      }
    }
    return;
  }
  const int64_t r0 = (w - S) * kZeroRows;
  if (r0 >= N) return;
  const int64_t lo = min(max(static_cast<int64_t>(bounds[0]), int64_t{0}), N);
  const int64_t hi = max(min(static_cast<int64_t>(bounds[S]), N), lo);
  const int64_t r1 = min(r0 + kZeroRows, N);
  for (int64_t r = r0; r < r1; ++r) {
    if (r >= lo && r < hi) continue;
    if (vec4) {
      float4* p = reinterpret_cast<float4*>(out + r * D);
      for (int64_t c = lane; c < D / 4; c += 32) p[c] = make_float4(0.f, 0.f, 0.f, 0.f);
    } else {
      for (int64_t c = lane; c < D; c += 32) out[r * D + c] = 0.f;
    }
  }
}

// The grouped forms. An embedding dim group's routed rows `vals` (N, D)
// hold one slice per feature, [ofs, ofs + n_vals), in feature order; each
// sum-pooled feature reduces its slice by its own CSR splits. Per feature
// the per-feature kernels above would take one wrapper call and one launch
// (26 a dlrm request, 61 an MSE step), and autograd would see one slice of
// `vals` per feature: each slice's backward fills a zero tensor the size of
// the whole of `vals` and adds it to the others, a fill and an add of N * D
// * 4 B per feature (872 MB each at dlrm's train batch). Here one launch
// takes every feature of the group, and the backward writes the gradient
// of the whole of `vals` once.
//
// The features travel by value, as a kernel parameter (no copy to the
// device, no extra launch): for each, its splits, its output (forward) or
// gradient rows and their row stride (backward; null for a feature whose
// gradient is absent), its slice, its segment count and the first block
// of its segment work. kMaxGroupFeatures * 56 B keeps the parameters under
// 4 KB; the wrapper launches once per chunk of that many features.
//
// Bound on H100: bytes, as the per-feature kernels, summed over features:
// forward (live rows + S) * D * 4 B; backward (S + N) * D * 4 B.
//
// Design: `lanes` = min(32, D/4 rounded up to a power of two) threads take
// a segment with float4 loads (D/lanes scalars when D % 4 != 0 or a pointer
// is unaligned), so a 32 B row of dim 8 takes 2 lanes and a warp works on 16
// segments. A 1-D grid: each feature owns ceil(S_f / (256 / lanes))
// consecutive blocks, found by a binary search over the parameter table.
// The forward sums each output element in the per-feature kernel's order
// (zero, then the rows in order), so the results are bit-equal to it. The
// backward's segment blocks store g_f[s] to every row of segment s; blocks
// past them each own a range of rows and zero those that no segment covers
// (padding tails, features without a gradient, the rows of features pooled
// otherwise), skipping covered runs whole. Every row of `vals` has exactly
// one writer: no atomics, no fill pass, deterministic.
constexpr int kMaxGroupFeatures = 64;
constexpr int kGroupThreads = 256;
constexpr int kZeroPasses = 16;  // zero-writing rows per block: kZeroPasses * (kGroupThreads / lanes)

struct GroupFeature {
  const void* splits;   // (n_rows + 1,) int32 or int64, ascending
  float* ptr;           // forward: out (n_rows, D); backward: g rows, or null
  int64_t ofs;          // the feature's first row in vals
  int64_t n_vals;       // rows in its slice: bounds clamp to [0, n_vals]
  int64_t n_rows;       // segments
  int64_t stride;       // backward: g's row stride in elements
  int32_t splits64;     // the splits are int64
  int32_t first_block;  // its first block of segment work
};
static_assert(sizeof(GroupFeature) == 56, "GroupFeature layout");

struct GroupParams {
  GroupFeature f[kMaxGroupFeatures];
  int32_t n;           // features
  int32_t seg_blocks;  // blocks of segment work; the backward's zero blocks follow
  int64_t row_lo;      // backward: the rows of vals this launch owns, [row_lo, row_hi)
  int64_t row_hi;
};

__device__ __forceinline__ int64_t split_at(const GroupFeature& f, int64_t i) {
  return f.splits64 ? __ldg(static_cast<const int64_t*>(f.splits) + i)
                    : static_cast<int64_t>(__ldg(static_cast<const int32_t*>(f.splits) + i));
}

// The feature whose segment blocks hold block b: the last with first_block
// <= b (features without segment work share the next one's first_block).
__device__ __forceinline__ int feature_of_block(const GroupParams& p, int b) {
  int lo = 0, hi = p.n - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (p.f[mid].first_block <= b) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// Segment s of feature f: its rows [begin, end) of the feature's slice.
__device__ __forceinline__ void segment_rows(const GroupFeature& f, int64_t s, int64_t& begin,
                                             int64_t& end) {
  begin = min(max(split_at(f, s), int64_t{0}), f.n_vals);
  end = max(min(split_at(f, s + 1), f.n_vals), begin);
}

template <typename V>
__device__ __forceinline__ V vzero();
template <>
__device__ __forceinline__ float4 vzero<float4>() { return make_float4(0.f, 0.f, 0.f, 0.f); }
template <>
__device__ __forceinline__ float vzero<float>() { return 0.f; }

__device__ __forceinline__ void vacc(float4& a, const float4 x) {
  a.x += x.x;
  a.y += x.y;
  a.z += x.z;
  a.w += x.w;
}
__device__ __forceinline__ void vacc(float& a, const float x) { a += x; }

// V is float4 (D % 4 == 0, aligned) or float; cols = D / (elements of V).
template <typename V>
__global__ void __launch_bounds__(kGroupThreads)
segment_sum_group_kernel(const V* __restrict__ vals, int64_t cols, int lanes,
                         const __grid_constant__ GroupParams p) {
  const GroupFeature& f = p.f[feature_of_block(p, blockIdx.x)];
  const int64_t s = static_cast<int64_t>(blockIdx.x - f.first_block) * (kGroupThreads / lanes) +
                    threadIdx.x / lanes;
  if (s >= f.n_rows) return;
  int64_t begin, end;
  segment_rows(f, s, begin, end);
  const V* base = vals + (f.ofs + begin) * cols;
  V* out = reinterpret_cast<V*>(f.ptr) + s * cols;
  for (int64_t c = threadIdx.x & (lanes - 1); c < cols; c += lanes) {
    const V* q = base + c;
    V acc = vzero<V>();
    for (int64_t r = begin; r < end; ++r, q += cols) vacc(acc, __ldg(q));
    out[c] = acc;
  }
}

template <typename V>
__global__ void __launch_bounds__(kGroupThreads)
segment_expand_group_kernel(V* __restrict__ out, int64_t cols, int lanes,
                            const __grid_constant__ GroupParams p) {
  const int col0 = threadIdx.x & (lanes - 1);
  const int per_pass = kGroupThreads / lanes;
  if (static_cast<int>(blockIdx.x) < p.seg_blocks) {  // segment s of feature f: g_f[s] to its rows
    const GroupFeature& f = p.f[feature_of_block(p, blockIdx.x)];
    const int64_t s = static_cast<int64_t>(blockIdx.x - f.first_block) * per_pass + threadIdx.x / lanes;
    if (s >= f.n_rows) return;
    int64_t begin, end;
    segment_rows(f, s, begin, end);
    const V* src = reinterpret_cast<const V*>(f.ptr + s * f.stride);
    for (int64_t c = col0; c < cols; c += lanes) {
      const V x = __ldg(src + c);
      V* q = out + (f.ofs + begin) * cols + c;
      for (int64_t r = begin; r < end; ++r, q += cols) *q = x;
    }
    return;
  }
  // rows [r0, r1): zero every row outside the covered runs [ofs + lo, ofs +
  // hi) of the features with a gradient, walking the features in row order
  const int64_t r0 = p.row_lo + static_cast<int64_t>(blockIdx.x - p.seg_blocks) * kZeroPasses * per_pass;
  const int64_t r1 = min(r0 + static_cast<int64_t>(kZeroPasses) * per_pass, p.row_hi);
  int k = 0;  // the last feature that starts at or before r0
  for (int lo = 0, hi = p.n - 1; lo <= hi;) {
    const int mid = (lo + hi) >> 1;
    if (p.f[mid].ofs <= r0) { k = mid; lo = mid + 1; } else { hi = mid - 1; }
  }
  int64_t j = r0;
  while (j < r1) {
    int64_t a = r1, b = r1;  // the next covered run that ends after j
    for (; k < p.n && p.f[k].ofs < r1; ++k) {
      const GroupFeature& f = p.f[k];
      if (f.ptr == nullptr) continue;
      const int64_t lo = min(max(split_at(f, 0), int64_t{0}), f.n_vals);
      const int64_t hi = max(min(split_at(f, f.n_rows), f.n_vals), lo);
      if (f.ofs + hi > j && lo < hi) {
        a = max(f.ofs + lo, j);
        b = f.ofs + hi;
        ++k;
        break;
      }
    }
    const int64_t e = min(a, r1);
    for (int64_t r = j + threadIdx.x / lanes; r < e; r += per_pass)
      for (int64_t c = col0; c < cols; c += lanes) out[r * cols + c] = vzero<V>();
    j = b;
  }
}

// Fill the parameters from the caller's table (F rows of kGroupFields
// int64: splits, splits are int64, ptr, ofs, n_vals, n_rows, stride) and
// check them: slices in order, inside [0, N), not overlapping.
constexpr int kGroupFields = 7;

cudaError_t group_params(const int64_t* table, int F, int64_t N, int64_t D, bool backward, int lanes,
                         GroupParams& p) {
  if (F < 1 || F > kMaxGroupFeatures || N < 0 || D <= 0) return cudaErrorInvalidValue;
  int64_t blocks = 0, prev_end = 0;
  const int per_block = kGroupThreads / lanes;
  for (int i = 0; i < F; ++i) {
    const int64_t* t = table + i * kGroupFields;
    GroupFeature& f = p.f[i];
    f.splits = reinterpret_cast<const void*>(t[0]);
    f.splits64 = static_cast<int32_t>(t[1] != 0);
    f.ptr = reinterpret_cast<float*>(t[2]);
    f.ofs = t[3];
    f.n_vals = t[4];
    f.n_rows = t[5];
    f.stride = t[6];
    if (f.splits == nullptr || f.ofs < prev_end || f.n_vals < 0 || f.ofs + f.n_vals > N || f.n_rows < 0 ||
        (!backward && f.n_rows > 0 && f.ptr == nullptr) || (backward && f.ptr != nullptr && f.stride < 0)) {
      return cudaErrorInvalidValue;
    }
    prev_end = f.ofs + f.n_vals;
    f.first_block = static_cast<int32_t>(blocks);
    if (f.ptr != nullptr) blocks += (f.n_rows + per_block - 1) / per_block;
    if (blocks > INT_MAX / 2) return cudaErrorInvalidValue;
  }
  p.n = F;
  p.seg_blocks = static_cast<int32_t>(blocks);
  return cudaSuccess;
}

int group_lanes(int64_t cols) {
  int lanes = 1;
  while (lanes < cols && lanes < 32) lanes <<= 1;
  return lanes;
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// vals (N, D) fp32, bounds (S+1,) int32 or int64 ascending, out (S, D) fp32;
// all contiguous on the device. Launches on `stream`, does not synchronise.
extern "C" int repro_segment_sum_sorted(const void* vals, const void* bounds,
                                        int bounds_are_int64, void* out, int64_t N, int64_t S,
                                        int64_t D, void* stream) {
  const int64_t blocks = (S + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (N < 0 || S <= 0 || D <= 0 || blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec4 = D % 4 == 0 &&
      ((reinterpret_cast<uintptr_t>(vals) | reinterpret_cast<uintptr_t>(out)) % 16) == 0;
  const float* v = static_cast<const float*>(vals);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(blocks));
  if (bounds_are_int64) {
    segment_sum_sorted_kernel<int64_t><<<grid, kWarpsPerBlock * 32, 0, st>>>(
        v, static_cast<const int64_t*>(bounds), o, N, S, D, vec4);
  } else {
    segment_sum_sorted_kernel<int32_t><<<grid, kWarpsPerBlock * 32, 0, st>>>(
        v, static_cast<const int32_t*>(bounds), o, N, S, D, vec4);
  }
  return static_cast<int>(cudaGetLastError());
}

// g (S, D) fp32 with row stride g_stride (elements, >= D), bounds (S+1,)
// int32 or int64 ascending, out (N, D) fp32 contiguous; all on the device.
// Launches on `stream`, does not synchronise.
extern "C" int repro_segment_expand_csr(const void* g, int64_t g_stride, const void* bounds,
                                        int bounds_are_int64, void* out, int64_t N, int64_t S,
                                        int64_t D, void* stream) {
  const int64_t warps = S + (N + kZeroRows - 1) / kZeroRows;
  const int64_t blocks = (warps + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (N <= 0 || S < 0 || D <= 0 || g_stride < D || blocks > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool vec4 = D % 4 == 0 && g_stride % 4 == 0 &&
      ((reinterpret_cast<uintptr_t>(g) | reinterpret_cast<uintptr_t>(out)) % 16) == 0;
  const float* gp = static_cast<const float*>(g);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(blocks));
  if (bounds_are_int64) {
    segment_expand_csr_kernel<int64_t><<<grid, kWarpsPerBlock * 32, 0, st>>>(
        gp, g_stride, static_cast<const int64_t*>(bounds), o, N, S, D, vec4);
  } else {
    segment_expand_csr_kernel<int32_t><<<grid, kWarpsPerBlock * 32, 0, st>>>(
        gp, g_stride, static_cast<const int32_t*>(bounds), o, N, S, D, vec4);
  }
  return static_cast<int>(cudaGetLastError());
}

// The features of one dim group at once: for each row of `table` (F rows of
// 7 int64: splits pointer, splits are int64, out pointer, ofs, n_vals,
// n_rows, unused), out_f[s] = sum of vals[ofs + b_s, ofs + b_{s+1}) with
// b clamped to [0, n_vals]. vals (N, D) fp32 contiguous, each out_f (n_rows,
// D) fp32 contiguous, on the device; `table` in host memory, 1 <= F <= 64.
// Launches once on `stream`, does not synchronise.
extern "C" int repro_segment_sum_csr_group(const void* vals, int64_t N, int64_t D, const int64_t* table,
                                           int F, void* stream) {
  bool vec4 = D % 4 == 0 && aligned16(vals);
  for (int i = 0; i < F && i < kMaxGroupFeatures; ++i) {
    vec4 = vec4 && aligned16(reinterpret_cast<const void*>(table[i * kGroupFields + 2]));
  }
  const int64_t cols = vec4 ? D / 4 : D;
  const int lanes = group_lanes(cols);
  GroupParams p;
  cudaError_t err = group_params(table, F, N, D, false, lanes, p);
  if (err != cudaSuccess) return static_cast<int>(err);
  p.row_lo = p.row_hi = 0;
  if (p.seg_blocks == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec4) {
    segment_sum_group_kernel<float4><<<p.seg_blocks, kGroupThreads, 0, st>>>(
        static_cast<const float4*>(vals), cols, lanes, p);
  } else {
    segment_sum_group_kernel<float><<<p.seg_blocks, kGroupThreads, 0, st>>>(
        static_cast<const float*>(vals), cols, lanes, p);
  }
  return static_cast<int>(cudaGetLastError());
}

// The gradient of the grouped forward over rows [row_lo, row_hi) of vals:
// out (N, D) fp32 contiguous; for each feature (a row of `table` as above,
// with its gradient pointer, or 0 for none, and the gradient's row stride
// in elements, its rows dense), out[ofs + j] = g_f[s] for every row j of
// segment s, and every other row in [row_lo, row_hi) zero. Every feature's
// slice lies inside [row_lo, row_hi). Launches once on `stream`, does not
// synchronise.
extern "C" int repro_segment_expand_csr_group(void* out, int64_t N, int64_t D, int64_t row_lo,
                                              int64_t row_hi, const int64_t* table, int F, void* stream) {
  bool vec4 = D % 4 == 0 && aligned16(out);
  for (int i = 0; i < F && i < kMaxGroupFeatures; ++i) {
    const int64_t* t = table + i * kGroupFields;
    vec4 = vec4 && aligned16(reinterpret_cast<const void*>(t[2])) && t[6] % 4 == 0;
  }
  const int64_t cols = vec4 ? D / 4 : D;
  const int lanes = group_lanes(cols);
  GroupParams p;
  cudaError_t err = group_params(table, F, N, D, true, lanes, p);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (row_lo < 0 || row_hi > N || row_lo > row_hi || (F > 0 && (p.f[0].ofs < row_lo ||
      p.f[F - 1].ofs + p.f[F - 1].n_vals > row_hi))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  p.row_lo = row_lo;
  p.row_hi = row_hi;
  const int64_t zero_rows = static_cast<int64_t>(kZeroPasses) * (kGroupThreads / lanes);
  const int64_t blocks = p.seg_blocks + (row_hi - row_lo + zero_rows - 1) / zero_rows;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  if (blocks == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(blocks));
  if (vec4) {
    segment_expand_group_kernel<float4><<<grid, kGroupThreads, 0, st>>>(static_cast<float4*>(out), cols, lanes, p);
  } else {
    segment_expand_group_kernel<float><<<grid, kGroupThreads, 0, st>>>(static_cast<float*>(out), cols, lanes, p);
  }
  return static_cast<int>(cudaGetLastError());
}
