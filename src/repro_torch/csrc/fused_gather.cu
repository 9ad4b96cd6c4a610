// fused_gather, row mode: out[i] = table[ids[i]], PAD (-1) and
// out-of-range ids read row 0. Slab mode (the second kernel below): the
// windowed gather of sorted ids.
//
// Replaces the TPU kernel repro/kernels/fused_gather/fused_gather.py::
// gather_rows_padded (_kernel: one scalar-prefetched row DMA per grid step),
// with the clamp of repro/kernels/fused_gather/ops.py:38 fused in.
//
// Bound on H100: bytes. Nothing is computed; each output row reads D*4 B at
// a data-dependent address of a table far larger than the 50 MB L2 and
// writes D*4 B. Least time = (distinct rows read + rows written) * D * 4 B
// + the ids, over 3.35 TB/s.
//
// Design. A warp that copies one row and exits keeps one dependent chain
// (load the id, then the row) in flight, and at D 8 uses 2 of its 32
// lanes. Instead:
//   * `lanes` = min(32, D/4 rounded up to a power of two) threads move one
//     row, one float4 each, so a warp holds 32 / lanes row groups (16 at
//     D 8, 1 at D >= 128);
//   * a warp's work item is a chunk of up to 64 output rows and one column
//     slice of them (cols / lanes slices when a row is wider than one pass
//     of the lanes: 16 of 512 B at D 2,048, on neighbouring warps);
//   * the chunk's ids are loaded in one coalesced access (lane j the j-th
//     and the 32 + j-th) and clamped there, then handed out by
//     __shfl_sync; each row group issues the loads of its per_group rows
//     before their stores;
//   * per_group is the most (16, 4 or 1: three instantiations, since it
//     sizes the registers) that still gives every warp the card holds at
//     once (cudaOccupancyMaxActiveBlocksPerMultiprocessor, queried once per
//     instantiation) kItemsPerWarp items: 16 at dlrm's train and bulk
//     shapes, 4 at D 8, 1 at serve_p99's 26,624 rows, so a small K still
//     spreads over every SM;
//   * one item a warp, the grid as large as the items: a persistent grid
//     whose warps stride over items (the scatter's design) measured slower
//     at D 128 on the H100, and 64-bit divisions per warp slowed the small
//     serve_p99 launch by a quarter, so the kernel has none.
// Every output element has one writer: no atomics. Addresses are 64-bit:
// R*D passes 2^31 at full table size. When D % 4 != 0 or a pointer is not
// 16-byte aligned the same kernel moves scalars.
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kMaxChunk = 64;  // rows of a work item: two ids a lane
constexpr int kItemsPerWarp = 4;  // items per resident warp, at least, before rows per item grow

template <typename IdT>
__device__ __forceinline__ int64_t load_clamped(const IdT* __restrict__ ids, int64_t i, int64_t K, int64_t R) {
  if (i >= K) return 0;
  const int64_t r = static_cast<int64_t>(__ldg(ids + i));
  return (r < 0 || r >= R) ? 0 : r;
}

// V is float4 (D % 4 == 0, aligned) or float; cols = D / (elements of V).
// A warp moves one work item: chunk = (32 / lanes) * per_group rows (per
// row group per_group <= kU, which sizes the registers) and one column
// slice of them; the slices of a chunk are neighbouring warps, so a wide
// row is read and written at once. No 64-bit divisions: on a small K they
// cost as much as the copy.
template <typename IdT, typename V, int kU>
__global__ void __launch_bounds__(kWarpsPerBlock * 32, kU > 4 ? 2 : kU > 1 ? 4 : 8)
gather_rows_kernel(const V* __restrict__ table, const IdT* __restrict__ ids, V* __restrict__ out,
                   int64_t R, int64_t cols, int64_t K, int lanes, int per_group, unsigned slices) {
  const int lane = threadIdx.x & 31;
  const int groups = 32 / lanes;  // row groups per warp
  const int grp = lane / lanes;   // lanes is a power of two
  const int chunk = groups * per_group;  // <= kMaxChunk
  const unsigned w = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);  // the entry bounds the items by 2^32
  const unsigned c = slices == 1 ? w : w / slices;
  const int64_t i0 = static_cast<int64_t>(c) * chunk;
  if (i0 >= K) return;  // uniform across the warp
  const int64_t cc = static_cast<int64_t>(w - c * slices) * lanes + (lane & (lanes - 1));  // this lane's column
  // lane j holds the clamped ids of the item's rows j and 32 + j
  const int64_t lo = lane < chunk ? load_clamped(ids, i0 + lane, K, R) : 0;
  const int64_t hi = lane + 32 < chunk ? load_clamped(ids, i0 + lane + 32, K, R) : 0;
  V x[kU];
#pragma unroll
  for (int u = 0; u < kU; ++u) {
    if (u == per_group) break;  // uniform
    const int k = u * groups + grp;  // the item's row this group moves; k < 32 for all lanes or none
    const int64_t src = __shfl_sync(0xffffffffu, u * groups < 32 ? lo : hi, k & 31);
    if (i0 + k < K && cc < cols) x[u] = __ldg(table + src * cols + cc);
  }
#pragma unroll
  for (int u = 0; u < kU; ++u) {
    if (u == per_group) break;
    const int64_t i = i0 + u * groups + grp;
    if (i < K && cc < cols) out[i * cols + cc] = x[u];
  }
}

// Blocks resident on the card at once for one instantiation, queried once.
template <typename IdT, typename V, int kU>
int resident_blocks() {
  static const int blocks = [] {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gather_rows_kernel<IdT, V, kU>, kWarpsPerBlock * 32, 0);
    return (sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
  }();
  return blocks;
}

// Rows a row group moves per item: as many as kU and the chunk allow, but
// few enough that each warp the card holds at once gets kItemsPerWarp
// items (so a small K spreads over the whole card).
template <typename IdT, typename V, int kU>
int rows_per_group(int64_t cols, int64_t K, int lanes) {
  const int groups = 32 / lanes;
  const int64_t slices = (cols + lanes - 1) / lanes;
  const int64_t fill = K * slices / (groups * kItemsPerWarp * kWarpsPerBlock * int64_t{resident_blocks<IdT, V, kU>()});
  const int most = kMaxChunk / groups < kU ? kMaxChunk / groups : kU;
  return fill < 1 ? 1 : (fill < most ? static_cast<int>(fill) : most);
}

template <typename IdT, typename V, int kU>
void launch_gather(const void* table, const void* ids, void* out, int64_t R, int64_t cols, int64_t K, int lanes,
                   int per_group, cudaStream_t s) {
  const int64_t chunk = 32 / lanes * per_group;
  const int64_t slices = (cols + lanes - 1) / lanes;
  const int64_t blocks = ((K + chunk - 1) / chunk * slices + kWarpsPerBlock - 1) / kWarpsPerBlock;
  gather_rows_kernel<IdT, V, kU><<<static_cast<unsigned>(blocks), kWarpsPerBlock * 32, 0, s>>>(
      static_cast<const V*>(table), static_cast<const IdT*>(ids), static_cast<V*>(out), R, cols, K, lanes,
      per_group, static_cast<unsigned>(slices));
}

// The most rows in flight a row group that K still fills the card with:
// 16 (where a row takes 8 or more lanes; 128 registers a thread, 16 warps
// an SM), 4 (64 registers, 32 warps) or 1 (a row a group, 64 warps).
template <typename IdT, typename V>
void dispatch_gather(const void* table, const void* ids, void* out, int64_t R, int64_t cols, int64_t K,
                     cudaStream_t s) {
  int lanes = 1;
  while (lanes < cols && lanes < 32) lanes <<= 1;
  const int many = lanes >= 8 ? rows_per_group<IdT, V, 16>(cols, K, lanes) : 1;
  const int few = rows_per_group<IdT, V, 4>(cols, K, lanes);
  if (many > 4) {
    launch_gather<IdT, V, 16>(table, ids, out, R, cols, K, lanes, many, s);
  } else if (few > 1) {
    launch_gather<IdT, V, 4>(table, ids, out, R, cols, K, lanes, few, s);
  } else {
    launch_gather<IdT, V, 1>(table, ids, out, R, cols, K, lanes, 1, s);
  }
}

}  // namespace

// table (R, D) fp32, ids (K,) int32 or int64, out (K, D) fp32; all
// contiguous on the device. Launches on `stream`, does not synchronise.
extern "C" int repro_gather_rows(const void* table, const void* ids, int ids_are_int64,
                                 void* out, int64_t R, int64_t D, int64_t K, void* stream) {
  const bool vec4 = D % 4 == 0 &&
      ((reinterpret_cast<uintptr_t>(table) | reinterpret_cast<uintptr_t>(out)) % 16) == 0;
  const int64_t cols = vec4 ? D / 4 : D;
  // work items (a row and a column slice each at the most) fit 32 bits
  if (K <= 0 || D <= 0 || R <= 0 || K > UINT_MAX / cols) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ids_are_int64) {
    if (vec4) dispatch_gather<int64_t, float4>(table, ids, out, R, cols, K, s);
    else dispatch_gather<int64_t, float>(table, ids, out, R, cols, K, s);
  } else {
    if (vec4) dispatch_gather<int32_t, float4>(table, ids, out, R, cols, K, s);
    else dispatch_gather<int32_t, float>(table, ids, out, R, cols, K, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// fused_gather, slab mode: the windowed gather of sorted ids.
//
// Replaces the TPU kernel repro/kernels/fused_gather/fused_gather.py::
// gather_rows_slab (_kernel_slab), with the clamp and padding of
// repro/kernels/fused_gather/ops.py:38-53 fused in. Its function: ids
// outside [0, R) read as id 0; the ids, padded with id 0 to a multiple of
// rows_blk, form runs of rows_blk; a run's window is the slab-aligned
// (slab, D) block at base = clip(min(run), 0, max_base) / slab * slab, with
// max_base = max(round_up(R, slab) - slab, 0); out[i] = table[id] when
// base <= id < base + slab, else zeros. Only the first K rows are written.
//
// The TPU kernel DMAs the whole window and picks rows with a one-hot MXU
// product, because a TPU cannot index VMEM by a vector. A GPU can: nothing
// is staged, each row is read where it lies.
//
// Bound on H100: bytes, (distinct rows read + K rows written) * D * 4 B over
// 3.35 TB/s; a run's rows share one window, so rows read again hit L2.
//
// Design: one CTA per run. Its threads take the block-wide minimum of the
// run's clamped ids (the padding tail included) with warp shuffles and one
// shared-memory step, then copy rows: `lanes` threads (a power of two, 32
// for D >= 128 fp32, so a warp per row there) share a row and move float4
// chunks, so narrow rows do not leave most of a warp idle. A row outside
// the window writes zeros. 64-bit addressing, int32 or int64 ids, and a
// scalar loop when D % 4 != 0 or a pointer is not 16-byte aligned.

namespace {

template <typename IdT>
__device__ __forceinline__ int64_t clamped_id(const IdT* ids, int64_t i, int64_t R) {
  const int64_t r = static_cast<int64_t>(ids[i]);
  return (r < 0 || r >= R) ? 0 : r;
}

template <typename IdT>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
gather_rows_slab_kernel(const float* __restrict__ table, const IdT* __restrict__ ids,
                        float* __restrict__ out, int64_t R, int64_t D, int64_t K,
                        int64_t rows_blk, int64_t slab, int64_t max_base, int lanes, bool vec4) {
  __shared__ int64_t warp_min[kWarpsPerBlock];
  const int lane = threadIdx.x & 31;
  const int64_t run0 = static_cast<int64_t>(blockIdx.x) * rows_blk;
  int64_t m = INT64_MAX;
  for (int64_t j = threadIdx.x; j < rows_blk; j += blockDim.x) {
    const int64_t i = run0 + j;
    const int64_t r = i < K ? clamped_id(ids, i, R) : 0;  // the tail pads with id 0
    m = r < m ? r : m;
  }
  for (int off = 16; off > 0; off >>= 1) {
    const int64_t o = __shfl_xor_sync(0xffffffffu, m, off);
    m = o < m ? o : m;
  }
  if (lane == 0) warp_min[threadIdx.x >> 5] = m;
  __syncthreads();
  m = warp_min[0];
  for (int w = 1; w < kWarpsPerBlock; ++w) m = warp_min[w] < m ? warp_min[w] : m;
  const int64_t base = (m < max_base ? m : max_base) / slab * slab;  // m >= 0: ids are clamped

  const int64_t cols = vec4 ? D / 4 : D;
  const int col0 = threadIdx.x & (lanes - 1);
  const int64_t rows_per_pass = blockDim.x / lanes;
  for (int64_t j = threadIdx.x / lanes; j < rows_blk; j += rows_per_pass) {
    const int64_t i = run0 + j;
    if (i >= K) break;
    const int64_t r = clamped_id(ids, i, R);
    const bool in_window = r >= base && r - base < slab;
    if (vec4) {
      const float4* s4 = reinterpret_cast<const float4*>(table + r * D);
      float4* d4 = reinterpret_cast<float4*>(out + i * D);
      for (int64_t c = col0; c < cols; c += lanes)
        d4[c] = in_window ? __ldg(s4 + c) : make_float4(0.f, 0.f, 0.f, 0.f);
    } else {
      const float* src = table + r * D;
      float* dst = out + i * D;
      for (int64_t c = col0; c < cols; c += lanes) dst[c] = in_window ? __ldg(src + c) : 0.f;
    }
  }
}

}  // namespace

// table (R, D) fp32, ids (K,) int32 or int64, out (K, D) fp32; all
// contiguous on the device. rows_blk >= 1 and 1 <= slab (the wrapper has
// already cut slab to round_up(R, 8)). Launches on `stream`, does not
// synchronise.
extern "C" int repro_gather_rows_slab(const void* table, const void* ids, int ids_are_int64,
                                      void* out, int64_t R, int64_t D, int64_t K,
                                      int64_t rows_blk, int64_t slab, void* stream) {
  if (K <= 0 || D <= 0 || R <= 0 || rows_blk <= 0 || slab <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t runs = (K + rows_blk - 1) / rows_blk;
  if (runs > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t padded_rows = (R + slab - 1) / slab * slab;
  const int64_t max_base = padded_rows - slab > 0 ? padded_rows - slab : 0;
  const bool vec4 = D % 4 == 0 &&
      ((reinterpret_cast<uintptr_t>(table) | reinterpret_cast<uintptr_t>(out)) % 16) == 0;
  const int64_t cols = vec4 ? D / 4 : D;
  int lanes = 1;
  while (lanes < 32 && lanes < cols) lanes <<= 1;
  const float* t = static_cast<const float*>(table);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(runs));
  if (ids_are_int64) {
    gather_rows_slab_kernel<int64_t><<<grid, kWarpsPerBlock * 32, 0, s>>>(
        t, static_cast<const int64_t*>(ids), o, R, D, K, rows_blk, slab, max_base, lanes, vec4);
  } else {
    gather_rows_slab_kernel<int32_t><<<grid, kWarpsPerBlock * 32, 0, s>>>(
        t, static_cast<const int32_t*>(ids), o, R, D, K, rows_blk, slab, max_base, lanes, vec4);
  }
  return static_cast<int>(cudaGetLastError());
}
