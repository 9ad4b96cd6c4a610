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
// over 3.35 TB/s.
//
// Design: one warp per output row. Each lane moves 16-byte float4 chunks, so
// a 128-wide fp32 row is one fully coalesced 512 B warp load and one store;
// many independent warps in flight hide the latency of the random row
// addresses. Addresses are 64-bit: R*D passes 2^31 at full table size. When
// D % 4 != 0 or a pointer is not 16-byte aligned, the same kernel copies
// with a scalar loop.
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kWarpsPerBlock = 8;

template <typename IdT>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
gather_rows_kernel(const float* __restrict__ table, const IdT* __restrict__ ids,
                   float* __restrict__ out, int64_t R, int64_t D, int64_t K, bool vec4) {
  const int lane = threadIdx.x & 31;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (i >= K) return;
  int64_t r = static_cast<int64_t>(ids[i]);
  if (r < 0 || r >= R) r = 0;
  const float* src = table + r * D;
  float* dst = out + i * D;
  if (vec4) {
    const float4* s4 = reinterpret_cast<const float4*>(src);
    float4* d4 = reinterpret_cast<float4*>(dst);
    for (int64_t c = lane; c < D / 4; c += 32) d4[c] = __ldg(s4 + c);
  } else {
    for (int64_t c = lane; c < D; c += 32) dst[c] = __ldg(src + c);
  }
}

}  // namespace

// table (R, D) fp32, ids (K,) int32 or int64, out (K, D) fp32; all
// contiguous on the device. Launches on `stream`, does not synchronise.
extern "C" int repro_gather_rows(const void* table, const void* ids, int ids_are_int64,
                                 void* out, int64_t R, int64_t D, int64_t K, void* stream) {
  const int64_t blocks = (K + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (K <= 0 || D <= 0 || R <= 0 || blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec4 = D % 4 == 0 &&
      ((reinterpret_cast<uintptr_t>(table) | reinterpret_cast<uintptr_t>(out)) % 16) == 0;
  const float* t = static_cast<const float*>(table);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(blocks));
  if (ids_are_int64) {
    gather_rows_kernel<int64_t><<<grid, kWarpsPerBlock * 32, 0, s>>>(
        t, static_cast<const int64_t*>(ids), o, R, D, K, vec4);
  } else {
    gather_rows_kernel<int32_t><<<grid, kWarpsPerBlock * 32, 0, s>>>(
        t, static_cast<const int32_t*>(ids), o, R, D, K, vec4);
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
