// fused_gather (row mode): out[i] = table[ids[i]], PAD (-1) and
// out-of-range ids read row 0.
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
