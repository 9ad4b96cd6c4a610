// fused_transform.fused_bucketize: every bucketize column in one launch.
// out[i] = the number of boundaries of value i's own column that are <= v,
// v = vals[i], the column's boundaries being bounds[offs[c] : offs[c + 1]]
// (sorted ascending) for c = cids[i]: right-open bins, the index within
// the column, as int64.
//
// Replaces the TPU kernel repro/kernels/fused_transform/fused_transform.py::
// fused_bucketize_padded (_kernel), which streams (TR, 128) value tiles
// through the VPU, keeps the whole boundary table in VMEM and runs a
// branch-free binary search with a fixed trip count, so a tile advances in
// lock step.
//
// Bound on H100: bytes. A search is about log2(column width) compares (5 at
// the MSE model's 17 boundaries) against 16 B of traffic per value: 4 B
// value, 4 B column id, 8 B result. Least time = N * 16 B (+ the table) over
// 3.35 TB/s.
//
// Design: one thread per value, a grid-stride loop over N. The boundary
// table and the offsets are staged in shared memory when they fit (the MSE
// model: 340 floats and 21 offsets; the operator benchmark's 100 columns:
// about 14 KB), so every compare reads shared memory, not L2; a larger table
// is read through the read-only cache. The search loop ends when lo == hi,
// which gives the Pallas kernel's answer: its fixed trip count of
// ceil(log2(max width)) + 1 is at least the number of halvings, and once lo
// == hi its steps change nothing (mid == hi fails `mid < hi`). The compare
// is `v >= b`, as there: a value equal to a boundary goes right, -inf gives
// 0, +inf the column's width, NaN 0 (every compare is false), and -0.0
// compares equal to 0.0. Subnormal values and boundaries compare as zero,
// as XLA (on the CPU, where the reference's tests run) and the TPU compare
// them: the kernel flushes them itself, so its answer does not depend on
// the build's -ftz setting. Column ids are clamped into the table, so a bad
// id cannot read outside it.
#include <cuda_runtime.h>

#include <cfloat>
#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kSmemLimit = 48 * 1024;  // bytes without an opt-in attribute

__device__ __forceinline__ float flush_subnormal(float x) {
  return fabsf(x) < FLT_MIN ? 0.0f : x;  // NaN and the infinities pass
}

template <bool kStaged>
__device__ __forceinline__ int64_t bucketize_one(float v, const float* bounds, int lo, int hi) {
  const int base = lo;
  while (lo < hi) {  // upper bound: first position whose boundary is > v
    const int mid = lo + ((hi - lo) >> 1);
    const float b = kStaged ? bounds[mid] : flush_subnormal(__ldg(bounds + mid));
    if (v >= b) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return static_cast<int64_t>(lo - base);
}

template <bool kStaged>
__global__ void __launch_bounds__(kThreads)
fused_bucketize_kernel(const float* __restrict__ vals, const int32_t* __restrict__ cids,
                       const float* __restrict__ bounds, const int32_t* __restrict__ offs,
                       int64_t* __restrict__ out, int64_t N, int B, int C) {
  extern __shared__ float smem[];  // [C + 1 offsets as int32][B boundaries]
  const int32_t* o = offs;
  const float* b = bounds;
  if (kStaged) {
    int32_t* so = reinterpret_cast<int32_t*>(smem);
    float* sb = smem + (C + 1);
    for (int i = threadIdx.x; i <= C; i += blockDim.x) so[i] = offs[i];
    for (int i = threadIdx.x; i < B; i += blockDim.x) sb[i] = flush_subnormal(bounds[i]);
    __syncthreads();
    o = so;
    b = sb;
  }
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < N; i += stride) {
    const int c = min(max(__ldg(cids + i), 0), C - 1);
    const int lo = kStaged ? o[c] : __ldg(o + c);
    const int hi = kStaged ? o[c + 1] : __ldg(o + c + 1);
    out[i] = bucketize_one<kStaged>(flush_subnormal(__ldg(vals + i)), b, lo, hi);
  }
}

}  // namespace

// vals (N,) fp32, cids (N,) int32, bounds (B,) fp32 sorted within each
// column, offs (C+1,) int32 ascending in [0, B], out (N,) int64; all
// contiguous on the device. Launches on `stream`, does not synchronise.
extern "C" int repro_fused_bucketize(const void* vals, const void* cids, const void* bounds,
                                     const void* offs, void* out, int64_t N, int64_t B, int64_t C,
                                     int sm_count, void* stream) {
  if (N <= 0 || B < 0 || C <= 0 || B > INT_MAX || C >= INT_MAX || sm_count <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t smem = (C + 1 + B) * 4;
  const int64_t blocks_needed = (N + kThreads - 1) / kThreads;
  const int64_t max_blocks = static_cast<int64_t>(sm_count) * 8;  // 8 x 256 threads fill an SM
  const dim3 grid(static_cast<unsigned>(blocks_needed < max_blocks ? blocks_needed : max_blocks));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* v = static_cast<const float*>(vals);
  const int32_t* c = static_cast<const int32_t*>(cids);
  const float* b = static_cast<const float*>(bounds);
  const int32_t* o = static_cast<const int32_t*>(offs);
  int64_t* r = static_cast<int64_t*>(out);
  if (smem <= kSmemLimit) {
    fused_bucketize_kernel<true><<<grid, kThreads, static_cast<size_t>(smem), st>>>(
        v, c, b, o, r, N, static_cast<int>(B), static_cast<int>(C));
  } else {
    fused_bucketize_kernel<false><<<grid, kThreads, 0, st>>>(
        v, c, b, o, r, N, static_cast<int>(B), static_cast<int>(C));
  }
  return static_cast<int>(cudaGetLastError());
}
