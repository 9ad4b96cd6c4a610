// segment_reduce.segment_sum: the forward, out[s] = sum of the value rows
// [bounds[s], bounds[s+1]), the CSR form of a sum over sorted segment ids;
// and its gradient, segment_expand_csr (below the forward).
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
