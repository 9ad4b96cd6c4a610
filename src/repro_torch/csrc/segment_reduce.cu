// segment_reduce.segment_sum (forward): out[s] = sum of the value rows
// [bounds[s], bounds[s+1]), the CSR form of a sum over sorted segment ids.
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
