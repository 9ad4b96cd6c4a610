// sequence_tile: concat pooling of a CSR column, and its gradient.
//
// Forward: out[i, j, :] = vals[min(splits[i] + j, N - 1), :] when splits[i]
// + j < splits[i + 1], else 0, for rows i < S and slots j < k: the first k
// value rows of each CSR row, zero-filled past its length, as (S, k * D).
//
// Replaces the TPU kernel repro/kernels/sequence_tile/sequence_tile.py::
// sequence_tile_padded (_kernel): a (row, slot) grid whose scalar-prefetched
// splits address the value row of each step, so the DMA engine streams
// exactly the rows the output needs and the core predicates the copy.
//
// Bound on H100: bytes. A copy: least time = (live slots * D + S * k * D) *
// 4 B (+ the splits) over 3.35 TB/s.
//
// Design: one thread per 16-byte float4 of the output (a 4-byte float where
// D % 4 != 0 or a pointer is not 16-byte aligned), so neighbouring threads
// store neighbouring addresses and a row of D = 8 is two threads. The
// thread reads its row's two splits (cached: the k * D / 4 threads of a row
// share them) and copies or writes zero. Every output element has one
// writer: no memset, no atomics. The padding slots write +0.0, as the
// Pallas kernel does (the reference's `rows[idx] * mask` gives -0.0 where
// the clamped source is negative; the two compare equal).
//
// Gradient (sequence_untile): dv[p, :] = g[r, p - splits[r], :] for the row
// r with splits[r] <= p < splits[r + 1] when p - splits[r] < k, and 0
// otherwise: rows longer than k past their k-th value, and positions
// outside [splits[0], splits[S]) (the padding tail). It is the transpose
// of the forward when splits[S] <= N, which a Ragged column guarantees.
// One thread per float4 (or float) of dv; each finds its row by a binary
// search over the splits (17 steps at 65,536 rows, reads that stay in L1
// and L2), then copies or writes zero: every position written once, so no
// memset and no atomics.
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;

template <typename Idx, typename Vec>
__global__ void __launch_bounds__(kThreads)
sequence_tile_kernel(const Vec* __restrict__ vals, const Idx* __restrict__ splits,
                     Vec* __restrict__ out, int64_t N, int64_t S, int64_t k, int64_t dv) {
  const int64_t total = S * k * dv;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; e < total; e += stride) {
    const int64_t c = e % dv;
    const int64_t slot = e / dv;
    const int64_t j = slot % k;
    const int64_t i = slot / k;
    const int64_t src = static_cast<int64_t>(__ldg(splits + i)) + j;
    Vec x{};  // zero
    if (src < static_cast<int64_t>(__ldg(splits + i + 1))) {
      x = __ldg(vals + min(max(src, int64_t{0}), N - 1) * dv + c);
    }
    out[e] = x;
  }
}

template <typename Idx, typename Vec>
__global__ void __launch_bounds__(kThreads)
sequence_untile_kernel(const Vec* __restrict__ g, const Idx* __restrict__ splits,
                       Vec* __restrict__ out, int64_t N, int64_t S, int64_t k, int64_t dv) {
  const int64_t total = N * dv;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t first = static_cast<int64_t>(__ldg(splits));
  const int64_t last = static_cast<int64_t>(__ldg(splits + S));
  for (int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; e < total; e += stride) {
    const int64_t c = e % dv;
    const int64_t p = e / dv;
    Vec x{};  // zero
    if (p >= first && p < last) {
      int64_t lo = 0, hi = S + 1;  // upper bound of p in splits[0..S]
      while (lo < hi) {
        const int64_t mid = lo + ((hi - lo) >> 1);
        if (static_cast<int64_t>(__ldg(splits + mid)) <= p) {
          lo = mid + 1;
        } else {
          hi = mid;
        }
      }
      const int64_t r = lo - 1;  // splits[r] <= p < splits[r + 1]
      const int64_t off = p - static_cast<int64_t>(__ldg(splits + r));
      if (off < k) x = __ldg(g + (r * k + off) * dv + c);
    }
    out[e] = x;
  }
}

int64_t grid_for(int64_t total, int sm_count) {
  const int64_t needed = (total + kThreads - 1) / kThreads;
  const int64_t cap = static_cast<int64_t>(sm_count) * 8;  // 8 x 256 threads fill an SM
  return needed < cap ? needed : cap;
}

template <template <typename, typename> class Launch>
int dispatch(const void* src, const void* splits, int splits_are_int64, void* dst, int64_t N,
             int64_t S, int64_t k, int64_t D, int64_t total_rows, int sm_count, void* stream) {
  const bool vec4 = D % 4 == 0 &&
      ((reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst)) % 16) == 0;
  const int64_t dv = vec4 ? D / 4 : D;
  const dim3 grid(static_cast<unsigned>(grid_for(total_rows * dv, sm_count)));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (splits_are_int64) {
    if (vec4) Launch<int64_t, float4>::run(grid, st, src, splits, dst, N, S, k, dv);
    else Launch<int64_t, float>::run(grid, st, src, splits, dst, N, S, k, dv);
  } else {
    if (vec4) Launch<int32_t, float4>::run(grid, st, src, splits, dst, N, S, k, dv);
    else Launch<int32_t, float>::run(grid, st, src, splits, dst, N, S, k, dv);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename Idx, typename Vec>
struct TileLaunch {
  static void run(dim3 grid, cudaStream_t st, const void* src, const void* splits, void* dst,
                  int64_t N, int64_t S, int64_t k, int64_t dv) {
    sequence_tile_kernel<Idx, Vec><<<grid, kThreads, 0, st>>>(
        static_cast<const Vec*>(src), static_cast<const Idx*>(splits), static_cast<Vec*>(dst), N, S, k, dv);
  }
};

template <typename Idx, typename Vec>
struct UntileLaunch {
  static void run(dim3 grid, cudaStream_t st, const void* src, const void* splits, void* dst,
                  int64_t N, int64_t S, int64_t k, int64_t dv) {
    sequence_untile_kernel<Idx, Vec><<<grid, kThreads, 0, st>>>(
        static_cast<const Vec*>(src), static_cast<const Idx*>(splits), static_cast<Vec*>(dst), N, S, k, dv);
  }
};

}  // namespace

// vals (N, D) fp32, splits (S+1,) int32 or int64 ascending, out (S, k, D)
// fp32; all contiguous on the device. Launches on `stream`, does not
// synchronise.
extern "C" int repro_sequence_tile(const void* vals, const void* splits, int splits_are_int64,
                                   void* out, int64_t N, int64_t S, int64_t k, int64_t D,
                                   int sm_count, void* stream) {
  if (N <= 0 || S <= 0 || k <= 0 || D <= 0 || sm_count <= 0) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch<TileLaunch>(vals, splits, splits_are_int64, out, N, S, k, D, S * k, sm_count, stream);
}

// g (S, k, D) fp32, splits (S+1,) int32 or int64 ascending with splits[S]
// <= N, out (N, D) fp32; all contiguous on the device. Launches on
// `stream`, does not synchronise.
extern "C" int repro_sequence_untile(const void* g, const void* splits, int splits_are_int64,
                                     void* out, int64_t N, int64_t S, int64_t k, int64_t D,
                                     int sm_count, void* stream) {
  if (N <= 0 || S < 0 || k <= 0 || D <= 0 || sm_count <= 0) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch<UntileLaunch>(g, splits, splits_are_int64, out, N, S, k, D, N, sm_count, stream);
}
