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
// outside [splits[0], splits[S]) (the head and the padding tail). It is the
// transpose of the forward when splits[S] <= N, which a Ragged column
// guarantees. Bound on H100: bytes, (copied positions + N) * D * 4 B (+ the
// splits) over 3.35 TB/s.
//
// Design: row-driven, so no position searches for its row (the kernel
// this replaced ran a 17-step binary search over the splits for every
// float4 it wrote). A block takes a run of kUntileThreads rows, whose
// positions are one contiguous run [splits[r0], splits[r0 + 64]): each
// row's thread reads its two splits once and marks its first min(len, k)
// positions with its row in a shared-memory map of the run (a window of
// kUntileWindow positions at a time); then the block's threads walk the
// window's positions in order, each a float4 of g's slot or a zero where
// the map has no row, kUntileUnroll loads in flight a thread. So the
// writes of dv are dense and in order, and the rest of a row longer than
// k is zeros that the whole block writes, not one thread's loop. The
// first blocks (at most one an SM, so they start at once) write the head
// [0, splits[0]) and the tail [splits[S], N) as zeros. Every position has
// one writer: no memset, no atomics. Splits are clamped to [0, N], so no
// input writes outside dv.
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

constexpr int kUntileThreads = 64;  // a block takes a row a thread
constexpr int kUntileWindow = 2048;  // positions a block maps at once (8 KB of shared memory)
constexpr int kUntileUnroll = 8;     // elements a thread has in flight

template <typename Idx>
__device__ __forceinline__ int64_t clamp_split(const Idx* splits, int64_t i, int64_t N) {
  const int64_t x = static_cast<int64_t>(__ldg(splits + i));
  return x < 0 ? 0 : (x > N ? N : x);
}

// Blocks [0, zero_blocks) write the head and the tail; each later block
// takes runs of kUntileThreads rows.
template <typename Idx, typename Vec>
__global__ void __launch_bounds__(kUntileThreads)
sequence_untile_kernel(const Vec* __restrict__ g, const Idx* __restrict__ splits,
                       Vec* __restrict__ out, int64_t N, int64_t S, int64_t k, int64_t dv, int zero_blocks) {
  if (static_cast<int>(blockIdx.x) < zero_blocks) {  // [0, splits[0]) and [splits[S], N)
    const int64_t first = clamp_split(splits, 0, N);
    int64_t last = clamp_split(splits, S, N);
    last = last < first ? first : last;
    const int64_t head = first * dv;
    const int64_t total = head + (N - last) * dv;
    const int64_t stride = static_cast<int64_t>(zero_blocks) * blockDim.x;
    for (int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; e < total; e += stride) {
      out[e < head ? e : e - head + last * dv] = Vec{};
    }
    return;
  }
  __shared__ int row_at[kUntileWindow];      // the block's row of each copied position of the window, else -1
  __shared__ int64_t row_start[kUntileThreads];  // each row's first position
  const int t = threadIdx.x;
  const int d = static_cast<int>(dv), kd = static_cast<int>(k * dv);
  const bool pow2 = (d & (d - 1)) == 0;
  const int shift = __ffs(d) - 1;
  for (int64_t r0 = (blockIdx.x - zero_blocks) * int64_t{kUntileThreads}; r0 < S;
       r0 += (gridDim.x - zero_blocks) * int64_t{kUntileThreads}) {
    const int n_rows = S - r0 < kUntileThreads ? static_cast<int>(S - r0) : kUntileThreads;
    // the rows' positions: [p_begin, p_end), one contiguous run
    const int64_t p_begin = clamp_split(splits, r0, N);
    const int64_t p_end = max(clamp_split(splits, r0 + n_rows, N), p_begin);
    int64_t s0 = p_end, s1 = p_end;
    if (t < n_rows) {
      s0 = min(max(clamp_split(splits, r0 + t, N), p_begin), p_end);
      s1 = min(max(clamp_split(splits, r0 + t + 1, N), s0), p_end);
      row_start[t] = s0;
    }
    for (int64_t w0 = p_begin; w0 < p_end; w0 += kUntileWindow) {  // one window at a time
      const int n_pos = p_end - w0 < kUntileWindow ? static_cast<int>(p_end - w0) : kUntileWindow;
      for (int i = t; i < n_pos; i += kUntileThreads) row_at[i] = -1;
      __syncthreads();
      // a row maps only its first k positions: the rest of a long row is
      // zeros that the whole block writes
      for (int64_t p = max(s0, w0); p < min(min(s1, s0 + k), w0 + n_pos); ++p) row_at[p - w0] = t;
      __syncthreads();
      // every position of the window, in order: g's slot or a zero; 32-bit
      // offsets from the block's rows of g and the window's first element
      const int n_el = n_pos * d;
      const Vec* g_rows = g + r0 * k * dv;
      Vec* out_w = out + w0 * dv;
      for (int q0 = t; q0 < n_el; q0 += kUntileThreads * kUntileUnroll) {
        Vec x[kUntileUnroll];
#pragma unroll
        for (int u = 0; u < kUntileUnroll; ++u) {
          const int q = q0 + u * kUntileThreads;
          x[u] = Vec{};
          if (q < n_el) {
            const int pl = pow2 ? q >> shift : q / d;
            const int row = row_at[pl];
            if (row >= 0) x[u] = __ldg(g_rows + row * kd + static_cast<int>(w0 + pl - row_start[row]) * d + (q - pl * d));
          }
        }
#pragma unroll
        for (int u = 0; u < kUntileUnroll; ++u)
          if (q0 + u * kUntileThreads < n_el) out_w[q0 + u * kUntileThreads] = x[u];
      }
      __syncthreads();  // the map is read before the next window writes it
    }
  }
}

int64_t grid_for(int64_t total, int sm_count) {
  const int64_t needed = (total + kThreads - 1) / kThreads;
  const int64_t cap = static_cast<int64_t>(sm_count) * 8;  // 8 x 256 threads fill an SM
  return needed < cap ? needed : cap;
}

template <template <typename, typename> class Launch>
int dispatch(const void* src, const void* splits, int splits_are_int64, void* dst, int64_t N,
             int64_t S, int64_t k, int64_t D, int sm_count, void* stream) {
  const bool vec4 = D % 4 == 0 &&
      ((reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst)) % 16) == 0;
  const int64_t dv = vec4 ? D / 4 : D;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (splits_are_int64) {
    if (vec4) Launch<int64_t, float4>::run(st, src, splits, dst, N, S, k, dv, sm_count);
    else Launch<int64_t, float>::run(st, src, splits, dst, N, S, k, dv, sm_count);
  } else {
    if (vec4) Launch<int32_t, float4>::run(st, src, splits, dst, N, S, k, dv, sm_count);
    else Launch<int32_t, float>::run(st, src, splits, dst, N, S, k, dv, sm_count);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename Idx, typename Vec>
struct TileLaunch {
  static void run(cudaStream_t st, const void* src, const void* splits, void* dst, int64_t N, int64_t S,
                  int64_t k, int64_t dv, int sm_count) {
    const dim3 grid(static_cast<unsigned>(grid_for(S * k * dv, sm_count)));
    sequence_tile_kernel<Idx, Vec><<<grid, kThreads, 0, st>>>(
        static_cast<const Vec*>(src), static_cast<const Idx*>(splits), static_cast<Vec*>(dst), N, S, k, dv);
  }
};

template <typename Idx, typename Vec>
struct UntileLaunch {
  static void run(cudaStream_t st, const void* src, const void* splits, void* dst, int64_t N, int64_t S,
                  int64_t k, int64_t dv, int sm_count) {
    const int64_t needed = (S + kUntileThreads - 1) / kUntileThreads;
    const int64_t cap = static_cast<int64_t>(sm_count) * 32;  // 32 x 64 threads fill an SM
    const int64_t row_blocks = needed < cap ? needed : cap;
    const int64_t zero_needed = (N * dv + kUntileThreads - 1) / kUntileThreads;  // the most the head and tail hold
    const int zero_blocks = static_cast<int>(zero_needed < sm_count ? zero_needed : sm_count);
    sequence_untile_kernel<Idx, Vec><<<static_cast<unsigned>(zero_blocks + row_blocks), kUntileThreads, 0, st>>>(
        static_cast<const Vec*>(src), static_cast<const Idx*>(splits), static_cast<Vec*>(dst), N, S, k, dv,
        zero_blocks);
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
  return dispatch<TileLaunch>(vals, splits, splits_are_int64, out, N, S, k, D, sm_count, stream);
}

// g (S, k, D) fp32, splits (S+1,) int32 or int64 ascending with splits[S]
// <= N, out (N, D) fp32; all contiguous on the device. Launches on
// `stream`, does not synchronise.
extern "C" int repro_sequence_untile(const void* g, const void* splits, int splits_are_int64,
                                     void* out, int64_t N, int64_t S, int64_t k, int64_t D,
                                     int sm_count, void* stream) {
  // a block's offsets are 32-bit: kUntileWindow positions, kUntileThreads rows of g
  if (N <= 0 || S < 0 || k <= 0 || D <= 0 || D > INT_MAX / kUntileWindow || k * D > INT_MAX / kUntileThreads ||
      sm_count <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return dispatch<UntileLaunch>(g, splits, splits_are_int64, out, N, S, k, D, sm_count, stream);
}
