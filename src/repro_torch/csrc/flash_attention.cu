// flash_attention: causal (or full) attention of queries (B, T, H, hd) over
// keys and values (B, T, Hk, hd), H a multiple of Hk, with fp32 softmax
// statistics; writes O (B, T, H, hd) in the input type and LSE = m + log l
// (B, H, T) in fp32, and its backward dQ, dK, dV. Two kernel families:
//
//   bf16 (namespace tc): every product on the tensor cores with wgmma,
//                        bf16 operands, fp32 accumulation; tiles arrive by
//                        TMA and complete on mbarriers. sm_90a only.
//   fp32 (the rest):     every product as fp32 FMAs on the CUDA cores. On
//                        the tensor cores fp32 would run as TF32, which
//                        cannot hold fp32's tolerance; no full-width path
//                        runs attention in fp32.
//
// Both replace the TPU kernels repro/kernels/flash_attention/
// flash_attention.py::flash_fwd (_fwd_kernel) and ::flash_bwd (_dkv_kernel,
// _dq_kernel), and with them what surrounds those calls: the
// (B, T, H, hd) -> (BH, T, hd) transposes and the T / hd padding of
// repro/kernels/flash_attention/ops.py, the kv-head repeat of
// repro/models/attention.py::_expand_kv (query head h reads kv head
// h / (H / Hk) through its strides), the delta = rowsum(dO·O) beside the
// backward, and the sum of dK, dV over each kv head's G query heads (the
// transpose of _expand_kv, which the reference gets by autodiff).
//
// ---- bf16, forward (flash_fwd_tc_kernel). Bound on H100: operations. A
// causal launch does 4 * hd * H * B * T(T+1)/2 flops over O(B T H hd)
// bytes: at B 1, T 32,768, H 16, hd 128 that is 4.4 TFLOP over 0.3 GB, so
// the least time is flops / 989 TFLOP/s (bf16 tensor cores), 4.4 ms.
// Design: a CTA per (128 query rows, head, batch row), the late (heavy)
// query tiles first, of three warpgroups. Warpgroup 2 is the producer: one
// thread loads the Q tile and keeps a ring of two stages of K and V tiles
// (64 keys at hd 128, 128 at hd 64) in flight by TMA (4-D maps of the
// strided views, boxes of 64 rows x 64 columns with the 128-byte swizzle,
// zeros past T), and gives its registers to the consumers (setmaxnreg
// 24 / 240). Warpgroups 0 and 1 own 64 query rows each: S = Q K^T by wgmma
// from shared memory (both operands K-major), the online softmax on the
// fp32 accumulator (a thread holds two rows; a row reduces over the 4
// lanes of a quad), P split in registers into hi + lo bf16 terms (kSplit)
// that feed two register-A products O += P V, V read MN-major through the
// descriptor's transpose bit. Only tiles up to the diagonal are loaded;
// only the diagonal and tail tiles are masked; a warpgroup skips a tile
// wholly past its rows' diagonal. A 64-key tile at hd 128 keeps S, P and O
// within a consumer's registers (a 128-key one spills).
//
// ---- bf16, backward (flash_bwd_dq_tc_kernel, flash_bwd_dkv_tc_kernel,
// then flash_bwd_group_sum_kernel). Bound on H100: operations. The least
// work is five products over the lower triangle (S, dP, dV, dQ, dK):
// 5 * hd * H * B * T(T+1) flops; at the qwen2.5-3b train shape (B 1, T
// 4,096, H 16, hd 128) 1.72e11 flops over about 70 MB, 0.174 ms. These
// kernels run seven (S and dP in each of the first two, as the reference's
// two kernels do), and the split issues dV, dQ and dK twice. Three launches
// on one stream and no atomics, so every result repeats bit for bit:
//  1. dQ: a CTA per (128 query rows, query head, batch row), the producer
//     loading Q and dO once and streaming 64-key K and V tiles. Its
//     prologue forms delta for its rows from O and dO (kept, and written
//     for launch 2). Per tile: S = Q K^T and dP = dO V^T (both K-major),
//     dS = P (dP - delta) scale in registers, dQ += dS K (K MN-major).
//  2. dK, dV: a CTA per (64 keys, query head, batch row), the early
//     (heavy) key tiles first. K and V stay resident; 64-row tiles of Q and
//     dO stream in by TMA while the producer warp's lanes stage the LSE and
//     delta of their rows (setmaxnreg 40 / 232). The transposed tiles keep
//     P^T and dS^T on the register path, and the two consumer warpgroups
//     split the products: warpgroup 0 forms S^T = K Q^T, P^T and
//     dV += P^T dO and hands P^T to warpgroup 1 through shared memory
//     (double-buffered, named barriers); warpgroup 1 forms dP^T = V dO^T,
//     dS^T and dK += dS^T Q (dO and Q MN-major). A thread holds one
//     64 x hd accumulator, not two, which would spill. It writes fp32
//     partial dK and dV of its query head. One CTA per query head, not per
//     kv head looping over its group: at the train shape that is 1,024 CTAs,
//     not 128 on 132 SMs.
//  3. group sum: dK, dV (B, T, Hk, hd) in bf16, each the sum of its G
//     partials in a fixed order.
// Head dims 64 and 128 (the wrapper pads smaller bf16 ones to 64 with
// zeros). P and dS enter the tensor cores as hi + lo bf16 pairs, about 16
// bits where the reference keeps fp32; the statistics, the accumulators
// and delta stay fp32. Keys at or past T are masked; rows of O, dQ, dK and
// dV at or past T are never written. A bf16 input these kernels refuse
// returns an error; it never goes to the fp32 kernels.
//
// ---- fp32, forward (flash_fwd_kernel). The same bound; this kernel runs
// both products as fp32 FMAs on the CUDA cores (67 TFLOP/s peak), 1/15 of
// the bf16 tensor-core rate.
//
// Design: one CTA of 256 threads per (query tile of 64 rows, head, batch
// row); the late query tiles, which see the most keys, are scheduled first.
// The Q tile is converted to fp32 into shared memory once. Each key tile of
// 64 rows up to the diagonal is staged in fp32 in one shared buffer that
// holds K while S = Q K^T is formed and then V while O += P V is summed, so
// two CTAs fit on an SM at hd = 128 (86 KB each). Thread (ty, tx) owns rows
// ty + 16 i (i < 4) of S, O, m and l, and columns tx + 16 j (j < 4) of S:
// the row max and sum reduce over the 16 lanes of a half-warp with
// shuffles, and the row's rescale factor never leaves the registers of the
// threads that own the row. Row strides of 4 (Q, K) and 16 (P) floats of
// padding keep the 16-byte shared loads free of bank conflicts. Rows and
// keys past T are zero-filled and masked with -1e30, as the padded
// reference masks them; l is clamped at 1e-30 before the division.
//
// ---- fp32, backward (flash_bwd_dq_kernel, flash_bwd_dkv_kernel,
// flash_bwd_group_sum_kernel): the same bound, seven products as fp32 FMAs.
// Design: three launches on one stream and no atomics, so every result is
// the same from run to run.
//  1. dQ: one CTA per (query tile of 64 rows, query head, batch row), heavy
//     tiles first. Its prologue stages Q and dO in fp32 and forms delta for
//     its rows (kept, and written for launch 2); then it walks the key
//     tiles up to the diagonal: K and V staged, S = Q K^T and dP = dO V^T
//     formed in one pass, dS = P (dP - delta) scale to shared memory, and
//     dQ += dS K summed in registers.
//  2. dK, dV: one CTA per (key tile of 64 rows, query head, batch row), the
//     early key tiles, which see the most queries, first. K and V stay
//     staged while the CTA walks the query tiles from the diagonal down:
//     the transposed tiles S^T and dP^T (keys on rows), then P^T and dS^T
//     to shared memory, and dV += P^T dO, dK += dS^T Q in registers. It
//     writes fp32 partial dK and dV (B, T, H, hd) of its query head. One
//     CTA per query head rather than per kv head looping over its group: at
//     the train shape that is 1,024 CTAs, not 128 on 132 SMs with the
//     causal triangle leaving half of their work idle.
//  3. group sum: dK, dV (B, T, Hk, hd) in the input type, each the sum of
//     its G partials in a fixed order.
// As in the forward, thread (ty, tx) owns rows ty + 16 i and columns
// tx + 16 j (i, j < 4) of each 64 x 64 score tile, and rows ty + 16 i of
// its accumulators; tiles are fp32 with the forward's padded strides. At
// hd 128 launches 1 and 2 take 152 and 173 KB of shared memory: one CTA per
// SM. Rows and keys past T are zero-filled and masked to P = 0.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "hopper.cuh"

namespace {

constexpr int kBQ = 64;       // query rows per CTA
constexpr int kBK = 64;       // key rows per staged tile
constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;

template <int HD>
struct Layout {
  static constexpr int LD = HD + 4;     // row stride of the Q and K/V tiles, floats
  static constexpr int LDP = kBK + 16;  // row stride of the P tile
  static constexpr int CPT = HD / 16;   // O columns per thread
  static constexpr int VEC = CPT < 4 ? CPT : 4;
  static constexpr int NCH = CPT / VEC;  // column chunks of VEC floats
  static constexpr size_t kSmemBytes =
      sizeof(float) * (size_t(kBQ) * LD + size_t(kBK) * LD + size_t(kBQ) * LDP);
};

// 16 bytes of the input (4 fp32) to fp32 in shared memory.
__device__ __forceinline__ void load16(const float* src, float* dst) {
  *reinterpret_cast<float4*>(dst) = __ldg(reinterpret_cast<const float4*>(src));
}

__device__ __forceinline__ void store(float* dst, float x) { *dst = x; }

__device__ __forceinline__ float to_float(float x) { return x; }

__device__ __forceinline__ float lane(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

__device__ __forceinline__ float dot4(const float4& a, const float4& b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// The CPT columns thread tx owns (VEC * tx + 16 * VEC * ch + e) of one fp32
// tile row.
template <int HD>
__device__ __forceinline__ void read_cols(const float* row, int tx, float (&out)[Layout<HD>::CPT]) {
  using L = Layout<HD>;
#pragma unroll
  for (int ch = 0; ch < L::NCH; ++ch) {
    const float* src = row + L::VEC * tx + 16 * L::VEC * ch;
    if constexpr (L::VEC == 4) {
      const float4 t4 = *reinterpret_cast<const float4*>(src);
      out[4 * ch] = t4.x; out[4 * ch + 1] = t4.y; out[4 * ch + 2] = t4.z; out[4 * ch + 3] = t4.w;
    } else if constexpr (L::VEC == 2) {
      const float2 t2 = *reinterpret_cast<const float2*>(src);
      out[2 * ch] = t2.x; out[2 * ch + 1] = t2.y;
    } else {
      out[ch] = *src;
    }
  }
}

// Rows [row0, row0 + 64) of a (T, HD) matrix whose rows are `row_stride`
// elements apart, to fp32 tile s[64][LD]; rows at or past T are zeros.
template <typename T, int HD>
__device__ __forceinline__ void load_tile(float* s, const T* base, int64_t row_stride, int row0,
                                          int n_rows) {
  constexpr int E = 16 / sizeof(T);  // elements per 16-byte chunk
  constexpr int CH = HD / E;         // chunks per row
  for (int c = threadIdx.x; c < kBK * CH; c += kThreads) {
    const int r = c / CH, e = (c % CH) * E;
    float* dst = s + r * Layout<HD>::LD + e;
    const int t = row0 + r;
    if (t < n_rows) {
      load16(base + t * row_stride + e, dst);
    } else {
#pragma unroll
      for (int k = 0; k < E; k += 4) *reinterpret_cast<float4*>(dst + k) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, float* __restrict__ lse, int n_tok, int H, int group,
                 int64_t sqb, int64_t sqt, int64_t sqh, int64_t skb, int64_t skt, int64_t skh,
                 int64_t svb, int64_t svt, int64_t svh, float scale, bool causal) {
  using L = Layout<HD>;
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;
  float* sKV = sQ + kBQ * L::LD;
  float* sP = sKV + kBK * L::LD;

  const int qt = gridDim.x - 1 - blockIdx.x;  // late (heavy) query tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = qt * kBQ;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const T* kbase = k + b * skb + (h / group) * skh;
  const T* vbase = v + b * svb + (h / group) * svh;
  load_tile<T, HD>(sQ, q + b * sqb + h * sqh, sqt, q0, n_tok);

  float acc[4][L::CPT];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < L::CPT; ++c) acc[i][c] = 0.f;
  }

  const int nk = causal ? qt + 1 : (n_tok + kBK - 1) / kBK;
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the last tile's V and P reads are done
    load_tile<T, HD>(sKV, kbase, skt, k0, n_tok);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; d += 4) {
      float4 kf[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) kf[j] = *reinterpret_cast<const float4*>(sKV + (tx + 16 * j) * L::LD + d);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 qf = *reinterpret_cast<const float4*>(sQ + (ty + 16 * i) * L::LD + d);
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dot4(qf, kf[j], s[i][j]);
      }
    }

    // scale, mask, online softmax; P to shared memory
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        float x = s[i][j] * scale;
        if (col >= n_tok || (causal && col > row)) x = kNegInf;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off, 16));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = __expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = __expf(s[i][j] - m_new);
        rs += p;
        sP[(ty + 16 * i) * L::LDP + tx + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, off, 16);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < L::CPT; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();  // S is formed: the buffer may take V; P is complete
    load_tile<T, HD>(sKV, vbase, svt, k0, n_tok);
    __syncthreads();

#pragma unroll 2
    for (int j = 0; j < kBK; j += 4) {
      float4 pf[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pf[i] = *reinterpret_cast<const float4*>(sP + (ty + 16 * i) * L::LDP + j);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        float vv[L::CPT];
        read_cols<HD>(sKV + (j + jj) * L::LD, tx, vv);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = lane(pf[i], jj);
#pragma unroll
          for (int c = 0; c < L::CPT; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= n_tok) continue;
    const float lc = fmaxf(l[i], 1e-30f);
    T* orow = o + ((static_cast<int64_t>(b) * n_tok + row) * H + h) * HD + L::VEC * tx;
#pragma unroll
    for (int ch = 0; ch < L::NCH; ++ch)
#pragma unroll
      for (int e = 0; e < L::VEC; ++e) store(orow + 16 * L::VEC * ch + e, acc[i][ch * L::VEC + e] / lc);
    if (tx == 0) lse[(static_cast<int64_t>(b) * H + h) * n_tok + row] = m[i] + logf(lc);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, void* lse, int B, int n_tok,
                   int H, int group, const int64_t* st, float scale, bool causal, cudaStream_t stream) {
  auto kern = flash_fwd_kernel<T, HD>;
  const size_t smem = Layout<HD>::kSmemBytes;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((n_tok + kBQ - 1) / kBQ, H, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), static_cast<T*>(o),
      static_cast<float*>(lse), n_tok, H, group, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
      st[8], scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_hd(int hd, const void* q, const void* k, const void* v, void* o, void* lse, int B,
                      int n_tok, int H, int group, const int64_t* st, float scale, bool causal,
                      cudaStream_t s) {
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, o, lse, B, n_tok, H, group, st, scale, causal, s);
    case 32: return launch<T, 32>(q, k, v, o, lse, B, n_tok, H, group, st, scale, causal, s);
    case 64: return launch<T, 64>(q, k, v, o, lse, B, n_tok, H, group, st, scale, causal, s);
    case 128: return launch<T, 128>(q, k, v, o, lse, B, n_tok, H, group, st, scale, causal, s);
    default: return cudaErrorInvalidValue;
  }
}


// ------------------------------------------------------------------ backward

struct Str3 {
  int64_t b, t, h;  // strides in elements
};

template <typename T>
struct BwdParams {
  const T *q, *k, *v, *o, *dout;
  const float* lse;       // (B, H, T)
  T *dq, *dk, *dv;        // (B, T, H, hd), (B, T, Hk, hd) x 2, contiguous
  float* delta;           // (B, H, T) scratch: rowsum(dO * O)
  float *dk_part, *dv_part;  // (B, T, H, hd) scratch, per query head
  Str3 sq, sk, sv, so, sdo;
  int n_tok, H, group;
  float scale;
  bool causal;
};

template <int HD>
struct BwdLayout {
  using L = Layout<HD>;
  // dQ kernel: Q, dO, K, V tiles, the dS tile, then LSE and delta of the rows
  static constexpr size_t kDqSmem =
      sizeof(float) * (4 * size_t(kBQ) * L::LD + size_t(kBQ) * L::LDP + 2 * kBQ);
  // dK/dV kernel: K, V, Q, dO tiles, the P^T and dS^T tiles, LSE and delta
  static constexpr size_t kDkvSmem =
      sizeof(float) * (4 * size_t(kBQ) * L::LD + 2 * size_t(kBK) * L::LDP + 2 * kBQ);
};

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 1) flash_bwd_dq_kernel(const BwdParams<T> a) {
  using L = Layout<HD>;
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;
  float* sdO = sQ + kBQ * L::LD;
  float* sK = sdO + kBQ * L::LD;
  float* sV = sK + kBK * L::LD;
  float* sdS = sV + kBK * L::LD;
  float* sLse = sdS + kBQ * L::LDP;
  float* sDelta = sLse + kBQ;

  const int qt = gridDim.x - 1 - blockIdx.x;  // late (heavy) query tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = qt * kBQ, n_tok = a.n_tok;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int hk = h / a.group;
  load_tile<T, HD>(sQ, a.q + b * a.sq.b + h * a.sq.h, a.sq.t, q0, n_tok);
  load_tile<T, HD>(sdO, a.dout + b * a.sdo.b + h * a.sdo.h, a.sdo.t, q0, n_tok);
  __syncthreads();

  // delta = rowsum(dO * O) and the LSE of the tile's rows: 4 threads a row
  {
    const int r = threadIdx.x >> 2, part = threadIdx.x & 3, row = q0 + r;
    float acc = 0.f;
    if (row < n_tok) {
      const T* orow = a.o + b * a.so.b + row * a.so.t + h * a.so.h;
      for (int d = part; d < HD; d += 4) acc = fmaf(to_float(orow[d]), sdO[r * L::LD + d], acc);
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    if (part == 0) {
      const int64_t at = (static_cast<int64_t>(b) * a.H + h) * n_tok + row;
      sDelta[r] = acc;
      sLse[r] = row < n_tok ? a.lse[at] : 0.f;
      if (row < n_tok) a.delta[at] = acc;
    }
  }
  __syncthreads();
  float lse_r[4], delta_r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    lse_r[i] = sLse[ty + 16 * i];
    delta_r[i] = sDelta[ty + 16 * i];
  }

  float acc[4][L::CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < L::CPT; ++c) acc[i][c] = 0.f;

  const T* kbase = a.k + b * a.sk.b + hk * a.sk.h;
  const T* vbase = a.v + b * a.sv.b + hk * a.sv.h;
  const int nk = a.causal ? qt + 1 : (n_tok + kBK - 1) / kBK;
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the last tile's dS and K reads are done
    load_tile<T, HD>(sK, kbase, a.sk.t, k0, n_tok);
    load_tile<T, HD>(sV, vbase, a.sv.t, k0, n_tok);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 kf[4], vf[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kf[j] = *reinterpret_cast<const float4*>(sK + (tx + 16 * j) * L::LD + d);
        vf[j] = *reinterpret_cast<const float4*>(sV + (tx + 16 * j) * L::LD + d);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 qf = *reinterpret_cast<const float4*>(sQ + (ty + 16 * i) * L::LD + d);
        const float4 df = *reinterpret_cast<const float4*>(sdO + (ty + 16 * i) * L::LD + d);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = dot4(qf, kf[j], s[i][j]);
          dp[i][j] = dot4(df, vf[j], dp[i][j]);
        }
      }
    }

    // dS = P (dP - delta) scale, P = exp(S scale - LSE), masked to 0
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        float ds = 0.f;
        if (row < n_tok && col < n_tok && !(a.causal && col > row)) {
          const float p = __expf(s[i][j] * a.scale - lse_r[i]);
          ds = p * (dp[i][j] - delta_r[i]) * a.scale;
        }
        sdS[(ty + 16 * i) * L::LDP + tx + 16 * j] = ds;
      }
    }
    __syncthreads();

    // dQ += dS K
#pragma unroll 2
    for (int j = 0; j < kBK; j += 4) {
      float4 pf[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pf[i] = *reinterpret_cast<const float4*>(sdS + (ty + 16 * i) * L::LDP + j);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        float kv[L::CPT];
        read_cols<HD>(sK + (j + jj) * L::LD, tx, kv);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = lane(pf[i], jj);
#pragma unroll
          for (int c = 0; c < L::CPT; ++c) acc[i][c] = fmaf(p, kv[c], acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= n_tok) continue;
    T* out = a.dq + ((static_cast<int64_t>(b) * n_tok + row) * a.H + h) * HD + L::VEC * tx;
#pragma unroll
    for (int ch = 0; ch < L::NCH; ++ch)
#pragma unroll
      for (int e = 0; e < L::VEC; ++e) store(out + 16 * L::VEC * ch + e, acc[i][ch * L::VEC + e]);
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 1) flash_bwd_dkv_kernel(const BwdParams<T> a) {
  using L = Layout<HD>;
  extern __shared__ __align__(16) float smem[];
  float* sK = smem;
  float* sV = sK + kBK * L::LD;
  float* sQ = sV + kBK * L::LD;
  float* sdO = sQ + kBQ * L::LD;
  float* sP = sdO + kBQ * L::LD;   // P^T: keys on rows
  float* sdS = sP + kBK * L::LDP;  // dS^T
  float* sLse = sdS + kBK * L::LDP;
  float* sDelta = sLse + kBQ;

  const int kt = blockIdx.x;  // early (heavy) key tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int k0 = kt * kBK, n_tok = a.n_tok;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int hk = h / a.group;
  load_tile<T, HD>(sK, a.k + b * a.sk.b + hk * a.sk.h, a.sk.t, k0, n_tok);
  load_tile<T, HD>(sV, a.v + b * a.sv.b + hk * a.sv.h, a.sv.t, k0, n_tok);

  float dk[4][L::CPT], dv[4][L::CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < L::CPT; ++c) dk[i][c] = dv[i][c] = 0.f;

  const T* qbase = a.q + b * a.sq.b + h * a.sq.h;
  const T* dobase = a.dout + b * a.sdo.b + h * a.sdo.h;
  const int64_t row_at = (static_cast<int64_t>(b) * a.H + h) * n_tok;
  const int nq = (n_tok + kBQ - 1) / kBQ;
  for (int qt = a.causal ? kt : 0; qt < nq; ++qt) {  // kBQ == kBK: tile kt holds the diagonal
    const int q0 = qt * kBQ;
    __syncthreads();  // the last tile's P, dS, Q and dO reads are done
    load_tile<T, HD>(sQ, qbase, a.sq.t, q0, n_tok);
    load_tile<T, HD>(sdO, dobase, a.sdo.t, q0, n_tok);
    if (threadIdx.x < kBQ) {
      const int row = q0 + threadIdx.x;
      sLse[threadIdx.x] = row < n_tok ? a.lse[row_at + row] : 0.f;
      sDelta[threadIdx.x] = row < n_tok ? a.delta[row_at + row] : 0.f;
    }
    __syncthreads();

    // S^T = K Q^T and dP^T = V dO^T: keys ty + 16 i, queries tx + 16 j
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 qf[4], df[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        qf[j] = *reinterpret_cast<const float4*>(sQ + (tx + 16 * j) * L::LD + d);
        df[j] = *reinterpret_cast<const float4*>(sdO + (tx + 16 * j) * L::LD + d);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 kf = *reinterpret_cast<const float4*>(sK + (ty + 16 * i) * L::LD + d);
        const float4 vf = *reinterpret_cast<const float4*>(sV + (ty + 16 * i) * L::LD + d);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = dot4(kf, qf[j], s[i][j]);
          dp[i][j] = dot4(vf, df[j], dp[i][j]);
        }
      }
    }

#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int qr = tx + 16 * j, row = q0 + qr;
      const float lse = sLse[qr], delta = sDelta[qr];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = k0 + ty + 16 * i;
        float p = 0.f, ds = 0.f;
        if (row < n_tok && key < n_tok && !(a.causal && key > row)) {
          p = __expf(s[i][j] * a.scale - lse);
          ds = p * (dp[i][j] - delta) * a.scale;
        }
        sP[(ty + 16 * i) * L::LDP + qr] = p;
        sdS[(ty + 16 * i) * L::LDP + qr] = ds;
      }
    }
    __syncthreads();

    // dV += P^T dO, dK += dS^T Q
#pragma unroll 2
    for (int j = 0; j < kBQ; j += 4) {
      float4 pf[4], sf[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pf[i] = *reinterpret_cast<const float4*>(sP + (ty + 16 * i) * L::LDP + j);
        sf[i] = *reinterpret_cast<const float4*>(sdS + (ty + 16 * i) * L::LDP + j);
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        float dov[L::CPT], qv[L::CPT];
        read_cols<HD>(sdO + (j + jj) * L::LD, tx, dov);
        read_cols<HD>(sQ + (j + jj) * L::LD, tx, qv);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = lane(pf[i], jj), ds = lane(sf[i], jj);
#pragma unroll
          for (int c = 0; c < L::CPT; ++c) {
            dv[i][c] = fmaf(p, dov[c], dv[i][c]);
            dk[i][c] = fmaf(ds, qv[c], dk[i][c]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty + 16 * i;
    if (key >= n_tok) continue;
    const int64_t at = ((static_cast<int64_t>(b) * n_tok + key) * a.H + h) * HD + L::VEC * tx;
#pragma unroll
    for (int ch = 0; ch < L::NCH; ++ch)
#pragma unroll
      for (int e = 0; e < L::VEC; ++e) {
        a.dk_part[at + 16 * L::VEC * ch + e] = dk[i][ch * L::VEC + e];
        a.dv_part[at + 16 * L::VEC * ch + e] = dv[i][ch * L::VEC + e];
      }
  }
}

__device__ __forceinline__ void store4(float* dst, float4 x) { *reinterpret_cast<float4*>(dst) = x; }
__device__ __forceinline__ void store4(__nv_bfloat16* dst, float4 x) {
  __nv_bfloat162 h[2] = {__floats2bfloat162_rn(x.x, x.y), __floats2bfloat162_rn(x.z, x.w)};
  *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(h);
}

// dK and dV (B, T, Hk, hd) in the input type: each 4-column chunk the sum
// of the G partials of its group, in order g = 0 .. G - 1. A partial row
// of query head hk * G + g sits at ((b T + t) Hk + hk) G + g.
template <typename T>
__global__ void flash_bwd_group_sum_kernel(const BwdParams<T> a, int64_t n_chunks, int hd4) {
  const float4* dkp = reinterpret_cast<const float4*>(a.dk_part);
  const float4* dvp = reinterpret_cast<const float4*>(a.dv_part);
  for (int64_t c = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x; c < n_chunks;
       c += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t row = c / hd4, d4 = c % hd4;
    float4 sk = make_float4(0.f, 0.f, 0.f, 0.f), sv = sk;
    for (int g = 0; g < a.group; ++g) {
      const int64_t at = (row * a.group + g) * hd4 + d4;
      const float4 x = dkp[at], y = dvp[at];
      sk.x += x.x; sk.y += x.y; sk.z += x.z; sk.w += x.w;
      sv.x += y.x; sv.y += y.y; sv.z += y.z; sv.w += y.w;
    }
    store4(a.dk + 4 * c, sk);
    store4(a.dv + 4 * c, sv);
  }
}

// The GQA sum: dK, dV (B, T, Hk, hd) in the input type from the fp32
// partials of each query head (launch 3 of the backward, both paths).
template <typename T>
cudaError_t launch_group_sum(const BwdParams<T>& a, int B, int hd, cudaStream_t stream) {
  const int64_t n_chunks = static_cast<int64_t>(B) * a.n_tok * (a.H / a.group) * (hd / 4);
  const int64_t want = (n_chunks + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < 132 * 16 ? want : 132 * 16);  // a grid-stride loop past that
  flash_bwd_group_sum_kernel<T><<<blocks, kThreads, 0, stream>>>(a, n_chunks, hd / 4);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch_bwd(const BwdParams<T>& a, int B, cudaStream_t stream) {
  auto dq_kern = flash_bwd_dq_kernel<T, HD>;
  auto dkv_kern = flash_bwd_dkv_kernel<T, HD>;
  constexpr size_t dq_smem = BwdLayout<HD>::kDqSmem, dkv_smem = BwdLayout<HD>::kDkvSmem;
  cudaError_t err = cudaFuncSetAttribute(dq_kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(dq_smem));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(dkv_kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(dkv_smem));
  if (err != cudaSuccess) return err;
  const int n_tiles = (a.n_tok + kBQ - 1) / kBQ;
  const dim3 grid(n_tiles, a.H, B);
  dq_kern<<<grid, kThreads, dq_smem, stream>>>(a);  // writes delta for the next launch
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  dkv_kern<<<grid, kThreads, dkv_smem, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return launch_group_sum(a, B, HD, stream);
}

template <typename T>
cudaError_t launch_bwd_hd(int hd, const BwdParams<T>& a, int B, cudaStream_t s) {
  switch (hd) {
    case 16: return launch_bwd<T, 16>(a, B, s);
    case 32: return launch_bwd<T, 32>(a, B, s);
    case 64: return launch_bwd<T, 64>(a, B, s);
    case 128: return launch_bwd<T, 128>(a, B, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
BwdParams<T> bwd_params(const void* q, const void* k, const void* v, const void* o, const void* dout,
                        const void* lse, void* dq, void* dk, void* dv, void* delta, void* dk_part,
                        void* dv_part, const int64_t* st, int n_tok, int H, int group, float scale,
                        bool causal) {
  BwdParams<T> a;
  a.q = static_cast<const T*>(q);
  a.k = static_cast<const T*>(k);
  a.v = static_cast<const T*>(v);
  a.o = static_cast<const T*>(o);
  a.dout = static_cast<const T*>(dout);
  a.lse = static_cast<const float*>(lse);
  a.dq = static_cast<T*>(dq);
  a.dk = static_cast<T*>(dk);
  a.dv = static_cast<T*>(dv);
  a.delta = static_cast<float*>(delta);
  a.dk_part = static_cast<float*>(dk_part);
  a.dv_part = static_cast<float*>(dv_part);
  a.sq = {st[0], st[1], st[2]};
  a.sk = {st[3], st[4], st[5]};
  a.sv = {st[6], st[7], st[8]};
  a.so = {st[9], st[10], st[11]};
  a.sdo = {st[12], st[13], st[14]};
  a.n_tok = n_tok;
  a.H = H;
  a.group = group;
  a.scale = scale;
  a.causal = causal;
  return a;
}

}  // namespace

// ------------------------------------------- bf16: wgmma fed by TMA (sm_90a)

namespace tc {

using hopper::desc_sw128;
using hopper::fence_regs;
using hopper::mbar_arrive;
using hopper::mbar_arrive_expect_tx;
using hopper::mbar_wait;
using hopper::pack_bf16;
using hopper::smem_addr;
using bf16 = __nv_bfloat16;

constexpr int kWG = 128;            // threads of a warpgroup
constexpr int kThreads = 3 * kWG;   // consumer warpgroups 0 and 1, producer warpgroup 2
constexpr int kBox = 64;            // a TMA box: 64 rows of 64 values (128 bytes, one swizzle row)
constexpr int kStages = 2;          // ring of streamed tiles
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
// P and dS enter the register-A products as hi + lo bf16 terms (two wgmma
// each). Rounded once to bf16 instead, dQ, dK and dV read up to 1.3-1.6x
// chip_smoke.py's FLASH_TOL (a row of dS sums to zero, and the rounding
// breaks that cancellation; dV's sums are short on early keys) and O up to
// 0.95x; split, all read under 0.6x. On an H100 the split costs the
// forward about 17% and the backward about 34% of its time. Building with
// -DREPRO_FLASH_TC_SPLIT=0 drops the lo products; scripts/flash_split_cost.py
// measures both builds.
#ifndef REPRO_FLASH_TC_SPLIT
#define REPRO_FLASH_TC_SPLIT 1
#endif
constexpr bool kSplit = REPRO_FLASH_TC_SPLIT != 0;

// Where the map of a (B, T, H, hd) view puts t, h and b among its
// coordinates 1..3 (coordinate 0 is the column): the host orders the outer
// dimensions by stride.
struct MapPos {
  int t, h, b;
};

// One TMA plan from the host (``kernels/flash_attention/flash_attention.py::
// tma_plan``): dims (innermost first), byte strides of dims 1..3, box, and
// the positions of t, h and b.
struct Plan {
  int64_t dims[4], strides[3], box[4], pos_t, pos_h, pos_b;
};
static_assert(sizeof(Plan) == 14 * sizeof(int64_t), "a plan is 14 int64 values");

__device__ __forceinline__ int coord(const MapPos& m, int i, int t, int h, int b) {
  return m.t == i ? t : m.h == i ? h : b;
}

// A tile of ROWS rows x HD columns at row t0 of head h, batch row b: HD / 64
// column blocks of ROWS x 128 bytes, each ROWS / 64 boxes, 128-byte swizzled.
template <int ROWS, int HD>
__device__ __forceinline__ void load_tile(bf16* dst, const CUtensorMap* map, const MapPos& m, uint64_t* bar,
                                          int t0, int h, int b) {
#pragma unroll
  for (int cb = 0; cb < HD / kBox; ++cb)
#pragma unroll
    for (int rb = 0; rb < ROWS / kBox; ++rb) {
      const int t = t0 + rb * kBox;
      hopper::tma_load_4d(dst + (cb * ROWS + rb * kBox) * kBox, map, bar, cb * kBox, coord(m, 1, t, h, b),
                          coord(m, 2, t, h, b), coord(m, 3, t, h, b));
    }
}

// Descriptor of a K-major operand at k-step kk (16 columns) of a tile of
// ROWS rows, starting `row0` rows in.
template <int ROWS>
__device__ __forceinline__ uint64_t kmajor(uint32_t tile, int row0, int kk) {
  return desc_sw128(tile + (kk / 4) * ROWS * 128 + row0 * 128 + (kk % 4) * 32, 16, 1024);
}

// Descriptor of an MN-major operand (rows along K) at k-step kk of a tile
// of ROWS rows.
template <int ROWS>
__device__ __forceinline__ uint64_t mnmajor(uint32_t tile, int kk) {
  return desc_sw128(tile + kk * 16 * 128, ROWS * 128, 1024);
}

template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a, uint64_t b, int scale_d) {
  if constexpr (N == 64) hopper::wgmma_ss_n64(d, a, b, scale_d);
  else hopper::wgmma_ss_n128(d, a, b, scale_d);
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b) {
  if constexpr (N == 64) hopper::wgmma_rs_n64(d, a, b, 1);
  else hopper::wgmma_rs_n128(d, a, b, 1);
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The 16-column slice kk of an accumulator fragment (64 x N fp32) as the
// register A operand (64 x 16 bf16) of the next product: the wgmma
// accumulator and A layouts agree element for element. Each value x is
// split into hi = bf16(x) and lo = bf16(x - hi); the product is issued for
// both (kSplit), so P and dS enter the sums with about 16 bits, not 8.
template <int N>
__device__ __forceinline__ void to_a(const float (&d)[N / 2], uint32_t (&hi)[N / 16][4],
                                     uint32_t (&lo)[N / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float x0 = d[8 * kk + 2 * r], x1 = d[8 * kk + 2 * r + 1];
      const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
      const float2 hf = __bfloat1622float2(h);
      hi[kk][r] = *reinterpret_cast<const uint32_t*>(&h);
      lo[kk][r] = kSplit ? pack_bf16(x0 - hf.x, x1 - hf.y) : 0u;
    }
}

// D += A B for the K = N_A columns of a split register operand, K in
// steps of 16: the hi product, then (kSplit) the lo product, of each step.
template <int N, int K, int ROWS>
__device__ __forceinline__ void product_rs(float (&d)[N / 2], const uint32_t (&hi)[K / 16][4],
                                           const uint32_t (&lo)[K / 16][4], uint32_t b_tile) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    wgmma_rs<N>(d, hi[kk], mnmajor<ROWS>(b_tile, kk));
    if constexpr (kSplit) wgmma_rs<N>(d, lo[kk], mnmajor<ROWS>(b_tile, kk));
  }
}

// Element i of a thread's m64nN accumulator fragment sits at row
// 16 * warp + lane / 4 + 8 * row_half(i), column col(i, lane).
__device__ __forceinline__ int row_half(int i) { return (i >> 1) & 1; }
__device__ __forceinline__ int frag_col(int i, int lane) { return 8 * (i >> 2) + 2 * (lane & 3) + (i & 1); }

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

// ---------------------------------------------------------------- forward

struct FwdParams {
  bf16* o;     // (B, T, H, HD) contiguous
  float* lse;  // (B, H, T)
  int n_tok, H, group;
  float scale_log2;  // scale * log2(e)
  bool causal;
  MapPos mq, mk, mv;
};

// 64-key tiles at hd 128 keep a consumer's S, P and O within its 240
// registers (128-key tiles spill).
template <int HD>
struct FwdLayout {
  static constexpr int BQ = 128, BK = HD == 128 ? 64 : 128;
  static constexpr int Q_BYTES = BQ * HD * 2, KV_BYTES = BK * HD * 2;
  static constexpr size_t kSmem = 1024 + Q_BYTES + 2 * kStages * KV_BYTES + 8 * (1 + 3 * kStages);
};

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_tc_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, const FwdParams p) {
  using L = FwdLayout<HD>;
  constexpr int BQ = L::BQ, BK = L::BK;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = align1024(smem_raw);
  bf16* sQ = reinterpret_cast<bf16*>(base);
  bf16* sK = reinterpret_cast<bf16*>(base + L::Q_BYTES);
  bf16* sV = reinterpret_cast<bf16*>(base + L::Q_BYTES + kStages * L::KV_BYTES);
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(base + L::Q_BYTES + 2 * kStages * L::KV_BYTES);
  uint64_t* full_k = bar_q + 1;
  uint64_t* full_v = full_k + kStages;
  uint64_t* empty = full_v + kStages;

  const int qt = gridDim.x - 1 - blockIdx.x;  // late (heavy) query tiles first
  const int h = blockIdx.y, b = blockIdx.z, q0 = qt * BQ, n_tok = p.n_tok;
  const int n_kt = (n_tok + BK - 1) / BK;
  const int nk = p.causal ? min(n_kt, (q0 + BQ + BK - 1) / BK) : n_kt;  // up to the diagonal
  if (threadIdx.x == 0) {
    hopper::mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&full_k[s], 1);
      hopper::mbar_init(&full_v[s], 1);
      hopper::mbar_init(&empty[s], 2 * kWG);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();
  const int wg = threadIdx.x / kWG;

  if (wg == 2) {  // producer warp: one thread keeps the ring of K and V tiles full
    hopper::setmaxnreg_dec<24>();
    if (threadIdx.x == 2 * kWG) {
      const int hk = h / p.group;
      mbar_arrive_expect_tx(bar_q, L::Q_BYTES);
      load_tile<BQ, HD>(sQ, &tq, p.mq, bar_q, q0, h, b);
      for (int i = 0; i < nk; ++i) {
        const int s = i % kStages, ph = (i / kStages) & 1;
        mbar_wait(&empty[s], ph ^ 1);
        mbar_arrive_expect_tx(&full_k[s], L::KV_BYTES);
        load_tile<BK, HD>(sK + s * BK * HD, &tk, p.mk, &full_k[s], i * BK, hk, b);
        mbar_arrive_expect_tx(&full_v[s], L::KV_BYTES);
        load_tile<BK, HD>(sV + s * BK * HD, &tv, p.mv, &full_v[s], i * BK, hk, b);
      }
      for (int i = nk > kStages ? nk - kStages : 0; i < nk; ++i)  // the last tiles are consumed
        mbar_wait(&empty[i % kStages], (i / kStages) & 1);
    }
  } else {  // consumers: 64 query rows per warpgroup
    hopper::setmaxnreg_inc<240>();
    const int tid = threadIdx.x % kWG, warp = tid / 32, lane = tid % 32;
    const int row0 = q0 + 64 * wg + 16 * warp + lane / 4;  // this thread's rows: row0, row0 + 8
    float o[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    const uint32_t q_tile = smem_addr(sQ);
    mbar_wait(bar_q, 0);
    for (int i = 0; i < nk; ++i) {
      const int s = i % kStages, ph = (i / kStages) & 1, k0 = i * BK;
      const uint32_t k_tile = smem_addr(sK + s * BK * HD), v_tile = smem_addr(sV + s * BK * HD);
      mbar_wait(&full_k[s], ph);
      if (p.causal && k0 > q0 + 64 * wg + 63) {  // every key of the tile follows these rows
        mbar_arrive(&empty[s]);
        continue;
      }
      float sc[BK / 2];
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        wgmma_ss<BK>(sc, kmajor<BQ>(q_tile, 64 * wg, kk), kmajor<BK>(k_tile, 0, kk), kk > 0);
      hopper::wgmma_commit();
      hopper::wgmma_wait0();
      fence_regs(sc);

      // mask (diagonal and tail tiles only), online softmax in log2 units
      if ((p.causal && k0 + BK - 1 > q0 + 64 * wg) || k0 + BK > n_tok) {
#pragma unroll
        for (int e = 0; e < BK / 2; ++e) {
          const int col = k0 + frag_col(e, lane), row = row0 + 8 * row_half(e);
          if (col >= n_tok || (p.causal && col > row)) sc[e] = -INFINITY;
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = -INFINITY;
#pragma unroll
        for (int e = 0; e < BK / 2; ++e)
          if (row_half(e) == r) mx = fmaxf(mx, sc[e]);
        const float m_new = fmaxf(m[r], quad_max(mx) * p.scale_log2);
        const float m_use = m_new == -INFINITY ? 0.f : m_new;
        const float alpha = fast_exp2(m[r] - m_use);
        m[r] = m_new;
        float rs = 0.f;
#pragma unroll
        for (int e = 0; e < BK / 2; ++e)
          if (row_half(e) == r) {
            sc[e] = fast_exp2(fmaf(sc[e], p.scale_log2, -m_use));
            rs += sc[e];
          }
        l[r] = l[r] * alpha + rs;  // this thread's columns; summed over the quad at the end
#pragma unroll
        for (int e = 0; e < HD / 2; ++e)
          if (row_half(e) == r) o[e] *= alpha;
      }
      uint32_t pa[BK / 16][4], pl[BK / 16][4];
      to_a<BK>(sc, pa, pl);

      mbar_wait(&full_v[s], ph);
      hopper::wgmma_fence();
      product_rs<HD, BK, BK>(o, pa, pl, v_tile);
      hopper::wgmma_commit();
      hopper::wgmma_wait0();
      fence_regs(o);
      mbar_arrive(&empty[s]);
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      const float lsum = fmaxf(quad_sum(l[r]), 1e-30f), inv = 1.f / lsum;
      if (row >= n_tok) continue;
      bf16* orow = p.o + ((static_cast<int64_t>(b) * n_tok + row) * p.H + h) * HD;
#pragma unroll
      for (int e = 0; e < HD / 2; e += 2)
        if (row_half(e) == r)
          *reinterpret_cast<uint32_t*>(orow + frag_col(e, lane)) = pack_bf16(o[e] * inv, o[e + 1] * inv);
      if ((lane & 3) == 0) p.lse[(static_cast<int64_t>(b) * p.H + h) * n_tok + row] = (m[r] + log2f(lsum)) * kLn2;
    }
  }
}

// --------------------------------------------------------------- backward

struct BwdParams {
  const bf16 *o, *dout;      // read by the dQ kernel's prologue (delta)
  const float* lse;          // (B, H, T)
  float* delta;              // (B, H, T): rowsum(dO * O), written by the dQ kernel
  bf16* dq;                  // (B, T, H, HD) contiguous
  float *dk_part, *dv_part;  // (B, T, H, HD) fp32, per query head
  int64_t sob, sot, soh, sdb, sdt, sdh;  // strides of O and dO in elements
  int n_tok, H, group;
  float scale, scale_log2;
  bool causal;
  MapPos mq, mk, mv, mdo;
};

// dQ: a CTA per 128 query rows (64 per consumer warpgroup), streaming
// 64-key tiles of K and V.
template <int HD>
struct DqLayout {
  static constexpr int BQ = 128, BK = 64;
  static constexpr int Q_BYTES = BQ * HD * 2, KV_BYTES = BK * HD * 2;
  static constexpr size_t kSmem =
      1024 + 2 * Q_BYTES + 2 * kStages * KV_BYTES + 2 * BQ * sizeof(float) + 8 * (1 + 2 * kStages);
};

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_tc_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                       const BwdParams p) {
  using L = DqLayout<HD>;
  constexpr int BQ = L::BQ, BK = L::BK;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = align1024(smem_raw);
  bf16* sQ = reinterpret_cast<bf16*>(base);
  bf16* sdO = reinterpret_cast<bf16*>(base + L::Q_BYTES);
  bf16* sK = reinterpret_cast<bf16*>(base + 2 * L::Q_BYTES);
  bf16* sV = reinterpret_cast<bf16*>(base + 2 * L::Q_BYTES + kStages * L::KV_BYTES);
  float* sLse = reinterpret_cast<float*>(base + 2 * L::Q_BYTES + 2 * kStages * L::KV_BYTES);
  float* sDelta = sLse + BQ;
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(sDelta + BQ);
  uint64_t* full = bar_q + 1;
  uint64_t* empty = full + kStages;

  const int qt = gridDim.x - 1 - blockIdx.x;  // late (heavy) query tiles first
  const int h = blockIdx.y, b = blockIdx.z, q0 = qt * BQ, n_tok = p.n_tok;
  const int n_kt = (n_tok + BK - 1) / BK;
  const int nk = p.causal ? min(n_kt, (q0 + BQ) / BK) : n_kt;
  if (threadIdx.x == 0) {
    hopper::mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 2 * kWG);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();
  const int wg = threadIdx.x / kWG;

  if (wg == 2) {
    hopper::setmaxnreg_dec<24>();
    if (threadIdx.x == 2 * kWG) {
      const int hk = h / p.group;
      mbar_arrive_expect_tx(bar_q, 2 * L::Q_BYTES);
      load_tile<BQ, HD>(sQ, &tq, p.mq, bar_q, q0, h, b);
      load_tile<BQ, HD>(sdO, &tdo, p.mdo, bar_q, q0, h, b);
      for (int i = 0; i < nk; ++i) {
        const int s = i % kStages, ph = (i / kStages) & 1;
        mbar_wait(&empty[s], ph ^ 1);
        mbar_arrive_expect_tx(&full[s], 2 * L::KV_BYTES);
        load_tile<BK, HD>(sK + s * BK * HD, &tk, p.mk, &full[s], i * BK, hk, b);
        load_tile<BK, HD>(sV + s * BK * HD, &tv, p.mv, &full[s], i * BK, hk, b);
      }
      for (int i = nk > kStages ? nk - kStages : 0; i < nk; ++i)
        mbar_wait(&empty[i % kStages], (i / kStages) & 1);
    }
  } else {
    hopper::setmaxnreg_inc<240>();
    const int tid = threadIdx.x % kWG, warp = tid / 32, lane = tid % 32;
    // delta = rowsum(dO * O) and the LSE (in log2 units) of the
    // warpgroup's 64 rows: two threads a row, 16-byte loads
    {
      const int r = 64 * wg + tid / 2, half = tid & 1, row = q0 + r;
      float acc = 0.f;
      if (row < n_tok) {
        const bf16* orow = p.o + b * p.sob + row * p.sot + h * p.soh + half * (HD / 2);
        const bf16* drow = p.dout + b * p.sdb + row * p.sdt + h * p.sdh + half * (HD / 2);
#pragma unroll
        for (int c = 0; c < HD / 2; c += 8) {
          const uint4 ov = __ldg(reinterpret_cast<const uint4*>(orow + c));
          const uint4 dv = __ldg(reinterpret_cast<const uint4*>(drow + c));
          const __nv_bfloat162* oh = reinterpret_cast<const __nv_bfloat162*>(&ov);
          const __nv_bfloat162* dh = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float2 of = __bfloat1622float2(oh[j]), df = __bfloat1622float2(dh[j]);
            acc = fmaf(of.x, df.x, acc);
            acc = fmaf(of.y, df.y, acc);
          }
        }
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      if (half == 0) {
        const int64_t at = (static_cast<int64_t>(b) * p.H + h) * n_tok + row;
        sDelta[r] = acc;
        sLse[r] = row < n_tok ? p.lse[at] * kLog2e : 0.f;
        if (row < n_tok) p.delta[at] = acc;
      }
    }
    hopper::named_sync(1 + wg, kWG);
    const int rl = 64 * wg + 16 * warp + lane / 4, row0 = q0 + rl;
    const float lse2[2] = {sLse[rl], sLse[rl + 8]}, dl[2] = {sDelta[rl], sDelta[rl + 8]};

    float dq[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) dq[i] = 0.f;
    const uint32_t q_tile = smem_addr(sQ), do_tile = smem_addr(sdO);
    mbar_wait(bar_q, 0);
    for (int i = 0; i < nk; ++i) {
      const int s = i % kStages, ph = (i / kStages) & 1, k0 = i * BK;
      mbar_wait(&full[s], ph);
      if (!p.causal || k0 <= q0 + 64 * wg + 63) {  // else every key of the tile is masked for these rows
        const uint32_t k_tile = smem_addr(sK + s * BK * HD), v_tile = smem_addr(sV + s * BK * HD);
        float sc[BK / 2], dp[BK / 2];
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk)
          wgmma_ss<BK>(sc, kmajor<BQ>(q_tile, 64 * wg, kk), kmajor<BK>(k_tile, 0, kk), kk > 0);
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk)
          wgmma_ss<BK>(dp, kmajor<BQ>(do_tile, 64 * wg, kk), kmajor<BK>(v_tile, 0, kk), kk > 0);
        hopper::wgmma_commit();
        hopper::wgmma_wait0();
        fence_regs(sc);
        fence_regs(dp);
        const bool edge = (p.causal && k0 + BK - 1 > q0 + 64 * wg) || k0 + BK > n_tok;
#pragma unroll
        for (int e = 0; e < BK / 2; ++e) {
          const int r = row_half(e), col = k0 + frag_col(e, lane);
          float pr = fast_exp2(fmaf(sc[e], p.scale_log2, -lse2[r]));
          if (edge && (col >= n_tok || (p.causal && col > row0 + 8 * r))) pr = 0.f;
          sc[e] = pr * (dp[e] - dl[r]) * p.scale;  // dS
        }
        uint32_t ds_hi[BK / 16][4], ds_lo[BK / 16][4];
        to_a<BK>(sc, ds_hi, ds_lo);
        hopper::wgmma_fence();
        product_rs<HD, BK, BK>(dq, ds_hi, ds_lo, k_tile);
        hopper::wgmma_commit();
        hopper::wgmma_wait0();
        fence_regs(dq);
      }
      mbar_arrive(&empty[s]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row >= n_tok) continue;
      bf16* out = p.dq + ((static_cast<int64_t>(b) * n_tok + row) * p.H + h) * HD;
#pragma unroll
      for (int e = 0; e < HD / 2; e += 2)
        if (row_half(e) == r) *reinterpret_cast<uint32_t*>(out + frag_col(e, lane)) = pack_bf16(dq[e], dq[e + 1]);
    }
  }
}

// dK, dV: a CTA per (64 keys, query head, batch row), K and V resident,
// 64-row tiles of Q and dO streamed with the LSE and delta of their rows.
// The two consumer warpgroups split the work on the same 64 keys, three
// products each: warpgroup 0 forms S^T = K Q^T, P^T and dV += P^T dO, and
// hands P^T (fp32) to warpgroup 1 through shared memory; warpgroup 1 forms
// dP^T = V dO^T, dS^T = P^T (dP^T - delta) scale and dK += dS^T Q. A thread
// holds one 64 x hd accumulator, not two, so neither spills. Writes fp32
// partials of its query head.
template <int HD>
struct DkvLayout {
  static constexpr int BK = 64, BQ = 64;
  static constexpr int KV_BYTES = BK * HD * 2, Q_BYTES = BQ * HD * 2, P_FLOATS = BK * BQ;
  static constexpr size_t kSmem = 1024 + 2 * KV_BYTES + 2 * kStages * Q_BYTES + 2 * P_FLOATS * sizeof(float) +
                                  2 * kStages * BQ * sizeof(float) + 8 * (1 + 2 * kStages);
};

// Named barriers of the P^T hand-over, one pair per buffer: "full" (0 has
// written it, 1 waits) and "free" (1 has read it, 0 waits). 0 is
// __syncthreads.
constexpr int kBarPFull = 1, kBarPFree = 3;

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_tc_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                        const BwdParams p) {
  using L = DkvLayout<HD>;
  constexpr int BK = L::BK, BQ = L::BQ;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = align1024(smem_raw);
  bf16* sK = reinterpret_cast<bf16*>(base);
  bf16* sV = reinterpret_cast<bf16*>(base + L::KV_BYTES);
  bf16* sQ = reinterpret_cast<bf16*>(base + 2 * L::KV_BYTES);
  bf16* sdO = reinterpret_cast<bf16*>(base + 2 * L::KV_BYTES + kStages * L::Q_BYTES);
  float* sP = reinterpret_cast<float*>(base + 2 * L::KV_BYTES + 2 * kStages * L::Q_BYTES);  // 2 buffers
  float* sLse = sP + 2 * L::P_FLOATS;
  float* sDelta = sLse + kStages * BQ;
  uint64_t* bar_kv = reinterpret_cast<uint64_t*>(sDelta + kStages * BQ);
  uint64_t* full = bar_kv + 1;
  uint64_t* empty = full + kStages;

  const int kt = blockIdx.x;  // early (heavy) key tiles first
  const int h = blockIdx.y, b = blockIdx.z, k0 = kt * BK, n_tok = p.n_tok;
  const int nq = (n_tok + BQ - 1) / BQ, first = p.causal ? kt : 0;  // BQ == BK: tile kt holds the diagonal
  if (threadIdx.x == 0) {
    hopper::mbar_init(bar_kv, 1);
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&full[s], 32);  // the producer warp's lanes, after their LSE and delta
      hopper::mbar_init(&empty[s], 2 * kWG);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();
  const int wg = threadIdx.x / kWG;

  if (wg == 2) {
    hopper::setmaxnreg_dec<40>();  // the LSE and delta loads
    if (threadIdx.x < 2 * kWG + 32) {  // one warp
      const int lane = threadIdx.x % 32;
      const int64_t row_at = (static_cast<int64_t>(b) * p.H + h) * n_tok;
      if (lane == 0) {
        mbar_arrive_expect_tx(bar_kv, 2 * L::KV_BYTES);
        load_tile<BK, HD>(sK, &tk, p.mk, bar_kv, k0, h / p.group, b);
        load_tile<BK, HD>(sV, &tv, p.mv, bar_kv, k0, h / p.group, b);
      }
      for (int qi = first, i = 0; qi < nq; ++qi, ++i) {
        const int s = i % kStages, ph = (i / kStages) & 1, q0 = qi * BQ;
        mbar_wait(&empty[s], ph ^ 1);
        if (lane == 0) {
          hopper::mbar_expect_tx(&full[s], 2 * L::Q_BYTES);
          load_tile<BQ, HD>(sQ + s * BQ * HD, &tq, p.mq, &full[s], q0, h, b);
          load_tile<BQ, HD>(sdO + s * BQ * HD, &tdo, p.mdo, &full[s], q0, h, b);
        }
#pragma unroll
        for (int r = lane; r < BQ; r += 32) {
          const int row = q0 + r;
          sLse[s * BQ + r] = row < n_tok ? p.lse[row_at + row] * kLog2e : 0.f;
          sDelta[s * BQ + r] = row < n_tok ? p.delta[row_at + row] : 0.f;
        }
        mbar_arrive(&full[s]);
      }
      const int n = nq - first;
      for (int i = n > kStages ? n - kStages : 0; i < n; ++i) mbar_wait(&empty[i % kStages], (i / kStages) & 1);
    }
  } else {
    hopper::setmaxnreg_inc<232>();
    const int tid = threadIdx.x % kWG, warp = tid / 32, lane = tid % 32;
    const int key0 = k0 + 16 * warp + lane / 4;  // this thread's keys: key0, key0 + 8
    const int n = nq - first;
    float acc[HD / 2];  // dV in warpgroup 0, dK in warpgroup 1
#pragma unroll
    for (int e = 0; e < HD / 2; ++e) acc[e] = 0.f;
    const uint32_t k_tile = smem_addr(sK), v_tile = smem_addr(sV);
    mbar_wait(bar_kv, 0);
    for (int qi = first, i = 0; qi < nq; ++qi, ++i) {
      const int s = i % kStages, ph = (i / kStages) & 1, q0 = qi * BQ, pb = i & 1;
      const uint32_t q_tile = smem_addr(sQ + s * BQ * HD), do_tile = smem_addr(sdO + s * BQ * HD);
      float* sPb = sP + pb * L::P_FLOATS;  // element e of thread tid at e * 128 + tid
      float x[BQ / 2];
      uint32_t xh[BQ / 16][4], xl[BQ / 16][4];
      mbar_wait(&full[s], ph);
      hopper::wgmma_fence();
      if (wg == 0) {  // S^T = K Q^T, then P^T
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk)
          wgmma_ss<BQ>(x, kmajor<BK>(k_tile, 0, kk), kmajor<BQ>(q_tile, 0, kk), kk > 0);
      } else {  // dP^T = V dO^T
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk)
          wgmma_ss<BQ>(x, kmajor<BK>(v_tile, 0, kk), kmajor<BQ>(do_tile, 0, kk), kk > 0);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait0();
      fence_regs(x);
      if (wg == 0) {
        const float* lse2 = sLse + s * BQ;
        const bool edge = (p.causal && qi == kt) || q0 + BQ > n_tok;
#pragma unroll
        for (int e = 0; e < BQ / 2; ++e) {
          const int c = frag_col(e, lane), qrow = q0 + c, key = key0 + 8 * row_half(e);
          float pr = fast_exp2(fmaf(x[e], p.scale_log2, -lse2[c]));
          if (edge && (qrow >= n_tok || (p.causal && key > qrow))) pr = 0.f;
          x[e] = pr;
        }
        if (i >= 2) hopper::named_sync(kBarPFree + pb, 2 * kWG);  // warpgroup 1 has read tile i - 2
#pragma unroll
        for (int e = 0; e < BQ / 2; ++e) sPb[e * kWG + tid] = x[e];
        __threadfence_block();
        hopper::named_arrive(kBarPFull + pb, 2 * kWG);
        to_a<BQ>(x, xh, xl);
        hopper::wgmma_fence();
        product_rs<HD, BQ, BQ>(acc, xh, xl, do_tile);  // dV += P^T dO
      } else {
        const float* dl = sDelta + s * BQ;
        hopper::named_sync(kBarPFull + pb, 2 * kWG);  // P^T of tile i
#pragma unroll
        for (int e = 0; e < BQ / 2; ++e) x[e] = sPb[e * kWG + tid] * (x[e] - dl[frag_col(e, lane)]) * p.scale;
        if (i + 2 < n) {
          __threadfence_block();
          hopper::named_arrive(kBarPFree + pb, 2 * kWG);
        }
        to_a<BQ>(x, xh, xl);
        hopper::wgmma_fence();
        product_rs<HD, BQ, BQ>(acc, xh, xl, q_tile);  // dK += dS^T Q
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait0();
      fence_regs(acc);
      mbar_arrive(&empty[s]);
    }
    float* part = wg == 0 ? p.dv_part : p.dk_part;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = key0 + 8 * r;
      if (key >= n_tok) continue;
      const int64_t at = ((static_cast<int64_t>(b) * n_tok + key) * p.H + h) * HD;
#pragma unroll
      for (int e = 0; e < HD / 2; e += 2)
        if (row_half(e) == r)
          *reinterpret_cast<float2*>(part + at + frag_col(e, lane)) = make_float2(acc[e], acc[e + 1]);
    }
  }
}

// ------------------------------------------------------------- host side

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the CUDA runtime's entry-point
// query, so the library needs no -lcuda.
EncodeTiledFn encode_fn() {
  static EncodeTiledFn fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &q) != cudaSuccess)
      return static_cast<EncodeTiledFn>(nullptr);
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &q) != cudaSuccess)
      return static_cast<EncodeTiledFn>(nullptr);
#endif
    return q == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiledFn>(f) : nullptr;
  }();
  return fn;
}

// The 4-D map of one (B, T, H, HD) bf16 operand from its host plan: boxes
// of 64 rows x 64 columns, 128-byte swizzle, zeros past the extent.
cudaError_t encode(CUtensorMap* map, MapPos* pos, const Plan& pl, const void* ptr, int hd) {
  const int64_t pt = pl.pos_t, ph = pl.pos_h, pb = pl.pos_b;
  const bool perm = pt >= 1 && ph >= 1 && pb >= 1 && pt <= 3 && ph <= 3 && pb <= 3 && pt != ph && pt != pb &&
                    ph != pb;
  if (!perm || pl.dims[0] != hd || pl.box[0] != kBox) return cudaErrorInvalidValue;
  for (int i = 1; i < 4; ++i) {
    if (pl.box[i] != (i == pt ? kBox : 1) || pl.dims[i] <= 0 || pl.dims[i] > INT_MAX) return cudaErrorInvalidValue;
    const int64_t st = pl.strides[i - 1];
    if (st <= 0 || st % 16 != 0 || st >= (int64_t(1) << 40)) return cudaErrorInvalidValue;
  }
  if (reinterpret_cast<uintptr_t>(ptr) % 16 != 0) return cudaErrorInvalidValue;
  const EncodeTiledFn fn = encode_fn();
  if (fn == nullptr) return cudaErrorSymbolNotFound;
  cuuint64_t dims[4], strides[3];
  cuuint32_t box[4], estr[4] = {1, 1, 1, 1};
  for (int i = 0; i < 4; ++i) {
    dims[i] = static_cast<cuuint64_t>(pl.dims[i]);
    box[i] = static_cast<cuuint32_t>(pl.box[i]);
  }
  for (int i = 0; i < 3; ++i) strides[i] = static_cast<cuuint64_t>(pl.strides[i]);
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box, estr,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return cudaErrorInvalidValue;
  *pos = {static_cast<int>(pt), static_cast<int>(ph), static_cast<int>(pb)};
  return cudaSuccess;
}

template <typename K>
cudaError_t set_smem(K kern, size_t bytes) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
}

template <int HD>
cudaError_t launch_fwd(const CUtensorMap* maps, const FwdParams& p, int B, cudaStream_t stream) {
  using L = FwdLayout<HD>;
  cudaError_t err = set_smem(flash_fwd_tc_kernel<HD>, L::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.n_tok + L::BQ - 1) / L::BQ, p.H, B);
  flash_fwd_tc_kernel<HD><<<grid, kThreads, L::kSmem, stream>>>(maps[0], maps[1], maps[2], p);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_bwd(const CUtensorMap* maps, const BwdParams& p, int B, cudaStream_t stream) {
  cudaError_t err = set_smem(flash_bwd_dq_tc_kernel<HD>, DqLayout<HD>::kSmem);
  if (err != cudaSuccess) return err;
  if ((err = set_smem(flash_bwd_dkv_tc_kernel<HD>, DkvLayout<HD>::kSmem)) != cudaSuccess) return err;
  const dim3 grid_q((p.n_tok + DqLayout<HD>::BQ - 1) / DqLayout<HD>::BQ, p.H, B);
  flash_bwd_dq_tc_kernel<HD><<<grid_q, kThreads, DqLayout<HD>::kSmem, stream>>>(maps[0], maps[1], maps[2],
                                                                                 maps[3], p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;  // delta is written for the next launch
  const dim3 grid_k((p.n_tok + DkvLayout<HD>::BK - 1) / DkvLayout<HD>::BK, p.H, B);
  flash_bwd_dkv_tc_kernel<HD><<<grid_k, kThreads, DkvLayout<HD>::kSmem, stream>>>(maps[0], maps[1], maps[2],
                                                                                   maps[3], p);
  return cudaGetLastError();
}

}  // namespace tc

namespace {

int64_t g_tc_launches[2] = {0, 0};  // tensor-core forward, backward launches

// A plan of the map of a (B, T, n_heads, hd) operand fits the call's shape.
bool plan_fits(const tc::Plan& pl, int64_t B, int64_t T, int64_t n_heads) {
  const int64_t pt = pl.pos_t, ph = pl.pos_h, pb = pl.pos_b;
  if (pt < 1 || pt > 3 || ph < 1 || ph > 3 || pb < 1 || pb > 3) return false;
  return pl.dims[pt] == T && pl.dims[ph] == n_heads && pl.dims[pb] == B;
}

}  // namespace

// q (B, T, H, hd), k and v (B, T, Hk, hd), all fp32 or all bf16 on the
// device, last dim contiguous; strides in elements (b, t, h) for each, each
// a multiple of 16 bytes, base pointers 16-byte aligned. o (B, T, H, hd)
// contiguous, in the input type; lse (B, H, T) contiguous fp32. bf16 goes
// to the tensor-core kernel (hd 64 or 128) and needs `plans`: three TMA
// plans of 14 int64 each (q, k, v; see tc::Plan); fp32 ignores them.
// Launches on `stream`, does not synchronise.
extern "C" int repro_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                               int is_bf16, int64_t B, int64_t T, int64_t H, int64_t Hk, int64_t hd,
                               int64_t sqb, int64_t sqt, int64_t sqh, int64_t skb, int64_t skt,
                               int64_t skh, int64_t svb, int64_t svt, int64_t svh, float scale,
                               int causal, const int64_t* plans, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0 || Hk <= 0 || H % Hk != 0 || B > 65535 || H > 65535 ||
      T > INT_MAX - kBQ)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int b = static_cast<int>(B), t = static_cast<int>(T), h = static_cast<int>(H);
  const int group = static_cast<int>(H / Hk), d = static_cast<int>(hd);
  if (!is_bf16) {
    const int64_t st[9] = {sqb, sqt, sqh, skb, skt, skh, svb, svt, svh};
    return static_cast<int>(launch_hd<float>(d, q, k, v, o, lse, b, t, h, group, st, scale, causal != 0, s));
  }
  if (plans == nullptr || (hd != 64 && hd != 128)) return static_cast<int>(cudaErrorInvalidValue);
  const tc::Plan* pl = reinterpret_cast<const tc::Plan*>(plans);
  if (!plan_fits(pl[0], B, T, H) || !plan_fits(pl[1], B, T, Hk) || !plan_fits(pl[2], B, T, Hk))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap maps[3];
  tc::FwdParams p;
  const void* ptrs[3] = {q, k, v};
  tc::MapPos* pos[3] = {&p.mq, &p.mk, &p.mv};
  for (int i = 0; i < 3; ++i) {
    const cudaError_t err = tc::encode(&maps[i], pos[i], pl[i], ptrs[i], d);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  p.o = static_cast<__nv_bfloat16*>(o);
  p.lse = static_cast<float*>(lse);
  p.n_tok = t;
  p.H = h;
  p.group = group;
  p.scale_log2 = scale * tc::kLog2e;
  p.causal = causal != 0;
  const cudaError_t err = d == 64 ? tc::launch_fwd<64>(maps, p, b, s) : tc::launch_fwd<128>(maps, p, b, s);
  if (err == cudaSuccess) ++g_tc_launches[0];
  return static_cast<int>(err);
}

// q, o, dout (B, T, H, hd), k and v (B, T, Hk, hd), all fp32 or all bf16 on
// the device, each read through its strides (b, t, h) in elements as the
// forward reads q, k, v; lse (B, H, T) fp32 contiguous. Writes dq
// (B, T, H, hd) and dk, dv (B, T, Hk, hd), contiguous in the input type;
// delta (B, H, T) and dk_part, dv_part (B, T, H, hd) are fp32 scratch. bf16
// goes to the tensor-core kernels (hd 64 or 128) and needs `plans`: four TMA
// plans (q, k, v, dout). Launches on `stream`, does not synchronise.
extern "C" int repro_flash_bwd(const void* q, const void* k, const void* v, const void* o,
                               const void* dout, const void* lse, void* dq, void* dk, void* dv,
                               void* delta, void* dk_part, void* dv_part, int is_bf16, int64_t B,
                               int64_t T, int64_t H, int64_t Hk, int64_t hd, int64_t sqb, int64_t sqt,
                               int64_t sqh, int64_t skb, int64_t skt, int64_t skh, int64_t svb,
                               int64_t svt, int64_t svh, int64_t sob, int64_t sot, int64_t soh,
                               int64_t sdb, int64_t sdt, int64_t sdh, float scale, int causal,
                               const int64_t* plans, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0 || Hk <= 0 || H % Hk != 0 || B > 65535 || H > 65535 ||
      T > INT_MAX - kBQ)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t st[15] = {sqb, sqt, sqh, skb, skt, skh, svb, svt, svh, sob, sot, soh, sdb, sdt, sdh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int t = static_cast<int>(T), h = static_cast<int>(H), group = static_cast<int>(H / Hk);
  const int b = static_cast<int>(B), d = static_cast<int>(hd);
  if (!is_bf16)
    return static_cast<int>(launch_bwd_hd<float>(d, bwd_params<float>(q, k, v, o, dout, lse, dq, dk, dv, delta,
                                                                       dk_part, dv_part, st, t, h, group, scale,
                                                                       causal != 0),
                                                  b, s));
  if (plans == nullptr || (hd != 64 && hd != 128)) return static_cast<int>(cudaErrorInvalidValue);
  const tc::Plan* pl = reinterpret_cast<const tc::Plan*>(plans);
  if (!plan_fits(pl[0], B, T, H) || !plan_fits(pl[1], B, T, Hk) || !plan_fits(pl[2], B, T, Hk) ||
      !plan_fits(pl[3], B, T, H))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap maps[4];
  tc::BwdParams p;
  const void* ptrs[4] = {q, k, v, dout};
  tc::MapPos* pos[4] = {&p.mq, &p.mk, &p.mv, &p.mdo};
  for (int i = 0; i < 4; ++i) {
    const cudaError_t err = tc::encode(&maps[i], pos[i], pl[i], ptrs[i], d);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  p.o = static_cast<const __nv_bfloat16*>(o);
  p.dout = static_cast<const __nv_bfloat16*>(dout);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<float*>(delta);
  p.dq = static_cast<__nv_bfloat16*>(dq);
  p.dk_part = static_cast<float*>(dk_part);
  p.dv_part = static_cast<float*>(dv_part);
  p.sob = sob, p.sot = sot, p.soh = soh, p.sdb = sdb, p.sdt = sdt, p.sdh = sdh;
  p.n_tok = t;
  p.H = h;
  p.group = group;
  p.scale = scale;
  p.scale_log2 = scale * tc::kLog2e;
  p.causal = causal != 0;
  cudaError_t err = d == 64 ? tc::launch_bwd<64>(maps, p, b, s) : tc::launch_bwd<128>(maps, p, b, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = launch_group_sum(bwd_params<__nv_bfloat16>(q, k, v, o, dout, lse, dq, dk, dv, delta, dk_part, dv_part, st,
                                                   t, h, group, scale, causal != 0),
                         b, d, s);
  if (err == cudaSuccess) ++g_tc_launches[1];
  return static_cast<int>(err);
}

// Launches of the tensor-core kernels since the library was loaded:
// which = 0 the forward, 1 the backward.
extern "C" int64_t repro_flash_tc_launches(int which) { return g_tc_launches[which != 0]; }
