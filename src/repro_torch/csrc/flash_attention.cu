// flash_attention, forward: causal FlashAttention-2 over queries
// (B, T, H, hd) and keys / values (B, T, Hk, hd), H a multiple of Hk, with
// fp32 online-softmax statistics. Writes O (B, T, H, hd) in the input type
// and LSE = m + log l (B, H, T) in fp32.
//
// Replaces the TPU kernel repro/kernels/flash_attention/flash_attention.py::
// flash_fwd (_fwd_kernel), and with it what surrounds that call: the
// (B, T, H, hd) -> (BH, T, hd) transposes and the T / hd padding of
// repro/kernels/flash_attention/ops.py::_fwd_impl, and the kv-head repeat of
// repro/models/attention.py::_expand_kv. Queries, keys and values are read
// through their strides; query head h reads kv head h / (H / Hk).
//
// Bound on H100: operations. A causal launch does 4 * hd * H * B * T(T+1)/2
// flops (two products over the lower triangle) on O(B * T * H * hd) bytes:
// at B = 1, T = 32,768, H = 16, hd = 128 that is 4.4 TFLOP over 0.3 GB, so
// the least time is flops / 989 TFLOP/s (bf16 tensor cores), 4.4 ms. This
// kernel runs both products as fp32 FMAs on the CUDA cores (67 TFLOP/s
// peak), so it can reach at most 1/15 of that bound; moving them to the
// tensor cores (mma.sync, then wgmma fed by TMA) is later work.
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
// flash_attention, backward: dQ, dK and dV from q, k, v, O, dO and the
// forward's LSE. Replaces the TPU kernel flash_attention.py::flash_bwd
// (_dkv_kernel and _dq_kernel), the delta = rowsum(dO·O) computed beside
// it, and again the transposes, padding and kv-head repeat around it:
// q, k, v, O and dO are read through their strides, query head h reads kv
// head h / (H / Hk), and dK, dV of the G query heads of a group are summed
// here (the transpose of _expand_kv, which the reference gets by autodiff).
//
// Bound on H100: operations. The least work is five products over the
// lower triangle (S, dP, dV, dQ, dK): 5 * hd * H * B * T(T+1) flops. At
// the qwen2.5-3b train shape (B 1, T 4,096, H 16, hd 128) that is 1.72e11
// flops over about 70 MB, 0.174 ms on the bf16 tensor cores. These kernels
// run seven products (S and dP are formed once in each of the first two
// kernels, as in the reference's two kernels) as fp32 FMAs on the CUDA
// cores, 67 TFLOP/s at most; the tensor cores are later work.
//
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
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

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

// 16 bytes of the input (8 bf16 or 4 fp32) to fp32 in shared memory.
__device__ __forceinline__ void load16(const float* src, float* dst) {
  *reinterpret_cast<float4*>(dst) = __ldg(reinterpret_cast<const float4*>(src));
}

__device__ __forceinline__ void load16(const __nv_bfloat16* src, float* dst) {
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(src));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
  float2 f[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) f[k] = __bfloat1622float2(h[k]);
  reinterpret_cast<float4*>(dst)[0] = make_float4(f[0].x, f[0].y, f[1].x, f[1].y);
  reinterpret_cast<float4*>(dst)[1] = make_float4(f[2].x, f[2].y, f[3].x, f[3].y);
}

__device__ __forceinline__ void store(float* dst, float x) { *dst = x; }
__device__ __forceinline__ void store(__nv_bfloat16* dst, float x) { *dst = __float2bfloat16_rn(x); }

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

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
  const int64_t n_chunks = static_cast<int64_t>(B) * a.n_tok * (a.H / a.group) * (HD / 4);
  const int64_t want = (n_chunks + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < 132 * 16 ? want : 132 * 16);  // a grid-stride loop past that
  flash_bwd_group_sum_kernel<T><<<blocks, kThreads, 0, stream>>>(a, n_chunks, HD / 4);
  return cudaGetLastError();
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

// q (B, T, H, hd), k and v (B, T, Hk, hd), all fp32 or all bf16 on the
// device, last dim contiguous; strides in elements (b, t, h) for each, each
// a multiple of 16 bytes, base pointers 16-byte aligned. o (B, T, H, hd)
// contiguous, in the input type; lse (B, H, T) contiguous fp32. Launches on
// `stream`, does not synchronise.
extern "C" int repro_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                               int is_bf16, int64_t B, int64_t T, int64_t H, int64_t Hk, int64_t hd,
                               int64_t sqb, int64_t sqt, int64_t sqh, int64_t skb, int64_t skt,
                               int64_t skh, int64_t svb, int64_t svt, int64_t svh, float scale,
                               int causal, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0 || Hk <= 0 || H % Hk != 0 || B > 65535 || H > 65535 ||
      T > INT_MAX - kBQ)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t st[9] = {sqb, sqt, sqh, skb, skt, skh, svb, svt, svh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int b = static_cast<int>(B), t = static_cast<int>(T), h = static_cast<int>(H);
  const int group = static_cast<int>(H / Hk), d = static_cast<int>(hd);
  const cudaError_t err =
      is_bf16 ? launch_hd<__nv_bfloat16>(d, q, k, v, o, lse, b, t, h, group, st, scale, causal != 0, s)
              : launch_hd<float>(d, q, k, v, o, lse, b, t, h, group, st, scale, causal != 0, s);
  return static_cast<int>(err);
}

// q, o, dout (B, T, H, hd), k and v (B, T, Hk, hd), all fp32 or all bf16 on
// the device, each read through its strides (b, t, h) in elements as the
// forward reads q, k, v; lse (B, H, T) fp32 contiguous. Writes dq
// (B, T, H, hd) and dk, dv (B, T, Hk, hd), contiguous in the input type;
// delta (B, H, T) and dk_part, dv_part (B, T, H, hd) are fp32 scratch.
// Launches on `stream`, does not synchronise.
extern "C" int repro_flash_bwd(const void* q, const void* k, const void* v, const void* o,
                               const void* dout, const void* lse, void* dq, void* dk, void* dv,
                               void* delta, void* dk_part, void* dv_part, int is_bf16, int64_t B,
                               int64_t T, int64_t H, int64_t Hk, int64_t hd, int64_t sqb, int64_t sqt,
                               int64_t sqh, int64_t skb, int64_t skt, int64_t skh, int64_t svb,
                               int64_t svt, int64_t svh, int64_t sob, int64_t sot, int64_t soh,
                               int64_t sdb, int64_t sdt, int64_t sdh, float scale, int causal,
                               void* stream) {
  if (B <= 0 || T <= 0 || H <= 0 || Hk <= 0 || H % Hk != 0 || B > 65535 || H > 65535 ||
      T > INT_MAX - kBQ)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t st[15] = {sqb, sqt, sqh, skb, skt, skh, svb, svt, svh, sob, sot, soh, sdb, sdt, sdh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int t = static_cast<int>(T), h = static_cast<int>(H), group = static_cast<int>(H / Hk);
  const int b = static_cast<int>(B), d = static_cast<int>(hd);
  const cudaError_t err =
      is_bf16 ? launch_bwd_hd<__nv_bfloat16>(d, bwd_params<__nv_bfloat16>(q, k, v, o, dout, lse, dq, dk, dv,
                                                                           delta, dk_part, dv_part, st, t, h,
                                                                           group, scale, causal != 0),
                                             b, s)
              : launch_bwd_hd<float>(d, bwd_params<float>(q, k, v, o, dout, lse, dq, dk, dv, delta, dk_part,
                                                          dv_part, st, t, h, group, scale, causal != 0),
                                     b, s);
  return static_cast<int>(err);
}
