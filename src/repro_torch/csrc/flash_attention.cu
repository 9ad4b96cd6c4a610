// flash_attention (forward): causal FlashAttention-2 over queries
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
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qf.x, kf[j].x, s[i][j]);
          s[i][j] = fmaf(qf.y, kf[j].y, s[i][j]);
          s[i][j] = fmaf(qf.z, kf[j].z, s[i][j]);
          s[i][j] = fmaf(qf.w, kf[j].w, s[i][j]);
        }
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
        const float* vrow = sKV + (j + jj) * L::LD + L::VEC * tx;
        float vv[L::CPT];
#pragma unroll
        for (int ch = 0; ch < L::NCH; ++ch) {
          const float* src = vrow + 16 * L::VEC * ch;
          if constexpr (L::VEC == 4) {
            const float4 t4 = *reinterpret_cast<const float4*>(src);
            vv[4 * ch] = t4.x; vv[4 * ch + 1] = t4.y; vv[4 * ch + 2] = t4.z; vv[4 * ch + 3] = t4.w;
          } else if constexpr (L::VEC == 2) {
            const float2 t2 = *reinterpret_cast<const float2*>(src);
            vv[2 * ch] = t2.x; vv[2 * ch + 1] = t2.y;
          } else {
            vv[ch] = *src;
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = jj == 0 ? pf[i].x : jj == 1 ? pf[i].y : jj == 2 ? pf[i].z : pf[i].w;
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
