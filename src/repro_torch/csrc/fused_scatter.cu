// fused_scatter: in place, table[ids[i]] += rows[i] (add) or
// table[ids[i]] = rows[i] (set), for every slot i whose id lies in [0, R)
// and whose valid flag is set. Ids are unique among those slots, so every
// table row has at most one writer.
//
// Replaces the TPU kernel repro/kernels/fused_scatter/fused_scatter.py::
// scatter_rows_padded (_kernel_add, _kernel_set: one scalar-prefetched row
// read-modify-write per grid step, the table donated and aliased to the
// output). The TPU version sends invalid slots to row 0 with a zero delta
// (add) or a copy-through (set); here many warps aliasing row 0 would race,
// so an invalid slot is predicated off and writes nothing.
//
// Bound on H100: bytes. One add per element against 12 B moved (add: read
// the table row and the delta, write the row) or 8 B (set: read the new
// row, write it). Least time = live slots * D * 4 B * (3 for add, 2 for
// set) over 3.35 TB/s.
//
// Design: one warp per slot. Each lane moves 16-byte float4 chunks, so a
// 128-wide fp32 row is one coalesced 512 B warp access; many independent
// warps in flight hide the latency of the random row addresses. No atomics:
// unique ids give each row one writer. Addresses are 64-bit. When D % 4 != 0
// or a pointer is not 16-byte aligned the same kernel uses a scalar loop.
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kWarpsPerBlock = 8;

template <typename IdT, bool kAdd>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
scatter_rows_kernel(float* __restrict__ table, const IdT* __restrict__ ids,
                    const uint8_t* __restrict__ valid, const float* __restrict__ rows,
                    int64_t R, int64_t D, int64_t K, bool vec4) {
  const int lane = threadIdx.x & 31;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (i >= K) return;
  const int64_t r = static_cast<int64_t>(ids[i]);
  if (r < 0 || r >= R || (valid != nullptr && valid[i] == 0)) return;
  float* dst = table + r * D;
  const float* src = rows + i * D;
  if (vec4) {
    float4* d4 = reinterpret_cast<float4*>(dst);
    const float4* s4 = reinterpret_cast<const float4*>(src);
    for (int64_t c = lane; c < D / 4; c += 32) {
      float4 x = __ldg(s4 + c);
      if (kAdd) {
        const float4 t = d4[c];
        x.x = t.x + x.x;
        x.y = t.y + x.y;
        x.z = t.z + x.z;
        x.w = t.w + x.w;
      }
      d4[c] = x;
    }
  } else {
    for (int64_t c = lane; c < D; c += 32) {
      const float x = __ldg(src + c);
      dst[c] = kAdd ? dst[c] + x : x;
    }
  }
}

template <typename IdT>
void launch(float* t, const void* ids, const uint8_t* valid, const float* rows, int64_t R,
            int64_t D, int64_t K, bool vec4, bool add, dim3 grid, cudaStream_t s) {
  const IdT* id = static_cast<const IdT*>(ids);
  if (add) {
    scatter_rows_kernel<IdT, true><<<grid, kWarpsPerBlock * 32, 0, s>>>(t, id, valid, rows, R, D, K, vec4);
  } else {
    scatter_rows_kernel<IdT, false><<<grid, kWarpsPerBlock * 32, 0, s>>>(t, id, valid, rows, R, D, K, vec4);
  }
}

}  // namespace

// table (R, D) fp32, updated in place; ids (K,) int32 or int64; valid (K,)
// bytes 0/1 or null (all valid); rows (K, D) fp32; all contiguous on the
// device. is_add: 1 adds, 0 sets. Launches on `stream`, does not synchronise.
extern "C" int repro_scatter_rows(void* table, const void* ids, int ids_are_int64,
                                  const void* valid, const void* rows, int64_t R, int64_t D,
                                  int64_t K, int is_add, void* stream) {
  const int64_t blocks = (K + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (K <= 0 || D <= 0 || R <= 0 || blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec4 = D % 4 == 0 &&
      ((reinterpret_cast<uintptr_t>(table) | reinterpret_cast<uintptr_t>(rows)) % 16) == 0;
  float* t = static_cast<float*>(table);
  const float* r = static_cast<const float*>(rows);
  const uint8_t* v = static_cast<const uint8_t*>(valid);
  const dim3 grid(static_cast<unsigned>(blocks));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ids_are_int64) {
    launch<int64_t>(t, ids, v, r, R, D, K, vec4, is_add != 0, grid, s);
  } else {
    launch<int32_t>(t, ids, v, r, R, D, K, vec4, is_add != 0, grid, s);
  }
  return static_cast<int>(cudaGetLastError());
}
