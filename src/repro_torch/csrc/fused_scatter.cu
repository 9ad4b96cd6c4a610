// fused_scatter: in place, table[ids[i]] += rows[i] (add) or
// table[ids[i]] = rows[i] (set), for every slot i whose id lies in [0, R)
// and whose valid flag is set. Ids are unique among those slots, so every
// table row has at most one writer.
//
// Replaces the TPU kernel repro/kernels/fused_scatter/fused_scatter.py::
// scatter_rows_padded (_kernel_add, _kernel_set: one scalar-prefetched row
// read-modify-write per grid step, the table donated and aliased to the
// output). The TPU version sends invalid slots to row 0 with a zero delta
// (add) or a copy-through (set); here many writers aliasing row 0 would
// race, so an invalid slot is predicated off and writes nothing.
//
// Bound on H100: bytes. One add per element against 12 B moved (add: read
// the table row and the delta, write the row) or 8 B (set: read the new
// row, write it), plus each slot's id and flag. Least time = live slots * D
// * 4 B * (3 for add, 2 for set) + K * (id + flag bytes) over 3.35 TB/s.
//
// Design. Most slots are dead (SparseAdam's adds at dlrm's train batch: 10%
// of 3.4 M slots live), so the work is the live rows, found without a pass
// of their own:
//   * a persistent grid, the SM count times the blocks an SM holds at once
//     (cudaOccupancyMaxActiveBlocksPerMultiprocessor, queried once per
//     kernel and cached); each warp strides over work items, a chunk of 32
//     slots and one column slice of their rows (D/128 slices of a row wider
//     than 128, so that a few thousand live rows of dim 2,048 still give
//     thousands of warps work; one slice otherwise);
//   * lane j loads the chunk's id and flag j in one coalesced access, a
//     ballot gives the live mask, and the live slots are compacted into a
//     per-warp list in shared memory (rank = popc of the lower lanes' bits);
//     the next chunk's ids and flags are loaded into registers before this
//     chunk's rows move, so their latency hides behind the rows;
//   * `lanes` = min(32, D/4 rounded up to a power of two) threads move one
//     row's slice with float4 accesses, one each (a warp per row at D >=
//     128, 16 rows a warp at D 8); each row group has up to kUnroll live
//     rows in flight, all their loads issued before the first store;
//   * the delta rows are read once with a streaming hint (__ldcs); the table
//     rows are read, modified and written.
// No atomics: unique ids give each row one writer; each element gets one
// fp32 add, bit-equal to index_add_. Addresses are 64-bit. When D % 4 != 0
// or a pointer is not 16-byte aligned the same kernel moves scalars.
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;  // live rows a row group has in flight

__device__ __forceinline__ float4 ld_stream(const float4* p) { return __ldcs(p); }
__device__ __forceinline__ float ld_stream(const float* p) { return __ldcs(p); }

__device__ __forceinline__ float4 vadd(const float4 t, const float4 x) {
  return make_float4(t.x + x.x, t.y + x.y, t.z + x.z, t.w + x.w);
}
__device__ __forceinline__ float vadd(const float t, const float x) { return t + x; }

// V is float4 (D % 4 == 0, aligned) or float; cols = D / (elements of V).
template <typename IdT, bool kAdd, typename V>
__global__ void __launch_bounds__(kThreads)
scatter_rows_kernel(V* __restrict__ table, const IdT* __restrict__ ids, const uint8_t* __restrict__ valid,
                    const V* __restrict__ rows, int64_t R, int64_t cols, int64_t K, int lanes) {
  __shared__ int64_t live_row[kWarps][32];  // per warp: the live slots' table rows ...
  __shared__ int live_slot[kWarps][32];     // ... and their lanes in the chunk, in lane order
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int groups = 32 / lanes;  // row groups per warp
  const int grp = lane / lanes;
  const int col0 = lane & (lanes - 1);
  const int64_t slices = (cols + lanes - 1) / lanes;  // column slices of a row: each lane one column
  const int64_t n_items = (K + 31) / 32 * slices;
  const int64_t step = static_cast<int64_t>(gridDim.x) * kWarps;
  int64_t w = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
  IdT id = 0;
  bool ok = false;
  if (w < n_items && w / slices * 32 + lane < K) {
    id = ids[w / slices * 32 + lane];
    ok = valid == nullptr || valid[w / slices * 32 + lane] != 0;
  }
  while (w < n_items) {  // uniform across the warp
    const int64_t c = w / slices;
    const int64_t cc = (w - c * slices) * lanes + col0;  // this lane's column
    const int64_t r = static_cast<int64_t>(id);
    const bool live = ok && r >= 0 && r < R;
    const int64_t next = w + step;  // its ids and flags load now, are used next round
    ok = false;
    if (next < n_items && next / slices * 32 + lane < K) {
      id = ids[next / slices * 32 + lane];
      ok = valid == nullptr || valid[next / slices * 32 + lane] != 0;
    }
    const unsigned mask = __ballot_sync(0xffffffffu, live);
    if (mask != 0u) {
      if (live) {
        const int k = __popc(mask & ((1u << lane) - 1u));
        live_row[warp][k] = r;
        live_slot[warp][k] = lane;
      }
      __syncwarp();
      const int n = __popc(mask);
      for (int base = 0; base < n; base += groups * kUnroll) {
        V* dst[kUnroll];
        const V* src[kUnroll];
        bool has[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int k = base + u * groups + grp;
          has[u] = k < n;
          const int kk = has[u] ? k : 0;
          dst[u] = table + live_row[warp][kk] * cols;
          src[u] = rows + (c * 32 + live_slot[warp][kk]) * cols;
        }
        if (cc < cols) {
          V x[kUnroll], t[kUnroll];
#pragma unroll
          for (int u = 0; u < kUnroll; ++u)
            if (has[u]) x[u] = ld_stream(src[u] + cc);
          if (kAdd) {
#pragma unroll
            for (int u = 0; u < kUnroll; ++u)
              if (has[u]) t[u] = dst[u][cc];
          }
#pragma unroll
          for (int u = 0; u < kUnroll; ++u)
            if (has[u]) dst[u][cc] = kAdd ? vadd(t[u], x[u]) : x[u];
        }
      }
      __syncwarp();  // the lists are read before the next item writes them
    }
    w = next;
  }
}

// Blocks resident on the card at once for one instantiation, queried once.
template <typename IdT, bool kAdd, typename V>
int resident_blocks() {
  static const int blocks = [] {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, scatter_rows_kernel<IdT, kAdd, V>, kThreads, 0);
    return (sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
  }();
  return blocks;
}

template <typename IdT, bool kAdd, typename V>
void launch(void* t, const void* ids, const uint8_t* valid, const void* rows, int64_t R, int64_t cols,
            int64_t K, int lanes, cudaStream_t s) {
  const int64_t needed = ((K + 31) / 32 * ((cols + lanes - 1) / lanes) + kWarps - 1) / kWarps;  // an item a warp
  const int64_t cap = resident_blocks<IdT, kAdd, V>();
  const unsigned grid = static_cast<unsigned>(needed < cap ? needed : cap);
  scatter_rows_kernel<IdT, kAdd, V><<<grid, kThreads, 0, s>>>(
      static_cast<V*>(t), static_cast<const IdT*>(ids), valid, static_cast<const V*>(rows), R, cols, K,
      lanes);
}

template <typename IdT, typename V>
void launch_op(void* t, const void* ids, const uint8_t* valid, const void* rows, int64_t R, int64_t cols,
               int64_t K, int lanes, bool add, cudaStream_t s) {
  if (add) {
    launch<IdT, true, V>(t, ids, valid, rows, R, cols, K, lanes, s);
  } else {
    launch<IdT, false, V>(t, ids, valid, rows, R, cols, K, lanes, s);
  }
}

}  // namespace

// table (R, D) fp32, updated in place; ids (K,) int32 or int64; valid (K,)
// bytes 0/1 or null (all valid); rows (K, D) fp32; all contiguous on the
// device. is_add: 1 adds, 0 sets. Launches on `stream`, does not synchronise.
extern "C" int repro_scatter_rows(void* table, const void* ids, int ids_are_int64,
                                  const void* valid, const void* rows, int64_t R, int64_t D,
                                  int64_t K, int is_add, void* stream) {
  if (K <= 0 || D <= 0 || R <= 0 || K > INT64_MAX - 32) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec4 = D % 4 == 0 &&
      ((reinterpret_cast<uintptr_t>(table) | reinterpret_cast<uintptr_t>(rows)) % 16) == 0;
  const int64_t cols = vec4 ? D / 4 : D;
  int lanes = 1;
  while (lanes < cols && lanes < 32) lanes <<= 1;
  const uint8_t* v = static_cast<const uint8_t*>(valid);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool add = is_add != 0;
  if (ids_are_int64) {
    if (vec4) launch_op<int64_t, float4>(table, ids, v, rows, R, cols, K, lanes, add, s);
    else launch_op<int64_t, float>(table, ids, v, rows, R, cols, K, lanes, add, s);
  } else {
    if (vec4) launch_op<int32_t, float4>(table, ids, v, rows, R, cols, K, lanes, add, s);
    else launch_op<int32_t, float>(table, ids, v, rows, R, cols, K, lanes, add, s);
  }
  return static_cast<int>(cudaGetLastError());
}
