// The material fetch's backward, Hopper (sm_90a): the cotangents of the
// fetch's two gathers summed over the lanes of each material row into the
// gradient of the factor table.
//
// Replaces no TPU kernel.  mtllib.fetch_material gathers a lane's factors
// by its material row, base_rgb = fac[:, 0, 0:3][row] [N, 3] and
// scal_tab = fac[:, :, 0][row] [N, 12]; under autograd each gather's
// backward is index_put_(accumulate=True), which PyTorch runs on the card
// as a radix sort and one thread per (row, column) walking that row's run
// of lanes serially, two dependent loads a lane.  A scene has a handful
// of rows (the cornells: 5), so ~260k lane contributions a gather went
// through ~75 threads: tens of ms a bounce.  mtllib.MaterialRows puts this
// kernel in its place; its plain twin is
// mtllib.material_rows_backward_plain (the gathers' own backward,
// index_put_ with accumulate into the rows).
//
// Output: out [rows, 12, 4] f32, the gradient of fac:
//   out[r, 0, c] = sum of g_base[:, c] over the lanes of row r (c < 3),
//   out[r, p, 0] = sum of g_scal[:, p] over those lanes (p < 12),
//   out[r, 0, 0] = both sums, added;
//   every other entry 0.  Row ids lie in [0, rows) (mtllib.fetch_material
//   maps a missing material to the defaults row) and are compared by
//   their low 32 bits.
// Each sum is the one index_put_ makes on the card (a stable sort, then
// one thread a row and column): float32, from 0, lane by lane in lane
// order.  So the gradient is the aten path's bit for bit, and the
// same bits on every run.  Sums in float64 would sit closer to the exact
// ones, but at 512^2 lanes those float32 sums are up to ~3e-5 of the
// gradient's norm away from exact, and the reference that monkey.inverse
// checks against makes them: its grad_gap limit is 1e-5.
//
// What bounds it on this card: each (row, column) sum is a chain of
// dependent f32 adds, one a lane of the row (4 cycles each), so the
// longest row's lane count x 4 cycles (cornell_monkey's first bounce:
// 136,223 of 262,144 lanes, ~0.28 ms at 1.98 GHz), where the bytes,
// n * (8 + 15 * 4) (17.8 MB at 512^2), take 5.3 us at 3.35 TB/s.
// What the design does about it: a block of kWarps warps owns kWarps rows,
// a warp a row, its first 15 threads a column's chain each.  The block
// streams the lanes in tiles of kTile through shared memory with plain
// coalesced loads, the next tile's loads in flight (in registers) while
// the current one is summed.  In each tile a warp lists its row's lanes in
// lane order (a ballot and a population count a 32 lanes), so a chain adds
// only its row's lanes.  The list is padded to whole pairs of kBatch with
// the zero lane (adding +0 leaves a sum from +0 unchanged), so the loop
// over a pair has no branch: it loads the next batch's values and the
// one after's list entries while it adds this batch, and those loads fill
// the adds' latency.  Rows tile over blocks, so any number of materials
// runs; every block reads every lane, so the bytes grow with the number
// of blocks.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kCols = 15;    // basecolor's 3 channels, then 12 parameters
constexpr int kWarps = 8;    // rows a block, a warp each
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 512;   // lanes a tile
constexpr int kPer = kTile / kThreads;  // a thread's lanes of a tile's loads
constexpr int kBatch = 16;   // lanes a chain loads ahead of its adds
constexpr int kList = kTile + 2 * kBatch;  // the loop reads a pair ahead
constexpr int kOutCols = 12 * 4;  // fac's [12 parameters, 4 channels] a row

struct Staged {  // a thread's share of one tile, in registers
  int id[kPer];
  float base[3 * kPer];
  float scal[12 * kPer];
};

// Tile `first`'s lanes into registers, coalesced; lanes past n read as
// row -1 (no row).
__device__ __forceinline__ void load_tile(Staged& st, const int* rid,
                                          const float* g_base,
                                          const float* g_scal, int n,
                                          int first) {
  const int cnt = min(kTile, n - first);
  const float* b = g_base + static_cast<size_t>(first) * 3;
  const float* s = g_scal + static_cast<size_t>(first) * 12;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int j = threadIdx.x + i * kThreads;
    st.id[i] = j < cnt ? rid[2 * (static_cast<size_t>(first) + j)] : -1;
  }
#pragma unroll
  for (int i = 0; i < 3 * kPer; ++i) {
    const int e = threadIdx.x + i * kThreads;
    st.base[i] = e < cnt * 3 ? b[e] : 0.0f;
  }
#pragma unroll
  for (int i = 0; i < 12 * kPer; ++i) {
    const int e = threadIdx.x + i * kThreads;
    st.scal[i] = e < cnt * 12 ? s[e] : 0.0f;
  }
}

// The registers into shared memory, in the tile's own layout.
__device__ __forceinline__ void store_tile(const Staged& st, int* ids,
                                           float* base, float* scal) {
#pragma unroll
  for (int i = 0; i < kPer; ++i) ids[threadIdx.x + i * kThreads] = st.id[i];
#pragma unroll
  for (int i = 0; i < 3 * kPer; ++i)
    base[threadIdx.x + i * kThreads] = st.base[i];
#pragma unroll
  for (int i = 0; i < 12 * kPer; ++i)
    scal[threadIdx.x + i * kThreads] = st.scal[i];
}

__device__ __forceinline__ void entries(int (&e)[kBatch], const short* lst) {
#pragma unroll
  for (int k = 0; k < kBatch; ++k) e[k] = lst[k];
}

__device__ __forceinline__ void values(float (&x)[kBatch],
                                       const int (&e)[kBatch],
                                       const float* col, int stride) {
#pragma unroll
  for (int k = 0; k < kBatch; ++k) x[k] = col[e[k] * stride];
}

__device__ __forceinline__ void add(float& s, const float (&x)[kBatch]) {
#pragma unroll
  for (int k = 0; k < kBatch; ++k) s += x[k];
}

__global__ void __launch_bounds__(kThreads)
material_rows_kernel(const int64_t* __restrict__ row,
                     const float* __restrict__ g_base,
                     const float* __restrict__ g_scal, int n, int rows,
                     float* __restrict__ out) {
  // the tile's lanes, then lane kTile: zeros
  __shared__ int ids[kTile];
  __shared__ float base[(kTile + 1) * 3];
  __shared__ float scal[(kTile + 1) * 12];
  // a warp's row's lanes in this tile, in lane order, padded with kTile
  __shared__ short list[kWarps][kList];
  const int warp = threadIdx.x >> 5, t = threadIdx.x & 31;
  const int r = blockIdx.x * kWarps + warp;
  const int* rid = reinterpret_cast<const int*>(row);  // low words: 2j
  short* lst = list[warp];
  if (t < 12) scal[kTile * 12 + t] = 0.0f;
  if (t < 3) base[kTile * 3 + t] = 0.0f;
  for (int k = t; k < kList; k += 32) lst[k] = kTile;
  // column t's chain (t < 15): its sum, its column of the tile
  float s = 0.0f;
  const float* col = t < 3 ? base + t : scal + (t - 3);
  const int stride = t < 3 ? 3 : 12;
  Staged st;
  load_tile(st, rid, g_base, g_scal, n, 0);
  for (int first = 0; first < n; first += kTile) {
    store_tile(st, ids, base, scal);
    __syncthreads();
    if (first + kTile < n)
      load_tile(st, rid, g_base, g_scal, n, first + kTile);
    if (r < rows) {
      int cnt = 0;
#pragma unroll
      for (int g = 0; g < kTile; g += 32) {
        const bool hit = ids[g + t] == r;
        const unsigned m = __ballot_sync(0xffffffffu, hit);
        if (hit)
          lst[cnt + __popc(m & ((1u << t) - 1u))] = static_cast<short>(g + t);
        cnt += __popc(m);
      }
      const int pairs = (cnt + 2 * kBatch - 1) / (2 * kBatch);
      if (cnt + t < pairs * 2 * kBatch) lst[cnt + t] = kTile;
      __syncwarp();
      if (t < kCols && pairs) {
        // x: batch b's values; e: batch b + 1's entries
        int e[kBatch];
        float x[kBatch], y[kBatch];
        entries(e, lst);
        values(x, e, col, stride);
        entries(e, lst + kBatch);
        for (int b = 0; b < 2 * pairs; b += 2) {
          values(y, e, col, stride);
          entries(e, lst + (b + 2) * kBatch);
          add(s, x);
          values(x, e, col, stride);
          entries(e, lst + (b + 3) * kBatch);
          add(s, y);
        }
      }
    }
    __syncthreads();  // every warp is done with the tile
  }

  // row r's 48 entries, a warp's two passes over them
  for (int e = t; e < 64; e += 32) {
    const int p = min(e / 4, 11), ch = e % 4;
    const float sp = __shfl_sync(0xffffffffu, s, 3 + p);
    const float sc = __shfl_sync(0xffffffffu, s, ch);
    float v = ch == 0 ? sp : 0.0f;
    if (p == 0 && ch < 3) v += sc;
    if (r < rows && e < kOutCols)
      out[static_cast<size_t>(r) * kOutCols + e] = v;
  }
}

}  // namespace

extern "C" {

// The backward of the two gathers: row [n] int64, g_base [n, 3] and
// g_scal [n, 12] f32, contiguous, n >= 1, rows >= 1; out [rows, 12, 4]
// f32.  One launch on the stream.  Returns cudaGetLastError() after the
// launch.
int ptina_material_rows(const int64_t* row, const float* g_base,
                        const float* g_scal, int n, int rows, float* out,
                        void* stream) {
  const int blocks = (rows + kWarps - 1) / kWarps;
  material_rows_kernel<<<blocks, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      row, g_base, g_scal, n, rows, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
