// The texel gather's backward, Hopper (sm_90a): the cotangent rows of one
// gather data[texid, x, y] summed over the lanes of each texel into the
// gradient of the texture atlas.
//
// Replaces no TPU kernel.  texture.sample_texture fetches a texel with
// four gathers, data[texid, x, y] [N, 4]; under autograd each gather's
// backward is index_put_(accumulate=True) into zeros, which PyTorch runs on
// the card as a radix sort of the lanes by texel and one thread per
// (texel, channel) walking that texel's run of lanes serially.  On a
// textured scene most lanes carry an all-zero cotangent row (a fetch of a
// parameter bound to no map, a lane on no live path), and the sky's and
// the ground's lanes all read the texels at uv 0: one thread walked ~200k
// lanes of zeros, 116 times a 1-spp gradient step.  texture.TexelRows puts
// this kernel in its place; its plain twin is
// texture.texel_rows_backward_plain (the gather's own backward).
//
// Output: out [texels, 4] f32 (the atlas [T, H, W, 4] flattened), where
// texel (t * H + x) * W + y gets, in each channel, the float32 sum from +0
// of the rows of its lanes, lane by lane in lane order: the sum index_put_
// makes on the card (a stable sort, then one thread a texel and channel,
// from 0), so the gradient is the aten path's bit for bit, the same bits
// on every run.  A lane whose four channels are all +0 or -0 is left out
// of every sum: a sum from +0 is never -0 under round-to-nearest (+0 + -0
// is +0, and so is an exact cancellation), and adding +0 or -0 to any
// other value leaves its bits as they were, so the sums are the same bits
// with or without such lanes.  A NaN is not zero, so its lane stays.
// Indices lie in range (the forward's gather read them); a lane whose
// texel falls outside the atlas is dropped rather than written.
//
// What bounds it on this card: the bytes every implementation moves, 16 a
// lane to learn whether its row is zero and 24 of indices a live lane (at
// 262,144 lanes and 1.5% live, ~4.3 MB: ~1.3 us at 3.35 TB/s), beside the
// longest texel's chain of dependent adds, 4 cycles an add.  What the
// design does about it, in two launches and no host sync:
//   1. texel_lanes_kernel, a block a segment of kSeg lanes, reads every
//      row with one 16-byte load a lane, reads the indices of the live
//      lanes only, and writes the segment's live lanes (texel key and row)
//      stably partitioned by key bucket (a ballot, a match and a
//      population count a warp; per-warp counts and one block scan), with
//      the bucket offsets.  A segment with no live lane writes its offsets
//      and stops.
//   2. texel_keys_kernel, a block a range of at most kKeys texels (a part
//      of one bucket) with their sums in shared memory, walks its bucket's
//      lanes of every segment in lane order, a tile at a time (the next
//      tile's loads in flight while the current one is summed).  In a
//      tile, warp w owns the texels whose offset in the range is w modulo
//      kWarps; in each batch of 32 lanes it matches equal texels, and the
//      first lane of each texel adds that texel's rows in lane order.
// Buckets follow the atlas (about 128 blocks' worth of texels, at most
// kBucketsMax), so the work of launch 2 follows the live lanes: a block
// reads only its own bucket's lanes, and a texel's chain is the one
// serial part.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kSeg = 2048;                    // lanes a segment (launch 1)
constexpr int kWarpLanes = kSeg / kWarps;     // a warp's contiguous lanes
constexpr int kChunks = kWarpLanes / 32;      // its batches of 32
constexpr int kBucketsMax = 1024;
constexpr int kKeys = 2048;                   // texels a launch-2 block
constexpr int kKeysMin = 32;
constexpr int kBlocksAim = 128;               // launch-2 blocks to aim for
constexpr int kTile = kThreads;               // lanes a tile (launch 2)
constexpr int kSegGroup = 1024;               // segments a pass (launch 2)
constexpr unsigned kFull = 0xffffffffu;

// The launch shape both kernels and the scratch size agree on.
struct Plan {
  int keys;     // texels a launch-2 block (kps)
  int per;      // texels a bucket, a multiple of keys
  int buckets;  // <= kBucketsMax
  int parts;    // launch-2 blocks a bucket (per / keys)
  int segs;     // segments of kSeg lanes
};

Plan plan(int n, int texels) {
  Plan p;
  const int aim = (texels + kBlocksAim - 1) / kBlocksAim;
  p.keys = aim < kKeysMin ? kKeysMin : (aim > kKeys ? kKeys : aim);
  int buckets = (texels + p.keys - 1) / p.keys;
  if (buckets > kBucketsMax) buckets = kBucketsMax;
  const int64_t per = (static_cast<int64_t>(texels) + buckets - 1) / buckets;
  p.parts = static_cast<int>((per + p.keys - 1) / p.keys);
  p.per = p.parts * p.keys;
  p.buckets = (texels + p.per - 1) / p.per;
  p.segs = (n + kSeg - 1) / kSeg;
  return p;
}

size_t align256(size_t b) { return (b + 255) & ~static_cast<size_t>(255); }

// Scratch: the partitioned rows (float4), their keys, the offsets.
size_t rows_bytes(const Plan& p) {
  return align256(static_cast<size_t>(p.segs) * kSeg * sizeof(float4));
}
size_t keys_bytes(const Plan& p) {
  return align256(static_cast<size_t>(p.segs) * kSeg * sizeof(int));
}
size_t offs_bytes(const Plan& p) {
  return align256(static_cast<size_t>(p.segs) * (p.buckets + 1) *
                  sizeof(int));
}

// Exclusive prefix sums of a[0, n) in place, by the whole block; returns
// the total.  wsum holds kWarps + 1 ints.
__device__ int block_exclusive_scan(int* a, int n, int* wsum) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int per = (n + kThreads - 1) / kThreads;
  const int lo = min(n, static_cast<int>(threadIdx.x) * per);
  const int hi = min(n, lo + per);
  int s = 0;
  for (int i = lo; i < hi; ++i) s += a[i];
  int v = s;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += u;
  }
  if (lane == 31) wsum[warp] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    int run = 0;
    for (int w = 0; w < kWarps; ++w) {
      const int t = wsum[w];
      wsum[w] = run;
      run += t;
    }
    wsum[kWarps] = run;
  }
  __syncthreads();
  int run = wsum[warp] + v - s;
  for (int i = lo; i < hi; ++i) {
    const int t = a[i];
    a[i] = run;
    run += t;
  }
  __syncthreads();
  return wsum[kWarps];
}

__device__ __forceinline__ bool nonzero(const float4& v) {
  return ((__float_as_uint(v.x) | __float_as_uint(v.y) |
           __float_as_uint(v.z) | __float_as_uint(v.w)) &
          0x7fffffffu) != 0u;
}

// Launch 1: a block a segment.  Warp w holds the segment's lanes
// [w * kWarpLanes, (w + 1) * kWarpLanes), kChunks batches of 32 in order,
// so (bucket, warp, batch, lane) is lane order within a bucket.
__global__ void __launch_bounds__(kThreads)
texel_lanes_kernel(const float4* __restrict__ g,
                   const int64_t* __restrict__ texid,
                   const int64_t* __restrict__ xs,
                   const int64_t* __restrict__ ys, int64_t st, int64_t sx,
                   int64_t sy, int n, int h, int w, int texels, int per,
                   int buckets, float4* __restrict__ rows,
                   int* __restrict__ keys, int* __restrict__ offs) {
  __shared__ int table[kBucketsMax * kWarps];  // [bucket][warp]
  __shared__ int wsum[kWarps + 1];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t seg = blockIdx.x;
  const int64_t first = seg * kSeg + warp * kWarpLanes;
  float4 v[kChunks];
  int key[kChunks];
  unsigned live = 0u;  // bit c: this thread's lane of batch c is live
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int64_t j = first + c * 32 + lane;
    v[c] = j < n ? g[j] : zero;
    key[c] = -1;
  }
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    if (nonzero(v[c])) {
      const int64_t j = first + c * 32 + lane;
      const int64_t k = (texid[j * st] * h + xs[j * sx]) * w + ys[j * sy];
      if (k >= 0 && k < texels) {
        key[c] = static_cast<int>(k);
        live |= 1u << c;
      }
    }
  }
  int* row = offs + seg * (buckets + 1);
  if (__syncthreads_count(live != 0u) == 0) {
    for (int i = threadIdx.x; i <= buckets; i += kThreads) row[i] = 0;
    return;
  }
  const int cells = buckets * kWarps;
  for (int i = threadIdx.x; i < cells; i += kThreads) table[i] = 0;
  __syncthreads();
  // each bucket's lanes in each warp
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const bool on = (live >> c) & 1u;
    const unsigned m = __ballot_sync(kFull, on);
    if (on) {
      const int b = key[c] / per;
      const unsigned peers = __match_any_sync(m, b);
      if (lane == __ffs(peers) - 1) table[b * kWarps + warp] += __popc(peers);
    }
    __syncwarp();
  }
  __syncthreads();
  const int total = block_exclusive_scan(table, cells, wsum);
  for (int b = threadIdx.x; b < buckets; b += kThreads)
    row[b] = table[b * kWarps];
  if (threadIdx.x == 0) row[buckets] = total;
  __syncthreads();  // warp 0's places below are the cells just read
  // each live lane to its bucket's place, in lane order
  const unsigned below = (1u << lane) - 1u;
  const int64_t base = seg * kSeg;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const bool on = (live >> c) & 1u;
    const unsigned m = __ballot_sync(kFull, on);
    unsigned peers = 0u;
    int* slot = nullptr;
    if (on) {
      const int b = key[c] / per;
      peers = __match_any_sync(m, b);
      slot = &table[b * kWarps + warp];
      const int64_t at = base + *slot + __popc(peers & below);
      keys[at] = key[c];
      rows[at] = v[c];
    }
    __syncwarp();
    if (on && lane == __ffs(peers) - 1) *slot += __popc(peers);
    __syncwarp();
  }
}

// One tile entry: the lane at position q of the bucket's lanes in this
// group of segments (start: the group's exclusive prefix, at: each
// segment's first lane of the bucket), or key -1 past the end.
__device__ __forceinline__ void load_entry(int& k, float4& v, int q,
                                           int total, int ng, int64_t g0,
                                           const int* start, const int* at,
                                           const int* __restrict__ keys,
                                           const float4* __restrict__ rows) {
  k = -1;
  v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (q >= total) return;
  int lo = 0, hi = ng - 1;  // the last segment whose start is <= q
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (start[mid] <= q) lo = mid;
    else hi = mid - 1;
  }
  const int64_t i = (g0 + lo) * kSeg + at[lo] + (q - start[lo]);
  k = keys[i];
  v = rows[i];
}

// Launch 2: block (bucket, part) owns texels [lo, hi).
__global__ void __launch_bounds__(kThreads)
texel_keys_kernel(const float4* __restrict__ rows,
                  const int* __restrict__ keys, const int* __restrict__ offs,
                  int segs, int buckets, int per, int kps, int parts,
                  int texels, float4* __restrict__ out) {
  __shared__ float4 acc[kKeys];
  __shared__ float4 tv[kTile + 1];  // the tile's rows, then +0
  __shared__ int tk[kTile];
  __shared__ int at[kSegGroup];
  __shared__ int start[kSegGroup];
  __shared__ int wsum[kWarps + 1];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int bucket = blockIdx.x / parts;
  const int lo = bucket * per + (blockIdx.x % parts) * kps;
  if (lo >= texels) return;
  const int nk = min(kps, texels - lo);
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int i = threadIdx.x; i < nk; i += kThreads) acc[i] = zero;
  if (threadIdx.x == 0) tv[kTile] = zero;
  for (int g0 = 0; g0 < segs; g0 += kSegGroup) {
    const int ng = min(kSegGroup, segs - g0);
    for (int i = threadIdx.x; i < ng; i += kThreads) {
      const int* r = offs + static_cast<int64_t>(g0 + i) * (buckets + 1);
      at[i] = r[bucket];
      start[i] = r[bucket + 1] - r[bucket];
    }
    __syncthreads();
    const int total = block_exclusive_scan(start, ng, wsum);
    int k;
    float4 v;
    load_entry(k, v, threadIdx.x, total, ng, g0, start, at, keys, rows);
    for (int t0 = 0; t0 < total; t0 += kTile) {
      tk[threadIdx.x] = k;
      tv[threadIdx.x] = v;
      __syncthreads();
      load_entry(k, v, t0 + kTile + threadIdx.x, total, ng, g0, start, at,
                 keys, rows);
      const int cnt = min(kTile, total - t0);
      for (int b = 0; b < cnt; b += 32) {
        const int e = b + lane;
        const int r = (e < cnt ? tk[e] : -1) - lo;
        const bool mine = r >= 0 && r < nk && (r & (kWarps - 1)) == warp;
        const unsigned m = __ballot_sync(kFull, mine);
        if (mine) {
          const unsigned peers = __match_any_sync(m, r);
          if (lane == __ffs(peers) - 1) {
            // this texel's rows of the batch, in lane order, four loads
            // ahead of their adds; +0 (tv[kTile]) pads the last four
            float4 s = acc[r];
            unsigned p = peers;
            while (p) {
              int q[4];
#pragma unroll
              for (int u = 0; u < 4; ++u) {
                q[u] = p ? b + __ffs(p) - 1 : kTile;
                p &= p - 1u;
              }
              float4 x[4];
#pragma unroll
              for (int u = 0; u < 4; ++u) x[u] = tv[q[u]];
#pragma unroll
              for (int u = 0; u < 4; ++u) {
                s.x += x[u].x;
                s.y += x[u].y;
                s.z += x[u].z;
                s.w += x[u].w;
              }
            }
            acc[r] = s;
          }
        }
        __syncwarp();
      }
      __syncthreads();  // every warp is done with the tile
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nk; i += kThreads) out[lo + i] = acc[i];
}

}  // namespace

extern "C" {

// Bytes of scratch ptina_texel_rows needs for n lanes onto `texels`
// texels (n, texels >= 1).
size_t ptina_texel_rows_scratch(int n, int texels) {
  const Plan p = plan(n, texels);
  return rows_bytes(p) + keys_bytes(p) + offs_bytes(p);
}

// The backward of one texel gather: g [n, 4] f32, contiguous and 16-byte
// aligned; texid, x, y [n] int64 at element strides st, sx, sy; the atlas
// [texels / (h * w), h, w, 4]; scratch of ptina_texel_rows_scratch bytes,
// 256-byte aligned; out [texels, 4] f32, 16-byte aligned, every entry
// written.  Two launches on the stream.  Returns cudaGetLastError() after
// the launches.
int ptina_texel_rows(const float* g, const int64_t* texid, const int64_t* x,
                     const int64_t* y, int64_t st, int64_t sx, int64_t sy,
                     int n, int h, int w, int texels, void* scratch,
                     float* out, void* stream) {
  const Plan p = plan(n, texels);
  char* s = static_cast<char*>(scratch);
  float4* rows = reinterpret_cast<float4*>(s);
  int* keys = reinterpret_cast<int*>(s + rows_bytes(p));
  int* offs = reinterpret_cast<int*>(s + rows_bytes(p) + keys_bytes(p));
  const cudaStream_t cs = static_cast<cudaStream_t>(stream);
  texel_lanes_kernel<<<p.segs, kThreads, 0, cs>>>(
      reinterpret_cast<const float4*>(g), texid, x, y, st, sx, sy, n, h, w,
      texels, p.per, p.buckets, rows, keys, offs);
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  texel_keys_kernel<<<p.buckets * p.parts, kThreads, 0, cs>>>(
      rows, keys, offs, p.segs, p.buckets, p.per, p.keys, p.parts, texels,
      reinterpret_cast<float4*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
