// Blocked two-level ray casts for big scenes, Hopper (sm_90a).
//
// Replaces the two Pallas kernels of ptina_tpu/intersect/blocked.py that the
// wavefront path launches on scenes of the blocked route (more than 8192
// faces, or accel='blocked'):
//   blocked_shade_kernel <- _blocked_shade_kernel (blocked.py:388,
//                           blocked_cast_shade): closest hit + barycentric
//                           interpolation of the winner's 18 corner
//                           attributes;
//   blocked_any_kernel   <- _blocked_mint_kernel (blocked.py:462,
//                           blocked_cast_any): occlusion, a valid hit with
//                           t < min(tmax, INF).
// The plain torch versions are intersect/blocked.py:blocked_cast_shade_plain
// and blocked_cast_any_plain.
//
// The scene's faces are Morton-ordered (scene.py) and block b is rows
// b * 512 ... b * 512 + 511 of the face_coef [F, 16] / face_attr [F, 18]
// tables, with its box in block_bounds [nb, 8] (lo.xyz, hi.xyz, 0, 0;
// padding blocks inverted).  The contract is brute's winners, not the TPU
// kernels' tiles, and the packed key is BLOCK-LOCAL, as in the reference:
//   key = (bits(t) & ~2047) | (fid - 512 * blk), minimum over (key, blk)
//   taken lexicographically, the winner's id blk * 512 + (key & 2047).
// So t sits on the 2^-12 grid at every scene size, and an exact-key tie
// across blocks goes to the lower block id (the reference: to its visit
// order).
//
// What bounds it on this card: the pair tests, ~25 FP32 ops per (ray,
// face) pair as in dense_cast.cu, times the blocks a ray cannot cull; on
// the 101,888-face scene each ray meets 199 boxes and enters a few of
// them.  The face table (6.5 MB) lives in L2.
//
// What the design does about it: one thread per ray and no ray sort, tiles,
// candidate table or DMA ring.  Each thread walks the blocks in index
// order; a conservative slab test of its ray against the block's box (with
// the reference's relative margins, blocked.py:287-296) gives an entry
// bound, and the block's 512 faces are tested only when the box is ahead
// of the ray and its entry, floored to the key's t grid, is not beyond the
// ray's running best (the reference's gate, blocked.py:445-451).  The
// threads of a warp walk the blocks in step, so a block one of them enters
// is read by all as broadcast loads through L1.  The occlusion kernel skips
// blocks whose entry is at or beyond tmax and stops at its first hit.  The
// file is built with --fmad=false (intersect/blocked.py), so the pair
// tests round as the plain torch version does.
#include <cuda_runtime.h>

#include "plucker.cuh"

namespace {

constexpr int kBlock = 128;        // rays per CUDA block
constexpr int kBlockFaces = 512;   // scene.BLOCK_FACES
constexpr int kLocalMask = 2047;   // plucker.KEY_FID_MASK: the block-local id

// Conservative slab test of the ray against one box bb = (lo.xyz, hi.xyz):
// false when no point of the box lies ahead of the origin; else *entry is a
// lower bound on the t of any hit inside the box.  The bounds carry the
// reference's relative margins, so rounding cannot drop a hit whose t sits
// on a box face (the cornell walls lie on their blocks' planes).  A zero
// direction component is decided by the origin alone, so no 0 * inf NaN
// arises (a parked ray points along +z from the origin).
__device__ __forceinline__ bool box_entry(const ptina::Ray& r,
                                          const float* __restrict__ bb,
                                          float* entry) {
  const float o[3] = {r.ox, r.oy, r.oz};
  const float d[3] = {r.dx, r.dy, r.dz};
  float near = -INFINITY, far = INFINITY;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float lo = __ldg(bb + a), hi = __ldg(bb + 3 + a);
    if (!(lo <= hi)) return false;  // a padding block's inverted box
    if (d[a] == 0.f) {
      if (o[a] < lo || o[a] > hi) return false;
      continue;
    }
    const float t1 = (lo - o[a]) / d[a];
    const float t2 = (hi - o[a]) / d[a];
    near = fmaxf(near, fminf(t1, t2));
    far = fminf(far, fmaxf(t1, t2));
  }
  near = near * (1.0f - 1e-6f);
  far = far * (1.0f + 1e-6f);
  if (!(far > 0.f && near <= far && isfinite(near))) return false;
  *entry = fmaxf(near, 0.f);
  return true;
}

__global__ void __launch_bounds__(kBlock)
blocked_shade_kernel(const float* __restrict__ ox,
                     const float* __restrict__ oy,
                     const float* __restrict__ oz,
                     const float* __restrict__ dx,
                     const float* __restrict__ dy,
                     const float* __restrict__ dz,
                     const int* __restrict__ avoid,
                     const float4* __restrict__ coef,
                     const float* __restrict__ attr,
                     const float* __restrict__ bounds, int n, int f, int nb,
                     ptina::HitOut out) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= n) return;
  const ptina::Ray r = ptina::make_ray(ox[i], oy[i], oz[i], dx[i], dy[i],
                                       dz[i]);
  const int av = avoid[i];
  int best = ptina::kKeyMiss;
  int best_blk = -1;

  for (int b = 0; b < nb; ++b) {
    float entry;
    if (!box_entry(r, bounds + 8 * b, &entry)) continue;
    // skip a block whose every hit is strictly beyond the running best on
    // the key's t grid (KEY_MISS keeps every block in play)
    if ((__float_as_int(entry) & ~kLocalMask) > (best & ~kLocalMask))
      continue;
    const int base = b * kBlockFaces;
    const int cnt = min(kBlockFaces, f - base);
    const int local_av = av - base;  // the global avoid, block-local
    const float4* c = coef + 4 * base;
    int kb = ptina::kKeyMiss;
    for (int j = 0; j < cnt; ++j) {
      float t;
      const bool valid = ptina::face_hit(r, __ldg(c + 4 * j),
                                         __ldg(c + 4 * j + 1),
                                         __ldg(c + 4 * j + 2),
                                         __ldg(c + 4 * j + 3), &t);
      if (valid && j != local_av && t < ptina::kInf)
        kb = min(kb, ptina::pack_key(t, j, kLocalMask));
    }
    if (kb < best) {  // strict: an equal key keeps the lower block
      best = kb;
      best_blk = b;
    }
  }
  if (best == ptina::kKeyMiss) {
    ptina::store_miss<true>(out, i, n);
    return;
  }
  ptina::store_hit<true>(out, r, reinterpret_cast<const float*>(coef), attr,
                         best_blk * kBlockFaces + (best & kLocalMask),
                         ptina::key_decode_t(best, kLocalMask), i, n);
}

__global__ void __launch_bounds__(kBlock)
blocked_any_kernel(const float* __restrict__ ox, const float* __restrict__ oy,
                   const float* __restrict__ oz, const float* __restrict__ dx,
                   const float* __restrict__ dy, const float* __restrict__ dz,
                   const int* __restrict__ avoid,
                   const float* __restrict__ tmax,
                   const float4* __restrict__ coef,
                   const float* __restrict__ bounds, int n, int f, int nb,
                   bool* __restrict__ occ_out) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= n) return;
  const ptina::Ray r = ptina::make_ray(ox[i], oy[i], oz[i], dx[i], dy[i],
                                       dz[i]);
  const int av = avoid[i];
  // t < min(tmax, INF) == (t < INF && t < tmax), also for a NaN tmax; a
  // parked ray (tmax 0) skips every block, since entries are >= 0
  const float tm = tmax[i];
  bool occ = false;

  for (int b = 0; b < nb && !occ; ++b) {
    float entry;
    if (!box_entry(r, bounds + 8 * b, &entry) || entry >= tm) continue;
    const int base = b * kBlockFaces;
    const int cnt = min(kBlockFaces, f - base);
    const int local_av = av - base;
    const float4* c = coef + 4 * base;
    for (int j = 0; j < cnt && !occ; ++j) {
      float t;
      const bool valid = ptina::face_hit(r, __ldg(c + 4 * j),
                                         __ldg(c + 4 * j + 1),
                                         __ldg(c + 4 * j + 2),
                                         __ldg(c + 4 * j + 3), &t);
      occ = valid && j != local_av && t < ptina::kInf && t < tm;
    }
  }
  occ_out[i] = occ;
}

inline int grid_for(int n) { return (n + kBlock - 1) / kBlock; }

}  // namespace

extern "C" {

// Closest hit + attributes over a blocked table.  Rays are six [n] f32 rows;
// coef [f, 16] (16-byte aligned), attr [f, 18], bounds [nb, 8] with
// nb = ceil(f / 512); outputs t/u/v [n] f32, idx [n] i32, hit [n] bool,
// attrs [6, n] f32.  Returns cudaGetLastError() after the launch.
int ptina_blocked_cast_shade(const float* ox, const float* oy,
                             const float* oz, const float* dx,
                             const float* dy, const float* dz,
                             const int* avoid, const float* coef,
                             const float* attr, const float* bounds, int n,
                             int f, int nb, float* t, int* idx, bool* hit,
                             float* u, float* v, float* attrs,
                             void* stream) {
  blocked_shade_kernel<<<grid_for(n), kBlock, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      ox, oy, oz, dx, dy, dz, avoid, reinterpret_cast<const float4*>(coef),
      attr, bounds, n, f, nb, ptina::HitOut{t, idx, hit, u, v, attrs});
  return static_cast<int>(cudaGetLastError());
}

// Occlusion over a blocked table: occ [n] bool is true where a valid hit
// lies at t < min(tmax, INF).
int ptina_blocked_cast_any(const float* ox, const float* oy, const float* oz,
                           const float* dx, const float* dy, const float* dz,
                           const int* avoid, const float* tmax,
                           const float* coef, const float* bounds, int n,
                           int f, int nb, bool* occ, void* stream) {
  blocked_any_kernel<<<grid_for(n), kBlock, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      ox, oy, oz, dx, dy, dz, avoid, tmax,
      reinterpret_cast<const float4*>(coef), bounds, n, f, nb, occ);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
