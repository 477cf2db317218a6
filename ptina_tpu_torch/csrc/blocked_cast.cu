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
// tables.  The contract is brute's winners, not the TPU kernels' tiles,
// and the packed key is BLOCK-LOCAL, as in the reference:
//   key = (bits(t) & ~2047) | (fid - 512 * blk), minimum over (key, blk)
//   taken lexicographically, the winner's id blk * 512 + (key & 2047).
// So t sits on the 2^-12 grid at every scene size, and an exact-key tie
// across blocks goes to the lower block id (the reference: to its visit
// order).
//
// The kernels walk the scene's box tree, nodes [2P, 8] (scene.py:
// compute_node_bounds): an implicit complete binary tree in heap layout
// over leaves of 32 consecutive faces, node k with children 2k and 2k + 1,
// leaf l at node P + l and inside block l / 16; rows (lo.xyz, hi.xyz, 0,
// 0), padding leaves and nodes inverted.
//
// What bounds it on this card: the pair tests, 36 FP32 operations per
// (ray, face) pair (ptina::face_hit), over the faces of the leaves whose
// box a ray enters before its hit; the face table (6.5 MB at 101,888
// faces) and the tree (256 KB) live in L2.  With 512-face blocks in index
// order a ray tested ~4,000 faces, most of them sphere faces that shared a
// block with a wall spanning the whole scene, and a warp the union of its
// rays' blocks.
//
// What the design does about it: one thread per ray walks the tree
// depth-first (tree.cuh: walk_tree, in the while-while order) with a
// 17-entry stack (depth <= 16 at MAX_BLOCKS * 16 leaves), the nearer
// child first.  A conservative slab test of each box (the reference's
// relative margins, blocked.py:287-296) gives an entry bound; the
// closest-hit kernel prunes a node whose entry, floored to the key's t
// grid, is strictly beyond the running best (the reference's
// gate, blocked.py:445-451), so the nearest-first order gives the early
// exit that index order could not.  The result is a lexicographic minimum,
// so it does not depend on the visit order.  The occlusion kernel prunes
// entries at or beyond tmax and stops at its first occluder.  No shared
// memory and no barrier: faces and boxes are read through the read-only
// cache.  The file is built with --fmad=false (intersect/blocked.py), so
// the pair tests round as the plain torch version does.
#include <cuda_runtime.h>

#include "plucker.cuh"
#include "tree.cuh"

namespace {

constexpr int kBlock = 128;        // rays per CUDA block
constexpr int kBlockFaces = 512;   // scene.BLOCK_FACES
constexpr int kLeavesPerBlock = kBlockFaces / ptina::kLeafFaces;
constexpr int kLocalMask = 2047;   // plucker.KEY_FID_MASK: the block-local id
constexpr int kStack = 17;         // blocked.MAX_TREE_DEPTH + 1

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
                     const float4* __restrict__ nodes, int n, int f, int p,
                     ptina::HitOut out, int2* __restrict__ visits) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= n) return;
  const ptina::Ray r = ptina::make_ray(ox[i], oy[i], oz[i], dx[i], dy[i],
                                       dz[i]);
  const int av = avoid[i];
  int best = ptina::kKeyMiss;
  int best_blk = -1;

  ptina::walk_tree<kStack, true>(
      r, nodes, p,
      // a box whose every hit is strictly beyond the running best on the
      // key's t grid (KEY_MISS keeps every box in play)
      [&](float entry) {
        return (__float_as_int(entry) & ~kLocalMask) > (best & ~kLocalMask);
      },
      [&](int l) {
        const int base = l * ptina::kLeafFaces;
        const int cnt = min(ptina::kLeafFaces, f - base);
        const int blk = l / kLeavesPerBlock;
        const int local0 = base - blk * kBlockFaces;  // block-local ids
        const float4* c = coef + 4 * base;
        int kl = ptina::kKeyMiss;
        for (int j = 0; j < cnt; ++j) {
          float t;
          const bool valid = ptina::face_hit(r, __ldg(c + 4 * j),
                                             __ldg(c + 4 * j + 1),
                                             __ldg(c + 4 * j + 2),
                                             __ldg(c + 4 * j + 3), &t);
          // base + j != av: the global avoid, i.e. local0 + j against the
          // avoid localised by the block
          if (valid && base + j != av && t < ptina::kInf)
            kl = min(kl, ptina::pack_key(t, local0 + j, kLocalMask));
        }
        // the (key, block) minimum: an equal key keeps the lower block
        if (kl < best || (kl == best && blk < best_blk)) {
          best = kl;
          best_blk = blk;
        }
        return false;
      },
      visits ? visits + i : nullptr);

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
                   const float4* __restrict__ nodes, int n, int f, int p,
                   bool* __restrict__ occ_out, int2* __restrict__ visits) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= n) return;
  const ptina::Ray r = ptina::make_ray(ox[i], oy[i], oz[i], dx[i], dy[i],
                                       dz[i]);
  const int av = avoid[i];
  // t < min(tmax, INF) == (t < INF && t < tmax), also for a NaN tmax; a
  // parked ray (tmax 0) leaves at the root, since entries are >= 0
  const float tm = tmax[i];
  bool occ = false;

  ptina::walk_tree<kStack, true>(
      r, nodes, p, [&](float entry) { return entry >= tm; },
      [&](int l) {
        const int base = l * ptina::kLeafFaces;
        const int cnt = min(ptina::kLeafFaces, f - base);
        const float4* c = coef + 4 * base;
        for (int j = 0; j < cnt; ++j) {
          float t;
          const bool valid = ptina::face_hit(r, __ldg(c + 4 * j),
                                             __ldg(c + 4 * j + 1),
                                             __ldg(c + 4 * j + 2),
                                             __ldg(c + 4 * j + 3), &t);
          if (valid && base + j != av && t < ptina::kInf && t < tm) {
            occ = true;
            return true;
          }
        }
        return false;
      },
      visits ? visits + i : nullptr);
  occ_out[i] = occ;
}

inline int grid_for(int n) { return (n + kBlock - 1) / kBlock; }

}  // namespace

extern "C" {

// Closest hit + attributes over a blocked table.  Rays are six [n] f32 rows;
// coef [f, 16] and nodes [2p, 8] (both 16-byte aligned), attr [f, 18];
// outputs t/u/v [n] f32, idx [n] i32, hit [n] bool, attrs [6, n] f32;
// visits: null, or [n, 2] i32 for the traversal counters.  Returns
// cudaGetLastError() after the launch.
int ptina_blocked_cast_shade(const float* ox, const float* oy,
                             const float* oz, const float* dx,
                             const float* dy, const float* dz,
                             const int* avoid, const float* coef,
                             const float* attr, const float* nodes, int n,
                             int f, int p, float* t, int* idx, bool* hit,
                             float* u, float* v, float* attrs, int* visits,
                             void* stream) {
  blocked_shade_kernel<<<grid_for(n), kBlock, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      ox, oy, oz, dx, dy, dz, avoid, reinterpret_cast<const float4*>(coef),
      attr, reinterpret_cast<const float4*>(nodes), n, f, p,
      ptina::HitOut{t, idx, hit, u, v, attrs},
      reinterpret_cast<int2*>(visits));
  return static_cast<int>(cudaGetLastError());
}

// Occlusion over a blocked table: occ [n] bool is true where a valid hit
// lies at t < min(tmax, INF).
int ptina_blocked_cast_any(const float* ox, const float* oy, const float* oz,
                           const float* dx, const float* dy, const float* dz,
                           const int* avoid, const float* tmax,
                           const float* coef, const float* nodes, int n,
                           int f, int p, bool* occ, int* visits,
                           void* stream) {
  blocked_any_kernel<<<grid_for(n), kBlock, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      ox, oy, oz, dx, dy, dz, avoid, tmax,
      reinterpret_cast<const float4*>(coef),
      reinterpret_cast<const float4*>(nodes), n, f, p, occ,
      reinterpret_cast<int2*>(visits));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
