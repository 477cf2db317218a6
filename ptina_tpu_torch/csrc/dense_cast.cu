// Dense ray casts, Hopper (sm_90a).
//
// Replaces the three Pallas kernels of ptina_tpu/intersect/pallas_cast.py:
//   shade_kernel    <- _shade_kernel (pallas_cast.py:69, pallas_cast_shade):
//                      closest hit + barycentric interpolation of 6 attribute
//                      channels x 3 corners (nrm3, uv2, mtlid); the wavefront
//                      main path's closest cast (dispatch.cast_shaded);
//   any_kernel      <- _any_kernel (pallas_cast.py:62, pallas_cast_any):
//                      occlusion, a valid hit with t < min(tmax, INF); the
//                      wavefront's shadow cast (dispatch.cast_shadow);
//   closest_kernel  <- _closest_kernel (pallas_cast.py:51,
//                      pallas_cast_closest): t, index, u and v only, behind
//                      the table-level intersect.cast_closest;
//   any_flat_kernel <- _any_kernel again, behind the table-level
//                      intersect.cast_any.
// The per-pair math is the hit contract of plucker.cuh; the plain torch
// versions are intersect/dense_cast.py:cast_shade_plain / cast_any_plain /
// cast_closest_plain (cast_any_plain for both occlusion kernels).
//
// What bounds it on this card: the pair tests, 36 FP32 operations per
// (ray, face) pair (ptina::face_hit), against ~60 B of ray I/O per ray.  A
// cast that meets every face (~1000 faces, 2.6e8 pairs at 512^2 rays) is
// pure FP32 issue, and 94-97% of those pairs are waste: a wavefront ray on
// cornell_monkey, envlight or matball needs only the faces of the 32-face
// leaves of the scene's box tree that it enters before its hit, 50-80 of
// them.
//
// What the design does about it.  The scene-level casts (shade_kernel,
// any_kernel) walk the scene's box tree, the one the path megakernel walks
// (scene.py: fused_nodes over the faces in fused_order, whose coefficient
// rows are fused_coef): one thread per ray, 128-ray blocks, depth first,
// nearer child first, with tree.cuh's walk_tree; faces and boxes are read
// through the read-only cache, with no shared memory and no barrier, so a
// thread leaves as soon as its own walk ends (a copy of the whole tree in
// shared memory, and of the whole face table in 512-ray blocks, measured
// slower: PERF.md).  The closest cast prunes a node whose entry, floored to
// the key's t grid (& ~fid_mask), is strictly beyond the running best, and
// keys each pair by the face's original id (fused_order[slot]), so the
// result is the packed-key minimum over every face whatever the visit
// order, ties to the lowest id; the winner's coefficient and attribute
// rows are read once, by original id, from the scene's own face_coef /
// face_attr.  The occlusion cast prunes entries at or beyond tmax and stops
// at its first occluder.  `avoid` is an original face id, as the wavefront
// passes it (the last hit's index), and is held against the original id of
// each face under test.  A table of one or two leaves (the cornell scenes,
// 40 padded faces) takes the instantiation without box tests (kBoxes
// false), which would cost more than they cull: a flat loop over a
// shared-memory copy of its faces in 256-ray blocks, as the flat kernels
// below, comparing tree slots with the avoided face's slot.
//
// The table-level casts (closest_kernel, any_flat_kernel) get a bare face
// table per call and no tree: one thread per ray, 256-ray blocks, the face
// table staged through shared memory in chunks of 256 faces (16 KB), each
// face four broadcast LDS.128 per warp; a running packed-key minimum in a
// register; any_flat_kernel leaves the face loop once every ray of its
// block is occluded (or out of range).  The ragged ray edge is masked
// in-kernel; N is never padded.  No MXU-style chunk matmul, lane tiles or
// one-hot extraction survive from the TPU kernels.  The file is built with
// --fmad=false (intersect/dense_cast.py): products and sums round exactly
// as in the plain torch version, which makes the two agree bit for bit at
// the price of separate multiply and add instructions.
#include <cuda_runtime.h>

#include "plucker.cuh"
#include "tree.cuh"

namespace {

constexpr int kBlock = 256;      // rays per block of the flat kernels
// rays per block of the tree kernels: 128 on a tree with boxes; a table
// of at most two leaves is a flat loop, with the flat kernels' blocks
template <bool kBoxes>
constexpr int kTreeBlock = kBoxes ? 128 : kBlock;
constexpr int kChunk = 256;      // faces per shared-memory chunk
// the most faces of a tree of at most two leaves (kBoxes false)
constexpr int kSmallFaces = 2 * ptina::kLeafFaces;

// The scene's box tree (scene.py: fused_coef, fused_nodes, fused_order)
// over f faces in p leaf slots.
struct Tree {
  const float4* coef;   // [f, 16] face_coef rows in tree slot order
  const float4* nodes;  // [2p, 8] (tree.cuh)
  const int* order;     // [f] the original face id of each tree slot
  int f, p;
  const int* slot;      // [f] the tree slot of each face id: a block's
                        // shared copy of a small table only (else null)
};

// A tree of at most two leaves (kBoxes false) is tested face by face with
// no box test, from a shared-memory copy of its <= 64 faces, their ids and
// the inverse permutation that the block makes once: every thread of a
// warp reads the same face at the same step, which shared memory
// broadcasts, and a ray's avoided id becomes a slot once, so the loop
// compares slots.  Returns the table the kernel reads: the copy, or the
// tree itself.
template <bool kBoxes>
__device__ __forceinline__ Tree block_table(const Tree& tree) {
  if constexpr (kBoxes) {
    return tree;
  } else {
    __shared__ float4 sc[4 * kSmallFaces];
    __shared__ int so[kSmallFaces];
    __shared__ int ss[kSmallFaces];
    for (int k = threadIdx.x; k < 4 * tree.f; k += kBlock)
      sc[k] = __ldg(tree.coef + k);
    for (int k = threadIdx.x; k < tree.f; k += kBlock) {
      const int id = __ldg(tree.order + k);  // fused_order is a permutation
      so[k] = id;
      ss[id] = k;
    }
    __syncthreads();
    return Tree{sc, tree.nodes, so, tree.f, tree.p, ss};
  }
}

// The tree slot of face id av in a small table's copy, -1 for none.
__device__ __forceinline__ int slot_of(const Tree& tb, int av) {
  return av >= 0 && av < tb.f ? tb.slot[av] : -1;
}

template <bool kBoxes>
__global__ void __launch_bounds__(kTreeBlock<kBoxes>)
shade_kernel(const float* __restrict__ ox, const float* __restrict__ oy,
             const float* __restrict__ oz, const float* __restrict__ dx,
             const float* __restrict__ dy, const float* __restrict__ dz,
             const int* __restrict__ avoid, const float* __restrict__ coef,
             const float* __restrict__ attr, const Tree tree, int n,
             int fid_mask, ptina::HitOut out, int2* __restrict__ visits) {
  const Tree tb = block_table<kBoxes>(tree);
  const int i = blockIdx.x * kTreeBlock<kBoxes> + threadIdx.x;
  if (i >= n) return;
  const ptina::Ray r = ptina::make_ray(ox[i], oy[i], oz[i], dx[i], dy[i],
                                       dz[i]);
  const int av = avoid[i];
  int best = ptina::kKeyMiss;

  if constexpr (!kBoxes) {
    // a table of <= 64 faces: every face, in slot order
    const int sav = slot_of(tb, av);
#pragma unroll 4
    for (int j = 0; j < tb.f; ++j) {
      float t;
      const bool valid = ptina::face_hit(r, tb.coef[4 * j],
                                         tb.coef[4 * j + 1],
                                         tb.coef[4 * j + 2],
                                         tb.coef[4 * j + 3], &t);
      if (valid && j != sav && t < ptina::kInf)
        best = min(best, ptina::pack_key(t, tb.order[j], fid_mask));
    }
    if (visits) visits[i] = make_int2(0, tb.p);
  } else {
    ptina::walk_tree<ptina::kDenseStack, true>(
        r, tb.nodes, tb.p,
        // a box whose every hit is strictly beyond the running best on
        // the key's t grid (KEY_MISS keeps every box in play)
        [&](float entry) {
          return (__float_as_int(entry) & ~fid_mask) > (best & ~fid_mask);
        },
        [&](int l) {
          const int base = l * ptina::kLeafFaces;
          const int cnt = min(ptina::kLeafFaces, tb.f - base);
          const float4* c = tb.coef + 4 * base;
#pragma unroll 4
          for (int j = 0; j < cnt; ++j) {
            float t;
            const bool valid = ptina::face_hit(r, __ldg(c + 4 * j),
                                               __ldg(c + 4 * j + 1),
                                               __ldg(c + 4 * j + 2),
                                               __ldg(c + 4 * j + 3), &t);
            if (valid && t < ptina::kInf) {
              const int fid = __ldg(tb.order + base + j);
              if (fid != av)
                best = min(best, ptina::pack_key(t, fid, fid_mask));
            }
          }
          return false;
        },
        visits ? visits + i : nullptr);
  }

  if (best == ptina::kKeyMiss) {
    ptina::store_miss<true>(out, i, n);
    return;
  }
  ptina::store_hit<true>(out, r, coef, attr, best & fid_mask,
                         ptina::key_decode_t(best, fid_mask), i, n);
}

template <bool kBoxes>
__global__ void __launch_bounds__(kTreeBlock<kBoxes>)
any_kernel(const float* __restrict__ ox, const float* __restrict__ oy,
           const float* __restrict__ oz, const float* __restrict__ dx,
           const float* __restrict__ dy, const float* __restrict__ dz,
           const int* __restrict__ avoid, const float* __restrict__ tmax,
           const Tree tree, int n, bool* __restrict__ occ_out,
           int2* __restrict__ visits) {
  const Tree tb = block_table<kBoxes>(tree);
  const int i = blockIdx.x * kTreeBlock<kBoxes> + threadIdx.x;
  if (i >= n) return;
  const ptina::Ray r = ptina::make_ray(ox[i], oy[i], oz[i], dx[i], dy[i],
                                       dz[i]);
  const int av = avoid[i];
  // t < min(tmax, INF) == (t < INF && t < tmax), also for a NaN tmax; a
  // parked ray (tmax 0) leaves at the root, since entries are >= 0
  const float tm = tmax[i];
  bool occ = false;

  if constexpr (!kBoxes) {
    // a table of <= 64 faces: every face, with no exit, which a warp
    // whose rays leave at different faces cannot use anyway
    const int sav = slot_of(tb, av);
#pragma unroll 4
    for (int j = 0; j < tb.f; ++j) {
      float t;
      const bool valid = ptina::face_hit(r, tb.coef[4 * j],
                                         tb.coef[4 * j + 1],
                                         tb.coef[4 * j + 2],
                                         tb.coef[4 * j + 3], &t);
      occ |= valid && j != sav && t < ptina::kInf && t < tm;
    }
    if (visits) visits[i] = make_int2(0, tb.p);
  } else {
    ptina::walk_tree<ptina::kDenseStack, true>(
        r, tb.nodes, tb.p, [&](float entry) { return entry >= tm; },
        [&](int l) {
          const int base = l * ptina::kLeafFaces;
          const int cnt = min(ptina::kLeafFaces, tb.f - base);
          const float4* c = tb.coef + 4 * base;
#pragma unroll 4
          for (int j = 0; j < cnt; ++j) {
            float t;
            const bool valid = ptina::face_hit(r, __ldg(c + 4 * j),
                                               __ldg(c + 4 * j + 1),
                                               __ldg(c + 4 * j + 2),
                                               __ldg(c + 4 * j + 3), &t);
            if (valid && t < ptina::kInf && t < tm &&
                __ldg(tb.order + base + j) != av) {
              occ = true;
              return true;
            }
          }
          return false;
        },
        visits ? visits + i : nullptr);
  }
  occ_out[i] = occ;
}

// Cooperative copy of faces [base, base + cnt) into shared memory.
__device__ __forceinline__ void stage_faces(float4* sc, const float4* coef,
                                            int base, int cnt) {
  for (int k = threadIdx.x; k < cnt * 4; k += kBlock)
    sc[k] = coef[base * 4 + k];
}

__global__ void __launch_bounds__(kBlock)
closest_kernel(const float* __restrict__ ox, const float* __restrict__ oy,
               const float* __restrict__ oz, const float* __restrict__ dx,
               const float* __restrict__ dy, const float* __restrict__ dz,
               const int* __restrict__ avoid, const float4* __restrict__ coef,
               int n, int f, int fid_mask, ptina::HitOut out) {
  __shared__ float4 sc[kChunk * 4];
  const int i = blockIdx.x * kBlock + threadIdx.x;
  const bool live = i < n;
  ptina::Ray r = live ? ptina::make_ray(ox[i], oy[i], oz[i], dx[i], dy[i],
                                        dz[i])
                      : ptina::make_ray(0.f, 0.f, 0.f, 0.f, 0.f, 1.f);
  const int av = live ? avoid[i] : -1;
  int best = ptina::kKeyMiss;

  for (int base = 0; base < f; base += kChunk) {
    const int cnt = min(kChunk, f - base);
    stage_faces(sc, coef, base, cnt);
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < cnt; ++j) {
      float t;
      bool valid = ptina::face_hit(r, sc[4 * j], sc[4 * j + 1], sc[4 * j + 2],
                                   sc[4 * j + 3], &t);
      const int fid = base + j;
      if (valid && fid != av && t < ptina::kInf)
        best = min(best, ptina::pack_key(t, fid, fid_mask));
    }
    __syncthreads();  // before the next chunk overwrites sc
  }
  if (!live) return;
  if (best == ptina::kKeyMiss) {
    ptina::store_miss<false>(out, i, n);
    return;
  }
  ptina::store_hit<false>(out, r, reinterpret_cast<const float*>(coef),
                          nullptr, best & fid_mask,
                          ptina::key_decode_t(best, fid_mask), i, n);
}

__global__ void __launch_bounds__(kBlock)
any_flat_kernel(const float* __restrict__ ox, const float* __restrict__ oy,
                const float* __restrict__ oz, const float* __restrict__ dx,
                const float* __restrict__ dy, const float* __restrict__ dz,
                const int* __restrict__ avoid,
                const float* __restrict__ tmax,
                const float4* __restrict__ coef, int n, int f,
                bool* __restrict__ occ_out) {
  __shared__ float4 sc[kChunk * 4];
  const int i = blockIdx.x * kBlock + threadIdx.x;
  const bool live = i < n;
  ptina::Ray r = live ? ptina::make_ray(ox[i], oy[i], oz[i], dx[i], dy[i],
                                        dz[i])
                      : ptina::make_ray(0.f, 0.f, 0.f, 0.f, 0.f, 1.f);
  const int av = live ? avoid[i] : -1;
  // as any_kernel: t < min(tmax, INF); a parked ray never occludes
  const float tm = live ? tmax[i] : 0.f;
  bool occ = false;

  for (int base = 0; base < f; base += kChunk) {
    const int cnt = min(kChunk, f - base);
    stage_faces(sc, coef, base, cnt);
    __syncthreads();
    if (live && !occ) {
#pragma unroll 4
      for (int j = 0; j < cnt; ++j) {
        float t;
        bool valid = ptina::face_hit(r, sc[4 * j], sc[4 * j + 1],
                                     sc[4 * j + 2], sc[4 * j + 3], &t);
        occ |= valid && (base + j) != av && t < ptina::kInf && t < tm;
      }
    }
    // doubles as the barrier before the next chunk overwrites sc
    if (__syncthreads_and(occ || !live)) break;
  }
  if (live) occ_out[i] = occ;
}

inline int grid_for(int n, int block) { return (n + block - 1) / block; }

}  // namespace

extern "C" {

// Closest hit + attributes over the scene's box tree.  Rays are six [n]
// f32 rows, avoid [n] i32 an original face id (-1 none); coef [f, 16]
// (the scene's face_coef, by original id) and attr [f, 18]; tree_coef
// [f, 16], nodes [2p, 8] (16-byte aligned, as coef) and order [f] i32 the
// tree (scene.py); outputs t/u/v [n] f32, idx [n] i32, hit [n] bool,
// attrs [6, n] f32; visits: null, or [n, 2] i32 for the walk's counters.
// Returns cudaGetLastError() after the launch.
int ptina_cast_shade(const float* ox, const float* oy, const float* oz,
                     const float* dx, const float* dy, const float* dz,
                     const int* avoid, const float* coef, const float* attr,
                     const float* tree_coef, const float* nodes,
                     const int* order, int n, int f, int p, int fid_mask,
                     float* t, int* idx, bool* hit, float* u, float* v,
                     float* attrs, int* visits, void* stream) {
  const Tree tree{reinterpret_cast<const float4*>(tree_coef),
                  reinterpret_cast<const float4*>(nodes), order, f, p,
                  nullptr};
  const ptina::HitOut out{t, idx, hit, u, v, attrs};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int2* vis = reinterpret_cast<int2*>(visits);
  if (p > 2)
    shade_kernel<true><<<grid_for(n, kTreeBlock<true>), kTreeBlock<true>, 0,
                         s>>>(
        ox, oy, oz, dx, dy, dz, avoid, coef, attr, tree, n, fid_mask, out,
        vis);
  else
    shade_kernel<false><<<grid_for(n, kTreeBlock<false>), kTreeBlock<false>,
                          0, s>>>(
        ox, oy, oz, dx, dy, dz, avoid, coef, attr, tree, n, fid_mask, out,
        vis);
  return static_cast<int>(cudaGetLastError());
}

// Occlusion over the scene's box tree: occ [n] bool is true where a valid
// hit on a face other than avoid (an original id) lies at t < min(tmax,
// INF).  The tree tables and visits as for ptina_cast_shade.
int ptina_cast_any(const float* ox, const float* oy, const float* oz,
                   const float* dx, const float* dy, const float* dz,
                   const int* avoid, const float* tmax,
                   const float* tree_coef, const float* nodes,
                   const int* order, int n, int f, int p, bool* occ,
                   int* visits, void* stream) {
  const Tree tree{reinterpret_cast<const float4*>(tree_coef),
                  reinterpret_cast<const float4*>(nodes), order, f, p,
                  nullptr};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int2* vis = reinterpret_cast<int2*>(visits);
  if (p > 2)
    any_kernel<true><<<grid_for(n, kTreeBlock<true>), kTreeBlock<true>, 0,
                       s>>>(
        ox, oy, oz, dx, dy, dz, avoid, tmax, tree, n, occ, vis);
  else
    any_kernel<false><<<grid_for(n, kTreeBlock<false>), kTreeBlock<false>,
                        0, s>>>(
        ox, oy, oz, dx, dy, dz, avoid, tmax, tree, n, occ, vis);
  return static_cast<int>(cudaGetLastError());
}

// Closest hit without attributes over a bare face table coef [f, 16]
// (16-byte aligned): the outputs of ptina_cast_shade but attrs.
int ptina_cast_closest(const float* ox, const float* oy, const float* oz,
                       const float* dx, const float* dy, const float* dz,
                       const int* avoid, const float* coef, int n, int f,
                       int fid_mask, float* t, int* idx, bool* hit, float* u,
                       float* v, void* stream) {
  closest_kernel<<<grid_for(n, kBlock), kBlock, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      ox, oy, oz, dx, dy, dz, avoid, reinterpret_cast<const float4*>(coef), n,
      f, fid_mask, ptina::HitOut{t, idx, hit, u, v, nullptr});
  return static_cast<int>(cudaGetLastError());
}

// Occlusion over a bare face table coef [f, 16]: occ [n] bool as
// ptina_cast_any's.
int ptina_cast_any_flat(const float* ox, const float* oy, const float* oz,
                        const float* dx, const float* dy, const float* dz,
                        const int* avoid, const float* tmax,
                        const float* coef, int n, int f, bool* occ,
                        void* stream) {
  any_flat_kernel<<<grid_for(n, kBlock), kBlock, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      ox, oy, oz, dx, dy, dz, avoid, tmax,
      reinterpret_cast<const float4*>(coef), n, f, occ);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
