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
// table per call and no tree, so they test every face: building a tree per
// call would cost more than the cast.  What bounds them is FP32 issue.
// Every pair needs the sign test's 29 FP32 operations (plucker.cuh:
// face_side); only a pair that passes it needs face_t's 7 more (An and
// An * B > 0).  Under --fmad=false (below) each operation is one
// instruction, at the card's 33.5e12 FP32 instructions a second.  A plain
// flat loop of one ray a thread spends all 36 on every pair and ~16
// further issue slots: four LDS.128 of the face, the sign-test logic, the
// face id, the avoid compare, the key, the loop, a divergent reciprocal,
// and a copy of each chunk of faces by all threads between two barriers.
// What the design does about it.  Each thread holds kRays = 2 rays, so a
// face's loads, branch and loop step serve two pairs.  The sign words of
// both rays fold with a few LOP3 into one branch a face: a thread takes
// it, with An, the An * B > 0 test, the reciprocal, the face id, avoid,
// the far clip and the key (face_t), only for a face one of its rays
// passes the sign test on.  The face table streams through a two-buffer
// ring in shared memory: thread 0 issues each 128-face chunk as one bulk
// asynchronous copy (cp.async.bulk) that completes on the buffer's
// mbarrier a chunk ahead, so the next chunk lands while the block tests
// this one, and one block barrier a chunk releases a buffer.  A block
// holds 256 rays; any_flat_kernel's threads stop testing once their rays
// are all occluded (or out of range), and the block leaves at the first
// chunk barrier where all of them are (__syncthreads_and, every 128
// faces), after the copies still in flight have landed.  Where most faces
// pass a ray's sign test (large overlapping faces) the branch is taken on
// most faces and costs more than it saves; on a table of one chunk the
// ring's set-up is not hidden (PERF.md).  The ragged ray edge is masked
// in-kernel; N is never padded.  No MXU-style chunk matmul, lane tiles or
// one-hot extraction survive from the TPU kernels.  The file is built with
// --fmad=false (intersect/dense_cast.py): products and sums round exactly
// as in the plain torch version, which makes the two agree bit for bit at
// the price of separate multiply and add instructions.
#include <cuda_runtime.h>

#include "plucker.cuh"
#include "tree.cuh"

namespace {

// rays per block of the tree kernels: 128 on a tree with boxes; a table
// of at most two leaves is a flat loop over a shared copy, in blocks of
// kBlock
constexpr int kBlock = 256;
template <bool kBoxes>
constexpr int kTreeBlock = kBoxes ? 128 : kBlock;
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

// ---- the table-level casts: a flat loop over a face ring (the note at
// the head of the file) ------------------------------------------------
constexpr int kFlatRays = 256;   // rays per block
constexpr int kRays = 2;         // rays per thread
constexpr int kFlatThreads = kFlatRays / kRays;
constexpr int kChunk = 128;      // faces per ring buffer (8 KB)
constexpr int kStages = 2;

// The ring: the buffers, one mbarrier per buffer, the table.
struct Ring {
  float4* buf;                  // [kStages][4 * kChunk]
  unsigned long long* full;     // [kStages]
  const float4* coef;           // [f, 16] in device memory
  int f, chunks;
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Thread 0: chunk c into its buffer, completing on its mbarrier.
__device__ __forceinline__ void ring_issue(const Ring& rg, int c) {
  const int s = c % kStages;
  const int cnt = min(kChunk, rg.f - c * kChunk);
  const unsigned bytes = cnt * 4 * sizeof(float4);
  const unsigned bar = smem_addr(rg.full + s);
  // the block's reads of this buffer (generic proxy) come before the
  // copy's writes (async proxy)
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(rg.buf + s * 4 * kChunk)),
         "l"(rg.coef + static_cast<size_t>(c) * 4 * kChunk), "r"(bytes),
         "r"(bar)
      : "memory");
}

// Chunk c's buffer, once its copy has landed.
__device__ __forceinline__ const float4* ring_wait(const Ring& rg, int c) {
  const int s = c % kStages;
  const unsigned parity = (c / kStages) & 1;
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" :: "r"(smem_addr(rg.full + s)), "r"(parity) : "memory");
  return rg.buf + s * 4 * kChunk;
}

// Thread 0 makes the mbarriers and issues the first kStages chunks; the
// block's barrier then publishes the mbarriers.
__device__ __forceinline__ void ring_start(const Ring& rg) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                   :: "r"(smem_addr(rg.full + s)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int c = 0; c < min(kStages, rg.chunks); ++c) ring_issue(rg, c);
  }
  __syncthreads();
}

// After the block's barrier that follows chunk c: thread 0 refills its
// buffer with chunk c + kStages.
__device__ __forceinline__ void ring_next(const Ring& rg, int c) {
  if (threadIdx.x == 0 && c + kStages < rg.chunks)
    ring_issue(rg, c + kStages);
}

// Before a block leaves after chunk c (the any cast's vote): thread 0
// waits out the copies still landing in the block's shared memory.
__device__ __forceinline__ void ring_drain(const Ring& rg, int c) {
  if (threadIdx.x == 0)
    for (int k = c + 1; k < min(c + kStages, rg.chunks); ++k) ring_wait(rg, k);
}

// This thread's kRays rays: ray k is blockIdx.x * kFlatRays + k *
// kFlatThreads + threadIdx.x, so each load and store of a ray row
// coalesces.  A ray past n is live false and, for the any cast, occluded
// from the start.
struct FlatRays {
  ptina::Ray r[kRays];
  int av[kRays];
  bool live[kRays];

  __device__ __forceinline__ int index(int k) const {
    return blockIdx.x * kFlatRays + k * kFlatThreads + threadIdx.x;
  }

  __device__ __forceinline__ FlatRays(const float* ox, const float* oy,
                                      const float* oz, const float* dx,
                                      const float* dy, const float* dz,
                                      const int* avoid, int n) {
#pragma unroll
    for (int k = 0; k < kRays; ++k) {
      const int i = index(k);
      live[k] = i < n;
      r[k] = live[k] ? ptina::make_ray(ox[i], oy[i], oz[i], dx[i], dy[i],
                                       dz[i])
                     : ptina::make_ray(0.f, 0.f, 0.f, 0.f, 0.f, 1.f);
      av[k] = live[k] ? avoid[i] : -1;
    }
  }
};

// Every face of one chunk (base, cnt faces at sc) against a thread's rays:
// hit(k, fid, t) for each valid pair of ray k with t < kInf.
template <typename Hit>
__device__ __forceinline__ void test_chunk(const FlatRays& fr,
                                           const float4* sc, int base,
                                           int cnt, Hit hit) {
#pragma unroll 4
  for (int j = 0; j < cnt; ++j) {
    const float4 c0 = sc[4 * j], c1 = sc[4 * j + 1], c2 = sc[4 * j + 2],
                 c3 = sc[4 * j + 3];
    float b[kRays];
    int side[kRays];
    int all = -1;  // its sign bit stays set while every ray fails
#pragma unroll
    for (int k = 0; k < kRays; ++k) {
      side[k] = ptina::face_side(fr.r[k], c0, c1, c2, c3, &b[k]);
      all &= side[k];
    }
    if (all >= 0) {
      const int fid = base + j;
#pragma unroll
      for (int k = 0; k < kRays; ++k) {
        float t;
        if (side[k] >= 0 && ptina::face_t(fr.r[k], c3, b[k], &t) &&
            fid != fr.av[k] && t < ptina::kInf)
          hit(k, fid, t);
      }
    }
  }
}

__global__ void __launch_bounds__(kFlatThreads)
closest_kernel(const float* __restrict__ ox, const float* __restrict__ oy,
               const float* __restrict__ oz, const float* __restrict__ dx,
               const float* __restrict__ dy, const float* __restrict__ dz,
               const int* __restrict__ avoid, const float4* __restrict__ coef,
               int n, int f, int fid_mask, ptina::HitOut out) {
  __shared__ __align__(128) float4 buf[kStages * 4 * kChunk];
  __shared__ __align__(8) unsigned long long full[kStages];
  const Ring rg{buf, full, coef, f, (f + kChunk - 1) / kChunk};
  ring_start(rg);
  const FlatRays fr(ox, oy, oz, dx, dy, dz, avoid, n);
  int best[kRays];
#pragma unroll
  for (int k = 0; k < kRays; ++k) best[k] = ptina::kKeyMiss;

  for (int c = 0; c < rg.chunks; ++c) {
    const int base = c * kChunk;
    test_chunk(fr, ring_wait(rg, c), base, min(kChunk, f - base),
               [&](int k, int fid, float t) {
                 best[k] = min(best[k], ptina::pack_key(t, fid, fid_mask));
               });
    if (c + kStages < rg.chunks) {
      __syncthreads();  // every thread is done with chunk c's buffer
      ring_next(rg, c);
    }
  }
#pragma unroll
  for (int k = 0; k < kRays; ++k) {
    if (!fr.live[k]) continue;
    const int i = fr.index(k);
    if (best[k] == ptina::kKeyMiss)
      ptina::store_miss<false>(out, i, n);
    else
      ptina::store_hit<false>(out, fr.r[k],
                              reinterpret_cast<const float*>(coef), nullptr,
                              best[k] & fid_mask,
                              ptina::key_decode_t(best[k], fid_mask), i, n);
  }
}

__global__ void __launch_bounds__(kFlatThreads)
any_flat_kernel(const float* __restrict__ ox, const float* __restrict__ oy,
                const float* __restrict__ oz, const float* __restrict__ dx,
                const float* __restrict__ dy, const float* __restrict__ dz,
                const int* __restrict__ avoid,
                const float* __restrict__ tmax,
                const float4* __restrict__ coef, int n, int f,
                bool* __restrict__ occ_out) {
  __shared__ __align__(128) float4 buf[kStages * 4 * kChunk];
  __shared__ __align__(8) unsigned long long full[kStages];
  const Ring rg{buf, full, coef, f, (f + kChunk - 1) / kChunk};
  ring_start(rg);
  const FlatRays fr(ox, oy, oz, dx, dy, dz, avoid, n);
  // as any_kernel: t < min(tmax, INF); a parked ray never occludes
  float tm[kRays];
  bool occ[kRays];
#pragma unroll
  for (int k = 0; k < kRays; ++k) {
    tm[k] = fr.live[k] ? tmax[fr.index(k)] : 0.f;
    occ[k] = false;
  }
  // a thread whose rays are all occluded (or out of range) tests no more
  // faces; the block leaves once all of its threads are so
  bool done = true;
#pragma unroll
  for (int k = 0; k < kRays; ++k) done &= !fr.live[k];

  for (int c = 0; c < rg.chunks; ++c) {
    const int base = c * kChunk;
    const float4* sc = ring_wait(rg, c);
    if (!done) {
      test_chunk(fr, sc, base, min(kChunk, f - base),
                 [&](int k, int, float t) { occ[k] |= t < tm[k]; });
      done = true;
#pragma unroll
      for (int k = 0; k < kRays; ++k) done &= occ[k] || !fr.live[k];
    }
    // every thread is done with chunk c's buffer, and the block's vote
    if (__syncthreads_and(done)) {
      ring_drain(rg, c);
      break;
    }
    ring_next(rg, c);
  }
#pragma unroll
  for (int k = 0; k < kRays; ++k)
    if (fr.live[k]) occ_out[fr.index(k)] = occ[k];
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
  closest_kernel<<<grid_for(n, kFlatRays), kFlatThreads, 0,
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
  any_flat_kernel<<<grid_for(n, kFlatRays), kFlatThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      ox, oy, oz, dx, dy, dz, avoid, tmax,
      reinterpret_cast<const float4*>(coef), n, f, occ);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
