// Dense ray casts, Hopper (sm_90a).
//
// Replaces the three Pallas kernels of ptina_tpu/intersect/pallas_cast.py:
//   shade_kernel   <- _shade_kernel (pallas_cast.py:69, pallas_cast_shade):
//                     closest hit + barycentric interpolation of 6 attribute
//                     channels x 3 corners (nrm3, uv2, mtlid); the wavefront
//                     main path's closest cast;
//   any_kernel     <- _any_kernel (pallas_cast.py:62, pallas_cast_any):
//                     occlusion, a valid hit with t < min(tmax, INF);
//   closest_kernel <- _closest_kernel (pallas_cast.py:51,
//                     pallas_cast_closest): t, index, u and v only, behind the
//                     table-level intersect.cast_closest.  The shade kernel's
//                     body compiled without its attribute epilogue.
// The per-pair math is the hit contract of plucker.cuh; the plain torch
// versions are intersect/dense_cast.py:cast_shade_plain / cast_any_plain /
// cast_closest_plain.
//
// What bounds it on this card: every ray meets every face, ~25 FP32 ops per
// (ray, face) pair (the dot products for U, V, B, An; W; the sign tests;
// An * B) plus a few integer ops for the packed key, against ~60 B of ray
// I/O per ray
// (6 floats + avoid in; t, idx, hit, u, v and 6 attributes out).  At 512^2 rays
// and ~1000 faces that is ~2.6e8 pairs per cast: pure FP32 issue, with the
// face stream the only memory traffic that scales with F.
//
// What the design does about it: one thread per ray, 256-ray blocks; the
// face table is staged through shared memory in chunks of 256 faces
// (16 coefficients each, 16 KB), so each face costs four broadcast
// LDS.128 per warp and no global traffic per pair; each thread keeps a
// running packed-key minimum in a register (the reference's min-reduce,
// ties to the lowest face id); the IEEE reciprocal runs only for valid
// pairs; the winner's 16 coefficients and 18 corner attributes are loaded
// once per ray after the loop.  any_kernel leaves the face loop as soon as
// every ray of its block is occluded (or out of range).  The ragged ray
// edge is masked in-kernel; N is never padded.  No MXU-style chunk matmul,
// lane tiles or one-hot extraction survive from the TPU kernels.  The file
// is built with --fmad=false (intersect/dense_cast.py): products and sums
// round exactly as in the plain torch version, which makes the two agree
// bit for bit at the price of separate multiply and add instructions.
#include <cuda_runtime.h>

#include "plucker.cuh"

namespace {

constexpr int kBlock = 256;  // rays per block
constexpr int kChunk = 256;  // faces per shared-memory chunk

// Cooperative copy of faces [base, base + cnt) into shared memory.
__device__ __forceinline__ void stage_faces(float4* sc, const float4* coef,
                                            int base, int cnt) {
  for (int k = threadIdx.x; k < cnt * 4; k += kBlock)
    sc[k] = coef[base * 4 + k];
}

// The closest cast of one ray per thread; kAttrs adds the attribute
// epilogue (shade_kernel), without it the result is the Hit alone
// (closest_kernel).  sc: the block's shared face chunk.
template <bool kAttrs>
__device__ __forceinline__ void closest_cast(
    float4* sc, const float* __restrict__ ox, const float* __restrict__ oy,
    const float* __restrict__ oz, const float* __restrict__ dx,
    const float* __restrict__ dy, const float* __restrict__ dz,
    const int* __restrict__ avoid, const float4* __restrict__ coef,
    const float* __restrict__ attr, int n, int f, int fid_mask,
    const ptina::HitOut& out) {
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
    ptina::store_miss<kAttrs>(out, i, n);
    return;
  }
  ptina::store_hit<kAttrs>(out, r, reinterpret_cast<const float*>(coef), attr,
                           best & fid_mask,
                           ptina::key_decode_t(best, fid_mask), i, n);
}

__global__ void __launch_bounds__(kBlock)
shade_kernel(const float* __restrict__ ox, const float* __restrict__ oy,
             const float* __restrict__ oz, const float* __restrict__ dx,
             const float* __restrict__ dy, const float* __restrict__ dz,
             const int* __restrict__ avoid, const float4* __restrict__ coef,
             const float* __restrict__ attr, int n, int f, int fid_mask,
             ptina::HitOut out) {
  __shared__ float4 sc[kChunk * 4];
  closest_cast<true>(sc, ox, oy, oz, dx, dy, dz, avoid, coef, attr, n, f,
                     fid_mask, out);
}

__global__ void __launch_bounds__(kBlock)
closest_kernel(const float* __restrict__ ox, const float* __restrict__ oy,
               const float* __restrict__ oz, const float* __restrict__ dx,
               const float* __restrict__ dy, const float* __restrict__ dz,
               const int* __restrict__ avoid, const float4* __restrict__ coef,
               int n, int f, int fid_mask, ptina::HitOut out) {
  __shared__ float4 sc[kChunk * 4];
  closest_cast<false>(sc, ox, oy, oz, dx, dy, dz, avoid, coef, nullptr, n, f,
                      fid_mask, out);
}

__global__ void __launch_bounds__(kBlock)
any_kernel(const float* __restrict__ ox, const float* __restrict__ oy,
           const float* __restrict__ oz, const float* __restrict__ dx,
           const float* __restrict__ dy, const float* __restrict__ dz,
           const int* __restrict__ avoid, const float* __restrict__ tmax,
           const float4* __restrict__ coef, int n, int f,
           bool* __restrict__ occ_out) {
  __shared__ float4 sc[kChunk * 4];
  const int i = blockIdx.x * kBlock + threadIdx.x;
  const bool live = i < n;
  ptina::Ray r = live ? ptina::make_ray(ox[i], oy[i], oz[i], dx[i], dy[i],
                                        dz[i])
                      : ptina::make_ray(0.f, 0.f, 0.f, 0.f, 0.f, 1.f);
  const int av = live ? avoid[i] : -1;
  // t < min(tmax, INF) == (t < INF && t < tmax), also for a NaN tmax; a
  // parked ray (tmax 0) never occludes since valid t >= 0
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

inline int grid_for(int n) { return (n + kBlock - 1) / kBlock; }

}  // namespace

extern "C" {

// Closest hit + attributes.  Rays are six [n] f32 rows; coef is [f, 16]
// (16-byte aligned), attr [f, 18]; outputs t/u/v [n] f32, idx [n] i32,
// hit [n] bool, attrs [6, n] f32.  Returns cudaGetLastError() after the
// launch.
int ptina_cast_shade(const float* ox, const float* oy, const float* oz,
                     const float* dx, const float* dy, const float* dz,
                     const int* avoid, const float* coef, const float* attr,
                     int n, int f, int fid_mask, float* t, int* idx,
                     bool* hit, float* u, float* v, float* attrs,
                     void* stream) {
  shade_kernel<<<grid_for(n), kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      ox, oy, oz, dx, dy, dz, avoid, reinterpret_cast<const float4*>(coef),
      attr, n, f, fid_mask, ptina::HitOut{t, idx, hit, u, v, attrs});
  return static_cast<int>(cudaGetLastError());
}

// Closest hit without attributes: the outputs of ptina_cast_shade but
// attrs.
int ptina_cast_closest(const float* ox, const float* oy, const float* oz,
                       const float* dx, const float* dy, const float* dz,
                       const int* avoid, const float* coef, int n, int f,
                       int fid_mask, float* t, int* idx, bool* hit, float* u,
                       float* v, void* stream) {
  closest_kernel<<<grid_for(n), kBlock, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      ox, oy, oz, dx, dy, dz, avoid, reinterpret_cast<const float4*>(coef), n,
      f, fid_mask, ptina::HitOut{t, idx, hit, u, v, nullptr});
  return static_cast<int>(cudaGetLastError());
}

// Occlusion: occ [n] bool is true where a valid hit lies at
// t < min(tmax, INF).
int ptina_cast_any(const float* ox, const float* oy, const float* oz,
                   const float* dx, const float* dy, const float* dz,
                   const int* avoid, const float* tmax, const float* coef,
                   int n, int f, bool* occ, void* stream) {
  any_kernel<<<grid_for(n), kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      ox, oy, oz, dx, dy, dz, avoid, tmax,
      reinterpret_cast<const float4*>(coef), n, f, occ);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
