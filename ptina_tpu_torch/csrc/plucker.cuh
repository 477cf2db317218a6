// The casts' hit contract as __device__ helpers.
//
// Reference: ptina_tpu/intersect/plucker.py (chunk_valid, the packed-key
// minimum, key_decode_t and the winner's u/v rebuild).  The pure-torch twin
// is ptina_tpu_torch/intersect/plucker.py; keep the two in lockstep.
//
// A face is one row of 16 floats (plucker.pack_faces), read as four
// float4: cu[0..5], cv[0..5], m0[0..3].  A ray is its 6 Plücker
// coordinates p, its direction d and its origin o.  Per (ray, face) pair:
//   U = cu.p   V = cv.p   B = m0.xyz.d   An = -(m0.[o, 1])   W = B - U - V
//   valid = sign bits of U, V, W equal B's, and An * B > 0, face != avoid
//   t = An * (1 / B), a hit only while t < INF
// The division is IEEE (__frcp_rn, no fast math): the sign tests, the
// An * B > 0 test and the far clip all rely on exact f32 behaviour.
#pragma once

#include <cstdint>

namespace ptina {

constexpr float kInf = 1e6f;          // utils/mathutils.INF, the far clip
constexpr int kKeyMiss = 0x7fffffff;  // plucker.KEY_MISS
constexpr int kCoef = 16;             // plucker.N_COEF
constexpr int kAttr = 18;             // 3 corners x (nrm3, uv2, mtlid)
constexpr int kChannels = 6;

struct Ray {
  float p0, p1, p2, p3, p4, p5;  // Plücker coordinates (ray_features order)
  float dx, dy, dz;
  float ox, oy, oz;
};

__device__ __forceinline__ Ray make_ray(float ox, float oy, float oz,
                                        float dx, float dy, float dz) {
  Ray r;
  r.p0 = ox * dy - oy * dx;
  r.p1 = ox * dz - oz * dx;
  r.p2 = -dx;
  r.p3 = oy * dz - oz * dy;
  r.p4 = -dy;
  r.p5 = -dz;
  r.dx = dx; r.dy = dy; r.dz = dz;
  r.ox = ox; r.oy = oy; r.oz = oz;
  return r;
}

// The first half of a pair, which every pair pays: U, V, B and W, and
// the sign-bit test of U, V and W against B (29 FP32 operations).  Returns
// the test's word, >= 0 where the pair passes (so the AND of several
// pairs' words is >= 0 where any of them passes), and writes B, which
// face_t needs.  A pair that fails it is no hit, whatever An.
__device__ __forceinline__ int face_side(const Ray& r, float4 c0, float4 c1,
                                         float4 c2, float4 c3, float* b) {
  float U = c0.x * r.p0 + c0.y * r.p1 + c0.z * r.p2 + c0.w * r.p3 +
            c1.x * r.p4 + c1.y * r.p5;
  float V = c1.z * r.p0 + c1.w * r.p1 + c2.x * r.p2 + c2.y * r.p3 +
            c2.z * r.p4 + c2.w * r.p5;
  float B = c3.x * r.dx + c3.y * r.dy + c3.z * r.dz;
  float W = B - U - V;
  int bi = __float_as_int(B);
  *b = B;
  return (__float_as_int(U) ^ bi) | (__float_as_int(V) ^ bi) |
         (__float_as_int(W) ^ bi);
}

// The second half, for a pair that passed face_side: An and the An * B > 0
// test (7 FP32 operations); returns whether the face is a valid hit (avoid
// not applied) and writes its t.
__device__ __forceinline__ bool face_t(const Ray& r, float4 c3, float B,
                                       float* t) {
  float An = -(c3.x * r.ox + c3.y * r.oy + c3.z * r.oz + c3.w);
  bool valid = An * B > 0.0f;
  // only valid pairs pay for the IEEE reciprocal
  *t = valid ? An * __frcp_rn(B) : kInf;
  return valid;
}

// One (ray, face) pair: returns whether the face is a valid hit (avoid not
// applied) and writes its t.  c0..c3 are the face's 16 coefficients.
// face_side, then face_t's arithmetic for every pair without a branch
// (the tree casts and the megakernel, whose registers were fitted to it).
__device__ __forceinline__ bool face_hit(const Ray& r, float4 c0, float4 c1,
                                         float4 c2, float4 c3, float* t) {
  float B;
  const int side = face_side(r, c0, c1, c2, c3, &B);
  float An = -(c3.x * r.ox + c3.y * r.oy + c3.z * r.oz + c3.w);
  bool valid = (side >= 0) && (An * B > 0.0f);
  // only valid pairs pay for the IEEE reciprocal
  *t = valid ? An * __frcp_rn(B) : kInf;
  return valid;
}

// Packed comparison key of a valid hit: the t bits with the low id bits
// replaced by the face id, so an int min is the nearest hit with ties to
// the lowest id.
__device__ __forceinline__ int pack_key(float t, int fid, int fid_mask) {
  return (__float_as_int(t) & ~fid_mask) | fid;
}

__device__ __forceinline__ float key_decode_t(int key, int fid_mask) {
  return __int_as_float(key & ~fid_mask);
}

// u, v of the winner from its coefficient row (global memory, read once
// per ray), with the reference's min(1 / B, 1e18) guard.
__device__ __forceinline__ void winner_uv(const Ray& r, const float* cw,
                                          float* u, float* v) {
  float uw = cw[0] * r.p0 + cw[1] * r.p1 + cw[2] * r.p2 + cw[3] * r.p3 +
             cw[4] * r.p4 + cw[5] * r.p5;
  float vw = cw[6] * r.p0 + cw[7] * r.p1 + cw[8] * r.p2 + cw[9] * r.p3 +
             cw[10] * r.p4 + cw[11] * r.p5;
  float bw = cw[12] * r.dx + cw[13] * r.dy + cw[14] * r.dz;
  float rb = fminf(__frcp_rn(bw), 1e18f);
  *u = uw * rb;
  *v = vw * rb;
}

// Per-ray outputs of a closest cast: t/u/v [n] f32, idx [n] i32, hit [n]
// bool and, for the shade casts, attrs [6, n] (channel-major).
struct HitOut {
  float* t;
  int* idx;
  bool* hit;
  float* u;
  float* v;
  float* attrs;  // unused without attributes (kAttrs false)
};

template <bool kAttrs>
__device__ __forceinline__ void store_miss(const HitOut& o, int i, int n) {
  o.t[i] = kInf;
  o.idx[i] = -1;
  o.hit[i] = false;
  o.u[i] = 0.f;
  o.v[i] = 0.f;
  if (kAttrs) {
#pragma unroll
    for (int c = 0; c < kChannels; ++c) o.attrs[c * n + i] = 0.f;
  }
}

// The winner w (a face id of the whole table) hit at t: its u, v rebuilt
// from its coefficient row and, with kAttrs, its 18 corner attributes
// (corner-major rows of attr: a[k * 6 + c]) interpolated barycentrically.
template <bool kAttrs>
__device__ __forceinline__ void store_hit(const HitOut& o, const Ray& r,
                                          const float* coef,
                                          const float* attr, int w, float t,
                                          int i, int n) {
  float u, v;
  winner_uv(r, coef + w * kCoef, &u, &v);
  o.t[i] = t;
  o.idx[i] = w;
  o.hit[i] = true;
  o.u[i] = u;
  o.v[i] = v;
  if (kAttrs) {
    const float w0 = 1.0f - u - v;
    const float* a = attr + w * kAttr;
#pragma unroll
    for (int c = 0; c < kChannels; ++c)
      o.attrs[c * n + i] =
          a[c] * w0 + a[kChannels + c] * u + a[2 * kChannels + c] * v;
  }
}

}  // namespace ptina
