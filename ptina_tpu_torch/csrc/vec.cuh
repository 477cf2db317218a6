// Per-thread float math of the path megakernel: 3-vectors and the scalar
// helpers of utils/mathutils.py and utils/vec.py, in the plain torch
// versions' exact operation order.
//
// Built with --fmad=false and without --use_fast_math, so every product,
// sum, division and sqrtf rounds as one torch elementwise op does.  The
// clamps propagate NaN as torch.clamp / clamp_min / maximum do (a fmaxf
// would turn a NaN into the bound).  Constants that the torch code holds
// as Python floats are the float32 roundings of the same doubles.
#pragma once

#include "plucker.cuh"  // kInf, the far clip

namespace ptina {

constexpr float kEps = 1e-6f;                              // mathutils.EPS
constexpr float kPi = static_cast<float>(3.141592653589793);
constexpr float kTau = static_cast<float>(2.0 * 3.141592653589793);
constexpr float kInvPi = static_cast<float>(1.0 / 3.141592653589793);

// torch.clamp_min(x, lo): NaN stays NaN
__device__ __forceinline__ float cmin(float x, float lo) {
  return x < lo ? lo : x;
}
// torch.clamp_max(x, hi)
__device__ __forceinline__ float cmax(float x, float hi) {
  return x > hi ? hi : x;
}
// torch.clamp(x, lo, hi)
__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return cmax(cmin(x, lo), hi);
}
// mathutils.safe_sqrt: 0 where x <= 0 or NaN
__device__ __forceinline__ float safe_sqrt(float x) {
  return x > 0.0f ? sqrtf(x) : 0.0f;
}
// mathutils.lerp(fac, src, dst) = src * (1 - fac) + dst * fac
__device__ __forceinline__ float lerp(float fac, float src, float dst) {
  return src * (1.0f - fac) + dst * fac;
}

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 v3(float x, float y, float z) {
  V3 r;
  r.x = x; r.y = y; r.z = z;
  return r;
}
__device__ __forceinline__ V3 operator+(V3 a, V3 b) {
  return v3(a.x + b.x, a.y + b.y, a.z + b.z);
}
__device__ __forceinline__ V3 operator+(V3 a, float s) {
  return v3(a.x + s, a.y + s, a.z + s);
}
__device__ __forceinline__ V3 operator-(V3 a, V3 b) {
  return v3(a.x - b.x, a.y - b.y, a.z - b.z);
}
__device__ __forceinline__ V3 operator*(V3 a, V3 b) {
  return v3(a.x * b.x, a.y * b.y, a.z * b.z);
}
__device__ __forceinline__ V3 operator*(V3 a, float s) {
  return v3(a.x * s, a.y * s, a.z * s);
}
__device__ __forceinline__ V3 operator-(V3 a) { return v3(-a.x, -a.y, -a.z); }

__device__ __forceinline__ float vdot(V3 a, V3 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}
__device__ __forceinline__ float vdot_or_zero(V3 a, V3 b) {
  return cmin(vdot(a, b), 0.0f);
}
// vec.vnormalize: a * (1 / max(|a|, 1e-12))
__device__ __forceinline__ V3 vnormalize(V3 a) {
  const float inv = 1.0f / cmin(safe_sqrt(vdot(a, a)), 1e-12f);
  return a * inv;
}
__device__ __forceinline__ V3 vcross(V3 a, V3 b) {
  return v3(a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
            a.x * b.y - a.y * b.x);
}
// vec.vlerp(fac, src, dst) with a scalar destination
__device__ __forceinline__ V3 vlerp(float fac, V3 src, float dst) {
  return src * (1.0f - fac) + dst * fac;
}
__device__ __forceinline__ V3 vlerp(float fac, V3 src, V3 dst) {
  return src * (1.0f - fac) + dst * fac;
}
__device__ __forceinline__ float vavg3(V3 a) {
  return (a.x + a.y + a.z) * static_cast<float>(1.0 / 3.0);
}
__device__ __forceinline__ bool any3(V3 a) {
  return a.x > 0.0f || a.y > 0.0f || a.z > 0.0f;
}
// vec.vreflect: i - n * (2 (n . i))
__device__ __forceinline__ V3 vreflect(V3 i, V3 n) {
  return i - n * (2.0f * vdot(n, i));
}
// vec.vspherical(h, p)
__device__ __forceinline__ V3 vspherical(float h, float p) {
  const float r = safe_sqrt(1.0f - h * h);
  const float ang = p * kTau;
  return v3(r * cosf(ang), r * sinf(ang), h);
}
// vec.vtanframe with the fixed up vector (233, 666, 512)
__device__ __forceinline__ void vtanframe(V3 n, V3* tan, V3* bitan) {
  *bitan = vnormalize(vcross(n, v3(233.0f, 666.0f, 512.0f)));
  *tan = vcross(*bitan, n);
}

}  // namespace ptina
