// Analytic lights for one path in one thread: the direct-hit query with
// the nearest-light rule, and the next-event light sample.
//
// Reference: engine/fused.py::_lights_hit_k / _lights_sample_k (which
// trace ptina_tpu/lights.py).  The plain torch twin is
// ptina_tpu_torch/lights.py (lights_hit, lights_sample, ray_sphere,
// ray_rect), in whose operation order everything here is written.
//
// The kernel reads the light pool as the scene keeps it (per-slot pos /
// color [L, 3], axes [L, 3, 3] with axis k in column k, size [L], type
// [L] and the live count), the same fields _pack_lights stacks into its
// [18, L] table, so nothing is repacked per launch.
#pragma once

#include "vec.cuh"

namespace ptina {

constexpr int kLightPoint = 1;  // scene.LIGHT_POINT
constexpr int kLightArea = 2;   // scene.LIGHT_AREA

struct LightPool {
  const float* pos;    // [L, 3]
  const float* color;  // [L, 3]
  const float* axes;   // [L, 3, 3]
  const float* size;   // [L]
  const int* type;     // [L]
  int slots;           // L
  int count;           // live lights (slots [0, count))
  bool has_point, has_area;  // Lights.kinds
};

__device__ __forceinline__ V3 ld3(const float* p) {
  return v3(__ldg(p), __ldg(p + 1), __ldg(p + 2));
}
// axis k (column k of the slot's 3x3)
__device__ __forceinline__ V3 light_axis(const LightPool& lp, int l, int k) {
  const float* a = lp.axes + 9 * l + k;
  return v3(__ldg(a), __ldg(a + 3), __ldg(a + 6));
}

// lights.ray_sphere: nearest positive hit distance, 0 on a miss
__device__ __forceinline__ float ray_sphere(V3 ro, V3 rd, V3 center,
                                            float radius2) {
  const V3 op = center - ro;
  const float b = vdot(op, rd);
  const float det = b * b + radius2 - vdot(op, op);
  const float sq = safe_sqrt(det);
  const float t_near = b - sq;
  const float t_far = b + sq;
  const float t = t_near > kEps ? t_near : (t_far > kEps ? t_far : 0.0f);
  return det >= 0.0f ? t : 0.0f;
}

// lights.ray_rect: one-sided rectangle pos +/- dirx +/- diry
__device__ __forceinline__ bool ray_rect(V3 ro, V3 rd, V3 pos, V3 dirx,
                                         V3 diry, float* t_out) {
  const V3 nrm = vnormalize(vcross(dirx, diry));
  const float nod = vdot(nrm, rd);
  const bool facing = nod > kEps;
  const float t = vdot(nrm, pos - ro) / (facing ? nod : 1.0f);
  const V3 p = ro + rd * t - pos;
  const float u = vdot(p, dirx) / cmin(vdot(dirx, dirx), 1e-20f);
  const float v = vdot(p, diry) / cmin(vdot(diry, diry), 1e-20f);
  const bool hit = facing && fabsf(u) < 1.0f && fabsf(v) < 1.0f;
  *t_out = hit ? t : kInf;
  return hit;
}

// lights.lights_hit: the nearest light along the ray wins
__device__ __forceinline__ bool lights_hit(const LightPool& lp, V3 ro, V3 rd,
                                           float* dis, float* pdf,
                                           V3* color) {
  bool found = false;
  *dis = kInf;
  *pdf = 0.0f;
  *color = v3(0.0f, 0.0f, 0.0f);
  for (int l = 0; l < lp.slots; ++l) {
    const int type = __ldg(lp.type + l);
    const bool is_point = type == kLightPoint;
    const bool is_area = type == kLightArea;
    const float size = __ldg(lp.size + l);
    const V3 pos = ld3(lp.pos + 3 * l);
    const float t_sph =
        lp.has_point ? ray_sphere(ro, rd, pos, size * size) : 0.0f;
    float t_ar = 0.0f;
    if (lp.has_area) {
      float t_rect;
      const bool hit_rect = ray_rect(ro, rd, pos, light_axis(lp, l, 0) * size,
                                     light_axis(lp, l, 1) * size, &t_rect);
      t_ar = is_area && hit_rect ? t_rect : 0.0f;
    }
    const float t = lp.has_point ? (is_point ? t_sph : t_ar) : t_ar;
    const float area = is_point ? kPi * size * size : 4.0f * size * size;
    if (l < lp.count && t > 0.0f && t < *dis) {
      *dis = t;
      *pdf = t * t / cmin(area, 1e-12f);
      *color = ld3(lp.color + 3 * l);
      found = true;
    }
  }
  return found;
}

// lights.lights_sample: sz picks the light, su / sv the point on it.
// The color comes divided by the pdf and cosine-weighted for area lights.
__device__ __forceinline__ void lights_sample(const LightPool& lp, V3 hitpos,
                                              float su, float sv, float sz,
                                              float* dis, V3* dir, float* pdf,
                                              V3* color) {
  const int cnt = max(lp.count, 1);
  int idx = static_cast<int>(sz * static_cast<float>(cnt));
  idx = min(max(idx, 0), cnt - 1);
  V3 litpos = v3(0.0f, 0.0f, 0.0f), nrm = litpos, col = litpos;
  float area = 0.0f;
  bool is_area_sel = false;
  if (idx < lp.slots) {
    const float size = __ldg(lp.size + idx);
    const V3 pos = ld3(lp.pos + 3 * idx);
    const bool is_area = __ldg(lp.type + idx) == kLightArea;
    const float lx = su * 2.0f - 1.0f;
    const float ly = sv * 2.0f - 1.0f;
    const V3 ax_x = light_axis(lp, idx, 0);
    const V3 ax_y = light_axis(lp, idx, 1);
    if (lp.has_point && (!lp.has_area || !is_area))
      litpos = pos + vspherical(su, sv) * size;
    else if (lp.has_area)
      litpos = pos + (ax_x * lx + ax_y * ly) * size;
    else
      litpos = pos;
    area = is_area ? 4.0f * size * size : kPi * size * size;
    nrm = is_area ? light_axis(lp, idx, 2) : nrm;
    col = ld3(lp.color + 3 * idx);
    is_area_sel = is_area;
  }
  const V3 toli = litpos - hitpos;
  const float d = cmin(safe_sqrt(vdot(toli, toli)), 1e-12f);
  const V3 direction = toli * (1.0f / d);
  const float p = d * d / cmin(area, 1e-12f);
  V3 out = col * (1.0f / p);
  const float cosine = cmin(vdot(nrm, direction), 0.0f);
  if (is_area_sel) out = out * cosine;
  const bool empty = lp.count == 0;
  *dis = empty ? kInf : d;
  *dir = empty ? v3(0.0f, 0.0f, 0.0f) : direction;
  *pdf = empty ? 0.0f : p;
  *color = empty ? v3(0.0f, 0.0f, 0.0f) : out;
}

}  // namespace ptina
