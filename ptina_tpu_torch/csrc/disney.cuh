// The Disney principled BSDF for one path in one thread: the derived
// parameters, the BRDF value and the importance-sampled bounce.
//
// Reference: ptina_tpu/materials/disney.py and microfacet.py, as traced
// inside engine/fused.py::_path_kernel.  The plain torch twin is
// ptina_tpu_torch/materials/disney.py (+ microfacet.py, choice_split in
// materials/__init__.py); every expression here keeps that file's
// operation order, so with --fmad=false the two differ only where
// sinf/cosf/logf/powf round differently from torch's.
//
// The torch version evaluates every lobe on every lane and selects by the
// stream-split decisions.  Here the thread branches on the decision and
// evaluates only the chosen lobe: an unselected lobe's value, NaN
// included, never reaches the result.  `zero` carries
// scene.Materials.zero as bits (kZero*): a lobe whose parameter is 0 in
// the whole table is skipped exactly as the torch version skips it.
#pragma once

#include "vec.cuh"

namespace ptina {

constexpr int kZeroMetallic = 1;
constexpr int kZeroSubsurface = 2;
constexpr int kZeroSheen = 4;
constexpr int kZeroClearcoat = 8;
constexpr int kZeroTransmission = 16;

struct Material {
  V3 basecolor;
  float metallic, roughness, specular, specularTint, subsurface, sheen,
      sheenTint, clearcoat, clearcoatGloss, transmission, ior;
  // derived (disney_derive)
  V3 tintcolor, speccolor, sheencolor;
  float alpha, ccalpha;
};

// ---- microfacet.py

__device__ __forceinline__ float pow5(float x) {
  const float x2 = x * x;
  return x * (x2 * x2);
}
__device__ __forceinline__ float schlick_fresnel(float cost) {
  return pow5(clampf(1.0f - cost, 0.0f, 1.0f));
}
__device__ __forceinline__ float dielectric_fresnel(float etai, float etao,
                                                    float cosi) {
  const float sini = safe_sqrt(1.0f - cosi * cosi);
  const float sint = etao / etai * sini;
  const bool no_tir = sint < 1.0f;
  const float cost = safe_sqrt(1.0f - sint * sint);
  const float a1 = etai * cosi, a2 = etao * cost;
  const float b1 = etao * cosi, b2 = etai * cost;
  const float para = (a1 - a2) / cmin(a1 + a2, 1e-12f);
  const float perp = (b1 - b2) / cmin(b1 + b2, 1e-12f);
  return no_tir ? 0.5f * (para * para + perp * perp) : 1.0f;
}
__device__ __forceinline__ float gtr1(float cosh, float alpha) {
  const float a2 = alpha * alpha;
  const float t = 1.0f + (a2 - 1.0f) * cosh * cosh;
  const float denom = kPi * logf(cmin(a2, 1e-12f)) * t;
  return (a2 - 1.0f) / (fabsf(denom) < 1e-12f ? 1e-12f : denom);
}
__device__ __forceinline__ float gtr2(float cosh, float alpha) {
  const float a2 = alpha * alpha;
  const float t = 1.0f + (a2 - 1.0f) * cosh * cosh;
  return a2 / (kPi * cmin(t * t, 1e-12f));
}
__device__ __forceinline__ float smith_ggx(float cosi, float alpha) {
  const float a = alpha * alpha;
  const float b = cosi * cosi;
  return 1.0f / cmin(cosi + safe_sqrt(a + b - a * b), 1e-12f);
}
__device__ __forceinline__ V3 sample_gtr1(float u, float v, float alpha) {
  const float a2 = cmin(alpha * alpha, 1e-12f);
  const float h = safe_sqrt(cmin(1.0f - powf(a2, 1.0f - u), 0.0f) /
                            cmin(1.0f - a2, 1e-12f));
  return vspherical(h, v);
}
__device__ __forceinline__ V3 sample_gtr2(float u, float v, float alpha) {
  const float h = safe_sqrt((1.0f - u) /
                            cmin(1.0f - u * (1.0f - alpha * alpha), 1e-12f));
  return vspherical(h, v);
}

// ---- materials/__init__.py and disney.py helpers

// choice_split: one stream-splitting decision
__device__ __forceinline__ bool choice_split(float w, float rate, float* w2,
                                             float* pdf) {
  const bool taken = w < rate;
  const float safe_r = cmin(rate, 1e-12f);
  const float safe_1r = cmin(1.0f - rate, 1e-12f);
  *w2 = taken ? w / safe_r : (w - rate) / safe_1r;
  *pdf = taken ? rate : 1.0f - rate;
  return taken;
}
// disney._sd: divide by a sign-preserving clamped denominator
__device__ __forceinline__ float sd(float num, float den) {
  const float mag = cmin(fabsf(den), 1e-8f);
  return num / (den < 0.0f ? -mag : mag);
}
// vec.vrefract: unit refracted direction, zeros on total internal
// reflection (returns whether it refracts)
__device__ __forceinline__ bool vrefract(V3 i, V3 n, float eta, V3* out) {
  const float noi = vdot(n, i);
  const float discr = 1.0f - eta * eta * (1.0f - noi * noi);
  const bool has = discr > 0.0f;
  const V3 t = vnormalize(i * eta - n * (eta * noi + safe_sqrt(discr)));
  *out = has ? t : v3(0.0f, 0.0f, 0.0f);
  return has;
}

__device__ __forceinline__ void disney_derive(Material* m) {
  const V3 b = m->basecolor;
  const float lum = 0.3f * b.x + 0.6f * b.y + 0.1f * b.z;
  const float inv_lum = 1.0f / cmin(lum, kEps);
  const V3 one = v3(1.0f, 1.0f, 1.0f);
  m->tintcolor = lum > kEps ? b * inv_lum : one;
  const V3 mix = vlerp(m->specularTint, one, m->tintcolor);
  m->speccolor = vlerp(m->metallic, mix * (m->specular * 0.08f), b);
  m->sheencolor = vlerp(m->sheenTint, one, m->tintcolor);
  m->alpha = cmin(m->roughness * m->roughness, 0.001f);
  m->ccalpha = lerp(m->clearcoatGloss, 0.1f, 0.001f);
}

__device__ __forceinline__ void etas(const Material& m, float sign,
                                     float* etai, float* etao) {
  *etai = sign < 0.0f ? m.ior : 1.0f;
  *etao = sign < 0.0f ? 1.0f : m.ior;
}

__device__ __forceinline__ float diffuse_lobe(const Material& m, int zero,
                                              float fi, float fo,
                                              float cosoh, float cosi,
                                              float coso) {
  const float fd90 = 0.5f + 2.0f * (cosoh * cosoh) * m.roughness;
  const float fd = lerp(fi, 1.0f, fd90) * lerp(fo, 1.0f, fd90);
  if (zero & kZeroSubsurface) return fd;
  const float fss90 = (cosoh * cosoh) * m.roughness;
  const float fss = lerp(fi, 1.0f, fss90) * lerp(fo, 1.0f, fss90);
  const float ss = 1.25f * (fss * (sd(1.0f, cosi + coso) - 0.5f) + 0.5f);
  return lerp(m.subsurface, fd, ss);
}

// disney_eval: the BRDF value for (indir, outdir)
__device__ __forceinline__ V3 disney_eval(const Material& m, int zero,
                                          V3 normal, float sign, V3 indir,
                                          V3 outdir) {
  const V3 halfdir = vnormalize(indir + outdir);
  const float cosi = vdot(indir, normal);
  const float coso = vdot(outdir, normal);
  const float cosh = vdot_or_zero(halfdir, normal);
  const float cosoh = vdot_or_zero(halfdir, outdir);
  const float ds = gtr2(cosh, m.alpha);
  const float fi = schlick_fresnel(cosi);
  const float fo = schlick_fresnel(coso);
  const float diff_lobe = diffuse_lobe(m, zero, fi, fo, cosoh, cosi, coso);
  const float foh = schlick_fresnel(cosoh);
  V3 diffuse = m.basecolor * (kInvPi * diff_lobe);
  if (!(zero & kZeroSheen))
    diffuse = diffuse + m.sheencolor * (foh * m.sheen);
  const V3 fs = vlerp(foh, m.speccolor, 1.0f);
  const float gs = smith_ggx(cosi, m.alpha) * smith_ggx(coso, m.alpha);
  V3 specular = fs * (gs * ds);
  if (!(zero & kZeroClearcoat)) {
    const float dr = gtr1(cosh, m.ccalpha);
    const float gr = smith_ggx(cosi, 0.25f) * smith_ggx(coso, 0.25f);
    const float fr = lerp(foh, 0.04f, 1.0f);
    specular = specular + (0.25f * m.clearcoat * gr * fr * dr);
  }
  const bool no_metal = zero & kZeroMetallic;
  const float kd = no_metal ? 1.0f : 1.0f - m.metallic;
  const V3 zero3 = v3(0.0f, 0.0f, 0.0f);
  if (zero & kZeroTransmission) {
    const V3 above = diffuse * kd + specular;
    return coso < 0.0f ? zero3 : above;
  }
  float etai, etao;
  etas(m, sign, &etai, &etao);
  const float fdf = dielectric_fresnel(etao, etai, cosoh);
  const V3 transmit_b = m.basecolor * (kInvPi * (1.0f - fdf) * ds);
  V3 below = transmit_b * (kd * m.transmission);
  below = cosi >= 0.0f ? below : zero3;
  const V3 transmit = m.basecolor * (kInvPi * fdf * ds);
  const V3 above = diffuse * (kd * (1.0f - m.transmission)) +
                   transmit * (kd * m.transmission) +
                   specular * (1.0f - m.transmission);
  return coso < 0.0f ? below : above;
}

// disney_sample: importance-sample a bounce (su, sv pick the direction,
// sw drives the lobe choice).  Invalid samples have pdf 0 and color 0.
__device__ __forceinline__ void disney_sample(const Material& m, int zero,
                                              V3 normal, float sign, V3 indir,
                                              float su, float sv, float sw,
                                              V3* outdir, float* pdf,
                                              V3* color) {
  const bool no_trans = zero & kZeroTransmission;
  const bool no_coat = zero & kZeroClearcoat;
  const bool no_metal = zero & kZeroMetallic;
  const V3 zero3 = v3(0.0f, 0.0f, 0.0f);

  const float fi = schlick_fresnel(vdot(indir, normal));
  const V3 fs_color = vlerp(fi, m.speccolor, 1.0f);
  const float spec_metal = no_metal ? vavg3(fs_color)
                                    : lerp(m.metallic, vavg3(fs_color), 1.0f);
  float specrate = no_trans ? spec_metal
                            : lerp(m.transmission, spec_metal, 1.0f);
  specrate = lerp(specrate, 0.1f, 1.0f);

  bool take_coat = false;
  float w1 = sw, pdf_c = 1.0f;
  if (!no_coat) {
    const float raw = 0.04f * m.clearcoat;
    const float coatrate = raw != 0.0f ? lerp(raw, 0.1f, 1.0f) : 0.0f;
    take_coat = choice_split(sw, coatrate, &w1, &pdf_c);
  }
  float w2, pdf_s;
  const bool take_spec_r = choice_split(w1, specrate, &w2, &pdf_s);
  const bool take_spec = no_coat ? take_spec_r : (!take_coat && take_spec_r);
  bool take_trans_r = false;
  float w3 = w2, pdf_t = 1.0f;
  if (!no_trans) take_trans_r = choice_split(w2, m.transmission, &w3, &pdf_t);

  V3 tan, bitan;
  vtanframe(normal, &tan, &bitan);
#define PTINA_TO_WORLD(l) (tan * (l).x + bitan * (l).y + normal * (l).z)

  if (take_coat) {  // clearcoat lobe
    const V3 lh = sample_gtr1(su, sv, m.ccalpha);
    const V3 h = PTINA_TO_WORLD(lh);
    const V3 out = vreflect(-indir, h);
    const float coso = vdot(out, normal);
    const float cosh = vdot_or_zero(h, normal);
    const float cosoh = vdot_or_zero(h, out);
    const bool ok = cosoh > 0.0f;
    const float dr = gtr1(cosh, m.ccalpha);
    const float fr = lerp(schlick_fresnel(cosoh), 0.04f, 1.0f);
    const float partial = m.clearcoat * fr * sd(coso, cosoh);
    *outdir = out;
    *pdf = ok ? dr * partial : 0.0f;
    const float s = ok ? sd(partial, pdf_c) : 0.0f;
    *color = v3(s, s, s);
    return;
  }
  if (take_spec) {  // specular lobe, with the transmission sub-branch
    const V3 lh = sample_gtr2(su, sv, m.alpha);
    const V3 h = PTINA_TO_WORLD(lh);
    const V3 out_sp = vreflect(-indir, h);
    const float coso = vdot_or_zero(out_sp, normal);
    const float cosh = vdot_or_zero(h, normal);
    const float cosoh = vdot_or_zero(h, out_sp);
    const bool ok = cosoh > 0.0f && coso > 0.0f && cosh > 0.0f;
    const float ds = gtr2(cosh, m.alpha);
    V3 out = out_sp, col;
    float p;
    if (!take_trans_r) {  // also every lane when no_trans
      const float foh = schlick_fresnel(cosoh);
      const V3 fs2 = vlerp(foh, m.speccolor, 1.0f);
      const float partial = 0.5f * sd(1.0f, cosoh * smith_ggx(coso, m.alpha));
      p = ds * vavg3(fs2) * partial;
      col = fs2 * sd(partial * (1.0f - m.transmission), pdf_c * pdf_s * pdf_t);
    } else {
      float etai, etao;
      etas(m, sign, &etai, &etao);
      const float eta = etai / etao;
      const float fdf = dielectric_fresnel(etao, etai, cosoh);
      const float reflrate = lerp(fdf, 0.2f, 1.0f);
      float w4, pdf_r;
      const bool take_refl = choice_split(w3, reflrate, &w4, &pdf_r);
      if (take_refl) {
        p = ds * fdf;
        col = m.basecolor * sd(fdf * m.transmission,
                               pdf_c * pdf_s * pdf_t * pdf_r);
      } else {
        const bool has_rf = vrefract(-indir, h, eta, &out);
        p = has_rf ? ds * (1.0f - fdf) : 0.0f;
        col = has_rf ? m.basecolor * sd((1.0f - fdf) * m.transmission,
                                        pdf_c * pdf_s * pdf_t * pdf_r)
                     : zero3;
      }
    }
    *outdir = out;
    *pdf = ok ? p : 0.0f;
    *color = ok ? col : zero3;
    return;
  }
  // diffuse lobe
  const V3 ld = vspherical(safe_sqrt(su), sv);
  const V3 out = PTINA_TO_WORLD(ld);
#undef PTINA_TO_WORLD
  const V3 half = vnormalize(indir + out);
  const float cosi = vdot(indir, normal);
  const float coso = vdot(out, normal);
  const float cosoh = vdot_or_zero(half, out);
  const float diff_lobe = diffuse_lobe(m, zero, schlick_fresnel(cosi),
                                       schlick_fresnel(coso), cosoh, cosi,
                                       coso);
  V3 diffuse = m.basecolor * (kInvPi * diff_lobe);
  if (!(zero & kZeroSheen))
    diffuse = diffuse + m.sheencolor * (schlick_fresnel(cosoh) * m.sheen);
  const float kd = no_metal ? 1.0f : 1.0f - m.metallic;
  const float kt = no_trans ? 1.0f : 1.0f - m.transmission;
  *outdir = out;
  *pdf = kInvPi;
  *color = diffuse * (kPi * sd(kd * kt, pdf_c * pdf_s));
}

}  // namespace ptina
