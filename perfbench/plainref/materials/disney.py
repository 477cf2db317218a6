'''
Disney principled BSDF with transmission, branchless over ray batches.

Reference: ptina_tpu/materials/disney.py (reference
ptina/materials/disney.py).  For sampling, every lobe (clearcoat /
specular with its transmission sub-branch / diffuse) is evaluated on
every lane and the lane's result selected by the stream-split decision
masks.  `zero` (scene.Materials.zero) names parameters that are 0 across
the whole material table; their terms are skipped exactly as the
reference skips them, which changes which lobes are evaluated but not
the result.
'''

import torch

from perfbench.plainref.mathutils import (EPS, PI, clamp_min, lerp,
                                            safe_sqrt)
from perfbench.plainref.vec import (
    V3, vdot, vdot_or_zero, vnormalize, vlerp, vwhere, vavg3, vreflect,
    vrefract, vtanframe, vspherical,
)
from perfbench.plainref.materials import choice_split
from perfbench.plainref.materials.microfacet import (
    schlick_fresnel, dielectric_fresnel, gtr1, gtr2, smith_ggx,
    sample_gtr1, sample_gtr2,
)

__all__ = ['disney_derive', 'disney_eval', 'disney_sample']


def _sd(num, den, eps=1e-8):
    '''Divide with a sign-preserving clamped denominator (den: tensor).'''
    mag = clamp_min(torch.abs(den), eps)
    return num / torch.where(den < 0, -mag, mag)


def disney_derive(p):
    '''Derived terms (tint / spec / sheen colors, alphas) of the reference
    ctor.  p: dict with basecolor (V3) and the 11 scalar params [N].'''
    basecolor = p['basecolor']
    lum = 0.3 * basecolor.x + 0.6 * basecolor.y + 0.1 * basecolor.z
    inv_lum = 1.0 / clamp_min(lum, EPS)
    tint = vwhere(lum > EPS, basecolor * inv_lum, 1.0)
    one = V3.full_like(tint, (1.0, 1.0, 1.0))
    mix = vlerp(p['specularTint'], one, tint)
    spec = vlerp(p['metallic'], mix * (p['specular'] * 0.08), basecolor)
    sheen = vlerp(p['sheenTint'], one, tint)
    out = dict(p)
    out['tintcolor'] = tint
    out['speccolor'] = spec
    out['sheencolor'] = sheen
    out['alpha'] = clamp_min(p['roughness'] * p['roughness'], 0.001)
    out['ccalpha'] = lerp(p['clearcoatGloss'], 0.1, 0.001)
    return out


def _etas(p, sign):
    '''(etai, etao), swapped when hitting the back side.'''
    ior = p['ior']
    one = torch.ones_like(ior)
    etai = torch.where(sign < 0, ior, one)
    etao = torch.where(sign < 0, one, ior)
    return etai, etao


def _diffuse_lobe(p, zero, fi, fo, cosoh, cosi, coso):
    fd90 = 0.5 + 2.0 * (cosoh * cosoh) * p['roughness']
    fd = lerp(fi, 1.0, fd90) * lerp(fo, 1.0, fd90)
    if 'subsurface' in zero:
        return fd
    fss90 = (cosoh * cosoh) * p['roughness']
    fss = lerp(fi, 1.0, fss90) * lerp(fo, 1.0, fss90)
    ss = 1.25 * (fss * (_sd(1.0, cosi + coso) - 0.5) + 0.5)
    return lerp(p['subsurface'], fd, ss)


def disney_eval(p, normal, sign, indir, outdir, zero=()):
    '''BRDF value (reference brdf()).  p: derived param dict; normal,
    indir, outdir: V3; sign: [N].  Returns V3.'''
    no_trans = 'transmission' in zero
    no_coat = 'clearcoat' in zero
    no_metal = 'metallic' in zero

    halfdir = vnormalize(indir + outdir)
    cosi = vdot(indir, normal)
    coso = vdot(outdir, normal)
    cosh = vdot_or_zero(halfdir, normal)
    cosoh = vdot_or_zero(halfdir, outdir)

    alpha = p['alpha']
    basecolor = p['basecolor']
    metallic = p['metallic']
    transmission = p['transmission']

    ds = gtr2(cosh, alpha)

    fi = schlick_fresnel(cosi)
    fo = schlick_fresnel(coso)
    diff_lobe = _diffuse_lobe(p, zero, fi, fo, cosoh, cosi, coso)

    foh = schlick_fresnel(cosoh)
    diffuse = basecolor * ((1.0 / PI) * diff_lobe)
    if 'sheen' not in zero:
        diffuse = diffuse + p['sheencolor'] * (foh * p['sheen'])

    fs = vlerp(foh, p['speccolor'], 1.0)
    gs = smith_ggx(cosi, alpha) * smith_ggx(coso, alpha)
    specular = fs * (gs * ds)
    if not no_coat:
        dr = gtr1(cosh, p['ccalpha'])
        gr = smith_ggx(cosi, 0.25) * smith_ggx(coso, 0.25)
        fr = lerp(foh, 0.04, 1.0)
        specular = specular + (0.25 * p['clearcoat'] * gr * fr * dr)

    kd = 1.0 - metallic if not no_metal else 1.0
    if no_trans:
        above = diffuse * kd + specular
        return vwhere(coso < 0.0, 0.0, above)

    etai, etao = _etas(p, sign)
    fdf = dielectric_fresnel(etao, etai, cosoh)

    transmit_b = basecolor * ((1.0 / PI) * (1.0 - fdf) * ds)
    below = transmit_b * (kd * transmission)
    below = vwhere(cosi >= 0.0, below, 0.0)

    transmit = basecolor * ((1.0 / PI) * fdf * ds)
    above = (diffuse * (kd * (1.0 - transmission))
             + transmit * (kd * transmission)
             + specular * (1.0 - transmission))
    return vwhere(coso < 0.0, below, above)


def disney_sample(p, normal, sign, indir, su, sv, sw, zero=()):
    '''Importance-sample a bounce direction (reference bounce()).
    su/sv/sw: [N] uniforms (sw drives the lobe choice).  Returns
    (outdir V3, pdf [N], color V3); invalid samples have pdf 0, color 0.'''
    no_trans = 'transmission' in zero
    no_coat = 'clearcoat' in zero
    no_metal = 'metallic' in zero

    basecolor = p['basecolor']
    metallic = p['metallic']
    transmission = p['transmission']
    alpha = p['alpha']

    cosi_s = vdot(indir, normal)
    fi = schlick_fresnel(cosi_s)
    fs_color = vlerp(fi, p['speccolor'], 1.0)

    # stream-split lobe decisions
    spec_metal = (vavg3(fs_color) if no_metal
                  else lerp(metallic, vavg3(fs_color), 1.0))
    specrate = spec_metal if no_trans else lerp(transmission, spec_metal, 1.0)
    specrate = lerp(specrate, 0.1, 1.0)

    if no_coat:
        take_coat, w1, pdf_c = None, sw, 1.0
    else:
        coatrate_raw = 0.04 * p['clearcoat']
        coatrate = torch.where(coatrate_raw != 0.0,
                               lerp(coatrate_raw, 0.1, 1.0),
                               torch.zeros_like(coatrate_raw))
        take_coat, w1, pdf_c = choice_split(sw, coatrate)
    take_spec_r, w2, pdf_s = choice_split(w1, specrate)
    take_spec = take_spec_r if no_coat else ~take_coat & take_spec_r
    if no_trans:
        take_trans_r, w3, pdf_t = None, w2, 1.0
    else:
        take_trans_r, w3, pdf_t = choice_split(w2, transmission)

    tan, bitan = vtanframe(normal)

    def to_world(local):
        return tan * local.x + bitan * local.y + normal * local.z

    # clearcoat lobe
    if not no_coat:
        cc_alpha = p['ccalpha']
        h_cc = to_world(sample_gtr1(su, sv, cc_alpha))
        out_cc = vreflect(-indir, h_cc)
        coso_cc = vdot(out_cc, normal)
        cosh_cc = vdot_or_zero(h_cc, normal)
        cosoh_cc = vdot_or_zero(h_cc, out_cc)
        ok_cc = cosoh_cc > 0.0
        dr = gtr1(cosh_cc, cc_alpha)
        fr = lerp(schlick_fresnel(cosoh_cc), 0.04, 1.0)
        partial_cc = p['clearcoat'] * fr * _sd(coso_cc, cosoh_cc)
        pdf_cc = torch.where(ok_cc, dr * partial_cc, 0.0)
        col_cc_s = torch.where(ok_cc, _sd(partial_cc, pdf_c), 0.0)
        col_cc = V3(col_cc_s, col_cc_s, col_cc_s)

    # specular lobe
    h_sp = to_world(sample_gtr2(su, sv, alpha))
    out_sp = vreflect(-indir, h_sp)
    coso_sp = vdot_or_zero(out_sp, normal)
    cosh_sp = vdot_or_zero(h_sp, normal)
    cosoh_sp = vdot_or_zero(h_sp, out_sp)
    ok_sp = (cosoh_sp > 0.0) & (coso_sp > 0.0) & (cosh_sp > 0.0)
    ds = gtr2(cosh_sp, alpha)

    foh = schlick_fresnel(cosoh_sp)
    fs2 = vlerp(foh, p['speccolor'], 1.0)
    partial_sp = 0.5 * _sd(1.0, cosoh_sp * smith_ggx(coso_sp, alpha))
    pdf_sp_plain = ds * vavg3(fs2) * partial_sp
    col_sp_plain = fs2 * _sd(partial_sp * (1.0 - transmission),
                             pdf_c * pdf_s * pdf_t)

    if no_trans:
        out_spec, pdf_spec, col_spec = out_sp, pdf_sp_plain, col_sp_plain
    else:
        etai, etao = _etas(p, sign)
        eta = etai / etao
        fdf = dielectric_fresnel(etao, etai, cosoh_sp)
        reflrate = lerp(fdf, 0.2, 1.0)
        take_refl_r, _w4, pdf_r = choice_split(w3, reflrate)
        pdf_sp_trefl = ds * fdf
        col_sp_trefl = basecolor * _sd(fdf * transmission,
                                       pdf_c * pdf_s * pdf_t * pdf_r)
        has_rf, out_rf = vrefract(-indir, h_sp, eta)
        pdf_sp_trefr = torch.where(has_rf, ds * (1.0 - fdf), 0.0)
        col_sp_trefr = vwhere(
            has_rf,
            basecolor * _sd((1.0 - fdf) * transmission,
                            pdf_c * pdf_s * pdf_t * pdf_r),
            0.0)
        out_spec = vwhere(take_trans_r, vwhere(take_refl_r, out_sp, out_rf),
                          out_sp)
        pdf_spec = torch.where(take_trans_r,
                               torch.where(take_refl_r, pdf_sp_trefl,
                                           pdf_sp_trefr),
                               pdf_sp_plain)
        col_spec = vwhere(take_trans_r, vwhere(take_refl_r, col_sp_trefl,
                                               col_sp_trefr),
                          col_sp_plain)
    pdf_spec = torch.where(ok_sp, pdf_spec, 0.0)
    col_spec = vwhere(ok_sp, col_spec, 0.0)

    # diffuse lobe
    out_df = to_world(vspherical(safe_sqrt(su), sv))
    half_df = vnormalize(indir + out_df)
    cosi_df = vdot(indir, normal)
    coso_df = vdot(out_df, normal)
    cosoh_df = vdot_or_zero(half_df, out_df)
    fi_d = schlick_fresnel(cosi_df)
    fo_d = schlick_fresnel(coso_df)
    diff_lobe = _diffuse_lobe(p, zero, fi_d, fo_d, cosoh_df, cosi_df,
                              coso_df)
    diffuse = basecolor * ((1.0 / PI) * diff_lobe)
    if 'sheen' not in zero:
        diffuse = diffuse + p['sheencolor'] * (
            schlick_fresnel(cosoh_df) * p['sheen'])
    kd = 1.0 if no_metal else 1.0 - metallic
    kt = 1.0 if no_trans else 1.0 - transmission
    col_df = diffuse * (PI * _sd(kd * kt, pdf_c * pdf_s))

    # select by lane decision
    outdir = vwhere(take_spec, out_spec, out_df)
    pdf = torch.where(take_spec, pdf_spec, 1.0 / PI)
    color = vwhere(take_spec, col_spec, col_df)
    if not no_coat:
        outdir = vwhere(take_coat, out_cc, outdir)
        pdf = torch.where(take_coat, pdf_cc, pdf)
        color = vwhere(take_coat, col_cc, color)
    return outdir, pdf, color
