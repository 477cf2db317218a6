'''
BSDF model dispatch: Disney plus the alternate Lambert / Mirror / Phong
models.

Reference: ptina_tpu/materials/simple.py (reference
ptina/materials/lambert.py, phong.py).  Same calling convention as the
Disney functions: `*_eval(p, normal, sign, indir, outdir) -> V3` and
`*_sample(p, normal, sign, indir, su, sv, sw) -> (outdir, pdf, color)`,
with `p` the derived parameter dict of mtllib.fetch_material.
'''

import math

import torch

from perfbench.plainref.mathutils import INF, clamp, clamp_min, sqrt
from perfbench.plainref.vec import (
    V3, vdot, vnormalize, vreflect, vspherical, vtanframe, vwhere,
)
from perfbench.plainref.materials.disney import disney_eval, disney_sample

__all__ = ['lambert_eval', 'lambert_sample', 'mirror_eval', 'mirror_sample',
           'phong_eval', 'phong_sample', 'bsdf_eval', 'bsdf_sample',
           'MATERIAL_MODELS']


def _to_frame(normal, local):
    tan, bitan = vtanframe(normal)
    return tan * local.x + bitan * local.y + normal * local.z


def lambert_eval(p, normal, sign, indir, outdir):
    '''color / pi.'''
    return p['basecolor'] * (1.0 / math.pi)


def lambert_sample(p, normal, sign, indir, su, sv, sw):
    '''Cosine-hemisphere bounce: pdf 1/pi, throughput = basecolor.'''
    outdir = _to_frame(normal, vspherical(sqrt(su), sv))
    pdf = torch.full_like(su, 1.0 / math.pi)
    return outdir, pdf, p['basecolor']


def mirror_eval(p, normal, sign, indir, outdir):
    '''Perfect mirror: zero for next-event estimation.'''
    zero = torch.zeros_like(sign)
    return V3(zero, zero, zero)


def mirror_sample(p, normal, sign, indir, su, sv, sw):
    '''Deterministic reflection with the pdf = INF sentinel.'''
    outdir = vreflect(-1.0 * indir, normal)
    pdf = torch.full_like(su, INF)
    return outdir, pdf, p['basecolor']


def _shineness(p):
    # Phong exponent from roughness: 2/r^2 - 2
    r = p.get('roughness')
    r = clamp(r, 1e-3, 1.0)
    return clamp_min(2.0 / (r * r) - 2.0, 0.0)


def phong_eval(p, normal, sign, indir, outdir):
    return p['basecolor'] * (1.0 / math.pi)


def phong_sample(p, normal, sign, indir, su, sv, sw):
    '''Phong lobe around the reflected direction; below-horizon samples
    are invalid (pdf 0, color 0).'''
    m = _shineness(p)
    cosor = su ** (1.0 / (m + 1.0))
    refldir = vreflect(-1.0 * indir, normal)
    outdir = _to_frame(refldir, vspherical(cosor, sv))
    ok = vdot(outdir, normal) >= 0.0
    pdf = torch.where(ok, torch.full_like(su, 1.0 / math.pi), 0.0)
    color = vwhere(ok, p['basecolor'], 0.0)
    return vnormalize(vwhere(ok, outdir, normal)), pdf, color


MATERIAL_MODELS = {
    'disney': (disney_eval, disney_sample),
    'lambert': (lambert_eval, lambert_sample),
    'mirror': (mirror_eval, mirror_sample),
    'phong': (phong_eval, phong_sample),
}


def bsdf_eval(model, p, normal, sign, indir, outdir, zero=()):
    '''Model dispatch by name; zero (Materials.zero) reaches Disney only.'''
    if model == 'disney':
        return disney_eval(p, normal, sign, indir, outdir, zero)
    return MATERIAL_MODELS[model][0](p, normal, sign, indir, outdir)


def bsdf_sample(model, p, normal, sign, indir, su, sv, sw, zero=()):
    if model == 'disney':
        return disney_sample(p, normal, sign, indir, su, sv, sw, zero)
    return MATERIAL_MODELS[model][1](p, normal, sign, indir, su, sv, sw)
