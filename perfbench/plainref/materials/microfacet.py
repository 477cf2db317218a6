'''
Microfacet helpers, elementwise over [N] rows.

Reference: ptina_tpu/materials/microfacet.py (reference
ptina/materials/microfacet.py).  Every division is guarded so masked-out
lanes stay finite.  The visible-normal sampler sample_gtr2_vnor works on
[..., 3] vectors, as the reference's does; like the reference's Disney,
the port's does not call it.
'''

import torch

from perfbench.plainref.mathutils import (PI, clamp, clamp_min, cross,
                                             normalize, safe_sqrt, sqrt)
from perfbench.plainref.vec import vspherical

__all__ = ['schlick_fresnel', 'dielectric_fresnel', 'gtr1', 'gtr2',
           'smith_ggx', 'sample_gtr1', 'sample_gtr2', 'sample_gtr2_vnor',
           'pow5']


def pow5(x):
    '''x ** 5 by squaring, the multiplication chain of the reference's
    integer power (x * x^4).'''
    x2 = x * x
    return x * (x2 * x2)


def schlick_fresnel(cost):
    '''(1 - cos)^5.'''
    return pow5(clamp(1.0 - cost, 0.0, 1.0))


def dielectric_fresnel(etai, etao, cosi):
    '''Unpolarized dielectric Fresnel with total internal reflection
    (argument order of the reference).'''
    sini = safe_sqrt(1.0 - cosi * cosi)
    sint = etao / etai * sini
    no_tir = sint < 1.0
    cost = safe_sqrt(1.0 - sint * sint)
    a1, a2 = etai * cosi, etao * cost
    b1, b2 = etao * cosi, etai * cost
    para = (a1 - a2) / clamp_min(a1 + a2, 1e-12)
    perp = (b1 - b2) / clamp_min(b1 + b2, 1e-12)
    return torch.where(no_tir, 0.5 * (para * para + perp * perp), 1.0)


def gtr1(cosh, alpha):
    '''Berry NDF used for clearcoat (alpha < 1).'''
    a2 = alpha * alpha
    t = 1.0 + (a2 - 1.0) * cosh * cosh
    denom = PI * torch.log(clamp_min(a2, 1e-12)) * t
    return (a2 - 1.0) / torch.where(torch.abs(denom) < 1e-12, 1e-12, denom)


def gtr2(cosh, alpha):
    '''GGX NDF.'''
    a2 = alpha * alpha
    t = 1.0 + (a2 - 1.0) * cosh * cosh
    return a2 / (PI * clamp_min(t * t, 1e-12))


def smith_ggx(cosi, alpha):
    '''Smith masking term 1 / (cos + sqrt(a^2 + cos^2 - a^2 cos^2)).'''
    a = alpha * alpha
    b = cosi * cosi
    return 1.0 / clamp_min(cosi + safe_sqrt(a + b - a * b), 1e-12)


def sample_gtr1(u, v, alpha):
    '''Importance-sample the GTR1 lobe, local frame (standard CDF
    inversion; the reference fixes ptina's misplaced parentheses).'''
    a2 = clamp_min(alpha * alpha, 1e-12)
    h = safe_sqrt(clamp_min(1.0 - a2 ** (1.0 - u), 0.0)
                  / clamp_min(1.0 - a2, 1e-12))
    return vspherical(h, v)


def sample_gtr2(u, v, alpha):
    '''Importance-sample the GGX lobe, local frame.'''
    h = safe_sqrt((1.0 - u)
                  / clamp_min(1.0 - u * (1.0 - alpha * alpha), 1e-12))
    return vspherical(h, v)


def sample_gtr2_vnor(ve, u, v, alpha):
    '''Visible-normal GGX sampling (present but disabled in the reference,
    microfacet.py:81-100 / disney.py:162).  ve: [..., 3] view direction in
    the local frame; u, v, alpha: [...].  Returns the [..., 3] normal.'''
    vh = normalize(torch.stack([alpha * ve[..., 0], alpha * ve[..., 1],
                                ve[..., 2]], dim=-1))
    lensq = vh[..., 0] ** 2 + vh[..., 1] ** 2
    safe = lensq > 1e-12
    inv = 1.0 / sqrt(torch.where(safe, lensq, 1.0))
    t1 = torch.where(safe[..., None],
                     torch.stack([-vh[..., 1] * inv, vh[..., 0] * inv,
                                  torch.zeros_like(inv)], dim=-1),
                     torch.tensor([1.0, 0.0, 0.0], dtype=vh.dtype,
                                  device=vh.device))
    t2 = cross(vh, t1)
    r = safe_sqrt(u)
    phi = 2.0 * PI * v
    p1 = r * torch.cos(phi)
    p2r = r * torch.sin(phi)
    s = 0.5 * (1.0 + vh[..., 2])
    p2 = (1.0 - s) * safe_sqrt(1.0 - p1 * p1) + s * p2r
    nh = (p1[..., None] * t1 + p2[..., None] * t2
          + safe_sqrt(1.0 - p1 * p1 - p2 * p2)[..., None] * vh)
    return normalize(torch.stack([alpha * nh[..., 0], alpha * nh[..., 1],
                                  clamp_min(nh[..., 2], 0.0)], dim=-1))
