'''
Brute-force ray-triangle oracle and the Hit record.

Reference: ptina_tpu/intersect/brute.py.  Each triangle's 3x4 affine
functionals M (scene.precompute_tri_functionals) give, for a ray o + t d,
a = M [o, 1] and b = M [d, 0], then t = -a0 / b0, u = a1 + t b1,
v = a2 + t b2.  Hit semantics of the reference Face.intersect: |b0| >= EPS,
strict t > 0, barycentrics in the closed unit triangle, `avoid` excluded,
t < INF, nearest hit wins (argmin: lowest face id on exact ties).

The render path never calls this module's casts (it uses the dense
casts, intersect/dense_cast.py); it is the independent oracle the tests
hold them against.
'''

from __future__ import annotations

import dataclasses

import torch

from perfbench.plainref.mathutils import EPS, INF

__all__ = ['Hit', 'cast_closest', 'cast_any', 'TILE_F']

TILE_F = 512  # faces per tile: bounds the [N, 3 * TILE_F] intermediates


@dataclasses.dataclass
class Hit:
    hit: torch.Tensor    # [N] bool
    t: torch.Tensor      # [N] f32 (INF on miss)
    index: torch.Tensor  # [N] int32 (-1 on miss)
    u: torch.Tensor      # [N] f32 barycentric weight of v1
    v: torch.Tensor      # [N] f32 barycentric weight of v2


def _tile_test(o4, d4, m_tile, base, avoid):
    '''All rays against one face tile -> (t [N, TF] (INF where invalid),
    u, v).'''
    tf = m_tile.shape[0]
    mt = m_tile.reshape(tf * 3, 4).t()
    a = (o4 @ mt).reshape(-1, tf, 3)
    b = (d4 @ mt).reshape(-1, tf, 3)
    denom = b[..., 0]
    live = torch.abs(denom) >= EPS
    t = -a[..., 0] / torch.where(live, denom, 1.0)
    u = a[..., 1] + t * b[..., 1]
    v = a[..., 2] + t * b[..., 2]
    ids = base + torch.arange(tf, dtype=torch.int32, device=o4.device)
    valid = (live & (t > 0.0) & (u >= 0.0) & (u <= 1.0) & (v >= 0.0)
             & (u + v <= 1.0) & (ids[None, :] != avoid[:, None]))
    return torch.where(valid, t, INF), u, v


def _homog(ro, rd):
    one = torch.ones_like(ro.x)
    return (torch.stack([ro.x, ro.y, ro.z, one], dim=-1),
            torch.stack([rd.x, rd.y, rd.z, torch.zeros_like(one)], dim=-1))


def cast_closest(ro, rd, tri_w2b, avoid, tile=TILE_F):
    '''Nearest-hit cast.  ro, rd: V3 of [N] rows; tri_w2b [F, 3, 4];
    avoid [N] int32 (-1 = none).'''
    o4, d4 = _homog(ro, rd)
    n = o4.shape[0]
    dev = o4.device
    tbest = torch.full((n,), INF, device=dev)
    ibest = torch.full((n,), -1, dtype=torch.int32, device=dev)
    ubest = torch.zeros(n, device=dev)
    vbest = torch.zeros(n, device=dev)
    for base in range(0, tri_w2b.shape[0], tile):
        t, u, v = _tile_test(o4, d4, tri_w2b[base:base + tile], base, avoid)
        j = torch.argmin(t, dim=1)  # first minimum: lowest face id
        tmin = t.gather(1, j[:, None])[:, 0]
        better = tmin < tbest
        tbest = torch.where(better, tmin, tbest)
        ibest = torch.where(better, base + j.to(torch.int32), ibest)
        ubest = torch.where(better, u.gather(1, j[:, None])[:, 0], ubest)
        vbest = torch.where(better, v.gather(1, j[:, None])[:, 0], vbest)
    return Hit(hit=tbest < INF, t=tbest, index=ibest, u=ubest, v=vbest)


def cast_any(ro, rd, tri_w2b, avoid, tmax, tile=TILE_F):
    '''Occlusion: True where a face (except avoid) is hit at
    0 < t < min(tmax, INF).'''
    o4, d4 = _homog(ro, rd)
    occ = torch.zeros(o4.shape[0], dtype=torch.bool, device=o4.device)
    tm = torch.clamp_max(tmax, INF)
    for base in range(0, tri_w2b.shape[0], tile):
        t, _, _ = _tile_test(o4, d4, tri_w2b[base:base + tile], base, avoid)
        occ = occ | torch.any(t < tm[:, None], dim=1)
    return occ
