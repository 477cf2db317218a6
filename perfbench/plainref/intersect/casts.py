'''
The plain reference's scene-level casts: a frozen copy of the plain
versions in ptina_tpu_torch/intersect/dense_cast.py (cast_shade_plain,
cast_any_plain), intersect/blocked.py (blocked_cast_shade_plain,
blocked_cast_any_plain) and the route of intersect/dispatch.py.  Every
cast tests every face of the table: the hit contract (plucker.py) decides
the winner, the same one the program's tree kernels must find.
'''

import torch

from perfbench.plainref.intersect.plucker import (
    KEY_FID_MASK, KEY_MISS, face_chunk, key_decode_t, key_mask_for,
    pair_hits, pair_keys, ray_features, winner_hit)
from perfbench.plainref.mathutils import INF
from perfbench.plainref.vec import V3, vnormalize

MAX_DENSE_FACES = 8192
BLOCK_FACES = 512
MAX_BLOCKED_FACES = BLOCK_FACES * 4096


def route(nfaces, accel):
    '''dispatch.route: 'dense', 'blocked' or 'brute' for nfaces padded
    faces built with accel.'''
    if accel == 'dense' and nfaces > MAX_DENSE_FACES:
        return 'brute'
    if accel != 'blocked' and nfaces <= MAX_DENSE_FACES:
        return 'dense'
    if nfaces > MAX_BLOCKED_FACES:
        raise ValueError(f'{nfaces} faces exceed the blocked casts')
    return 'blocked'


def _best_keys(ro, rd, avoid, coef):
    n, f = ro.x.shape[0], coef.shape[0]
    fid_mask = key_mask_for(f)
    p = ray_features(ro, rd)
    best = torch.full((n,), KEY_MISS, dtype=torch.int32, device=ro.x.device)
    fc = face_chunk(n, f)
    for base in range(0, f, fc):
        best = torch.minimum(best, pair_keys(p, ro, rd, coef[base:base + fc],
                                             base, avoid, fid_mask))
    return p, best, fid_mask


def dense_shade(ro, rd, avoid, coef, attr):
    p, best, fid_mask = _best_keys(ro, rd, avoid, coef)
    return winner_hit(p, rd, coef, attr, best != KEY_MISS, best & fid_mask,
                      key_decode_t(best, fid_mask))


def dense_closest(ro, rd, avoid, coef):
    p, best, fid_mask = _best_keys(ro, rd, avoid, coef)
    return winner_hit(p, rd, coef, None, best != KEY_MISS, best & fid_mask,
                      key_decode_t(best, fid_mask))


def _any(ro, rd, avoid, tmax, coef, blocks):
    n = ro.x.shape[0]
    p = ray_features(ro, rd)
    occ = torch.zeros(n, dtype=torch.bool, device=ro.x.device)
    for base, cnt in blocks:
        fc = face_chunk(n, cnt)
        for s in range(0, cnt, fc):
            rows = coef[base + s:base + min(s + fc, cnt)]
            valid, ts, _ = pair_hits(p, ro, rd, rows, s, avoid - base)
            occ = occ | torch.any(valid & (ts < INF) & (ts < tmax[:, None]),
                                  dim=1)
    return occ


def dense_any(ro, rd, avoid, tmax, coef):
    return _any(ro, rd, avoid, tmax, coef, [(0, coef.shape[0])])


def _blocks(f):
    return [(b, s, min(BLOCK_FACES, f - s))
            for b, s in enumerate(range(0, f, BLOCK_FACES))]


def _blocked_best(ro, rd, avoid, coef):
    n = ro.x.shape[0]
    dev = ro.x.device
    p = ray_features(ro, rd)
    best = torch.full((n,), KEY_MISS, dtype=torch.int32, device=dev)
    best_blk = torch.zeros((n,), dtype=torch.int32, device=dev)
    fc = face_chunk(n, BLOCK_FACES)
    for b, base, cnt in _blocks(coef.shape[0]):
        local_avoid = avoid - base
        kb = torch.full((n,), KEY_MISS, dtype=torch.int32, device=dev)
        for s in range(0, cnt, fc):
            rows = coef[base + s:base + min(s + fc, cnt)]
            kb = torch.minimum(kb, pair_keys(p, ro, rd, rows, s, local_avoid,
                                             KEY_FID_MASK))
        better = kb < best  # strict: an equal key keeps the lower block
        best = torch.where(better, kb, best)
        best_blk = torch.where(better, b, best_blk)
    return p, best, best_blk


def blocked_shade(ro, rd, avoid, coef, attr):
    p, best, blk = _blocked_best(ro, rd, avoid, coef)
    return winner_hit(p, rd, coef, attr, best != KEY_MISS,
                      blk * BLOCK_FACES + (best & KEY_FID_MASK),
                      key_decode_t(best, KEY_FID_MASK))


def blocked_closest(ro, rd, avoid, coef):
    p, best, blk = _blocked_best(ro, rd, avoid, coef)
    return winner_hit(p, rd, coef, None, best != KEY_MISS,
                      blk * BLOCK_FACES + (best & KEY_FID_MASK),
                      key_decode_t(best, KEY_FID_MASK))


def blocked_any(ro, rd, avoid, tmax, coef):
    return _any(ro, rd, avoid, tmax, coef,
                [(s, c) for _, s, c in _blocks(coef.shape[0])])


def _route(scene):
    r = route(scene.face_coef.shape[0], scene.accel)
    if r == 'brute':
        raise ValueError('the reference has no brute route')
    return r


def closest(scene, ro, rd, avoid):
    '''The nearest hit by the scene's route: Hit.'''
    if _route(scene) == 'blocked':
        return blocked_closest(ro, rd, avoid, scene.face_coef)
    return dense_closest(ro, rd, avoid, scene.face_coef)


def cast_shadow(scene, ro, rd, avoid, tmax):
    '''dispatch.cast_shadow on the plain casts: [N] bool.'''
    if _route(scene) == 'blocked':
        return blocked_any(ro, rd, avoid, tmax, scene.face_coef)
    return dense_any(ro, rd, avoid, tmax, scene.face_coef)


def cast_shaded(scene, ro, rd, avoid):
    '''dispatch.cast_shaded on the plain casts: (hit, unit normal, tex_s,
    tex_t, mtlid).'''
    if _route(scene) == 'blocked':
        hit, attrs = blocked_shade(ro, rd, avoid, scene.face_coef,
                                   scene.face_attr)
    else:
        hit, attrs = dense_shade(ro, rd, avoid, scene.face_coef,
                                 scene.face_attr)
    normal = vnormalize(V3(attrs[0], attrs[1], attrs[2]))
    mtlid = torch.where(hit.hit, torch.round(attrs[5]).to(torch.int32), -1)
    return hit, normal, attrs[3], attrs[4], mtlid
