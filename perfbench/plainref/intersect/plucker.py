'''
The casts' hit contract as pure torch: the plain twin of the `__device__`
helpers in csrc/plucker.cuh, and the plumbing the dense and blocked casts
share (operand checks, face chunking, the winner's Hit).

Reference: ptina_tpu/intersect/plucker.py.  The reference evaluates the
contract as one [5F, 14] @ [14, N] MXU matmul per face chunk plus a
division-free tail.  The port keeps WHAT it computes and drops the matmul
layout: each face is one row of 16 coefficients (pack_faces), built once
per scene, and each (ray, face) pair evaluates

    U  = cu . p            V = cv . p          (p: the ray's 6 Plücker
    B  = m0.xyz . d        An = -(m0 . [o, 1])  coordinates, ray_features)
    W  = B - U - V
    valid = sign(U) == sign(V) == sign(W) == sign(B)   (sign-BIT test)
            and An * B > 0 and face != avoid
    t  = An * (1 / B),  a hit only while t < INF (the far clip)
    key = (bits(t) & ~fid_mask) | face id,  nearest hit = min(key)

so the nearest hit wins with ties to the lowest face id on the key's
2^-12 relative t grid (2^-10 above 2048 faces, key_mask_for).  A miss is
KEY_MISS, whose t bits decode to NaN.  The winner's u, v are rebuilt per
ray from its coefficient row: u = (cu . p) * min(1 / B, 1e18).

Contract notes carried over from the reference:
  * W is B - U - V here, a separate dot product there; the two differ by
    rounding only, which moves the verdict only for rays that graze an
    edge to within an ulp.
  * grazing rays with 0 < |B| < 1e-6 may hit, where intersect/brute.py
    rejects them (reference plucker.py:222-227).
'''

import torch

from perfbench.plainref.intersect.brute import Hit
from perfbench.plainref.mathutils import INF

__all__ = ['KEY_FID_MASK', 'KEY_MISS', 'N_COEF', 'N_ATTR', 'key_mask_for',
           'pack_faces', 'ray_features', 'pair_side', 'pair_hits',
           'pair_keys',
           'key_decode_t', 'winner_uv', 'winner_hit', 'check_rays',
           'check_table', 'face_chunk']

KEY_FID_MASK = 2047
KEY_MISS = 2 ** 31 - 1
N_COEF = 16  # per-face coefficients: cu (6), cv (6), m0 (4)
N_ATTR = 18  # 3 corners x (nrm3, uv2, mtlid)

# elements per [N, Fc] temporary of the plain casts (bounds their memory)
_PLAIN_PAIRS = 1 << 24

_IJ = ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))


def key_mask_for(nfaces):
    '''Smallest all-ones face-id mask covering `nfaces` ids, at least the
    default 11 bits.'''
    m = KEY_FID_MASK
    while m + 1 < nfaces:
        m = (m << 1) | 1
    return m


def _anti(ma, mb):
    # C_ij = ma_i mb_j - mb_i ma_j for i < j
    return torch.stack([ma[:, i] * mb[:, j] - mb[:, i] * ma[:, j]
                        for i, j in _IJ], dim=1)


def pack_faces(tri_w2b, tri_attrs=None):
    '''The per-face tables the casts read, computed once per scene:
    coef [F, 16] = cu (6), cv (6), m0 (4) and attr [F, 18] = the corner-
    major attribute rows of tri_attrs [18, F], one face per row (the
    winner's corners are one contiguous load; None without tri_attrs).'''
    m0, m1, m2 = tri_w2b[:, 0], tri_w2b[:, 1], tri_w2b[:, 2]
    coef = torch.cat([_anti(m1, m0), _anti(m2, m0), m0], dim=1)
    attr = None if tri_attrs is None else tri_attrs.t().contiguous()
    return coef.contiguous(), attr


def ray_features(ro, rd):
    '''The 6 Plücker coordinates of the (o, 1) / (d, 0) pair in the
    reference's (i < j) order, as a list of [N] rows.'''
    return [ro.x * rd.y - ro.y * rd.x, ro.x * rd.z - ro.z * rd.x, -rd.x,
            ro.y * rd.z - ro.z * rd.y, -rd.y, -rd.z]


def _dot_rows(c, rows):
    '''sum_k c[:, k] x rows[k] as an [N, Fc] table, left to right.'''
    acc = rows[0][:, None] * c[None, :, 0]
    for k in range(1, len(rows)):
        acc = acc + rows[k][:, None] * c[None, :, k]
    return acc


def _i32(x):
    return x.view(torch.int32)


def pair_side(p, rd, coef):
    '''The sign-bit test of every (ray, face) pair of one face chunk
    (csrc/plucker.cuh face_side): (side [N, Fc] int32, >= 0 where the
    pair passes; B [N, Fc]).'''
    u = _dot_rows(coef[:, 0:6], p)
    v = _dot_rows(coef[:, 6:12], p)
    b = _dot_rows(coef[:, 12:15], [rd.x, rd.y, rd.z])
    w = b - u - v
    bi = _i32(b)
    return (_i32(u) ^ bi) | (_i32(v) ^ bi) | (_i32(w) ^ bi), b


def pair_hits(p, ro, rd, coef, base, avoid):
    '''Every (ray, face) pair of one face chunk: (valid [N, Fc], t [N, Fc],
    face ids [Fc]).  coef: [Fc, 16] rows of faces base .. base + Fc - 1.'''
    side, b = pair_side(p, rd, coef)
    an = -(_dot_rows(coef[:, 12:15], [ro.x, ro.y, ro.z])
           + coef[None, :, 15])
    fids = base + torch.arange(coef.shape[0], dtype=torch.int32,
                               device=coef.device)
    valid = (side >= 0) & (an * b > 0.0) & (fids[None, :] != avoid[:, None])
    return valid, an * (1.0 / b), fids


def pair_keys(p, ro, rd, coef, base, avoid, fid_mask):
    '''Per-ray minimum packed key over one face chunk, [N] int32.'''
    valid, ts, fids = pair_hits(p, ro, rd, coef, base, avoid)
    key = (_i32(ts) & ~fid_mask) | fids[None, :]
    key = torch.where(valid & (ts < INF), key, KEY_MISS)
    return torch.amin(key, dim=1)


def key_decode_t(key, fid_mask=KEY_FID_MASK):
    '''Winner t from the key's own bits; KEY_MISS decodes to NaN.'''
    return (key & ~fid_mask).view(torch.float32)


def winner_uv(p, rd, cw):
    '''u, v of each ray's winner from its coefficient row cw [N, 16].'''
    uw = cw[:, 0] * p[0]
    vw = cw[:, 6] * p[0]
    for k in range(1, 6):
        uw = uw + cw[:, k] * p[k]
        vw = vw + cw[:, 6 + k] * p[k]
    bw = cw[:, 12] * rd.x + cw[:, 13] * rd.y + cw[:, 14] * rd.z
    rb = torch.clamp_max(1.0 / bw, 1e18)
    return uw * rb, vw * rb


def winner_hit(p, rd, coef, attr, hitm, w, t):
    '''The plain casts' result from each ray's winner: w [N] face ids of
    the whole table and t [N] decoded where hitm, anything elsewhere.
    Returns the Hit and, given attr, the interpolated attributes [6, N]
    (zeros on a miss).'''
    w = torch.where(hitm, w, 0).long()
    u, v = winner_uv(p, rd, coef[w])
    hit = Hit(hit=hitm, t=torch.where(hitm, t, INF),
              index=torch.where(hitm, w.to(torch.int32), -1),
              u=torch.where(hitm, u, 0.0), v=torch.where(hitm, v, 0.0))
    if attr is None:
        return hit
    a = attr[w]  # [N, 18] corner-major: a[:, k * 6 + c]
    w0 = 1.0 - u - v
    att = (a[:, 0:6] * w0[:, None] + a[:, 6:12] * u[:, None]
           + a[:, 12:18] * v[:, None])
    return hit, torch.where(hitm[None, :], att.t(), 0.0)


def face_chunk(n, f):
    '''Faces per [N, Fc] temporary of a plain cast.'''
    return max(1, min(f, _PLAIN_PAIRS // max(n, 1)))


def check_rays(ro, rd, avoid, extra=()):
    '''Validate the [N] f32 ray rows (and extra rows) and the [N] i32
    avoid row; returns (N, device).'''
    rows = (ro.x, ro.y, ro.z, rd.x, rd.y, rd.z) + tuple(extra)
    n = ro.x.shape[0]
    dev = ro.x.device
    for r in rows:
        if r.dtype != torch.float32 or r.dim() != 1 or r.shape[0] != n:
            raise ValueError('ray rows must be [N] float32')
        if r.device != dev:
            raise ValueError('ray rows must share one device')
    if avoid.dtype != torch.int32 or avoid.shape != (n,) \
            or avoid.device != dev:
        raise ValueError('avoid must be [N] int32 on the rays\' device')
    return n, dev


def check_table(t, cols, dev, name, max_faces):
    '''Validate a per-face [F, cols] f32 table of at most max_faces rows
    on the rays' device.'''
    if t.dtype != torch.float32 or t.dim() != 2 or t.shape[1] != cols:
        raise ValueError(f'{name} must be [F, {cols}] float32')
    if t.device != dev:
        raise ValueError(f'{name} must lie on the rays\' device')
    if t.shape[0] > max_faces:
        raise ValueError(f'{t.shape[0]} faces exceed the cast\'s '
                         f'{max_faces}')
