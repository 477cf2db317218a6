'''
Compose multiple meshes with per-object world transforms into the flat
[F*3, 8] vertex layout + per-face material ids.

Reference: ptina_tpu/io/multimesh.py (reference ptina/multimesh.py:9-87),
copied: numpy only, transformed in float64 and cast to float32 at the
end, so its arrays equal the reference's.
'''

import numpy as np

__all__ = ['compose_multiple_meshes']


def compose_multiple_meshes(primitives):
    '''primitives: list of (p [F,3,3], n [F,3,3], t [F,3,2] or None,
    world [4,4], mtlid int or None).  Returns (vertices [F*3, 8],
    mtlids [F]).  Positions are transformed by world (homogeneous),
    normals by the linear part and renormalized.'''
    out_v, out_m = [], []
    for p, n, t, w, m in primitives:
        assert p is not None and n is not None and w is not None
        p = np.asarray(p, np.float64).reshape(-1, 3)
        n = np.asarray(n, np.float64).reshape(-1, 3)
        t = (np.zeros((p.shape[0], 2)) if t is None
             else np.asarray(t, np.float64).reshape(-1, 2))
        assert p.shape[0] == n.shape[0] == t.shape[0]
        w = np.asarray(w, np.float64)

        ph = np.concatenate([p, np.ones((p.shape[0], 1))], 1) @ w.T
        p = ph[:, :3] / ph[:, 3:4]
        n = n @ w[:3, :3].T
        n /= np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-300)

        a = np.concatenate([p, n, t], axis=1)
        assert a.shape[0] % 3 == 0
        out_v.append(a)
        out_m.append(np.full(a.shape[0] // 3, -1 if m is None else m))

    vertices = np.concatenate(out_v, 0).astype(np.float32)
    mtlids = np.concatenate(out_m, 0).astype(np.int32)
    assert len(vertices) == len(mtlids) * 3
    return vertices, mtlids
