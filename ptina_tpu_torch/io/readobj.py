'''
Wavefront OBJ reader (host side, numpy only).

Reference: ptina_tpu/io/readobj.py (reference ptina/tools/readobj.py),
copied: readobj returns a dict with vertex arrays and an [F, 3, 3] face
index array (v, vt, vn per corner), triangulating polygons as fans, with
helpers to generate flat normals when missing and to flatten the dict
into make_scene's [F * 3, 8] vertices (worker.load_model).  The
reference's writeobj, obj_mtlids and PLY reader have no caller in the
port and are not copied.
'''

import numpy as np

__all__ = ['readobj', 'obj_flat_normals', 'obj_to_vertices']


def readobj(path, orient='xyz', scale=None):
    '''Parse an OBJ file.  Returns dict with:
      v [NV,3], vt [NT,2], vn [NN,3] float arrays (with a zero row 0
      fallback when the file has no texcoords/normals),
      f [F,3,3] int indices (corner -> (v, vt, vn), 0-based),
      usemtl: list of (face_start, material_name),
      mtllib: str or None.

    orient: permutation like 'xZy' — upper-case flips the axis
    (reference: ptina/tools/readobj.py orientation handling).
    scale: float, or 'auto' to normalize the longest AABB side to 2.
    '''
    v, vt, vn, faces = [], [], [], []
    usemtl, mtllib = [], None
    with open(path) as fp:
        for line in fp:
            line = line.strip()
            if not line or line.startswith('#'):
                continue
            parts = line.split()
            tag, args = parts[0], parts[1:]
            if tag == 'v':
                v.append([float(x) for x in args[:3]])
            elif tag == 'vt':
                vt.append([float(x) for x in args[:2]])
            elif tag == 'vn':
                vn.append([float(x) for x in args[:3]])
            elif tag == 'f':
                corners = []
                for c in args:
                    idx = c.split('/')
                    vi = int(idx[0])
                    ti = int(idx[1]) if len(idx) > 1 and idx[1] else 0
                    ni = int(idx[2]) if len(idx) > 2 and idx[2] else 0
                    corners.append((vi, ti, ni))
                # fan-triangulate polygons (reference readobj.py:8-18)
                for k in range(1, len(corners) - 1):
                    faces.append([corners[0], corners[k], corners[k + 1]])
            elif tag == 'usemtl':
                usemtl.append((len(faces), args[0]))
            elif tag == 'mtllib':
                mtllib = args[0]

    v = np.asarray(v, np.float32) if v else np.zeros((1, 3), np.float32)
    vt = np.asarray(vt, np.float32) if vt else np.zeros((1, 2), np.float32)
    vn = np.asarray(vn, np.float32) if vn else np.zeros((1, 3), np.float32)
    f = np.asarray(faces, np.int64) if faces else np.zeros((0, 3, 3), np.int64)
    if f.size:
        # OBJ indices are 1-based; negatives are relative; 0 means missing
        # (missing slots were recorded as 0 and map to the zero fallback row)
        for a, n in ((0, len(v)), (1, len(vt)), (2, len(vn))):
            idx = f[:, :, a]
            f[:, :, a] = np.where(idx > 0, idx - 1, np.where(idx < 0, n + idx, 0))

    if orient != 'xyz':
        perm = [ord(c.lower()) - ord('x') for c in orient]
        flip = [c.isupper() for c in orient]
        for arr in (v, vn):
            arr[:] = arr[:, perm]
            for a, fl in enumerate(flip):
                if fl:
                    arr[:, a] = -arr[:, a]

    if scale == 'auto':
        size = (v.max(0) - v.min(0)).max()
        if size > 0:
            v *= 2.0 / size
    elif scale:
        v *= scale

    return dict(v=v, vt=vt, vn=vn, f=f.astype(np.int32),
                usemtl=usemtl, mtllib=mtllib)


def obj_flat_normals(obj):
    '''Fill vn with per-face flat normals when the OBJ has none
    (reference: readobj.py:212-222 objmknorm).'''
    f = obj['f']
    tri = obj['v'][f[:, :, 0]]
    n = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    n /= np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-12)
    obj = dict(obj)
    obj['vn'] = n.astype(np.float32)
    fidx = np.arange(f.shape[0], dtype=np.int32)
    f = f.copy()
    f[:, :, 2] = fidx[:, None]
    obj['f'] = f
    return obj


def obj_to_vertices(obj):
    '''Flatten the dict format into the [F*3, 8] vertex layout
    (pos3 + nrm3 + uv2; reference layout ptina/model.py:62-74).'''
    f = obj['f']
    if not np.any(f[:, :, 2]) and obj['vn'].shape[0] <= 1:
        obj = obj_flat_normals(obj)
        f = obj['f']
    verts = obj['v'][f[:, :, 0]].reshape(-1, 3)
    coors = obj['vt'][f[:, :, 1]].reshape(-1, 2)
    norms = obj['vn'][f[:, :, 2]].reshape(-1, 3)
    return np.concatenate([verts, norms, coors], axis=1).astype(np.float32)
