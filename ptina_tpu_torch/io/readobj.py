'''
Wavefront OBJ reader (host side, numpy only).

Reference: ptina_tpu/io/readobj.py (reference ptina/tools/readobj.py),
copied: readobj returns a dict with vertex arrays and an [F, 3, 3] face
index array (v, vt, vn per corner), triangulating polygons as fans, with
helpers to map usemtl ranges to per-face material ids, to generate flat
normals when missing and to flatten the dict into make_scene's
[F * 3, 8] vertices (worker.load_model); writeobj writes the dict back
out, and readply reads ASCII and binary little-endian PLY files into the
same dict, element by element in Python as the reference does.
'''

import numpy as np

__all__ = ['readobj', 'writeobj', 'readply', 'obj_mtlids',
           'obj_flat_normals', 'obj_to_vertices']


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


def writeobj(path, obj):
    '''Write the dict format back out (reference: readobj.py writeobj).'''
    with open(path, 'w') as fp:
        for x in obj['v']:
            print('v', *x, file=fp)
        for x in obj['vt']:
            print('vt', *x, file=fp)
        for x in obj['vn']:
            print('vn', *x, file=fp)
        for face in obj['f']:
            corners = ['/'.join(str(i + 1) for i in c) for c in face]
            print('f', *corners, file=fp)


def obj_mtlids(obj, name_to_id):
    '''Per-face material ids from usemtl ranges
    (reference: readobj.py:155-170).  Unknown names map to -1.'''
    nfaces = obj['f'].shape[0]
    mtlids = -np.ones(nfaces, np.int32)
    spans = obj['usemtl'] + [(nfaces, None)]
    for (start, name), (end, _) in zip(spans[:-1], spans[1:]):
        mtlids[start:end] = name_to_id.get(name, -1)
    return mtlids


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


def readply(path):
    """Minimal ASCII/binary-LE PLY reader (reference: readobj.py:225-233
    reads vertex/face elements).  Returns the same dict format as
    readobj (positions + faces, flat normals generated on demand)."""
    with open(path, 'rb') as fp:
        assert fp.readline().strip() == b'ply'
        fmt = fp.readline().split()[1]
        counts = []   # (element name, count, [(type, name), ...])
        props = None
        for line in iter(fp.readline, b''):
            tok = line.split()
            if tok[0] == b'comment':
                continue
            if tok[0] == b'element':
                props = []
                counts.append((tok[1].decode(), int(tok[2]), props))
            elif tok[0] == b'property':
                props.append((b' '.join(tok[1:-1]).decode(), tok[-1].decode()))
            elif tok[0] == b'end_header':
                break
        verts, faces = [], []
        if fmt == b'ascii':
            for name, cnt, pr in counts:
                for _ in range(cnt):
                    vals = fp.readline().split()
                    if name == 'vertex':
                        verts.append([float(x) for x in vals[:3]])
                    elif name == 'face':
                        idx = [int(x) for x in vals[1:1 + int(vals[0])]]
                        for k in range(1, len(idx) - 1):  # fan-triangulate
                            faces.append([idx[0], idx[k], idx[k + 1]])
        else:
            assert fmt == b'binary_little_endian', f'unsupported {fmt}'
            _sz = {'char': 1, 'uchar': 1, 'int8': 1, 'uint8': 1,
                   'short': 2, 'ushort': 2, 'int16': 2, 'uint16': 2,
                   'int': 4, 'uint': 4, 'int32': 4, 'uint32': 4,
                   'float': 4, 'float32': 4, 'double': 8, 'float64': 8}
            import struct
            _fc = {1: 'b', 2: 'h', 4: 'i', 8: 'q'}
            for name, cnt, pr in counts:
                for _ in range(cnt):
                    if name == 'vertex':
                        row = []
                        for typ, _pn in pr:
                            sz = _sz[typ]
                            raw = fp.read(sz)
                            if typ in ('float', 'float32'):
                                row.append(struct.unpack('<f', raw)[0])
                            elif typ in ('double', 'float64'):
                                row.append(struct.unpack('<d', raw)[0])
                            else:
                                row.append(int.from_bytes(raw, 'little', signed=not typ.startswith('u')))
                        verts.append(row[:3])
                    elif name == 'face':
                        typ = pr[0][0].split()
                        cnt_t, idx_t = typ[1], typ[2]
                        n = int.from_bytes(fp.read(_sz[cnt_t]), 'little')
                        idx = [int.from_bytes(fp.read(_sz[idx_t]), 'little')
                               for _ in range(n)]
                        for k in range(1, len(idx) - 1):
                            faces.append([idx[0], idx[k], idx[k + 1]])
    v = np.asarray(verts, np.float32).reshape(-1, 3)
    f3 = np.zeros((len(faces), 3, 3), np.int32)
    f3[:, :, 0] = np.asarray(faces, np.int32)
    return dict(v=v, vt=np.zeros((1, 2), np.float32),
                vn=np.zeros((1, 3), np.float32), f=f3,
                usemtl=[], mtllib=None)
