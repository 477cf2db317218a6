'''
glTF 2.0 scene reader (pure Python / numpy).

Reference: ptina_tpu/io/readgltf.py (reference ptina/tools/readgltf.py),
copied with its semantics: .gltf files with data-URI or external
buffers, and binary .glb containers; byteStride views; node TRS or
`matrix` hierarchies baked into positions and normals; flat normals
where NORMAL is absent; every primitive concatenated into the flat
[F*3, 8] layout (io.multimesh); pbrMetallicRoughness factors and
textures, the metallicRoughness texture bound to both metallic and
roughness.  Returns (vertices, mtlids, materials, images) as the
reference does, for worker.load_model / load_materials / load_images.

One deliberate difference: images.  A PNG decodes through io._png (the
machine with the card has no PIL), to the array PIL would give.  Any
other image type keeps the reference's `from PIL import Image`, imported
when such an image is met, and raises ImportError naming PIL where PIL
is not installed.
'''

import json
import os.path
import struct
from base64 import b64decode
from io import BytesIO

import numpy as np

from ptina_tpu_torch.io import _png, matrix
from ptina_tpu_torch.io.multimesh import compose_multiple_meshes

__all__ = ['readgltf']

_COMPONENT_DTYPES = {
    0x1400: np.int8, 0x1401: np.uint8, 0x1402: np.int16, 0x1403: np.uint16,
    0x1404: np.int32, 0x1405: np.uint32, 0x1406: np.float32,
}
_TYPE_COUNTS = {'SCALAR': 1, 'VEC2': 2, 'VEC3': 3, 'VEC4': 4,
                'MAT2': 4, 'MAT3': 9, 'MAT4': 16}


def _load_uri(uri, basedir):
    if uri.startswith('data:'):
        return b64decode(uri[uri.index('base64,') + 7:].encode('ascii'))
    if not os.path.isabs(uri):
        uri = os.path.join(basedir, uri)
    with open(uri, 'rb') as f:
        return f.read()


def _parse_glb(data):
    '''Binary container: 12-byte header + JSON chunk + optional BIN chunk.'''
    magic, version, _length = struct.unpack('<III', data[:12])
    assert magic == 0x46546C67, 'not a GLB file'
    off = 12
    gltf_json, bin_chunk = None, None
    while off < len(data):
        clen, ctype = struct.unpack('<II', data[off:off + 8])
        chunk = data[off + 8: off + 8 + clen]
        if ctype == 0x4E4F534A:  # 'JSON'
            gltf_json = json.loads(chunk.decode('utf-8'))
        elif ctype == 0x004E4942:  # 'BIN'
            bin_chunk = chunk
        off += 8 + clen
    return gltf_json, bin_chunk


def _decode_image(data):
    '''Image file bytes -> np.array(PIL.Image.open(...)) (module
    docstring).'''
    if data[:len(_png.SIGNATURE)] == _png.SIGNATURE:
        return _png.decode(data)
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError('readgltf: this glTF image is not a PNG; decoding '
                          'it needs PIL (Pillow), which is not installed') \
            from e
    with BytesIO(data) as f:
        return np.array(Image.open(f))


def readgltf(path):
    basedir = os.path.dirname(path)
    bin_chunk = None
    if path.endswith('.glb'):
        with open(path, 'rb') as f:
            model, bin_chunk = _parse_glb(f.read())
    else:
        with open(path) as f:
            model = json.load(f)

    buffers = []
    for buf in model.get('buffers', []):
        if 'uri' in buf:
            buffers.append(_load_uri(buf['uri'], basedir))
        else:
            assert bin_chunk is not None, 'bufferless buffer needs GLB BIN chunk'
            buffers.append(bin_chunk)

    views = []
    for bv in model.get('bufferViews', []):
        off = bv.get('byteOffset', 0)
        views.append((buffers[bv['buffer']], off, bv['byteLength'],
                      bv.get('byteStride')))

    def accessor(idx):
        acc = model['accessors'][idx]
        dtype = _COMPONENT_DTYPES[acc['componentType']]
        ncomp = _TYPE_COUNTS[acc['type']]
        count = acc['count']
        buf, voff, vlen, stride = views[acc['bufferView']]
        aoff = acc.get('byteOffset', 0)
        itemsize = np.dtype(dtype).itemsize * ncomp
        if stride and stride != itemsize:
            raw = np.frombuffer(buf, np.uint8, vlen, voff)
            rows = np.lib.stride_tricks.as_strided(
                raw[aoff:], shape=(count, itemsize), strides=(stride, 1))
            arr = rows.copy().view(dtype).reshape(count, ncomp)
        else:
            arr = np.frombuffer(buf, dtype, count * ncomp, voff + aoff)
            arr = arr.reshape(count, ncomp)
        return np.ascontiguousarray(arr)

    images = []
    for img in model.get('images', []):
        if 'uri' in img:
            data = _load_uri(img['uri'], basedir)
        else:
            buf, off, length, _ = views[img['bufferView']]
            data = bytes(np.frombuffer(buf, np.uint8, length, off))
        images.append(np.swapaxes(_decode_image(data), 0, 1))  # reference axis order

    materials = []
    for mat in model.get('materials', []):
        pbr = mat.get('pbrMetallicRoughness', {})
        b = pbr.get('baseColorFactor', [1, 1, 1, 1])
        bt = pbr.get('baseColorTexture')
        bt = model['textures'][bt['index']]['source'] if bt else -1
        m = pbr.get('metallicFactor', 1.0)
        r = pbr.get('roughnessFactor', 1.0)
        mrt = pbr.get('metallicRoughnessTexture')
        mrt = model['textures'][mrt['index']]['source'] if mrt else -1
        materials.append(((b, bt), (m, mrt), (r, mrt)))

    prims = []

    def walk(node_idx, world):
        node = model['nodes'][node_idx]
        local = matrix.identity()
        if 'matrix' in node:
            local = np.asarray(node['matrix'], float).reshape(4, 4).T
        else:
            if 'scale' in node:
                local = matrix.scale(node['scale']) @ local
            if 'rotation' in node:
                local = matrix.quaternion(node['rotation']) @ local
            if 'translation' in node:
                local = matrix.translate(node['translation']) @ local
        world = world @ local
        if 'mesh' in node:
            for prim in model['meshes'][node['mesh']]['primitives']:
                attrs = prim['attributes']
                p = accessor(attrs['POSITION']).astype(np.float64)
                n = (accessor(attrs['NORMAL']).astype(np.float64)
                     if 'NORMAL' in attrs else None)
                t = (accessor(attrs['TEXCOORD_0']).astype(np.float64)
                     if 'TEXCOORD_0' in attrs else None)
                if 'indices' in prim:
                    f = accessor(prim['indices']).reshape(-1)
                else:
                    f = np.arange(p.shape[0])
                p = p[f]
                if n is None:
                    flat = np.cross(p[1::3] - p[0::3], p[2::3] - p[0::3])
                    flat /= np.maximum(np.linalg.norm(flat, axis=1,
                                                      keepdims=True), 1e-300)
                    n = np.repeat(flat, 3, axis=0)
                else:
                    n = n[f]
                t = t[f] if t is not None else None
                prims.append((p.reshape(-1, 3, 3), n.reshape(-1, 3, 3),
                              None if t is None else t.reshape(-1, 3, 2),
                              world, prim.get('material', -1)))
        for child in node.get('children', []):
            walk(child, world)

    scene = model['scenes'][model.get('scene', 0)]
    for node_idx in scene['nodes']:
        walk(node_idx, matrix.identity())

    vertices, mtlids = compose_multiple_meshes(prims)
    return vertices, mtlids, materials, images
