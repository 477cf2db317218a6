'''
The PyTorch port's scene front-ends (ptina_tpu_torch.io) on the CPU,
against the JAX reference's (ptina_tpu.io):

  * readgltf on tests/test_gltf.py's triangle (.gltf and .glb) and on
    assets built here with torch_assets.write_gltf: data-URI, external .bin
    and .glb buffers, byteStride views, TRS and `matrix` node
    hierarchies, a missing NORMAL, uint8 / 16 / 32 indices and none, and
    PNG textures of every colour type: every returned array equal to
    JAX's (np.array_equal), materials equal;
  * a non-PNG image goes through PIL as in the reference, and raises an
    ImportError naming PIL where PIL is missing;
  * io._png decodes grey, grey+alpha, RGB, RGBA and palette PNGs with
    every filter type (and PIL's own files) exactly as PIL does (a
    palette image to its indices), encodes RGB / RGBA that PIL reads
    back, and refuses other bit depths and interlacing;
  * compose_multiple_meshes, readply (ASCII and binary, fan
    triangulation), writeobj / obj_mtlids and scenes.cornell_box_vertices
    equal to JAX's array for array;
  * a glTF asset rendered through the port's worker (device='cpu')
    against JAX's worker on the same file, at tests/test_torch_worker.py's
    tolerance (>= 98% of pixels within 1e-3 (1 + |ref|));
  * each example's main (ptina_tpu_torch.examples) at <= 32^2 on the
    CPU: finite images, the PNGs it writes, what it prints.
'''

import importlib
import io
import os
import struct
import sys
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

from ptina_tpu import worker as jworker
from ptina_tpu.io.multimesh import compose_multiple_meshes as jcompose
from ptina_tpu.io import readobj as jreadobj
from ptina_tpu.io.readgltf import readgltf as jreadgltf
from ptina_tpu.scenes import cornell_box_vertices as jcornell_box_vertices
from ptina_tpu_torch import worker
from ptina_tpu_torch.io import _png, readobj
from ptina_tpu_torch.io.multimesh import compose_multiple_meshes
from ptina_tpu_torch.io.readgltf import readgltf
from ptina_tpu_torch.scenes import (_blob_parts, _materials,
                                    cornell_box_vertices)
from test_gltf import _tri_gltf
import torch_assets

torch.set_num_threads(2)


def _same_gltf(got, ref):
    v, m, mats, images = got
    jv, jm, jmats, jimages = ref
    assert v.dtype == jv.dtype and m.dtype == jm.dtype
    np.testing.assert_array_equal(v, jv)
    np.testing.assert_array_equal(m, jm)
    assert mats == jmats
    assert len(images) == len(jimages)
    for a, b in zip(images, jimages):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize('binary', [False, True], ids=['gltf', 'glb'])
def test_readgltf_reference_triangle(binary, tmp_path):
    data, _ = _tri_gltf(binary=binary)
    path = str(tmp_path / ('s.glb' if binary else 's.gltf'))
    with open(path, 'wb') as f:
        f.write(data)
    got = readgltf(path)
    _same_gltf(got, jreadgltf(path))
    assert np.allclose(got[0][0, :3], [1, 2, 3], atol=1e-6)


def _pil_png(arr, mode):
    buf = io.BytesIO()
    img = Image.fromarray(arr, mode='L' if mode == 'P' else mode)
    if mode == 'P':
        img = img.convert('P', palette=Image.Palette.ADAPTIVE, colors=64)
    img.save(buf, format='PNG')
    return buf.getvalue()


def _rng_image(rng, mode, h=13, w=11):
    c = {'L': 1, 'LA': 2, 'RGB': 3, 'RGBA': 4, 'P': 1}[mode]
    arr = rng.randint(0, 256, size=(h, w, c)).astype(np.uint8)
    return arr[..., 0] if c == 1 else arr


def _small_prims(rng):
    '''Three primitives of a few faces each: no NORMAL with uint8
    indices; normals and UVs with no indices; normals with uint16.'''
    def tris(n):
        return rng.randn(n * 3, 3).astype(np.float32)
    p0 = tris(4)
    p1 = tris(3)
    p2 = tris(5)
    n2 = p2 / np.linalg.norm(p2, axis=1, keepdims=True)
    return [
        [dict(position=p0, indices=np.arange(12)[::-1].astype(np.uint8),
              material=0)],
        [dict(position=p1, normal=p1 / np.linalg.norm(p1, axis=1,
                                                      keepdims=True),
              texcoord=rng.rand(9, 2).astype(np.float32), material=1,
              interleave=True)],
        [dict(position=p2, normal=n2, indices=np.arange(15).astype(np.uint16)),
         dict(position=p2[:6], normal=n2[:6],
              indices=np.asarray([0, 1, 2, 3, 4, 5], np.uint32),
              material=1)],
    ]


def _small_nodes():
    return [
        {'translation': [0.5, -1.0, 2.0], 'scale': [2.0, 0.5, 1.0],
         'rotation': [0.0, 0.3826834, 0.0, 0.9238795], 'children': [1, 2],
         'mesh': 0},
        {'matrix': [1, 0, 0, 0, 0, 0, 1, 0, 0, -1, 0, 0, 3, 4, 5, 1],
         'mesh': 1},
        {'mesh': 2, 'children': [3]},
        {'rotation': [0.2, 0.1, 0.0, 0.9746794]},
    ]


def _case(name, tmp_path, rng):
    '''(path, asset written there) for each readgltf case.'''
    if name.startswith('monkey'):
        mode = name.split('_')[1]
        meshes, nodes, gl, _ = torch_assets.monkey_asset()
        path = str(tmp_path / ('monkey.glb' if mode == 'glb'
                               else 'monkey.gltf'))
        torch_assets.write_gltf(path, meshes, nodes, gl, mode=mode)
        return path
    if name == 'small_prims':
        path = str(tmp_path / 'small.gltf')
        gl, _ = torch_assets.gl_materials(_materials()[:2])
        torch_assets.write_gltf(path, _small_prims(rng), _small_nodes(), gl,
                              mode='external')
        return path
    if name == 'matball_png':
        _, png = torch_assets.ramp_png()
        meshes, nodes, gl, _, images = torch_assets.matball_asset(png)
        path = str(tmp_path / 'matball.glb')
        torch_assets.write_gltf(path, meshes, nodes, gl, images, mode='glb')
        return path
    # textures of every PNG colour type, the base colour and the
    # metallicRoughness textures of two materials
    pngs = [_pil_png(_rng_image(rng, m), m)
            for m in ('L', 'LA', 'RGB', 'RGBA', 'P')]
    gl = [{'pbrMetallicRoughness': {'baseColorTexture': {'index': 2},
                                    'metallicRoughnessTexture': {'index': 0}}},
          {'pbrMetallicRoughness': {'baseColorFactor': [1, 0.5, 0.25, 1],
                                    'baseColorTexture': {'index': 3},
                                    'metallicRoughnessTexture': {'index': 4}}}]
    path = str(tmp_path / 'textured.gltf')
    torch_assets.write_gltf(path, _small_prims(rng), _small_nodes(), gl, pngs)
    return path


@pytest.mark.parametrize('name', ['monkey_gltf', 'monkey_glb',
                                  'small_prims', 'matball_png',
                                  'textures_png'])
def test_readgltf_matches_reference(name, tmp_path):
    path = _case(name, tmp_path, np.random.RandomState(7))
    got = readgltf(path)
    _same_gltf(got, jreadgltf(path))
    assert np.isfinite(got[0]).all()


def test_readgltf_non_png_image_needs_pil(tmp_path, monkeypatch):
    buf = io.BytesIO()
    Image.fromarray(_rng_image(np.random.RandomState(1), 'RGB')) \
        .save(buf, format='JPEG')
    rng = np.random.RandomState(2)
    gl = [{'pbrMetallicRoughness': {'baseColorTexture': {'index': 0}}}]
    path = str(tmp_path / 'jpeg.gltf')
    torch_assets.write_gltf(path, _small_prims(rng), _small_nodes(), gl,
                          [buf.getvalue()])
    _same_gltf(readgltf(path), jreadgltf(path))
    monkeypatch.setitem(sys.modules, 'PIL', None)
    with pytest.raises(ImportError, match='PIL'):
        readgltf(path)


# ---------------------------------------------------------------- _png

_COLOR = {'L': (0, 1), 'LA': (4, 2), 'RGB': (2, 3), 'RGBA': (6, 4),
          'P': (3, 1)}


def _chunk(ctype, body):
    return (struct.pack('>I', len(body)) + ctype + body
            + struct.pack('>I', zlib.crc32(ctype + body)))


def _filtered_png(arr, mode, ftypes, interlace=0, depth=8):
    '''An 8-bit PNG of arr with filter ftypes[y % len(ftypes)] on row y,
    filtered here (the PNG specification's forward filters).'''
    color, bpp = _COLOR[mode]
    h, w = arr.shape[:2]
    rows = arr.reshape(h, -1).astype(np.int64)
    raw, prior = [], np.zeros_like(rows[0])
    for y in range(h):
        ftype = ftypes[y % len(ftypes)]
        cur = rows[y]
        a = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
        c = np.concatenate([np.zeros(bpp, np.int64), prior[:-bpp]])
        b = prior
        if ftype == 0:
            pred = 0
        elif ftype == 1:
            pred = a
        elif ftype == 2:
            pred = b
        elif ftype == 3:
            pred = (a + b) // 2
        else:
            p = a + b - c
            pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
            pred = np.where((pa <= pb) & (pa <= pc), a,
                            np.where(pb <= pc, b, c))
        raw.append(bytes([ftype]) + ((cur - pred) % 256).astype(np.uint8)
                   .tobytes())
        prior = cur
    out = _png.SIGNATURE + _chunk(b'IHDR', struct.pack(
        '>IIBBBBB', w, h, depth, color, 0, 0, interlace))
    if mode == 'P':
        out += _chunk(b'PLTE', bytes(range(256)) * 3)
    return (out + _chunk(b'IDAT', zlib.compress(b''.join(raw)))
            + _chunk(b'IEND', b''))


@pytest.mark.parametrize('ftypes', [(0,), (1,), (2,), (3,), (4,),
                                    (4, 3, 2, 1, 0)],
                         ids=['none', 'sub', 'up', 'average', 'paeth',
                              'mixed'])
@pytest.mark.parametrize('mode', list(_COLOR))
def test_png_decode_matches_pil(mode, ftypes):
    arr = _rng_image(np.random.RandomState(len(mode) * 10 + len(ftypes)),
                     mode)
    data = _filtered_png(arr, mode, ftypes)
    ref = np.array(Image.open(io.BytesIO(data)))
    got = _png.decode(data)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, arr)


@pytest.mark.parametrize('mode', list(_COLOR))
def test_png_decode_matches_pil_files(mode):
    '''PNGs written by PIL itself (its own filter choice).'''
    y, x = np.mgrid[0:40, 0:37]
    c = {'L': 1, 'LA': 2, 'RGB': 3, 'RGBA': 4, 'P': 1}[mode]
    arr = np.stack([(x * 7 + y * (3 + k)) % 256 for k in range(c)], -1) \
        .astype(np.uint8)
    data = _pil_png(arr[..., 0] if c == 1 else arr, mode)
    np.testing.assert_array_equal(_png.decode(data),
                                  np.array(Image.open(io.BytesIO(data))))


@pytest.mark.parametrize('channels', [3, 4])
def test_png_encode_reads_back_in_pil(channels, tmp_path):
    arr = np.random.RandomState(channels).randint(
        0, 256, size=(9, 14, channels)).astype(np.uint8)
    path = str(tmp_path / 'x.png')
    _png.write(path, arr)
    np.testing.assert_array_equal(np.array(Image.open(path)), arr)
    np.testing.assert_array_equal(_png.decode(_png.encode(arr)), arr)
    with pytest.raises(ValueError, match='uint8'):
        _png.encode(arr.astype(np.float32))


def test_png_refuses_what_it_does_not_decode():
    arr = _rng_image(np.random.RandomState(3), 'RGB')
    with pytest.raises(ValueError, match='interlaced'):
        _png.decode(_filtered_png(arr, 'RGB', (0,), interlace=1))
    buf = io.BytesIO()
    Image.fromarray(np.arange(64, dtype=np.uint16).reshape(8, 8) * 1000) \
        .save(buf, format='PNG')
    with pytest.raises(ValueError, match='bit depth 16'):
        _png.decode(buf.getvalue())
    data = bytearray(_filtered_png(arr, 'RGB', (0,)))
    data[-20] ^= 0xFF  # inside the IDAT chunk: its CRC fails
    with pytest.raises(ValueError, match='corrupt'):
        _png.decode(bytes(data))
    with pytest.raises(ValueError, match='not a PNG'):
        _png.decode(b'GIF89a')


# ------------------------------------------------- multimesh, PLY, OBJ

def test_compose_multiple_meshes_matches_reference():
    rng = np.random.RandomState(5)
    prims = []
    for k, (t, m) in enumerate([(True, 2), (False, None), (True, 0)]):
        f = 3 + k
        w = np.eye(4)
        w[:3, :3] = rng.randn(3, 3)
        w[:3, 3] = rng.randn(3)
        w[3] = [0.01, -0.02, 0.0, 1.0]  # a projective row
        prims.append((rng.randn(f, 3, 3), rng.randn(f, 3, 3),
                      rng.rand(f, 3, 2) if t else None, w, m))
    got, ref = compose_multiple_meshes(prims), jcompose(prims)
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def _ply_polygons(path, binary):
    '''A PLY with an extra vertex property of each kind, a quad, a
    pentagon and a triangle (fan-triangulated by the readers).'''
    v = np.random.RandomState(9).randn(7, 3).astype(np.float32)
    polys = [[0, 1, 2, 3], [2, 3, 4, 5, 6], [6, 0, 1]]
    head = (f'ply\nformat {"binary_little_endian" if binary else "ascii"} '
            f'1.0\ncomment polygons\nelement vertex {len(v)}\n'
            'property float x\nproperty float y\nproperty float z\n'
            'property double w\nproperty uchar red\nproperty short s\n'
            f'element face {len(polys)}\n'
            'property list uchar int vertex_indices\nend_header\n')
    with open(path, 'wb') as f:
        f.write(head.encode())
        for i, row in enumerate(v):
            if binary:
                f.write(struct.pack('<fffdBh', *row, 0.5 * i, i, -i))
            else:
                f.write(f'{row[0]} {row[1]} {row[2]} {0.5 * i} {i} '
                        f'{-i}\n'.encode())
        for p in polys:
            if binary:
                f.write(struct.pack(f'<B{len(p)}i', len(p), *p))
            else:
                f.write((' '.join(map(str, [len(p), *p])) + '\n').encode())


@pytest.mark.parametrize('binary', [False, True], ids=['ascii', 'binary'])
@pytest.mark.parametrize('source', ['polygons', 'highpoly_part'])
def test_readply_matches_reference(source, binary, tmp_path):
    path = str(tmp_path / 'm.ply')
    if source == 'polygons':
        _ply_polygons(path, binary)
    else:
        verts = _blob_parts(12, 6)[1][0]
        v, f = np.unique(verts[:, :3], axis=0, return_inverse=True)
        torch_assets.write_ply(path, v, f.reshape(-1, 3), binary)
    got, ref = readobj.readply(path), jreadobj.readply(path)
    assert got.keys() == ref.keys()
    for k in ('v', 'vt', 'vn', 'f'):
        assert got[k].dtype == ref[k].dtype
        np.testing.assert_array_equal(got[k], ref[k])
    np.testing.assert_array_equal(readobj.obj_to_vertices(got),
                                  jreadobj.obj_to_vertices(ref))
    if source == 'polygons':
        assert got['f'].shape[0] == 2 + 3 + 1


def test_writeobj_and_obj_mtlids_match_reference(tmp_path):
    (sv, sm), (bv, bm), (xv, xm) = _blob_parts(8, 4)
    verts = np.concatenate([sv, bv, xv])
    mtlids = np.concatenate([sm, bm, xm])
    obj = torch_assets.obj_of_vertices(verts, mtlids)
    paths = [str(tmp_path / 'port.obj'), str(tmp_path / 'ref.obj')]
    readobj.writeobj(paths[0], obj)
    jreadobj.writeobj(paths[1], obj)
    with open(paths[0]) as a, open(paths[1]) as b:
        assert a.read() == b.read()
    back = readobj.readobj(paths[0])
    np.testing.assert_array_equal(readobj.obj_to_vertices(back), verts)
    names = {'m0': 0, 'm1': 1, 'm3': 3}  # m2 unknown: -1 in both
    got = readobj.obj_mtlids(obj, names)
    np.testing.assert_array_equal(got, jreadobj.obj_mtlids(obj, names))
    np.testing.assert_array_equal(got, np.where(mtlids == 2, -1, mtlids))


def test_cornell_box_vertices_matches_reference():
    (v, m, mats), (jv, jm, jmats) = cornell_box_vertices(), \
        jcornell_box_vertices()
    np.testing.assert_array_equal(v, jv)
    np.testing.assert_array_equal(m, jm)
    assert v.dtype == jv.dtype and m.dtype == jm.dtype
    assert len(mats) == len(jmats)
    for a, b in zip(mats, jmats):
        for (fa, ta), (fb, tb) in zip(a, b):
            np.testing.assert_array_equal(np.asarray(fa), np.asarray(fb))
            assert ta == tb


# ---------------------------------------------------------- the worker

def _close(got, ref):
    return (np.abs(got - ref) <= 1e-3 * (1.0 + np.abs(ref))).all(-1).mean()


@pytest.mark.parametrize('name', ['monkey_glb', 'matball_png'])
def test_gltf_render_through_worker_matches_reference(name, tmp_path):
    '''The same file through each package's readgltf and worker, 8x8, two
    samples.'''
    path = _case(name, tmp_path, np.random.RandomState(0))
    for w, kw in ((jworker, {}), (worker, {'device': 'cpu'})):
        w.init(**kw)
        v, m, mats, images = (jreadgltf if w is jworker else readgltf)(path)
        torch_assets.load_worker(w, v, m, mats, images, res=8)
        w.render()
        w.render()
    ref, got = jworker.get_image(), worker.get_image()
    assert got.shape == ref.shape == (8, 8, 4)
    assert np.isfinite(got).all()
    assert _close(got[..., :3], ref[..., :3]) >= 0.98


_EXAMPLES = [
    ('smoke_render', dict(res=16, spp=2, scene_name='monkey'),
     ['smoke_monkey_16.png']),
    ('coverage', dict(res=16, spp=2), ['coverage_cornell.png']),
    ('matball', dict(res=16, spp=2), ['matball.png']),
    ('metropolis', dict(res=16, passes=2, steps=2),
     ['metropolis_cornell.png']),
    ('objloader', dict(res=16, spp=2), []),
    ('interactive', dict(res=32, start_pixel_size=4, final_samples=3,
                         frames=2),
     [f'refine_f{f}_{s}.png' for f in (0, 1)
      for s in ('final', 's0', 's1', 's2')]),
]


@pytest.mark.parametrize('name,kw,pngs', _EXAMPLES,
                         ids=[e[0] for e in _EXAMPLES])
def test_example_main_on_the_cpu(name, kw, pngs, tmp_path, capsys):
    mod = importlib.import_module(f'ptina_tpu_torch.examples.{name}')
    img = mod.main(device='cpu', out_dir=str(tmp_path), **kw)
    out = capsys.readouterr().out
    assert sorted(os.listdir(tmp_path)) == sorted(pngs)  # the OBJ is removed
    for png in pngs:
        with open(tmp_path / png, 'rb') as f:
            assert np.array_equal(_png.decode(f.read()),
                                  np.array(Image.open(tmp_path / png)))
    if img is not None:
        assert np.isfinite(img).all() and img[..., :3].mean() > 0
    if name == 'smoke_render':
        assert f'mean {str(img[..., :3].mean())} nan False' in out
    if name == 'metropolis':
        assert 'pass 1' in out

