'''
Hygiene of the PyTorch port package (ptina_tpu_torch): it never imports
JAX, the JAX package or its root bench.py, it imports on a machine with
neither nvcc nor a GPU (its kernel library is built only on first use on
the card), nor Blender's bpy, nor PIL; its entry points default to the
card with no CPU fallback; every public name of the reference's modules
has its counterpart in the port's mirror of that module, but the TPU-only
names ROADMAP.md lists under "Do not port"; and every root script
(examples/*.py and bench.py) has its port, with a main.
'''

import ast
import importlib
import inspect
import os
import subprocess
import sys

import pytest
import torch

from ptina_tpu_torch.engine.mlt import mlt_init
from ptina_tpu_torch.film import new_film
from ptina_tpu_torch.sampling import sobol
from ptina_tpu_torch.scenes import cornell_box

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, 'ptina_tpu_torch')


def _py_files():
    for dirpath, _, names in os.walk(PKG):
        for n in sorted(names):
            if n.endswith('.py'):
                yield os.path.join(dirpath, n)


@pytest.mark.parametrize('path', sorted(_py_files()),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_imports(path):
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or '']
        else:
            continue
        for name in names:
            top = name.split('.')[0]
            # `bench` is the JAX package's root benchmark script
            assert top not in ('jax', 'jaxlib', 'flax', 'ptina_tpu',
                               'bench'), f'{path} imports {name}'


def test_imports_without_jax_nvcc_or_gpu():
    '''A fresh interpreter with no CUDA toolkit on PATH imports every
    module of the port and pulls in no JAX.'''
    code = (
        'import sys\n'
        'import ptina_tpu_torch.engine.path, ptina_tpu_torch.scenes\n'
        'import ptina_tpu_torch.intersect.dispatch\n'
        'import ptina_tpu_torch.worker, ptina_tpu_torch.engine\n'
        'import ptina_tpu_torch.checkpoint, ptina_tpu_torch.tone\n'
        'import ptina_tpu_torch.utils.trace, ptina_tpu_torch.io.readobj\n'
        'import ptina_tpu_torch.diff, ptina_tpu_torch.blender\n'
        'import ptina_tpu_torch.io.readgltf, ptina_tpu_torch.io.multimesh\n'
        'import ptina_tpu_torch.examples.smoke_render\n'
        'import ptina_tpu_torch.examples.coverage\n'
        'import ptina_tpu_torch.examples.matball\n'
        'import ptina_tpu_torch.examples.metropolis\n'
        'import ptina_tpu_torch.examples.objloader\n'
        'import ptina_tpu_torch.examples.interactive\n'
        'import ptina_tpu_torch.examples.benchmark, ptina_tpu_torch.bench\n'
        'from ptina_tpu_torch.intersect import blocked, dense_cast\n'
        'from ptina_tpu_torch.engine import fused\n'
        'for m in (dense_cast, fused, blocked):\n'
        '    assert m.build_library.cache_info().currsize == 0\n'
        'bad = [m for m in sys.modules if m.split(".")[0] in '
        '("jax", "flax", "ptina_tpu", "bpy", "gpu", "PIL")]\n'
        'assert not bad, bad\n')
    env = dict(os.environ, PATH='/usr/bin:/bin', CUDA_VISIBLE_DEVICES='')
    env.pop('CUDA_HOME', None)
    out = subprocess.run([sys.executable, '-c', code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


# the public entry points that build tensors: they run on the card unless
# the caller asks for the CPU
CARD_DEFAULT = [
    ('scenes', 'cornell_box'), ('scenes', 'cornell_monkey'),
    ('scenes', 'cornell_highpoly'), ('scenes', 'envlight_scene'),
    ('scenes', 'matball'), ('scene', 'make_scene'),
    ('scene', 'scene_from_numpy'), ('scene', 'make_materials'),
    ('scene', 'make_textures'), ('scene', 'make_lights'),
    ('film', 'new_film'), ('engine.path', 'pixel_grid'),
    ('engine.mlt', 'mlt_init'), ('worker', 'init'),
    ('checkpoint', 'mlt_state_from_numpy'), ('sampling', 'uniform_grid'),
    ('examples.smoke_render', 'main'), ('examples.coverage', 'main'),
    ('examples.matball', 'main'), ('examples.metropolis', 'main'),
    ('examples.objloader', 'main'), ('examples.interactive', 'main'),
    ('examples.benchmark', 'main')]


@pytest.mark.parametrize('module,name', CARD_DEFAULT,
                         ids=lambda x: x)
def test_entry_points_default_to_the_card(module, name):
    fn = getattr(importlib.import_module(f'ptina_tpu_torch.{module}'), name)
    assert inspect.signature(fn).parameters['device'].default == 'cuda'


def test_gradient_entry_points_are_exported_and_follow_the_scene():
    '''diff.py's six functions and the pair (engine.fused_trace_diff, the
    autograd Function FusedTraceDiff) are exported; the gradients take no
    device of their own: they run where the scene lies.'''
    from ptina_tpu_torch import diff, engine
    from ptina_tpu_torch.engine import fused
    assert set(diff.__all__) == {'render_image_diff', 'image_loss',
                                 'material_grad', 'texture_grad',
                                 'inverse_render_step',
                                 'inverse_texture_step'}
    for name in diff.__all__:
        assert 'device' not in inspect.signature(getattr(diff, name)) \
            .parameters
    assert engine.fused_trace_diff is fused.fused_trace_diff
    assert 'fused_trace_diff' in engine.__all__
    assert issubclass(fused.FusedTraceDiff, torch.autograd.Function)


@pytest.mark.parametrize('name', ['sobol_block', 'sobol_vgrid'])
def test_sobol_points_default_to_the_host(name):
    '''The Sobol point rides in the megakernel's launch parameters, so it
    stays a host array unless asked for elsewhere.'''
    fn = getattr(sobol, name)
    assert inspect.signature(fn).parameters['device'].default == 'cpu'


def test_card_default_has_no_cpu_fallback():
    '''Without a card the default device raises, as torch does.'''
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    with pytest.raises((RuntimeError, AssertionError)):
        new_film(2, 2)
    with pytest.raises((RuntimeError, AssertionError)):
        cornell_box()
    with pytest.raises((RuntimeError, AssertionError)):
        mlt_init(4)


# ROADMAP.md's "Do not port": the reference's TPU-only public names (the
# Pallas casts, whose port is intersect/dense_cast.py; the MXU chunking of
# the hit contract; the blocked cast's VMEM / SMEM tiling; the
# megakernel's VMEM caps, tile rows, one-hot switch and interpret
# plumbing), and the reference's unbounded `timings` dict, whose port is
# the recorder's bounded aggregates (utils/trace.summary())
DO_NOT_PORT = {
    'intersect/pallas_cast.py': None,
    'intersect/plucker.py': {
        'FACE_CHUNK', 'cast_closest_chunks', 'cast_keys_chunks',
        'cast_mint_chunks', 'chunk_uvwta', 'chunk_uvwta_T', 'chunk_valid',
        'extract_winner', 'finish_extraction', 'pack_extract',
        'pack_plucker', 'recip'},
    'intersect/blocked.py': {
        'BLOCKED_TR', 'CAND_BITS', 'CAND_MASK', 'EXIT_ROUND',
        'MAX_BLOCKED_VMEM_FACES', 'SMEM_CAND_BUDGET', 'T5_ROWS',
        'TILES_PER_CALL', 'blocked_tables'},
    'engine/fused.py': {
        'MAX_FUSED_TEX_BINDINGS', 'MAX_FUSED_TEX_BYTES',
        'ONEHOT_FETCH_MIN_MATERIALS', 'RG', 'fused_trace_diff_interp'},
    'utils/trace.py': {'timings'},
}


def _public_names(path, imported=True):
    '''Top-level public names a module defines or assigns, and those it
    imports if `imported`.'''
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    out = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, ast.Assign):
            out.update(t.id for t in node.targets if isinstance(t, ast.Name))
        elif imported and isinstance(node, (ast.Import, ast.ImportFrom)):
            out.update((a.asname or a.name).split('.')[0]
                       for a in node.names)
    return {n for n in out if not n.startswith('_')}


def _reference_modules():
    ref = os.path.join(ROOT, 'ptina_tpu')
    for dirpath, _, names in os.walk(ref):
        for n in sorted(names):
            if n.endswith('.py'):
                yield os.path.relpath(os.path.join(dirpath, n), ref)


@pytest.mark.parametrize('rel', sorted(_reference_modules()))
def test_every_reference_module_is_ported(rel):
    '''The port's file of the same path has (defines or imports) every
    name the reference's defines, but the TPU-only ones.'''
    skip = DO_NOT_PORT.get(rel, set())
    if skip is None:
        return
    port = os.path.join(PKG, rel)
    assert os.path.exists(port), f'ptina_tpu_torch/{rel} is missing'
    ref = _public_names(os.path.join(ROOT, 'ptina_tpu', rel), imported=False)
    missing = sorted(ref - skip - _public_names(port))
    assert not missing, f'ptina_tpu_torch/{rel} lacks {missing}'


def _root_scripts():
    '''The reference's scripts at the repository's root level: every
    examples/*.py and bench.py, each with its port's path.'''
    ex = sorted(n for n in os.listdir(os.path.join(ROOT, 'examples'))
                if n.endswith('.py'))
    return [(f'examples/{n}', f'ptina_tpu_torch/examples/{n}') for n in ex] \
        + [('bench.py', 'ptina_tpu_torch/bench.py')]


@pytest.mark.parametrize('ref,port', _root_scripts(), ids=lambda x: x)
def test_every_root_script_is_ported(ref, port):
    '''Each root script has its counterpart in the port, which defines
    main(...) (the examples\' and the benchmark\'s entry point).'''
    path = os.path.join(ROOT, port)
    assert os.path.exists(path), f'{port} (the port of {ref}) is missing'
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    assert any(isinstance(n, ast.FunctionDef) and n.name == 'main'
               for n in tree.body), f'{port} defines no main'
