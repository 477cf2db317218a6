'''
Hygiene of the PyTorch port package (ptina_tpu_torch): it never imports
JAX or the JAX package, and it imports on a machine with neither nvcc
nor a GPU (its kernel library is built only on first use on the card).
'''

import ast
import os
import subprocess
import sys

import pytest

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
            assert top not in ('jax', 'jaxlib', 'flax', 'ptina_tpu'), \
                f'{path} imports {name}'


def test_imports_without_jax_nvcc_or_gpu():
    '''A fresh interpreter with no CUDA toolkit on PATH imports every
    module of the port and pulls in no JAX.'''
    code = (
        'import sys\n'
        'import ptina_tpu_torch.engine.path, ptina_tpu_torch.scenes\n'
        'import ptina_tpu_torch.intersect.dispatch\n'
        'from ptina_tpu_torch.intersect import blocked, dense_cast\n'
        'from ptina_tpu_torch.engine import fused\n'
        'for m in (dense_cast, fused, blocked):\n'
        '    assert m.build_library.cache_info().currsize == 0\n'
        'bad = [m for m in sys.modules if m.split(".")[0] in '
        '("jax", "flax", "ptina_tpu")]\n'
        'assert not bad, bad\n')
    env = dict(os.environ, PATH='/usr/bin:/bin', CUDA_VISIBLE_DEVICES='')
    env.pop('CUDA_HOME', None)
    out = subprocess.run([sys.executable, '-c', code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
