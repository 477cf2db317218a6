'''No module under perfbench/ imports JAX or the JAX package, compared by
whole top-level name (ptina_tpu_torch begins with ptina_tpu), and the
plain reference, the yardstick and the frozen scenes import nothing of
the program.'''

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {'jax', 'jaxlib', 'flax', 'ptina_tpu'}
SOURCES = sorted(BENCH.rglob('*.py'))


def _imports(path):
    tree = ast.parse(path.read_text(encoding='utf-8'))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module \
                and not node.level:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(
                node.func, 'attr', getattr(node.func, 'id', '')) \
                == 'import_module' and node.args \
                and isinstance(node.args[0], ast.Constant):
            yield node.args[0].value


@pytest.mark.parametrize('path', SOURCES,
                         ids=[str(p.relative_to(BENCH)) for p in SOURCES])
def test_no_jax(path):
    tops = {m.split('.', 1)[0] for m in _imports(path)}
    assert not tops & FORBIDDEN


@pytest.mark.parametrize('sub', ['plainref', 'yardstick', 'scenes'])
def test_reference_imports_nothing_of_the_program(sub):
    for path in (BENCH / sub).rglob('*.py'):
        tops = {m.split('.', 1)[0] for m in _imports(path)}
        assert 'ptina_tpu_torch' not in tops, path


def test_whole_name_comparison():
    assert 'ptina_tpu_torch'.split('.', 1)[0] not in FORBIDDEN
