'''The grad.graphed_share reader on a fake summary(): the program's
grad.shade.replay spans over its grad.shade spans, in percent; 0 where
the shading ran but never replayed; nothing where the program recorded
no grad.shade span (the parent's program, a run without the backward).'''

import pytest

from perfbench.harness import manifest as mf


def _fake(monkeypatch, traced):
    from ptina_tpu_torch.utils import trace
    monkeypatch.setattr(trace, 'summary', lambda: {'traced': traced})


def _span(count):
    return {'count': count, 'host_ns': 1000 * count, 'self_ns': 10,
            'device_ns': None, 'device_count': 0}


@pytest.mark.parametrize('shade,replay,want', [
    (40, 40, 100.0), (40, 30, 75.0), (40, None, 0.0)])
def test_share(monkeypatch, shade, replay, want):
    traced = {'grad.shade': _span(shade), 'grad.recompute': _span(4)}
    if replay is not None:
        traced['grad.shade.replay'] = _span(replay)
    _fake(monkeypatch, traced)
    assert mf.reader('grad.graphed_share').read({}) == pytest.approx(want)


@pytest.mark.parametrize('traced', [
    {}, {'grad.recompute': _span(4)}, {'grad.shade': _span(0)}])
def test_nothing_to_read(monkeypatch, traced):
    _fake(monkeypatch, traced)
    assert mf.reader('grad.graphed_share').read({}) is None
