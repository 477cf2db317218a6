'''The texture.roofline reader on a fake summary(): the bytes a texel
backward must move (16 a lane walked, 24 a live lane) at the card's
memory rate over the grad.texel_rows.kernels spans' device time (the
kernel's launches alone, not the whole grad.texel_rows span); nothing
where the program recorded no such span, no device time or no counter,
or the card has no peaks.'''

import pytest

from perfbench.harness import manifest as mf
from perfbench.harness.peaks import PEAKS

H100 = 'NVIDIA H100 80GB HBM3'


def _fake(monkeypatch, span, counts, outer=None):
    from ptina_tpu_torch.utils import trace
    traced = {} if outer is None else {'grad.texel_rows': outer}
    if span is not None:
        traced['grad.texel_rows.kernels'] = span
    got = {'traced': traced,
           'counts': {} if counts is None else {'texel_rows': counts}}
    monkeypatch.setattr(trace, 'summary', lambda: got)


def test_share_arithmetic(monkeypatch):
    # 116 backwards of 262,144 lanes, 1.5% live, in 10 ms of device time
    lanes, live = 116 * 262144, 459_000
    _fake(monkeypatch, {'count': 116, 'device_ns': 10_000_000,
                        'device_count': 116}, [lanes, live, 150_000],
          outer={'count': 116, 'device_ns': 20_000_000, 'device_count': 116})
    got = mf.reader('texture.roofline').read({'device_kind': H100})
    want = 100.0 * (16 * lanes + 24 * live) / PEAKS['H100']['hbm_bytes'] \
        / 1e-2
    assert got == pytest.approx(want, rel=1e-12)
    assert 0 < got < 100


@pytest.mark.parametrize('span,counts,kind', [
    (None, [10, 1, 1], H100),
    # the parent's program: the outer span alone
    ('outer', [10, 1, 1], H100),
    ({'count': 1, 'device_ns': None, 'device_count': 0}, [10, 1, 1], H100),
    ({'count': 1, 'device_ns': 5000, 'device_count': 1}, None, H100),
    ({'count': 1, 'device_ns': 5000, 'device_count': 1}, [10, 1, 1], 'cpu'),
])
def test_nothing_to_read(monkeypatch, span, counts, kind):
    if span == 'outer':
        _fake(monkeypatch, None, counts,
              outer={'count': 1, 'device_ns': 5000, 'device_count': 1})
    else:
        _fake(monkeypatch, span, counts)
    assert mf.reader('texture.roofline').read({'device_kind': kind}) is None
