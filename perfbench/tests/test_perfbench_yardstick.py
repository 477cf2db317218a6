'''The yardstick count repeats exactly, and the counts stored in the
configuration files are whole and agree with their own samples.'''

import pytest

from perfbench.harness import manifest as mf
from perfbench.yardstick import count

MAN = mf.manifest()


def test_count_repeats_exactly():
    a = count.count('cornell_monkey', 'cpu', res=8)
    b = count.count('cornell_monkey', 'cpu', res=8)
    assert a == b
    assert a['kernel'] == 'path_kernel' and a['flops_per_sample'] > 0


@pytest.mark.parametrize('config', [c['name'] for c in MAN['configs']])
def test_stored_count(config):
    _, cfg = mf.config(MAN, config)
    counted = cfg['yardstick']['counted']
    assert counted['res'] == cfg['res']
    per = counted['per_sample']
    assert [p['sample'] for p in per] == cfg['yardstick']['samples']
    for p in per:
        assert p['flops'] == 29 * p['pairs'] + 7 * p['passing']
    assert counted['flops_per_sample'] == sum(p['flops'] for p in per) \
        / len(per)
    assert counted['bytes_per_sample'] == sum(p['bytes'] for p in per) \
        / len(per)
