'''
Count a configuration's yardstick: the work one sample needs, whatever
implements it, for the roofline shares of the traced run.

    python perfbench/yardstick/count.py --config cornell_monkey \
        [--device cuda] [--res N]

Traces the configuration's fixed sample indices (its file's
yardstick.samples) at its resolution through the plain reference's
wavefront (perfbench/plainref), keeping each bounce's casts, and counts
on the frozen yardstick tree (perfbench/yardstick/tree.py) the ray-face
pairs those casts need and how many pass the sign test: 29 FP32
operations a pair, 7 more a passing pair.  The casts of the live paths
count: the closest cast of each path still alive, and the shadow ray of
each path that casts one.  Bytes: the tables the casts read and the rows
they write (`kernel` below).  Prints one JSON object, whose `counted`
block the configuration file stores; on a blocked-route configuration
the tree is the blocked casts' (over the Morton-ordered table), on a
dense-route one the megakernel's (over fused_face_order).
'''

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from perfbench.harness import manifest as mf  # noqa: E402
from perfbench.plainref.intersect import casts  # noqa: E402
from perfbench.plainref.path import PATH_DIMS, path_trace  # noqa: E402
from perfbench.plainref.camera import camera_rays  # noqa: E402
from perfbench.plainref.sampling.sobol import sample_dims  # noqa: E402
from perfbench.yardstick import tree  # noqa: E402
from perfbench.drivers.common import reference_scene  # noqa: E402


def _nbytes(t):
    return t.numel() * t.element_size()


def count_sample(scene, res, sample, dev):
    '''Per bounce: (live closest casts, live shadow casts, (closest pairs,
    passing), (shadow pairs, passing)) of one sample at res^2.'''
    ii, jj = torch.meshgrid(torch.arange(res, dtype=torch.int32, device=dev),
                            torch.arange(res, dtype=torch.int32, device=dev),
                            indexing='ij')
    ii, jj = ii.reshape(-1), jj.reshape(-1)
    u = sample_dims(sample, ii, jj, PATH_DIMS)
    x = (ii.to(torch.float32) + u[0]) / res * 2.0 - 1.0
    y = (jj.to(torch.float32) + u[1]) / res * 2.0 - 1.0
    ro, rd = camera_rays(scene.cam_v2w, x, y)
    lanes = []
    with torch.no_grad():
        path_trace(scene, ro, rd, u, lanes=lanes)
    nf = int(scene.nfaces)
    pos = scene.tri_pos.cpu().numpy()
    if casts.route(pos.shape[0], scene.accel) == 'blocked':
        order = np.arange(pos.shape[0])
    else:
        order = tree.fused_face_order(pos, nf)
    nodes = torch.as_tensor(tree.compute_node_bounds(pos[order], nf),
                            device=dev)
    coef = scene.face_coef[torch.as_tensor(order, device=dev)]
    slot = torch.as_tensor(np.argsort(order), device=dev)
    out = []
    with torch.no_grad():
        for lane in lanes:
            occluder = casts.closest(scene, lane['ro_sh'], lane['rd_sh'],
                                     lane['hit'].index).index
            c, s = tree.cast_work(lane, occluder, nodes, nf, slot, coef)
            a, sh = lane['alive'], lane['shadow']
            out.append((int(a.sum()), int(sh.sum()),
                        tuple(int(v[a].sum()) for v in c),
                        tuple(int(v[sh].sum()) for v in s)))
    return out, nodes


def count(config, dev, res=None):
    '''The `counted` block of a configuration file: the yardstick's work a
    sample, as the mean over its fixed samples.'''
    man = mf.manifest()
    _, cfg = mf.config(man, config)
    res = int(res or cfg['res'])
    inputs = mf.scene_family(cfg['scene']).build(cfg)
    scene = reference_scene(inputs, dev)
    nf = int(scene.nfaces)
    f = scene.face_coef.shape[0]
    blocked = casts.route(f, scene.accel) == 'blocked'
    per = []
    for sample in cfg['yardstick']['samples']:
        bounces, nodes = count_sample(scene, res, int(sample), dev)
        pairs = sum(c[0] + s[0] for _, _, c, s in bounces)
        passing = sum(c[1] + s[1] for _, _, c, s in bounces)
        tree_b = _nbytes(nodes)
        if blocked:
            # a bounce's shade cast: the face and attribute tables, the
            # tree, each live ray's row (28 B) and hit row (41 B); its
            # shadow cast: the face table, the tree, each ray's row with
            # tmax (32 B) and its bit (1 B)
            nbytes = sum(136 * nf + tree_b + 69 * a + 64 * nf + tree_b
                         + 33 * s for a, s, _, _ in bounces)
        else:
            # the megakernel: the face, attribute and tree tables (the
            # tree's face rows and order too), the textures, and the
            # radiance rows it writes
            nbytes = (136 * nf + tree_b + 64 * nf + 4 * f
                      + _nbytes(scene.textures.data) + 12 * res * res)
        per.append({'sample': int(sample), 'pairs': pairs,
                    'passing': passing,
                    'flops': tree.FLOPS_SIDE * pairs + tree.FLOPS_T * passing,
                    'bytes': nbytes,
                    'casts': [[a, s] for a, s, _, _ in bounces]})
    mean = {k: float(np.mean([p[k] for p in per]))
            for k in ('flops', 'bytes', 'pairs', 'passing')}
    return {'kernel': 'blocked_casts' if blocked else 'path_kernel',
            'res': res, 'tree': 'blocked' if blocked else 'dense',
            'flops_per_sample': mean['flops'],
            'bytes_per_sample': mean['bytes'],
            'pairs_per_sample': mean['pairs'],
            'passing_per_sample': mean['passing'], 'per_sample': per}


def main():
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--config', required=True)
    p.add_argument('--device', default='cuda')
    p.add_argument('--res', type=int, default=None)
    a = p.parse_args()
    print(json.dumps({'config': a.config,
                      'counted': count(a.config, a.device, a.res)}))


if __name__ == '__main__':
    main()
