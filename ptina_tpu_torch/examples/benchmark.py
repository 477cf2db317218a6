'''Benchmark example (reference examples/benchmark.py): one scene timed by
the port's benchmark harness, ptina_tpu_torch.bench (one warm-up, a probe
frame, then a self-tuned window of progressive frames with one sync at
the end; see its module docstring for the method).

    python -m ptina_tpu_torch.examples.benchmark [scene] [spp]

scene: the name of a function of ptina_tpu_torch.scenes (cornell_box,
cornell_monkey, cornell_highpoly, envlight_scene, matball).
'''

import sys

from ptina_tpu_torch import bench, scenes


def main(scene_name='cornell_monkey', spp=32, res=512, device='cuda'):
    scene = getattr(scenes, scene_name)(device=device)
    sps = bench.time_render(scene, res, spp).value
    print(f'{scene_name}: {sps:.3f} sps ({spp} spp frames, {res}x{res})')
    return sps


if __name__ == '__main__':
    args = sys.argv[1:]
    main(scene_name=args[0] if len(args) > 0 else 'cornell_monkey',
         spp=int(args[1]) if len(args) > 1 else 32)
