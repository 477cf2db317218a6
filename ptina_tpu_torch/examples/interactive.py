'''
Headless progressive refinement (reference examples/interactive.py, the
reference's viewport semantics, ptina/blender.py:714-784): a render
starts at a coarse resolution (start_pixel_size-for-1 blocks), each pass
halves the block size until full resolution, then samples accumulate.
A scripted orbit resets the refinement, as a camera move would.

Writes refine_f<frame>_s<step>.png and refine_f<frame>_final.png
snapshots into `out_dir` instead of drawing to a window.

    python -m ptina_tpu_torch.examples.interactive
'''

import time

import torch

from ptina_tpu_torch import worker
from ptina_tpu_torch.examples import out_path, save_png
from ptina_tpu_torch.scenes import cornell_box_vertices
from ptina_tpu_torch.tone import apply_exposure_gamma
from ptina_tpu_torch.utils.control import CamControl


def _snapshot(out_dir, name):
    img = torch.from_numpy(worker.get_image()[..., :3])
    save_png(out_path(out_dir, name),
             apply_exposure_gamma(img).numpy())


def main(res=256, start_pixel_size=8, final_samples=32, frames=3,
         device='cuda', out_dir=None):
    refine_samples = 1
    verts, mtlids, materials = cornell_box_vertices()
    worker.init(device=device)
    worker.load_materials(materials)
    worker.load_model(verts, mtlids)
    worker.build_tree()

    cam = CamControl(center=(0.0, 1.0, 0.0), radius=4.5, phi=0.1)

    for frame in range(frames):  # scripted "camera interaction"
        cam.orbit(0.06 * frame, 0.0)
        nblocks = start_pixel_size
        step = 0
        t0 = time.time()
        # coarse-to-fine: the reference halves the block size each pass
        while nblocks >= 1:
            nx, ny = res // nblocks, res // nblocks
            worker.set_size(nx, ny)
            worker.set_camera(cam.matrix(aspect=1.0))
            worker.render()
            if nblocks > 1:
                worker.render()  # a couple samples at coarse levels
            _snapshot(out_dir, f'refine_f{frame}_s{step}.png')
            print(f'frame {frame} pass {step}: {nx}x{ny} '
                  f'({time.time() - t0:.2f}s)')
            nblocks //= 2
            step += 1
        # progressive accumulation at full resolution
        for _ in range(final_samples - refine_samples):
            worker.render()
        _snapshot(out_dir, f'refine_f{frame}_final.png')
        print(f'frame {frame}: {final_samples} samples in '
              f'{time.time() - t0:.2f}s')


if __name__ == '__main__':
    main()
