'''Quick smoke render: cornell box (or cornell_monkey) at a small size,
image statistics printed and a PNG saved (reference
examples/smoke_render.py).

    python -m ptina_tpu_torch.examples.smoke_render [res] [spp] [cornell|monkey]
'''

import sys

import numpy as np

from ptina_tpu_torch.engine.path import render
from ptina_tpu_torch.examples import gamma_rgb, out_path, save_png
from ptina_tpu_torch.film import film_to_image, new_film
from ptina_tpu_torch.scenes import cornell_box, cornell_monkey


def main(res=64, spp=4, scene_name='cornell', device='cuda', out_dir=None):
    scene = {'cornell': cornell_box,
             'monkey': cornell_monkey}[scene_name](device=device)
    film = render(scene, new_film(res, res, device=device), 0, spp=spp)
    img = film_to_image(film).cpu().numpy()
    print('image', img.shape, 'min', img[..., :3].min(), 'max',
          img[..., :3].max(), 'mean', img[..., :3].mean(), 'nan',
          np.isnan(img).any())
    path = out_path(out_dir, f'smoke_{scene_name}_{res}.png')
    save_png(path, gamma_rgb(img))
    print('saved', path)
    return img


if __name__ == '__main__':
    args = sys.argv[1:]
    main(res=int(args[0]) if len(args) > 0 else 64,
         spp=int(args[1]) if len(args) > 1 else 4,
         scene_name=args[2] if len(args) > 2 else 'cornell')
