'''Material preview ball (reference examples/matball.py): the Disney
sphere on a ground plane with a checker roughness texture.

    python -m ptina_tpu_torch.examples.matball
'''

import numpy as np

from ptina_tpu_torch.engine.path import render
from ptina_tpu_torch.examples import gamma_rgb, out_path, save_png
from ptina_tpu_torch.film import film_to_image, new_film
from ptina_tpu_torch.io.matrix import lookat, perspective
from ptina_tpu_torch.scenes import matball


def main(res=256, spp=16, device='cuda', out_dir=None):
    # checker roughness texture
    u, v = np.meshgrid(np.arange(64), np.arange(64), indexing='ij')
    checker = (((u // 8) + (v // 8)) % 2).astype(np.float32) * 0.7 + 0.1
    tex = np.stack([checker] * 3, axis=-1)

    cam = perspective(fov=45) @ lookat(pos=(0, 1, 0), back=(2.5, 1.5, 2.5))
    scene = matball(roughness_tex=tex, cam_pers=cam, device=device)
    film = render(scene, new_film(res, res, device=device), 0, spp=spp)
    img = film_to_image(film).cpu().numpy()
    print('mean', img[..., :3].mean())
    path = out_path(out_dir, 'matball.png')
    save_png(path, gamma_rgb(img))
    print('saved', path)
    return img


if __name__ == '__main__':
    main()
