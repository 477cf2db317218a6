'''MLT render (reference examples/metropolis.py): cornell with Metropolis
chains, one chain per pixel, progressive passes.

    python -m ptina_tpu_torch.examples.metropolis

The chains' first points come from a torch.Generator (seed 0 by
default), where the reference takes jax.random.key(0).
'''

import torch

from ptina_tpu_torch.engine.mlt import mlt_init, render_mlt
from ptina_tpu_torch.examples import gamma_rgb, out_path, save_png
from ptina_tpu_torch.film import film_to_image, new_film
from ptina_tpu_torch.scenes import cornell_box


def main(res=256, passes=8, steps=4, generator=None, device='cuda',
         out_dir=None):
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    scene = cornell_box(device=device)
    film = new_film(res, res, device=device)
    state = mlt_init(nchains=res * res, generator=generator, device=device)

    for it in range(passes):
        state, film = render_mlt(scene, state, film, steps=steps)
        print('pass', it)

    img = film_to_image(film).cpu().numpy()
    print('mean', img[..., :3].mean())
    path = out_path(out_dir, 'metropolis_cornell.png')
    save_png(path, gamma_rgb(img))
    print('saved', path)
    return img


if __name__ == '__main__':
    main()
