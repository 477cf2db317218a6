'''Golden-image coverage render (reference examples/coverage.py): cornell
at 512x512, 32 spp, saved for eyeballing, with a numeric summary so a
caller can assert on drift.

    python -m ptina_tpu_torch.examples.coverage
'''

import numpy as np

from ptina_tpu_torch.engine.path import render
from ptina_tpu_torch.examples import gamma_rgb, out_path, save_png
from ptina_tpu_torch.film import film_to_image, new_film
from ptina_tpu_torch.scenes import cornell_box


def main(res=512, spp=32, device='cuda', out_dir=None):
    scene = cornell_box(device=device)
    film = render(scene, new_film(res, res, device=device), 0, spp=spp)
    img = film_to_image(film).cpu().numpy()
    print('mean', img[..., :3].mean(), 'p99', np.percentile(img[..., :3], 99))
    path = out_path(out_dir, 'coverage_cornell.png')
    save_png(path, gamma_rgb(img))
    print('saved', path)
    return img


if __name__ == '__main__':
    main()
