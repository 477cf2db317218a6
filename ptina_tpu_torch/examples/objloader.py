'''OBJ loading demo (reference examples/objloader.py): write a small OBJ,
load it through the worker API's OBJ path and render it with the default
material and the default point light.

    python -m ptina_tpu_torch.examples.objloader
'''

import os
import tempfile

from ptina_tpu_torch import worker
from ptina_tpu_torch.io.matrix import lookat, perspective

OBJ = '''
v -1 0 -1
v 1 0 -1
v 1 0 1
v -1 0 1
v 0 1.4 0
f 1 2 3 4
f 1 2 5
f 2 3 5
f 3 4 5
f 4 1 5
'''


def main(res=256, spp=16, device='cuda', out_dir=None):
    with tempfile.NamedTemporaryFile('w', suffix='.obj', dir=out_dir,
                                     delete=False) as fp:
        fp.write(OBJ)
        path = fp.name
    try:
        worker.init(device=device)
        worker.load_model(path)  # str -> readobj -> obj_to_vertices
        worker.build_tree()
        worker.set_size(res, res)
        worker.set_camera(perspective(60, 1) @ lookat(pos=(0, 0.5, 0),
                                                      back=(2.0, 1.5, 2.5)))
        for _ in range(spp):
            worker.render()
        img = worker.get_image()
    finally:
        os.unlink(path)
    print('pyramid render: mean', float(img[..., :3].mean()),
          'max', float(img[..., :3].max()))
    return img


if __name__ == '__main__':
    main()
