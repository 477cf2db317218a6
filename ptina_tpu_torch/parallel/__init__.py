'''
Multi-device rendering: film bands over a mesh of devices, and the
multi-process runtime.

Reference: ptina_tpu/parallel/__init__.py.  Each device renders a
contiguous band of film rows into a film of its own, with no
communication while rendering; the bands are assembled at readout, and
the gradient step averages its material gradient over the bands
(sharding.py).  Processes join a torch.distributed group only on
explicit configuration (distributed.py).
'''

from ptina_tpu_torch.parallel.sharding import (  # noqa: F401
    make_mesh, render_sharded, train_step_sharded, gather_film)
from ptina_tpu_torch.parallel.distributed import (  # noqa: F401
    init_distributed, global_mesh, is_distributed)

__all__ = ['make_mesh', 'render_sharded', 'train_step_sharded',
           'gather_film', 'init_distributed', 'global_mesh', 'is_distributed']
