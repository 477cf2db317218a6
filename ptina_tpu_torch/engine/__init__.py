'''
Rendering engines.

Reference: ptina_tpu/engine/__init__.py.  The path integrator in its two
routes — the wavefront (path.py: render, render_sample, path_trace) and
the path megakernel (fused.py: fused_trace_primary, the production route
of eligible scenes, fused_trace_uniforms, the explicit-uniform head, and
fused_trace, the explicit-ray head for callers who build their own rays);
render_sample picks the route.  fused_trace_diff pairs the explicit-uniform
head's forward with a wavefront backward (the gradients, diff.py).  The brute-force integrator (brute.py),
the albedo / normal AOV preview (preview.py) and primary-sample-space
MLT (mlt.py, whose replay takes the explicit-uniform head on eligible
scenes).
'''

from ptina_tpu_torch.engine.path import render, render_sample, path_trace
from ptina_tpu_torch.engine.fused import (fused_eligible, fused_trace_primary,
                                          fused_trace_uniforms, fused_trace,
                                          fused_trace_diff)
from ptina_tpu_torch.engine.brute import (brute_trace, render_brute_sample,
                                          render_brute)
from ptina_tpu_torch.engine.preview import (render_preview_sample,
                                            render_preview)
from ptina_tpu_torch.engine.mlt import (MLTState, mlt_init, mlt_step,
                                        render_mlt)

__all__ = ['render', 'render_sample', 'path_trace', 'fused_eligible',
           'fused_trace_primary', 'fused_trace_uniforms', 'fused_trace',
           'fused_trace_diff',
           'brute_trace', 'render_brute_sample', 'render_brute',
           'render_preview_sample', 'render_preview', 'MLTState', 'mlt_init',
           'mlt_step', 'render_mlt']
