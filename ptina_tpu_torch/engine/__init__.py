'''
Rendering engines.

Reference: ptina_tpu/engine/__init__.py.  Ported: the path integrator in
its two routes — the wavefront (path.py: render, render_sample,
path_trace) and the path megakernel (fused.py: fused_trace_primary, the
production route of eligible scenes, and fused_trace_uniforms, the
explicit-uniform head).  render_sample picks the route.  The brute,
preview and MLT engines are later work.
'''

from ptina_tpu_torch.engine.path import render, render_sample, path_trace
from ptina_tpu_torch.engine.fused import (fused_eligible, fused_trace_primary,
                                          fused_trace_uniforms)

__all__ = ['render', 'render_sample', 'path_trace', 'fused_eligible',
           'fused_trace_primary', 'fused_trace_uniforms']
