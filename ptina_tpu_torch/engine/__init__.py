'''
Rendering engines.

Reference: ptina_tpu/engine/__init__.py.  Ported: the wavefront path
integrator (path.py).  The megakernel, brute, preview and MLT engines are
later work.
'''
