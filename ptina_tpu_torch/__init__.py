'''
ptina_tpu_torch — the PyTorch/CUDA port of the ptina_tpu path tracer.

Reference: ptina_tpu/__init__.py.  The JAX package stays the reference;
this package mirrors its module paths one for one (each file names its
single reference file) and runs on one NVIDIA H100.  Plain tensor code is
PyTorch; every Pallas kernel of the reference becomes a hand-written
CUDA C++ kernel for sm_90a (sources under csrc/, built with nvcc at first
use on a CUDA tensor and bound with ctypes).

The package imports torch, numpy and (host code only) scipy — never jax
and never ptina_tpu, which would drag JAX in.  Importing it needs neither
nvcc nor a GPU: a kernel library is built and loaded only when a wrapper
first receives a CUDA tensor.

Ported so far: the wavefront path integrator (engine/path.py) over the
dense-route scene build, Sobol sampling, Disney shading, lights, and the
two dense casts (intersect/dense_cast.py: closest hit + attributes, and
occlusion).
'''

__version__ = '0.1.0'
