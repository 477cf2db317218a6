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

Every module of the reference is ported: the path integrator over the scene build (the five
megakernel-eligible benchmark scenes: cornell_box, cornell_monkey,
textured cornell, envlight_scene, matball; and the big scene
cornell_highpoly, Morton-ordered in 512-face blocks), Sobol sampling,
Disney shading, lights and textures, in both routes:
  * the path megakernel (engine/fused.py, csrc/fused_path.cu): one launch
    per sample, primary and explicit-uniform heads; render_sample's route
    for eligible scenes on the card;
  * the wavefront (engine/path.py) with the two dense casts
    (intersect/dense_cast.py, csrc/dense_cast.cu: closest hit +
    attributes, and occlusion, both walking the scene's box tree) or, on
    big scenes, the two blocked casts (intersect/blocked.py,
    csrc/blocked_cast.cu), or, for accel='dense' above 8192 faces, the
    plain brute casts (intersect/brute.py);
the table-level intersect.cast_closest / cast_any (the flat
closest_kernel and any_flat_kernel of csrc/dense_cast.cu); the other
engines (engine/brute.py, engine/preview.py: albedo / normal AOVs,
engine/mlt.py: Metropolis light transport on the megakernel's
explicit-uniform head), tone mapping (tone.py), and the flat worker API
(worker.py, selecting the engines) with its config (config.py),
checkpoints (checkpoint.py), parameters (utils/params.py) and logging,
profiling and tracing (utils/trace.py: the program's spans and tree-walk
counters, on with trace.enable() or under any torch.profiler session,
read with trace.summary(); its docstring is the operator's guide); and
the gradients (diff.py: render_image_diff,
image_loss, material_grad, texture_grad, inverse_render_step,
inverse_texture_step), autograd
through the wavefront with the casts detached, the forward of eligible
scenes from the megakernel (engine/fused.fused_trace_diff), the material
fetch's backward on the card one kernel a bounce (mtllib.MaterialRows,
csrc/material_rows.cu, which replaces no Pallas kernel); tiled renders
(render_sample's x0, y0, full_res) and render's spb groups; film bands
over a mesh of devices, the data-parallel gradient step and the
torch.distributed runtime with its two-process launcher (parallel/); the
daemon thread and the orbit camera (utils/daemon.py, utils/control.py);
the BVH oracles (intersect/lbvh.py, intersect/middlebvh.py); and the
scene front-ends feeding the worker: glTF / GLB (io/readgltf.py, its
PNGs through the stdlib codec io/_png.py), OBJ and PLY (io/readobj.py),
per-object transforms (io/multimesh.py), the Blender render engine
(blender.py) and the examples (examples/, python -m
ptina_tpu_torch.examples.<name>); and the benchmark, the counterpart of
the reference's root bench.py (bench.py, python -m ptina_tpu_torch.bench:
its eight configurations on the card, metrics named torch_*).
'''

__version__ = '0.1.0'
