'''
Unified configuration.

Reference: ptina_tpu/config.py (the same dataclass, fields and defaults).
The reference scatters its knobs over four mechanisms (init_things pool
caps, Globals sliders, Blender render properties, edit-the-import
choices); here they are one dataclass, threaded explicitly to the code
that needs each value (worker.py).
'''

import dataclasses

__all__ = ['Config', 'DEFAULT']


@dataclasses.dataclass
class Config:
    # --- engine selection (reference worker.py:6-7, tree/__init__.py:5-6) ---
    engine: str = 'path'          # 'path' | 'brute' | 'mlt'
    accel: str = 'auto'           # 'auto' | 'dense' | 'blocked'
    material_model: str = 'disney'  # 'disney' | 'lambert' | 'mirror' | 'phong'

    # --- integrator (reference engine/path.py:25, mltpath.py:25-28) ---
    max_depth: int = 5
    mlt_large_step_prob: float = 0.25
    mlt_sigma: float = 0.01
    # MLT chain count; None = one chain per film pixel (at the 512x512
    # benchmark film that equals the reference's fixed 2^18 chains,
    # mltpath.py:11)
    mlt_chains: int | None = None

    # --- film / rendering (reference blender.py:922-931 defaults) ---
    render_samples: int = 128
    viewport_samples: int = 32
    albedo_samples: int = 1
    start_pixel_size: int = 8
    film_passes: int = 3

    # --- capacities (reference things.py:12-19).  None = size each pool
    # exactly to the scene; a number reserves headroom. ---
    max_lights: int | None = None
    max_materials: int | None = None
    pad_faces_to: int = 8

    # numerics: the reference's eps/inf/sobol-skip knobs
    # (common.py:32-33, sobol.py:75) are constants here:
    # utils/mathutils.EPS / INF and sampling/sobol.SKIP.


DEFAULT = Config()
