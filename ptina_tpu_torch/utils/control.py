'''
Orbit camera controller.

Reference: ptina_tpu/utils/control.py, copied: numpy over the port's own
io/matrix (ptina's CamControl, ptina/tools/control.py:111-122).
Blender-style orbit / pan / dolly producing a `proj @ view` matrix.  The
reference binds these to ti.GUI mouse events; here the controller is
headless — callers (an interactive viewer, a notebook widget, a test)
feed it normalized pointer deltas and read `matrix()`.
'''

import numpy as np

from ptina_tpu_torch.io.matrix import lookat, perspective, orthogonal

__all__ = ['CamControl']


class CamControl:
    '''Spherical-orbit camera around a center point.

    theta: azimuth (radians), phi: elevation in (-pi/2, pi/2),
    radius: dolly distance, center: look-at target.'''

    def __init__(self, center=(0.0, 0.0, 0.0), theta=0.0, phi=0.0,
                 radius=3.0, fov=60.0, is_ortho=False):
        self.center = np.asarray(center, float)
        self.theta = float(theta)
        self.phi = float(phi)
        self.radius = float(radius)
        self.fov = float(fov)
        self.is_ortho = is_ortho
        self.dirty = True

    # --- interactions (deltas in fractions of the viewport) ---
    def orbit(self, dx, dy, speed=np.pi):
        self.theta -= dx * speed
        self.phi = float(np.clip(self.phi + dy * speed,
                                 -np.pi / 2 + 1e-3, np.pi / 2 - 1e-3))
        self.dirty = True

    def pan(self, dx, dy):
        right, up, _ = self._frame()
        self.center -= (right * dx - up * dy) * self.radius
        self.dirty = True

    def zoom(self, delta):
        '''delta > 0 zooms in (wheel up), factor 0.89 per notch like the
        reference (control.py:95-101 semantics).'''
        self.radius *= 0.89 ** delta
        self.dirty = True

    # --- matrices ---
    def _frame(self):
        ct, st = np.cos(self.theta), np.sin(self.theta)
        cp, sp = np.cos(self.phi), np.sin(self.phi)
        back = np.array([st * cp, sp, ct * cp])
        right = np.array([ct, 0.0, -st])
        up = np.cross(back, right)
        return right, up, back

    def view(self):
        _, up, back = self._frame()
        return lookat(self.center, back * self.radius, up)

    def proj(self, aspect=1.0):
        if self.is_ortho:
            return orthogonal(self.radius, aspect)
        return perspective(self.fov, aspect)

    def matrix(self, aspect=1.0):
        '''proj @ view, the worker.set_camera input
        (reference control.py:111-122).'''
        self.dirty = False
        return self.proj(aspect) @ self.view()
