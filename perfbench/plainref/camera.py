'''
Camera ray generation from a 4x4 view-projection matrix.

Reference: ptina_tpu/camera.py.  Unproject two points per pixel (near and
far clip) and take the normalized difference; works for perspective and
orthographic matrices.  Rays come out as SoA V3 rows.
'''

from perfbench.plainref.vec import V3, vnormalize

__all__ = ['camera_rays']


def camera_rays(v2w, x, y):
    '''x, y: [N] NDC coordinates in [-1, 1].  Returns (ro, rd) V3 pairs.'''
    m = v2w

    def unproject(z):
        px = m[0, 0] * x + m[0, 1] * y + m[0, 2] * z + m[0, 3]
        py = m[1, 0] * x + m[1, 1] * y + m[1, 2] * z + m[1, 3]
        pz = m[2, 0] * x + m[2, 1] * y + m[2, 2] * z + m[2, 3]
        pw = m[3, 0] * x + m[3, 1] * y + m[3, 2] * z + m[3, 3]
        inv = 1.0 / pw
        return V3(px * inv, py * inv, pz * inv)

    ro = unproject(-1.0)
    ro1 = unproject(1.0)
    return ro, vnormalize(ro1 - ro)
