'''
Primary-sample-space Metropolis light transport.

Reference: ptina_tpu/engine/mlt.py (reference MLTPathEngine,
ptina/engine/mltpath.py).  Parallel Markov chains over the path
integrator's 32-dimensional primary sample space: each step proposes for
every chain either a large step (fresh uniforms, probability lsp) or a
Gaussian mutation (sigma, wrapped mod 1), replays the path on the
proposal as its random stream, splats into the film and accepts on the
luminance ratio.  The chains are a dimension-major [D, C] tensor, so each
primary-sample dimension is a dense row of the integrator's uniform
block.

Estimators: mode='kelemen' (the default) is the normalized PSSMLT
estimator (Kelemen et al. 2002): every step splats the importance-
compensated radiance L / lum(L) of the proposal weighted by the
acceptance and of the current state weighted by its complement (both in
one film_splat), and adds C / (b npixels) to the pass's sample count,
where b, the mean image luminance, is estimated online from the large
steps (uniform samples of the primary space); film_to_image's rgb / w
division then gives a radiance estimate comparable to the path engine's.
mode='reference' splats the raw proposal radiance with unit weight, the
reference's shipped (unnormalized) behaviour.

The replay (_replay) takes the reference's rule: a fused_eligible scene
(dense route on the card) runs the explicit-uniform head of the path
megakernel (engine/fused.fused_trace_uniforms: one path_kernel launch a
step), any other scene path_trace (on the CPU the same function).

A step reads nothing back to the host: the proposal, the brightness
estimate b, the sample-count add and the accept mask all stay on the
state's device (0 host-device synchronisations a step).

Randomness: mlt_init draws the first chains with torch.rand from an
explicit generator (the reference draws them with jax.random; its tests
pass the reference's initial state in).  The proposal streams are
counter-hashed (sampling.hash_uniform over (step * 0x9e3779b9 + dim,
chain)) and, as in the reference, do not depend on the init seed.
'''

import dataclasses

import torch

from ptina_tpu_torch.utils.mathutils import normaldist
from ptina_tpu_torch.utils.vec import V3, vavg3, vwhere
from ptina_tpu_torch.camera import camera_rays
from ptina_tpu_torch.engine.fused import fused_eligible, fused_trace_uniforms
from ptina_tpu_torch.engine.path import path_trace, PATH_DIMS
from ptina_tpu_torch.film import film_splat
from ptina_tpu_torch.sampling import hash_uniform

__all__ = ['MLTState', 'mlt_init', 'mlt_step', 'render_mlt', 'LSP', 'SIGMA']

LSP = 0.25    # large-step probability (reference mltpath.py:25-28)
SIGMA = 0.01  # mutation size
# the golden-ratio stride 0x9e3779b9 as a signed int32, as the reference
# multiplies its int32 step counter (mlt.py:106); hash_uniform takes the
# product mod 2^32, the bits of the reference's wrapped int32
_STRIDE = -1640531527


@dataclasses.dataclass
class MLTState:
    '''The chains: x [D, C] primary samples (dimension-major), l their
    cached radiance (V3 of [C] rows), b_sum / b_cnt the running sum and
    count of large-step luminances (0-d float32), step the int32 round
    counter that drives the proposal streams (0-d).'''
    x: torch.Tensor
    l: V3
    b_sum: torch.Tensor
    b_cnt: torch.Tensor
    step: torch.Tensor


def mlt_init(nchains=2 ** 18, ndims=PATH_DIMS, generator=None,
             device='cuda'):
    '''Fresh chains (reference reset(), mltpath.py:30-36): x uniform in
    [0, 1) from `generator` (a torch.Generator on `device`; None = the
    default one), zero radiance and counters.'''
    z = torch.zeros(nchains, device=device)
    return MLTState(
        x=torch.rand((ndims, nchains), generator=generator, device=device),
        l=V3(z, z.clone(), z.clone()),
        b_sum=torch.zeros((), device=device),
        b_cnt=torch.zeros((), device=device),
        step=torch.zeros((), dtype=torch.int32, device=device))


def _replay(scene, x):
    '''Radiance of the paths encoded by primary samples x [D, C] (dims 0-1
    are the lens, reference mltpath.py:67-69).'''
    ro, rd = camera_rays(scene.cam_v2w, x[0] * 2.0 - 1.0, x[1] * 2.0 - 1.0)
    if fused_eligible(scene):
        return fused_trace_uniforms(scene, ro, rd, x)
    return path_trace(scene, ro, rd, x)


def _propose(state, lsp, sigma):
    '''The step's proposals: (x_new [D, C], large [C] bool, the accept
    roll [C]).  Rows 0..D-1 of the hashed block are the fresh uniforms,
    row D the large-step coin, row D+1 the acceptance roll.'''
    d, c = state.x.shape
    dev = state.x.device
    chain = torch.arange(c, dtype=torch.int64, device=dev)
    dim = torch.arange(d + 2, dtype=torch.int64, device=dev)[:, None]
    u = hash_uniform(state.step.to(torch.int64) * _STRIDE + dim, chain)
    large = u[d] < lsp
    fresh = u[:d]
    mutated = torch.remainder(state.x + sigma * normaldist(fresh), 1.0)
    return torch.where(large[None, :], fresh, mutated), large, u[d + 1]


def _pixels(x, nx, ny):
    return (torch.floor(x[0] * nx).to(torch.int64),
            torch.floor(x[1] * ny).to(torch.int64))


def mlt_step(scene, state, film, lsp=LSP, sigma=SIGMA, mode='kelemen'):
    '''One mutation round for every chain; the film (on the state's
    device) accumulates in place.  Returns (new state, film).'''
    if mode not in ('kelemen', 'reference'):
        raise ValueError(f'unknown MLT mode {mode!r}')
    c = state.x.shape[1]
    nx, ny = film.shape[2], film.shape[3]
    x_new, large, roll = _propose(state, lsp, sigma)
    l_new = _replay(scene, x_new)

    al_new = vavg3(l_new) + 1e-10
    al_old = vavg3(state.l) + 1e-10
    accept = torch.clamp_max(al_new / al_old, 1.0)
    b_sum = state.b_sum + torch.sum(torch.where(large, al_new, 0.0))
    b_cnt = state.b_cnt + torch.sum(large.to(torch.float32))
    b = b_sum / torch.clamp_min(b_cnt, 1.0)

    if mode == 'reference':
        xi, yi = _pixels(x_new, nx, ny)
        film_splat(film, 0, xi, yi, l_new.x, l_new.y, l_new.z,
                   torch.ones_like(l_new.x))
    else:
        w_new = accept / al_new
        w_old = (1.0 - accept) / al_old
        xi_n, yi_n = _pixels(x_new, nx, ny)
        xi_o, yi_o = _pixels(state.x, nx, ny)
        film_splat(film, 0, torch.cat([xi_n, xi_o]), torch.cat([yi_n, yi_o]),
                   torch.cat([l_new.x * w_new, state.l.x * w_old]),
                   torch.cat([l_new.y * w_new, state.l.y * w_old]),
                   torch.cat([l_new.z * w_new, state.l.z * w_old]),
                   torch.zeros(2 * c, device=film.device))
        film[0, 3].add_(c / (b * nx * ny))

    take = roll < accept
    return MLTState(x=torch.where(take[None, :], x_new, state.x),
                    l=vwhere(take, l_new, state.l), b_sum=b_sum, b_cnt=b_cnt,
                    step=state.step + 1), film


def render_mlt(scene, state, film, steps=1, lsp=LSP, sigma=SIGMA,
               mode='kelemen'):
    '''Advance every chain `steps` rounds.  Returns (state, film).'''
    for _ in range(steps):
        state, film = mlt_step(scene, state, film, lsp, sigma, mode)
    return state, film
