'''
Checkpoint and resume for long progressive renders.

Reference: ptina_tpu/checkpoint.py.  The render state is small (the film
accumulator, the next sample index, optional MLT chains), and the
samplers are stateless functions of the sample index and the MLT step
counter, so a restarted render continues bit for bit.

The file is the reference's pickle, protocol 4: a dict of 'film' (numpy
[passes, 4, nx, ny] float32), 'sample_index' (int), 'mlt_state', 'meta'
(dict) and 'version' 1, so a path-engine checkpoint written by either
package loads in the other.  The reference pickles 'mlt_state' as its
flax MLTState; the port stores it as a plain dict of numpy arrays (x
[D, C], l [3, C], b_sum, b_cnt, step), because unpickling the reference's
class would import the JAX package.  Loading unpickles numpy arrays and
plain Python values only: any other class (a reference MLT checkpoint)
raises.
'''

import os
import pickle

import numpy as np
import torch

from ptina_tpu_torch.utils.vec import V3

__all__ = ['save_render_state', 'load_render_state', 'mlt_state_to_numpy',
           'mlt_state_from_numpy']


def _host(t):
    return t.detach().cpu().numpy()


def mlt_state_to_numpy(state):
    '''An engine.mlt.MLTState -> the checkpoint's dict of numpy arrays.'''
    return {'x': _host(state.x),
            'l': np.stack([_host(state.l.x), _host(state.l.y),
                           _host(state.l.z)]),
            'b_sum': _host(state.b_sum), 'b_cnt': _host(state.b_cnt),
            'step': _host(state.step)}


def mlt_state_from_numpy(d, device='cuda'):
    '''The checkpoint's dict -> an engine.mlt.MLTState on `device`.'''
    from ptina_tpu_torch.engine.mlt import MLTState

    def t(a):
        return torch.tensor(np.asarray(a), device=device)  # a copy
    l = t(d['l'])
    return MLTState(x=t(d['x']), l=V3(l[0], l[1], l[2]), b_sum=t(d['b_sum']),
                    b_cnt=t(d['b_cnt']), step=t(d['step']))


def save_render_state(path, film, sample_index, mlt_state=None, meta=None):
    '''Atomically write the render state (film: a tensor on any device).'''
    state = {
        'film': _host(film),
        'sample_index': int(sample_index),
        'mlt_state': None if mlt_state is None
        else mlt_state_to_numpy(mlt_state),
        'meta': meta or {},
        'version': 1,
    }
    tmp = path + '.tmp'
    with open(tmp, 'wb') as f:
        pickle.dump(state, f, protocol=4)
    os.replace(tmp, path)


class _NumpyUnpickler(pickle.Unpickler):
    '''Unpickles numpy arrays, dtypes and scalars and plain Python values;
    refuses every other class.'''

    def find_class(self, module, name):
        if module == 'numpy' or module.startswith('numpy.'):
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f'checkpoint holds {module}.{name}: only numpy arrays and plain '
            f'values load (an MLT checkpoint of the JAX package pickles its '
            f'flax MLTState and cannot be read here)')


def load_render_state(path):
    '''Returns dict(film, sample_index, mlt_state, meta, version) with film
    a numpy array and mlt_state None or a dict of numpy arrays, or None if
    no checkpoint exists.'''
    if not os.path.exists(path):
        return None
    with open(path, 'rb') as f:
        state = _NumpyUnpickler(f).load()
    if not isinstance(state, dict) or state.get('version') != 1:
        raise ValueError(f'{path}: not a version 1 render checkpoint')
    return state
