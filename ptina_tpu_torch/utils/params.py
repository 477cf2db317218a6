'''
Named tunable parameters with ranges.

Reference: ptina_tpu/utils/params.py (reference Globals debug-slider
registry, ptina/tools/globals.py:8-42), copied: `add(name, default, min,
max)` registers a scalar, `get` reads it, `set` clamps it into its range,
and front-ends enumerate `items()` to build sliders.  Values are plain
Python floats on the host.
'''

__all__ = ['Params']


class Params:
    def __init__(self):
        self._vals = {}
        self._meta = {}

    def add(self, name, default=0.0, lo=0.0, hi=1.0):
        if name not in self._vals:
            self._vals[name] = float(default)
            self._meta[name] = (float(lo), float(hi))
        return self._vals[name]

    def get(self, name):
        return self._vals[name]

    def set(self, name, value):
        lo, hi = self._meta[name]
        self._vals[name] = float(min(max(value, lo), hi))

    def items(self):
        '''Yields (name, value, lo, hi) for building UI sliders.'''
        for name, val in self._vals.items():
            lo, hi = self._meta[name]
            yield name, val, lo, hi

    def __contains__(self, name):
        return name in self._vals
