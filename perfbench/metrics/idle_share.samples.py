'''1 - the device's busy seconds (the profiler's operations and the
program's kernels by CUDA events, merged) over the profiled segment's
wall, in percent.'''


def read(window):
    if not window.get('profiled_s'):
        return None
    return 100.0 * (1.0 - window['busy_s'] / window['profiled_s'])
