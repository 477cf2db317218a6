'''Device ms of the blocked casts' launches (blocked_shade and blocked_any,
CUDA events around each) over the window's samples.'''


def read(window):
    if window.get('blocked_ms') is None or not window.get('samples'):
        return None
    return window['blocked_ms'] / window['samples']
