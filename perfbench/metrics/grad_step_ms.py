'''The window's wall time over the optimisation steps completed in it.'''


def read(window):
    if not window.get('steps'):
        return None
    return window['window_s'] * 1e3 / window['steps']
