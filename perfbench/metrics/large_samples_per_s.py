'''Full-film samples completed in the window over its seconds.'''


def read(window):
    if 'samples' not in window:
        return None
    return window['samples'] / window['window_s']
