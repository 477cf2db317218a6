'''Device ms of the path megakernel's launches (CUDA events around each)
over the window's samples.'''


def read(window):
    if window.get('path_ms') is None or not window.get('samples'):
        return None
    return window['path_ms'] / window['samples']
