'''The process's CPU ms (all threads, time.process_time) over the window,
per sample.'''


def read(window):
    if not window.get('samples'):
        return None
    return window['cpu_s'] * 1e3 / window['samples']
