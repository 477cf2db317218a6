'''The yardstick's bound a sample (the configuration file's counted work,
against the card's peaks) over the path kernel's device ms a sample, in
percent.'''

from perfbench.harness.roofline import share


def read(window):
    if window.get('path_ms') is None or not window.get('samples'):
        return None
    return share(window, 'path_kernel', window['path_ms'] / window['samples'])
