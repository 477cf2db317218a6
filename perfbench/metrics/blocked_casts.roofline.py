'''The yardstick's bound a sample (the configuration file's counted work,
against the card's peaks) over the blocked casts' device ms a sample, in
percent.'''

from perfbench.harness.roofline import share


def read(window):
    if window.get('blocked_ms') is None or not window.get('samples'):
        return None
    return share(window, 'blocked_casts',
                 window['blocked_ms'] / window['samples'])
