'''A roofline share from the configuration file's counted yardstick.'''

from perfbench.harness.peaks import bound_ms


def share(window, kernel, ms_per_sample):
    '''100 x the counted work's bound a sample over the measured ms a
    sample, or None where the configuration has no count for `kernel` or
    the card has no peaks in the table.'''
    counted = window['config'].get('yardstick', {}).get('counted')
    if not counted or counted.get('kernel') != kernel or ms_per_sample <= 0:
        return None
    b = bound_ms(counted['flops_per_sample'], counted['bytes_per_sample'],
                 window.get('device_kind', ''))
    return None if b is None else 100.0 * b / ms_per_sample
