'''
The table of peaks a roofline share is taken against, and the bound of a
counted piece of work.

NVIDIA H100 SXM, NVIDIA's data sheet, dense rates, at a 700 W power
limit: 67 TFLOP/s in FP32 outside the tensor cores, 3.35 TB/s of HBM3.
A card set below 700 W runs slower under load; the run's host line
carries the card's name and power limit beside the share.
'''

PEAKS = {'H100': {'fp32_flops': 67e12, 'hbm_bytes': 3.35e12}}


def peak(device_kind):
    '''The peaks of the card named device_kind, or None.'''
    for key, val in PEAKS.items():
        if key in device_kind:
            return val
    return None


def bound_ms(flops, nbytes, device_kind):
    '''The least time the card could take: the larger of the operations
    over the FP32 peak and the bytes over the memory rate, in ms (None
    on an unknown card).'''
    pk = peak(device_kind)
    if pk is None:
        return None
    return max(flops / pk['fp32_flops'], nbytes / pk['hbm_bytes']) * 1e3
