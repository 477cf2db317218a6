'''Process start to the first timed unit: imports, CUDA context, kernel
builds, scene, warm-up (and, in the inverse cell, the checked steps).'''


def read(window):
    return window['setup_s']
