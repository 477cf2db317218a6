'''Wall ms, synchronised, of a step's torch.autograd.grad, the mean over
the window's steps.'''


def read(window):
    return window.get('backward_ms')
