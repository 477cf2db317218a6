'''Wall ms, synchronised, of a step's forward (the program's
diff.render_image_diff), the mean over the window's steps.'''


def read(window):
    return window.get('forward_ms')
