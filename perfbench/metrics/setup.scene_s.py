'''Host seconds of the program's scene builds in set-up: the scene.build
spans (scene.make_scene, recorded whether or not tracing is on), summed,
from ptina_tpu_torch.utils.trace.summary().'''


def read(window):
    try:
        from ptina_tpu_torch.utils.trace import summary
    except ImportError:  # a program without the recorder
        return None
    got = summary()['always'].get('scene.build')
    return got['host_ns'] * 1e-9 if got else None
