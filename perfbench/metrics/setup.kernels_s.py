'''Host seconds of the program's kernel library builds and loads: the
kernels.build spans (utils/cuda_build.build_shared_library; nvcc runs
only where no library of the sources' hash is built), summed, from
ptina_tpu_torch.utils.trace.summary().'''


def read(window):
    try:
        from ptina_tpu_torch.utils.trace import summary
    except ImportError:  # a program without the recorder
        return None
    got = summary()['always'].get('kernels.build')
    return got['host_ns'] * 1e-9 if got else None
