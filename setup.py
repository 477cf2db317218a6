from setuptools import setup, find_packages

setup(
    name='ptina_tpu',
    version='0.1.0',
    description='TPU-native differentiable Monte-Carlo path tracer (JAX/XLA/Pallas)',
    packages=find_packages(include=['ptina_tpu', 'ptina_tpu.*',
                                    'ptina_tpu_torch', 'ptina_tpu_torch.*']),
    package_data={'ptina_tpu_torch': ['csrc/*.cu', 'csrc/*.cuh']},
    python_requires='>=3.10',
)
