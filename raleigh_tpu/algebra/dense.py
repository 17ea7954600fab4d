"""Backend selection and the architecture-aware dense-matrix wrapper.

Parity with the reference's ``dense_cpu.py`` try-import selector and
``AMatrix`` arch switch (raleigh/algebra/dense_cpu.py:10-17,
dense_matrix.py:10-64), re-targeted at JAX devices:

  arch='cpu'                   host NumPy algebra
  arch='gpu' / 'tpu' / 'jax'   JAX algebra on JAX's default device (all
                               three names mean the same and route the
                               same way)
  arch='gpu!' (etc.)           the same, but raise if JAX's default
                               device is the host CPU
"""

import numpy as np

DEVICE_ARCHS = ('gpu', 'tpu', 'jax')


def is_device_arch(arch):
    """True when ``arch`` selects JAX device algebra."""
    return str(arch).lower().startswith(DEVICE_ARCHS)


def best_backend(arch='gpu'):
    """Return (module, name) for the requested architecture string."""
    arch = str(arch).lower()
    if not is_device_arch(arch):
        from . import dense_numpy
        return dense_numpy, 'numpy'
    from . import dense_jax
    if arch.endswith('!'):
        import jax
        platform = jax.devices()[0].platform
        if platform == 'cpu':
            raise RuntimeError("arch=%r needs an accelerator, but JAX's "
                               "default device is %r" % (arch, platform))
    return dense_jax, 'jax'


class AMatrix:
    """Architecture-aware wrap of a dense 2D array (reference
    raleigh/algebra/dense_matrix.py:10-64)."""

    def __init__(self, a, arch='cpu', copy_data=False, sharding=None):
        self.__arch = arch
        backend, name = best_backend(arch)
        self.__backend = backend
        self.__backend_name = name
        if name == 'jax':
            self.__op = backend.Matrix(a, sharding=sharding)
        else:
            self.__op = backend.Matrix(a.copy() if copy_data else a)
        self.__vectors = None
        self.__scale = float(np.max(np.abs(a)) if a.size else 0.0)

    def as_operator(self):
        return self.__op

    def as_vectors(self):
        if self.__vectors is None:
            self.__vectors = self.__backend.Vectors(self.__op, shallow=True)
        return self.__vectors

    def arch(self):
        return self.__arch

    def backend(self):
        return self.__backend

    def backend_name(self):
        return self.__backend_name

    def gpu(self):
        # reference API compat (dense_matrix.py:50): truthy when on device
        return None

    def dots(self):
        return self.__op.dots()

    def data_type(self):
        return self.__op.data_type()

    def shape(self):
        return self.__op.shape()

    def order(self):
        return self.__op.order()

    def scale(self):
        return self.__scale
