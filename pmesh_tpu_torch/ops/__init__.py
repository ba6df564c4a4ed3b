from . import kernels, fft, transfer, gridpm  # noqa: F401
