"""Mesh FFTs with the pmesh normalization convention.

Counterpart of ``pmesh_tpu/ops/fft.py``: the forward transform is
scaled by prod(Nmesh)^-1 and the backward transform is unnormalized, so
c2r(r2c(x)) == x.  Both are ``torch.fft`` calls (cuFFT on the card):
over the hermitian-compressed half spectrum for a real mesh, full c2c
transforms with the same scaling for a complex one.  ``norm='forward'``
puts the whole 1/prod(Nmesh) on the forward transform.
"""
import torch

__all__ = ["r2c", "c2r", "is_c2c"]


def is_c2c(dtype):
    return dtype.is_complex


def r2c(value):
    """Forward transform of a mesh, scaled by prod(Nmesh)^-1: the half
    spectrum of a real mesh, the full spectrum of a complex one."""
    if is_c2c(value.dtype):
        return torch.fft.fftn(value, norm='forward')
    return torch.fft.rfftn(value, norm='forward')


def c2r(value, Nmesh, real_dtype):
    """Backward transform, unnormalized (inverse of r2c), to a mesh of
    ``real_dtype``: a c2c transform when that dtype is complex."""
    Nmesh = tuple(int(n) for n in Nmesh)
    if is_c2c(real_dtype):
        return torch.fft.ifftn(value, s=Nmesh, norm='forward').to(real_dtype)
    out = torch.fft.irfftn(value, s=Nmesh, norm='forward')
    return out.to(real_dtype)
