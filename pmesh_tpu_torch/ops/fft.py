"""Mesh FFTs with the pmesh normalization convention.

Counterpart of ``pmesh_tpu/ops/fft.py`` for real meshes: the forward
transform is scaled by prod(Nmesh)^-1 and the backward transform is
unnormalized, so c2r(r2c(x)) == x.  Both are ``torch.fft`` calls
(cuFFT on the card) over the hermitian-compressed half spectrum;
``norm='forward'`` puts the whole 1/prod(Nmesh) on the forward
transform.
"""
import torch

__all__ = ["r2c", "c2r"]


def r2c(value):
    """Forward transform of a real mesh, scaled by prod(Nmesh)^-1."""
    return torch.fft.rfftn(value, norm='forward')


def c2r(value, Nmesh, real_dtype):
    """Backward transform to a real mesh, unnormalized (inverse of r2c)."""
    Nmesh = tuple(int(n) for n in Nmesh)
    out = torch.fft.irfftn(value, s=Nmesh, norm='forward')
    return out.to(real_dtype)
