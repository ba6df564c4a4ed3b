"""The slab-distributed real FFT: one all_to_all per direction.

Counterpart of the slab transforms of ``pmesh_tpu/parallel/pfft.py``
(``_r2c_sharded``/``_c2r_sharded``, 3-d real meshes).  For a real
(N0, N1, N2) mesh over P ranks:

  local real slab       (N0/P, N1, N2)
  rfft2 over (y, z)  -> (N0/P, N1, Zh)      local, torch.fft (cuFFT)
  all_to_all         -> (N0, N1/P, Zh)      split y, gather x
  fft over x         -> (N0, N1/P, Zh)      local

giving the *transposed* layout of ``pm.py`` (whole x, y-chunk r); the
inverse undoes it, so a round trip costs two all_to_alls and never
reorders back.  The normalization is ``ops/fft.py``'s: the forward
scaled by 1/prod(Nmesh), the inverse unnormalized.  The pencil, uneven
and matmul transforms of the JAX package are not ported.
"""
import torch

from .comm import all_to_all

__all__ = ["r2c", "c2r"]


def r2c(pm, value):
    """Forward transform of this rank's real slab (N0/P, N1, N2) to its
    y-chunk (N0, N1/P, Zh) of the half spectrum, scaled by 1/N^3."""
    c = torch.fft.rfft2(value, norm='forward')
    c = all_to_all(c, pm, split_axis=1, concat_axis=0)
    return torch.fft.fft(c, dim=0, norm='forward')


def c2r(pm, value, Nmesh, real_dtype):
    """Unnormalized inverse of :func:`r2c`: the y-chunk (N0, N1/P, Zh)
    to this rank's real slab (N0/P, N1, N2)."""
    c = torch.fft.ifft(value, dim=0, norm='forward')
    c = all_to_all(c, pm, split_axis=0, concat_axis=1)
    s = tuple(int(n) for n in Nmesh[1:])
    return torch.fft.irfft2(c, s=s, norm='forward').to(real_dtype)
