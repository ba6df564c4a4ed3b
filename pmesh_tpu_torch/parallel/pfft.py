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
    to this rank's real slab (N0/P, N1, N2).

    numpy's irfftn convention, kept on the card: after the complex
    inverse over x and y, the real inverse over z reads only the real
    part of its DC (and, N2 even, Nyquist) column.  A spectrum that is
    not hermitian there (an odd filter's Nyquist modes, i k_x with the
    Nyquist index -N/2) leaves imaginary parts in that column, which
    cuFFT's C2R reads at some lengths (256 on an H100), unlike pocketfft
    and cuFFT's own 3-d irfftn (ROADMAP queue 3)."""
    c = torch.fft.ifft(value, dim=0, norm='forward')
    c = all_to_all(c, pm, split_axis=0, concat_axis=1)
    c = torch.fft.ifft(c, dim=1, norm='forward')
    n2 = int(Nmesh[2])
    for z in (0, n2 // 2) if n2 % 2 == 0 else (0,):
        c[..., z] = c[..., z].real
    return torch.fft.irfft(c, n=n2, dim=2, norm='forward').to(real_dtype)
