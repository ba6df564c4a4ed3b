"""The distributed FFTs: the slab transforms (one all_to_all per
direction, even and padded uneven slabs) and the pencil transforms (two).

Counterpart of ``pmesh_tpu/parallel/pfft.py`` (``_r2c_sharded``,
``_r2c_uneven``, ``_r2c_pencil`` and their inverses).  For a real
(N0, N1, N2) mesh over the P ranks of a 1-d grid:

  local real slab       (rows_b, N1, N2)    padded to rows = ceil(N0/P)
  rfft2 over (y, z)  -> (rows, N1, Zh)      local, torch.fft (cuFFT)
                                            y padded to n1 P, n1 = ceil(N1/P)
  all_to_all         -> (rows P, n1, Zh)    split y, gather x
  fft over x         -> (N0, n1, Zh)        the x padding sliced off first

giving the *transposed* layout of ``pm.py`` (whole x, y block r); the
inverse undoes it, so a round trip costs two all_to_alls and never
reorders back.  Each axis is transformed while it is whole on the rank
and unpadded: the dead x rows of the last slabs are zero real rows that
no DFT over x sees, the dead y columns are appended after the y DFT and
sliced off (``_r2c_uneven``).  Where P divides N0 and N1 nothing is
padded.  A c2c mesh transforms every axis as complex; a 2-d real mesh
takes the real DFT over y, whose Ny // 2 + 1 columns are then split as
the y axis of the spectrum.

On an (npx, npy) grid (3-d meshes whose N0 and N1 both grid axes
divide, the pencil route of ``pm.py``):

  real pencil   (N0/px, N1/py, N2)          z whole
  rfft over z   (N0/px, N1/py, Zh)          Zh padded to Zp = ceil(Zh/py) py
  all_to_all over the grid's axis 1 (split z, gather y)
                (N0/px, N1, Zp/py)          fft over y
  all_to_all over the grid's axis 0 (split y, gather x)
                (N0, N1/px, Zp/py)          fft over x

so x is whole, y is split over the grid's first axis and the padded z
over its second; each rank keeps the real columns of its z block (the
last ranks hold fewer, or none).

The normalization is ``ops/fft.py``'s: the forward scaled by
1/prod(Nmesh), the inverse unnormalized.  Every inverse keeps numpy's
irfftn convention on the card: after the complex inverses, the real
inverse over the last axis reads only the real part of its DC (and, for
an even length, Nyquist) column.  A spectrum that is not hermitian there
(an odd filter's Nyquist modes, i k_x with the Nyquist index -N/2) leaves
imaginary parts in that column, which cuFFT's C2R reads at some lengths
(256 on an H100), unlike pocketfft and cuFFT's own 3-d irfftn (ROADMAP
queue 3).
"""
import torch
import torch.nn.functional as F

from .comm import all_to_all

__all__ = ["r2c", "c2r", "r2c_pencil", "c2r_pencil"]


def _pad_to(x, axis, n):
    """``x`` with zeros appended along ``axis`` up to length n"""
    extra = n - x.shape[axis]
    if extra <= 0:
        return x
    if x.is_complex():
        return torch.view_as_complex(_pad_to(torch.view_as_real(x),
                                             axis % x.dim(), n))
    pad = [0, 0] * (x.dim() - axis % x.dim() - 1) + [0, extra]
    return F.pad(x, pad)


def _irfft_last(c, n, real_dtype):
    """the real inverse over the last axis of length n (unnormalized),
    reading only the real part of the DC and Nyquist columns"""
    edge = torch.zeros(c.shape[-1], dtype=torch.bool, device=c.device)
    edge[[0, n // 2] if n % 2 == 0 else [0]] = True
    c = torch.where(edge, c.real.to(c.dtype), c)
    return torch.fft.irfft(c, n=n, dim=-1, norm='forward').to(real_dtype)


def _blocks(n, P):
    return -(-int(n) // P)


def r2c(pm, value, Nmesh):
    """Forward transform of this rank's real (or c2c) slab (rows_b, N1,
    ...) to its y block (N0, n1_b, ...) of the spectrum (the half
    spectrum of a real mesh), scaled by 1/prod(Nmesh)."""
    P = pm.size
    Nmesh = tuple(int(n) for n in Nmesh)
    ndim, (N0, N1) = len(Nmesh), Nmesh[:2]
    rows, n1 = _blocks(N0, P), _blocks(N1, P)
    c2c = value.is_complex()
    r = _pad_to(value, 0, rows)
    axes = tuple(range(1, ndim))
    if c2c:
        c = torch.fft.fftn(r, dim=axes, norm='forward')
    else:
        c = torch.fft.rfftn(r, dim=axes, norm='forward')
    ny = c.shape[1]
    c = _pad_to(c, 1, n1 * P)
    c = all_to_all(c, pm, split_axis=1, concat_axis=0)
    if c.shape[0] != N0:
        c = c[:N0]
    c = torch.fft.fft(c, dim=0, norm='forward')
    start, stop = pm.block(ny, chunk=n1)
    return c[:, :stop - start] if stop - start != n1 else c


def c2r(pm, value, Nmesh, real_dtype):
    """Unnormalized inverse of :func:`r2c`: the y block (N0, n1_b, ...)
    to this rank's slab (rows_b, N1, ...) of the real mesh (complex for
    a complex ``real_dtype``)."""
    P = pm.size
    Nmesh = tuple(int(n) for n in Nmesh)
    ndim, (N0, N1) = len(Nmesh), Nmesh[:2]
    rows, n1 = _blocks(N0, P), _blocks(N1, P)
    ny = N1 if (real_dtype.is_complex or ndim > 2) else N1 // 2 + 1
    # an empty y block (the last ranks of an uneven mesh) has no DFT
    c = torch.fft.ifft(value, dim=0, norm='forward') if value.numel() \
        else value.to(torch.promote_types(value.dtype, torch.complex64))
    c = _pad_to(_pad_to(c, 1, n1), 0, rows * P)
    c = all_to_all(c, pm, split_axis=0, concat_axis=1)
    if c.shape[1] != ny:
        c = c[:, :ny]
    if real_dtype.is_complex:
        r = torch.fft.ifftn(c, dim=tuple(range(1, ndim)), norm='forward')
    else:
        if ndim > 2:
            c = torch.fft.ifftn(c, dim=tuple(range(1, ndim - 1)),
                                norm='forward')
        r = _irfft_last(c, Nmesh[-1], real_dtype)
    start, stop = pm.block(N0)
    return r[:stop - start] if stop - start != rows else r


def _zpad(Nmesh, py, c2c):
    zh = int(Nmesh[-1]) if c2c else int(Nmesh[-1]) // 2 + 1
    return zh, _blocks(zh, py) * py


def r2c_pencil(pm, value, Nmesh):
    """Forward pencil transform of this rank's real (or c2c) pencil
    (N0/px, N1/py, N2) to its block (N0, N1/px, zb) of the spectrum, zb
    the real columns of its z block, scaled by 1/prod(Nmesh)."""
    Nmesh = tuple(int(n) for n in Nmesh)
    ndim = len(Nmesh)
    ax0, ax1 = pm.along(0), pm.along(1)
    c2c = value.is_complex()
    zh, zp = _zpad(Nmesh, ax1.size, c2c)
    axes = tuple(range(2, ndim))
    if c2c:
        c = torch.fft.fftn(value, dim=axes, norm='forward')
    else:
        c = torch.fft.rfftn(value, dim=axes, norm='forward')
    c = _pad_to(c, ndim - 1, zp)
    c = all_to_all(c, ax1, split_axis=ndim - 1, concat_axis=1)
    c = torch.fft.fft(c, dim=1, norm='forward')
    c = all_to_all(c, ax0, split_axis=1, concat_axis=0)
    c = torch.fft.fft(c, dim=0, norm='forward')
    start, stop = pm.block(zh, 1, chunk=zp // ax1.size)
    return c[..., :stop - start] if stop - start != c.shape[-1] else c


def c2r_pencil(pm, value, Nmesh, real_dtype):
    """Unnormalized inverse of :func:`r2c_pencil`: the block (N0, N1/px,
    zb) to this rank's real (or complex) pencil (N0/px, N1/py, N2)."""
    Nmesh = tuple(int(n) for n in Nmesh)
    ndim = len(Nmesh)
    ax0, ax1 = pm.along(0), pm.along(1)
    zh, zp = _zpad(Nmesh, ax1.size, real_dtype.is_complex)
    c = _pad_to(value, ndim - 1, zp // ax1.size)
    c = torch.fft.ifft(c, dim=0, norm='forward')
    c = all_to_all(c, ax0, split_axis=0, concat_axis=1)
    c = torch.fft.ifft(c, dim=1, norm='forward')
    c = all_to_all(c, ax1, split_axis=1, concat_axis=ndim - 1)
    if c.shape[-1] != zh:
        c = c[..., :zh]
    if real_dtype.is_complex:
        return torch.fft.ifftn(c, dim=tuple(range(2, ndim)), norm='forward')
    if ndim > 3:
        c = torch.fft.ifftn(c, dim=tuple(range(2, ndim - 1)),
                            norm='forward')
    return _irfft_last(c, Nmesh[-1], real_dtype)
