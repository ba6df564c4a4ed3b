"""Power spectrum estimation on the mesh.

Counterpart of ``pmesh_tpu/ops/power.py``: one |k| binning over the
whole spectrum and three weighted bin sums (``index_add_``), with the
hermitian-compression weights so that each independent mode counts
once.  Where the spectrum is held in blocks (the slab and pencil
routes of ``pm.py``) each rank bins its own block, whose coordinates
and hermitian weights use the global indices, and the bin sums are
summed over the ranks (one ``all_reduce``).
"""
import numpy as np
import torch

__all__ = ["fftpower", "measure_power"]


def _hermitian_weights(comp):
    """Per-mode multiplicity of the compressed half spectrum: modes
    whose conjugate is not stored count twice."""
    dtype = comp.value.real.dtype
    if not comp.compressed:
        return torch.ones(comp.value.shape, dtype=dtype,
                          device=comp.value.device)
    last = comp.i[-1]
    w = torch.where((last != 0) & (last != comp.Nmesh[-1] // 2), 2.0, 1.0)
    return torch.broadcast_to(w.to(dtype), comp.value.shape)


def measure_power(comp, kedges=None, Nbins=None, dk=None, kmin=0.0,
                  remove_shotnoise=0.0):
    """Spherically averaged power spectrum of a complex field.

    Parameters
    ----------
    comp : a complex field (already the density contrast's)
    kedges : bin edges in k units; default linear bins of width dk (or
        the fundamental mode) up to the Nyquist, or Nbins bins
    remove_shotnoise : shot noise power to subtract (BoxSize^ndim / N)

    Returns
    -------
    k, power, nmodes : tensors on the field's device: the mean k, the
        mean P(k) (BoxSize^ndim volume normalization) and the number of
        independent modes of each bin.
    """
    BoxSize = comp.BoxSize
    knyq = np.pi * np.min(comp.Nmesh / BoxSize)
    kfun = 2 * np.pi / np.max(BoxSize)
    if kedges is None:
        if dk is None:
            dk = kfun
        if Nbins is None:
            kedges = np.arange(kmin, knyq + dk / 2, dk)
        else:
            kedges = np.linspace(kmin, knyq, Nbins + 1)
    kedges = np.asarray(kedges)

    k = comp.pm._apply_coords(type(comp), 'wavenumber')
    kmag = torch.sqrt(sum(ki ** 2 for ki in k))
    kmag = torch.broadcast_to(kmag, comp.value.shape)
    w = _hermitian_weights(comp)
    p = (comp.value.real ** 2 + comp.value.imag ** 2) * w

    # np.digitize(x, edges) - 1: the bin i of edges[i] <= x < edges[i+1],
    # compared in f8; outside the edges, the overflow bin nb
    nb = len(kedges) - 1
    edges = torch.as_tensor(kedges, dtype=torch.float64,
                            device=kmag.device)
    binid = torch.bucketize(kmag.reshape(-1).to(torch.float64), edges,
                            right=True) - 1
    binid = torch.where((binid < 0) | (binid >= nb), nb, binid)

    def bin_sum(x):
        x = x.reshape(-1)
        return x.new_zeros(nb + 1).index_add_(0, binid, x)

    psum, ksum, nsum = bin_sum(p), bin_sum(kmag * w), bin_sum(w)
    if comp.pm.blocked:
        from ..parallel.comm import all_reduce
        psum, ksum, nsum = all_reduce(torch.stack([psum, ksum, nsum]),
                                      comp.pm.procmesh, 'sum').unbind(0)
    vol = float(np.prod(BoxSize))
    nmodes = nsum[:nb]
    count = torch.clamp(nmodes, min=1)
    power = torch.where(nmodes > 0, psum[:nb] / count, 0.0) * vol \
        - remove_shotnoise
    kmean = torch.where(nmodes > 0, ksum[:nb] / count, 0.0)
    return kmean, power, nmodes


def fftpower(real, kedges=None, Nbins=None, dk=None, kmin=0.0,
             normalize=True, remove_shotnoise=0.0):
    """P(k) of a real field: with ``normalize`` its contrast
    value / mean - 1, then r2c and :func:`measure_power`."""
    if normalize:
        real = real.pm.create(type=type(real),
                              value=real.value / real.cmean() - 1.0)
    return measure_power(real.r2c(), kedges=kedges, Nbins=Nbins, dk=dk,
                         kmin=kmin, remove_shotnoise=remove_shotnoise)
