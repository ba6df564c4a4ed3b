"""Measurement utilities: snapshot power spectra and strain tensors.

Counterpart of ``pmesh_tpu/utils/measure.py``: the P(k) of a particle
snapshot and the strain (tidal) tensor at the particles, through the
generic paint and readout and ``torch.fft``.  They run on ``device``
(default the current CUDA device).
"""
import numpy as np
import torch

from ..pm import ParticleMesh
from ..ops.power import fftpower
from ..ops import transfer as tf
from ..ops import paint as _paint_ops

__all__ = ["snapshot_power", "strain_tensor"]


def _positions(pos, pm):
    return torch.as_tensor(pos, device=pm.device).to(pm.torch_dtype)


def snapshot_power(pos, BoxSize, Nmesh, resampler='tsc',
                   compensate=True, Nbins=None, device=None):
    """P(k) of a particle snapshot: paint, deconvolve the window,
    bin; shot noise subtracted.  Returns (k, P, Nmodes) tensors."""
    pm = ParticleMesh(BoxSize=BoxSize, Nmesh=[Nmesh] * pos.shape[-1],
                      resampler=resampler, device=device)
    pos = _positions(pos, pm)
    layout = pm.decompose(pos)
    rho = pm.paint(pos, layout=layout)
    if compensate:
        comp = rho.r2c().apply(pm.resampler.get_compensation(),
                               kind='circular')
        rho = comp.c2r()
    N = pos.shape[0]
    return fftpower(rho, Nbins=Nbins,
                    remove_shotnoise=float(np.prod(pm.BoxSize)) / N)


def strain_tensor(pos, BoxSize, Nmesh, smoothing=None, order=1,
                  device=None):
    """The symmetric strain tensor d^2 phi / dx_a dx_b of the density
    potential at the particles, (N, 6) in the order (00, 01, 02, 11, 12,
    22): the six second-derivative meshes read in one readout."""
    pm = ParticleMesh(BoxSize=BoxSize, Nmesh=[Nmesh] * 3,
                      resampler='cic', device=device)
    pos = _positions(pos, pm)
    layout = pm.decompose(pos)
    rho = pm.paint(pos, layout=layout)
    rhok = rho.r2c()
    if smoothing is not None:
        rhok = rhok.apply(tf.gaussian(smoothing))
    phik = rhok.apply(tf.poisson())

    a = pm.affine
    pairs = [(0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2)]
    meshes = []
    for (i, j) in pairs:
        def second(k, v, i=i, j=j):
            return -v * k[i] * k[j]
        meshes.append(phik.apply(second).c2r().value)
    vals = _paint_ops.readout(tuple(meshes), pos,
                              window=pm.resampler.window,
                              scale=a.scale, translate=a.translate,
                              period=a.period)
    return torch.stack(vals, dim=-1)
