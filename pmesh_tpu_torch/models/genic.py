"""2LPT grid initial conditions (the GridIC app).

Counterpart of ``pmesh_tpu/models/genic.py``: Zel'dovich displacements
through a Poisson and SuperLanczos-difference transfer chain read out
at the (optionally shifted) particle grid, and the 2LPT term from the
strain products, scaled by 3/7.  ``Solver.lpt`` is the modern path
(plain ik/k^2 kernels); GridIC keeps the finite-difference kernels and
the (P, stats) output of the reference.
"""
import numpy as np
import torch

from ..pm import ParticleMesh, RealField
from ..ops import transfer as tf
from ..ops import paint as _paint_ops

__all__ = ["GridIC"]


def GridIC(PowerSpectrum, BoxSize, Ngrid, D1, seed=None, shift=0.5,
           order=1, dlinear=None, compat='gadget', device=None):
    """Generate 2LPT grid ICs on an f8 Ngrid^3 mesh.

    Parameters
    ----------
    PowerSpectrum : callable P(k) on tensors (z=0, (Mpc/h)^3)
    D1 : float, the linear growth to the starting time
    order : SuperLanczos differentiation order of the ZA gradient
    dlinear : complex field or None
        the linear overdensity; if None, made from white noise of
        ``seed`` (``compat``), cut at the Nyquist
    device : torch device (default the current CUDA device; raises
        without CUDA: pass 'cpu')

    Returns
    -------
    P : dict of tensors: Position, Q, ZA, 2LPT, ID, ICDensity
    stats : dict
    """
    pm = ParticleMesh(BoxSize=BoxSize, Nmesh=[Ngrid] * 3, device=device)
    Q, ID = pm.generate_uniform_particle_grid(shift=shift, return_id=True)

    if dlinear is None:
        gauss = pm.generate_whitenoise(seed, type='complex', compat=compat)
        knyq = np.pi * Ngrid / BoxSize

        def amplitude(k, v):
            kmag = k.normp(2) ** 0.5
            wt = (PowerSpectrum(kmag) / k.BoxSize.prod()) ** 0.5 * D1
            wt = torch.where(kmag == 0, 0.0, wt)
            # cut at the Nyquist
            wt = torch.where(kmag >= knyq, 0.0, wt)
            return v * wt
        dlinear = gauss.apply(amplitude)

    a = pm.affine

    def read(comp):
        return _paint_ops.readout(comp.c2r().value, Q,
                                  window=pm.resampler.window,
                                  scale=a.scale, translate=a.translate,
                                  period=a.period)

    # potential = delta / k^2; ZA displacement -grad phi
    phik = dlinear.apply(tf.poisson())
    ZA = -torch.stack([read(phik.apply(tf.gradient(d, order=order)))
                       for d in range(3)], dim=-1)

    # the 2LPT source from the strain products
    def strain(a_, b_):
        def filt(k, v):
            return -v * k[a_] * k[b_] / k.normp(2, zeromode=1.0)
        return dlinear.apply(filt).c2r().value

    s00, s11, s22 = strain(0, 0), strain(1, 1), strain(2, 2)
    field = (s00 * s11 + s11 * s22 + s22 * s00
             - strain(0, 1) ** 2
             - strain(0, 2) ** 2
             - strain(1, 2) ** 2)
    srck = pm.create(type=RealField, value=field).r2c()
    LPT2 = -torch.stack([
        read(srck.apply(tf.poisson()).apply(tf.gradient(d, order=0)))
        for d in range(3)], dim=-1) * (3.0 / 7)

    P = {
        'Position': torch.remainder(Q + ZA * 0, BoxSize),  # the grid
        'Q': Q,
        'ZA': ZA,
        '2LPT': LPT2,
        'ID': ID,
        # the linear overdensity at the particles
        'ICDensity': read(dlinear),
    }
    stats = dict(
        BoxSize=BoxSize,
        Ngrid=Ngrid,
        stdZA=float(torch.sqrt(torch.mean(torch.sum(ZA ** 2, dim=-1))))
        / BoxSize * Ngrid,
        std2LPT=float(torch.sqrt(torch.mean(torch.sum(LPT2 ** 2, dim=-1))))
        / BoxSize * Ngrid,
    )
    return P, stats
