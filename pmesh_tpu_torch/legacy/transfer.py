"""Deprecated transfer function library.

Counterpart of ``pmesh_tpu/legacy/transfer.py``: ``TransferFunction``,
whose members are ``f(pm, complex) -> complex`` for the chains of
``legacy.particlemesh.ParticleMesh.transfer`` and ``c2r``.  They act on
whole tensors through the circular frequencies ``pm.w`` (tensors on the
mesh's device) and return a new tensor.
"""
import warnings

import numpy as np
import torch

warnings.warn("legacy.transfer.TransferFunction is deprecated; use "
              "pmesh_tpu_torch.ops.transfer with Field.apply",
              DeprecationWarning)

__all__ = ["TransferFunction"]


def _w2(pm):
    return sum(wi ** 2 for wi in pm.w)


class TransferFunction:

    @staticmethod
    def NormalizeDC(pm, complex):
        """Divide by the DC amplitude (the mean)."""
        dc = torch.abs(complex.reshape(-1)[0])
        return complex / dc

    @staticmethod
    def RemoveDC(pm, complex):
        mask = _w2(pm) > 0
        return complex * mask

    @staticmethod
    def Trilinear(pm, complex):
        """Divide out the CIC (trilinear) window: sinc^2 per axis."""
        tf = 1.0
        for wi in pm.w:
            tf = tf * torch.sinc(wi / (2 * np.pi)) ** 2
        return complex / tf

    @staticmethod
    def SuperLanzcos(dir, order=3):
        """i * D(w_dir) with the smooth super-lanczos difference kernel
        1/6 (8 sin w - sin 2w); order=0 gives plain i*w."""
        def SuperLanzcosDir(pm, complex):
            wi = pm.w[dir] * 1.0
            if order == 0:
                return complex * (wi * 1j)
            tmp = 1 / 6.0 * (8 * torch.sin(wi) - torch.sin(2 * wi))
            return complex * (tmp * 1j)
        return SuperLanzcosDir

    @staticmethod
    def Gaussian(smoothing):
        """exp(-0.5 w^2 s^2), s in mesh units."""
        sm2 = smoothing ** 2

        def GaussianS(pm, complex):
            return complex * torch.exp(-0.5 * _w2(pm) * sm2)
        return GaussianS

    @staticmethod
    def Constant(C):
        def Constant_(pm, complex):
            return complex * C
        return Constant_

    @staticmethod
    def Inspect(name, *indices):
        def Inspect_(pm, complex):
            V = ['%s = %s' % (str(i), str(complex[tuple(i)]))
                 for i in indices]
            print(name, ','.join(V))
            return complex
        return Inspect_

    @staticmethod
    def PowerSpectrum(wout, psout):
        """Binned |delta|^2 over |w|; run after NormalizeDC/RemoveDC.
        The results are written into the given host arrays: psout = P/N
        and wout = the mean |w| of each bin."""
        wedges = np.linspace(0, np.pi, len(psout) + 1)

        def PS(pm, complex):
            wmag = torch.broadcast_to(torch.sqrt(_w2(pm)), complex.shape)
            p = complex.real ** 2 + complex.imag ** 2
            nb = len(psout)
            # np.digitize's bins: edges[i - 1] <= |w| < edges[i] is bin i - 1
            binid = torch.bucketize(
                wmag.reshape(-1), torch.as_tensor(wedges, dtype=wmag.dtype,
                                                  device=wmag.device),
                right=True) - 1
            binid = torch.where((binid < 0) | (binid >= nb), nb, binid)

            def binsum(x):
                return torch.zeros(nb + 1, dtype=x.dtype,
                                   device=x.device).index_add_(
                    0, binid, x.reshape(-1))
            psum = binsum(p)
            wsum = binsum(wmag)
            nsum = binsum(torch.ones_like(wmag))
            n = np.maximum(nsum[:nb].cpu().numpy(), 1)
            psout[:] = psum[:nb].cpu().numpy() / n
            wout[:] = wsum[:nb].cpu().numpy() / n
            return complex
        return PS

    @staticmethod
    def Laplace(pm, complex):
        """complex *= -w^2 (with the zero mode killed)."""
        w2 = _w2(pm)
        return complex * torch.where(w2 == 0, 0.0, -w2)

    @staticmethod
    def Poisson(pm, complex):
        """complex /= -w^2 (with the zero mode killed)."""
        w2 = _w2(pm)
        safe = torch.where(w2 == 0, 1.0, w2)
        return torch.where(w2 == 0, 0.0, complex / (-safe))
