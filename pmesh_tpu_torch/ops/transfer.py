"""Transfer functions: ``filter(k, v)`` closures for
``ComplexField.apply``.

Counterpart of ``pmesh_tpu/ops/transfer.py``: the Laplace and Poisson
kernels, the Gaussian and long-range smoothings, the constant, the
DC-mode filters, the SuperLanczos difference, the gradient and PM force
kernels, the Zel'dovich displacement kernel and the CIC
decompensation.  ``super_lanzcos_diff`` and ``cic_decompensate`` take
circular frequencies (``apply(kind='circular')``), the rest
wavenumbers.
"""
import numpy as np
import torch

__all__ = ["laplace", "poisson", "gaussian", "constant", "remove_dc",
           "normalize_dc", "super_lanzcos_diff", "cic_decompensate",
           "gradient", "force_transfer", "dx1_transfer", "longrange"]


def laplace():
    """v / k^2 with the zero mode suppressed."""
    def filter(k, v):
        k2 = k.normp(2, zeromode=1.0)
        mask = k.normp(2) > 0
        return v / k2 * mask
    return filter


def poisson():
    """-v / k^2: the gravitational potential of a density contrast."""
    def filter(k, v):
        k2 = k.normp(2, zeromode=1.0)
        mask = k.normp(2) > 0
        return -v / k2 * mask
    return filter


def gaussian(smoothing):
    """exp(-0.5 k^2 s^2)."""
    def filter(k, v):
        return v * torch.exp(-0.5 * k.normp(2) * smoothing ** 2)
    return filter


def longrange(r_split):
    """The long-range force split exp(-k^2 r_split^2); the identity
    for r_split == 0."""
    if r_split == 0:
        return lambda k, v: v

    def filter(k, v):
        return v * torch.exp(-k.normp(2) * r_split ** 2)
    return filter


def constant(C):
    """v * C."""
    def filter(k, v):
        return v * C
    return filter


def remove_dc():
    """Zero the k == 0 mode."""
    def filter(k, v):
        return v * (k.normp(2) > 0)
    return filter


def normalize_dc():
    """Divide by the DC mode (the first element), so the field becomes
    1 + delta; the DC mode must not be zero."""
    def filter(k, v):
        return v / v.reshape(-1)[0].real
    return filter


def super_lanzcos_diff(dir, order=1):
    """i D(w) v along ``dir`` at circular frequency w: D(w) = w for
    order 0, the order-1 SuperLanczos 1/6 (8 sin w - sin 2w) else."""
    def filter(w, v):
        wd = w[dir]
        if order == 0:
            kd = wd
        else:
            kd = 1.0 / 6.0 * (8 * torch.sin(wd) - torch.sin(2 * wd))
        return v * 1j * kd
    return filter


def _super_lanczos(k, dir):
    # order-1 SuperLanczos difference 1/(6h) (8 sin(kh) - sin(2kh));
    # it vanishes at Nyquist
    cellsize = float(k.BoxSize[dir] / k.Nmesh[dir])
    w = k[dir] * cellsize
    return 1.0 / (6.0 * cellsize) * (8 * torch.sin(w) - torch.sin(2 * w))


def gradient(dir, order=1):
    """i k_dir v; order=1 takes the SuperLanczos difference for k_dir."""
    def filter(k, v):
        kd = k[dir] if order == 0 else _super_lanczos(k, dir)
        return v * 1j * kd
    return filter


def force_transfer(dir, order=1):
    """The PM force kernel i k_d / k^2; order=1 takes the SuperLanczos
    difference for k_d."""
    def filter(k, v):
        k2 = k.normp(2, zeromode=1.0)
        kd = k[dir] if order == 0 else _super_lanczos(k, dir)
        return 1j * kd / k2 * v
    return filter


def dx1_transfer(dir):
    """Zel'dovich displacement kernel i k_d / k^2."""
    def filter(k, v):
        k2 = k.normp(2, zeromode=1.0)
        return 1j * k[dir] / k2 * v
    return filter


def cic_decompensate(order=2):
    """Divide out the CIC window, prod_d sinc(w_d / 2 pi)^order, at
    circular frequency w."""
    def filter(w, v):
        tf = 1.0
        for wd in w:
            tf = tf * torch.sinc(wd / (2 * np.pi)) ** order
        return v / tf
    return filter
