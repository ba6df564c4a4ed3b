"""Transfer functions: ``filter(k, v)`` closures for
``ComplexField.apply``.

Counterpart of the part of ``pmesh_tpu/ops/transfer.py`` that the
FastPM lattice path uses: the Poisson potential, the gradient and PM
force kernels (with the order-1 SuperLanczos difference) and the
Zel'dovich displacement kernel.
"""
import torch

__all__ = ["poisson", "gradient", "force_transfer", "dx1_transfer"]


def poisson():
    """-v / k^2: the gravitational potential of a density contrast."""
    def filter(k, v):
        k2 = k.normp(2, zeromode=1.0)
        mask = k.normp(2) > 0
        return -v / k2 * mask
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
