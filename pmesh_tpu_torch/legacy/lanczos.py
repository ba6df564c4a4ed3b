"""Prototype painter with an arbitrary callable window (deprecated).

Counterpart of ``pmesh_tpu/legacy/lanczos.py``: the windows ``linear``,
``cubic``, ``lanczos(a)``, ``kaiser(a, alpha)``, ``lanczos2`` and
``lanczos3`` (callables on a tensor of offsets, with ``.support`` and
``.integral``), and a paint and readout that evaluate any such callable
one stencil offset at a time: the paint by ``index_add_``, the readout
by gathers.  The supported path is ``window.py`` and ``ops/paint.py``.

``mode='raise'`` checks that no particle lies beyond the window's reach
of the mesh, on the mesh's device (one flag read by the host); the JAX
package skips that check under tracing, and the port has no tracing,
so it always checks.  ``mode='ignore'`` drops the contributions outside
the mesh; a ``period`` wraps them.  ``mesh`` is a tensor, whose device
runs the paint; a numpy mesh goes to ``device`` (default the current
CUDA device; pass ``device='cpu'`` on the CPU).
"""
import warnings

import numpy as np
import torch

from .cic import _inputs

warnings.warn("pmesh_tpu_torch.legacy.lanczos is a prototype; use "
              "pmesh_tpu_torch.window instead", DeprecationWarning,
              stacklevel=2)

__all__ = ["linear", "cubic", "lanczos", "kaiser", "lanczos2",
           "lanczos3", "paint", "readout"]


def linear(dx):
    dx = torch.abs(dx)
    return torch.where(dx < 1.0, 1.0 - dx, 0.0)


linear.support = 1
linear.integral = 1.0


def cubic(dx, alpha=-0.5):
    """Catmull-Rom-family cubic (alpha=-0.5)."""
    dx = torch.abs(dx)
    v1 = (alpha + 2) * dx ** 3 - (alpha + 3) * dx ** 2 + 1
    v2 = alpha * (dx ** 3 - 5 * dx ** 2 + 8 * dx - 4)
    return torch.where(dx < 1.0, v1, torch.where(dx < 2.0, v2, 0.0))


cubic.support = 2
cubic.integral = 1.0


def _measure_integral(fn, a):
    dx = np.linspace(-a, a, 10001)
    return float(np.trapezoid(fn(torch.from_numpy(dx)).numpy(), dx))


def lanczos(a):
    ainv = 1.0 / a

    def kernel(dx):
        v = torch.sinc(dx) * torch.sinc(dx * ainv)
        return torch.where(torch.abs(dx) <= a, v, 0.0)

    kernel.support = int(np.ceil(a))
    kernel.integral = _measure_integral(kernel, a)
    return kernel


lanczos2 = lanczos(2)
lanczos3 = lanczos(3)


def kaiser(a, alpha):
    beta = np.pi * alpha

    def kernel(dx):
        t = torch.sqrt(torch.clamp(1.0 - (dx / a) ** 2, min=0.0))
        v = torch.special.i0(beta * t) / float(np.i0(beta))
        return torch.where(torch.abs(dx) <= a, v, 0.0)

    kernel.support = int(np.ceil(a))
    kernel.integral = _measure_integral(kernel, a)
    return kernel


def _prep(pos, mesh, period, transform, mode, support, device):
    pos, mesh = _inputs(pos, mesh, transform, device)
    ndim = pos.shape[-1]
    if period is not None:
        period = np.broadcast_to(np.asarray(period), (ndim,))
    elif mode == "raise":
        hi = torch.as_tensor(mesh.shape[:ndim], device=mesh.device) + support
        outside = ((pos < -support) | (pos >= hi)).any()
        if bool(outside):
            raise ValueError("particle painted outside the mesh")
    return pos, mesh, period


def _offsets(support, ndim):
    S = 2 * support
    grids = np.meshgrid(*([np.arange(S) - (support - 1)] * ndim),
                        indexing='ij')
    return np.stack([g.ravel() for g in grids], axis=-1)


def _stencil(pos, shape, period, window, support, dtype):
    """for each stencil offset: the flat target index of every particle
    and its weight, 0 where the target lies outside the mesh"""
    ndim = pos.shape[-1]
    base = torch.floor(pos).to(torch.int64)
    strides = np.cumprod((1,) + tuple(shape[::-1][:-1]))[::-1]
    for off in _offsets(support, ndim):
        tgt = base + torch.as_tensor(off, device=pos.device)
        k = torch.ones(pos.shape[:1], dtype=dtype, device=pos.device)
        for d in range(ndim):
            k = k * window(tgt[:, d] - pos[:, d]).to(dtype)
        inside = torch.ones(pos.shape[:1], dtype=torch.bool,
                            device=pos.device)
        idx = torch.zeros(pos.shape[:1], dtype=torch.int64,
                          device=pos.device)
        for d in range(ndim):
            t = tgt[:, d]
            if period is not None:
                t = torch.remainder(t, int(period[d]))
            else:
                inside = inside & (t >= 0) & (t < shape[d])
                t = torch.clamp(t, 0, shape[d] - 1)
            idx = idx + t * int(strides[d])
        yield idx, torch.where(inside, k, 0.0)


def paint(pos, mesh, weights=1.0, mode="raise", period=None,
          transform=None, window=linear, device=None):
    """Scatter ``weights`` onto ``mesh`` through a callable window: a
    new mesh, the input plus the paint (the input is not modified)."""
    support = int(getattr(window, 'support', 1))
    pos, mesh, period = _prep(pos, mesh, period, transform, mode, support,
                              device)
    w = torch.broadcast_to(torch.as_tensor(weights, dtype=mesh.dtype,
                                           device=mesh.device),
                           pos.shape[:1])
    flat = mesh.reshape(-1).clone()
    for idx, k in _stencil(pos, mesh.shape, period, window, support,
                           mesh.dtype):
        flat.index_add_(0, idx, k * w)
    return flat.reshape(mesh.shape)


def readout(mesh, pos, mode="raise", period=None, transform=None,
            window=linear, device=None):
    """Gather ``mesh`` at ``pos`` through a callable window."""
    support = int(getattr(window, 'support', 1))
    pos, mesh, period = _prep(pos, mesh, period, transform, mode, support,
                              device)
    flat = mesh.reshape(-1)
    acc = torch.zeros(pos.shape[:1], dtype=mesh.dtype, device=mesh.device)
    for idx, k in _stencil(pos, mesh.shape, period, window, support,
                           mesh.dtype):
        acc = acc + k * flat[idx]
    return acc
