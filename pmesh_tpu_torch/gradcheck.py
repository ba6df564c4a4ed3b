"""Numerical gradient validation harness.

Counterpart of ``pmesh_tpu/gradcheck.py``: check a scalar objective's
``torch.autograd`` gradient (which runs through the port's autograd
Functions) against central differences, with the reference suite's
rtol=1e-5 contract.  The objective takes a float64 tensor on the
device of ``x`` (a tensor's own device, else ``device``, by default the
current CUDA device) and returns a scalar.
"""
import numpy as np
import torch

from .pm import resolve_device

__all__ = ["check_grad", "central_difference"]


def _as_tensor(x, device):
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x), device=resolve_device(device))
    return x.detach().to(torch.complex128 if x.is_complex()
                         else torch.float64)


def central_difference(objective, x, eps=1e-4, indices=None, device=None):
    """Central differences of a scalar objective at ``x`` at the flat
    ``indices`` (all by default; use a subset for large x).  A complex
    ``x`` is stepped in its real and its imaginary part, and the
    difference is d/dRe + i d/dIm.  Returns (indices, differences) as
    numpy arrays."""
    x = _as_tensor(x, device)
    flat = x.reshape(-1)
    indices = list(range(flat.numel()) if indices is None else indices)
    parts = (1.0, 1j) if x.is_complex() else (1.0,)
    g = np.zeros(len(indices), dtype=complex if x.is_complex() else float)
    for j, i in enumerate(indices):
        for part in parts:
            xp = flat.clone()
            xp[i] += eps * part
            xm = flat.clone()
            xm[i] -= eps * part
            g[j] += part * (float(objective(xp.reshape(x.shape)))
                            - float(objective(xm.reshape(x.shape)))) \
                / (2 * eps)
    return np.asarray(indices), g


def check_grad(objective, x, eps=1e-4, rtol=1e-5, atol=1e-8,
               indices=None, verbose=False, device=None):
    """Assert that torch.autograd's gradient of ``objective`` at ``x``
    matches central differences: raises AssertionError with the
    mismatch on failure; returns (analytic, numerical) at the probed
    indices."""
    x = _as_tensor(x, device).requires_grad_(True)
    ag, = torch.autograd.grad(objective(x), x)
    ag = ag.detach().cpu().numpy().reshape(-1)
    idx, ng = central_difference(objective, x.detach(), eps=eps,
                                 indices=indices)
    ag = ag[idx]
    if verbose:
        for i, (a, n) in enumerate(zip(ag, ng)):
            print("%6d  analytic=% .8e  numeric=% .8e" % (idx[i], a, n))
    np.testing.assert_allclose(ng, ag, rtol=rtol, atol=atol,
                               err_msg="gradient check failed")
    return ag, ng
