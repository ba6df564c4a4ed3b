"""Deprecated standalone CIC paint and readout.

Counterpart of ``pmesh_tpu/legacy/cic.py``: the ``mode`` ('ignore',
'raise' or 'wrap') and ``period`` arguments over the generic paint of
``ops/paint.py``.  ``mesh`` is a tensor, whose device runs the paint;
a numpy mesh goes to ``device`` (default the current CUDA device; pass
``device='cpu'`` on the CPU).
"""
import warnings

import numpy as np
import torch

from ..ops import paint as _paint_ops
from ..pm import resolve_device

warnings.warn("legacy.cic is deprecated; use pmesh_tpu_torch.window.CIC",
              DeprecationWarning)

__all__ = ["paint", "readout"]


def _mode_args(mode, period, shape):
    if mode == 'wrap':
        return np.broadcast_to(period if period is not None
                               else shape, len(shape))
    if mode in ('ignore', 'raise'):
        return 0
    raise ValueError("mode must be wrap, ignore or raise")


def _inputs(pos, mesh, transform, device):
    """the mesh as a tensor and the positions on its device"""
    if not isinstance(mesh, torch.Tensor):
        mesh = torch.as_tensor(np.asarray(mesh), device=resolve_device(device))
    pos = torch.as_tensor(pos, device=mesh.device)
    if transform is not None:
        pos = torch.as_tensor(transform(pos), device=mesh.device)
    return pos, mesh


def paint(pos, mesh, weights=1.0, mode="raise", period=None,
          transform=None, device=None):
    """CIC paint: a new mesh, the input plus the paint (the input is not
    modified)."""
    pos, mesh = _inputs(pos, mesh, transform, device)
    return _paint_ops.paint(mesh, pos, mass=weights, window='linear',
                            period=_mode_args(mode, period, mesh.shape))


def readout(mesh, pos, mode="raise", period=None, transform=None,
            out=None, device=None):
    pos, mesh = _inputs(pos, mesh, transform, device)
    return _paint_ops.readout(mesh, pos, window='linear',
                              period=_mode_args(mode, period, mesh.shape))
