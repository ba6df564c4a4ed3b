"""Deprecated standalone TSC paint and readout.

Counterpart of ``pmesh_tpu/legacy/tsc.py``: as ``legacy/cic.py``, with
the quadratic window.
"""
import warnings

from ..ops import paint as _paint_ops
from .cic import _inputs, _mode_args

warnings.warn("legacy.tsc is deprecated; use pmesh_tpu_torch.window.TSC",
              DeprecationWarning)

__all__ = ["paint", "readout"]


def paint(pos, mesh, weights=1.0, mode="raise", period=None,
          transform=None, device=None):
    pos, mesh = _inputs(pos, mesh, transform, device)
    return _paint_ops.paint(mesh, pos, mass=weights, window='quadratic',
                            period=_mode_args(mode, period, mesh.shape))


def readout(mesh, pos, mode="raise", period=None, transform=None,
            out=None, device=None):
    pos, mesh = _inputs(pos, mesh, transform, device)
    return _paint_ops.readout(mesh, pos, window='quadratic',
                              period=_mode_args(mode, period, mesh.shape))
