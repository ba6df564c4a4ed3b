"""Affine transforms and the resampling-window registry.

Counterpart of ``pmesh_tpu/window.py``: ``Affine``, ``ResampleWindow``
and ``FindResampler``.  The generic scatter
``paint``/``readout`` of arbitrary particle positions is not ported
yet; the lattice path (``ops/gridpm.py``) is the port's paint and
readout.
"""
import numpy as np

from .ops.kernels import Window, windows, find_window

__all__ = ["Affine", "ResampleWindow", "FindResampler"]

_GENERIC = ("the generic scatter paint/readout is not ported yet "
            "(ROADMAP queue 1, item 3); use ops.gridpm for lattice "
            "particles")


class Affine(object):
    """An affine transformation from positions to (fractional) mesh
    units: ``scale`` multiplies positions, ``translate`` and ``period``
    are in integer mesh units."""

    def __init__(self, ndim, scale=None, translate=None, period=None):
        self.ndim = ndim
        self.scale = np.empty(ndim, dtype='f8')
        self.scale[:] = 1.0 if scale is None else scale
        self.translate = np.empty(ndim, dtype='f8')
        self.translate[:] = 0 if translate is None else translate
        self.period = np.empty(ndim, dtype='intp')
        self.period[:] = 0 if period is None else period


class ResampleWindow(object):
    """A named resampling window: ``.kind``, ``.support`` and
    ``.window`` (the ops.kernels.Window)."""

    def __init__(self, kind):
        self._w = find_window(kind)
        self.kind = self._w.kind

    @property
    def support(self):
        return self._w.support

    @property
    def window(self):
        return self._w

    def get_fwindow(self, w):
        return self._w.get_fwindow(w)

    def paint(self, *args, **kwargs):
        raise NotImplementedError(_GENERIC)

    def readout(self, *args, **kwargs):
        raise NotImplementedError(_GENERIC)


# reference names of the analytic windows
_CANONICAL = {'nnb': 'tunednnb', 'cic': 'tunedcic', 'tsc': 'tunedtsc',
              'pcs': 'tunedpcs'}


def FindResampler(window):
    """Resolve a name / ResampleWindow / Window to a ResampleWindow."""
    if isinstance(window, ResampleWindow):
        return window
    if isinstance(window, str):
        kind = window.lower()
        window = _CANONICAL.get(kind, kind)
        if window not in windows:
            raise TypeError("not a ResampleWindow name: %r" % (window,))
    if not isinstance(window, (str, Window)):
        raise TypeError(
            "argument is not a ResampleWindow name or object: %r"
            % (window,))
    return ResampleWindow(window)
