"""Affine transforms and the resampling-window registry.

Counterpart of ``pmesh_tpu/window.py``: ``Affine``, ``ResampleWindow``
(with the generic ``paint``/``readout`` of ``ops/paint.py``) and
``FindResampler``.
"""
import numpy as np

from .ops.kernels import Window, windows, find_window
from .ops import paint as _paint_ops

__all__ = ["Affine", "ResampleWindow", "FindResampler"]


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

    def rescale(self, amount):
        """A new Affine with the scale multiplied by amount."""
        return Affine(self.ndim, self.scale * amount, self.translate,
                      self.period)

    def shift(self, amount):
        """A new Affine with translate shifted by amount (mesh units)."""
        return Affine(self.ndim, self.scale, self.translate + amount,
                      self.period)


class ResampleWindow(object):
    """A named resampling window: ``.kind``, ``.support``, ``.window``
    (the ops.kernels.Window), and the generic paint and readout."""

    def __init__(self, kind, support=-1):
        self._w = find_window(kind)
        if support > 0 and support != self._w.nativesupport:
            self._w = self._w.resize(support)
        self.kind = self._w.kind

    @property
    def support(self):
        return self._w.support

    @property
    def window(self):
        return self._w

    def resize(self, support):
        return ResampleWindow(self.kind, support)

    def get_fwindow(self, w):
        return self._w.get_fwindow(w)

    def get_compensation(self):
        return self._w.get_compensation()

    def paint(self, real, pos, hsml=None, mass=None, diffdir=None,
              transform=None):
        """``real`` plus the paint of ``pos``: a new tensor (``real`` is
        not changed)."""
        if transform is None:
            transform = Affine(pos.shape[-1])
        return _paint_ops.paint(real, pos, mass=1.0 if mass is None
                                else mass, window=self._w,
                                scale=transform.scale,
                                translate=transform.translate,
                                period=transform.period, diffdir=diffdir,
                                hsml=hsml)

    def readout(self, real, pos, hsml=None, diffdir=None, transform=None):
        """The values of ``real`` at ``pos``, a new tensor."""
        if transform is None:
            transform = Affine(pos.shape[-1])
        return _paint_ops.readout(real, pos, window=self._w,
                                  scale=transform.scale,
                                  translate=transform.translate,
                                  period=transform.period, diffdir=diffdir,
                                  hsml=hsml)


# reference names of the analytic windows
_CANONICAL = {'nnb': 'tunednnb', 'cic': 'tunedcic', 'tsc': 'tunedtsc',
              'pcs': 'tunedpcs'}


def FindResampler(window):
    """Resolve a name / ResampleWindow / Window to a ResampleWindow."""
    if isinstance(window, ResampleWindow):
        return window
    if isinstance(window, Window):
        r = ResampleWindow.__new__(ResampleWindow)
        r._w = window
        r.kind = window.kind
        return r
    if isinstance(window, str):
        kind = window.lower()
        window = _CANONICAL.get(kind, kind)
        if window not in windows:
            raise TypeError("not a ResampleWindow name: %r" % (window,))
        return ResampleWindow(window)
    raise TypeError("argument is not a ResampleWindow name or object: %r"
                    % (window,))
