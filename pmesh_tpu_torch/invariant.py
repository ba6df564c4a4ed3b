"""Scale-invariant inside-out mode indexing.

Counterpart of ``pmesh_tpu/invariant.py``: maps integer mode vectors to
an inside-out (Linf-shell ordered) scale-invariant linear index, with
the hermitian-compressed last axis and the Nyquist folded positive.
The port's C++ host runtime (``native/``) computes it, OpenMP-parallel
over the points: host work by design, on numpy arrays.
"""
import numpy as np

from .native import runtime

__all__ = ["get_index"]


def get_index(x, Nmesh, compressed=True, maxlength=None):
    """The scale-invariant index of integer mode vectors.

    Parameters
    ----------
    x : array_like (..., d)
        integer mode coordinates in [-Nmesh//2, Nmesh//2).
    Nmesh : array_like, broadcast to (d,)
    compressed : bool
        if True the last axis stores only the non-negative half; modes
        with a negative last component index to -1.
    maxlength : int or None
        indices >= maxlength return -1.

    Returns
    -------
    ind : numpy int64 array (...): modes closer to zero in Linf distance
        have smaller indices; -1 if out of range.
    """
    x = np.asarray(x)
    if x.ndim < 2:
        raise ValueError("x must be (..., d)")
    return runtime.invariant_index(x, Nmesh, compressed=compressed,
                                   maxlength=maxlength)
