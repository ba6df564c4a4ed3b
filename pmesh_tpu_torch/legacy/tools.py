"""Deprecated MPI-era tools: ``Rotator``, ``FromRoot`` and the timers.

Counterpart of ``pmesh_tpu/legacy/tools.py``.  The port runs one
process per device, so the rank-serialization helpers are identities;
``Timer`` and ``Timers`` are those of ``utils/timers.py``.
"""
import warnings
from functools import wraps

from ..utils.timers import Timer, Timers  # noqa: F401

warnings.warn("legacy.tools is deprecated", DeprecationWarning)

__all__ = ["Rotator", "FromRoot", "Timer", "Timers"]


class Rotator(object):
    """Serialize execution over ranks; a no-op in one process."""

    def __init__(self, comm=None):
        self.comm = comm

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def FromRoot(comm=None):
    """Run on 'root' and broadcast; in one process the function simply
    runs."""
    def decorator(func):
        @wraps(func)
        def wrapped(*args, **kwargs):
            return func(*args, **kwargs)
        return wrapped
    return decorator
