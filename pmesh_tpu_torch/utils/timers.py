"""Phase timers and profiling helpers.

Counterpart of ``pmesh_tpu/utils/timers.py``: wall-clock phase timers
that wait for the CUDA device's queue at both ends of a phase (PyTorch
returns before the card finishes), and a ``torch.profiler`` trace of a
block.
"""
import time
from contextlib import contextmanager

import torch

__all__ = ["Timer", "Timers", "trace"]


def _sync():
    # nothing to wait for on the CPU, or before CUDA was first used
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class Timer(object):
    """Accumulating context-manager timer for one labeled phase."""

    def __init__(self, name):
        self.name = name
        self.total = 0.0
        self.count = 0

    def __enter__(self):
        _sync()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        _sync()
        self.total += time.perf_counter() - self._t0
        self.count += 1
        return False

    def __repr__(self):
        return "<Timer %s: %.4fs / %d calls>" % (self.name, self.total,
                                                 self.count)


class Timers(object):
    """A named collection of Timers (reference tools.Timers)."""

    def __init__(self):
        self._timers = {}

    def __getitem__(self, name):
        if name not in self._timers:
            self._timers[name] = Timer(name)
        return self._timers[name]

    def __repr__(self):
        return "\n".join(repr(t) for t in self._timers.values())

    def report(self):
        return {name: (t.total, t.count)
                for name, t in self._timers.items()}


@contextmanager
def trace(logdir):
    """A ``torch.profiler`` trace of the enclosed block (CPU, and CUDA
    where the card is in use), written to ``logdir`` for TensorBoard or
    chrome://tracing."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    handler = torch.profiler.tensorboard_trace_handler(logdir)
    with torch.profiler.profile(activities=activities,
                                on_trace_ready=handler):
        yield
