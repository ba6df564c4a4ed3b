"""Checkpoint / resume of simulation state.

Counterpart of ``pmesh_tpu/utils/checkpoint.py``.  ``save_state`` and
``restore_state`` write and read a catalog ``models.fastpm.State`` (and
extra tensors) with ``torch.save``/``torch.load`` in place of the JAX
package's orbax trees: one file, read back with ``weights_only=True``
(tensors and plain containers only), onto the device asked for.
``save_npz``/``load_npz`` are the single-host npz snapshot.
"""
import numpy as np
import torch

from ..pm import resolve_device

__all__ = ["save_state", "restore_state", "save_npz", "load_npz"]


def _host(t):
    return t.detach().cpu()


def save_state(path, state, extra=None):
    """Write the state's Q, S and V and the ``extra`` values (each made
    a tensor) to the file ``path``."""
    tree = {"Q": _host(state.Q), "S": _host(state.S), "V": _host(state.V)}
    for k, v in (extra or {}).items():
        tree[k] = _host(torch.as_tensor(np.asarray(v)))
    torch.save(tree, path)


def restore_state(path, template=None, device=None):
    """(State, extra) from a file written by :func:`save_state`, the
    tensors on ``device`` (default the current CUDA device)."""
    from ..models.fastpm import State
    device = resolve_device(device)
    tree = torch.load(path, map_location=device, weights_only=True)
    extra = {k: v for k, v in tree.items() if k not in ('Q', 'S', 'V')}
    return State(tree['Q'], tree['S'], tree['V']), extra


def save_npz(path, state, a=None, **extra):
    """Single-host npz snapshot (the bigfile-snapshot analog)."""
    np.savez(path,
             Position=_host(state.Q + state.S).numpy(),
             Velocity=_host(state.V).numpy(),
             Q=_host(state.Q).numpy(),
             a=a if a is not None else np.nan,
             **extra)


def load_npz(path, device=None):
    """(State, a) from :func:`save_npz`'s file, on ``device`` (default
    the current CUDA device); S is Position - Q, as in the JAX
    package."""
    from ..models.fastpm import State
    device = resolve_device(device)
    with np.load(path) as d:
        Q = torch.from_numpy(d['Q']).to(device)
        S = torch.from_numpy(d['Position']).to(device) - Q
        V = torch.from_numpy(d['Velocity']).to(device)
        return State(Q, S, V), float(d['a'])
