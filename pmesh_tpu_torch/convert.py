"""Carry state from the JAX package to this port.

The JAX side's values come in as numpy arrays and plain attributes
(``np.asarray(x)``, ``pm.Nmesh``, ``cosmology.Om0`` ...), so this
module imports only numpy and torch.  With it both packages compute
from the same inputs.  ``device`` defaults to the current CUDA device
and raises without CUDA; CPU use is asked for with ``device='cpu'``.
"""
import numpy as np
import torch

from .pm import ParticleMesh, RealField, ComplexField, resolve_device
from .models.cosmology import Cosmology

__all__ = ["particlemesh_from", "cosmology_from",
           "lattice_state_from_numpy", "binned_state_from_numpy",
           "binned_state_to_numpy", "catalog_state_from_numpy",
           "catalog_state_to_numpy", "field_from_numpy", "to_slabs",
           "gather"]


def particlemesh_from(Nmesh, BoxSize, dtype, resampler, device=None,
                      procmesh=None):
    """A ParticleMesh of the same geometry; ``resampler`` is a window
    name or any object with a ``.kind``."""
    kind = getattr(resampler, 'kind', resampler)
    return ParticleMesh(Nmesh=[int(n) for n in np.atleast_1d(Nmesh)],
                        BoxSize=np.asarray(BoxSize, dtype='f8'),
                        dtype=np.dtype(dtype), resampler=kind,
                        device=device, procmesh=procmesh)


def cosmology_from(Om0, Ol0, h, sigma8, ns, Ob0):
    return Cosmology(Om0=float(Om0), Ol0=float(Ol0), h=float(h),
                     sigma8=float(sigma8), ns=float(ns), Ob0=float(Ob0))


def lattice_state_from_numpy(disp, vel, device=None):
    """(disp, vel) tuples of mesh-shaped tensors on ``device``, keeping
    the arrays' dtype."""
    device = resolve_device(device)

    def conv(arrays):
        return tuple(torch.from_numpy(np.array(a)).to(device)
                     for a in arrays)
    return conv(disp), conv(vel)


def _nested(fn, x):
    if isinstance(x, (tuple, list)):
        return tuple(_nested(fn, y) for y in x)
    return fn(x)


def binned_state_from_numpy(state, device=None):
    """A binned state, e.g. ``(dslots, vslots, valid)``: nested tuples
    (slots, then axes) of numpy arrays become the same nesting of
    tensors on ``device``, keeping the arrays' dtype and values."""
    device = resolve_device(device)
    return _nested(lambda a: torch.from_numpy(np.array(a)).to(device),
                   state)


def binned_state_to_numpy(state):
    """The inverse of :func:`binned_state_from_numpy`."""
    return _nested(lambda t: t.detach().cpu().numpy(), state)


def catalog_state_from_numpy(Q, S, V, device=None):
    """A catalog ``models.fastpm.State`` of the (N, ndim) arrays Q, S
    and V (e.g. the JAX package's ``State.Q``, ``.S`` and ``.V``) on
    ``device``, keeping their dtype."""
    from .models.fastpm import State
    device = resolve_device(device)
    return State(*(torch.from_numpy(np.array(a)).to(device)
                   for a in (Q, S, V)))


def catalog_state_to_numpy(state):
    """(Q, S, V) of a catalog State as numpy arrays."""
    return tuple(t.detach().cpu().numpy()
                 for t in (state.Q, state.S, state.V))


def field_from_numpy(pm, array, type=None):
    """A field of ``pm`` holding ``array``: of ``type`` ('real',
    'complex' ... or a Field class), by default a ComplexField for a
    complex array (the half spectrum, or on a c2c mesh the full one)
    and a RealField for a real one.  A real field of a c2c mesh is
    complex: pass type='real' for it."""
    from .pm import _field_type
    array = np.array(array)
    if type is None:
        type = ComplexField if np.iscomplexobj(array) else RealField
    ftype = _field_type(type)
    shape, _ = pm._shape_dtype(ftype)
    if array.shape != shape:
        raise ValueError("array of shape %s is not a %s of this mesh %s"
                         % (array.shape, ftype.__name__, shape))
    return pm.create(type=ftype,
                     value=torch.from_numpy(array).to(pm.device))


def _block(procmesh, n, axis):
    if procmesh is None or procmesh.size == 1:
        return 0, n
    return procmesh.slab(n)


def to_slabs(array, procmesh, axis=0):
    """This rank's block of a global numpy array or tensor: its slab along
    ``axis`` (0: x rows of a real mesh; 1: the y-chunk of a transposed
    spectrum), as a tensor on the procmesh's device.  Nested tuples of
    arrays give the same nesting of blocks."""
    if isinstance(array, (tuple, list)):
        return tuple(to_slabs(a, procmesh, axis) for a in array)
    dev = procmesh.device if procmesh is not None else resolve_device(None)
    if not isinstance(array, torch.Tensor):
        array = torch.from_numpy(np.asarray(array))
    start, stop = _block(procmesh, array.shape[axis], axis)
    return array.narrow(axis, start, stop - start).contiguous().to(dev)


def gather(slabs, procmesh, axis=0, dst=None):
    """The global array of the ranks' blocks ``slabs`` (concatenated
    along ``axis``, rank-major) as numpy: on every rank, or with ``dst``
    on rank ``dst`` alone (None on the others).  Nested tuples of
    tensors give the same nesting of arrays."""
    if isinstance(slabs, (tuple, list)):
        return tuple(gather(t, procmesh, axis, dst) for t in slabs)
    from .parallel.comm import all_gather, gather as gather_to
    if procmesh is None or procmesh.size == 1:
        return slabs.detach().cpu().numpy()
    if dst is None:
        return all_gather(slabs.detach(), procmesh, axis).cpu().numpy()
    full = gather_to(slabs.detach(), procmesh, dst, axis)
    return None if full is None else full.cpu().numpy()
