"""ctypes wrappers of the binned rebase CUDA kernels (``csrc/binned.cu``),
the port of ``rebase_fused_t`` in ``pmesh_tpu/ops/binned_pallas.py``.

``rebase_assign`` computes the new slots, displacements, validity,
routes and overflow; ``rebase_apply`` replays the routes on the extra
payloads.  Each wrapper checks its tensors (CUDA, f32 meshes, 3-d,
contiguous, one shape and device, no autograd), allocates the outputs,
launches on PyTorch's current stream and raises RuntimeError if the
launch returns an error.  ``LAUNCHES`` counts the launches of each
kernel (the x-halo slab forms under "<name>_xhalo").

Both take the x-halo slab form of a slab-sharded state (``xbase``):
inputs of ``lo + rows + hi`` x planes, outputs of ``rows``, the source
of target row x at input plane x + xbase - o_x, no wrap on x.

The plain PyTorch versions are ``ops/binned.rebase_assign_plain`` and
``rebase_apply_plain`` (with ``xbase`` and ``rows`` for the slab form);
both sides are bitwise equal.
"""
import ctypes

import torch

from .binned import ROUTE_DTYPE, _route_check
from .gridpm_cuda import _check
from ..native import cuda as _cuda

__all__ = ["rebase_assign", "rebase_apply", "LAUNCHES", "reset_launches",
           "MAX_SLOTS", "MAX_EXTRAS"]

# the x-halo slab forms count apart ("_xhalo")
LAUNCHES = {"rebase_assign": 0, "rebase_apply": 0, "rebase_assign_xhalo": 0,
            "rebase_apply_xhalo": 0}

# the slot pointers travel by value in the kernel's parameter struct;
# 16 slots of a 512^3 state with velocities are 56 GB, most of the card
MAX_SLOTS = 16
MAX_EXTRAS = 4

_P, _I = ctypes.c_void_p, ctypes.c_int
_lib = None


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _load():
    global _lib
    if _lib is None:
        lib = _cuda.load("binned")
        lib.pmesh_cuda_error_string.argtypes = [_I]
        lib.pmesh_cuda_error_string.restype = ctypes.c_char_p
        lib.pmesh_rebase_assign.argtypes = (
            [_P, _P, _I, _P, _P, _P, _I, _P] + [_I] * 8 + [_P])
        lib.pmesh_rebase_assign.restype = _I
        lib.pmesh_rebase_apply.argtypes = (
            [_P, _I, _I, _P, _I, _P] + [_I] * 8 + [_P])
        lib.pmesh_rebase_apply.restype = _I
        _lib = lib
    return _lib


def _raise_on(rc, what):
    if rc != 0:
        msg = _load().pmesh_cuda_error_string(rc).decode()
        raise RuntimeError("%s: CUDA launch failed (%d: %s)"
                           % (what, rc, msg))


def _ptrs(tensors):
    """A ctypes array of the tensors' device pointers."""
    return (_P * len(tensors))(*[t.data_ptr() for t in tensors])


def _check_slots(n, limit, what, name):
    if not 1 <= n <= limit:
        raise NotImplementedError("%s: the CUDA kernel takes 1 to %d %s "
                                  "(got %d)" % (what, limit, name, n))


def _halo(what, n_in, rows, xbase, olo, ohi):
    """(output planes, xbase) of the wrapped (xbase None) or x-halo form"""
    if xbase is None:
        return n_in, -1
    if rows < 1 or xbase - ohi < 0 or rows - 1 + xbase - olo >= n_in:
        raise ValueError("%s: %d input planes do not hold the x halo of %d "
                         "rows at base %d for offsets [%d, %d]"
                         % (what, n_in, rows, xbase, olo, ohi))
    return rows, xbase


def rebase_assign(dslots, valid, nslots_out, olo, ohi, rows=None,
                  xbase=None):
    """Rebase assign over the integer offsets [olo, ohi] on every axis.

    dslots : K tuples of three (N0, N1, N2) f32 CUDA tensors
    valid : K (N0, N1, N2) f32 CUDA tensors
    rows, xbase : the x-halo slab form (module docstring): the outputs
        have ``rows`` planes, target row x reads input plane
        x + xbase - o_x
    Returns (new_dslots, new_valid, routes, overflow): nslots_out slots,
    routes int16 meshes, overflow a 0-d int64 CUDA tensor."""
    what = "rebase_assign"
    K, Kout = len(dslots), int(nslots_out)
    _check_slots(K, MAX_SLOTS, what, "slots")
    _check_slots(Kout, MAX_SLOTS, what, "output slots")
    if any(len(dk) != 3 for dk in dslots):
        raise NotImplementedError("%s: the CUDA kernel is 3-d only" % what)
    if len(valid) != K:
        raise ValueError("%s: %d displacement slots but %d validity slots"
                         % (what, K, len(valid)))
    if ohi < olo:
        raise ValueError("%s: empty offset range [%d, %d]" % (what, olo, ohi))
    _route_check(K, (ohi - olo + 1) ** 3)
    dflat = tuple(x for dk in dslots for x in dk)
    shape_in, device = _check(dflat + tuple(valid), what)
    n0, xb = _halo(what, shape_in[0], rows, xbase, olo, ohi)
    shape = (n0,) + shape_in[1:]
    nd = tuple(torch.empty(shape, dtype=torch.float32, device=device)
               for _ in range(3 * Kout))
    nv = tuple(torch.empty(shape, dtype=torch.float32, device=device)
               for _ in range(Kout))
    rt = tuple(torch.empty(shape, dtype=ROUTE_DTYPE, device=device)
               for _ in range(Kout))
    overflow = torch.zeros((), dtype=torch.int64, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    LAUNCHES[what + ("_xhalo" if xb >= 0 else "")] += 1
    rc = _load().pmesh_rebase_assign(
        _ptrs(dflat), _ptrs(valid), K, _ptrs(nd), _ptrs(nv), _ptrs(rt), Kout,
        overflow.data_ptr(), shape[0], shape[1], shape[2], shape_in[0], xb,
        olo, ohi, device.index, stream)
    _raise_on(rc, what)
    new_d = tuple(nd[3 * j:3 * j + 3] for j in range(Kout))
    return new_d, nv, rt, overflow


def rebase_apply(extras, routes, olo, ohi, xbase=None):
    """Rebase apply: replays ``routes`` (from :func:`rebase_assign` with
    the same offsets) on the extra payloads.

    extras : tuple of K-slot structures (K tuples of three f32 CUDA
        tensors), e.g. ``(vslots,)``
    xbase : the x-halo slab form: the extras hold lo + rows + hi planes
        about the routes' rows
    Returns the same nesting with len(routes) slots."""
    what = "rebase_apply"
    nextra, Kout = len(extras), len(routes)
    _check_slots(nextra, MAX_EXTRAS, what, "extra fields")
    K = len(extras[0])
    _check_slots(K, MAX_SLOTS, what, "slots")
    _check_slots(Kout, MAX_SLOTS, what, "output slots")
    if any(len(e) != K or any(len(ek) != 3 for ek in e) for e in extras):
        raise ValueError("%s: every extra field needs K slots of 3 axes"
                         % what)
    eflat = tuple(x for e in extras for ek in e for x in ek)
    shape_in, device = _check(eflat, what)
    shape = tuple(routes[0].shape) if xbase is not None else shape_in
    _, xb = _halo(what, shape_in[0], shape[0], xbase, olo, ohi)
    if shape[1:] != shape_in[1:]:
        raise ValueError("%s: the routes' planes must match the extras'"
                         % what)
    for r in routes:
        if (r.dtype != ROUTE_DTYPE or tuple(r.shape) != shape
                or r.device != device or not r.is_contiguous()):
            raise ValueError("%s: routes must be contiguous int16 meshes of "
                             "the extras' shape and device" % what)
    ne = tuple(torch.empty(shape, dtype=torch.float32, device=device)
               for _ in range(3 * nextra * Kout))
    stream = torch.cuda.current_stream(device).cuda_stream
    LAUNCHES[what + ("_xhalo" if xb >= 0 else "")] += 1
    rc = _load().pmesh_rebase_apply(
        _ptrs(eflat), nextra, K, _ptrs(routes), Kout, _ptrs(ne), shape[0],
        shape[1], shape[2], shape_in[0], xb, olo, ohi, device.index, stream)
    _raise_on(rc, what)
    return tuple(tuple(ne[(e * Kout + j) * 3:(e * Kout + j) * 3 + 3]
                       for j in range(Kout)) for e in range(nextra))
