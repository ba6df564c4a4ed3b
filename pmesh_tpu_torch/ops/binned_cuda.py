"""ctypes wrappers of the binned rebase CUDA kernels (``csrc/binned.cu``),
the port of ``rebase_fused_t`` in ``pmesh_tpu/ops/binned_pallas.py``.

``rebase_assign`` computes the new slots, displacements, validity,
routes and overflow; ``rebase_apply`` replays the routes on the extra
payloads.  Each wrapper checks its tensors (CUDA, f32 or f64 meshes of
one dtype, 3-d, contiguous, one shape and device, no autograd; bf16 is
refused), allocates the outputs in that dtype, launches on PyTorch's
current stream and raises RuntimeError if the launch returns an error.
``LAUNCHES`` counts the launches of each kernel (the x-halo slab forms
under "<name>_xhalo", the f64 forms with "_f64" appended).

Both take the x-halo slab form of a slab-sharded state (``xbase``):
inputs of ``lo + rows + hi`` x planes, outputs of ``rows``, the source
of target row x at input plane x + xbase - o_x, no wrap on x.

The assign stages the source planes of a y-z tile in shared memory, each
source slot-cell classified once (``csrc/binned.cu`` says how); ``plan``
is its launch planner: the tile, the target planes per block, the ring
depth, the slot group, whether the displacements are staged and the
shared bytes, for each slot count, offset range and form.  It alone
counts the bytes; the entry point takes them as given.

The plain PyTorch versions are ``ops/binned.rebase_assign_plain`` and
``rebase_apply_plain`` (with ``xbase`` and ``rows`` for the slab form);
both sides are bitwise equal.
"""
import ctypes

import torch

from .binned import ROUTE_DTYPE, _route_check
from .gridpm_cuda import SMEM_LIMIT, _ceil, _check, planes_per_block
from ..native import cuda as _cuda

__all__ = ["rebase_assign", "rebase_apply", "plan", "LAUNCHES",
           "reset_launches", "MAX_SLOTS", "MAX_EXTRAS"]

# the x-halo slab forms ("_xhalo") and the f64 forms ("_f64") count apart
FORMS = {torch.float32: "", torch.float64: "_f64"}
LAUNCHES = {name + halo + form: 0
            for name in ("rebase_assign", "rebase_apply")
            for halo in ("", "_xhalo") for form in FORMS.values()}

# the slot pointers travel by value in the kernel's parameter struct;
# 16 slots of a 512^3 state with velocities are 56 GB, most of the card
MAX_SLOTS = 16
MAX_EXTRAS = 4
# csrc/binned.cu's assign tile: THREADS threads, one target column each,
# in rows of TILE_Z z cells; the offsets per axis it compiles in (the
# others read nr at run time, up to NR_MAX: K nr^3 route codes fit in
# int16 only for nr <= 31)
THREADS, TILE_Z = 256, 32
TILE_Y = THREADS // TILE_Z
NR_COMPILED = (2, 3, 4)
NR_MAX = 31
ROUTE_MAX = 32767

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
            [_P, _P, _I, _P, _P, _P, _I, _P] + [_I] * 13 + [_P])
        lib.pmesh_rebase_assign.restype = _I
        lib.pmesh_rebase_apply.argtypes = (
            [_P, _I, _I, _P, _I, _P] + [_I] * 9 + [_P])
        lib.pmesh_rebase_apply.restype = _I
        _lib = lib
    return _lib


def _raise_on(rc, what):
    if rc != 0:
        msg = _load().pmesh_cuda_error_string(rc).decode()
        raise RuntimeError("%s: CUDA launch failed (%d: %s)"
                           % (what, rc, msg))


def plan(shape, K, Kout, olo, ohi, xhalo=False, dtype=torch.float32):
    """The launch plan of the assign, as ``csrc/binned.cu`` takes it.

    shape : the (N0, N1, N2) target planes (the x-halo form's ``rows``
    output planes); K, Kout : input and output slots (1 .. MAX_SLOTS);
    [olo, ohi] : the offsets per axis (nr of them, K nr^3 <= ROUTE_MAX);
    xhalo : the x-halo slab form, whose planes come from its extended
    inputs without wrap; it plans as the wrapped form; dtype : the
    storage, f32 or f64, whose values the ring holds (4 or 8 bytes).

    A block owns a TILE_Y x TILE_Z tile of y-z through ``xc`` target planes
    and keeps a ring of ``depth`` = nr + 1 source planes of the tile plus
    its nr - 1 halo: the codes of ``group`` slots (bytes, or 16 bits where
    nr^3 >= 255: ``code_bytes``) and, with ``stage_d``, their three
    displacements, beside one plane of the slots' validity and
    displacements as their copies land and each thread's Kout int16 route
    codes.  ``group`` is K wherever the ring of every slot fits in
    SMEM_LIMIT (it then slides a plane at a time), else the most slots that
    fit (each group's planes are staged anew per target plane).  ``smem``:
    the dynamic shared bytes; ``width``: the compiled nr, or None where the
    kernel reads nr at run time; ``grid``: the launch's (z tiles, y tiles, x
    chunks)."""
    K, Kout, olo, ohi = int(K), int(Kout), int(olo), int(ohi)
    nr = ohi - olo + 1
    if not (1 <= K <= MAX_SLOTS and 1 <= Kout <= MAX_SLOTS):
        raise ValueError("plan: the kernel takes 1 to %d slots (got %d -> "
                         "%d)" % (MAX_SLOTS, K, Kout))
    if nr < 1 or K * nr ** 3 > ROUTE_MAX:
        raise ValueError("plan: %d slots x %d^3 offsets do not fit the "
                         "int16 route codes" % (K, max(nr, 0)))
    n0, n1, n2 = (int(n) for n in shape)
    esize = 8 if dtype == torch.float64 else 4
    code_bytes = 1 if nr ** 3 < 255 else 2
    area = (TILE_Y + nr - 1) * (TILE_Z + nr - 1)
    depth = nr + 1
    hits = 2 * Kout * THREADS
    group = K
    while hits + group * (depth * code_bytes + 4 * esize) * area \
            > SMEM_LIMIT:
        group -= 1
    codes = group * depth * area * code_bytes
    disp = group * depth * 3 * area * esize
    raw = group * 4 * area * esize
    # on an H100 (PERF.md) reading a hit's displacement back from device
    # memory cost 15-20 % at the main paths' shapes, whatever the
    # occupancy: staged wherever it fits
    stage_d = group == K and disp + raw + hits + codes <= SMEM_LIMIT
    smem = (disp if stage_d else 0) + raw + hits + codes
    xc = planes_per_block(n0, _ceil(n1, TILE_Y) * _ceil(n2, TILE_Z))
    return dict(width=nr if nr in NR_COMPILED else None,
                tile=(TILE_Y, TILE_Z), xc=xc, depth=depth, group=group,
                code_bytes=code_bytes, stage_d=stage_d, smem=smem,
                grid=(_ceil(n2, TILE_Z), _ceil(n1, TILE_Y), _ceil(n0, xc)),
                xhalo=bool(xhalo))


def _ptrs(tensors):
    """A ctypes array of the tensors' device pointers."""
    return (_P * len(tensors))(*[t.data_ptr() for t in tensors])


def _check_rebase(tensors, what):
    """shape and device as gridpm_cuda._check; the rebase kernels read
    and write f32 or f64 (bf16 is refused)"""
    shape, device = _check(tensors, what)
    if tensors[0].dtype not in FORMS:
        raise NotImplementedError("%s: the CUDA kernel takes f32 or f64 "
                                  "meshes (got %s)"
                                  % (what, tensors[0].dtype))
    return shape, device


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

    dslots : K tuples of three (N0, N1, N2) f32 or f64 CUDA tensors
    valid : K (N0, N1, N2) CUDA tensors of the same dtype
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
    shape_in, device = _check_rebase(dflat + tuple(valid), what)
    dtype = dflat[0].dtype
    n0, xb = _halo(what, shape_in[0], rows, xbase, olo, ohi)
    shape = (n0,) + shape_in[1:]
    nd = tuple(torch.empty(shape, dtype=dtype, device=device)
               for _ in range(3 * Kout))
    nv = tuple(torch.empty(shape, dtype=dtype, device=device)
               for _ in range(Kout))
    rt = tuple(torch.empty(shape, dtype=ROUTE_DTYPE, device=device)
               for _ in range(Kout))
    overflow = torch.zeros((), dtype=torch.int64, device=device)
    p = plan(shape, K, Kout, olo, ohi, xhalo=xb >= 0, dtype=dtype)
    stream = torch.cuda.current_stream(device).cuda_stream
    LAUNCHES[what + ("_xhalo" if xb >= 0 else "") + FORMS[dtype]] += 1
    rc = _load().pmesh_rebase_assign(
        _ptrs(dflat), _ptrs(valid), K, _ptrs(nd), _ptrs(nv), _ptrs(rt), Kout,
        overflow.data_ptr(), shape[0], shape[1], shape[2], shape_in[0], xb,
        olo, ohi, p['xc'], p['group'], int(p['stage_d']), p['smem'],
        int(dtype == torch.float64), device.index, stream)
    _raise_on(rc, what)
    new_d = tuple(nd[3 * j:3 * j + 3] for j in range(Kout))
    return new_d, nv, rt, overflow


def rebase_apply(extras, routes, olo, ohi, xbase=None):
    """Rebase apply: replays ``routes`` (from :func:`rebase_assign` with
    the same offsets) on the extra payloads.

    extras : tuple of K-slot structures (K tuples of three f32 or f64
        CUDA tensors), e.g. ``(vslots,)``
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
    shape_in, device = _check_rebase(eflat, what)
    dtype = eflat[0].dtype
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
    ne = tuple(torch.empty(shape, dtype=dtype, device=device)
               for _ in range(3 * nextra * Kout))
    stream = torch.cuda.current_stream(device).cuda_stream
    LAUNCHES[what + ("_xhalo" if xb >= 0 else "") + FORMS[dtype]] += 1
    rc = _load().pmesh_rebase_apply(
        _ptrs(eflat), nextra, K, _ptrs(routes), Kout, _ptrs(ne), shape[0],
        shape[1], shape[2], shape_in[0], xb, olo, ohi,
        int(dtype == torch.float64), device.index, stream)
    _raise_on(rc, what)
    return tuple(tuple(ne[(e * Kout + j) * 3:(e * Kout + j) * 3 + 3]
                       for j in range(Kout)) for e in range(nextra))
