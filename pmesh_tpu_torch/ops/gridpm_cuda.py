"""ctypes wrappers of the lattice paint and readout CUDA kernels
(``csrc/gridpm.cu``), the port of ``pmesh_tpu/ops/gridpm_pallas.py``.

Each wrapper checks its tensors (CUDA, f32, bf16 or f64 (one dtype for
all), 3-d mesh shape, contiguous, on one device, no autograd), allocates
the outputs in that dtype (bf16: the kernels compute in f32 and round
each output once, as the TPU kernels' ``_cdtype``; f64: the kernels
compute in f64, from the libraries that ``csrc/gridpm64.cu`` and
``csrc/gridpm64w.cu`` build),
launches on PyTorch's current stream and raises RuntimeError if the
launch returns an error.  ``LAUNCHES`` counts the launches of each
kernel, so a run can show that it went through the kernels (the
x-halo slab forms under "<name>_xhalo", the bf16 and f64 forms with
"_bf16" and "_f64" appended).

The kernels stage x-planes of a tile in shared memory (``csrc/gridpm.cu``
says how); ``plan`` is their launch planner: the tile, the planes per
block, the readout's ring depth, the paint's table buffers and the
shared bytes, for each window width, mesh count and mass.  It alone
counts the bytes; the entry points take them as given.

Both take the x-halo slab form of a slab-sharded mesh (``xbase``):
the paint reads displacements and mass of ``lo + rows + hi`` planes and
writes ``rows``, the readout reads meshes of ``lo + rows + hi`` planes
at the ``rows`` planes of its displacements, with no wrap on x.

The plain PyTorch version of both is ``ops/gridpm._shift_loop`` (on the
extended slab for the x-halo form: ``ops/gridpm.paint_slab_plain`` and
``readout_slab_plain``).
"""
import ctypes

import numpy as np
import torch

from .kernels import find_window, ANALYTIC_BASE
from ..native import cuda as _cuda

__all__ = ["paint_lattice", "readout_lattice", "plan", "LAUNCHES",
           "reset_launches"]

# the x-halo slab forms ("_xhalo") and the bf16 and f64 forms ("_bf16",
# "_f64") count apart
FORMS = {torch.float32: "", torch.bfloat16: "_bf16", torch.float64: "_f64"}
LAUNCHES = {name + halo + form: 0
            for name in ("paint_lattice", "readout_lattice")
            for halo in ("", "_xhalo") for form in FORMS.values()}

_ANALYTIC_CODE = {'nearest': 0, 'linear': 1, 'quadratic': 2, 'cubic': 3}
_TABLE, _TABLE_OFFSET = 4, 5
_DIFF = {None: -1, 0: 0, 1: 1, 2: 2, 'all': 3}
# the rebase kernels' launch grid (csrc/binned.cu) puts N1 and N0 on
# gridDim.y and gridDim.z; the lattice kernels, whose grid is smaller,
# share the check
_MAX_GRID_YZ = 65535

# csrc/gridpm.cu's tiles: THREADS threads in rows of TILE_Z z cells, one
# y row per thread in the readout's tile and ROWS_PER_THREAD in the
# paint's (TILE_Y); its widest window (NV_MAX, the 12^3 offsets of
# GRID_LIMIT) and the widths it compiles in (the others read nv at run
# time)
THREADS, TILE_Z, ROWS_PER_THREAD = 256, 32, 2
TILE_Y = {'readout': THREADS // TILE_Z,
          'paint': THREADS // TILE_Z * ROWS_PER_THREAD}
NV_MAX = 12
NV_COMPILED = (2, 3, 4, 5)
# csrc/gridpm64.cu's f64 tiles: THREADS threads in rows of TILE_Z64,
# each thread ROWS64[kind][nv - 1] consecutive y rows (the readout of one
# to three meshes, of 'all', the paint) of one z cell, or for the paint
# ZCELLS64[nv - 1] consecutive z cells; every width 1..NV_MAX compiled
# in, from NV_WIDE64 on in a library of its own (csrc/gridpm64w.cu) that
# builds in parallel
TILE_Z64, NV_WIDE64 = 16, 6
ROWS64 = {'readout': (2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1),
          'readout_all': (1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1),
          'paint': (2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1)}
ZCELLS64 = (1, 1, 1, 1, 2, 2, 2, 2, 2, 1, 1, 1)
NV_COMPILED64 = tuple(range(1, NV_MAX + 1))
# the H100's shared memory per block and its SMs
SMEM_LIMIT = 232448
SMS = 132
# planes per block: at most XC_MAX, halved while the launch has fewer
# than MIN_BLOCKS blocks (four per SM) and more than XC_MIN planes.  On
# an H100 (tools/time_lattice_kernels.py --xc) 32 timed as 64 at 512^3
# and 2-3 % faster on the 384^3 readouts; 16 cost the paint 5 %, 128
# the readouts 2-7 %.  XC_MIN and MIN_BLOCKS are not tuned.
XC_MAX, XC_MIN, MIN_BLOCKS = 32, 8, 4 * SMS

_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
_LL = ctypes.c_longlong
_libs = {}
_tables = {}
# the entry points' storage codes (csrc/gridpm.cu DT_*)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float64: 2}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _load(name="gridpm"):
    """the library of the f32 and bf16 forms, or of the f64 forms
    ("gridpm64" below NV_WIDE64 offsets per axis, "gridpm64w" from it
    on); all have the same entry points"""
    if name not in _libs:
        lib = _cuda.load(name)
        lib.pmesh_cuda_error_string.argtypes = [_I]
        lib.pmesh_cuda_error_string.restype = ctypes.c_char_p
        lib.pmesh_paint_lattice.argtypes = (
            [_P] * 4 + [_D, _P] + [_I] * 9 + [_P, _I, _D, _D]
            + [_I] * 3 + [_LL, _I, _P])
        lib.pmesh_paint_lattice.restype = _I
        lib.pmesh_readout_lattice.argtypes = (
            [_P] * 3 + [_I] + [_P] * 6 + [_I] * 9 + [_P, _I, _D, _D]
            + [_I] * 2 + [_LL, _I, _P])
        lib.pmesh_readout_lattice.restype = _I
        _libs[name] = lib
    return _libs[name]


def _lib_of(dtype, nv=1):
    if dtype != torch.float64:
        return _load()
    return _load("gridpm64w" if nv >= NV_WIDE64 else "gridpm64")


def _ceil(a, b):
    return -(-a // b)


def planes_per_block(n0, tiles):
    """the x planes each block of a staged launch walks, over n0 planes
    and ``tiles`` y-z tiles: at most XC_MAX, halved while the launch has
    fewer than MIN_BLOCKS blocks and more than XC_MIN planes (the rebase
    assign, ops/binned_cuda.plan, takes the same rule)"""
    xc = min(n0, XC_MAX)
    while xc > XC_MIN and tiles * _ceil(n0, xc) < MIN_BLOCKS:
        xc = _ceil(xc, 2)
    return xc


def tile(op, dtype=torch.float32, nv=None, diff_all=False):
    """(TY, TZ) of a block's y-z tile: TILE_Y[op] x TILE_Z where the
    kernels compute in f32 (f32 and bf16 storage); for f64 (``nv``
    offsets per axis; ``diff_all``: the readout of 'all') TILE_Z64
    threads along z of one cell each (the paint's ZCELLS64) and THREADS /
    TILE_Z64 thread rows of ROWS64 rows each (``csrc/gridpm64.cu``)"""
    if dtype != torch.float64:
        return TILE_Y[op], TILE_Z
    kind = 'readout_all' if op == 'readout' and diff_all else op
    rz = ZCELLS64[nv - 1] if op == 'paint' else 1
    return THREADS // TILE_Z64 * ROWS64[kind][nv - 1], TILE_Z64 * rz


def plan(op, shape, nv, nmesh=1, mass=False, dtype=torch.float32,
         diff_all=False):
    """The launch plan of a lattice kernel, as ``csrc/gridpm.cu`` and
    ``csrc/gridpm64.cu`` take it.

    op : 'paint' or 'readout'; shape : the (N0, N1, N2) output planes;
    nv : offsets per axis (1 .. NV_MAX); nmesh : the readout's meshes
    (1 .. 3; 'all' reads one); mass : the paint takes a mass mesh;
    dtype : the storage (f32 and bf16 compute in f32, f64 in f64);
    diff_all : the readout of 'all' (its f64 tile differs).

    A block owns a ``tile`` (TY x TZ) of y-z through ``xc`` output
    planes.  The readout keeps a ring of ``depth`` = nv + 1 mesh planes of
    the tile plus its nv - 1 halo, per mesh; the paint keeps ``nbuf``
    tables of 3 nv axis weights (and the mass) per source cell of that
    region: in f32 two where they fit in SMEM_LIMIT, else one; in f64 one
    (on an H100, one table and the blocks an SM it leaves room for were
    as fast as two tables or faster at every width timed).  Shared memory
    holds the compute type, 4 or 8 bytes a value.  ``smem``: the dynamic
    shared bytes; ``width``: the compiled nv, or None where the kernel
    reads nv at run time.  The window's kind does not change the plan."""
    if op not in ('paint', 'readout'):
        raise ValueError("plan: op must be 'paint' or 'readout'")
    if not 1 <= nv <= NV_MAX:
        raise ValueError("plan: %d offsets per axis; the kernels take 1 to "
                         "%d" % (nv, NV_MAX))
    if op == 'readout' and not 1 <= nmesh <= 3:
        raise ValueError("plan: the readout takes 1 to 3 meshes")
    n0, n1, n2 = (int(n) for n in shape)
    f64 = dtype == torch.float64
    ty, tz = tile(op, dtype, nv, diff_all)
    # f64 paint rows rounded up to whole z blocks (csrc/gridpm64.cu width64)
    rz = ZCELLS64[nv - 1] if f64 and op == 'paint' else 1
    region = (ty + nv - 1) * _ceil(tz + nv - 1, rz) * rz * (8 if f64 else 4)
    if op == 'readout':
        depth, nbuf = nv + 1, None
        smem = depth * nmesh * region
    else:
        table = (3 * nv + int(bool(mass))) * region
        depth, nbuf = None, 2 if 2 * table <= SMEM_LIMIT and not f64 else 1
        smem = nbuf * table
    xc = planes_per_block(n0, _ceil(n1, ty) * _ceil(n2, tz))
    compiled = NV_COMPILED64 if f64 else NV_COMPILED
    return dict(width=nv if nv in compiled else None, tile=(ty, tz),
                xc=xc, depth=depth, nbuf=nbuf, smem=smem)


def _window_args(window, device, dtype=torch.float32):
    """(kind code, table pointer, table length, step, offset); the table
    in the compute type of ``dtype`` (f64 for f64, else f32)."""
    win = find_window(window)
    base = ANALYTIC_BASE.get(win.kind)
    if base is not None:
        return _ANALYTIC_CODE[base], None, 0, 0.0, 0.0
    tdtype = torch.float64 if dtype == torch.float64 else torch.float32
    key = (win.kind, device, tdtype)
    if key not in _tables:
        # the values, then the forward differences / step, both from f8
        t = np.asarray(win.table, dtype='f8')
        d = np.append(np.diff(t) / win.table_step, 0.0)
        _tables[key] = torch.as_tensor(np.concatenate([t, d]),
                                       dtype=tdtype, device=device)
    code = _TABLE if win.table_offset is None else _TABLE_OFFSET
    return (code, _tables[key], len(win.table), win.table_step,
            0.0 if win.table_offset is None else win.table_offset)


_DTYPES = tuple(FORMS)


def _check(arrays, what):
    """Common checks; returns (shape, device)."""
    ref = arrays[0]
    for a in arrays:
        if not isinstance(a, torch.Tensor) or a.device.type != 'cuda':
            raise ValueError("%s: the CUDA kernel takes CUDA tensors"
                             % what)
        if a.dtype not in _DTYPES or a.dtype != ref.dtype:
            raise NotImplementedError(
                "%s: the CUDA kernel takes f32, bf16 or f64 meshes of one "
                "dtype (got %s)"
                % (what, ", ".join(str(t.dtype) for t in arrays)))
        if a.dim() != 3:
            raise NotImplementedError(
                "%s: the CUDA kernel is 3-d only (got %d-d)"
                % (what, a.dim()))
        if a.shape != ref.shape or a.device != ref.device:
            raise ValueError("%s: all meshes must share shape and device"
                             % what)
        if not a.is_contiguous():
            raise ValueError("%s: tensors must be contiguous" % what)
        if a.requires_grad:
            if what.startswith('rebase'):
                raise NotImplementedError(
                    "%s: the CUDA rebase has no gradient rule, as the JAX "
                    "package's Pallas rebase has none (pmesh_tpu/ops/"
                    "binned.py:288-293); differentiate nbody_binned on the "
                    "CPU, where the plain rebase takes gradients" % what)
            raise NotImplementedError(
                "%s: the CUDA kernel takes no tensor that requires grad; "
                "gradients run through ops/gridpm.paint_grid and "
                "readout_grid, whose backward launches the kernels" % what)
    n0, n1, n2 = ref.shape
    if n0 > _MAX_GRID_YZ or n1 > _MAX_GRID_YZ:
        raise ValueError("%s: Nmesh[0] and Nmesh[1] must be <= %d"
                         % (what, _MAX_GRID_YZ))
    if n1 * n2 > 2 ** 31 - 1:
        raise ValueError("%s: a plane of Nmesh[1] * Nmesh[2] cells must "
                         "hold fewer than 2^31" % what)
    return tuple(ref.shape), ref.device


def _ptr(t):
    return None if t is None else t.data_ptr()


def _raise_on(rc, what, dtype=torch.float32):
    if rc != 0:
        msg = _lib_of(dtype).pmesh_cuda_error_string(rc).decode()
        raise RuntimeError("%s: CUDA launch failed (%d: %s)"
                           % (what, rc, msg))


def _halo_rows(what, n_in, rows, xbase, lo_reach, hi_reach):
    """check the x-halo form's extent: output rows [0, rows) read input
    planes from xbase - lo_reach to rows - 1 + xbase + hi_reach"""
    if xbase - lo_reach < 0 or rows - 1 + xbase + hi_reach >= n_in \
            or rows < 1:
        raise ValueError("%s: %d input planes do not hold the x halo of "
                         "%d rows at base %d (reach -%d, +%d)"
                         % (what, n_in, rows, xbase, lo_reach, hi_reach))


def paint_lattice(disp, mass, vmin, vmax, window, diffdir=None, rows=None,
                  xbase=None):
    """Gather-form lattice paint:
    rho[p] = sum_v m(p - v) prod_d W_d(v_d - s_d(p - v)), v in
    [vmin, vmax]^3, W_d = -W' on axis ``diffdir``.

    disp : three (N0, N1, N2) f32, bf16 or f64 CUDA tensors (cell units)
    mass : None (1), a scalar, or a mesh tensor of disp's dtype
    rows, xbase : the x-halo slab form: disp and mass hold N0 = lo +
        rows + hi planes, the output ``rows`` planes, output row i at
        input plane i + xbase (= lo), no wrap on x
    """
    what = "paint_lattice"
    if diffdir not in (None, 0, 1, 2):
        raise ValueError("%s: diffdir must be None, 0, 1 or 2" % what)
    disp = tuple(disp)
    if len(disp) != 3:
        raise NotImplementedError("%s: the CUDA kernel is 3-d only" % what)
    mesh_mass = isinstance(mass, torch.Tensor) and mass.dim() > 0
    shape, device = _check(disp + ((mass,) if mesh_mass else ()), what)
    n_in = shape[0]
    if xbase is None:
        xbase = -1
        rows = n_in
    else:
        _halo_rows(what, n_in, rows, xbase, vmax, -vmin)
    scalar = 1.0 if mass is None or mesh_mass else float(mass)
    dtype = disp[0].dtype
    kind, table, ntable, step, offset = _window_args(window, device, dtype)
    out = torch.empty((rows,) + shape[1:], dtype=dtype, device=device)
    p = plan('paint', out.shape, vmax - vmin + 1, mass=mesh_mass,
             dtype=dtype)
    stream = torch.cuda.current_stream(device).cuda_stream
    LAUNCHES[what + ("_xhalo" if xbase >= 0 else "") + FORMS[dtype]] += 1
    rc = _lib_of(dtype, vmax - vmin + 1).pmesh_paint_lattice(
        _ptr(disp[0]), _ptr(disp[1]), _ptr(disp[2]),
        _ptr(mass) if mesh_mass else None, scalar, _ptr(out),
        rows, shape[1], shape[2], n_in, xbase, vmin, vmax, kind,
        _DIFF[diffdir], _ptr(table), ntable, step, offset,
        _DTYPE_CODE[dtype], p['xc'], p['nbuf'], p['smem'], device.index,
        stream)
    _raise_on(rc, what, dtype)
    return out


def readout_lattice(meshes, disp, vmin, vmax, window, diffdir=None,
                    xbase=None):
    """Lattice readout: out[q] = sum_v prod_d W_d(v_d - s_d(q))
    mesh[q + v] for 1 to 3 meshes sharing the weights; with
    ``diffdir='all'`` the three derivative readouts of one mesh.
    Returns a tuple of outputs (one per mesh, or three for 'all').

    xbase : the x-halo slab form: the meshes hold lo + rows + hi planes
        about the displacements' ``rows``, particle row i at mesh plane
        i + xbase (= lo), no wrap on x."""
    what = "readout_lattice"
    if diffdir not in _DIFF:
        raise ValueError("%s: diffdir must be None, 0, 1, 2 or 'all'"
                         % what)
    meshes, disp = tuple(meshes), tuple(disp)
    if not 1 <= len(meshes) <= 3:
        raise ValueError("%s: takes 1 to 3 meshes" % what)
    if diffdir == 'all' and len(meshes) != 1:
        raise ValueError("%s: diffdir='all' takes exactly one mesh" % what)
    if len(disp) != 3:
        raise NotImplementedError("%s: the CUDA kernel is 3-d only" % what)
    if xbase is None:
        shape, device = _check(meshes + disp, what)
        n_in, xbase = shape[0], -1
    else:
        shape, device = _check(disp, what)
        mshape, mdev = _check(meshes, what)
        if mshape[1:] != shape[1:] or mdev != device:
            raise ValueError("%s: the meshes' planes must match the "
                             "displacements'" % what)
        n_in = mshape[0]
        if meshes[0].dtype != disp[0].dtype:
            raise NotImplementedError(
                "%s: the meshes and displacements must share a dtype" % what)
        _halo_rows(what, n_in, shape[0], xbase, -vmin, vmax)
    nout = 3 if diffdir == 'all' else len(meshes)
    dtype = disp[0].dtype
    kind, table, ntable, step, offset = _window_args(window, device, dtype)
    outs = tuple(torch.empty(shape, dtype=dtype, device=device)
                 for _ in range(nout))
    m = [_ptr(x) for x in meshes] + [None] * (3 - len(meshes))
    o = [_ptr(x) for x in outs] + [None] * (3 - nout)
    p = plan('readout', shape, vmax - vmin + 1, nmesh=len(meshes),
             dtype=dtype, diff_all=diffdir == 'all')
    stream = torch.cuda.current_stream(device).cuda_stream
    LAUNCHES[what + ("_xhalo" if xbase >= 0 else "") + FORMS[dtype]] += 1
    rc = _lib_of(dtype, vmax - vmin + 1).pmesh_readout_lattice(
        m[0], m[1], m[2], len(meshes), _ptr(disp[0]), _ptr(disp[1]),
        _ptr(disp[2]), o[0], o[1], o[2], shape[0], shape[1], shape[2],
        n_in, xbase, vmin, vmax, kind, _DIFF[diffdir], _ptr(table), ntable,
        step, offset, _DTYPE_CODE[dtype], p['xc'], p['smem'], device.index,
        stream)
    _raise_on(rc, what, dtype)
    return outs
