"""ctypes wrappers of the DFT kernels of ``fft='mxu'``
(``csrc/fft_mxu.cu``), the port of the single-device Pallas kernels of
``pmesh_tpu/ops/fft_mxu.py`` (the split-Nyquist CT passes and the
dense passes) and of ``pmesh_tpu/ops/fft_mxu_ref.py`` (the full-spectrum
and first-CT zy passes; their x passes are ``x_dense`` and
``xct_multi``).

Each wrapper checks its tensors (CUDA, the pass's dtypes and shapes,
contiguous, one device, no autograd), the x/y splits of the CT passes
(R in {2, 4, 8} with M a multiple of 128) and the table shapes,
allocates the outputs
and the scratch with ``torch.empty``, launches on PyTorch's current
stream and raises RuntimeError if a launch returns an error.  The
numpy tables are uploaded once per table object and device (the public
operators of ``ops/fft_mxu.py`` build each table once per shape).

The f32 products of ``zy_fwd_ct2`` and ``xct_multi`` run on the
split-precision tensor-core routine (``tc_ct``, ``tc_z``): each table
enters as its real block table [[Wr, -Wi], [Wi, Wr]], laid out in the
kernel's tiles by ``ct_block_table`` / ``z_block_table`` and split once
into three bf16 parts (``bf16_split3``), beside the f32 row or column
sums of the complex tables (``table_sums``), with which the kernels add
back the first element of each data vector that they take out before
the products; both are made once per table object and device
(``_split_cached``).  The outputs that carry a mesh's mean (the first
modes of z chunk 0, column 0 of the y and x stages) are then summed
again from the f32 tables as the plain versions sum them.

The dense forward passes ``zy_fwd_half`` (and ``zy_fwd_full``, its
row-13 width, and ``zy_fwd_half_ct``'s z stage) and ``x_dense`` run
both their forms on ``tc_gemm``: a
split pass forms each data operand once as pre-split, pre-swizzled
tiles in a scratch buffer, and the products read those and the tables'
tiles (``ct_block_table`` at R = 1 with modes and contraction padded,
``z_real_block_table`` for the real z data, both ``tile_swizzle``-d;
three bf16 parts for the f32 products, one, the bf16 rounding, for the
bf16 products) through bulk copies into wgmma.  The f32 forms take out
each data vector's first element and form the outputs that carry the
mean in f32 chains as the ct2 passes do (z modes [0, 8), column 0 of
the y and x stages; the x pass on a forward table alone, as
``xct_multi`` on its forward passes); the z stage also chains the few
modes past its last whole 64-mode table tile (``z_tc_modes``: the
Nyquist mode of N2 = 384).

The zy inverses ``zy_inv_ct2``, ``zy_inv_ct2_dual``, ``zy_inv_half``
(and row 13's ``zy_inv_half_ct``) run on ``tc_gemm`` too, in every
form: the y stage on the y tables' ``ct_block_table`` tiles (both sets
of the dual on one split of the spectrum), the z stage as one
real-output product of the y output's rows (the inverse y butterfly
formed in its split pass) and the stacked irfft pair [A; B]
(``z_inv_block_table``; the z-CT's chunks with their P and Q columns),
the Nyquist plane added in f32.  Row 13's full-spectrum inverse
``zy_inv_full`` is two real-output products on ``tc_gemm``: the complex
z stage as one product of [xr | xi] and the stacked table [[A, -B], [B,
A]] (``z_full_block_table``: zr in the first N2 output columns, zi in
the rest), the y stage's real part as one product of the rows [Wr |
-Wi] alone (``y_real_block_table``).  Row 13's half-CT pass 1
``zy_fwd_half_ct`` runs ``zy_fwd_half``'s z stage, then its y CT
behind ``split_ct`` (three parts for the f32 products, each chunk's
first element taken out and column 0 chained, as ``zy_fwd_ct2``'s y
stage does).

Two forms besides the f32 one, which the kernels take or refuse, never
swap for another:

- ``bf16=True`` (``precision='bf16'``, ``fft='mxu_bf16'``): every
  product of the pass runs on the tensor cores, each operand rounded to
  bf16, the sums in f32: the forward passes (``zy_fwd_ct2``,
  ``xct_multi`` forward and inverse, the dense ones, the half-CT pass 1's
  y stage) on ``tc_gemm``'s one-part tables (``ct_block_table(sets,
  1)``, ``zct_block_table``, ``z_real_block_table``, ``tile_swizzle``-d)
  behind split passes that form each butterfly once and round it
  (``split_ct``, ``split_zct``, ``split_cols``); the zy inverses on
  one-part tables likewise (``split_cols``, ``split_zinv``);
- bf16 spectrum storage (``fft='mxu_bf16s'``), on the four ct2 passes
  only: ``zy_fwd_ct2(out_dtype=torch.bfloat16)`` writes its spectrum in
  bf16, ``xct_multi`` reads and writes bf16 when its input is bf16, and
  ``zy_inv_ct2``/``zy_inv_ct2_dual`` read a bf16 spectrum (f32
  products: its one exact bf16 part against the three-part y table).
  The real meshes and the Nyquist plane stay f32.

``LAUNCHES`` counts the calls of each kernel in each form: the key is
the kernel's name, with ``_bf16`` for the bf16 products and ``_bf16s``
for the bf16 storage (both, in that order, when a call uses both).
``kernel_launches()`` reads the C side's counts of the device kernels
those calls launched, by kind (``tc_gemm``, ``split``, ...).

The plain PyTorch versions are ``ops/fft_mxu.zy_fwd_ct2_plain``,
``xct_multi_plain``, ``zy_inv_ct2_plain``, ``zy_inv_ct2_dual_plain``,
``zy_fwd_half_plain``, ``x_dense_plain`` and ``zy_inv_half_plain``;
those of the row-13 zy passes are ``zy_fwd_half_plain`` at full width,
``ops/fft_mxu_ref.zy_inv_full_plain``,
``ops/fft_mxu_ref.zy_fwd_half_ct_plain`` and
``ops/fft_mxu.zy_inv_ct2_plain`` at Zh.  Each takes the same ``bf16``
flag and storage dtypes.
"""
import ctypes

import numpy as np
import torch

from . import fft_mxu as _fm
from ..native import cuda as _cuda

__all__ = ["zy_fwd_ct2", "xct_multi", "zy_inv_ct2", "zy_inv_ct2_dual",
           "zy_fwd_half", "x_dense", "zy_inv_half", "zy_fwd_full",
           "zy_inv_full", "zy_fwd_half_ct", "zy_inv_half_ct", "LAUNCHES",
           "reset_launches", "bf16_split3", "ct_block_table", "z_block_table",
           "zct_block_table", "z_real_block_table", "z_inv_block_table",
           "z_full_block_table", "y_real_block_table", "z_tc_modes", "tile_swizzle", "table_sums", "KERNEL_KINDS", "kernel_launches"]

# the ct2 passes, which also take bf16 spectrum storage
_STORAGE = ("zy_fwd_ct2", "xct_multi", "zy_inv_ct2", "zy_inv_ct2_dual")
_NAMES = _STORAGE + ("zy_fwd_half", "x_dense", "zy_inv_half", "zy_fwd_full",
                     "zy_inv_full", "zy_fwd_half_ct", "zy_inv_half_ct")
LAUNCHES = {name + form: 0 for name in _NAMES
            for form in (("", "_bf16", "_bf16s", "_bf16_bf16s")
                         if name in _STORAGE else ("", "_bf16"))}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_lib = None
_coefs = {}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _load():
    global _lib
    if _lib is None:
        lib = _cuda.load("fft_mxu")
        lib.pmesh_cuda_error_string.argtypes = [_I]
        lib.pmesh_cuda_error_string.restype = ctypes.c_char_p
        lib.pmesh_kernel_launches.argtypes = [_P, _I, _I]
        lib.pmesh_kernel_launches.restype = _I
        lib.pmesh_zy_fwd_ct2.argtypes = (
            [_P] * 5 + [_I] * 4 + [_P] * 12 + [_I] * 6 + [_I, _I, _P])
        lib.pmesh_xct_multi.argtypes = (
            [_P] * 20 + [_I] * 6 + [_F, _P, _I, _I, _P])
        lib.pmesh_zy_inv_ct2.argtypes = (
            [_P] * 4 + [_I] * 4 + [_P] * 6 + [_I] * 6 + [_P] * 2
            + [_I, _I, _P])
        lib.pmesh_zy_inv_ct2_dual.argtypes = (
            [_P] * 5 + [_I] * 4 + [_P] * 9 + [_I] * 6 + [_P] * 2
            + [_I, _I, _P])
        lib.pmesh_zy_fwd_half.argtypes = [_P] * 15 + [_I] * 6 + [_I, _P]
        lib.pmesh_x_dense.argtypes = [_P] * 17 + [_I] * 3 + [_F, _I, _I, _P]
        lib.pmesh_zy_inv_half.argtypes = [_P] * 8 + [_I] * 4 + [_I, _P]
        lib.pmesh_zy_inv_full.argtypes = [_P] * 8 + [_I] * 3 + [_I, _P]
        lib.pmesh_zy_fwd_half_ct.argtypes = [_P] * 16 + [_I] * 8 + [_I, _P]
        for fn in (lib.pmesh_zy_fwd_ct2, lib.pmesh_xct_multi,
                   lib.pmesh_zy_inv_ct2, lib.pmesh_zy_inv_ct2_dual,
                   lib.pmesh_zy_fwd_half, lib.pmesh_x_dense,
                   lib.pmesh_zy_inv_half, lib.pmesh_zy_inv_full,
                   lib.pmesh_zy_fwd_half_ct):
            fn.restype = _I
        _lib = lib
    return _lib


# the kernel kinds that csrc/fft_mxu.cu counts at their launches
KERNEL_KINDS = ("tc_ct", "tc_z", "tc_gemm", "split", "ct_fwd_col0")


def kernel_launches(reset=False):
    """{kind: launches} of the product routines and the dense passes'
    split and chain kernels since the last reset, counted by the C entry
    points where each kernel is launched (zeroed after reading when
    ``reset``)"""
    out = (ctypes.c_longlong * len(KERNEL_KINDS))()
    n = _load().pmesh_kernel_launches(out, len(KERNEL_KINDS), int(reset))
    assert n == len(KERNEL_KINDS)
    return dict(zip(KERNEL_KINDS, out))


def _raise_on(rc, what):
    if rc != 0:
        msg = _load().pmesh_cuda_error_string(rc).decode()
        raise RuntimeError("%s: CUDA launch failed (%d: %s)"
                           % (what, rc, msg))


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def _count(what, bf16, bf16s=False):
    """one launch of ``what`` in its form"""
    LAUNCHES[what + ("_bf16" if bf16 else "")
             + ("_bf16s" if bf16s else "")] += 1


_F32 = (torch.float32,)
_SPECTRUM = (torch.float32, torch.bfloat16)
_NAME = {torch.float32: 'f32', torch.bfloat16: 'bf16'}


def _check(tensors, shape, what, dtypes=_F32):
    """device, dtype, shape, contiguity and autograd checks; the
    tensors share one of ``dtypes``.  Returns the device"""
    dev = tensors[0].device
    for a in tensors:
        if not isinstance(a, torch.Tensor) or a.device.type != 'cuda':
            raise ValueError("%s: the CUDA kernel takes CUDA tensors" % what)
        if a.dtype not in dtypes or a.dtype != tensors[0].dtype:
            raise NotImplementedError(
                "%s: the CUDA kernel takes %s tensors of one dtype here "
                "(got %s)" % (what, " or ".join(_NAME[d] for d in dtypes),
                              ", ".join(str(t.dtype) for t in tensors)))
        if a.device != dev:
            raise ValueError("%s: all tensors must share one device" % what)
        if tuple(a.shape) != tuple(shape):
            raise ValueError("%s: expected shape %s, got %s"
                             % (what, tuple(shape), tuple(a.shape)))
        if not a.is_contiguous():
            raise ValueError("%s: tensors must be contiguous" % what)
        if a.requires_grad:
            raise NotImplementedError(
                "%s: the CUDA kernel takes no tensor that requires grad; "
                "gradients run through the Solver's force and potential, "
                "whose backward launches the kernels" % what)
    return dev


def _split(n, what, axis):
    """(R, M) of a CT axis; raises unless R in {2, 4, 8} and M % 128 == 0"""
    R, M = _fm._ct_factor(n)
    if R not in (2, 4, 8) or M % 128:
        raise ValueError("%s: axis %s of length %d does not split as R * M "
                         "with R in {2, 4, 8} and M a multiple of 128 (not "
                         "a ct2 shape)" % (what, axis, n))
    return R, M


def _shape(a, shape, what):
    if np.shape(a) != tuple(shape):
        raise ValueError("%s: table of shape %s where %s is needed"
                         % (what, np.shape(a), tuple(shape)))


def _table(a, shape, device, what):
    """the device copy of one numpy table, uploaded once per object"""
    _shape(a, shape, what)
    return _fm._on_device(np.asarray(a), device)


# --- the tables of the tensor-core routine -----------------------------------

_MODES = 64     # complex modes per table tile (the kernels' TC_MODES)
_BK = 16        # real contraction columns per slice (TC_BK)


def _bf16_bits(a):
    """the bits of f32 ``a`` rounded to the nearest bf16 (ties to even)"""
    u = np.ascontiguousarray(a, np.float32).view(np.uint32)
    return ((u + np.uint32(0x7FFF) + ((u >> 16) & np.uint32(1)))
            >> 16).astype(np.uint16)


def _bf16_value(b):
    return (b.astype(np.uint32) << 16).view(np.float32)


def bf16_split3(a):
    """(a1, a2, a3), the bits (uint16) of three bf16 values with a1 + a2
    + a3 = a to f32's precision: a1 = bf16(a), a2 = bf16(a - a1), a3 =
    bf16(a - a1 - a2), each rounded to nearest even, each difference
    exact in f32, as the kernels split their data operand (``split3``)."""
    a = np.asarray(a, np.float32)
    a1 = _bf16_bits(a)
    r1 = a - _bf16_value(a1)
    a2 = _bf16_bits(r1)
    return a1, a2, _bf16_bits(r1 - _bf16_value(a2))


def _parts(a, parts):
    """the first ``parts`` of ``bf16_split3(a)`` (a: (..., 128, 16)
    tiles) stacked before the tile axes: all three (the f32 products),
    or the bf16 rounding alone (the bf16 products)"""
    return np.ascontiguousarray(np.stack(bf16_split3(a)[:parts], -3))


def ct_block_table(pairs, parts=3):
    """The split table of ``tc_ct`` and of the dense passes' ``tc_gemm``
    for one or two (R, M, M) complex pairs (Wr, Wi)[j, q, m]: (R, T, nks,
    parts, 128, 16) bf16 bits (uint16), T = ceil(M / 64) tiles per set
    (set 2's after set 1's), nks = ceil(M / 8) slices, the parts of
    ``bf16_split3`` on axis 3 (three, or one: the bf16 rounding), zero
    past M (modes padded to whole tiles, the contraction to whole
    slices).  Tile t, row r: output mode q = (t mod T1) * 64 + r mod 64,
    real part for r < 64, imaginary above; slice s, column c: data row
    m = 8 s + c mod 8, real part for c < 8.  The entries are those of
    [[Wr, -Wi], [Wi, Wr]]."""
    tiles = []
    dr = _BK // 2
    for wr, wi in pairs:
        wr, wi = np.asarray(wr, np.float32), np.asarray(wi, np.float32)
        R, M = wr.shape[:2]
        T, nks = -(-M // _MODES), -(-M // dr)
        # j, out part, q, in part, m
        a = np.zeros((R, 2, T * _MODES, 2, nks * dr), np.float32)
        a[:, 0, :M, 0, :M], a[:, 0, :M, 1, :M] = wr, -wi
        a[:, 1, :M, 0, :M], a[:, 1, :M, 1, :M] = wi, wr
        a = a.reshape(R, 2, T, _MODES, 2, nks, dr)
        tiles.append(a.transpose(0, 2, 5, 1, 3, 4, 6).reshape(
            R, T, nks, 2 * _MODES, _BK))
    return _parts(np.concatenate(tiles, 1), parts)


def z_tc_modes(Zh):
    """the z modes of the dense z stage's table tiles: all Zh, or the
    whole 64-mode tiles when at most 8 modes would pass them (the
    Nyquist mode at even N2 = 128 k: 193 = 3 * 64 + 1 at 384), which the
    kernel chains instead"""
    tail = Zh % _MODES
    return Zh - tail if Zh > _MODES and tail <= 8 else Zh


def z_real_block_table(er, ei, zm, parts=3):
    """The split table of the dense z stage's ``tc_gemm`` for the real
    data of the (K, Zh) half-DFT pair (Er, Ei)[k, mode], over modes
    [0, zm): (T, nks, parts, 128, 16) bf16 bits (uint16), T = ceil(zm /
    64) tiles, nks = ceil(K / 16) slices, zero past K and zm.  Tile t,
    row c: mode t * 64 + c mod 64, the real output (Er) for c < 64, the
    imaginary (Ei) above; slice s, column kk: k = 16 s + kk (every
    contraction column a real data value)."""
    er, ei = np.asarray(er, np.float32), np.asarray(ei, np.float32)
    K = er.shape[0]
    T, nks = -(-zm // _MODES), -(-K // _BK)
    b = np.zeros((nks * _BK, 2, T * _MODES), np.float32)   # k, part, mode
    b[:K, 0, :zm], b[:K, 1, :zm] = er[:, :zm], ei[:, :zm]
    b = b.reshape(nks, _BK, 2, T, _MODES).transpose(3, 0, 2, 4, 1)
    return _parts(b.reshape(T, nks, 2 * _MODES, _BK), parts)


def z_inv_block_table(a, b, parts=3):
    """The split table of the z inverse's ``tc_gemm`` (real output, data
    the row operand) for the (K, n2) irfft pair (A, B)[k, n] of out = yr A
    + yi B (a 2-d pair: the dense z stage, one chunk) or the (Ri, K, Kb)
    z-CT chunks (P_j = yr A_j + yi B_j in columns [0, Kb), Q_j = yi A_j -
    yr B_j in [Kb, 2 Kb)): (R, T, nks, parts, 128, 16) bf16 bits
    (uint16), T = ceil(width / 128) tiles of 128 output columns, nks =
    ceil(K / 8) slices, the parts of ``bf16_split3`` on axis 3 (three, or
    one: the bf16 rounding), zero past K and the width.  Tile t, row c:
    output column t * 128 + c; slice s, column kk: data k = 8 s + kk mod
    8, its real part (the row of A, or -B for Q) for kk < 8, its
    imaginary part (B, or A for Q) above: the stacked [A; B], as
    ``split_cols`` lays out a complex contraction."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    if a.ndim == 2:
        cols = np.stack([a, b])[None]          # chunk, in part, k, column
    else:
        cols = np.concatenate([np.stack([a, b], 1), np.stack([-b, a], 1)],
                              -1)
    R, _, K, width = cols.shape
    T, nks, dr = -(-width // 128), -(-K // (_BK // 2)), _BK // 2
    big = np.zeros((R, 2, nks * dr, T * 128), np.float32)
    big[:, :, :K, :width] = cols
    # j, in part, s, k, t, c -> j, t, s, c, in part, k
    big = big.reshape(R, 2, nks, dr, T, 128).transpose(0, 4, 2, 5, 1, 3)
    return _parts(big.reshape(R, T, nks, 128, _BK), parts)


def z_full_block_table(a, b, parts=3):
    """The split table of the full-spectrum z inverse's ``tc_gemm`` for
    the (N2, N2) pair (A, B) = (Re Wz, -Im Wz): the complex product z =
    (xr + i xi) Wz as one real product of [xr | xi] and the stacked
    [[A, -B], [B, A]], i.e. ``z_inv_block_table`` of the (N2, 2 N2) pair
    ([A | -B], [B | A]): (1, T, nks, parts, 128, 16), T = ceil(2 N2 /
    128), nks = ceil(N2 / 8); output columns [0, N2) are zr = xr A + xi
    B, [N2, 2 N2) zi = xi A - xr B"""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return z_inv_block_table(np.concatenate([a, -b], 1),
                             np.concatenate([b, a], 1), parts)


def y_real_block_table(wr, wi, parts=3):
    """The split table of the real part of a dense complex DFT along y
    on ``tc_gemm`` (real output rows, data the column operand) for the
    (M, M) pair (Wr, Wi)[q, m]: the rows [Wr | -Wi] alone, as
    ``z_inv_block_table`` of (Wr^T, -Wi^T): (1, T, nks, parts, 128, 16),
    T = ceil(M / 128) tiles of 128 output rows, nks = ceil(M / 8).  Tile
    t, row r: output q = 128 t + r; slice s, column c: data row m = 8 s +
    c mod 8, Wr[q, m] for c < 8 (the real data, as ``split_cols`` lays it
    out), -Wi[q, m] above"""
    wr, wi = np.asarray(wr, np.float32), np.asarray(wi, np.float32)
    return z_inv_block_table(wr.T, -wi.T, parts)


def tile_swizzle(tab):
    """``tab`` (..., 128, 16) tiles as ``tc_gemm`` copies them whole into
    shared memory: the two 8-value halves of each row r swapped where
    bit 2 of r is set, so that ldmatrix reads conflict-free (the
    kernel's ``tile_at``)"""
    out = np.array(tab)
    rows = (np.arange(out.shape[-2]) >> 2) & 1 == 1
    half = out.shape[-1] // 2
    out[..., rows, :] = np.concatenate(
        [out[..., rows, half:], out[..., rows, :half]], -1)
    return out


def zct_block_table(er, ei, parts=1):
    """The split table of ``zy_fwd_ct2``'s z-CT stage on ``tc_gemm`` (the
    bf16 products) for the (Rz, K, Mq) stored-order chunks (Er,
    Ei)[p, k, mode]: the tiles of each stored chunk p in turn, (sum_p T
    nk_p, parts, 128, 16) bf16 bits (uint16), T = ceil(Mq / 64) tiles of
    nk_p slices each, zero past K and Mq.  Tile row c: mode t * 64 + c
    mod 64, the real output for c < 64.  The chunk's data is the
    butterfly u_d, d = j for j = ``_zct_order(Rz)[p]`` <= Rz / 2, else
    d = Rz - j and u_j = conj(u_d): u_0 and u_{Rz/2} are real, 16 k per
    slice (column kk: k = 16 s + kk), entries (Er, Ei) as
    ``z_real_block_table``'s; the others complex, 8 k per slice (column
    r: k = 8 s + r mod 8, real data for r < 8), entries [[Er, Ei], [-Ei,
    Er]] as ``z_block_table``'s, with the imaginary data's rows negated
    for a conjugate chunk (its u_j's imaginary part is -Im u_d)."""
    er, ei = np.asarray(er, np.float32), np.asarray(ei, np.float32)
    Rz, K, Mq = er.shape
    T = -(-Mq // _MODES)
    tiles = []
    for p, j in enumerate(_fm._zct_order(Rz)):
        d = j if j <= Rz // 2 else Rz - j
        if d == 0 or 2 * d == Rz:
            nk = -(-K // _BK)
            b = np.zeros((nk * _BK, 2, T * _MODES), np.float32)
            b[:K, 0, :Mq], b[:K, 1, :Mq] = er[p], ei[p]
            # s, kk, out part, t, mode -> t, s, out part, mode, kk
            b = b.reshape(nk, _BK, 2, T, _MODES).transpose(3, 0, 2, 4, 1)
        else:
            sign = -1.0 if j > Rz // 2 else 1.0
            dr = _BK // 2
            nk = -(-K // dr)
            b = np.zeros((2, nk * dr, 2, T * _MODES), np.float32)
            b[0, :K, 0, :Mq], b[1, :K, 0, :Mq] = er[p], -sign * ei[p]
            b[0, :K, 1, :Mq], b[1, :K, 1, :Mq] = ei[p], sign * er[p]
            # in part, s, k, out part, t, mode -> t, s, out, mode, in, k
            b = b.reshape(2, nk, dr, 2, T, _MODES).transpose(4, 1, 3, 5, 0, 2)
        tiles.append(b.reshape(T * nk, 2 * _MODES, _BK))
    return _parts(np.concatenate(tiles, 0), parts)


def z_block_table(er, ei):
    """The split table of ``tc_z`` for the (Rz, K, nmodes) complex z
    chunks (Er, Ei)[p, k, mode] (a 2-d pair: the dense half-DFT, Rz = 1):
    (Rz, T, nks, 3, 128, 16) bf16 bits (uint16), T = ceil(nmodes / 64)
    tiles, nks = ceil(K / 8) slices, zero past K and nmodes.  Tile t, row
    c: mode t * 64 + c mod 64, real output for c < 64; slice s, column r:
    k = 8 s + r mod 8, real data for r < 8.  The entries are those of
    [[Er, Ei], [-Ei, Er]] (rows: data, columns: output), transposed."""
    er, ei = (np.asarray(a, np.float32).reshape((-1,) + np.shape(a)[-2:])
              for a in (er, ei))
    Rz, K, nm = er.shape
    dr = _BK // 2
    nks, T = -(-K // dr), -(-nm // _MODES)
    b = np.zeros((Rz, 2, nks * dr, 2, T * _MODES), np.float32)
    b[:, 0, :K, 0, :nm], b[:, 1, :K, 0, :nm] = er, -ei
    b[:, 0, :K, 1, :nm], b[:, 1, :K, 1, :nm] = ei, er
    # p, in part, s, k, out part, t, mode -> p, t, s, out part, mode, in, k
    b = b.reshape(Rz, 2, nks, dr, 2, T, _MODES).transpose(0, 5, 2, 4, 6, 1, 3)
    b = b.reshape(Rz, T, nks, 2 * _MODES, _BK)
    return np.ascontiguousarray(np.stack(bf16_split3(b), 3))


def table_sums(pairs, axis):
    """(sets, ..., 2) f32: the sums of each complex pair (Wr, Wi) along
    ``axis`` (the contraction), taken in f64 from the f32 tables"""
    out = []
    for wr, wi in pairs:
        s = (np.asarray(wr, np.float64).sum(axis)
             + 1j * np.asarray(wi, np.float64).sum(axis))
        out.append(np.stack([s.real, s.imag], -1))
    return np.ascontiguousarray(np.stack(out), np.float32)


_SPLIT = {}


def _split_cached(arrays, device, make, form=None):
    """the device copies of ``make()`` = (split table (uint16 bits of
    bf16), f32 sums or None), made once per table objects ``arrays``,
    device and ``form`` (the kind of block table and its parts: at a cube
    one DFT table serves the z, y and x stages, whose block tables
    differ)"""
    key = (tuple(id(a) for a in arrays), str(device), form)
    hit = _SPLIT.get(key)
    if hit is None or any(h is not a for h, a in zip(hit[0], arrays)):
        host, sums = make()
        tab = torch.from_numpy(host.view(np.int16)).view(torch.bfloat16)
        hit = (tuple(arrays), (tab.to(device), None if sums is None else
                               torch.as_tensor(sums, device=device)))
        _SPLIT[key] = hit
    return hit[1]


def _coef(kind, R):
    """(R, R, 2) f32 host constants, [a][c] = (re, im):
    'fwd' b[r][j] = W_R^{-rj}; 'inv' b[r][j] = W_R^{+rj}; 'zfwd' the
    butterfly of the z-CT chunk in storage slot p, c[r][p] (conjugated
    for the upper chunks, as the JAX package forms them).  The z-CT
    inverse combination cs[j][c] = W_R^{+jc} is the 'inv' table."""
    key = (kind, R)
    if key not in _coefs:
        if kind == 'fwd':
            c = _fm._butter(R, -1)
        elif kind == 'inv':
            c = _fm._butter(R, +1)
        else:
            Bt = _fm._butter(R, -1)
            c = np.empty((R, R), complex)
            for p, j in enumerate(_fm._zct_order(R)):
                c[:, p] = Bt[:, j] if j <= R // 2 else np.conj(Bt[:, R - j])
        _coefs[key] = np.ascontiguousarray(
            np.stack([c.real, c.imag], -1).astype(np.float32))
    return _coefs[key]


def _host(a):
    return a.ctypes.data_as(_P)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _empty(shape, dev, n, dtype=torch.float32):
    return [torch.empty(shape, dtype=dtype, device=dev) for _ in range(n)]


def zy_fwd_ct2(x, wz, wy, bf16=False, out_dtype=torch.float32):
    """Row 6: real f32 (n0, N1, N2) -> (r, i) (n0, N1, N2//2) stored as
    ``out_dtype`` (f32 or bf16), nq (n0, N1) f32."""
    what = "zy_fwd_ct2"
    n0, N1, N2 = x.shape
    dev = _check((x,), x.shape, what)
    if out_dtype not in _SPECTRUM:
        raise NotImplementedError("%s: the spectrum is stored as f32 or "
                                  "bf16 (got %s)" % (what, out_dtype))
    Ry, My = _split(N1, what, 1)
    if N2 % 2:
        raise ValueError("%s: N2 must be even (got %d)" % (what, N2))
    Zm = N2 // 2
    zct = np.ndim(wz[0]) == 3
    if zct:
        Rz, Kz, Mq = _fm._zct_factor(N2)
        if Rz == 1:
            raise ValueError("%s: z-CT tables for N2=%d, which does not "
                             "split" % (what, N2))
        zshape = (Rz, Kz, Mq)
    else:
        Rz, Kz, Mq = 1, N2, Zm
        zshape = (N2, Zm)
    for a in wz:
        _shape(a, zshape, what)
    for a in wy:
        _shape(a, (Ry, My, My), what)
    # the f32 products take the split tables and, for the outputs that
    # carry the mean, the f32 tables too; the bf16 products tc_gemm's
    # one-part tables and a scratch for the data tiles of both stages
    wzr, wzi = (_table(a, zshape, dev, what) for a in wz)
    wyr, wyi = (_table(a, (Ry, My, My), dev, what) for a in wy)
    z3 = [np.reshape(a, (Rz, Kz, Mq)) for a in wz]
    zm = Zm if zct else z_tc_modes(Zm)
    split = None
    if not bf16:
        tz = _split_cached(tuple(wz), dev, lambda: (
            z_block_table(*wz), table_sums([z3], 1)[0]))
        ty = _split_cached(tuple(wy), dev, lambda: (
            ct_block_table([wy]), table_sums([wy], 2)))
    else:
        tz = _split_cached(tuple(wz), dev, lambda: (
            tile_swizzle(zct_block_table(*wz) if zct else
                         z_real_block_table(*wz, zm, 1)),
            table_sums([z3], 1)[0]), ('z one part', 1))
        ty = _ct_tiles([wy], dev)
        split = _split_scratch(max(_cdiv(n0 * N1, 128) * _cdiv(N2, _BK),
                                   _cdiv(n0 * Zm, 128) * (N1 // 8)),
                               True, dev)
    outr, outi = _empty((n0, N1, Zm), dev, 2, out_dtype)
    sr, si = _empty((n0, N1, Zm), dev, 2)
    nq = torch.empty((n0, N1), dtype=torch.float32, device=dev)
    bf16s = out_dtype == torch.bfloat16
    _count(what, bf16, bf16s)
    zcoef = _host(_coef('fwd' if bf16 else 'zfwd', Rz)) if zct else None
    rc = _load().pmesh_zy_fwd_ct2(
        _ptr(x), _ptr(wzr), _ptr(wzi), _ptr(tz[0]), _ptr(tz[1]), int(zct),
        Rz, Kz, Mq, zcoef, _ptr(wyr), _ptr(wyi), _ptr(ty[0]), _ptr(ty[1]),
        _host(_coef('fwd', Ry)), _ptr(outr), _ptr(outi), _ptr(nq), _ptr(sr),
        _ptr(si), _ptr(split), n0, N1, N2, Ry, My, zm, int(bool(bf16)),
        int(bf16s), _stream(dev))
    _raise_on(rc, what)
    return outr, outi, nq


def xct_multi(pr, pi, wx, scale, inverse=False, wx2=None, k2=None,
              bf16=False):
    """Row 5: the x CT of (N0, n1, W) complex; (r, i) or (r, i, r2, i2),
    stored as the input is (f32, or bf16 for the bf16 storage form)."""
    what = "xct_multi"
    N0, n1, W = pr.shape
    dev = _check((pr, pi), pr.shape, what, _SPECTRUM)
    bf16s = pr.dtype == torch.bfloat16
    R, M = _split(N0, what, 0)
    pairs = tuple(wx) + (() if wx2 is None else tuple(wx2))
    for a in pairs:
        _shape(a, (R, M, M), what)
    tabs = [_table(a, (R, M, M), dev, what) for a in pairs]
    tabs += [None] * (4 - len(tabs))
    sets = [pairs[i:i + 2] for i in range(0, len(pairs), 2)]
    split = None
    if not bf16:
        tc = _split_cached(pairs, dev, lambda: (
            ct_block_table(sets), table_sums(sets, 2)))
    else:
        tc = _ct_tiles(sets, dev)
        split = _split_scratch(_cdiv(n1 * W, 128) * (N0 // 8), True, dev)
    ks = [None] * 3
    if k2 is not None:
        ks = [_table(np.asarray(t, np.float32), (n,), dev, what)
              for t, n in zip(k2, (N0, n1, W))]
    nout = len(pairs)
    out = _empty((N0, n1, W), dev, nout, pr.dtype)
    # the bf16 inverse sums its butterfly from f32 products
    scr = _empty((N0, n1, W), dev, nout) if bf16s and inverse else []
    o = [_ptr(t) for t in out] + [None] * (4 - nout)
    s = [_ptr(t) for t in scr] + [None] * (4 - len(scr))
    _count(what, bf16, bf16s)
    rc = _load().pmesh_xct_multi(
        _ptr(pr), _ptr(pi), *(_ptr(t) for t in tabs), _ptr(tc[0]),
        _ptr(tc[1]),
        _ptr(ks[0]), _ptr(ks[1]), _ptr(ks[2]), *o, *s, _ptr(split), N0, n1,
        W, R, M, int(bool(inverse)), float(scale),
        _host(_coef('inv' if inverse else 'fwd', R)), int(bool(bf16)),
        int(bf16s), _stream(dev))
    _raise_on(rc, what)
    return tuple(out)


def _z_inv_form(AB, Zm, n2, what):
    """(zct, Ri, Kin, Kb, table shape) of an inverse z table pair"""
    if np.ndim(AB[0]) == 3:
        Ri, Kin, Kb = np.shape(AB[0])
        if Ri * Kin != Zm or Ri * Kb != n2 or not 1 <= Ri <= 8 or Kin % 8:
            raise ValueError("%s: z-CT tables %s do not fit Zm=%d, n2=%d"
                             % (what, np.shape(AB[0]), Zm, n2))
        return 1, Ri, Kin, Kb, (Ri, Kin, Kb)
    return 0, 1, Zm, n2, (Zm, n2)


def _z_inv_tiles(AB, dev, bf16):
    """the block table of the z inverse's tc_gemm for the pair ``AB`` on
    dev: ``z_inv_block_table``, swizzled (no sums: the inverse takes no
    first element out)"""
    return _split_cached(tuple(AB), dev, lambda: (
        tile_swizzle(z_inv_block_table(*AB, parts=_parts_of(bf16))),
        None), ('z inv', _parts_of(bf16)))[0]


def _zy_inv_scratch(n0, N1, Zm, y_parts, z_parts, dev):
    """the data tiles' scratch of a zy inverse: the larger of the y
    stage's (columns (n0, Zm), N1 / 8 slices) and the z stage's (rows
    n0 N1, ceil(Zm / 8) slices)"""
    return torch.empty(max(_cdiv(n0 * Zm, 128) * _cdiv(N1, 8) * y_parts,
                           _cdiv(n0 * N1, 128) * _cdiv(Zm, 8) * z_parts)
                       * 128 * _BK, dtype=torch.bfloat16, device=dev)


def _zy_inv_ct(what, rr, ii, Wys, ABs, n2, plane, bf16, half=False):
    """the ct2 zy inverse of one or two table sets (``Wys``, ``ABs``) on
    one read of (rr, ii): (n0, N1, n2) f32 outputs; the plane on the
    first.  The spectrum holds Zm = n2 / 2 modes (the ct2 storage), or
    n2 // 2 + 1 where ``half`` (row 13's half-CT form)"""
    n0, N1, Zm = rr.shape
    if (n2 // 2 + 1 != Zm) if half else (n2 != 2 * Zm):
        raise ValueError("%s: n2=%d does not fit Zm=%d" % (what, n2, Zm))
    dev = _check((rr, ii), rr.shape, what, _SPECTRUM)
    Ry, My = _split(N1, what, 1)
    if plane is not None:
        _check((plane,), (n0, N1), what)
    zct, Ri, Kin, Kb, zshape = _z_inv_form(ABs[0], Zm, n2, what)
    for AB in ABs:
        if _z_inv_form(AB, Zm, n2, what)[0] != zct:
            raise ValueError("%s: both z table sets must have one form"
                             % what)
        for a in AB:
            _shape(a, zshape, what)
    for Wy in Wys:
        for a in Wy:
            _shape(a, (Ry, My, My), what)
    bf16s = rr.dtype == torch.bfloat16
    ty = _ct_tiles(Wys, dev, _parts_of(bf16))
    tz = [_z_inv_tiles(AB, dev, bf16) for AB in ABs]
    outs = _empty((n0, N1, n2), dev, len(ABs))
    scr = _empty((n0, N1, Zm), dev, 2 * len(ABs))
    zq = torch.empty_like(outs[0]) if zct else None
    split = _zy_inv_scratch(n0, N1, Zm, 1 if bf16 or bf16s else 3,
                            _parts_of(bf16), dev)
    _count(what, bf16, bf16s)
    lib = _load()
    args = [_ptr(rr), _ptr(ii), _ptr(ty[0])] + [_ptr(t) for t in tz] + [
        zct, Ri, Kin, Kb, _ptr(plane)] + [_ptr(o) for o in outs] + [
        _ptr(t) for t in scr] + [
        _ptr(zq), _ptr(split), n0, N1, Zm, n2, Ry, My,
        _host(_coef('inv', Ry)), _host(_coef('inv', Ri)) if zct else None,
        int(bool(bf16)), int(bf16s), _stream(dev)]
    fn = lib.pmesh_zy_inv_ct2 if len(ABs) == 1 else lib.pmesh_zy_inv_ct2_dual
    _raise_on(fn(*args), what)
    return outs


def zy_inv_ct2(rr, ii, Wy, AB, n2, plane=None, bf16=False):
    """Row 7: (n0, N1, Zm) stored-order spectrum (f32, or bf16 for the
    bf16 storage form) -> real f32 (n0, N1, n2)."""
    return _zy_inv_ct("zy_inv_ct2", rr, ii, [Wy], [AB], n2, plane,
                      bf16)[0]


def zy_inv_ct2_dual(rr, ii, WyA, ABA, WyB, ABB, n2, planeA=None,
                    bf16=False):
    """Row 8: (outA, outB) from one (rr, ii) read; planeA on A only."""
    return tuple(_zy_inv_ct("zy_inv_ct2_dual", rr, ii, [WyA, WyB],
                            [ABA, ABB], n2, planeA, bf16))


# --- the dense passes (rows 3 and 4), natural order --------------------------
#
# The forward dense passes run on the tensor cores (``tc_gemm``) in both
# forms: the f32 products on the three-part tables, the bf16 products
# on one-part ones (the bf16 rounding of each entry).  Each pass splits
# its data once into the scratch ``split`` (bf16, 2048 parts' values per
# 128-row or -column tile and slice) before the products.

def _ct_tiles(sets, dev, parts=1):
    """(block table, (sets, R, M, 2) row sums) of tc_gemm's CT stage for
    one or two (R, M, M) pairs on dev: ``ct_block_table`` in ``parts``
    parts (one: the bf16 rounding), swizzled"""
    return _split_cached(tuple(a for p in sets for a in p), dev, lambda: (
        tile_swizzle(ct_block_table(sets, parts)), table_sums(sets, 2)),
        ('ct tiles', parts))


def _parts_of(bf16):
    return 1 if bf16 else 3


def _split_scratch(tiles_slices, bf16, dev):
    """the data tiles' scratch of a tc_gemm pass: tiles x slices of
    (parts, 128, 16) bf16"""
    return torch.empty(tiles_slices * _parts_of(bf16) * 128 * _BK,
                       dtype=torch.bfloat16, device=dev)


def _dense_table(pairs, dev, bf16):
    """(block table, (sets, 1, M, 2) row sums) of (M, M) pairs on dev"""
    sets = [tuple(np.asarray(a, np.float32)[None] for a in p) for p in pairs]
    return _split_cached(tuple(a for p in pairs for a in p), dev, lambda: (
        tile_swizzle(ct_block_table(sets, _parts_of(bf16))),
        table_sums(sets, 2)), ('dense', _parts_of(bf16)))


def _cdiv(a, b):
    return -(-a // b)


def _z_real_tiles(wz, zm, dev, bf16):
    """(block table, (Zh, 2) column sums) of the dense z stage for the
    (N2, Zh) pair ``wz`` over its first zm modes on dev"""
    return _split_cached(tuple(wz), dev, lambda: (
        tile_swizzle(z_real_block_table(*wz, zm, _parts_of(bf16))),
        table_sums([wz], 0)[0]), ('z real', _parts_of(bf16)))


def _zy_fwd_dense(what, x, wz, wy, Zh, bf16):
    """the dense z DFT of real (n0, N1, N2) by the (N2, Zh) pair ``wz``,
    then the dense (N1, N1) y DFT by ``wy``: (r, i) (n0, N1, Zh)"""
    n0, N1, N2 = x.shape
    dev = _check((x,), x.shape, what)
    wzr, wzi = (_table(a, (N2, Zh), dev, what) for a in wz)
    wyr, wyi = (_table(a, (N1, N1), dev, what) for a in wy)
    zm = z_tc_modes(Zh)
    tz = _z_real_tiles(wz, zm, dev, bf16)
    ty = _dense_table([wy], dev, bf16)
    rows = n0 * N1
    Zp = _cdiv(Zh, 4) * 4     # the z scratch's row pitch: 16-byte rows
    outr, outi = _empty((n0, N1, Zh), dev, 2)
    sr, si = _empty((rows, Zp), dev, 2)
    split = _split_scratch(max(_cdiv(rows, 128) * _cdiv(N2, _BK),
                               _cdiv(n0 * Zh, 128) * _cdiv(N1, _BK // 2)),
                           bf16, dev)
    c0 = torch.empty(max(rows, 2 * n0 * Zh), dtype=torch.float32, device=dev)
    _count(what, bf16)
    rc = _load().pmesh_zy_fwd_half(
        _ptr(x), _ptr(wzr), _ptr(wzi), _ptr(wyr), _ptr(wyi), _ptr(tz[0]),
        _ptr(tz[1]), _ptr(ty[0]), _ptr(ty[1]), _ptr(outr), _ptr(outi),
        _ptr(sr), _ptr(si), _ptr(split), _ptr(c0), n0, N1, N2, Zh, Zp, zm,
        int(bool(bf16)), _stream(dev))
    _raise_on(rc, what)
    return outr, outi


def zy_fwd_half(x, wz, wy, bf16=False):
    """Row 3 pass 1: real (n0, N1, N2) -> (r, i) (n0, N1, N2 // 2 + 1)
    by the (N2, Zh) half-DFT pair ``wz`` and the (N1, N1) y pair ``wy``."""
    return _zy_fwd_dense("zy_fwd_half", x, wz, wy, x.shape[2] // 2 + 1, bf16)


def zy_fwd_full(x, wz, wy, bf16=False):
    """Row 13 full-spectrum pass 1: real (n0, N1, N2) -> (r, i)
    (n0, N1, N2) by the (N2, N2) z DFT pair ``wz`` and the y pair ``wy``."""
    return _zy_fwd_dense("zy_fwd_full", x, wz, wy, x.shape[2], bf16)


def _forward(w):
    """whether the (N, N) pair ``w`` is a forward DFT, exp(-2 pi i q m /
    N): its imaginary part negative at (1, 1) (N > 2; at N <= 2 the
    directions coincide)"""
    wi = np.asarray(w[1])
    return wi.shape[0] > 2 and float(wi[1, 1]) < 0.0


def x_dense(pr, pi, wx, scale, wx2=None, k2=None, bf16=False):
    """Rows 3 and 4 x pass: the dense x DFT of (N0, n1, W) complex by
    the (N0, N0) pair ``wx`` times ``scale`` [and by ``wx2``], with the
    natural-order 1/k^2 fold ``k2``; (r, i) or (r, i, r2, i2)."""
    what = "x_dense"
    N0, n1, W = pr.shape
    dev = _check((pr, pi), pr.shape, what)
    pairs = [wx] if wx2 is None else [wx, wx2]
    tabs = [_table(a, (N0, N0), dev, what) for p in pairs for a in p]
    tc = _dense_table(pairs, dev, bf16)
    ks = [None] * 3
    if k2 is not None:
        ks = [_table(np.asarray(t, np.float32), (n,), dev, what)
              for t, n in zip(k2, (N0, n1, W))]
    out = _empty((N0, n1, W), dev, len(tabs))
    o = [_ptr(t) for t in out] + [None] * (4 - len(out))
    t2 = [_ptr(t) for t in tabs[2:]] + [None] * (4 - len(tabs))
    ncols = n1 * W
    split = _split_scratch(_cdiv(ncols, 128) * _cdiv(N0, _BK // 2), bf16,
                           dev)
    c0 = torch.empty(2 * ncols, dtype=torch.float32, device=dev)
    _count(what, bf16)
    rc = _load().pmesh_x_dense(
        _ptr(pr), _ptr(pi), _ptr(tabs[0]), _ptr(tabs[1]), t2[0], t2[1],
        _ptr(tc[0]), _ptr(tc[1]), _ptr(ks[0]), _ptr(ks[1]), _ptr(ks[2]),
        o[0], o[1], o[2], o[3], _ptr(split), _ptr(c0), N0, n1, W,
        float(scale), int(wx2 is None and k2 is None and _forward(wx)),
        int(bool(bf16)), _stream(dev))
    _raise_on(rc, what)
    return tuple(out)


def zy_inv_half(rr, ii, wy, AB, bf16=False):
    """Row 4 zy pass: (n0, N1, Zh) spectrum -> real (n0, N1, n2): the
    dense inverse y DFT of (n0, N1, Zh) by the (N1, N1) pair ``wy``, then
    the real part of the z product by the (Zh, n2) irfft pair ``AB``
    (out = yr @ A + yi @ B); n2 is AB's width and must have
    Zh = n2 // 2 + 1."""
    what = "zy_inv_half"
    n0, N1, Zh = rr.shape
    n2 = np.shape(AB[0])[-1]
    if n2 // 2 + 1 != Zh:
        raise ValueError("%s: z tables of width %d do not fit Zh=%d"
                         % (what, n2, Zh))
    dev = _check((rr, ii), rr.shape, what)
    for a in wy:
        _shape(a, (N1, N1), what)
    for a in AB:
        _shape(a, (Zh, n2), what)
    ty = _dense_table([wy], dev, bf16)
    tz = _z_inv_tiles(AB, dev, bf16)
    out = torch.empty((n0, N1, n2), dtype=torch.float32, device=dev)
    sr, si = _empty((n0, N1, Zh), dev, 2)
    parts = _parts_of(bf16)
    split = _zy_inv_scratch(n0, N1, Zh, parts, parts, dev)
    _count(what, bf16)
    rc = _load().pmesh_zy_inv_half(
        _ptr(rr), _ptr(ii), _ptr(ty[0]), _ptr(tz), _ptr(out), _ptr(sr),
        _ptr(si), _ptr(split), n0, N1, Zh, n2, int(bool(bf16)), _stream(dev))
    _raise_on(rc, what)
    return out


def zy_inv_full(rr, ii, wy, AB, bf16=False):
    """Row 13 full-spectrum zy inverse: (n0, N1, N2) spectrum -> real
    (n0, N1, N2): the complex inverse z DFT, whose (N2, N2) pair enters
    as ``AB`` = (Re Wz, -Im Wz), then the real part of the inverse y DFT
    ``wy``, in the JAX kernel's order."""
    what = "zy_inv_full"
    n0, N1, N2 = rr.shape
    dev = _check((rr, ii), rr.shape, what)
    for a in wy:
        _shape(a, (N1, N1), what)
    for a in AB:
        _shape(a, (N2, N2), what)
    parts = _parts_of(bf16)
    ty = _split_cached(tuple(wy), dev, lambda: (
        tile_swizzle(y_real_block_table(*wy, parts)), None),
        ('y real', parts))[0]
    tz = _split_cached(tuple(AB), dev, lambda: (
        tile_swizzle(z_full_block_table(*AB, parts)), None),
        ('z full', parts))[0]
    out = torch.empty((n0, N1, N2), dtype=torch.float32, device=dev)
    sr, si = _empty((n0, N1, N2), dev, 2)
    split = _zy_inv_scratch(n0, N1, N2, parts, parts, dev)
    _count(what, bf16)
    rc = _load().pmesh_zy_inv_full(
        _ptr(rr), _ptr(ii), _ptr(ty), _ptr(tz), _ptr(out), _ptr(sr),
        _ptr(si), _ptr(split), n0, N1, N2, int(bool(bf16)), _stream(dev))
    _raise_on(rc, what)
    return out


# --- the first-CT half pipeline (row 13), chunk-permuted x and y --------------

def zy_fwd_half_ct(x, wz, wy, bf16=False):
    """Row 13 half-CT pass 1: real (n0, N1, N2) -> (r, i) (n0, N1, Zh),
    Zh = N2 // 2 + 1: the (N2, Zh) half-DFT pair ``wz``, then the y CT by
    the (Ry, My, My) pair ``wy``; y chunk-permuted, the z-Nyquist column
    at Zh - 1."""
    what = "zy_fwd_half_ct"
    n0, N1, N2 = x.shape
    dev = _check((x,), x.shape, what)
    Ry, My = _split(N1, what, 1)
    Zh = N2 // 2 + 1
    wzr, wzi = (_table(a, (N2, Zh), dev, what) for a in wz)
    wyr, wyi = (_table(a, (Ry, My, My), dev, what) for a in wy)
    zm = z_tc_modes(Zh)
    tz = _z_real_tiles(wz, zm, dev, bf16)
    ty = _ct_tiles([wy], dev, _parts_of(bf16))
    rows = n0 * N1
    Zp = _cdiv(Zh, 4) * 4     # the z scratch's row pitch: 16-byte rows
    outr, outi = _empty((n0, N1, Zh), dev, 2)
    sr, si = _empty((rows, Zp), dev, 2)
    split = _split_scratch(max(_cdiv(rows, 128) * _cdiv(N2, _BK),
                               _cdiv(n0 * Zh, 128) * (N1 // 8)), bf16, dev)
    c0 = torch.empty(max(rows, 2 * Ry * n0 * Zh), dtype=torch.float32,
                     device=dev)
    _count(what, bf16)
    rc = _load().pmesh_zy_fwd_half_ct(
        _ptr(x), _ptr(wzr), _ptr(wzi), _ptr(wyr), _ptr(wyi), _ptr(tz[0]),
        _ptr(tz[1]), _ptr(ty[0]), _ptr(ty[1]), _host(_coef('fwd', Ry)),
        _ptr(outr), _ptr(outi), _ptr(sr), _ptr(si), _ptr(split), _ptr(c0),
        n0, N1, N2, Zh, Zp, zm, Ry, My, int(bool(bf16)), _stream(dev))
    _raise_on(rc, what)
    return outr, outi


def zy_inv_half_ct(rr, ii, Wy, AB, n2, bf16=False):
    """Row 13 half-CT zy inverse: (n0, N1, Zh) spectrum, y
    chunk-permuted -> real (n0, N1, n2): the inverse y CT by the
    (Ry, My, My) pair ``Wy``, then z half -> real by the (Zh, n2) irfft
    pair ``AB`` (the ct2 entry point at Zm = Zh, with no plane)."""
    what = "zy_inv_half_ct"
    if np.ndim(AB[0]) != 2:
        raise ValueError("%s: the z tables are the (Zh, n2) irfft pair"
                         % what)
    return _zy_inv_ct(what, rr, ii, [Wy], [AB], n2, None, bf16,
                      half=True)[0]
