"""CPU evidence that the split-precision tensor-core products of
zy_fwd_ct2 and xct_multi (csrc/fft_mxu.cu, tc_ct and tc_z), of the
dense passes zy_fwd_half and x_dense and of the zy inverses zy_inv_ct2,
zy_inv_ct2_dual and zy_inv_half (tc_gemm) keep f32 accuracy.

The kernels split each f32 operand into three bf16 parts, a = a1 + a2 +
a3 (the host splits the tables, ops/fft_mxu_cuda.bf16_split3; the threads
split the data the same way) and keep the six products down to 2^-16 of
the leading one.  Here:

- the host split: every part is a bf16 value (its 16 low f32 bits zero),
  each part at most 2^-8 of the one before, and a1 + a2 + a3 reproduces
  each table entry to 2^-24 relative (f32's own rounding);
- the tables' layout: the real block GEMM that the kernels run over
  ct_block_table / z_block_table (tiles, slices, parts) equals the
  complex products W u and u E; the dense passes' tables
  (ct_block_table at R = 1 and z_real_block_table for real z data) at
  N = 33, 75, 80, 96 and 384 are bf16_split3 of the padded block
  matrices, zero in the padding, and give W u and x E; the zy inverses'
  real-output z table (z_inv_block_table: the stacked [A; B] in slices
  of 8 complex k, 128 output columns per tile, the z-CT's P and Q
  columns per chunk) at Zh = 38, 193 and 257, the stored-order ct2
  table at Zm = 256 and the z-CT at n2 = 1024, three parts and one, is
  bf16_split3 of the padded stacked matrix and gives yr A + yi B; row
  13's full-spectrum inverse tables at N = 33, 75 and 512, three parts
  and one: the stacked complex z table [[A, -B]; [B, A]]
  (z_full_block_table, zr and zi in one product's columns) and the real
  output y table of the rows [Wr | -Wi] (y_real_block_table), each
  bf16_split3 of the padded matrix and zero in the padding;
- a plain-torch emulation of the split product, kept in this file (not a
  mode of the package), patched into the plain passes where the kernels
  run it (the f32 forms of zy_fwd_ct2, xct_multi, zy_fwd_half and
  x_dense; the few outputs
  that carry the mean, which the kernels sum again as the plain passes
  do, are left to the split here too): each pass, forward
  and the folded dual inverse, at (256, 256, 16) and 32^3 against the
  JAX package's Pallas kernels in interpret mode within 3e-6 of max (the
  tolerance of tests/test_torch_fft_mxu.py), and the (256, 256, 16)
  force within 2e-5 of max of JAX's fft='xla'.  At 32^3, not a ct2
  shape, the passes run with R = 1 (no butterfly): the same products.
  The dense passes likewise on a mesh with a mean of 1 at (16, 16, 16)
  and (24, 20, 15), forward and the dual inverse with the 1/k^2 fold,
  against the dense Pallas kernels (_zy_fwd_half_call,
  _xpass_half_call); and the zy inverses (single with the Nyquist plane,
  the dual with it on set A, the dense one with the folded tables) on
  1/k^2-filtered spectra, at (8, 256, 16) and (8, 32, 32) (the y and
  z extents of SHAPES: the zy passes work per x-plane) against
  _zy_inv_ct2_call / _zy_inv_ct2_call_dual and at (16, 16, 16) and
  (24, 20, 15) against _zy_inv_half_call.  Row 13's two zy passes as
  the kernels run them (the full inverse's z stage as one real product
  of [xr | xi] and the stacked table, its y stage as one real-output
  product; the half-CT forward's dense z stage with each row's first
  value taken out and the modes [0, 8) and past the last whole tile
  summed as plain sums them, its y CT with each chunk's first element
  taken out and column 0 as plain), patched into zy_inv_full_plain and
  zy_fwd_half_ct_plain: fft3_real_inverse (grad None and 2) and
  fft3_real_inverse_grad3 at (8, 32, 32) and (6, 10, 14), and
  fft3_real_forward_half_ct at (256, 256, 16), against the JAX
  package's entry points in interpret mode within 3e-6 of max.  The
  emulation sums the six products in f32 on the CPU; the tensor
  cores' truncating sums are the card's part (tests/test_torch_cuda.py,
  chip_smoke.py).
"""
import inspect

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental import pallas as pl

from pmesh_tpu import ParticleMesh as JaxPM
from pmesh_tpu.models import fastpm as jfastpm
from pmesh_tpu.ops import fft_mxu as jfm
from pmesh_tpu.ops import fft_mxu_ref as jref
from pmesh_tpu_torch import convert
from pmesh_tpu_torch.models import fastpm as tfastpm
from pmesh_tpu_torch.ops import fft_mxu as fm
from pmesh_tpu_torch.ops import fft_mxu_cuda as fk
from pmesh_tpu_torch.ops import fft_mxu_ref as ref

torch.set_num_threads(1)

TOL_PASS = 3e-6
TOL_FORCE = 2e-5
SHAPES = [(256, 256, 16), (32, 32, 32)]


def _rel(ref, got):
    ref = np.asarray(ref)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert ref.shape == got.shape
    return np.abs(ref - got).max() / np.abs(ref).max()


def _value(bits):
    return (np.asarray(bits).astype(np.uint32) << 16).view(np.float32)


# --- the host split and the tables' layout -------------------------------------

@pytest.mark.parametrize("n", [256, 1024])
def test_bf16_split3_of_tables(n):
    wr, wi = fm._ct_fwd_mats_np(n)
    er, ei = fm._zct_fwd_mats_np(n)
    for a in (wr, wi, er, ei, fm._ct_inv_mats_np(n)[1]):
        parts = fk.bf16_split3(a)
        vals = [_value(p) for p in parts]
        for p, v in zip(parts, vals):
            assert p.dtype == np.uint16
            assert np.all(v.view(np.uint32) & 0xFFFF == 0)
        for big, small in zip(vals, vals[1:]):
            assert np.all(np.abs(small) <= 2.0 ** -8 * np.abs(big))
        total = sum(v.astype(np.float64) for v in vals)
        err = np.abs(total - a.astype(np.float64))
        assert np.all(err <= 2.0 ** -24 * np.abs(a))


def _unsplit(tab):
    """the f64 sum of the three parts (axis 3) of a split table"""
    return sum(_value(tab[:, :, :, h]).astype(np.float64) for h in range(3))


@pytest.mark.parametrize("n, sets", [(256, 1), (512, 2)])
def test_ct_block_table_layout(n, sets):
    """the tc_ct GEMM over ct_block_table: output tile t row r (mode q, re
    or im) sums table[j, t, s, :, r, c] u_part(c)[8 s + c % 8] over the
    slices s and columns c, for each chunk j and set"""
    pairs = [fm._ct_fwd_mats_np(n), fm._ct_inv_mats_np(n)][:sets]
    R, M = pairs[0][0].shape[:2]
    tab = _unsplit(fk.ct_block_table(pairs))
    T1, nks = M // 64, M // 8
    assert tab.shape == (R, sets * T1, nks, 128, 16)
    rng = np.random.RandomState(n)
    u = rng.normal(size=(R, M, 5)) + 1j * rng.normal(size=(R, M, 5))
    # data operand of slice s: rows c < 8 real, c >= 8 imaginary
    d = np.concatenate([u.real.reshape(R, nks, 8, 5),
                        u.imag.reshape(R, nks, 8, 5)], 2)
    out = np.einsum('jtsrc,jscn->jtrn', tab, d)
    for k, (wr, wi) in enumerate(pairs):
        ref = np.einsum('jqm,jmn->jqn', wr.astype(np.float64)
                        + 1j * wi.astype(np.float64), u)
        got = out[:, k * T1:(k + 1) * T1].reshape(R, T1, 2, 64, 5)
        got = (got[:, :, 0] + 1j * got[:, :, 1]).reshape(R, M, 5)
        np.testing.assert_allclose(got, ref, atol=1e-9 * np.abs(ref).max())


@pytest.mark.parametrize("n2", [16, 18, 512])
def test_z_block_table_layout(n2):
    """the tc_z GEMM over z_block_table: output row m, tile t column c
    (mode, re or im) sums table[p, t, s, :, c, r] u_part(r)[8 s + r % 8]"""
    wz = fm._z_fwd_tabs(n2, n2 // 2)
    er, ei = (np.asarray(a, np.float64).reshape((-1,) + np.shape(a)[-2:])
              for a in wz)
    Rz, K, nm = er.shape
    tab = _unsplit(fk.z_block_table(*wz))
    nks, T = -(-K // 8), -(-nm // 64)
    assert tab.shape == (Rz, T, nks, 128, 16)
    rng = np.random.RandomState(n2)
    u = rng.normal(size=(Rz, 3, K)) + 1j * rng.normal(size=(Rz, 3, K))
    up = np.zeros((Rz, 3, nks * 8), complex)
    up[:, :, :K] = u
    d = np.concatenate([up.real.reshape(Rz, 3, nks, 8),
                        up.imag.reshape(Rz, 3, nks, 8)], 3)
    out = np.einsum('ptscr,pmsr->pmtc', tab, d).reshape(Rz, 3, T, 2, 64)
    got = (out[:, :, :, 0] + 1j * out[:, :, :, 1]).reshape(Rz, 3, T * 64)
    ref = np.einsum('pmk,pkq->pmq', u, er + 1j * ei)
    np.testing.assert_allclose(got[:, :, :nm], ref,
                               atol=1e-9 * np.abs(ref).max())
    sums = fk.table_sums([(er, ei)], 1)[0]
    assert sums.shape == (Rz, nm, 2) and sums.dtype == np.float32
    np.testing.assert_allclose(sums[..., 0] + 1j * sums[..., 1],
                               (er + 1j * ei).sum(1), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("n", [33, 75, 80, 96, 384])
@pytest.mark.parametrize("sets", [1, 2])
def test_dense_block_table_padded(n, sets):
    """the dense passes' block table (ct_block_table at R = 1, any M):
    modes padded to whole 64-mode tiles and the contraction to whole
    8-row slices with zeros, each part that of bf16_split3 of the padded
    [[Wr, -Wi], [Wi, Wr]]; the one-part form is the bf16 rounding; the
    GEMM over the tiles gives W u"""
    kv = tuple(np.sin(np.fft.fftfreq(n) * 2 * np.pi))
    pairs = [fm._dft_np(n, -1), fm._dft_fold_np(n, kv)][:sets]
    T1, nks = -(-n // 64), -(-n // 8)
    tab = fk.ct_block_table([tuple(a[None] for a in p) for p in pairs])
    assert tab.shape == (1, sets * T1, nks, 3, 128, 16)
    assert tab.dtype == np.uint16
    one = fk.ct_block_table([tuple(a[None] for a in p) for p in pairs], 1)
    np.testing.assert_array_equal(one, tab[:, :, :, :1])
    for k, (wr, wi) in enumerate(pairs):
        big = np.zeros((2, T1 * 64, 2, nks * 8), np.float32)
        big[0, :n, 0, :n], big[0, :n, 1, :n] = wr, -wi
        big[1, :n, 0, :n], big[1, :n, 1, :n] = wi, wr
        want = np.stack(fk.bf16_split3(big), 0)  # part, out, q, in, m
        got = tab[0, k * T1:(k + 1) * T1].reshape(T1, nks, 3, 2, 64, 2, 8)
        # tile t, slice s, part h, out part, q, in part, m -> the same order
        got = got.transpose(2, 3, 0, 4, 5, 1, 6).reshape(want.shape)
        np.testing.assert_array_equal(got, want)
        pad = np.ones(big.shape, bool)
        pad[:, :n, :, :n] = False
        assert not got[:, pad].any()
    rng = np.random.RandomState(n)
    u = rng.normal(size=(n, 3)) + 1j * rng.normal(size=(n, 3))
    up = np.zeros((nks * 8, 3), complex)
    up[:n] = u
    d = np.concatenate([up.real.reshape(nks, 8, 3), up.imag.reshape(nks, 8, 3)],
                       1)
    out = np.einsum('tsrc,scn->trn', _unsplit(tab)[0], d)
    for k, (wr, wi) in enumerate(pairs):
        o = out[k * T1:(k + 1) * T1].reshape(T1, 2, 64, 3)
        got = (o[:, 0] + 1j * o[:, 1]).reshape(T1 * 64, 3)[:n]
        ref = (wr.astype(np.float64) + 1j * wi.astype(np.float64)) @ u
        np.testing.assert_allclose(got, ref, atol=1e-9 * np.abs(ref).max())


@pytest.mark.parametrize("n2", [33, 75, 80, 96, 384])
@pytest.mark.parametrize("parts", [3, 1])
def test_z_real_block_table_padded(n2, parts):
    """the dense z stage's table for real data: every contraction column
    a real k (16 per slice), the modes [0, zm) of z_tc_modes (the
    Nyquist mode of 384 chained, not tiled) padded to whole tiles, zero
    past K and zm; the GEMM over the tiles gives x E"""
    Zh = n2 // 2 + 1
    er, ei = fm._dft_half_np(n2, Zh)
    zm = fk.z_tc_modes(Zh)
    assert zm == (192 if n2 == 384 else Zh)
    T, nks = -(-zm // 64), -(-n2 // 16)
    tab = fk.z_real_block_table(er, ei, zm, parts)
    assert tab.shape == (T, nks, parts, 128, 16) and tab.dtype == np.uint16
    big = np.zeros((nks * 16, 2, T * 64), np.float32)   # k, part, mode
    big[:n2, 0, :zm], big[:n2, 1, :zm] = er[:, :zm], ei[:, :zm]
    want = np.stack(fk.bf16_split3(big)[:parts], 0)
    got = tab.reshape(T, nks, parts, 2, 64, 16).transpose(2, 1, 5, 3, 0, 4)
    np.testing.assert_array_equal(got.reshape(want.shape), want)
    pad = np.ones(big.shape, bool)
    pad[:n2, :, :zm] = False
    assert not got.reshape(want.shape)[:, pad].any()
    if parts == 3:
        x = np.random.RandomState(n2).normal(size=(5, n2))
        xp = np.zeros((5, nks * 16))
        xp[:, :n2] = x
        out = np.einsum('msk,tsck->mtc', xp.reshape(5, nks, 16),
                        _unsplit_z(tab)).reshape(5, T, 2, 64)
        got = (out[:, :, 0] + 1j * out[:, :, 1]).reshape(5, T * 64)[:, :zm]
        ref = x @ (er.astype(np.float64) + 1j * ei.astype(np.float64))[:, :zm]
        np.testing.assert_allclose(got, ref, atol=1e-9 * np.abs(ref).max())


def _unsplit_z(tab):
    """the f64 sum of the parts (axis 2) of a z table"""
    return sum(_value(tab[:, :, h]).astype(np.float64)
               for h in range(tab.shape[2]))


def _z_inv_pair(case):
    """(A, B) of a z inverse: the dense irfft pair at Zh (row 4, row 13's
    half CT), the ct2 stored-order pair at n2 = 512, the z-CT at 1024"""
    kind, n = case
    if kind == 'dense':
        return fm._irfft_mats_np(n, n // 2 + 1,
                                 grad_kvec=np.sin(np.fft.rfftfreq(n)))
    return fm._z_inv_tabs(n, n // 2)


@pytest.mark.parametrize("case", [('dense', 75), ('dense', 384),
                                  ('dense', 512), ('ct2', 512),
                                  ('ct2', 1024)])
@pytest.mark.parametrize("parts", [3, 1])
def test_z_inv_block_table_layout(case, parts):
    """the z inverse's real-output table: chunk j, tile t, slice s, part
    h, row c (output column t * 128 + c), column kk (data k = 8 s + kk
    mod 8, real part for kk < 8) holds part h of bf16_split3 of the
    stacked [A; B] (the z-CT: P = [A_j; B_j] in columns [0, Kb), Q = [-B_j;
    A_j] in [Kb, 2 Kb)), zero past K and the width; its GEMM over the
    tiles gives yr A + yi B"""
    a, b = (np.asarray(t, np.float32) for t in _z_inv_pair(case))
    if a.ndim == 2:
        a, b = a[None], b[None]
        cols = np.stack([a, b], 1)               # chunk, in part, k, col
    else:
        cols = np.concatenate([np.stack([a, b], 1), np.stack([-b, a], 1)],
                              -1)
    R, _, K, width = cols.shape
    T, nks = -(-width // 128), -(-K // 8)
    tab = fk.z_inv_block_table(*_z_inv_pair(case), parts=parts)
    assert tab.shape == (R, T, nks, parts, 128, 16)
    assert tab.dtype == np.uint16
    big = np.zeros((R, 2, nks * 8, T * 128), np.float32)
    big[:, :, :K, :width] = cols
    want = np.stack(fk.bf16_split3(big)[:parts], 0)   # h, j, in, k, col
    # j, t, s, h, c, (in, k8) -> h, j, in, (s, k8), (t, c)
    got = tab.reshape(R, T, nks, parts, 128, 2, 8).transpose(
        3, 0, 5, 2, 6, 1, 4).reshape(want.shape)
    np.testing.assert_array_equal(got, want)
    pad = np.ones(big.shape, bool)
    pad[:, :, :K, :width] = False
    assert not got[:, pad].any()
    if parts == 3:
        rng = np.random.RandomState(K)
        y = rng.normal(size=(5, R * K)) + 1j * rng.normal(size=(5, R * K))
        full = sum(_value(tab[:, :, :, h]).astype(np.float64)
                   for h in range(3))
        for j in range(R):
            yj = np.zeros((5, nks * 8), complex)
            yj[:, :K] = y[:, j * K:(j + 1) * K]
            d = np.concatenate([yj.real.reshape(5, nks, 8),
                                yj.imag.reshape(5, nks, 8)], 2)
            out = np.einsum('msk,tsck->mtc', d, full[j]).reshape(5, -1)
            yk = y[:, j * K:(j + 1) * K]
            ref = yk.real @ a[j] + yk.imag @ b[j]
            if R > 1:
                ref = np.concatenate([ref, yk.imag @ a[j] - yk.real @ b[j]],
                                     1)
            np.testing.assert_allclose(out[:, :width], ref,
                                       atol=1e-9 * np.abs(ref).max())


def _padded_layout(tab, big, parts):
    """tab (1, T, nks, parts, 128, 16) of a real-output table is
    bf16_split3 of ``big`` (in part, k, output) padded to (2, nks 8, T
    128), zero in the padding beyond ``used`` (the same shape, True where
    a matrix entry sits)"""
    _, T, nks = tab.shape[:3]
    assert tab.shape == (1, T, nks, parts, 128, 16)
    assert tab.dtype == np.uint16
    want = np.stack(fk.bf16_split3(big)[:parts], 0)   # h, in, k, out
    # t, s, h, c, (in, k8) -> h, in, (s, k8), (t, c)
    got = tab[0].reshape(T, nks, parts, 128, 2, 8).transpose(
        2, 4, 1, 5, 0, 3).reshape(want.shape)
    np.testing.assert_array_equal(got, want)
    return got


@pytest.mark.parametrize("n", [33, 75, 512])
@pytest.mark.parametrize("parts", [3, 1])
def test_z_full_block_table_layout(n, parts):
    """row 13's full z inverse: z_full_block_table of (A, B) = (Re Wz,
    -Im Wz) is bf16_split3 of the stacked [[A, -B]; [B, A]] (data k re |
    im down, 2 n output columns across: zr = xr A + xi B, then zi = xi A
    - xr B) padded to whole slices and 128-column tiles, zero in the
    padding"""
    A, B = ref._z_inv_full_np(n, _kvec(n))
    T, nks = -(-2 * n // 128), -(-n // 8)
    big = np.zeros((2, nks * 8, T * 128), np.float32)
    big[0, :n, :n], big[0, :n, n:2 * n] = A, -B
    big[1, :n, :n], big[1, :n, n:2 * n] = B, A
    got = _padded_layout(fk.z_full_block_table(A, B, parts), big, parts)
    pad = np.ones(big.shape, bool)
    pad[:, :n, :2 * n] = False
    assert not got[:, pad].any()


@pytest.mark.parametrize("n", [33, 75, 512])
@pytest.mark.parametrize("parts", [3, 1])
def test_y_real_block_table_layout(n, parts):
    """row 13's full inverse y stage: y_real_block_table of (Wr, Wi) is
    bf16_split3 of the rows [Wr | -Wi] (data row m re | im down, output
    q across) padded to whole slices and 128-row tiles, zero in the
    padding"""
    wr, wi = fm._dft_fold_np(n, _kvec(n))
    T, nks = -(-n // 128), -(-n // 8)
    big = np.zeros((2, nks * 8, T * 128), np.float32)
    big[0, :n, :n], big[1, :n, :n] = wr.T, -wi.T
    got = _padded_layout(fk.y_real_block_table(wr, wi, parts), big, parts)
    pad = np.ones(big.shape, bool)
    pad[:, :n, :n] = False
    assert not got[:, pad].any()


# --- the emulated split product through the plain passes -----------------------

def _bf16_parts(t):
    """the three bf16 parts of an f32 tensor, as f32 tensors, each
    rounded to nearest even (torch's bf16 rounding, the kernels')"""
    p1 = t.to(torch.bfloat16).float()
    r1 = t - p1
    p2 = r1.to(torch.bfloat16).float()
    return p1, p2, (r1 - p2).to(torch.bfloat16).float()


def split_mm(a, b):
    """a @ b as the kernels form it: both f32 operands in three bf16
    parts, the six products down to 2^-16 of the leading one (exact in
    f32 each), summed smallest first in f32"""
    A, B = _bf16_parts(a.float()), _bf16_parts(b.float())
    out = None
    for i, j in ((1, 1), (2, 0), (0, 2), (1, 0), (0, 1), (0, 0)):
        p = torch.matmul(A[i], B[j])
        out = p if out is None else out + p
    return out


@pytest.fixture
def split_products(monkeypatch):
    """the plain passes with the kernels' split product inside the f32
    forms of zy_fwd_ct2, xct_multi, zy_fwd_half, x_dense and the zy
    inverses, the passes that run it; every other product (the Nyquist
    plane's) stays the plain f32 one"""
    orig = fm._mm

    def split(plain):
        def run(*args, **kw):
            if inspect.signature(plain).bind(*args, **kw).arguments.get(
                    'bf16'):
                return plain(*args, **kw)
            monkeypatch.setattr(fm, '_mm', lambda a, b, bf16=False:
                                split_mm(a, b))
            try:
                return plain(*args, **kw)
            finally:
                monkeypatch.setattr(fm, '_mm', orig)
        return run
    monkeypatch.setattr(fm, 'zy_fwd_ct2_plain', split(fm.zy_fwd_ct2_plain))
    monkeypatch.setattr(fm, 'xct_multi_plain', split(fm.xct_multi_plain))
    monkeypatch.setattr(fm, 'zy_fwd_half_plain', split(fm.zy_fwd_half_plain))
    monkeypatch.setattr(fm, 'x_dense_plain', split(fm.x_dense_plain))
    for name in ('zy_inv_ct2_plain', 'zy_inv_ct2_dual_plain',
                 'zy_inv_half_plain'):
        monkeypatch.setattr(fm, name, split(getattr(fm, name)))


@pytest.mark.parametrize("shape", SHAPES)
def test_zy_fwd_split_matches_jax(shape, split_products):
    n0, N1, n2 = shape
    x = np.random.RandomState(n2 + N1).normal(size=(8, N1, n2)).astype('f4')
    x += 1.0   # a mean, as a density has
    wz = fm._z_fwd_tabs(n2, n2 // 2)
    wy = fm._ct_fwd_mats_np(N1)
    ref = jfm._zy_fwd_ct2_call(jnp.asarray(x), n2, n2 // 2, wz, wy, None)
    got = fm._zy_fwd_ct2_call(torch.from_numpy(x), n2, n2 // 2, wz, wy)
    for r, g in zip(ref, got):
        assert _rel(r, g) <= TOL_PASS


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("case", ['forward', 'inverse_dual_k2'])
def test_xct_multi_split_matches_jax(shape, case, split_products):
    N0, n1, n2 = shape
    W = min(n2 // 2, 8)
    rng = np.random.RandomState(N0 + W)
    pr, pi = (rng.normal(size=(N0, n1, W)).astype('f4') for _ in range(2))
    if case == 'forward':
        kw = dict(wx=fm._ct_fwd_mats_np(N0), scale=1.0 / N0)
    else:
        k2 = tuple(rng.uniform(0.0, 2.0, n).astype('f4')
                   for n in (N0, n1, W))
        for t in k2:
            t[0] = 0.0
        w = np.fft.fftfreq(N0) * 2 * np.pi
        kw = dict(wx=fm._ct_inv_mats_np(N0), scale=1.0, inverse=True,
                  wx2=fm._ct_inv_mats_np(N0, fold_kvec=tuple(np.sin(w))),
                  k2=k2)
    ref = jfm._xct_call_multi(jnp.asarray(pr), jnp.asarray(pi), kw['wx'],
                              kw['scale'], None,
                              inverse=kw.get('inverse', False),
                              wx2=kw.get('wx2'), k2=kw.get('k2'))
    got = fm._xct_call_multi(torch.from_numpy(pr), torch.from_numpy(pi),
                             **kw)
    assert len(got) == len(ref)
    for r, g in zip(ref, got):
        assert _rel(r, g) <= TOL_PASS


DENSE_SHAPES = [(16, 16, 16), (24, 20, 15)]


def _mean_one(shape):
    """1 + N(0, 1) on ``shape``: a mesh with a mean, as a density has"""
    return (1.0 + np.random.RandomState(sum(shape)).normal(size=shape)
            ).astype('f4')


@pytest.mark.parametrize("shape", DENSE_SHAPES)
def test_zy_fwd_half_split_matches_jax(shape, split_products):
    n0, N1, n2 = shape
    Zh = n2 // 2 + 1
    x = _mean_one(shape)
    wz, wy = fm._dft_half_np(n2, Zh), fm._dft_np(N1, -1)
    ref = jfm._zy_fwd_half_call(jnp.asarray(x), n2, Zh,
                                *map(jnp.asarray, wz + wy), None)
    got = fm._zy_fwd_dense_call(torch.from_numpy(x), wz, wy)
    assert len(got) == 2
    for r, g in zip(ref, got):
        assert _rel(r, g) <= TOL_PASS


@pytest.mark.parametrize("shape", DENSE_SHAPES)
@pytest.mark.parametrize("case", ['forward', 'inverse_dual_k2'])
def test_x_dense_split_matches_jax(shape, case, split_products):
    """the x pass on the zy spectrum of a mesh with a mean (forward), and
    on its x-transformed spectrum (the dual with 1/k^2, against two
    Pallas x passes of the input filtered the JAX package's way)"""
    N0, N1, n2 = shape
    Zh = n2 // 2 + 1
    wf = fm._dft_np(N0, -1)
    spec = jfm._zy_fwd_half_call(
        jnp.asarray(_mean_one(shape)), n2, Zh,
        *map(jnp.asarray, fm._dft_half_np(n2, Zh) + fm._dft_np(N1, -1)),
        None)

    def jax_pass(w, scale, a, b):
        return jfm._xpass_half_call(a, b, *map(jnp.asarray, w), scale, None)

    scale = 1.0 / (N0 * N1 * n2)
    if case == 'forward':
        ref = jax_pass(wf, scale, *spec)
        got = fm._x_dense_call(*(torch.from_numpy(np.array(a))
                                 for a in spec), wf, scale)
    else:
        jr, ji = jax_pass(wf, scale, *spec)
        rng = np.random.RandomState(5)
        k2 = [rng.uniform(0.0, 2.0, n).astype('f4') for n in (N0, N1, Zh)]
        for t in k2:
            t[0] = 0.0
        kk = (jnp.asarray(k2[0])[:, None, None]
              + jnp.asarray(k2[1])[None, :, None]
              + jnp.asarray(k2[2])[None, None, :])
        invk2 = jnp.where(kk > 0, 1.0 / jnp.where(kk > 0, kk, 1.0), 0.0)
        wi = fm._dft_np(N0, +1)
        wg = fm._dft_fold_np(N0, tuple(np.sin(np.fft.fftfreq(N0) * 2 *
                                              np.pi)))
        ref = (jax_pass(wi, 1.0, jr * invk2, ji * invk2)
               + jax_pass(wg, 1.0, jr * invk2, ji * invk2))
        got = fm._x_dense_call(torch.from_numpy(np.array(jr)),
                               torch.from_numpy(np.array(ji)), wi, 1.0,
                               wx2=wg, k2=k2)
    assert len(got) == len(ref)
    for r, g in zip(ref, got):
        assert _rel(r, g) <= TOL_PASS


def test_force_split_matches_jax(split_products):
    shape = SHAPES[0]
    jpm = JaxPM(Nmesh=list(shape), BoxSize=np.asarray(shape, float),
                dtype='f4')
    tpm = convert.particlemesh_from(jpm.Nmesh, jpm.BoxSize, jpm.dtype,
                                    jpm.resampler, device='cpu')
    js, ts = jfastpm.Solver(jpm), tfastpm.Solver(tpm)
    rng = np.random.RandomState(3)
    disp = [rng.uniform(0, 1, shape).astype('f4') for _ in range(3)]
    ref = js.force_lattice(tuple(map(jnp.asarray, disp)), bounds=(0., 1.),
                           fft='xla')
    got = ts.force_lattice(tuple(map(torch.from_numpy, disp)),
                           bounds=(0., 1.), fft='mxu')
    for r, g in zip(ref, got):
        assert _rel(r, g) <= TOL_FORCE


def _filtered(shape, seed):
    """(re, im) of the x-inverted, 1/k^2-filtered half spectrum of a
    density 1 + N(0, 1) of ``shape`` with its Nyquist column (n2 // 2 + 1
    columns, natural order), f32: a force's zy-inverse input"""
    x = 1.0 + np.random.RandomState(seed).normal(size=shape)
    k = np.fft.rfftn(x) / x.size
    kk = sum((2 * np.pi * (np.fft.rfftfreq(n) if d == 2 else
                           np.fft.fftfreq(n))).reshape(
        [-1 if e == d else 1 for e in range(3)]) ** 2
        for d, n in enumerate(shape))
    k = np.where(kk > 0, k / np.where(kk > 0, kk, 1.0), 0.0)
    s = np.fft.ifft(k, axis=0) * shape[0]
    return s.real.astype('f4'), s.imag.astype('f4')


def _kvec(n, half=False):
    """a SuperLanczos-shaped table, zero at Nyquist"""
    w = (np.fft.rfftfreq(n) if half else np.fft.fftfreq(n)) * 2 * np.pi
    return tuple(((8 * np.sin(w) - np.sin(2 * w)) / 6.0).tolist())


@pytest.mark.parametrize("shape", SHAPES)
def test_zy_inv_split_matches_jax(shape, split_products):
    """the ct2 zy inverses on a filtered spectrum in stored y order (its
    z-Nyquist column as the plane, xy-inverted in the JAX package's
    force; here its real part stands for it): the single pass with the
    plane and the i k_y, i k_z folded tables, the dual with the plane on
    set A"""
    _, N1, n2 = shape
    Zm = n2 // 2
    sr, si = _filtered((8, N1, n2), N1 + n2)
    perm = fm._ct_permute(N1)
    rr, ii = (np.ascontiguousarray(np.take(t[:, :, :Zm], np.argsort(perm),
                                           axis=1)) for t in (sr, si))
    plane = np.ascontiguousarray(sr[:, :, Zm])
    Wy, Wyg = fm._ct_inv_mats_np(N1), fm._ct_inv_mats_np(N1,
                                                         fold_kvec=_kvec(N1))
    AB = fm._z_inv_tabs(n2, Zm)
    ABg = fm._z_inv_tabs(n2, Zm, grad_kvec=_kvec(n2, half=True))
    jr, ji, jp = (jnp.asarray(t) for t in (rr, ii, plane))
    tr, ti, tp = (torch.from_numpy(t) for t in (rr, ii, plane))
    ref = jfm._zy_inv_ct2_call(jr, ji, Wyg, ABg, n2, None, plane=jp)
    got = fm._zy_inv_ct2_call(tr, ti, Wyg, ABg, n2, plane=tp)
    assert _rel(ref, got) <= TOL_PASS
    ref = jfm._zy_inv_ct2_call_dual(jr, ji, Wyg, AB, Wy, ABg, n2, None,
                                    planeA=jp)
    got = fm._zy_inv_ct2_call_dual(tr, ti, Wyg, AB, Wy, ABg, n2, planeA=tp)
    assert len(got) == 2
    for r, g in zip(ref, got):
        assert _rel(r, g) <= TOL_PASS


@pytest.mark.parametrize("shape", DENSE_SHAPES)
@pytest.mark.parametrize("tables", ['ky', 'kz'])
def test_zy_inv_half_split_matches_jax(shape, tables, split_products):
    """the dense zy inverse on a filtered spectrum with its Nyquist
    column in place: the fy tables (k_y-folded y, plain z) and the fz
    tables (plain y, k_z-folded z)"""
    _, N1, n2 = shape
    Zh = n2 // 2 + 1
    rr, ii = _filtered(shape, sum(shape))
    wy, AB = fm._dft_np(N1, +1), fm._irfft_mats_np(n2, Zh)
    if tables == 'ky':
        wy = fm._dft_fold_np(N1, _kvec(N1))
    else:
        AB = fm._irfft_mats_np(n2, Zh, grad_kvec=_kvec(n2, half=True))
    ref = jfm._zy_inv_half_call(jnp.asarray(rr), jnp.asarray(ii), wy, AB, n2,
                                None)
    got = fm._zy_inv_dense_call(torch.from_numpy(rr), torch.from_numpy(ii),
                                wy, AB)
    assert _rel(ref, got) <= TOL_PASS


# --- row 13's zy passes as the kernels run them ---------------------------------

def emu_zy_inv_full(rr, ii, wy, AB):
    """zy_inv_full's f32 data path: the z stage as ONE split product of
    the rows [xr | xi] and the stacked [[A, -B]; [B, A]] (zr, then zi),
    the y stage as ONE split product of the rows [Wr | -Wi] and [zr;
    zi], per x-plane"""
    n0, N1, N2 = rr.shape
    A, B = (fm._t(a, rr) for a in AB)
    wr, wi = (fm._t(a, rr) for a in wy)
    z = split_mm(torch.cat([rr, ii], -1).reshape(n0 * N1, 2 * N2),
                 torch.cat([torch.cat([A, -B], 1), torch.cat([B, A], 1)], 0))
    z = z.reshape(n0, N1, 2 * N2)
    rows = torch.cat([wr, -wi], 1)
    return torch.stack([split_mm(rows, torch.cat([z[o, :, :N2],
                                                  z[o, :, N2:]], 0))
                        for o in range(n0)])


def emu_zy_fwd_half_ct(x, wz, wy):
    """zy_fwd_half_ct's f32 data path: the dense z stage with each row's
    first value taken out of the split products and added back through
    the table's column sums, the modes [0, 8) and those past the last
    whole 64-mode tile summed as plain sums them (split_rows' chains);
    then each y chunk's butterfly (the plain terms), its first element
    taken out and added back through the row sums, the chunk's complex
    product as one split product of the block table, column 0 as plain
    (ct_fwd_col0)"""
    p = x.float()
    er, ei = (fm._t(a, p) for a in wz)
    Zh = er.shape[1]
    zm = fk.z_tc_modes(Zh)
    c0 = p[..., :1]
    sums = fk.table_sums([wz], 0)[0]
    z = [split_mm(p - c0, e) + c0 * fm._t(sums[:, h], p)
         for h, e in enumerate((er, ei))]
    chained = list(range(min(8, zm))) + list(range(zm, Zh))
    for h, e in enumerate((er, ei)):
        z[h][..., chained] = torch.matmul(p, e[:, chained])
    wr, wi = (fm._t(a, p) for a in wy)
    R, M = wr.shape[:2]
    Bt = fm._butter(R, -1)
    rsum = fk.table_sums([wy], 2)[0]
    xs = [(z[0][..., r * M:(r + 1) * M, :], z[1][..., r * M:(r + 1) * M, :])
          for r in range(R)]
    outs = ([], [])
    for j in range(R):
        acc = (None, None)
        for r in range(R):
            acc = fm._cmadd(acc, xs[r][0], xs[r][1], Bt[r, j])
        ur, ui = acc
        cr, ci = ur[..., :1, :], ui[..., :1, :]
        u = torch.cat([ur - cr, ui - ci], -2)
        sr, si = (fm._t(rsum[j, :, h], p)[:, None] for h in (0, 1))
        outs[0].append(split_mm(torch.cat([wr[j], -wi[j]], 1), u)
                       + cr * sr - ci * si)
        outs[1].append(split_mm(torch.cat([wi[j], wr[j]], 1), u)
                       + cr * si + ci * sr)
    out = [torch.cat(o, -2) for o in outs]
    col0 = fm._ct_fwd_plain(z[0][..., :1], z[1][..., :1], wr, wi)
    for o, c in zip(out, col0):
        o[..., :1] = c
    return tuple(out)


@pytest.fixture
def row13_kernel_path(monkeypatch, split_products):
    """the plain row-13 zy passes with the kernels' f32 data path in
    their f32 form (and the x passes' split products)"""
    inv, fwd = ref.zy_inv_full_plain, ref.zy_fwd_half_ct_plain

    def zy_inv_full(rr, ii, wy, AB, bf16=False):
        if bf16:
            return inv(rr, ii, wy, AB, bf16)
        return emu_zy_inv_full(rr.float(), ii.float(), wy, AB)

    def zy_fwd_half_ct(x, wz, wy, bf16=False):
        if bf16:
            return fwd(x, wz, wy, bf16)
        return emu_zy_fwd_half_ct(x, wz, wy)
    monkeypatch.setattr(ref, 'zy_inv_full_plain', zy_inv_full)
    monkeypatch.setattr(ref, 'zy_fwd_half_ct_plain', zy_fwd_half_ct)


@pytest.mark.parametrize("shape", [(8, 32, 32), (6, 10, 14)])
def test_zy_inv_full_kernel_path_matches_jax(shape, row13_kernel_path):
    """the full-spectrum inverses (grad None and 2, the force triple) of
    the spectrum of a mesh with a mean, through the emulated z and y
    products"""
    x = _mean_one(shape)
    jr, ji = jref.fft3_real_forward(jnp.asarray(x))
    tr, ti = (torch.from_numpy(np.array(a)) for a in (jr, ji))
    kv = tuple(_kvec(n) for n in shape)
    for grad in (None, 2):
        kw = {} if grad is None else dict(grad=grad, kvec=kv[grad])
        assert _rel(jref.fft3_real_inverse(jr, ji, **kw),
                    ref.fft3_real_inverse(tr, ti, **kw)) <= TOL_PASS
    want = jref.fft3_real_inverse_grad3(jr, ji, kvecs=kv)
    got = ref.fft3_real_inverse_grad3(tr, ti, kvecs=kv)
    for w, g in zip(want, got):
        assert _rel(w, g) <= TOL_PASS


def _jax_zy_fwd_half_ct(x):
    """the JAX package's half-CT pass-1 kernel (_zy_forward_real_h_ct)
    in interpret mode, wired as fft3_real_forward_half_ct wires it, 2
    x-planes a block"""
    n0, N1, N2 = x.shape
    Zh = N2 // 2 + 1
    Ry, My = fm._ct_factor(N1)
    tabs = fm._dft_half_np(N2, Zh) + fm._ct_fwd_mats_np(N1)
    out = jax.ShapeDtypeStruct((n0, N1, Zh), jnp.float32)
    return pl.pallas_call(
        jref._zy_forward_real_h_ct(2, N1, N2, Zh, None), grid=(n0 // 2,),
        in_specs=[jref._xplane_spec(N1, N2, 2), jref._full_spec((N2, Zh)),
                  jref._full_spec((N2, Zh)), jref._full_spec((Ry, My, My)),
                  jref._full_spec((Ry, My, My))],
        out_specs=(jref._xplane_spec(N1, Zh, 2),) * 2,
        out_shape=(out, out), compiler_params=jref._params(),
        interpret=jref._interpret())(jnp.asarray(x),
                                     *map(jnp.asarray, tabs))


def test_zy_fwd_half_ct_kernel_path_matches_jax(row13_kernel_path):
    """the half-CT pass 1 through the emulated z and y stages: alone, on
    a mesh with a mean at the slab's zy extents (8, 256, 16), against the
    JAX kernel; and the first-CT forward of N(0, 1) at (256, 256, 16) (R
    = 2 along x and y) against fft3_real_forward_half_ct.  (With a mean,
    the port's plain f32 forward itself is 3.5e-5 of max from JAX's at
    the x pass's kx line of the mean's column, a sum the kernels chain as
    the port's plain version does.)"""
    x = _mean_one((8, 256, 16))
    got = ref._zy_fwd_half_ct_call(torch.from_numpy(x),
                                   fm._dft_half_np(16, 9),
                                   fm._ct_fwd_mats_np(256))
    for w, g in zip(_jax_zy_fwd_half_ct(x), got):
        assert _rel(w, g) <= TOL_PASS
    shape = (256, 256, 16)
    key = 'bx:%dx%dx%d' % (shape[0], shape[1], shape[2] // 2 + 1)
    jfm.TUNE[key] = 2
    try:
        x = np.random.RandomState(2).normal(size=shape).astype('f4')
        want = jref.fft3_real_forward_half_ct(jnp.asarray(x))
    finally:
        jfm.TUNE.pop(key, None)
    got = ref.fft3_real_forward_half_ct(torch.from_numpy(x))
    for w, g in zip(want, got):
        assert _rel(w, g) <= TOL_PASS
