"""CPU evidence for the bf16-product forms of the ct2 DFT passes and the
dense zy inverse (fft='mxu_bf16'): zy_fwd_ct2 and xct_multi on tc_gemm,
fed by split passes that fold the Cooley-Tukey butterfly
(csrc/fft_mxu.cu, split_ct, split_zct, split_cols, tc_gemm), and the zy
inverses zy_inv_ct2, zy_inv_ct2_dual and zy_inv_half, whose real-output
z stage reads split_zinv's tiles (the inverse y butterfly fused in).

- the one-part block tables: ct_block_table(sets, 1) at R = 2, 4, 8
  (N = 256, 512, 1024; one and two sets) is the bf16 rounding of the
  block matrices [[Wr, -Wi], [Wi, Wr]] (the first part of the f32
  forms' three-part table); zct_block_table at Rz = 2, 4, 8 (N2 = 256,
  1024, 512) is the bf16 rounding of each stored chunk's block matrix,
  the real chunks u_0 and u_{Rz/2} on 16 k per slice, the conjugate
  chunks with their imaginary data rows negated, and its GEMM gives
  u_j E_p;
- a plain-torch emulation of the kernels' data path, kept in this file
  (not a mode of the package): the split passes' butterflies, term by
  term in the kernels' order from the f32 coefficients, rounded once to
  bf16 into the data tiles (the 32-byte swizzle and all), times the
  swizzled one-part tables, chunk by chunk as tc_gemm's blocks run them.
  Its butterflies are bitwise the plain passes' (_ct_fwd_plain,
  _zct_fwd_plain at bf16=True) and its outputs equal theirs up to the
  f32 sum order;
- that emulation patched into the plain passes, against the JAX
  package's _xct_call_multi (forward and the folded dual inverse) and
  _zy_fwd_ct2_call at Precision('default') under the tpu_rounding patch
  of tests/test_torch_fft_bf16.py (each operand rounded to bf16 as the
  MXU's single pass rounds it), by that file's criteria: max gap 5e-4
  of max, at least 99.9 % of the entries within 1e-5 of max, for each
  x pass, the slab's zy pass and the z-CT stage alone; a zy pass with a
  z-CT stage as a chain of two products (its y operand is the z output
  rounded again), by the chained criterion (max gap 1e-2 of max, rms gap
  0.15 of the bf16 rounding);
- the zy inverses' data path: the y products as above, the inverse
  butterfly as split_zinv forms it (ct_inv_butterfly's fmaf chain, each
  step rounded once: the two kernels' chains, read from
  csrc/fft_mxu.cu, are one chain, and the fused butterfly is bitwise
  the sweep's emulated terms), the y output rounded once into
  split_zinv's tiles (slices of 8 complex k, re | im, swizzled) times
  the one-part z_inv_block_table, one real product per row as tc_gemm's
  real-output blocks run it: the z stage equal to the plain
  yr A + yi B (bf16) up to the f32 sum order, and the path patched into
  the plain zy_inv_ct2 (with the Nyquist plane), its dual and
  zy_inv_half against the JAX package's kernels at Precision('default')
  on 1/k^2-filtered spectra, a chain of two rounded products, by the
  chained criterion;
- row 13's two zy passes as the kernels run them in the bf16 form:
  zy_inv_full's z stage as one real product of split_zinv's rounded
  [xr | xi] tiles and the one-part stacked table (z_full_block_table),
  its z output rounded once into split_cols' tiles times the one-part
  rows [Wr | -Wi] (y_real_block_table), 128 real outputs per table
  tile; zy_fwd_half_ct's z stage on rounded operands, then the y CT as
  above; patched into zy_inv_full_plain and zy_fwd_half_ct_plain, the
  entry points fft3_real_inverse (grad 2), fft3_real_inverse_grad3 at
  (8, 16, 32) and fft3_real_forward_half_ct at the slab against the JAX
  package's at Precision('default') under tpu_rounding, by the chained
  criterion.

The tensor cores' own sum order is the card's part (tests/test_torch_
cuda.py, chip_smoke.py).
"""
import pathlib
import re

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pmesh_tpu.ops import fft_mxu as jfm
from pmesh_tpu.ops import fft_mxu_ref as jref
from pmesh_tpu_torch.ops import fft_mxu as fm
from pmesh_tpu_torch.ops import fft_mxu_cuda as fk
from pmesh_tpu_torch.ops import fft_mxu_ref as ref

torch.set_num_threads(1)

TOL_MAX, TOL_NEAR, NEAR_SHARE = 5e-4, 1e-5, 1e-3
TOL_ORDER = 2e-6      # the same bf16 products summed in another f32 order
TOL_CHAIN_MAX, TOL_CHAIN_RMS = 1e-2, 0.15
DEFAULT = jax.lax.Precision('default')
SLAB = (256, 256, 16)
ZCT = (2, 256, 512)


@pytest.fixture(scope="module")
def tpu_rounding():
    """the JAX package's products at Precision('default') rounded as the
    MXU's single pass rounds them (tests/test_torch_fft_bf16.py's patch)"""
    orig_fm, orig_ref = jfm._mm, jref._mm

    def mm(a, b, prec=None):
        if prec == DEFAULT:
            return jnp.dot(a.astype(jnp.bfloat16), b.astype(jnp.bfloat16),
                           preferred_element_type=jnp.float32)
        return orig_fm(a, b, prec)
    jax.clear_caches()
    jfm._mm = jref._mm = mm
    try:
        yield
    finally:
        jfm._mm, jref._mm = orig_fm, orig_ref
        jax.clear_caches()


def _value(bits):
    return (np.asarray(bits).astype(np.uint32) << 16).view(np.float32)


def _rb(t):
    return t.to(torch.bfloat16).float()


def _rel(ref, got):
    ref, got = (np.asarray(a, np.float32) if not isinstance(a, torch.Tensor)
                else a.float().numpy() for a in (ref, got))
    assert ref.shape == got.shape
    return np.abs(ref - got).max() / np.abs(ref).max()


def _close(want, got):
    """tests/test_torch_fft_bf16.py's criterion of one mxu_bf16 output"""
    want = np.asarray(want, np.float32)
    got = got.float().numpy()
    assert want.shape == got.shape
    d = np.abs(want - got)
    s = np.abs(want).max()
    assert d.max() <= TOL_MAX * s, d.max() / s
    assert (d > TOL_NEAR * s).mean() <= NEAR_SHARE


# --- the one-part tables --------------------------------------------------------

@pytest.mark.parametrize("n", [256, 512, 1024])
@pytest.mark.parametrize("sets", [1, 2])
def test_ct_block_table_one_part(n, sets):
    """ct_block_table(sets, 1): (R, sets T1, nks, 1, 128, 16), the bf16
    rounding of [[Wr, -Wi], [Wi, Wr]] of each chunk and set, and the
    first part of the three-part table"""
    kv = tuple(np.sin(np.fft.fftfreq(n) * 2 * np.pi))
    pairs = [fm._ct_fwd_mats_np(n), fm._ct_inv_mats_np(n, fold_kvec=kv)]
    pairs = pairs[:sets]
    R, M = fm._ct_factor(n)
    T1, nks = M // 64, M // 8
    one = fk.ct_block_table(pairs, 1)
    assert one.shape == (R, sets * T1, nks, 1, 128, 16)
    assert one.dtype == np.uint16
    np.testing.assert_array_equal(one, fk.ct_block_table(pairs)[:, :, :, :1])
    for k, (wr, wi) in enumerate(pairs):
        big = np.zeros((R, 2, M, 2, M), np.float32)  # j, out, q, in, m
        big[:, 0, :, 0], big[:, 0, :, 1] = wr, -wi
        big[:, 1, :, 0], big[:, 1, :, 1] = wi, wr
        got = one[:, k * T1:(k + 1) * T1, :, 0].reshape(
            R, T1, nks, 2, 64, 2, 8).transpose(0, 3, 1, 4, 5, 2, 6)
        np.testing.assert_array_equal(got.reshape(big.shape),
                                      fk.bf16_split3(big)[0])
    sw = fk.tile_swizzle(one)
    np.testing.assert_array_equal(fk.tile_swizzle(sw), one)


@pytest.mark.parametrize("n2", [256, 512, 1024])
def test_zct_block_table(n2):
    """zct_block_table: the stored chunks' tiles in turn, T = Mq / 64
    tiles of K / 16 slices (u_0, u_{Rz/2}: real) or K / 8 (complex), each
    entry the bf16 rounding of the chunk's block matrix, the conjugate
    chunks' imaginary data rows negated; its GEMM gives u_j E_p"""
    er, ei = fm._zct_fwd_mats_np(n2)
    Rz, K, Mq = fm._zct_factor(n2)
    T = Mq // 64
    tab = fk.zct_block_table(er, ei)
    order = fm._zct_order(Rz)
    real = [j in (0, Rz // 2) for j in order]
    nks = [K // 16 if r else K // 8 for r in real]
    assert tab.shape == (T * sum(nks), 1, 128, 16) and tab.dtype == np.uint16
    vals = _value(tab[:, 0]).astype(np.float64)
    rng = np.random.RandomState(n2)
    x = rng.normal(size=(3, n2))
    Bt = fm._butter(Rz, -1)
    u = np.einsum('mrk,rj->jmk', x.reshape(3, Rz, K), Bt)   # u_j, every j
    at = 0
    for p, j in enumerate(order):
        nk = nks[p]
        t = vals[at:at + T * nk].reshape(T, nk, 128, 16)
        at += T * nk
        sign = -1.0 if j > Rz // 2 else 1.0
        if real[p]:
            want = np.zeros((K, 2, T * 64), np.float32)   # k, out, mode
            want[:, 0, :Mq], want[:, 1, :Mq] = er[p], ei[p]
            got = t.reshape(T, nk, 2, 64, 16).transpose(1, 4, 2, 0, 3)
            d = np.einsum('mrk,r->mk', x.reshape(3, Rz, K),
                          np.real(Bt[:, j]))                # real u_j
            out = np.einsum('mk,kcq->mcq', d, got.reshape(K, 2, T * 64))
        else:
            want = np.zeros((2, K, 2, T * 64), np.float32)  # in, k, out, mode
            want[0, :, 0, :Mq], want[1, :, 0, :Mq] = er[p], -sign * ei[p]
            want[0, :, 1, :Mq], want[1, :, 1, :Mq] = ei[p], sign * er[p]
            got = t.reshape(T, nk, 2, 64, 2, 8).transpose(4, 1, 5, 2, 0, 3)
            ud = u[j if j <= Rz // 2 else Rz - j]    # the data is u_d
            d = np.stack([ud.real, ud.imag], 1)      # m, in, k
            out = np.einsum('mik,ikcq->mcq', d,
                            got.reshape(2, K, 2, T * 64))
        np.testing.assert_array_equal(got.reshape(want.shape),
                                      _value(fk.bf16_split3(want)[0]))
        ref = u[j] @ (er[p].astype(np.float64) + 1j * ei[p])
        np.testing.assert_allclose(out[:, 0, :Mq] + 1j * out[:, 1, :Mq],
                                   ref, atol=1e-2 * np.abs(ref).max())


# --- the emulated data path --------------------------------------------------------

def bterm(b, coef, a):
    """b + coef a as the split passes add a butterfly term: coef an f32
    constant, skipped below 1e-30, +-1 exact, else one f32 product; b
    None: the term alone"""
    coef = float(coef)
    if abs(coef) < 1e-30:
        return b
    t = a if coef == 1.0 else (-a if coef == -1.0 else a * coef)
    return t if b is None else b + t


def swizzle(t):
    """the 32-byte swizzle of (..., 128, 16) tiles (an involution): row
    r's two 8-value halves swapped where bit 2 of r is set"""
    rows = (torch.arange(t.shape[-2]) >> 2) & 1 == 1
    out = t.clone()
    out[..., rows, :] = torch.cat([t[..., rows, 8:], t[..., rows, :8]], -1)
    return out


def table(bits):
    """a host table (uint16 bits, parts axis of one) as swizzled f32"""
    return torch.from_numpy(_value(fk.tile_swizzle(bits)))


def split_ct(xr, xi, R):
    """split_ct's data tiles of (n, C) columns: u_j of every chunk j from
    the kernels' f32 coefficients, rounded to bf16, as (tiles, R nks,
    128, 16) swizzled: chunk j's slice s at j nks + s, row c % 128, re of
    rows 8 s .. 8 s + 7 | im.  Returns (tiles, u) with u[j] = (ur, ui)"""
    c = fk._coef('fwd', R)
    M, C = xr.shape[0] // R, xr.shape[1]
    xs = [(xr[r * M:(r + 1) * M], xi[r * M:(r + 1) * M]) for r in range(R)]
    us = []
    for j in range(R):
        ur = ui = None
        for r in range(R):
            cr, ci = c[r, j]
            ur = bterm(bterm(ur, cr, xs[r][0]), -ci, xs[r][1])
            ui = bterm(bterm(ui, ci, xs[r][0]), cr, xs[r][1])
        us.append((_rb(ur), _rb(ui)))
    return _col_tiles([u for u in us], M, C), us


def _col_tiles(us, M, C):
    """(ur, ui) (M, C) per chunk -> (tiles, chunks nks, 128, 16)"""
    tiles, nks = -(-C // 128), M // 8
    pad = tiles * 128 - C
    parts = []
    for ur, ui in us:
        a = torch.stack([torch.nn.functional.pad(ur, (0, pad)),
                         torch.nn.functional.pad(ui, (0, pad))])
        # part, s, m8, tile, row -> tile, s, row, part, m8
        parts.append(a.reshape(2, nks, 8, tiles, 128).permute(3, 1, 4, 0, 2)
                     .reshape(tiles, nks, 128, 16))
    return swizzle(torch.cat(parts, 1))


def tc_gemm_cols(tab, dat, R, M, C):
    """tc_gemm over chunks, data the column operand: tab (R, T, nks, 128,
    16) and dat (tiles, R nks, 128, 16), both swizzled; block (t, j, dt)
    sums its slices' products in f32; rows [0, 64) of a table tile are
    the real parts of its modes.  Returns (out_r, out_i) (R M, C) of one
    table set"""
    T, nks = tab.shape[1], tab.shape[2]
    a, d = swizzle(tab), swizzle(dat)
    d = d.reshape(d.shape[0], R, nks, 128, 16)
    out = torch.einsum('jtsak,xjsbk->jtaxb', a, d)       # j, t, row, dt, col
    out = out.reshape(R, T, 2, 64, -1)[..., :C]
    out = out.permute(2, 0, 1, 3, 4).reshape(2, R * T * 64, C)
    return out[0], out[1]


def emu_ct_fwd(xr, xi, wr, wi):
    """the forward CT of (..., n, C) as the kernels run it (bf16)"""
    R, M = wr.shape[0], wr.shape[1]
    lead, (n, C) = xr.shape[:-2], xr.shape[-2:]
    flat = [t.reshape(-1, n, C).permute(1, 0, 2).reshape(n, -1)
            for t in (xr, xi)]
    dat, _ = split_ct(*flat, R)
    tab = table(fk.ct_block_table([(wr.numpy(), wi.numpy())], 1))[:, :, :, 0]
    outs = tc_gemm_cols(tab, dat, R, M, flat[0].shape[1])
    return tuple(o.reshape(n, -1, C).permute(1, 0, 2).reshape(*lead, n, C)
                 for o in outs)


def emu_ct_inv_products(xr, xi, wr, wi):
    """the inverse CT's products y_j (chunk j at rows j M + m) of (n, C)
    as the kernels run them: the input rounded (split_cols, one part),
    times the chunks' tables"""
    R, M = wr.shape[0], wr.shape[1]
    C = xr.shape[1]
    dat = _col_tiles([(_rb(xr[j * M:(j + 1) * M]), _rb(xi[j * M:(j + 1) * M]))
                      for j in range(R)], M, C)
    tab = table(fk.ct_block_table([(wr.numpy(), wi.numpy())], 1))[:, :, :, 0]
    return tc_gemm_cols(tab, dat, R, M, C)


def emu_ct_inv(xr, xi, wr, wi):
    """the inverse CT of (n, C): the emulated products, then the plain
    butterfly"""
    R, M = wr.shape[0], wr.shape[1]
    yr, yi = emu_ct_inv_products(xr, xi, wr, wi)
    B = fm._butter(R, +1)
    outs_r, outs_i = [], []
    for r in range(R):
        acc = (None, None)
        for j in range(R):
            acc = fm._cmadd(acc, yr[j * M:(j + 1) * M], yi[j * M:(j + 1) * M],
                            B[r, j])
        outs_r.append(acc[0])
        outs_i.append(acc[1])
    return torch.cat(outs_r, 0), torch.cat(outs_i, 0)


def split_zct(p, Rz, K):
    """split_zct's data tiles of real rows p (rows, N2): u_d (d <= Rz/2)
    from the f32 coefficients, u_0 and u_{Rz/2} real (16 k per slice),
    the others complex (8 k per slice, re | im), rounded to bf16, as
    (tiles, nkd, 128, 16) swizzled.  Returns (tiles, slice offsets, u)"""
    c = fk._coef('fwd', Rz)
    rows = p.shape[0]
    tiles = -(-rows // 128)
    p = torch.nn.functional.pad(p, (0, 0, 0, tiles * 128 - rows))
    xs = [p[:, r * K:(r + 1) * K] for r in range(Rz)]
    blocks, offs, us, at = [], [], [], 0
    for d in range(Rz // 2 + 1):
        real = d in (0, Rz // 2)
        ur = ui = None
        for r in range(Rz):
            ur = bterm(ur, c[r, d, 0], xs[r])
            if not real:
                ui = bterm(ui, c[r, d, 1], xs[r])
        ur = _rb(ur)
        us.append((ur, None if real else _rb(ui)))
        if real:     # tile, row, s, kk -> tile, s, row, kk
            b = ur.reshape(tiles, 128, K // 16, 16).permute(0, 2, 1, 3)
        else:
            b = torch.stack([ur.reshape(-1, K // 8, 8),
                             _rb(ui).reshape(-1, K // 8, 8)], 2)
            # tile, row, s, part, k8 -> tile, s, row, part, k8
            b = b.reshape(tiles, 128, K // 8, 2, 8).permute(0, 2, 1, 3, 4)
            b = b.reshape(tiles, K // 8, 128, 16)
        offs.append(at)
        at += b.shape[1]
        blocks.append(b)
    return swizzle(torch.cat(blocks, 1)), offs, us


def emu_zct_fwd(p, Er, Ei, N2):
    """the z-CT forward of real (..., N2) as the kernels run it (bf16):
    stored chunk p = order[p] on its tiles of zct_block_table, data the
    row operand"""
    Rz, K, Mq = fm._zct_factor(N2)
    lead = p.shape[:-1]
    rows = p.reshape(-1, N2)
    dat, offs, _ = split_zct(rows, Rz, K)
    d = swizzle(dat)
    tab = swizzle(table(fk.zct_block_table(Er.numpy(), Ei.numpy()))[:, 0])
    T = Mq // 64
    outs, at = [], 0
    for pc, j in enumerate(fm._zct_order(Rz)):
        dd = j if j <= Rz // 2 else Rz - j
        nk = K // 16 if dd in (0, Rz // 2) else K // 8
        t = tab[at:at + T * nk].reshape(T, nk, 128, 16)
        at += T * nk
        o = torch.einsum('xsak,tsck->xatc', d[:, offs[dd]:offs[dd] + nk], t)
        outs.append(o.reshape(-1, T, 2, 64)[:rows.shape[0]])
    out = torch.stack(outs, 1)                 # row, p, t, part, mode
    out = out.permute(3, 0, 1, 2, 4).reshape(2, rows.shape[0], Rz * Mq)
    return tuple(o.reshape(*lead, Rz * Mq) for o in out)


# --- the emulation against the plain passes -------------------------------------

def _mean_one(shape, seed):
    return torch.from_numpy((1.0 + np.random.RandomState(seed).normal(
        size=shape)).astype('f4'))


@pytest.mark.parametrize("n", [256, 512, 1024])
def test_split_ct_butterflies_are_plain(n):
    """split_ct's butterflies, from the f32 coefficients term by term, are
    bitwise the plain forward's (_cmadd), rounded; the emulated products
    equal _ct_fwd_plain(bf16=True) up to the f32 sum order"""
    R, M = fm._ct_factor(n)
    xr, xi = _mean_one((n, 40), n), _mean_one((n, 40), n + 1)
    _, us = split_ct(xr, xi, R)
    B = fm._butter(R, -1)
    for j, (ur, ui) in enumerate(us):
        acc = (None, None)
        for r in range(R):
            acc = fm._cmadd(acc, xr[r * M:(r + 1) * M], xi[r * M:(r + 1) * M],
                            B[r, j])
        assert torch.equal(ur, _rb(acc[0])) and torch.equal(ui, _rb(acc[1]))
    wr, wi = (torch.from_numpy(a) for a in fm._ct_fwd_mats_np(n))
    ref = fm._ct_fwd_plain(xr, xi, wr, wi, bf16=True)
    for r, g in zip(ref, emu_ct_fwd(xr, xi, wr, wi)):
        assert _rel(r, g) <= TOL_ORDER


@pytest.mark.parametrize("n", [256, 512, 1024])
def test_ct_inv_products_are_plain(n):
    """the inverse's emulated products and the plain butterfly equal
    _ct_inv_plain(bf16=True) up to the f32 sum order"""
    xr, xi = _mean_one((n, 24), n + 2), _mean_one((n, 24), n + 3)
    wr, wi = (torch.from_numpy(a) for a in fm._ct_inv_mats_np(n))
    ref = fm._ct_inv_plain(xr, xi, wr, wi, bf16=True)
    for r, g in zip(ref, emu_ct_inv(xr, xi, wr, wi)):
        assert _rel(r, g) <= TOL_ORDER


@pytest.mark.parametrize("n2", [256, 512, 1024])
def test_split_zct_butterflies_are_plain(n2):
    """split_zct's u_d are bitwise the plain z-CT's (its real chunks'
    imaginary parts, 1e-16 of a term, left out), rounded; the emulated
    products equal _zct_fwd_plain(bf16=True) up to the f32 sum order"""
    Rz, K, Mq = fm._zct_factor(n2)
    p = _mean_one((200, n2), n2)
    _, _, us = split_zct(p, Rz, K)
    Bt = fm._butter(Rz, -1)
    for d, (ur, ui) in enumerate(us):
        acc = (None, None)
        for r in range(Rz):
            acc = fm._cmadd(acc, p[:, r * K:(r + 1) * K], None, Bt[r, d])
        assert torch.equal(ur[:200], _rb(acc[0]))
        if ui is not None:
            assert torch.equal(ui[:200], _rb(acc[1]))
        else:
            assert acc[1] is None or float(acc[1].abs().max()) < 1e-12
    Er, Ei = (torch.from_numpy(a) for a in fm._zct_fwd_mats_np(n2))
    ref = fm._zct_fwd_plain(p, Er, Ei, n2, bf16=True)
    for r, g in zip(ref, emu_zct_fwd(p, Er, Ei, n2)):
        assert _rel(r, g) <= TOL_ORDER


# --- the emulation in the plain passes, against the JAX package -----------------

@pytest.fixture
def kernel_path(monkeypatch):
    """the plain passes with the emulated data path in their bf16 CT
    products (the x / y forward and inverse, the z-CT forward)"""
    orig = {k: getattr(fm, k) for k in ('_ct_fwd_plain', '_ct_inv_plain',
                                        '_zct_fwd_plain')}

    def fwd(xr, xi, wr, wi, bf16=False):
        if not bf16:
            return orig['_ct_fwd_plain'](xr, xi, wr, wi, bf16)
        return emu_ct_fwd(xr, xi, wr, wi)

    def inv(xr, xi, wr, wi, bf16=False):
        if not bf16:
            return orig['_ct_inv_plain'](xr, xi, wr, wi, bf16)
        return emu_ct_inv(xr, xi, wr, wi)

    def zct(p, Er, Ei, N2, bf16=False):
        if not bf16:
            return orig['_zct_fwd_plain'](p, Er, Ei, N2, bf16)
        return emu_zct_fwd(p, Er, Ei, N2)
    monkeypatch.setattr(fm, '_ct_fwd_plain', fwd)
    monkeypatch.setattr(fm, '_ct_inv_plain', inv)
    monkeypatch.setattr(fm, '_zct_fwd_plain', zct)


@pytest.mark.parametrize("case", ['forward', 'inverse_dual_k2'])
def test_xct_kernel_path_matches_jax(case, kernel_path, tpu_rounding):
    N0, n1, W = SLAB[0], SLAB[1], 8
    rng = np.random.RandomState(N0 + W)
    pr, pi = (rng.normal(size=(N0, n1, W)).astype('f4') for _ in range(2))
    pr[0] += 4.0
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
                              kw['scale'], DEFAULT,
                              inverse=kw.get('inverse', False),
                              wx2=kw.get('wx2'), k2=kw.get('k2'))
    got = fm._xct_call_multi(torch.from_numpy(pr), torch.from_numpy(pi),
                             precision='bf16', **kw)
    assert len(got) == len(ref)
    for r, g in zip(ref, got):
        _close(r, g)


def test_zy_fwd_kernel_path_matches_jax(kernel_path, tpu_rounding):
    """the slab's planes (the dense z stage, PR 9's one-part z, then the y
    CT): the pass by the per-pass criterion"""
    shape = (8,) + SLAB[1:]
    n0, N1, n2 = shape
    x = _mean_one(shape, n2 + N1).numpy()
    wz = fm._z_fwd_tabs(n2, n2 // 2)
    wy = fm._ct_fwd_mats_np(N1)
    ref = jfm._zy_fwd_ct2_call(jnp.asarray(x), n2, n2 // 2, wz, wy, DEFAULT)
    got = fm._zy_fwd_ct2_call(torch.from_numpy(x), n2, n2 // 2, wz, wy,
                              precision='bf16')
    for r, g in zip(ref[:2], got[:2]):
        _close(r, g)
    assert _rel(ref[2], got[2]) <= 1e-6


def test_zy_fwd_zct_kernel_path_matches_jax(kernel_path, tpu_rounding):
    """a z-CT shape (Rz = 4): the z stage alone by the per-pass criterion
    against the JAX package's z-CT (_zct_fwd_apply); the pass, whose y
    stage reads the z outputs rounded to bf16 again, as a chain: where
    JAX's and the port's f32 z sums straddle a rounding midpoint the y
    operand flips by one bf16 ulp and moves its whole y column by about
    1e-5 of max, so the pass is held to tests/test_torch_fft_bf16.py's
    chained criterion (max gap 1e-2 of max, rms gap 0.15 of the rms of
    the bf16 rounding itself)"""
    n0, N1, n2 = ZCT
    Zm = n2 // 2
    x = _mean_one(ZCT, n2 + N1).numpy()
    wz = fm._z_fwd_tabs(n2, Zm)
    wy = fm._ct_fwd_mats_np(N1)
    rows = x.reshape(-1, n2)
    want = jfm._zct_fwd_apply(jnp.asarray(rows), *map(jnp.asarray, wz), n2,
                              DEFAULT)
    got = emu_zct_fwd(torch.from_numpy(rows), *map(torch.from_numpy, wz), n2)
    for w, g in zip(want, got):
        _close(w, g)
    ref = jfm._zy_fwd_ct2_call(jnp.asarray(x), n2, Zm, wz, wy, DEFAULT)
    got = fm._zy_fwd_ct2_call(torch.from_numpy(x), n2, Zm, wz, wy,
                              precision='bf16')
    f32 = fm._zy_fwd_ct2_call(torch.from_numpy(x), n2, Zm, wz, wy)
    scale = max(np.abs(np.asarray(r)).max() for r in ref[:2])
    for r, g, f in zip(ref[:2], got[:2], f32[:2]):
        r, g, f = np.asarray(r), g.numpy(), f.numpy()
        assert np.abs(r - g).max() <= TOL_CHAIN_MAX * scale
        assert (np.sqrt(((r - g) ** 2).mean() / ((r - f) ** 2).mean())
                <= TOL_CHAIN_RMS)
    assert _rel(ref[2], got[2]) <= 1e-6


# --- the zy inverses: fused butterfly, real-output z stage ----------------------

def fma32(a, b, c):
    """fmaf on f32 tensors (a, c may be python floats), rounded once: the
    exact f64 product a b plus c, rounded to odd in f64 (TwoSum's error
    as the sticky bit), then to f32"""
    def d(t):
        return (t.double() if isinstance(t, torch.Tensor) else
                torch.tensor(float(t), dtype=torch.float64))
    p, c = d(a) * d(b), d(c)
    s = p + c
    bb = s - p
    e = (p - (s - bb)) + (c - bb)
    even = (s.view(torch.int64) & 1) == 0
    s = torch.where((e != 0) & even,
                    torch.nextafter(s, torch.where(e > 0, np.inf, -np.inf)
                                    .double()), s)
    return s.float()


# the inverse butterfly's fmaf chain, as split_zinv and ct_inv_butterfly
# write it in csrc/fft_mxu.cu (names normalised by _fmaf_chain)
FMAF_CHAIN = ["cr = bt.r[r][j], ci = bt.i[r][j];",
              "sr = fmaf(cr, yr, fmaf(-ci, yi, sr));",
              "si = fmaf(cr, yi, fmaf(ci, yr, si));"]


def _fmaf_chain(kernel):
    """the coefficient load and the fmaf lines of ``kernel``'s body in
    csrc/fft_mxu.cu: split_zinv's v[q] / v[8 + q] read as sr / si, its
    p.bt as bt, the [q] / [j] subscripts of the data dropped"""
    src = (pathlib.Path(fk.__file__).parent.parent / 'csrc' /
           'fft_mxu.cu').read_text()
    body = re.search(r'__global__ void[^{;]*?\b%s\(.*?\n}\n' % kernel, src,
                     re.S).group(0)
    lines = [ln.strip() for ln in body.splitlines()
             if 'fmaf(' in ln or 'bt.r[r][j]' in ln]
    norm = []
    for ln in lines:
        ln = ln.replace('const float ', '').replace('p.bt.', 'bt.')
        ln = ln.replace('v[8 + q]', 'si').replace('v[q]', 'sr')
        norm.append(re.sub(r'(yr|yi)\[[qj]\]', r'\1', ln))
    return norm


def fused_butterfly(ys):
    """the inverse butterfly out_r = sum_j b[r][j] y_j of the chunks' y_j
    = (yr, yi), as split_zinv forms it (FMAF_CHAIN): its 16 values v
    from 0, re and im each an fmaf chain over j from the f32 constants of
    W_R^{+rj}, stored unscaled into the tiles"""
    R = len(ys)
    c = fk._coef('inv', R)
    outs = []
    for r in range(R):
        sr = si = torch.zeros_like(ys[0][0])
        for j, (yr, yi) in enumerate(ys):
            cr, ci = float(c[r, j, 0]), float(c[r, j, 1])
            sr = fma32(cr, yr, fma32(-ci, yi, sr))
            si = fma32(cr, yi, fma32(ci, yr, si))
        outs.append((sr, si))
    return outs


def sweep_butterfly(ys, scale=1.0):
    """ct_inv_butterfly's terms (FMAF_CHAIN), one element per thread:
    the R values y_j (re, im) loaded, sr and si from 0.f, then stored as
    sr * scale, si * scale (scale 1 in the zy inverse's y stage)"""
    R = len(ys)
    c = fk._coef('inv', R)
    yr = torch.stack([y[0] for y in ys])
    yi = torch.stack([y[1] for y in ys])
    outs = []
    for r in range(R):
        sr = torch.full_like(yr[0], 0.0)
        si = torch.full_like(yi[0], 0.0)
        for j in range(R):
            cr = torch.tensor(c[r, j, 0], dtype=torch.float32)
            ci = torch.tensor(c[r, j, 1], dtype=torch.float32)
            sr = fma32(cr, yr[j], fma32(-ci, yi[j], sr))
            si = fma32(cr, yi[j], fma32(ci, yr[j], si))
        outs.append((sr * scale, si * scale))
    return outs


def split_zinv(yr, yi):
    """split_zinv's one-part data tiles of (rows, Zm) y rows: (tiles, nks,
    128, 16) swizzled, row m's slice s the rounded re of k = 8 s .. 8 s +
    7 | im, zero past Zm and rows"""
    rows, Zm = yr.shape
    tiles, nks = -(-rows // 128), -(-Zm // 8)
    pad = [torch.nn.functional.pad(_rb(t), (0, nks * 8 - Zm,
                                            0, tiles * 128 - rows))
           for t in (yr, yi)]
    # part, tile, row, s, k8 -> tile, s, row, part, k8
    a = torch.stack(pad).reshape(2, tiles, 128, nks, 8).permute(1, 3, 2, 0, 4)
    return swizzle(a.reshape(tiles, nks, 128, 16))


def emu_z_inv(yr, yi, A, B):
    """the z inverse of (..., Zm) y rows by the (Zm, n2) pair (A, B) as
    the kernels run it (bf16): split_zinv's tiles times the swizzled
    one-part z_inv_block_table, 128 real columns per table tile, the
    slices' products summed in f32"""
    lead, Zm = yr.shape[:-1], yr.shape[-1]
    n2 = A.shape[-1]
    dat = swizzle(split_zinv(yr.reshape(-1, Zm), yi.reshape(-1, Zm)))
    tab = swizzle(table(fk.z_inv_block_table(A.numpy(), B.numpy(),
                                             parts=1))[0, :, :, 0])
    out = torch.einsum('xsrk,tsck->xrtc', dat, tab)
    rows = int(np.prod(lead))
    return out.reshape(-1, tab.shape[0] * 128)[:rows, :n2].reshape(*lead, n2)


def emu_zy_inv(xr, xi, Wy, AB, n2, plane):
    """the ct2 zy inverse (bf16) of (n0, N1, Zm) as the kernels run it:
    the y chunks' products (emu_ct_inv_products), the fused butterfly,
    the z stage (emu_z_inv), plus the plane (-1)^n in f32"""
    wr, wi = (torch.from_numpy(np.asarray(a, np.float32)) for a in Wy)
    R, M = wr.shape[:2]
    n0, N1, Zm = xr.shape
    cols = [t.permute(1, 0, 2).reshape(N1, n0 * Zm) for t in (xr, xi)]
    pr, pi = emu_ct_inv_products(*cols, wr, wi)
    outs = fused_butterfly([(pr[j * M:(j + 1) * M], pi[j * M:(j + 1) * M])
                            for j in range(R)])
    yr, yi = (torch.cat([o[h] for o in outs], 0).reshape(N1, n0, Zm)
              .permute(1, 0, 2) for h in (0, 1))
    out = emu_z_inv(yr, yi, *(torch.from_numpy(np.asarray(a, np.float32))
                              for a in AB))
    if plane is not None:
        out = out + plane.float()[:, :, None] * fm._signs(n2, out)
    return out


def _filtered(shape, seed):
    """(re, im) f32 of the x-inverted, 1/k^2-filtered half spectrum of a
    density 1 + N(0, 1) of ``shape``, natural order, its Nyquist column
    included"""
    x = 1.0 + np.random.RandomState(seed).normal(size=shape)
    k = np.fft.rfftn(x) / x.size
    kk = sum((2 * np.pi * (np.fft.rfftfreq(n) if d == 2 else
                           np.fft.fftfreq(n))).reshape(
        [-1 if e == d else 1 for e in range(3)]) ** 2
        for d, n in enumerate(shape))
    k = np.where(kk > 0, k / np.where(kk > 0, kk, 1.0), 0.0)
    s = np.fft.ifft(k, axis=0) * shape[0]
    return s.real.astype('f4'), s.imag.astype('f4')


def _sl(n, half=False):
    w = (np.fft.rfftfreq(n) if half else np.fft.fftfreq(n)) * 2 * np.pi
    return tuple(((8 * np.sin(w) - np.sin(2 * w)) / 6.0).tolist())


@pytest.mark.parametrize("n2,Zm", [(16, 8), (75, 38), (384, 193),
                                   (512, 256)])
def test_z_inv_tiles_are_plain(n2, Zm):
    """split_zinv's tiles times the one-part z_inv_block_table equal the
    plain bf16 z stage yr A + yi B up to the f32 sum order (the dense
    pairs at Zh = 38 and 193, the ct2 stored-order pairs at Zm = 8 and
    256)"""
    AB = (fm._z_inv_tabs(n2, Zm) if Zm == n2 // 2 else
          fm._irfft_mats_np(n2, Zm, grad_kvec=_sl(n2, half=True)))
    A, B = (torch.from_numpy(np.asarray(a, np.float32)) for a in AB)
    yr, yi = _mean_one((3, 70, Zm), n2), _mean_one((3, 70, Zm), n2 + 1)
    ref = fm._mm(yr, A, True) + fm._mm(yi, B, True)
    assert _rel(ref, emu_z_inv(yr, yi, A, B)) <= TOL_ORDER


def test_fma32_rounds_once():
    """fma32 is fmaf: a = 1 + 2^-12, a a + 2^-60 is above the f32 tie
    1 + 2^-11 + 2^-24 and rounds once to 1 + 2^-11 + 2^-23 (rounded to
    f64 first, it lands on the tie and goes to even, 1 + 2^-11); a a -
    (1 + 2^-11) is the product's exact tail 2^-24"""
    a = torch.tensor([1 + 2.0 ** -12], dtype=torch.float32)
    assert fma32(a, a, 2.0 ** -60).item() == 1 + 2.0 ** -11 + 2.0 ** -23
    assert ((a.double() * a.double() + 2.0 ** -60).float().item()
            == 1 + 2.0 ** -11)
    assert fma32(a, a, -(1 + 2.0 ** -11)).item() == 2.0 ** -24


def test_fused_butterfly_chain_is_the_sweeps():
    """split_zinv and ct_inv_butterfly in csrc/fft_mxu.cu run one fmaf
    chain, FMAF_CHAIN, the one fused_butterfly and sweep_butterfly
    emulate"""
    assert _fmaf_chain('split_zinv') == FMAF_CHAIN
    assert _fmaf_chain('ct_inv_butterfly') == FMAF_CHAIN


@pytest.mark.parametrize("n", [256, 512, 1024])
def test_fused_butterfly_is_the_sweep(n):
    """the fused butterfly of split_zinv on the emulated y products:
    bitwise ct_inv_butterfly's terms (sweep_butterfly at scale 1), the
    plain inverse butterfly (_cmadd, each term rounded) up to f32
    rounding, and _ct_inv_plain(bf16=True) to the f32 sum order"""
    xr, xi = _mean_one((n, 24), n + 4), _mean_one((n, 24), n + 5)
    wr, wi = (torch.from_numpy(a) for a in fm._ct_inv_mats_np(n))
    R, M = wr.shape[:2]
    pr, pi = emu_ct_inv_products(xr, xi, wr, wi)
    ys = [(pr[j * M:(j + 1) * M], pi[j * M:(j + 1) * M]) for j in range(R)]
    fused = fused_butterfly(ys)
    for f, w in zip(fused, sweep_butterfly(ys)):
        assert torch.equal(f[0], w[0]) and torch.equal(f[1], w[1])
    got = [torch.cat([o[h] for o in fused], 0) for h in (0, 1)]
    want = emu_ct_inv(xr, xi, wr, wi)
    for g, w in zip(got, want):
        assert _rel(w, g) <= 1e-6
    for g, w in zip(got, fm._ct_inv_plain(xr, xi, wr, wi, bf16=True)):
        assert _rel(w, g) <= TOL_ORDER


@pytest.fixture
def zy_inv_kernel_path(monkeypatch):
    """the plain zy inverses with the emulated data path in their bf16
    form: the ct2 passes' y stage, fused butterfly and z stage
    (emu_zy_inv), the dense pass's z stage (emu_z_inv after the plain
    dense y products, whose operands round as the kernel's do)"""
    one, half = fm._zy_inv_one, fm.zy_inv_half_plain

    def zy_inv_one(xr, xi, Wy, AB, n2, plane, bf16):
        if not bf16:
            return one(xr, xi, Wy, AB, n2, plane, bf16)
        return emu_zy_inv(xr, xi, Wy, AB, n2, plane)

    def zy_inv_half(rr, ii, wy, AB, bf16=False):
        if not bf16:
            return half(rr, ii, wy, AB, bf16)
        yr, yi = fm._dense_plain(rr.float(), ii.float(),
                                 *(fm._t(a, rr) for a in wy), bf16=True)
        return emu_z_inv(yr, yi, *(fm._t(a, rr) for a in AB))
    monkeypatch.setattr(fm, '_zy_inv_one', zy_inv_one)
    monkeypatch.setattr(fm, 'zy_inv_half_plain', zy_inv_half)


def _chain(ref, got, f32):
    """the chained criterion: max gap 1e-2 of max, rms gap within 0.15 of
    the rms of the bf16 rounding itself (the JAX kernel against the
    port's f32 pass)"""
    scale = max(np.abs(np.asarray(r)).max() for r in ref)
    for r, g, f in zip(ref, got, f32):
        r, g, f = np.asarray(r), g.numpy(), f.numpy()
        assert np.abs(r - g).max() <= TOL_CHAIN_MAX * scale
        assert (np.sqrt(((r - g) ** 2).mean() / ((r - f) ** 2).mean())
                <= TOL_CHAIN_RMS)


def test_zy_inv_kernel_path_matches_jax(zy_inv_kernel_path, tpu_rounding):
    """the ct2 zy inverses on the slab's filtered spectrum in stored y
    order (the z-Nyquist column's real part as the plane): the single
    pass with the plane and the folded tables, the dual with the plane on
    set A"""
    n0, N1, n2 = (8,) + SLAB[1:]
    Zm = n2 // 2
    sr, si = _filtered((n0, N1, n2), 7)
    order = np.argsort(fm._ct_permute(N1))
    rr, ii = (np.ascontiguousarray(t[:, order, :Zm]) for t in (sr, si))
    plane = np.ascontiguousarray(sr[:, :, Zm])
    Wy, Wyg = fm._ct_inv_mats_np(N1), fm._ct_inv_mats_np(N1,
                                                         fold_kvec=_sl(N1))
    AB = fm._z_inv_tabs(n2, Zm)
    ABg = fm._z_inv_tabs(n2, Zm, grad_kvec=_sl(n2, half=True))
    jr, ji, jp = (jnp.asarray(t) for t in (rr, ii, plane))
    tr, ti, tp = (torch.from_numpy(t) for t in (rr, ii, plane))
    ref = (jfm._zy_inv_ct2_call(jr, ji, Wyg, ABg, n2, DEFAULT, plane=jp),)
    got = (fm._zy_inv_ct2_call(tr, ti, Wyg, ABg, n2, plane=tp,
                               precision='bf16'),)
    f32 = (fm._zy_inv_ct2_call(tr, ti, Wyg, ABg, n2, plane=tp),)
    _chain(ref, got, f32)
    ref = jfm._zy_inv_ct2_call_dual(jr, ji, Wyg, AB, Wy, ABg, n2, DEFAULT,
                                    planeA=jp)
    got, f32 = (fm._zy_inv_ct2_call_dual(tr, ti, Wyg, AB, Wy, ABg, n2,
                                         planeA=tp, **kw)
                for kw in (dict(precision='bf16'), {}))
    _chain(ref, got, f32)


@pytest.mark.parametrize("shape", [(16, 16, 16), (24, 20, 15)])
def test_zy_inv_half_kernel_path_matches_jax(shape, zy_inv_kernel_path,
                                             tpu_rounding):
    """the dense zy inverse on a filtered spectrum with its Nyquist
    column in place, the k_y-folded y and k_z-folded z tables"""
    _, N1, n2 = shape
    Zh = n2 // 2 + 1
    rr, ii = _filtered(shape, sum(shape))
    wy = fm._dft_fold_np(N1, _sl(N1))
    AB = fm._irfft_mats_np(n2, Zh, grad_kvec=_sl(n2, half=True))
    ref = (jfm._zy_inv_half_call(jnp.asarray(rr), jnp.asarray(ii), wy, AB,
                                 n2, DEFAULT),)
    got, f32 = ((fm._zy_inv_dense_call(torch.from_numpy(rr),
                                       torch.from_numpy(ii), wy, AB, **kw),)
                for kw in (dict(precision='bf16'), {}))
    _chain(ref, got, f32)


# --- row 13's zy passes in the bf16 form ----------------------------------------

def emu_y_real(zr, zi, wr, wi):
    """tc_gemm's real-output y stage (bf16) of (n, C) columns: split_cols'
    one-part tiles of (zr, zi), rounded, times the swizzled one-part
    y_real_block_table of the (n, n) pair, 128 output rows per table
    tile, the slices' products summed in f32"""
    n, C = zr.shape
    nks = -(-n // 8)
    pad = [torch.nn.functional.pad(_rb(t), (0, 0, 0, nks * 8 - n))
           for t in (zr, zi)]
    dat = _col_tiles([tuple(pad)], nks * 8, C)
    tab = table(fk.y_real_block_table(wr.numpy(), wi.numpy(), 1))
    tab = swizzle(tab[0, :, :, 0])
    out = torch.einsum('tsrk,xsck->trxc', tab, swizzle(dat))
    return out.reshape(tab.shape[0] * 128, -1)[:n, :C]


def emu_zy_inv_full(rr, ii, wy, AB):
    """zy_inv_full (bf16) of (n0, N1, N2) as the kernels run it: the z
    stage as one real product of the rounded [xr | xi] and the stacked
    one-part table ([A | -B], [B | A] as z_inv_block_table's pair: zr,
    then zi), then the real-output y stage of the z output"""
    n0, N1, N2 = rr.shape
    A, B = (fm._t(a, rr) for a in AB)
    z = emu_z_inv(rr, ii, torch.cat([A, -B], 1), torch.cat([B, A], 1))
    cols = [t.permute(1, 0, 2).reshape(N1, n0 * N2)
            for t in (z[..., :N2], z[..., N2:])]
    out = emu_y_real(*cols, *(fm._t(a, rr) for a in wy))
    return out.reshape(N1, n0, N2).permute(1, 0, 2)


@pytest.fixture
def row13_kernel_path(monkeypatch):
    """the plain row-13 zy passes with the emulated data path in their
    bf16 form: zy_inv_full's two real products (emu_zy_inv_full), and
    zy_fwd_half_ct's z stage on rounded operands before the emulated y
    CT (emu_ct_fwd)"""
    inv, fwd = ref.zy_inv_full_plain, ref.zy_fwd_half_ct_plain

    def zy_inv_full(rr, ii, wy, AB, bf16=False):
        if not bf16:
            return inv(rr, ii, wy, AB, bf16)
        return emu_zy_inv_full(rr.float(), ii.float(), wy, AB)

    def zy_fwd_half_ct(x, wz, wy, bf16=False):
        if not bf16:
            return fwd(x, wz, wy, bf16)
        p = x.float()
        z = [fm._mm(p, fm._t(a, p), True) for a in wz]
        return emu_ct_fwd(*z, *(fm._t(a, p) for a in wy))
    monkeypatch.setattr(ref, 'zy_inv_full_plain', zy_inv_full)
    monkeypatch.setattr(ref, 'zy_fwd_half_ct_plain', zy_fwd_half_ct)


def test_zy_inv_full_kernel_path_matches_jax(row13_kernel_path,
                                             tpu_rounding):
    """the full-spectrum inverse with i k_z and the force triple of the
    spectrum of a mesh with a mean at (8, 16, 32)"""
    shape = (8, 16, 32)
    x = _mean_one(shape, 9)
    kv = tuple(_sl(n) for n in shape)
    spec = jref.fft3_real_forward(jnp.asarray(x.numpy()), precision='bf16')
    r, i = (torch.from_numpy(np.array(a)) for a in spec)
    kw = dict(grad=2, kvec=kv[2])
    ref_ = (jref.fft3_real_inverse(*spec, precision='bf16', **kw),)
    got = (ref.fft3_real_inverse(r, i, precision='bf16', **kw),)
    _chain(ref_, got, (ref.fft3_real_inverse(r, i, **kw),))
    _chain(jref.fft3_real_inverse_grad3(*spec, kvecs=kv, precision='bf16'),
           ref.fft3_real_inverse_grad3(r, i, kvecs=kv, precision='bf16'),
           ref.fft3_real_inverse_grad3(r, i, kvecs=kv))


def test_zy_fwd_half_ct_kernel_path_matches_jax(row13_kernel_path,
                                                tpu_rounding):
    """the first-CT forward of a mesh with a mean at the slab"""
    key = 'bx:%dx%dx%d' % (SLAB[0], SLAB[1], SLAB[2] // 2 + 1)
    x = _mean_one(SLAB, 10)
    jfm.TUNE[key] = 2
    try:
        want = jref.fft3_real_forward_half_ct(jnp.asarray(x.numpy()),
                                              precision='bf16')
    finally:
        jfm.TUNE.pop(key, None)
    _chain(want, ref.fft3_real_forward_half_ct(x, precision='bf16'),
           ref.fft3_real_forward_half_ct(x))
