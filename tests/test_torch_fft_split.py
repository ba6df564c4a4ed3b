"""CPU evidence that the split-precision tensor-core products of
zy_fwd_ct2 and xct_multi (csrc/fft_mxu.cu, tc_ct and tc_z) keep f32
accuracy.

The kernels split each f32 operand into three bf16 parts, a = a1 + a2 +
a3 (the host splits the tables, ops/fft_mxu_cuda.bf16_split3; the threads
split the data the same way) and keep the six products down to 2^-16 of
the leading one.  Here:

- the host split: every part is a bf16 value (its 16 low f32 bits zero),
  each part at most 2^-8 of the one before, and a1 + a2 + a3 reproduces
  each table entry to 2^-24 relative (f32's own rounding);
- the tables' layout: the real block GEMM that the kernels run over
  ct_block_table / z_block_table (tiles, slices, parts) equals the
  complex products W u and u E;
- a plain-torch emulation of the split product, kept in this file (not a
  mode of the package), patched into the plain passes where the kernels
  run it (the f32 form of zy_fwd_ct2 and xct_multi; the few outputs
  that carry the mean, which the kernels sum again as the plain passes
  do, are left to the split here too): each pass, forward
  and the folded dual inverse, at (256, 256, 16) and 32^3 against the
  JAX package's Pallas kernels in interpret mode within 3e-6 of max (the
  tolerance of tests/test_torch_fft_mxu.py), and the (256, 256, 16)
  force within 2e-5 of max of JAX's fft='xla'.  At 32^3, not a ct2
  shape, the passes run with R = 1 (no butterfly): the same products.
  The emulation sums the six products in f32 on the CPU; the tensor
  cores' truncating sums are the card's part (tests/test_torch_cuda.py,
  chip_smoke.py).
"""
import inspect

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pmesh_tpu import ParticleMesh as JaxPM
from pmesh_tpu.models import fastpm as jfastpm
from pmesh_tpu.ops import fft_mxu as jfm
from pmesh_tpu_torch import convert
from pmesh_tpu_torch.models import fastpm as tfastpm
from pmesh_tpu_torch.ops import fft_mxu as fm
from pmesh_tpu_torch.ops import fft_mxu_cuda as fk

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
    forms of zy_fwd_ct2 and xct_multi, the passes that run it; every
    other product stays the plain f32 one"""
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
