"""The bf16 forms of the port's DFT passes against the JAX package:
``fft='mxu_bf16'`` (``precision='bf16'``, single-pass bf16 products) and
``fft='mxu_bf16s'`` (``spectrum_dtype=bfloat16``, bf16 spectrum storage
between the ct2 passes).

The JAX reference for ``mxu_bf16``.  On the CPU, XLA ignores
``Precision.DEFAULT`` for f32 dots, so the JAX package's
``precision='bf16'`` runs f32 products here.  The ``tpu_rounding``
fixture puts the MXU's single pass back: it replaces ``_mm`` in
``pmesh_tpu.ops.fft_mxu`` and ``pmesh_tpu.ops.fft_mxu_ref`` (which
imports it by name) by a dot that, at ``Precision('default')``, rounds
both operands to bf16 and keeps the sum in f32.  The JAX kernels then
round exactly where they round on the TPU.  No file of the JAX package
changes; the fixture clears JAX's caches before and after, because the
entry points are jitted on their static arguments.

Tolerances, from a rounding argument.  A product of two bf16 values is
exact in f32, so port and reference differ in the order of the f32 sums
only, and where a pass rounds an intermediate again that order can flip
one bf16 rounding (one bf16 ulp of one operand):

- each pass on the same inputs, ``mxu_bf16``: max|port - ref| <= 5e-4 of
  max|ref| and at least 99.9 % of the entries within 1e-5 of max|ref|;
  the port's bf16 result differs from its f32 result by at least 1e-4
  relative rms (the rounding takes place);
- each pass on the same inputs, ``mxu_bf16s`` against the JAX package's
  own ``out_dtype=bfloat16`` kernels (no patch): every stored spectrum
  is bf16, at least 99.9 % of it bitwise equal to JAX's and no entry
  more than one bf16 ulp away beyond the gap of the f32 sums it rounds;
  an f32 output within 3e-6 of max (f32 products);
- a chain of passes (a row-13 entry point, a force): a flip does not
  stay in its pass.  Every later product reads the flipped operand, and
  one flip at a dominant mode moves a whole mesh by up to one bf16 ulp
  of that mode, 2^-8 of its share.  So at the (256, 256, 16) slab,
  where the sums are 128 terms long, chains are held to max|port - ref|
  <= 1e-2 of max|ref| and to an rms gap <= 0.15 of the rms of the bf16
  rounding itself (the bf16 result against the port's f32 one): the
  port carries the same roundings and what is left is the flips, which
  ``test_chained_gap_is_operand_flips`` traces (PERF.md has the
  numbers).  At 16^3 (dense, 16-term sums) no rounding flips, and the
  forces and the gradient are held to the per-pass criteria.

The ct2 shapes need x and y lengths R * 128k, so those cases use
(256, 256, 16) slabs; the JAX package's plane-block picker would unroll
every x-plane of them into one interpret-mode kernel body, so the tests
set its ``TUNE`` blocks to 2 planes (blocking, not math).  About 60 s in
one process; the four JAX forces at the slab take most of it.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pmesh_tpu import ParticleMesh as JaxPM
from pmesh_tpu.models import fastpm as jfastpm
from pmesh_tpu.ops import binned as jbn
from pmesh_tpu.ops import fft_mxu as jfm
from pmesh_tpu.ops import fft_mxu_ref as jref
from pmesh_tpu_torch import convert
from pmesh_tpu_torch.models import fastpm as tfastpm
from pmesh_tpu_torch.ops import binned as tbn
from pmesh_tpu_torch.ops import fft_mxu as fm
from pmesh_tpu_torch.ops import fft_mxu_ref as ref

torch.set_num_threads(1)

CPU = 'cpu'
SLAB = (256, 256, 16)
TOL_F32 = 3e-6
TOL_MAX, TOL_NEAR, NEAR_SHARE = 5e-4, 1e-5, 1e-3
TOL_ROUNDS = 1e-4
TOL_FORCE_MAX, TOL_FORCE_RMS = 1e-2, 0.15
DEFAULT = jax.lax.Precision('default')
BF16 = dict(precision='bf16')


@pytest.fixture(scope="module")
def tpu_rounding():
    """the JAX package's products at Precision('default') rounded as
    the MXU's single pass rounds them, for the rest of this module (the
    mxu_bf16s tests, which need no patch, run before the first test that
    asks for it)"""
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


@pytest.fixture(scope="module", autouse=True)
def slab_blocks():
    """2-plane blocks for the JAX zy kernels at the slab's shapes, and
    1-row blocks for its x-CT kernel, whose rows are unrolled in
    interpret mode (blocking, not math)"""
    N0, N1, n2 = SLAB
    keys = (['bx:%s:%dx%dx%d' % (t, N0, N1, n2 // 2)
             for t in ('zyf', 'zyi', 'zyid')]
            + ['bx:%dx%dx%d' % (N0, N1, n2 // 2 + 1)])
    for k in keys:
        jfm.TUNE[k] = 2
    jfm.TUNE['xct_by'] = 1
    yield
    for k in keys + ['xct_by']:
        jfm.TUNE.pop(k, None)


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _close(want, got):
    """the mxu_bf16 criterion of one output"""
    want, got = _np(want), _np(got)
    assert want.shape == got.shape
    d = np.abs(want - got)
    s = np.abs(want).max()
    assert d.max() <= TOL_MAX * s, d.max() / s
    assert (d > TOL_NEAR * s).mean() <= NEAR_SHARE


def _rounds(bf16, f32):
    """the bf16 products differ from the f32 ones"""
    a, b = _np(bf16), _np(f32)
    assert np.sqrt(((a - b) ** 2).mean() / (b ** 2).mean()) >= TOL_ROUNDS


def _same_bf16(want, got, want32, got32):
    """the mxu_bf16s criterion of one stored spectrum: bf16, at most
    NEAR_SHARE of it not bitwise equal, and no entry more than one bf16
    ulp away beyond the gap of the two f32 sums it rounds (``want32``,
    ``got32``: the same pass stored in f32).  Two values less than an ulp
    apart round at most one ulp apart; an entry whose sums differ by
    more, the rounding noise of a mode that nearly cancels, may round
    further apart by that much."""
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    w, g = _np(want), _np(got)
    m = np.maximum(np.abs(w), np.abs(g))
    ulp = np.exp2(np.floor(np.log2(np.where(m > 0, m, 1.0))) - 7)
    assert (w != g).mean() <= NEAR_SHARE
    assert (np.abs(w - g) <= ulp + np.abs(_np(want32) - _np(got32))).all()


def _chained(want, got, f32):
    """the criterion of a chain of passes (an entry point of row 13, a
    force): max|got - want| <= TOL_FORCE_MAX of max|want| over the
    outputs, and an rms gap <= TOL_FORCE_RMS of the rms of the bf16
    rounding itself (want against the port's f32 result); returns the
    two measures"""
    want, got, f32 = ([_np(a) for a in t] for t in (want, got, f32))
    scale = max(np.abs(w).max() for w in want)
    gap = max(np.abs(w - g).max() for w, g in zip(want, got)) / scale
    rms = max(np.sqrt(((w - g) ** 2).mean() / ((w - f) ** 2).mean())
              for w, g, f in zip(want, got, f32))
    assert gap <= TOL_FORCE_MAX and rms <= TOL_FORCE_RMS, (gap, rms)
    return gap, rms


def _normal(seed, shape, n=1):
    rng = np.random.RandomState(seed)
    return [rng.normal(size=shape).astype('f4') for _ in range(n)]


def _kvec(n, half=False):
    """a SuperLanczos-shaped table, zero at Nyquist, as a tuple"""
    w = (np.fft.rfftfreq(n) if half else np.fft.fftfreq(n)) * 2 * np.pi
    return tuple(((8 * np.sin(w) - np.sin(2 * w)) / 6.0).tolist())


def _k2(shape):
    """natural-order 1-d k^2 tables, DC zero"""
    out = []
    for n, half in zip(shape, (False, False, True)):
        k = (np.fft.rfftfreq(n) if half else np.fft.fftfreq(n)) * 2 * np.pi
        out.append((k ** 2).astype('f4'))
    return out


# --- the ct2 passes, each on the same inputs ---------------------------------

CT2_PASSES = ['zy_fwd', 'x_fwd', 'x_inv_dual_k2', 'zy_inv_plane', 'zy_inv_dual']


def _ct2_pass(name, storage, out32=False):
    """(JAX call, port call, port keywords) of one ct2 pass at the slab;
    under ``storage`` the spectra are bf16 (the mxu_bf16s form; with
    ``out32`` the same inputs and f32 outputs), else the products are
    (the mxu_bf16 form)"""
    N0, N1, n2 = SLAB
    Zm = n2 // 2
    prec = None if storage else DEFAULT
    bf = {} if storage else BF16
    # the spectra read (jin, tin) and written (jdt, tdt)
    jin, tin = ((jnp.bfloat16, torch.bfloat16) if storage
                else (jnp.float32, torch.float32))
    jdt, tdt = (jnp.float32, torch.float32) if out32 else (jin, tin)
    if name == 'zy_fwd':
        x = 1.0 + 0.3 * _normal(1, SLAB)[0]
        wz, wy = fm._z_fwd_tabs(n2, Zm), fm._ct_fwd_mats_np(N1)
        return (lambda: jfm._zy_fwd_ct2_call(jnp.asarray(x), n2, Zm, wz, wy,
                                             prec, out_dtype=jdt),
                lambda **kw: fm._zy_fwd_ct2_call(_t(x), n2, Zm, wz, wy,
                                                 out_dtype=tdt, **kw), bf)
    if name.startswith('x_'):
        pr, pi = (jnp.asarray(a).astype(jin)
                  for a in _normal(2, (N0, 4, Zm), 2))
        tr, ti = (_t(_np(a)).to(tin) for a in (pr, pi))
        if name == 'x_fwd':
            kw = dict(wx=fm._ct_fwd_mats_np(N0), scale=1.0 / N0 ** 3)
        else:
            k2 = _k2((N0, 4, n2))
            k2[1] = np.asarray([0.0, 0.5, 1.0, 1.5], 'f4')
            kw = dict(wx=fm._ct_inv_mats_np(N0), scale=1.0, inverse=True,
                      wx2=fm._ct_inv_mats_np(N0, fold_kvec=_kvec(N0)),
                      k2=(k2[0], k2[1], k2[2][:Zm]))
        return (lambda: jfm._xct_call_multi(pr, pi, prec=prec, out_dtype=jdt,
                                            **kw),
                lambda **k: fm._xct_call_multi(tr, ti, out_dtype=tdt, **k,
                                               **kw), bf)
    rr, ii = (jnp.asarray(a).astype(jin) for a in _normal(3, (4, N1, Zm), 2))
    tr, ti = (_t(_np(a)).to(tin) for a in (rr, ii))
    plane = _normal(4, (4, N1))[0]
    Wy, Wyg = fm._ct_inv_mats_np(N1), fm._ct_inv_mats_np(N1, _kvec(N1))
    AB = fm._z_inv_tabs(n2, Zm)
    ABg = fm._z_inv_tabs(n2, Zm, grad_kvec=_kvec(n2, half=True))
    if name == 'zy_inv_plane':
        return (lambda: jfm._zy_inv_ct2_call(rr, ii, Wyg, ABg, n2, prec,
                                             plane=jnp.asarray(plane)),
                lambda **k: fm._zy_inv_ct2_call(tr, ti, Wyg, ABg, n2,
                                                plane=_t(plane), **k), bf)
    return (lambda: jfm._zy_inv_ct2_call_dual(rr, ii, Wyg, AB, Wy, ABg, n2,
                                              prec, planeA=jnp.asarray(plane)),
            lambda **k: fm._zy_inv_ct2_call_dual(tr, ti, Wyg, AB, Wy, ABg,
                                                 n2, planeA=_t(plane), **k),
            bf)


@pytest.mark.parametrize("name", CT2_PASSES)
def test_ct2_pass_bf16_storage_matches_jax(name):
    jax_call, port_call, _ = _ct2_pass(name, storage=True)
    want, got = jax_call(), port_call()
    if isinstance(got, torch.Tensor):
        want, got = (want,), (got,)
    if any(w.dtype == jnp.bfloat16 for w in want):
        jax32, port32, _ = _ct2_pass(name, storage=True, out32=True)
        want32, got32 = jax32(), port32()
    for k, (w, g) in enumerate(zip(want, got)):
        if w.dtype == jnp.bfloat16:
            _same_bf16(w, g, want32[k], got32[k])
        else:
            # the Nyquist row sum and the real meshes stay f32
            assert g.dtype == torch.float32
            assert np.abs(_np(w) - _np(g)).max() <= TOL_F32 * np.abs(
                _np(w)).max()


@pytest.mark.parametrize("name", CT2_PASSES)
def test_ct2_pass_bf16_products_match_jax(tpu_rounding, name):
    jax_call, port_call, bf = _ct2_pass(name, storage=False)
    want, got, f32 = jax_call(), port_call(**bf), port_call()
    if isinstance(got, torch.Tensor):
        want, got, f32 = (want,), (got,), (f32,)
    assert len(want) == len(got)
    # the zy forward's third output, the Nyquist row sum, has no product
    for w, g, f in list(zip(want, got, f32))[:2]:
        assert g.dtype == torch.float32
        _close(w, g)
        _rounds(g, f)
    for w, g in list(zip(want, got))[2:]:
        _close(w, g)


def test_chained_gap_is_operand_flips(tpu_rounding):
    """Why a chain of passes is held to the chained criterion, on the
    force triple's inverse at the slab: the x pass (with the 1/k^2 fold,
    which makes the low modes dominant) writes f32 outputs, JAX's and
    the port's, that differ in the order of their sums; the zy inverse
    rounds them to bf16, and where the two values lie on either side of
    a rounding midpoint the operand flips by one bf16 ulp.  The zy
    inverse on JAX's own x-pass output is JAX's to the per-pass
    criterion, and the gap of the chain is that of the flipped operands
    (printed)."""
    N0, N1, n2 = SLAB
    Zm = n2 // 2
    x = 1.0 + 0.3 * _normal(13, SLAB)[0]
    spec = fm.fft3_real_forward_half_ct2(_t(x))[:2]
    k2 = _k2(SLAB)
    wx = (fm._ct_inv_mats_np(N0), fm._ct_inv_mats_np(N0, _kvec(N0)))
    k2m = fm._poisson_tables(fm._tuples(k2), N0, N1, Zm)[1]
    Wy, AB = fm._ct_inv_mats_np(N1), fm._z_inv_tabs(n2, Zm)
    jx = jfm._xct_call_multi(*(jnp.asarray(_np(a)) for a in spec), wx[0],
                             1.0, DEFAULT, inverse=True, wx2=wx[1], k2=k2m)
    tx = fm._xct_call_multi(*spec, wx[0], 1.0, inverse=True, wx2=wx[1],
                            k2=k2m, **BF16)
    flips = np.mean([_np(_t(_np(a)).to(torch.bfloat16))
                     != _np(b.to(torch.bfloat16)) for a, b in zip(jx, tx)])
    want = jfm._zy_inv_ct2_call(jx[2], jx[3], Wy, AB, n2, DEFAULT)
    on_jax = fm._zy_inv_ct2_call(*map(_t, jx[2:]), Wy, AB, n2, **BF16)
    chained = fm._zy_inv_ct2_call(*tx[2:], Wy, AB, n2, **BF16)
    _close(want, on_jax)
    s = np.abs(_np(want)).max()
    gap = np.abs(_np(want) - _np(chained)).max() / s
    flip_gap = np.abs(_np(on_jax) - _np(chained)).max() / s
    print("x-pass outputs whose bf16 rounding flips: %.3e of the entries; "
          "the chain x -> zy against JAX's %.3e of max, the port's zy "
          "inverse on its own against on JAX's x-pass output %.3e"
          % (flips, gap, flip_gap))
    assert 0 < flips < NEAR_SHARE
    assert abs(gap - flip_gap) <= TOL_MAX
    assert gap <= TOL_FORCE_MAX


# --- the dense passes --------------------------------------------------------

@pytest.mark.parametrize("shape", [(16, 16, 16), (15, 12, 10)])
def test_dense_passes_bf16_match_jax(tpu_rounding, shape):
    """the Pallas bodies of rows 3 and 4 (``_zy_forward_real_h``,
    ``_x_transform``, ``_zy_inverse_to_real_h``, run through the JAX
    package's per-slab calls) at Precision('default'); the fold of
    1/k^2, elementwise in JAX's solver, goes before the x product's
    rounding in both"""
    N0, N1, n2 = shape
    Zh = n2 // 2 + 1
    x, = _normal(5, shape)
    wz, wy = fm._dft_half_np(n2, Zh), fm._dft_np(N1, -1)
    want = jfm._zy_fwd_half_call(jnp.asarray(x), n2, Zh,
                                 *map(jnp.asarray, wz + wy), DEFAULT)
    got = fm._zy_fwd_dense_call(_t(x), wz, wy, **BF16)
    for w, g, f in zip(want, got, fm._zy_fwd_dense_call(_t(x), wz, wy)):
        _close(w, g)
        _rounds(g, f)
    pr, pi = _normal(6, (N0, N1, Zh), 2)
    k2 = _k2(shape)
    kk = k2[0][:, None, None] + k2[1][None, :, None] + k2[2][None, None]
    invk2 = np.where(kk > 0, 1.0 / np.where(kk > 0, kk, 1.0), 0.0)
    wx, wg = fm._dft_np(N0, +1), fm._dft_fold_np(N0, _kvec(N0))
    # one scale: the kernel is compiled per scale
    for table, scale, fold in ((fm._dft_np(N0, -1), 1.0, False),
                               (wx, 1.0, True), (wg, 1.0, True)):
        a, b = (pr * invk2, pi * invk2) if fold else (pr, pi)
        want = jfm._xpass_half_call(jnp.asarray(a), jnp.asarray(b),
                                    *map(jnp.asarray, table), scale, DEFAULT)
        got = fm._x_dense_call(_t(pr), _t(pi), table, scale,
                               k2=k2 if fold else None, **BF16)
        for w, g in zip(want, got):
            _close(w, g)
    wyi, wyg = fm._dft_np(N1, +1), fm._dft_fold_np(N1, _kvec(N1))
    ABg = fm._irfft_mats_np(n2, Zh, grad_kvec=_kvec(n2, half=True))
    for tabs in ((wyg, fm._irfft_mats_np(n2, Zh)), (wyi, ABg)):
        want = jfm._zy_inv_half_call(jnp.asarray(pr), jnp.asarray(pi),
                                     *tabs, n2, DEFAULT)
        _close(want, fm._zy_inv_dense_call(_t(pr), _t(pi), *tabs, **BF16))


# --- row 13: each entry point is a chain of two passes -----------------------

def test_ref_full_bf16_matches_jax(tpu_rounding):
    """the full-spectrum forward, an inverse with i k_z and the force
    triple at (8, 16, 32)"""
    shape = (8, 16, 32)
    x, = _normal(7, shape)
    kv = tuple(_kvec(n) for n in shape)
    want = jref.fft3_real_forward(jnp.asarray(x), precision='bf16')
    got = ref.fft3_real_forward(_t(x), **BF16)
    f32 = ref.fft3_real_forward(_t(x))
    _chained(want, got, f32)
    for g, f in zip(got, f32):
        _rounds(g, f)
    r, i = map(_t, want)
    _chained([jref.fft3_real_inverse(*want, grad=2, kvec=kv[2],
                                     precision='bf16')],
             [ref.fft3_real_inverse(r, i, grad=2, kvec=kv[2], **BF16)],
             [ref.fft3_real_inverse(r, i, grad=2, kvec=kv[2])])
    _chained(jref.fft3_real_inverse_grad3(*want, kvecs=kv, precision='bf16'),
             ref.fft3_real_inverse_grad3(r, i, kvecs=kv, **BF16),
             ref.fft3_real_inverse_grad3(r, i, kvecs=kv))


def test_ref_half_ct_bf16_matches_jax(tpu_rounding):
    """the first-CT forward and force triple at the slab"""
    x, = _normal(8, SLAB)
    kd = (_kvec(SLAB[0]), _kvec(SLAB[1]), _kvec(SLAB[2], half=True))
    want = jref.fft3_real_forward_half_ct(jnp.asarray(x), precision='bf16')
    _chained(want, ref.fft3_real_forward_half_ct(_t(x), **BF16),
             ref.fft3_real_forward_half_ct(_t(x)))
    r, i = map(_t, want)
    got = ref.fft3_real_inverse_grad3_half_ct(r, i, SLAB[2], kd, **BF16)
    f32 = ref.fft3_real_inverse_grad3_half_ct(r, i, SLAB[2], kd)
    _chained(jref.fft3_real_inverse_grad3_half_ct(
        *want, n2=SLAB[2], kvecs=kd, precision='bf16'), got, f32)
    for g, f in zip(got, f32):
        _rounds(g, f)


# --- the forces --------------------------------------------------------------

def _solvers(shape):
    jpm = JaxPM(Nmesh=list(shape), BoxSize=np.asarray(shape, float),
                dtype='f4')
    tpm = convert.particlemesh_from(jpm.Nmesh, jpm.BoxSize, jpm.dtype,
                                    jpm.resampler, device=CPU)
    return jfastpm.Solver(jpm), tfastpm.Solver(tpm)


def _disp(seed, shape):
    rng = np.random.RandomState(seed)
    return [rng.uniform(0, 1, shape).astype('f4') for _ in range(3)]


@pytest.mark.parametrize("fft", ['mxu_bf16', 'mxu_bf16s'])
@pytest.mark.parametrize("mode", ['spectral', 'gradient'])
def test_force_lattice_slab_matches_jax(tpu_rounding, fft, mode):
    """the ct2 forces end to end, one JAX force per case (the gaps are
    printed)"""
    js, ts = _solvers(SLAB)
    disp = _disp(9, SLAB)
    td = tuple(map(torch.from_numpy, disp))
    want = js.force_lattice(tuple(map(jnp.asarray, disp)), (0.0, 1.0),
                            mode=mode, fft=fft)
    got = ts.force_lattice(td, (0.0, 1.0), mode=mode, fft=fft)
    f32 = ts.force_lattice(td, (0.0, 1.0), mode=mode, fft='mxu')
    assert all(g.dtype == torch.float32 for g in got)
    gap, rms = _chained(want, got, f32)
    print("%s %s: max gap %.3e of max, rms gap %.3f of the bf16 rounding"
          % (fft, mode, gap, rms))
    for g, f in zip(got, f32):
        _rounds(g, f)


def test_force_lattice_dense_bf16_matches_jax(tpu_rounding):
    """at 16^3 (dense, 16-term sums) the bf16 force is JAX's to the
    per-pass criteria"""
    js, ts = _solvers((16,) * 3)
    disp = _disp(10, (16,) * 3)
    td = tuple(map(torch.from_numpy, disp))
    want = js.force_lattice(tuple(map(jnp.asarray, disp)), (0.0, 1.0),
                            fft='mxu_bf16')
    got = ts.force_lattice(td, (0.0, 1.0), fft='mxu_bf16')
    f32 = ts.force_lattice(td, (0.0, 1.0), fft='mxu')
    for w, g, f in zip(want, got, f32):
        _close(w, g)
        _rounds(g, f)


def test_force_binned_dense_bf16_matches_jax(tpu_rounding):
    js, ts = _solvers((16,) * 3)
    disp = _disp(11, (16,) * 3)
    jd, jv = jbn.from_lattice(tuple(map(jnp.asarray, disp)), nslots=2)
    td, tv = tbn.from_lattice(tuple(map(torch.from_numpy, disp)), nslots=2)
    want = js.force_binned(jd, jv, (-0.5, 1.5), fft='mxu_bf16')
    got = ts.force_binned(td, tv, (-0.5, 1.5), fft='mxu_bf16')
    # slot 0 is the lattice; slot 1 is empty and reads garbage
    for w, g in zip(want[0], got[0]):
        _close(w, g)


def test_force_lattice_dense_bf16_grad_matches_jax(tpu_rounding):
    """torch.autograd through one force_lattice(fft='mxu_bf16') against
    jax.grad: the transpose runs the forward's bf16 passes"""
    js, ts = _solvers((16,) * 3)
    disp = _disp(12, (16,) * 3)

    def jloss(d):
        F = js.force_lattice(d, (0.0, 1.0), fft='mxu_bf16')
        return jnp.sum(F[0] ** 2 + 2 * F[1] ** 2 + 3 * F[2] ** 2)
    want = jax.grad(jloss)(tuple(map(jnp.asarray, disp)))

    def grads(fft):
        td = [torch.from_numpy(d).requires_grad_() for d in disp]
        F = ts.force_lattice(td, (0.0, 1.0), fft=fft)
        (F[0] ** 2 + 2 * F[1] ** 2 + 3 * F[2] ** 2).sum().backward()
        return [t.grad for t in td]
    for w, g, f in zip(want, grads('mxu_bf16'), grads('mxu')):
        _close(w, g)
        _rounds(g, f)
