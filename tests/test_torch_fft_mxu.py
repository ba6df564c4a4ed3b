"""The port's split-Nyquist CT DFT passes (pmesh_tpu_torch.ops.fft_mxu)
and the fft='mxu' force path against the JAX package.

- the static tables: bitwise equal to the JAX package's numpy tables;
- each plain pass against the JAX pass, run as tests/test_zct.py runs it
  (the Pallas kernel in interpret mode on the CPU): 3e-6 of max|ref|,
  the tolerance of test_zct (f32 matmuls summed in another order);
- the public ct2 operators against numpy's rfftn/irfftn: 2e-6 of max
  (f32 DFT products against an f8 FFT);
- the slice at (256, 256, 16): force_lattice(fft='mxu') and
  force_binned(fft='mxu') against the JAX package's fft='xla', 2e-5 of
  max|ref| (test_fft_mxu.test_ct_force_lattice_end_to_end), except the
  gradient-mode binned force at 4e-5: a dense f32 DFT product rounds
  with an error that grows with its contraction length (an FFT's with
  its log), 1/k^2 lifts that error at low k, and the derivative window
  differences the potential across cells; that leaves 2.4e-5 of max
  there, where the port's fft='xla' is 6e-6 from the JAX package on the
  same input; three KDK steps 1e-4 of max|S|.  The JAX fft='mxu' path
  takes ~30 s per call in interpret mode at that size, so the per-pass
  tests hold the passes to it instead.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pmesh_tpu import ParticleMesh as JaxPM
from pmesh_tpu.models import fastpm as jfastpm
from pmesh_tpu.ops import fft_mxu as jfm
from pmesh_tpu_torch import convert
from pmesh_tpu_torch.models import fastpm as tfastpm
from pmesh_tpu_torch.ops import binned as tbn
from pmesh_tpu_torch.ops import fft_mxu as fm

torch.set_num_threads(1)

TOL_PASS = 3e-6
TOL_NUMPY = 2e-6
TOL_FORCE = 2e-5
TOL_FORCE_BINNED_GRADIENT = 4e-5
TOL_NBODY = 1e-4
SHAPE = (256, 256, 16)


def _same(ref, got):
    """bitwise equal, nested tuples allowed"""
    if isinstance(ref, (tuple, list)):
        assert isinstance(got, (tuple, list)) and len(ref) == len(got)
        for r, g in zip(ref, got):
            _same(r, g)
        return
    ref, got = np.asarray(ref), np.asarray(got)
    assert ref.shape == got.shape and ref.dtype == got.dtype
    assert np.array_equal(ref, got)


def _rel(ref, got):
    ref = np.asarray(ref)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert ref.shape == got.shape
    return np.abs(ref - got).max() / np.abs(ref).max()


def _kvec(n, half=False):
    """a SuperLanczos-shaped table, zero at Nyquist, as a tuple"""
    w = (np.fft.rfftfreq(n) if half else np.fft.fftfreq(n)) * 2 * np.pi
    return tuple(((8 * np.sin(w) - np.sin(2 * w)) / 6.0).tolist())


# --- (a) the tables ------------------------------------------------------------

@pytest.mark.parametrize("n", [256, 512, 1024])
def test_ct_tables_bitwise(n):
    R, _ = fm._ct_factor(n)
    assert fm._ct_factor(n) == jfm._ct_factor(n)
    _same(jfm._ct_permute(n), fm._ct_permute(n))
    table = np.arange(n) * 1.5 + 0.25
    _same(jfm._ct_table(n, table), fm._ct_table(n, table))
    _same(jfm._ct_fwd_mats_np(n), fm._ct_fwd_mats_np(n))
    _same(jfm._ct_inv_mats_np(n), fm._ct_inv_mats_np(n))
    kv = _kvec(n)
    _same(jfm._ct_inv_mats_np(n, fold_kvec=kv),
          fm._ct_inv_mats_np(n, fold_kvec=kv))
    for sign in (-1, 1):
        _same(jfm._butter(R, sign), fm._butter(R, sign))
        _same(jfm._dft_np(n, sign), fm._dft_np(n, sign))


@pytest.mark.parametrize("n2", [16, 256, 512, 1024])
def test_z_tables_bitwise(n2):
    Zm = n2 // 2
    kz = _kvec(n2, half=True)
    assert fm._zct_factor(n2) == jfm._zct_factor(n2)
    Rz = fm._zct_factor(n2)[0]
    assert fm._zct_order(Rz) == jfm._zct_order(Rz)
    assert fm._use_zct_fwd(n2, Zm) == jfm._use_zct_fwd(n2, Zm)
    assert fm._use_zct_inv(n2, Zm) == jfm._use_zct_inv(n2, Zm)
    _same(jfm._zct_perm(n2), fm._zct_perm(n2))
    table = np.arange(Zm + 1) * 0.5
    _same(jfm._zct_table(n2, table), fm._zct_table(n2, table))
    _same(jfm._zct_fwd_mats_np(n2), fm._zct_fwd_mats_np(n2))
    for kw in ({}, dict(grad_kvec=kz), dict(negate=True),
               dict(grad_kvec=kz, negate=True)):
        _same(jfm._zct_inv_mats_np(n2, **kw), fm._zct_inv_mats_np(n2, **kw))
        _same(jfm._z_inv_tabs(n2, Zm, **kw), fm._z_inv_tabs(n2, Zm, **kw))
    _same(jfm._z_fwd_tabs(n2, Zm), fm._z_fwd_tabs(n2, Zm))
    for zh in (Zm, Zm + 1):
        _same(jfm._dft_half_np(n2, zh), fm._dft_half_np(n2, zh))
        for kw in ({}, dict(nyquist_last=False),
                   dict(grad_kvec=np.asarray(kz)[:zh])):
            _same(jfm._irfft_mats_np(n2, zh, **kw),
                  fm._irfft_mats_np(n2, zh, **kw))


@pytest.mark.parametrize("shape", [(256, 512, 16), (512, 256, 512),
                                   (1024, 256, 1024), (256, 256, 256)])
def test_poisson_tables_bitwise(shape):
    N0, N1, n2 = shape
    Zm = n2 // 2
    k2 = tuple(tuple(float(v) for v in (np.asarray(t) ** 2).astype('f4'))
               for t in (_kvec(N0), _kvec(N1), _kvec(n2, half=True)))
    ref = jfm._poisson_tables(k2, N0, N1, Zm)
    got = fm._poisson_tables(k2, N0, N1, Zm)
    _same(np.asarray(ref[0]), got[0])
    _same(ref[1], got[1])


# --- (b) each plain pass against the JAX pass (interpret mode) -----------------

@pytest.mark.parametrize("n2", [16, 256, 512, 1024])
def test_zy_fwd_plain_matches_jax(n2):
    n0, N1, Zm = 8, 256, n2 // 2
    x = np.random.RandomState(n2).normal(size=(n0, N1, n2)).astype('f4')
    wz = fm._z_fwd_tabs(n2, Zm)
    wy = fm._ct_fwd_mats_np(N1)
    ref = jfm._zy_fwd_ct2_call(jnp.asarray(x), n2, Zm, wz, wy, None)
    got = fm._zy_fwd_ct2_call(torch.from_numpy(x), n2, Zm, wz, wy)
    assert len(got) == 3
    for r, g in zip(ref, got):
        assert _rel(r, g) <= TOL_PASS


def _xct_cases(N0, n1, W):
    rng = np.random.RandomState(N0 + W)
    k2 = (rng.uniform(0.0, 2.0, N0).astype('f4'),
          rng.uniform(0.0, 2.0, n1).astype('f4'),
          rng.uniform(0.0, 2.0, W).astype('f4'))
    for t in k2:
        t[0] = 0.0    # the DC mode: 1/k^2 -> 0
    wi = fm._ct_inv_mats_np(N0)
    wg = fm._ct_inv_mats_np(N0, fold_kvec=_kvec(N0))
    return {
        'forward': dict(wx=fm._ct_fwd_mats_np(N0), scale=1.0 / (N0 * 37)),
        'inverse': dict(wx=wi, scale=1.0, inverse=True),
        'inverse_dual_k2': dict(wx=wi, scale=1.0, inverse=True, wx2=wg,
                                k2=k2),
        'inverse_k2': dict(wx=wg, scale=1.0, inverse=True, k2=k2),
    }


@pytest.mark.parametrize("shape", [(256, 8, 8), (512, 8, 16)])
@pytest.mark.parametrize("case", ['forward', 'inverse', 'inverse_dual_k2',
                                  'inverse_k2'])
def test_xct_multi_plain_matches_jax(shape, case):
    rng = np.random.RandomState(7)
    pr, pi = (rng.normal(size=shape).astype('f4') for _ in range(2))
    kw = _xct_cases(*shape)[case]
    ref = jfm._xct_call_multi(jnp.asarray(pr), jnp.asarray(pi), kw['wx'],
                              kw['scale'], None,
                              inverse=kw.get('inverse', False),
                              wx2=kw.get('wx2'), k2=kw.get('k2'))
    got = fm._xct_call_multi(torch.from_numpy(pr), torch.from_numpy(pi),
                             **kw)
    assert len(got) == len(ref) == (4 if 'wx2' in kw else 2)
    for r, g in zip(ref, got):
        assert _rel(r, g) <= TOL_PASS


@pytest.mark.parametrize("n2", [16, 512, 1024])
@pytest.mark.parametrize("with_plane", [False, True])
def test_zy_inv_plain_matches_jax(n2, with_plane):
    n0, N1, Zm = 8, 256, n2 // 2
    rng = np.random.RandomState(n2 + with_plane)
    rr, ii = (rng.normal(size=(n0, N1, Zm)).astype('f4') for _ in range(2))
    plane = rng.normal(size=(n0, N1)).astype('f4') if with_plane else None
    kz = _kvec(n2, half=True)
    Wy = fm._ct_inv_mats_np(N1)
    Wyg = fm._ct_inv_mats_np(N1, fold_kvec=_kvec(N1))
    AB = fm._z_inv_tabs(n2, Zm)
    ABg = fm._z_inv_tabs(n2, Zm, grad_kvec=kz)
    assert (np.ndim(AB[0]) == 3) == (n2 == 1024)
    jp = None if plane is None else jnp.asarray(plane)
    tp = None if plane is None else torch.from_numpy(plane)
    jr, ji = jnp.asarray(rr), jnp.asarray(ii)
    tr, ti = torch.from_numpy(rr), torch.from_numpy(ii)
    ref = jfm._zy_inv_ct2_call(jr, ji, Wy, ABg, n2, None, plane=jp)
    got = fm._zy_inv_ct2_call(tr, ti, Wy, ABg, n2, plane=tp)
    assert _rel(ref, got) <= TOL_PASS
    ref = jfm._zy_inv_ct2_call_dual(jr, ji, Wyg, AB, Wy, ABg, n2, None,
                                    planeA=jp)
    got = fm._zy_inv_ct2_call_dual(tr, ti, Wyg, AB, Wy, ABg, n2, planeA=tp)
    assert len(got) == 2
    for r, g in zip(ref, got):
        assert _rel(r, g) <= TOL_PASS


# --- (c) the public ct2 operators against numpy ------------------------------

def _unpermute(a, shape):
    px, py = fm._ct_permute(shape[0]), fm._ct_permute(shape[1])
    a = a.numpy()[px][:, py]
    if fm._use_zct_fwd(shape[2], shape[2] // 2):
        a = a[..., fm._zct_perm(shape[2])]
    return a


def test_public_ct2_operators_match_numpy():
    N0, N1, n2 = SHAPE
    Zm = n2 // 2
    x = np.random.RandomState(1).normal(size=SHAPE).astype('f4')
    r, i, nqr, nqi = fm.fft3_real_forward_half_ct2(torch.from_numpy(x))
    spec = np.fft.rfftn(x.astype('f8')) / x.size
    for got, want in ((_unpermute(r, SHAPE), spec.real[..., :Zm]),
                      (_unpermute(i, SHAPE), spec.imag[..., :Zm]),
                      (nqr.numpy(), spec.real[..., Zm]),
                      (nqi.numpy(), spec.imag[..., Zm])):
        assert np.abs(got - want).max() <= TOL_NUMPY * np.abs(spec).max()

    kd = (_kvec(N0), _kvec(N1), _kvec(n2, half=True))
    k2 = tuple(tuple(float(v) for v in (np.asarray(t) ** 2).astype('f4'))
               for t in (np.fft.fftfreq(N0) * 7, np.fft.fftfreq(N1) * 5,
                         np.fft.rfftfreq(n2) * 3))
    kk = (np.asarray(k2[0])[:, None, None] + np.asarray(k2[1])[None, :, None]
          + np.asarray(k2[2])[None, None, :])
    invk2 = np.where(kk > 0, 1.0 / np.where(kk > 0, kk, 1.0), 0.0)
    kgrid = np.meshgrid(*[np.asarray(k) for k in kd], indexing='ij')
    forces = fm.fft3_real_inverse_grad3_half_ct2(r, i, nqr, nqi, n2=n2,
                                                 kvecs=kd, poisson_k2=k2)
    for d in range(3):
        want = np.fft.irfftn(1j * kgrid[d] * spec * invk2, s=SHAPE,
                             axes=(0, 1, 2)) * x.size
        assert _rel(want, forces[d]) <= TOL_NUMPY * 10
        only = fm.fft3_real_inverse_grad3_half_ct2(
            r, i, nqr, nqi, n2=n2, kvecs=kd, poisson_k2=k2, only=d)
        assert torch.equal(only, forces[d])
    phi = fm.fft3_poisson_half_ct2(r, i, nqr, nqi, n2=n2, poisson_k2=k2)
    want = np.fft.irfftn(-spec * invk2, s=SHAPE, axes=(0, 1, 2)) * x.size
    assert _rel(want, phi) <= TOL_NUMPY * 10


# --- (d) the slice against the JAX package -------------------------------------

def _solvers(shape=SHAPE):
    jpm = JaxPM(Nmesh=list(shape), BoxSize=np.asarray(shape, float),
                dtype='f4')
    tpm = convert.particlemesh_from(jpm.Nmesh, jpm.BoxSize, jpm.dtype,
                                    jpm.resampler, device='cpu')
    return jfastpm.Solver(jpm), tfastpm.Solver(tpm)


@pytest.mark.parametrize("mode", ['spectral', 'gradient'])
def test_force_lattice_mxu_matches_jax(mode):
    js, ts = _solvers()
    rng = np.random.RandomState(3)
    disp = [rng.uniform(0, 1, SHAPE).astype('f4') for _ in range(3)]
    ref = js.force_lattice(tuple(map(jnp.asarray, disp)), bounds=(0., 1.),
                           mode=mode, fft='xla')
    got = ts.force_lattice(tuple(map(torch.from_numpy, disp)),
                           bounds=(0., 1.), mode=mode, fft='mxu')
    for r, g in zip(ref, got):
        assert g.dtype == torch.float32
        assert _rel(r, g) <= TOL_FORCE


@pytest.mark.parametrize("mode", ['spectral', 'gradient'])
def test_force_binned_mxu_matches_jax(mode):
    js, ts = _solvers()
    rng = np.random.RandomState(17)
    ds = tuple(tuple(rng.uniform(-0.5, 1.5, SHAPE).astype('f4')
                     for _ in range(3)) for _ in range(2))
    va = tuple((rng.uniform(size=SHAPE) < f).astype('f4') for f in (0.9, 0.3))
    jds = tuple(tuple(map(jnp.asarray, d)) for d in ds)
    ref = js.force_binned(jds, tuple(map(jnp.asarray, va)), (-0.5, 1.5),
                          fft='xla', mode=mode)
    tds, tva = convert.binned_state_from_numpy((ds, va), device='cpu')
    got = ts.force_binned(tds, tva, (-0.5, 1.5), fft='mxu', mode=mode)
    assert len(got) == 2
    tol = TOL_FORCE if mode == 'spectral' else TOL_FORCE_BINNED_GRADIENT
    for rk, gk, v in zip(ref, got, va):
        for r, g in zip(rk, gk):
            # invalid slots read garbage: compare where a particle sits
            m = v > 0
            assert np.abs(np.asarray(r)[m] - g.numpy()[m]).max() \
                <= tol * np.abs(np.asarray(r)[m]).max()


def test_nbody_lattice_mxu_matches_jax():
    js, ts = _solvers()
    noise = np.random.RandomState(10).normal(size=SHAPE).astype('f4')
    dk = js.pm.create(type='real', value=jnp.asarray(noise)).r2c().apply(
        lambda k, v: v * 0.3 * jnp.where(
            k.normp(2) > 0, k.normp(2, zeromode=1.0) ** -0.375, 0.0))
    S0, V0 = js.lpt_lattice(dk, 0.1, order=2)
    steps = np.linspace(0.1, 0.4, 4)   # 3 KDK steps
    S1, V1 = js.nbody_lattice(S0, V0, steps, bounds=(-1.0, 1.0), fft='xla')
    tS0, tV0 = convert.lattice_state_from_numpy(
        [np.asarray(s) for s in S0], [np.asarray(v) for v in V0],
        device='cpu')
    S2, V2 = ts.nbody_lattice(tS0, tV0, steps, bounds=(-1.0, 1.0), fft='mxu')
    smax = max(float(np.abs(np.asarray(s)).max()) for s in S1)
    vmax = max(float(np.abs(np.asarray(v)).max()) for v in V1)
    assert 0.05 < smax < 1.0    # evolved, and inside the bounds
    for a, b in zip(S1, S2):
        assert np.abs(np.asarray(a) - b.numpy()).max() <= TOL_NBODY * smax
    for a, b in zip(V1, V2):
        assert np.abs(np.asarray(a) - b.numpy()).max() <= TOL_NBODY * vmax


# --- (e) what the path refuses -----------------------------------------------

def test_mxu_refusals():
    _, ts = _solvers((16, 16, 16))
    disp = tuple(torch.full((16,) * 3, 0.5) for _ in range(3))
    dsl, valid = tbn.from_lattice(disp, nslots=1)
    # the bf16 modes run (dense passes at this shape) and give f32 meshes:
    # a uniform lattice feels no force
    for fft in ('mxu_bf16', 'mxu_bf16s'):
        for mode in ('spectral', 'gradient'):
            F = ts.force_lattice(disp, (0.0, 1.0), mode=mode, fft=fft)
            Fb = ts.force_binned(dsl, valid, (0.0, 1.0), mode=mode, fft=fft)
            for f in F + Fb[0]:
                assert f.dtype == torch.float32 and f.shape == (16,) * 3
                assert float(f.abs().max()) < 1e-5
    with pytest.raises(ValueError, match='unknown fft'):
        ts.force_lattice(disp, (0.0, 1.0), fft='mxu_fp8')
    # not a ct2 shape: the spectral triple runs the dense DFT passes
    # (kernel-table rows 3 and 4); a uniform lattice feels no force
    F = ts.force_lattice(disp, (0.0, 1.0), fft='mxu')
    assert all(float(f.abs().max()) < 1e-6 for f in F)
    with pytest.raises(ValueError, match='ct2'):
        fm.fft3_real_forward_half_ct2(torch.zeros(16, 16, 16))
    x = torch.zeros(SHAPE)
    r, i, nqr, nqi = fm.fft3_real_forward_half_ct2(x)
    bad = (tuple([1.0] * SHAPE[0]), _kvec(SHAPE[1]), _kvec(SHAPE[2], True))
    with pytest.raises(ValueError, match='Nyquist'):
        fm.fft3_real_inverse_grad3_half_ct2(r, i, nqr, nqi, SHAPE[2], bad)
    # impl='cuda' on CPU tensors raises; nothing falls back
    with pytest.raises(ValueError, match="impl='cuda'"):
        fm.fft3_real_forward_half_ct2(x, impl='cuda')
    with pytest.raises(ValueError, match="impl='cuda'"):
        fm._xct_call_multi(r, i, fm._ct_inv_mats_np(SHAPE[0]), 1.0,
                           inverse=True, impl='cuda')


def test_mxu_gradient_off_ct2_takes_the_field_path():
    _, ts = _solvers((16, 16, 16))
    rng = np.random.RandomState(4)
    disp = tuple(torch.from_numpy(rng.uniform(0, 1, (16,) * 3).astype('f4'))
                 for _ in range(3))
    got = ts.force_lattice(disp, (0.0, 1.0), mode='gradient', fft='mxu')
    ref = ts.force_lattice(disp, (0.0, 1.0), mode='gradient', fft='xla')
    for r, g in zip(ref, got):
        assert torch.equal(r, g)


def test_mxu_spectral_refuses_f64():
    jpm = JaxPM(Nmesh=list(SHAPE), BoxSize=np.asarray(SHAPE, float),
                dtype='f8')
    tpm = convert.particlemesh_from(jpm.Nmesh, jpm.BoxSize, jpm.dtype,
                                    jpm.resampler, device='cpu')
    ts = tfastpm.Solver(tpm)
    disp = tuple(torch.full(SHAPE, 0.5, dtype=torch.float64)
                 for _ in range(3))
    for fft in ('mxu', 'mxu_bf16', 'mxu_bf16s'):
        with pytest.raises(ValueError, match='f32'):
            ts.force_lattice(disp, (0.0, 1.0), fft=fft)


def test_fft_mxu_cuda_wrappers_refuse_cpu_tensors():
    from pmesh_tpu_torch.ops import fft_mxu_cuda
    x = torch.zeros((2, 256, 16))
    r, i = torch.zeros((2, 256, 8)), torch.zeros((2, 256, 8))
    wy, AB = fm._ct_inv_mats_np(256), fm._z_inv_tabs(16, 8)
    before = dict(fft_mxu_cuda.LAUNCHES)
    with pytest.raises(ValueError, match='CUDA tensors'):
        fft_mxu_cuda.zy_fwd_ct2(x, fm._z_fwd_tabs(16, 8),
                                fm._ct_fwd_mats_np(256))
    with pytest.raises(ValueError, match='CUDA tensors'):
        fft_mxu_cuda.xct_multi(torch.zeros((256, 2, 8)),
                               torch.zeros((256, 2, 8)), wy, 1.0,
                               inverse=True)
    with pytest.raises(ValueError, match='CUDA tensors'):
        fft_mxu_cuda.zy_inv_ct2(r, i, wy, AB, 16)
    with pytest.raises(ValueError, match='CUDA tensors'):
        fft_mxu_cuda.zy_inv_ct2_dual(r, i, wy, AB, wy, AB, 16)
    assert fft_mxu_cuda.LAUNCHES == before
    fft_mxu_cuda.reset_launches()
    assert set(fft_mxu_cuda.LAUNCHES.values()) == {0}
