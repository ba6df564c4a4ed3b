"""The port's dense DFT passes of fft='mxu' (kernel-table rows 3 and 4:
``fft3_real_forward_half`` and ``fft3_real_inverse_grad3_half``) and the
fft='mxu' path at shapes that are not ct2, against the JAX package.

The shapes are not ct2: an even cube (16^3), an odd z (24, 20, 15) and
odd x and y lengths (15, 12, 10).

- the gradient tables: bitwise equal to the JAX package's numpy tables;
- each plain pass against the Pallas kernel of the same body, run in
  interpret mode on the CPU as the JAX package's tests run it
  (``_zy_fwd_half_call``, ``_xpass_half_call`` and ``_zy_inv_half_call``
  run ``_zy_forward_real_h``, ``_x_transform`` and
  ``_zy_inverse_to_real_h``, the bodies of rows 3 and 4): 3e-6 of
  max|ref| (f32 matmuls summed in another order);
- the public operators against numpy's rfftn/irfftn at the three
  shapes and against JAX's at the odd-z one: 3e-6 of max|ref|;
- the slice at 16^3: force_lattice and force_binned with fft='mxu'
  against the JAX package's fft='mxu', 2e-5 of max|ref|; three KDK
  steps 1e-4 of max|S|; an adaptive binned run (slot growth, fold,
  rebase) with fft='mxu' against the JAX package's adaptive run on the
  same inputs and against the port's fft='xla' run: density 1e-5 of
  max, counts, slots and overflow exact.  The JAX side of the adaptive
  run takes fft='xla': its own adaptive loop with fft='mxu' runs the
  Pallas kernels in interpret mode, 74 s at 16^3 op by op and longer
  jitted, past this file's budget.

Each JAX comparison at a new shape compiles the Pallas kernels in
interpret mode (1-6 s), so the cases are few: this file runs in about
40 s in one process, plus about 35 s for the JAX package's adaptive
binned run op by op.
"""
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pmesh_tpu import ParticleMesh as JaxPM
from pmesh_tpu.models import fastpm as jfastpm
from pmesh_tpu.ops import binned as jbn
from pmesh_tpu.ops import fft_mxu as jfm
from pmesh_tpu_torch import convert
from pmesh_tpu_torch.models import fastpm as tfastpm
from pmesh_tpu_torch.ops import binned as tbn
from pmesh_tpu_torch.ops import fft_mxu as fm

torch.set_num_threads(1)

CPU = 'cpu'     # the port runs on the card unless told otherwise
TOL_PASS = 3e-6
TOL_FORCE = 2e-5
TOL_NBODY = 1e-4
TOL_DENSITY = 1e-5
SHAPES = [(16, 16, 16), (24, 20, 15), (15, 12, 10)]


def _rel(ref, got):
    ref = np.asarray(ref)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert ref.shape == got.shape
    return np.abs(ref - got).max() / np.abs(ref).max()


def _kvec(n, half=False):
    """a SuperLanczos-shaped table, zero at Nyquist, as a tuple"""
    w = (np.fft.rfftfreq(n) if half else np.fft.fftfreq(n)) * 2 * np.pi
    return tuple(((8 * np.sin(w) - np.sin(2 * w)) / 6.0).tolist())


def _normal(seed, shape, n=1):
    rng = np.random.RandomState(seed)
    return [rng.normal(size=shape).astype('f4') for _ in range(n)]


# --- (a) the tables ----------------------------------------------------------

@pytest.mark.parametrize("n", [15, 16, 33])
def test_dense_tables_bitwise(n):
    kv = _kvec(n)
    for side in ('left', 'right'):
        ref = jfm._fold_i_freq(*jfm._dft_np(n, +1), kv, side)
        got = fm._fold_i_freq(*fm._dft_np(n, +1), kv, side)
        for r, g in zip(ref, got):
            assert r.dtype == g.dtype and np.array_equal(r, g)
    for r, g in zip(jfm._fold_i_freq(*jfm._dft_np(n, +1), kv, 'right'),
                    fm._dft_fold_np(n, kv)):
        assert np.array_equal(r, g)
    zh = n // 2 + 1
    for kw in ({}, dict(grad_kvec=_kvec(n, half=True))):
        for r, g in zip(jfm._irfft_mats_np(n, zh, **kw),
                        fm._irfft_mats_np(n, zh, **kw)):
            assert np.array_equal(r, g)
    for r, g in zip(jfm._dft_half_np(n, zh), fm._dft_half_np(n, zh)):
        assert np.array_equal(r, g)


# --- (b) each plain pass against the Pallas kernel (interpret mode) ----------

@pytest.mark.parametrize("shape", SHAPES)
def test_zy_fwd_half_plain_matches_jax(shape):
    n0, N1, N2 = shape
    Zh = N2 // 2 + 1
    (x,) = _normal(1, shape)
    wz, wy = fm._dft_half_np(N2, Zh), fm._dft_np(N1, -1)
    ref = jfm._zy_fwd_half_call(jnp.asarray(x), N2, Zh,
                                *map(jnp.asarray, wz + wy), None)
    got = fm._zy_fwd_dense_call(torch.from_numpy(x), wz, wy)
    assert len(got) == 2
    for r, g in zip(ref, got):
        assert _rel(r, g) <= TOL_PASS


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("case", ['forward', 'inverse_kx',
                                  'inverse_dual_k2'])
def test_x_dense_plain_matches_jax(shape, case):
    """the x pass; the dual (plain inverse table and k_x-folded one)
    with the 1/k^2 fold against two Pallas x passes of the input
    filtered the JAX package's way (fastpm.py's elementwise 1/k^2 before
    fft3_real_inverse_grad3_half)"""
    N0, n1, W = shape
    pr, pi = _normal(2, shape, 2)
    wf, wi = fm._dft_np(N0, -1), fm._dft_np(N0, +1)
    wg = fm._dft_fold_np(N0, _kvec(N0))
    jr, ji = jnp.asarray(pr), jnp.asarray(pi)

    def jax_pass(w, scale, a=jr, b=ji):
        return jfm._xpass_half_call(a, b, *map(jnp.asarray, w), scale, None)

    if case == 'inverse_dual_k2':
        rng = np.random.RandomState(3)
        k2 = [rng.uniform(0.0, 2.0, n).astype('f4') for n in shape]
        for t in k2:
            t[0] = 0.0    # the DC mode: 1/k^2 -> 0
        kk = (jnp.asarray(k2[0])[:, None, None]
              + jnp.asarray(k2[1])[None, :, None]
              + jnp.asarray(k2[2])[None, None, :])
        invk2 = jnp.where(kk > 0, 1.0 / jnp.where(kk > 0, kk, 1.0), 0.0)
        ref = (jax_pass(wi, 1.0, jr * invk2, ji * invk2)
               + jax_pass(wg, 1.0, jr * invk2, ji * invk2))
        got = fm._x_dense_call(torch.from_numpy(pr), torch.from_numpy(pi),
                               wi, 1.0, wx2=wg, k2=k2)
    else:
        w, scale = {'forward': (wf, 1.0 / (N0 * 37)),
                    'inverse_kx': (wg, 1.0)}[case]
        ref = jax_pass(w, scale)
        got = fm._x_dense_call(torch.from_numpy(pr), torch.from_numpy(pi),
                               w, scale)
    assert len(got) == len(ref)
    for r, g in zip(ref, got):
        assert _rel(r, g) <= TOL_PASS


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("tables", ['ky', 'kz'])
def test_zy_inv_half_plain_matches_jax(shape, tables):
    """the fy tables (k_y-folded y, plain z) and the fz tables (plain y,
    k_z-folded z): together every table the force triple uses"""
    n0, N1, n2 = shape
    Zh = n2 // 2 + 1
    rr, ii = _normal(4, (n0, N1, Zh), 2)
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


# --- (c) the public operators ------------------------------------------------

def _kd(shape):
    N0, N1, n2 = shape
    return (_kvec(N0), _kvec(N1), _kvec(n2, half=True))


def test_dense_operators_match_jax():
    shape = (24, 20, 15)
    (x,) = _normal(5, shape)
    r, i = fm.fft3_real_forward_half(torch.from_numpy(x))
    for ref, got in zip(jfm.fft3_real_forward_half(jnp.asarray(x)), (r, i)):
        assert _rel(ref, got) <= TOL_PASS
    tri = fm.fft3_real_inverse_grad3_half(r, i, shape[2], _kd(shape))
    ref = jfm.fft3_real_inverse_grad3_half(jnp.asarray(r.numpy()),
                                           jnp.asarray(i.numpy()),
                                           n2=shape[2], kvecs=_kd(shape))
    for d in range(3):
        assert _rel(ref[d], tri[d]) <= TOL_PASS


@pytest.mark.parametrize("shape", SHAPES)
def test_dense_operators_match_numpy(shape):
    N0, N1, n2 = shape
    (x,) = _normal(5, shape)
    r, i = fm.fft3_real_forward_half(torch.from_numpy(x))
    spec = np.fft.rfftn(x.astype('f8')) / x.size
    for got, want in ((r, spec.real), (i, spec.imag)):
        assert np.abs(got.numpy() - want).max() \
            <= TOL_PASS * np.abs(spec).max()

    kd = _kd(shape)
    tri = fm.fft3_real_inverse_grad3_half(r, i, n2, kd)
    kgrid = np.meshgrid(*[np.asarray(k) for k in kd], indexing='ij')
    for d in range(3):
        want = np.fft.irfftn(1j * kgrid[d] * spec, s=shape,
                             axes=(0, 1, 2)) * x.size
        assert _rel(want, tri[d]) <= TOL_PASS

    # the 1/k^2 fold
    k2 = tuple(tuple(float(v) for v in (np.asarray(t) ** 2).astype('f4'))
               for t in (np.fft.fftfreq(N0) * 7, np.fft.fftfreq(N1) * 5,
                         np.fft.rfftfreq(n2) * 3))
    kk = (np.asarray(k2[0])[:, None, None] + np.asarray(k2[1])[None, :, None]
          + np.asarray(k2[2])[None, None, :])
    invk2 = np.where(kk > 0, 1.0 / np.where(kk > 0, kk, 1.0), 0.0)
    forces = fm.fft3_real_inverse_grad3_half(r, i, n2, kd, poisson_k2=k2)
    for d in range(3):
        want = np.fft.irfftn(1j * kgrid[d] * spec * invk2, s=shape,
                             axes=(0, 1, 2)) * x.size
        assert _rel(want, forces[d]) <= TOL_PASS


def test_dense_operators_refuse():
    shape = (16, 12, 10)
    r, i = fm.fft3_real_forward_half(torch.zeros(shape))
    kd = (_kvec(16), _kvec(12), _kvec(10, half=True))
    for bad in ((tuple([1.0] * 16),) + kd[1:],
                (kd[0], tuple([1.0] * 12), kd[2])):
        with pytest.raises(ValueError, match='Nyquist'):
            fm.fft3_real_inverse_grad3_half(r, i, 10, bad)
    with pytest.raises(ValueError, match='length Zh=6'):
        fm.fft3_real_inverse_grad3_half(r, i, 10, kd[:2] + (_kvec(10),))
    with pytest.raises(ValueError, match='n2=12'):
        fm.fft3_real_inverse_grad3_half(r, i, 12, kd)
    with pytest.raises(ValueError, match='poisson_k2'):
        fm.fft3_real_inverse_grad3_half(r, i, 10, kd,
                                        poisson_k2=kd[:2] + (_kvec(10),))
    # odd lengths have no Nyquist index: any x or y table is taken
    r5, i5 = fm.fft3_real_forward_half(torch.zeros((15, 12, 10)))
    fm.fft3_real_inverse_grad3_half(r5, i5, 10, (tuple([1.0] * 15),) + kd[1:])
    # impl='cuda' on CPU tensors raises; nothing falls back
    with pytest.raises(ValueError, match="impl='cuda'"):
        fm.fft3_real_forward_half(torch.zeros(shape), impl='cuda')
    with pytest.raises(ValueError, match="impl='cuda'"):
        fm.fft3_real_inverse_grad3_half(r, i, 10, kd, impl='cuda')


def test_dense_cuda_wrappers_refuse_cpu_tensors():
    from pmesh_tpu_torch.ops import fft_mxu_cuda
    x = torch.zeros((4, 6, 10))
    r, i = torch.zeros((4, 6, 6)), torch.zeros((4, 6, 6))
    before = dict(fft_mxu_cuda.LAUNCHES)
    with pytest.raises(ValueError, match='CUDA tensors'):
        fft_mxu_cuda.zy_fwd_half(x, fm._dft_half_np(10, 6), fm._dft_np(6, -1))
    with pytest.raises(ValueError, match='CUDA tensors'):
        fft_mxu_cuda.x_dense(r, i, fm._dft_np(4, +1), 1.0)
    with pytest.raises(ValueError, match='CUDA tensors'):
        fft_mxu_cuda.zy_inv_half(r, i, fm._dft_np(6, +1),
                                 fm._irfft_mats_np(10, 6))
    assert fft_mxu_cuda.LAUNCHES == before


# --- (d) the slice against the JAX package, at 16^3 --------------------------

def _solvers(shape):
    jpm = JaxPM(Nmesh=list(shape), BoxSize=np.asarray(shape, float),
                dtype='f4')
    tpm = convert.particlemesh_from(jpm.Nmesh, jpm.BoxSize, jpm.dtype,
                                    jpm.resampler, device=CPU)
    return jfastpm.Solver(jpm), tfastpm.Solver(tpm)


def test_force_lattice_dense_mxu_matches_jax():
    shape = (16, 16, 16)
    js, ts = _solvers(shape)
    assert not fm.is_ct2(shape)
    rng = np.random.RandomState(6)
    disp = [rng.uniform(0, 1, shape).astype('f4') for _ in range(3)]
    ref = js.force_lattice(tuple(map(jnp.asarray, disp)), bounds=(0., 1.),
                           fft='mxu')
    got = ts.force_lattice(tuple(map(torch.from_numpy, disp)),
                           bounds=(0., 1.), fft='mxu')
    for r, g in zip(ref, got):
        assert g.dtype == torch.float32
        assert _rel(r, g) <= TOL_FORCE


def test_force_binned_dense_mxu_matches_jax():
    shape = (16, 16, 16)
    js, ts = _solvers(shape)
    rng = np.random.RandomState(7)
    ds = tuple(tuple(rng.uniform(-0.5, 1.5, shape).astype('f4')
                     for _ in range(3)) for _ in range(2))
    va = tuple((rng.uniform(size=shape) < f).astype('f4') for f in (0.9, 0.3))
    jds = tuple(tuple(map(jnp.asarray, d)) for d in ds)
    ref = js.force_binned(jds, tuple(map(jnp.asarray, va)), (-0.5, 1.5),
                          fft='mxu')
    tds, tva = convert.binned_state_from_numpy((ds, va), device=CPU)
    got = ts.force_binned(tds, tva, (-0.5, 1.5), fft='mxu')
    assert len(got) == 2
    for rk, gk, v in zip(ref, got, va):
        for r, g in zip(rk, gk):
            # invalid slots read garbage: compare where a particle sits
            m = v > 0
            assert np.abs(np.asarray(r)[m] - g.numpy()[m]).max() \
                <= TOL_FORCE * np.abs(np.asarray(r)[m]).max()


def test_nbody_lattice_dense_mxu_matches_jax():
    shape = (16, 16, 16)
    js, ts = _solvers(shape)
    (noise,) = _normal(8, shape)
    dk = js.pm.create(type='real', value=jnp.asarray(noise)).r2c().apply(
        lambda k, v: v * 0.3 * jnp.where(
            k.normp(2) > 0, k.normp(2, zeromode=1.0) ** -0.375, 0.0))
    S0, V0 = js.lpt_lattice(dk, 0.1, order=2)
    steps = np.linspace(0.1, 0.4, 4)   # 3 KDK steps
    S1, V1 = js.nbody_lattice(S0, V0, steps, bounds=(-1.0, 1.0), fft='mxu')
    tS0, tV0 = convert.lattice_state_from_numpy(
        [np.asarray(s) for s in S0], [np.asarray(v) for v in V0], device=CPU)
    S2, V2 = ts.nbody_lattice(tS0, tV0, steps, bounds=(-1.0, 1.0), fft='mxu')
    smax = max(float(np.abs(np.asarray(s)).max()) for s in S1)
    vmax = max(float(np.abs(np.asarray(v)).max()) for v in V1)
    assert 0.05 < smax < 1.0    # evolved, and inside the bounds
    for a, b in zip(S1, S2):
        assert np.abs(np.asarray(a) - b.numpy()).max() <= TOL_NBODY * smax
    for a, b in zip(V1, V2):
        assert np.abs(np.asarray(a) - b.numpy()).max() <= TOL_NBODY * vmax


ADAPTIVE_N = 16
ADAPTIVE_KW = dict(nslots=1, rebase_every=2, step_drift=0.5, adaptive=True)


def _adaptive_inputs():
    """a 16^3 state that overflows one slot per cell: the run must grow"""
    n = ADAPTIVE_N
    rng = np.random.RandomState(9)
    disp = [rng.uniform(-0.6, 1.6, (n,) * 3).astype('f4') for _ in range(3)]
    vel = [(0.3 * rng.normal(size=(n,) * 3)).astype('f4') for _ in range(3)]
    return disp, vel, np.linspace(0.5, 0.6, 5)


@functools.lru_cache(maxsize=None)
def _port_adaptive(fft):
    """the port's adaptive binned run: (density, count, max occupancy,
    overflow, K, growth events)"""
    _, ts = _solvers((ADAPTIVE_N,) * 3)
    disp, vel, steps = _adaptive_inputs()
    d, v = convert.lattice_state_from_numpy(disp, vel, device=CPU)
    ds, _, va, ov = ts.nbody_binned(d, v, steps, fft=fft, **ADAPTIVE_KW)
    tot, occ = tbn.occupancy(va)
    return (tbn.paint_binned(ds, va, bounds=(-1.0, 2.0)).numpy(), int(tot),
            float(occ), int(ov), len(ds),
            ts.last_binned_stats['growth_events'])


def test_nbody_binned_dense_mxu_adaptive_matches_jax():
    """the port's adaptive binned run from K = 1 with fft='mxu' (the
    dense passes at 16^3, slot growth, fold, rebase) against the JAX
    package's nbody_binned(adaptive=True) on the same inputs: the same
    count, occupancy, slot count, growth events and overflow, the
    density to 1e-5.  JAX runs fft='xla' (its fft='mxu' loop runs the
    Pallas kernels in interpret mode, past this file's budget);
    test_force_binned_dense_mxu_matches_jax holds the two FFTs' forces
    to each other"""
    js, _ = _solvers((ADAPTIVE_N,) * 3)
    disp, vel, steps = _adaptive_inputs()
    # op by op (about 35 s): jitted, the KDK chunk at K = 6 compiles
    # for minutes
    with jax.disable_jit():
        jd, _, jva, jov = js.nbody_binned(tuple(map(jnp.asarray, disp)),
                                          tuple(map(jnp.asarray, vel)),
                                          steps, fft='xla', **ADAPTIVE_KW)
    rtot, rocc = jbn.occupancy(jva)
    ref = np.asarray(jbn.paint_binned(jd, jva, bounds=(-1.0, 2.0)))
    got, gtot, gocc, gov, gk, gg = _port_adaptive('mxu')
    assert int(rtot) == gtot == ADAPTIVE_N ** 3 and int(jov) == gov == 0
    assert len(jd) == gk > 1 and float(rocc) == gocc
    assert js.last_binned_stats['growth_events'] == gg >= 1
    assert np.abs(got - ref).max() <= TOL_DENSITY * np.abs(ref).max()


def test_nbody_binned_dense_mxu_adaptive_matches_xla():
    """the same adaptive run with fft='mxu' against the port's fft='xla':
    the same counts, slot count and overflow, the density to 1e-5"""
    ref, rtot, rocc, rov, rk, rg = _port_adaptive('xla')
    got, gtot, gocc, gov, gk, gg = _port_adaptive('mxu')
    assert rtot == gtot == ADAPTIVE_N ** 3 and rov == gov == 0
    assert rk == gk > 1 and rg == gg >= 1 and rocc == gocc
    assert np.abs(got - ref).max() <= TOL_DENSITY * np.abs(ref).max()
