"""The port's FastPM lattice path (pmesh_tpu_torch.models) against the
JAX package's, on the same numpy inputs (f32 meshes at 16^3; the
cosmology and coefficients in f64).

Tolerances: the force triple 2e-5 of max|ref| (as in
test_fft_mxu.test_ct_force_lattice_end_to_end), lpt_lattice 1e-5,
three KDK steps 1e-4 of max|S|; host-side f64 tables rtol 1e-10.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pmesh_tpu import ParticleMesh as JaxPM
from pmesh_tpu.models import cosmology as jcosmo
from pmesh_tpu.models import fastpm as jfastpm
from pmesh_tpu_torch import convert
from pmesh_tpu_torch.models import cosmology as tcosmo
from pmesh_tpu_torch.models import fastpm as tfastpm

torch.set_num_threads(1)

N = 16


def _rel(ref, got):
    ref = np.asarray(ref)
    got = got.numpy()
    assert ref.shape == got.shape
    return np.abs(ref - got).max() / np.abs(ref).max()


def _solvers(resampler='cic'):
    jpm = JaxPM(Nmesh=[N] * 3, BoxSize=64.0, dtype='f4',
                resampler=resampler)
    tpm = convert.particlemesh_from(jpm.Nmesh, jpm.BoxSize, jpm.dtype,
                                    jpm.resampler, device='cpu')
    return jfastpm.Solver(jpm), tfastpm.Solver(tpm)


def _dlinear(js, ts, amplitude):
    """a power-law (|delta_k| ~ k^-0.75) linear field from seeded
    white noise, on both sides"""
    rng = np.random.RandomState(10)
    noise = rng.normal(size=(N,) * 3).astype('f4')
    dk = js.pm.create(type='real', value=jnp.asarray(noise)).r2c().apply(
        lambda k, v: v * amplitude * jnp.where(
            k.normp(2) > 0, k.normp(2, zeromode=1.0) ** -0.375, 0.0))
    return dk, convert.field_from_numpy(ts.pm, np.asarray(dk.value))


@pytest.mark.parametrize("name", ['E', 'D1', 'f1', 'D2', 'f2', 'Gp', 'gp',
                                  'Gf', 'gf'])
def test_cosmology_matches_jax(name):
    a = np.array([0.05, 0.1, 0.37, 0.8, 1.0, 1.5])
    ref = np.array([float(getattr(jcosmo.Planck15, name)(x)) for x in a])
    got = np.array([getattr(tcosmo.Planck15, name)(x) for x in a])
    assert all(isinstance(getattr(tcosmo.Planck15, name)(x), float)
               for x in a)
    np.testing.assert_allclose(got, ref, rtol=1e-10)


@pytest.mark.parametrize("scheme", ['symp2', 'symp1'])
@pytest.mark.parametrize("factors", ['fastpm', 'quinn', 'tve', 'vte',
                                     'naive'])
def test_leapfrog_factors_match_jax(factors, scheme):
    cosmo = dict(Om0=0.27, Ol0=0.73, h=0.7, sigma8=0.8, ns=0.96,
                 Ob0=0.045)
    jc = jcosmo.Cosmology(**cosmo)
    tc = convert.cosmology_from(**cosmo)
    steps = np.linspace(0.1, 1.0, 5)
    ref = jfastpm.leapfrog_factors(steps, jfastpm._FACTORS[factors](jc),
                                   scheme)
    got = tfastpm.leapfrog_factors(steps, tfastpm._FACTORS[factors](tc),
                                   scheme)
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g, np.asarray(r), rtol=1e-10,
                                   atol=1e-300)


@pytest.mark.parametrize("mode", ['spectral', 'gradient'])
def test_force_lattice_matches_jax(mode):
    js, ts = _solvers()
    rng = np.random.RandomState(11)
    disp = [rng.uniform(-0.5, 0.8, (N,) * 3).astype('f4')
            for _ in range(3)]
    ref = js.force_lattice(tuple(jnp.asarray(d) for d in disp),
                           bounds=(-0.5, 0.8), mode=mode, fft='xla')
    got = ts.force_lattice(tuple(torch.from_numpy(d) for d in disp),
                           bounds=(-0.5, 0.8), mode=mode, fft='xla')
    for r, g in zip(ref, got):
        assert g.dtype == torch.float32
        assert _rel(r, g) <= 2e-5


@pytest.mark.parametrize("order", [1, 2])
def test_lpt_lattice_matches_jax(order):
    js, ts = _solvers()
    jdl, tdl = _dlinear(js, ts, 3.0)
    ref = js.lpt_lattice(jdl, 0.1, order=order)
    got = ts.lpt_lattice(tdl, 0.1, order=order)
    for r, g in zip(ref[0] + ref[1], got[0] + got[1]):
        assert _rel(r, g) <= 1e-5


@pytest.mark.parametrize("force_mode", ['spectral', 'gradient'])
def test_nbody_lattice_matches_jax(force_mode):
    js, ts = _solvers()
    jdl, _ = _dlinear(js, ts, 0.3)
    S0, V0 = js.lpt_lattice(jdl, 0.1, order=2)
    tS0, tV0 = convert.lattice_state_from_numpy(
        [np.asarray(s) for s in S0], [np.asarray(v) for v in V0],
        device='cpu')
    steps = np.linspace(0.1, 0.4, 4)   # 3 KDK steps
    S1, V1 = js.nbody_lattice(S0, V0, steps, bounds=(-1.0, 1.0),
                              force_mode=force_mode)
    S2, V2 = ts.nbody_lattice(tS0, tV0, steps, bounds=(-1.0, 1.0),
                              force_mode=force_mode)
    smax = max(float(np.abs(np.asarray(s)).max()) for s in S1)
    vmax = max(float(np.abs(np.asarray(v)).max()) for v in V1)
    assert 0.05 < smax < 1.0    # evolved, and inside the bounds
    for a, b in zip(S1, S2):
        assert np.abs(np.asarray(a) - b.numpy()).max() <= 1e-4 * smax
    for a, b in zip(V1, V2):
        assert np.abs(np.asarray(a) - b.numpy()).max() <= 1e-4 * vmax
    # the inputs are not modified
    np.testing.assert_array_equal(tS0[0].numpy(), np.asarray(S0[0]))


def test_nbody_lattice_poisons_in_loop():
    """Strong outward velocities cross the upper bound after a few
    drifts: the port poisons S and V with NaN, as the JAX package does,
    while the same run inside wide bounds stays finite."""
    js, ts = _solvers()
    rng = np.random.RandomState(12)
    disp = [rng.uniform(-0.4, 0.6, (N,) * 3).astype('f4')
            for _ in range(3)]
    vel = [rng.uniform(0.4, 0.5, (N,) * 3).astype('f4') for _ in range(3)]
    steps = np.linspace(0.1, 0.5, 6)
    jS, jV = js.nbody_lattice(tuple(map(jnp.asarray, disp)),
                              tuple(map(jnp.asarray, vel)), steps,
                              bounds=(-0.5, 0.8))
    tS0, tV0 = convert.lattice_state_from_numpy(disp, vel, device='cpu')
    S, V = ts.nbody_lattice(tS0, tV0, steps, bounds=(-0.5, 0.8))
    assert not np.isfinite(np.asarray(jS[0])).all()
    assert not torch.isfinite(S[0]).all() and not torch.isfinite(V[0]).all()
    assert not torch.isfinite(V[2]).any()
    S2, V2 = ts.nbody_lattice(tS0, tV0, steps, bounds=(-2.0, 9.0))
    assert all(torch.isfinite(s).all() for s in S2 + V2)


def test_force_lattice_refuses_mxu_and_boost():
    _, ts = _solvers()
    disp = tuple(torch.zeros((N,) * 3) for _ in range(3))
    # fft='mxu' and its bf16 modes run at this shape, which is not ct2
    # (the dense DFT passes): a uniform lattice feels no force, and the
    # meshes are f32
    F = ts.force_lattice(disp, (0.0, 1.0), fft='mxu')
    assert all(float(f.abs().max()) < 1e-6 for f in F)
    for fft in ('mxu_bf16', 'mxu_bf16s'):
        F = ts.force_lattice(disp, (0.0, 1.0), fft=fft)
        assert all(f.dtype == torch.float32 and float(f.abs().max()) < 1e-5
                   for f in F)
    with pytest.raises(ValueError):
        ts.force_lattice(disp, (0.0, 1.0), fft='cufft')
    with pytest.raises(ValueError):
        tfastpm.Solver(ts.pm, B=2).force_lattice(disp, (0.0, 1.0))


def test_solver_force_mesh_is_cic():
    js, ts = _solvers(resampler='tsc')
    assert ts.fpm.resampler.kind == js.fpm.resampler.kind == 'tunedcic'
    assert ts.pm.resampler.kind == js.pm.resampler.kind == 'tunedtsc'
