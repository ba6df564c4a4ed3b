"""Reverse mode through the port's lattice path against ``jax.grad`` of
the JAX package on the same numpy inputs (CPU: the plain versions of
the kernels, which the backward calls as the forward does).

- ``paint_grid`` (displacements, a mesh mass, a scalar mass) and
  ``readout_grid`` (meshes, displacements) at 16^3, CIC and TSC, with
  displacements in (0, 1) so that the CIC derivative does not vanish:
  1e-6 of max|JAX| (the backward is the JAX package's custom vjp, the
  same shift sums);
- a diffdir readout differentiates natively on the CPU, as the JAX
  package's XLA version does: 1e-6;
- ``force_lattice`` in spectral mode at 16^3: ``fft='xla'`` against
  JAX's ``xla`` 1e-5, the dense ``fft='mxu'`` against JAX's ``mxu`` 2e-5
  (the DFT products round differently from cuFFT's and pocketfft's
  FFTs); the ct2 ``fft='mxu'`` gradient at (256, 256, 16) against JAX's
  ``fft='xla'`` 5e-4, as ``test_gradient.test_mxu_force_grad_matches_xla``
  holds the JAX package's own; the gradient mode (the ct2 potential and
  the native diffdir rolls) at (256, 256, 16) against JAX's ``xla``,
  5e-4;
- ``nbody_lattice`` (2 KDK steps) with ``fft='xla'`` and ``fft='mxu'``
  (dense) with respect to the initial (disp, vel), and ``lpt_lattice``
  with respect to a real field that is r2c'd first, at 16^3 against
  JAX's ``fft='xla'``: 1e-4 (two steps amplify the f32 differences);
- the transposes of the ``fft='mxu'`` operators: <T a, c> = <a, T^T c>
  for the force triple (dense and ct2) and the potential (ct2), 1e-5 of
  the products' scale.

About 60 s in one process.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pmesh_tpu import ParticleMesh as JaxPM
from pmesh_tpu.models import fastpm as jfastpm
from pmesh_tpu.ops import gridpm as jgp
from pmesh_tpu_torch import convert
from pmesh_tpu_torch.models import fastpm as tfastpm
from pmesh_tpu_torch.ops import gridpm as tgp

torch.set_num_threads(1)

CPU = 'cpu'
N = 16
SHAPE = (N,) * 3
CT2 = (256, 256, 16)
TOL_GRID = 1e-6
TOL_FORCE_XLA = 1e-5
TOL_FORCE_MXU = 2e-5
TOL_CT2 = 5e-4
TOL_RUN = 1e-4
TOL_ADJOINT = 1e-5


def _rel(want, got):
    want = np.asarray(want)
    got = got.detach().numpy()
    assert want.shape == got.shape
    return np.abs(want - got).max() / np.abs(want).max()


def _leaves(values):
    return [torch.tensor(np.asarray(v), requires_grad=True) for v in values]


def _inputs(seed, shape=SHAPE):
    rng = np.random.RandomState(seed)
    disp = [rng.uniform(0, 1, shape).astype('f4') for _ in range(3)]
    mass = (1 + 0.2 * rng.normal(size=shape)).astype('f4')
    meshes = [rng.normal(size=shape).astype('f4') for _ in range(3)]
    # positive weights: the scalar-mass cotangent is a sum without
    # cancellation
    weights = [rng.uniform(0.5, 1.5, shape).astype('f4') for _ in range(3)]
    return disp, mass, meshes, weights


def _solvers(shape):
    jpm = JaxPM(Nmesh=list(shape), BoxSize=np.asarray(shape, float),
                dtype='f4')
    tpm = convert.particlemesh_from(jpm.Nmesh, jpm.BoxSize, jpm.dtype,
                                    jpm.resampler, device=CPU)
    return jfastpm.Solver(jpm), tfastpm.Solver(tpm)


# --- paint and readout --------------------------------------------------------

@pytest.mark.parametrize("window", ['cic', 'tsc'])
@pytest.mark.parametrize("mass_kind", ['mesh', 'scalar'])
def test_paint_grad_matches_jax(window, mass_kind):
    disp, mass, _, (w, _, _) = _inputs(1)
    m = mass if mass_kind == 'mesh' else np.float32(0.7)

    def jloss(d, mm):
        return jnp.sum(jgp.paint_grid(d, mass=mm, window=window) * w)
    gd, gm = jax.grad(jloss, argnums=(0, 1))(tuple(map(jnp.asarray, disp)),
                                            jnp.asarray(m))
    td = _leaves(disp)
    tm = torch.tensor(m, requires_grad=True)
    (tgp.paint_grid(td, mass=tm, window=window)
     * torch.from_numpy(w)).sum().backward()
    for a, b in zip(gd, td):
        assert _rel(a, b.grad) <= TOL_GRID
    assert tm.grad.shape == tm.shape
    assert _rel(gm, tm.grad) <= TOL_GRID


@pytest.mark.parametrize("window", ['cic', 'tsc'])
def test_readout_grad_matches_jax(window):
    disp, _, meshes, weights = _inputs(2)

    def jloss(ms, d):
        out = jgp.readout_grid(ms, d, window=window)
        return sum(jnp.sum(o * w) for o, w in zip(out, weights))
    gm, gd = jax.grad(jloss, argnums=(0, 1))(
        tuple(map(jnp.asarray, meshes)), tuple(map(jnp.asarray, disp)))
    tm, td = _leaves(meshes), _leaves(disp)
    out = tgp.readout_grid(tm, td, window=window)
    sum((o * torch.from_numpy(w)).sum()
        for o, w in zip(out, weights)).backward()
    for a, b in zip(tuple(gm) + tuple(gd), tm + td):
        assert _rel(a, b.grad) <= TOL_GRID


def test_diffdir_readout_grad_is_native_on_cpu():
    """a diffdir readout has no custom rule; on the CPU the plain rolls
    differentiate, as the JAX package's XLA version does"""
    disp, _, meshes, (w, _, _) = _inputs(3)

    def jloss(m, d):
        return jnp.sum(jgp.readout_grid(m, d, window='tsc', diffdir=1) * w)
    gm, gd = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(meshes[0]),
                                            tuple(map(jnp.asarray, disp)))
    (tm,), td = _leaves(meshes[:1]), _leaves(disp)
    (tgp.readout_grid(tm, td, window='tsc', diffdir=1)
     * torch.from_numpy(w)).sum().backward()
    for a, b in zip((gm,) + tuple(gd), [tm] + td):
        assert _rel(a, b.grad) <= TOL_GRID


def test_no_grad_inputs_take_the_plain_path():
    """without tensors that require grad nothing is recorded"""
    disp, mass, meshes, _ = _inputs(4)
    d = tuple(map(torch.from_numpy, disp))
    rho = tgp.paint_grid(d, mass=torch.from_numpy(mass))
    out = tgp.readout_grid(tuple(map(torch.from_numpy, meshes)), d)
    assert rho.grad_fn is None and all(o.grad_fn is None for o in out)
    with torch.no_grad():
        rho = tgp.paint_grid(_leaves(disp))
    assert rho.grad_fn is None


# --- the force ----------------------------------------------------------------

def _force_loss_j(F):
    return jnp.sum(F[0] ** 2 + 2 * F[1] ** 2 + 3 * F[2] ** 2)


def _force_loss_t(F):
    return (F[0] ** 2 + 2 * F[1] ** 2 + 3 * F[2] ** 2).sum()


def _force_grads(shape, fft_jax, fft_port, mode='spectral', seed=5):
    js, ts = _solvers(shape)
    disp = _inputs(seed, shape)[0]
    want = jax.grad(lambda d: _force_loss_j(js.force_lattice(
        d, bounds=(0., 1.), mode=mode, fft=fft_jax)))(
            tuple(map(jnp.asarray, disp)))
    td = _leaves(disp)
    _force_loss_t(ts.force_lattice(td, bounds=(0., 1.), mode=mode,
                                   fft=fft_port)).backward()
    return want, [t.grad for t in td]


@pytest.mark.parametrize("fft,tol", [('xla', TOL_FORCE_XLA),
                                     ('mxu', TOL_FORCE_MXU)])
def test_force_lattice_grad_matches_jax(fft, tol):
    want, got = _force_grads(SHAPE, fft, fft)
    for a, b in zip(want, got):
        assert _rel(a, b) <= tol


@pytest.mark.parametrize("mode", ['spectral', 'gradient'])
def test_force_lattice_ct2_mxu_grad_matches_jax_xla(mode):
    """the ct2 backward: one x pass and one zy inverse per direction
    (only=d) for the triple, the potential itself for gradient mode"""
    want, got = _force_grads(CT2, 'xla', 'mxu', mode=mode, seed=6)
    for a, b in zip(want, got):
        assert _rel(a, b) <= TOL_CT2


# --- the solver loops ---------------------------------------------------------

def _linear(field):
    """the seeded linear-field filter of both packages' tests"""
    def filt(k, v):
        xp = torch if isinstance(v, torch.Tensor) else jnp
        return v * 0.3 * xp.where(k.normp(2) > 0,
                                  k.normp(2, zeromode=1.0) ** -0.375, 0.0)
    return field.r2c().apply(filt)


def _state_loss(S, V, xp_sum):
    return sum(xp_sum(s ** 2) + 2 * xp_sum(v ** 2) for s, v in zip(S, V))


@pytest.fixture(scope="module")
def nbody_ref():
    """JAX's gradient of a 2-step run's loss in the initial state"""
    js, _ = _solvers(SHAPE)
    noise = np.random.RandomState(8).normal(size=SHAPE).astype('f4')
    S0, V0 = js.lpt_lattice(
        _linear(js.pm.create(type='real', value=jnp.asarray(noise))), 0.1,
        order=2)
    steps = np.linspace(0.1, 0.3, 3)

    def loss(S, V):
        S1, V1 = js.nbody_lattice(S, V, steps, bounds=(-1.0, 1.0),
                                  fft='xla')
        return _state_loss(S1, V1, jnp.sum)
    gS, gV = jax.grad(loss, argnums=(0, 1))(S0, V0)
    return S0, V0, steps, gS, gV


@pytest.mark.parametrize("fft", ['xla', 'mxu'])
def test_nbody_lattice_grad_matches_jax(nbody_ref, fft):
    S0, V0, steps, gS, gV = nbody_ref
    _, ts = _solvers(SHAPE)
    tS, tV = _leaves(S0), _leaves(V0)
    S1, V1 = ts.nbody_lattice(tS, tV, steps, bounds=(-1.0, 1.0), fft=fft)
    _state_loss(S1, V1, torch.sum).backward()
    for a, b in zip(tuple(gS) + tuple(gV), tS + tV):
        assert np.isfinite(b.grad.numpy()).all()
        assert _rel(a, b.grad) <= TOL_RUN


def test_lpt_lattice_grad_matches_jax():
    js, ts = _solvers(SHAPE)
    noise = np.random.RandomState(9).normal(size=SHAPE).astype('f4')

    def loss(x):
        S, V = js.lpt_lattice(_linear(js.pm.create(type='real', value=x)),
                              0.1, order=2)
        return _state_loss(S, V, jnp.sum)
    want = jax.grad(loss)(jnp.asarray(noise))
    x = torch.tensor(noise, requires_grad=True)
    S, V = ts.lpt_lattice(_linear(ts.pm.create(type='real', value=x)), 0.1,
                          order=2)
    _state_loss(S, V, torch.sum).backward()
    assert _rel(want, x.grad) <= TOL_RUN


# --- the transposes of the fft='mxu' operators ----------------------------------

def _dot(a, b):
    return sum(float((x.detach().double() * y.detach().double()).sum())
               for x, y in zip(a, b))


@pytest.mark.parametrize("shape", [SHAPE, CT2], ids=['dense', 'ct2'])
def test_mxu_force_transpose_is_the_adjoint(shape):
    """<T a, c> = <a, T^T c>, T^T from the backward (-T_d per
    direction)"""
    _, ts = _solvers(shape)
    rng = np.random.RandomState(10)
    a = torch.tensor(rng.normal(size=shape).astype('f4'), requires_grad=True)
    c = [torch.from_numpy(rng.normal(size=shape).astype('f4'))
         for _ in range(3)]
    Ta = tfastpm._MxuForce.apply(ts, a)
    (g,) = torch.autograd.grad(Ta, a, grad_outputs=c)
    lhs, rhs = _dot(Ta, c), _dot((a,), (g,))
    scale = _dot([t.abs() for t in Ta], [t.abs() for t in c])
    assert abs(lhs - rhs) <= TOL_ADJOINT * scale


def test_mxu_potential_is_self_adjoint():
    _, ts = _solvers(CT2)
    rng = np.random.RandomState(11)
    a = torch.tensor(rng.normal(size=CT2).astype('f4'), requires_grad=True)
    b = torch.from_numpy(rng.normal(size=CT2).astype('f4'))
    phi_a = ts._mxu_potential(a)
    (g,) = torch.autograd.grad(phi_a, a, grad_outputs=b)
    # the backward is the potential itself, and <phi a, b> = <a, phi b>
    assert torch.equal(g, ts._mxu_potential_raw(b))
    lhs, rhs = _dot((phi_a,), (b,)), _dot((a,), (g,))
    scale = _dot((phi_a.abs(),), (b.abs(),))
    assert abs(lhs - rhs) <= TOL_ADJOINT * scale
