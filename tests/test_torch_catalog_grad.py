"""Reverse and forward mode through the port's catalog FastPM path
against ``jax.grad`` and ``jax.jvp`` of the JAX package, on the same
seeded numpy inputs (CPU, f8; the particle mesh 8^3 in 32 Mpc/h, the
force mesh 16^3 with B = 2, CIC, EHPower of Planck15, 2LPT at a = 0.1,
2 KDK steps to a = 0.3).

Tolerances, each relative to max|JAX|: 1e-8 for every gradient and
tangent (the same f8 operations, summed in other orders), reverse mode
against ``jax.grad`` and ``torch.func.jvp`` against ``jax.jvp`` (both
JAX references from one ``jax.linearize``):
- the forward model of ``tests/test_forward_model.py`` (white-noise
  shaping -> Zel'dovich displacement -> paint, 8^3, CIC): the gradient
  of sum(rho^2) with respect to the real modes, and the jvp of rho;
- ``Solver.lpt`` at order 1 and 2: the jvp of (S, V) and the gradient
  of sum(S^2 + 2 V^2) with respect to the real field whose r2c, shaped
  by sqrt(P(k) / V) as ``Solver.linear_field`` shapes white noise, is
  the linear field;
- the spectral ``Solver.force``: the jvp and the gradient with respect
  to the positions and the force factor (1.5 Om0, the gravitating mass);
- a 2-step ``Solver.nbody``: the jvp of the final (S, V) and the
  gradient with respect to the initial (S, V).
Gradient mode reads its potential with derivative windows, whose
positions take no derivative: ``jax.grad`` and ``jax.jvp`` raise there,
and so do the port's backward and jvp; in the force factor alone both
give the same gradient (1e-8).

Port only: the whole catalog model (shaping -> 2LPT -> ``nbody`` ->
paint, the model of ``chip_smoke.py`` phase 13(a)), whose reverse and
forward modes must agree, <grad L, v> = <dL/drho, J v> to 1e-10; and
the rest of ``tests/test_forward_model.py``: the inverse problem falls
by 100x in 150 steps of ``torch.optim.Adam(lr=0.2)`` (the JAX test's
``optax.adam(0.2)``), and ``gradcheck.check_grad`` passes at the JAX
test's rtol 1e-4 and eps 1e-4.

The JAX side runs op by op under ``jax.disable_jit()``: its ``Solver.lpt``
and ``nbody`` take host floats of the cosmology, so they cannot be jitted
whole (under ``ensure_compile_time_eval`` the whole model compiled
slower), and linearizing their inner jitted stages took longer than
running those eagerly.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pmesh_tpu import ParticleMesh as JaxPM
from pmesh_tpu.models import cosmology as jcosmo
from pmesh_tpu.models import fastpm as jfastpm
from pmesh_tpu.models import powerspectrum as jps
from pmesh_tpu.ops import transfer as jtf
from pmesh_tpu_torch import ParticleMesh
from pmesh_tpu_torch.gradcheck import check_grad
from pmesh_tpu_torch.models import cosmology as tcosmo
from pmesh_tpu_torch.models import fastpm as tfastpm
from pmesh_tpu_torch.models import powerspectrum as tps
from pmesh_tpu_torch.ops import transfer as ttf

torch.set_num_threads(1)

N = 8
BOX = 32.0
A0 = 0.1
STEPS = np.linspace(0.1, 0.3, 3)    # 2 KDK steps
TOL = 1e-8


@pytest.fixture(autouse=True)
def _eager_jax():
    """the JAX side with its inner jits off: linearizing the package's
    jitted stages op by op costs more here than running them eagerly"""
    with jax.disable_jit():
        yield


def _rel(ref, got):
    ref = np.asarray(ref)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    assert ref.shape == got.shape
    return np.abs(ref - got).max() / np.abs(ref).max()


def _linear(pm, power, x):
    """the real field x -> its r2c shaped by sqrt(P(k) / V), as
    ``Solver.linear_field`` shapes white noise (either package)"""
    def convolve(k, v):
        kmag = k.normp(2) ** 0.5
        return v * (power(kmag) / k.BoxSize.prod()) ** 0.5
    return pm.create(type='real', value=x).r2c().apply(convolve)


def _density(solver, power, x, steps=STEPS):
    """the forward model: rho on the force mesh (either package)"""
    state = solver.lpt(_linear(solver.pm, power, x), A0, order=2)
    state = solver.nbody(state, steps)
    fpm = solver.fpm
    return fpm.paint(state.X).value * float(fpm.Nmesh.prod() / N ** 3)


@pytest.fixture(scope='module')
def jax_side():
    pm = JaxPM(Nmesh=[N] * 3, BoxSize=BOX, dtype='f8')
    return (jfastpm.Solver(pm, B=2),
            jps.EHPower(jcosmo.Planck15, redshift=0.0))


@pytest.fixture(scope='module')
def port():
    pm = ParticleMesh(Nmesh=[N] * 3, BoxSize=BOX, dtype='f8', device='cpu')
    return (tfastpm.Solver(pm, B=2),
            tps.EHPower(tcosmo.Planck15, redshift=0.0))


@pytest.fixture(scope='module')
def inputs():
    rng = np.random.RandomState(17)
    return rng.normal(size=(N,) * 3), rng.normal(size=(N,) * 3)


def _forward(pm, modes, Q, transfer, stack):
    """the forward model of tests/test_forward_model.py (either package):
    modes (real mesh) -> shaped linear field -> Zel'dovich displacement
    -> painted density"""
    dlin = pm.create(type='real', value=modes).r2c()

    def shape_k(k, v):
        kk = k.normp(2, zeromode=1.0)
        return v * kk ** -0.75 * (k.normp(2) > 0)

    dlink = dlin.apply(shape_k)
    S = stack([dlink.apply(transfer.dx1_transfer(d)).c2r().readout(Q)
               for d in range(3)], -1)
    return pm.paint(Q + 0.5 * S).value


def _unit_meshes(n, resampler):
    jpm = JaxPM(Nmesh=[n] * 3, BoxSize=float(n), dtype='f8',
                resampler=resampler)
    tpm = ParticleMesh(Nmesh=[n] * 3, BoxSize=float(n), dtype='f8',
                       resampler=resampler, device='cpu')
    return jpm, tpm


def _torch_forward(pm, modes):
    Q = pm.generate_uniform_particle_grid(shift=0.0)
    return _forward(pm, modes, Q, ttf, torch.stack)


def test_forward_model_grad_and_jvp_match_jax(inputs):
    jpm, tpm = _unit_meshes(N, 'cic')
    x, v = inputs
    jQ = jpm.generate_uniform_particle_grid(shift=0.0)

    def jrho(y):
        return _forward(jpm, y, jQ, jtf, jnp.stack)
    # one linearization gives both modes: the jvp, and its transpose
    rho, lin = jax.linearize(jrho, jnp.asarray(x))
    ref_t = lin(jnp.asarray(v))
    ref_g, = jax.linear_transpose(lin, jnp.asarray(x))(2 * rho)
    tx = torch.tensor(x, requires_grad=True)
    got_g, = torch.autograd.grad((_torch_forward(tpm, tx) ** 2).sum(), tx)
    assert _rel(ref_g, got_g) <= TOL
    _, got_t = torch.func.jvp(lambda y: _torch_forward(tpm, y),
                              (torch.tensor(x),), (torch.tensor(v),))
    assert _rel(ref_t, got_t) <= TOL


def test_catalog_model_reverse_and_forward_agree(port, inputs):
    """the model of chip_smoke.py phase 13(a), at 8^3: <grad L, v> (reverse
    mode) against <dL/drho, J v> (torch.func.jvp), L = sum (rho - 1)^2"""
    solver, power = port
    x = torch.tensor(inputs[0], requires_grad=True)
    v = torch.tensor(inputs[1])
    rho = _density(solver, power, x)
    grad, = torch.autograd.grad(((rho - 1) ** 2).sum(), x)
    assert torch.isfinite(grad).all() and grad.abs().max() > 0
    _, tangent = torch.func.jvp(lambda y: _density(solver, power, y),
                                (x.detach(),), (v,))
    lhs = float((grad * v).sum())
    rhs = float((2 * (rho.detach() - 1) * tangent).sum())
    assert abs(lhs - rhs) <= 1e-10 * abs(lhs)


def _both_modes(fn, primals, tangents, cotangents):
    """JAX's jvp of ``fn`` along ``tangents`` and its vjp of
    ``cotangents(outputs)``, from one linearization"""
    out, lin = jax.linearize(fn, *primals)
    return lin(*tangents), jax.linear_transpose(lin, *primals)(
        cotangents(out))


def _port_modes(fn, primals, tangents, cotangents):
    """the same through torch.func.jvp and torch.autograd"""
    _, tangent = torch.func.jvp(fn, primals, tangents)
    leaves = [p.clone().requires_grad_() for p in primals]
    out = fn(*leaves)
    flat = out if isinstance(out, tuple) else (out,)
    cts = cotangents(tuple(o.detach() for o in flat))
    cts = cts if isinstance(cts, tuple) else (cts,)
    grads = torch.autograd.grad(flat, leaves, cts)
    return tangent, grads


def _assert_trees(ref, got):
    ref = jax.tree_util.tree_leaves(ref)
    got = (got,) if isinstance(got, torch.Tensor) else tuple(got)
    assert len(ref) == len(got)
    for r, g in zip(ref, got):
        assert np.abs(np.asarray(r)).max() > 0
        assert _rel(r, g) <= TOL


@pytest.mark.parametrize("order", [1, 2])
def test_lpt_grad_matches_jax(jax_side, port, inputs, order):
    """(S, V) of lpt: the jvp along v, and the gradient of
    sum(S^2 + 2 V^2) (the cotangent (2 S, 4 V))"""
    def lpt(package):
        solver, power = package

        def fn(y):
            s = solver.lpt(_linear(solver.pm, power, y), A0, order=order)
            return s.S, s.V
        return fn

    def cot(out):
        return 2 * out[0], 4 * out[1]
    x, v = inputs
    ref_t, ref_g = _both_modes(lpt(jax_side), (jnp.asarray(x),),
                               (jnp.asarray(v),), cot)
    got_t, got_g = _port_modes(lpt(port), (torch.tensor(x),),
                               (torch.tensor(v),), cot)
    _assert_trees(ref_t, got_t)
    _assert_trees(ref_g, got_g)


def _positions(seed):
    """a lattice displaced by 0.3 cells rms, and weights for the loss"""
    rng = np.random.RandomState(seed)
    cell = BOX / N
    q = (np.indices((N,) * 3).reshape(3, -1).T + 0.5) * cell
    X = q + 0.3 * cell * rng.normal(size=q.shape)
    return X, rng.normal(size=q.shape)


def test_force_grad_matches_jax(jax_side, port):
    """F(X, factor): the jvp along (w, 1), and the gradient of
    sum(w F^2)"""
    X, w = _positions(3)
    factor = 1.5 * 0.3089

    def force(solver):
        return lambda X, f: solver.force(X, factor=f)
    ref_t, ref_g = _both_modes(
        force(jax_side[0]), (jnp.asarray(X), jnp.asarray(factor)),
        (jnp.asarray(w), jnp.asarray(1.0)), lambda F: 2 * F * w)
    got_t, got_g = _port_modes(
        force(port[0]),
        (torch.tensor(X), torch.tensor(factor, dtype=torch.float64)),
        (torch.tensor(w), torch.tensor(1.0, dtype=torch.float64)),
        lambda F: 2 * F[0] * torch.tensor(w))
    _assert_trees(ref_t, got_t)
    _assert_trees(ref_g, got_g)


def test_force_gradient_mode_refuses_like_jax(jax_side, port):
    """positions of the derivative readouts take no derivative in either
    package, in reverse and in forward mode; the force factor does"""
    X, w = _positions(4)
    factor = 1.5 * 0.3089
    jsolver, tsolver = jax_side[0], port[0]

    def jforce(X, f):
        return jnp.sum(jsolver.force(X, factor=f, mode='gradient') * w)

    def tforce(X, f):
        return (tsolver.force(X, factor=f, mode='gradient')
                * torch.tensor(w)).sum()
    with pytest.raises(ValueError, match="gradient of gradient"):
        jax.grad(jforce)(jnp.asarray(X), factor)
    with pytest.raises(ValueError, match="gradient of gradient"):
        jax.jvp(lambda y: jforce(y, factor), (jnp.asarray(X),),
                (jnp.asarray(w),))
    tX = torch.tensor(X, requires_grad=True)
    with pytest.raises(ValueError, match="gradient of gradient"):
        torch.autograd.grad(tforce(tX, factor), tX)
    with pytest.raises(ValueError, match="gradient of gradient"):
        torch.func.jvp(lambda y: tforce(y, factor), (torch.tensor(X),),
                       (torch.tensor(w),))
    ref = jax.grad(jforce, argnums=1)(jnp.asarray(X), factor)
    tf_ = torch.tensor(factor, dtype=torch.float64, requires_grad=True)
    got, = torch.autograd.grad(tforce(torch.tensor(X), tf_), tf_)
    assert abs(float(ref) - float(got)) <= TOL * abs(float(ref))


def test_nbody_grad_matches_jax(jax_side, port):
    """2 KDK steps from (S, V) (S of 0.3 cells rms, V of 0.1 cells per
    unit of a rms): the jvp of the final (S, V) along a seeded tangent,
    and the gradient of sum(S^2 + 2 V^2)"""
    X, _ = _positions(5)
    rng = np.random.RandomState(6)
    Q = X - 0.3 * (BOX / N) * rng.normal(size=X.shape)
    S = X - Q
    V = 0.1 * (BOX / N) * rng.normal(size=X.shape)
    dS, dV = rng.normal(size=X.shape), rng.normal(size=X.shape)

    def nbody(solver, state, Q):
        def fn(S, V):
            s = solver.nbody(state(Q, S, V), STEPS)
            return s.S, s.V
        return fn

    def cot(out):
        return 2 * out[0], 4 * out[1]
    ref_t, ref_g = _both_modes(
        nbody(jax_side[0], jfastpm.State, jnp.asarray(Q)),
        (jnp.asarray(S), jnp.asarray(V)), (jnp.asarray(dS), jnp.asarray(dV)),
        cot)
    got_t, got_g = _port_modes(
        nbody(port[0], tfastpm.State, torch.tensor(Q)),
        (torch.tensor(S), torch.tensor(V)),
        (torch.tensor(dS), torch.tensor(dV)), cot)
    _assert_trees(ref_t, got_t)
    _assert_trees(ref_g, got_g)


# --- the rest of tests/test_forward_model.py (port only) ---------------------

def test_inverse_problem_recovers_density():
    n = 8
    # TSC: the CIC kernel derivative vanishes exactly at lattice points,
    # which would zero the gradient at the x = 0 start
    pm = _unit_meshes(n, 'tsc')[1]
    rng = np.random.RandomState(0)
    target = _torch_forward(pm, torch.tensor(rng.normal(size=(n, n, n))))

    def objective(modes):
        return ((_torch_forward(pm, modes) - target) ** 2).mean()

    x = torch.tensor(0.01 * rng.normal(size=(n, n, n)), requires_grad=True)
    opt = torch.optim.Adam([x], lr=0.2)
    loss0 = float(objective(x.detach()))
    for _ in range(150):
        opt.zero_grad()
        loss = objective(x)
        loss.backward()
        opt.step()
    loss1 = float(loss.detach())
    assert np.isfinite(loss1)
    # two orders of magnitude of data-fit improvement
    assert loss1 < 0.01 * loss0, (loss0, loss1)


def test_check_grad_through_full_pipeline():
    n = 6
    pm = _unit_meshes(n, 'tsc')[1]
    modes = np.random.RandomState(1).normal(size=(n, n, n))

    def objective(modes):
        return (_torch_forward(pm, modes) ** 2).sum()

    idx = [0, 37, 111, 215]   # flat indices to probe
    check_grad(objective, modes, indices=idx, rtol=1e-4, eps=1e-4,
               device='cpu')
