"""Reverse mode through the port's binned slot-lattice path on the CPU
(the plain fold, paint, readout and rebase), against ``jax.grad`` of the
JAX package's XLA versions (``rebase(impl='xla')``, the custom-vjp
``paint_grid``/``readout_grid``), on the same seeded numpy inputs, in f8
at 8^3.

Piece by piece, within 1e-8 of max|JAX| (the same f8 operations, the
shift sums of the custom vjps in another order; the JAX fold and force
gradients jitted, which compiles in a second where op by op they
linearize their inner jits anew at each call, and the rebase's op by
op, since jitted its unrolled images compile for minutes):
- ``fold_lattice``: the gradient of weighted slot displacements and
  velocities with respect to the lattice ``disp`` and ``vel``;
- ``force_binned`` at K = 2, spectral and gradient mode, with respect
  to the slot displacements (a diffdir readout differentiates natively
  on the CPU, as the JAX package's XLA version does);
- ``rebase`` with a velocity extra: the gradient of the new slot state
  with respect to the old (a gather: every entry is 0 or a weight).

The whole loop, port only (``jax.grad`` of the JAX package's whole
``nbody_binned`` takes minutes here):
- 2 KDK steps with ``rebase_every=2`` (one rebase that moves particles
  to their neighbours, no slot growth), and an ``adaptive=True`` run
  whose slot count grows once at that rebase: ``gradcheck.check_grad``
  at seeded indices of (disp, vel), rtol 1e-5 (the suite's vjp
  contract), eps 1e-6;
- on a state that never leaves slot 0, the gradient equals
  ``nbody_lattice``'s within 1e-10 of max|g| (the two loops then
  compute the same function).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pmesh_tpu import ParticleMesh as JaxPM
from pmesh_tpu.models import fastpm as jfastpm
from pmesh_tpu.ops import binned as jbn
from pmesh_tpu_torch import ParticleMesh
from pmesh_tpu_torch.gradcheck import check_grad
from pmesh_tpu_torch.models import fastpm as tfastpm
from pmesh_tpu_torch.ops import binned as tbn

torch.set_num_threads(1)

N = 8
SHAPE = (N,) * 3
TOL = 1e-8
STEPS = np.linspace(0.1, 0.2, 3)    # 2 KDK steps


def _rel(ref, got):
    ref = np.asarray(ref)
    got = got.detach().numpy()
    assert ref.shape == got.shape
    return np.abs(ref - got).max() / np.abs(ref).max()


def _leaves(tree):
    return jax.tree_util.tree_leaves(tree)


def _as_torch(tree, grad=False):
    return jax.tree_util.tree_map(
        lambda a: torch.tensor(np.asarray(a), requires_grad=grad), tree)


def _as_jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _weights(seed, tree):
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(lambda a: rng.normal(size=np.shape(a)),
                                  tree)


def _dot(tree, w):
    """sum of the leaves of ``tree`` times the weights ``w`` (either
    package)"""
    return sum((a * b).sum() for a, b in zip(_leaves(tree), _leaves(w)))


def _slot_state(seed, lo, hi, fill):
    """K = len(fill) slots: displacements uniform in [lo, hi), validity
    with the given fill fractions, velocities N(0, 1)"""
    rng = np.random.RandomState(seed)
    ds = tuple(tuple(rng.uniform(lo, hi, SHAPE) for _ in range(3))
               for _ in fill)
    va = tuple((rng.uniform(size=SHAPE) < f).astype('f8') for f in fill)
    vel = tuple(tuple(rng.normal(size=SHAPE) for _ in range(3))
                for _ in fill)
    return ds, va, vel


@pytest.fixture(scope='module')
def solvers():
    jpm = JaxPM(Nmesh=list(SHAPE), BoxSize=float(N), dtype='f8')
    tpm = ParticleMesh(Nmesh=list(SHAPE), BoxSize=float(N), dtype='f8',
                       device='cpu')
    return jfastpm.Solver(jpm), tfastpm.Solver(tpm)


def test_fold_lattice_grad_matches_jax():
    rng = np.random.RandomState(1)
    disp = tuple(rng.uniform(-1.2, 2.2, SHAPE) for _ in range(3))
    vel = tuple(rng.normal(size=SHAPE) for _ in range(3))
    K = int(jbn.fold_needed(_as_jax(disp)))
    assert K > 1
    w = _weights(2, (jbn.fold_lattice(_as_jax(disp), _as_jax(vel),
                                      nslots=K)[:2]))

    def jloss(d, v):
        dslots, vslots, _, _ = jbn.fold_lattice(d, v, nslots=K)
        return _dot((dslots, vslots), w)
    ref = jax.jit(jax.grad(jloss, argnums=(0, 1)))(_as_jax(disp),
                                                  _as_jax(vel))
    td, tv = _as_torch(disp, True), _as_torch(vel, True)
    dslots, vslots, _, overflow = tbn.fold_lattice(td, tv, nslots=K)
    assert int(overflow) == 0
    got = torch.autograd.grad(_dot((dslots, vslots), _as_torch(w)),
                              list(td) + list(tv))
    for r, g in zip(_leaves(ref), got):
        assert _rel(r, g) <= TOL


@pytest.mark.parametrize("mode", ['spectral', 'gradient'])
def test_force_binned_grad_matches_jax(solvers, mode):
    """the gradient of sum over the valid slots of w F^2 with respect to
    the slot displacements, K = 2"""
    ds, va, _ = _slot_state(3, 0.0, 1.0, (0.9, 0.3))
    bounds = (-0.5, 1.5)
    w = _weights(4, ds)
    jsolver, tsolver = solvers

    def loss(solver, d, valid, w):
        F = solver.force_binned(d, valid, bounds, mode=mode)
        return sum(_dot(tuple(f ** 2 * v for f in fk), wk)
                   for fk, v, wk in zip(F, valid, w))
    ref = jax.jit(jax.grad(
        lambda d: loss(jsolver, d, _as_jax(va), _as_jax(w))))(_as_jax(ds))
    td = _as_torch(ds, True)
    got = torch.autograd.grad(
        loss(tsolver, td, _as_torch(va), _as_torch(w)), _leaves(td))
    for r, g in zip(_leaves(ref), got):
        assert _rel(r, g) <= TOL


def test_rebase_grad_matches_jax():
    """the plain rebase (its assign's and apply's gathers and masks)
    against ``rebase(impl='xla')``, with a velocity extra; drift bounds
    (0, 1.5): 8 images per slot (JAX takes ~2 s per image op by op, and
    longer jitted)"""
    ds, va, vel = _slot_state(5, 0.0, 1.5, (0.5, 0.2))
    bounds = (0.0, 1.5)
    Kout = int(jbn.needed_slots(_as_jax(ds), _as_jax(va), bounds))
    jout = jbn.rebase(_as_jax(ds), _as_jax(va), bounds,
                      extras=(_as_jax(vel),), nslots_out=Kout, impl='xla')
    assert int(jout[3]) == 0
    w = _weights(6, (jout[0], jout[2]))

    def jloss(d, v):
        new_d, _, new_e, _ = jbn.rebase(d, _as_jax(va), bounds, extras=(v,),
                                        nslots_out=Kout, impl='xla')
        return _dot((new_d, new_e), w)
    ref = jax.grad(jloss, argnums=(0, 1))(_as_jax(ds), _as_jax(vel))
    td, tv = _as_torch(ds, True), _as_torch(vel, True)
    new_d, _, new_e, overflow = tbn.rebase(td, _as_torch(va), bounds,
                                           extras=(tv,), nslots_out=Kout)
    assert int(overflow) == 0
    got = torch.autograd.grad(_dot((new_d, new_e), _as_torch(w)),
                              _leaves(td) + _leaves(tv))
    for r, g in zip(_leaves(ref), got):
        assert _rel(r, g) <= TOL


# --- the whole loop, port only -----------------------------------------------

def _flow_state(seed):
    """displacements uniform in (0.2, 0.8) cells and a bulk flow along x
    of 0.12 (0.4 cells in the 2 steps) plus 0.02 rms: the particles
    past ~0.6 cells cross into the next cell by the rebase, which then
    holds two (K = 2 takes them)"""
    rng = np.random.RandomState(seed)
    disp = rng.uniform(0.2, 0.8, (3,) + SHAPE)
    vel = 0.02 * rng.normal(size=(3,) + SHAPE)
    vel[0] += 0.12
    return np.concatenate([disp, vel])


def _binned_loss(solver, x, adaptive=False, nslots=2):
    dslots, vslots, valid, overflow = solver.nbody_binned(
        tuple(x[:3]), tuple(x[3:]), STEPS, nslots=nslots, rebase_every=2,
        adaptive=adaptive)
    assert int(overflow) == 0
    # each valid particle's state, weighted by its slot-cell
    w = torch.linspace(0.5, 1.5, dslots[0][0].numel(),
                       dtype=torch.float64).reshape(SHAPE)
    return sum(((torch.stack(dk) ** 2 + 2 * torch.stack(vk) ** 2) * w * v)
               .sum() for dk, vk, v in zip(dslots, vslots, valid))


def _moved(solver, x, nslots, adaptive):
    """how many particles the run's rebase put in a cell's second slot,
    and the final slot count"""
    dslots, _, valid, _ = solver.nbody_binned(
        tuple(x[:3]), tuple(x[3:]), STEPS, nslots=nslots, rebase_every=2,
        adaptive=adaptive)
    return int(sum(v.sum() for v in valid[1:])), len(valid)


@pytest.mark.parametrize("adaptive", [False, True])
def test_nbody_binned_grad_matches_central_differences(solvers, adaptive):
    solver = solvers[1]
    x = torch.tensor(_flow_state(7))
    nslots = 1 if adaptive else 2
    moved, K = _moved(solver, x, nslots, adaptive)
    assert moved > 50 and K == 2
    if adaptive:
        assert solver.last_binned_stats['growth_events'] == 1
    idx = np.random.RandomState(8).choice(x.numel(), 6, replace=False)
    check_grad(lambda y: _binned_loss(solver, y, adaptive, nslots), x,
               indices=[int(i) for i in idx], eps=1e-6, rtol=1e-5,
               device='cpu')


def test_nbody_binned_grad_equals_lattice(solvers):
    """every particle stays in slot 0 of its home cell: the binned loop
    and the lattice loop compute the same function"""
    solver = solvers[1]
    rng = np.random.RandomState(9)
    disp = 0.5 + 0.05 * rng.normal(size=(3,) + SHAPE)
    vel = 0.01 * rng.normal(size=(3,) + SHAPE)
    w = torch.tensor(rng.normal(size=(6,) + SHAPE))
    xb = torch.tensor(np.concatenate([disp, vel]), requires_grad=True)
    dslots, vslots, valid, overflow = solver.nbody_binned(
        tuple(xb[:3]), tuple(xb[3:]), STEPS, nslots=2, rebase_every=2)
    assert int(overflow) == 0 and float(valid[1].sum()) == 0
    assert float(valid[0].sum()) == N ** 3
    gb, = torch.autograd.grad(
        (torch.stack(dslots[0] + vslots[0]) * w).sum(), xb)
    xl = torch.tensor(np.concatenate([disp, vel]), requires_grad=True)
    S, V = solver.nbody_lattice(tuple(xl[:3]), tuple(xl[3:]), STEPS,
                                bounds=(-0.5, 1.5))
    gl, = torch.autograd.grad((torch.stack(S + V) * w).sum(), xl)
    assert float(gl.abs().max()) > 0
    assert float((gb - gl).abs().max()) <= 1e-10 * float(gl.abs().max())
