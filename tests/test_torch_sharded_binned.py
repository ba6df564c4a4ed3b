"""The port's slab-sharded binned path against the JAX package: the
sharded rebase (kernel-table row 12, ``rebase_fused_sharded``), the
global overflow and slot counts, and the Solver's sharded binned loops.

The port runs as 4 gloo ranks on the CPU (``parallel/launch.spawn``,
the plain versions of the kernels), each on its own x slab; the JAX
package runs ``ProcessMesh(jax.devices()[:4])`` on the virtual devices
of ``tests/conftest.py``:

- the sharded rebase at 16^3, K = 2 with velocities: bitwise against the
  JAX package's sharded Pallas rebase (interpret mode) and against the
  port's single-device rebase, for more and fewer output slots and for
  a drift deeper than the Pallas kernel's [-1, 1] offsets (the x halo
  then spans two planes); the overflow exact and the same on every
  rank;
- ``needed_slots``: the global maximum on every rank;
- ``force_binned``, spectral and gradient: the JAX package's sharded
  force to 2e-5 of max, the port's single-device force to 1e-6;
- a 2-step ``nbody_binned``: the adaptive loop (slot growth) slot by
  slot against the JAX package's sharded adaptive loop, 1e-4 of max,
  slot count, occupancy and overflow exact; the fixed loop's density
  against the JAX package's single-device run to 1e-8 (its sharded
  fixed loop takes 45 s op by op and over 4 minutes jitted; the sharded
  initial fold is the adaptive loop's) and its counts exact.

The ranks start once for the module, in a thread, while the JAX side
computes (~60 s, most of it the JAX package's loops op by op).
"""
import concurrent.futures
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from pmesh_tpu import ParticleMesh as JaxPM
from pmesh_tpu.models.fastpm import Solver as JaxSolver
from pmesh_tpu.ops import binned as jbn
from pmesh_tpu.parallel.pmesh import ProcessMesh as JaxProcessMesh
from pmesh_tpu_torch import ParticleMesh
from pmesh_tpu_torch.models.fastpm import Solver
from pmesh_tpu_torch.ops import binned as tbn
from pmesh_tpu_torch.parallel import launch
from torch_sharded_cases import CASES

torch.set_num_threads(1)

RANKS = 4
N = 16
NB = 8          # the N-body runs, as test_torch_binned's
# (drift bounds, output slots): the main path's, more slots, fewer, a
# drift past [-1, 1]; the random state overflows each by a different
# count
REBASES = [((-0.5, 1.5), 2), ((-0.5, 1.5), 3), ((-0.5, 1.5), 1),
           ((-1.0, 2.0), 2)]
FORCE_BOUNDS = (-0.5, 1.5)
STEPS = np.linspace(0.3, 0.5, 3)        # 2 KDK steps
FIXED = dict(nslots=2, rebase_every=2, step_drift=0.5)
ADAPTIVE = dict(nslots=1, rebase_every=1, step_drift=0.5, adaptive=True)
TOL_FORCE = 1e-6
TOL_FORCE_JAX = 2e-5
TOL_STATE = 1e-4


def _rel(ref, got):
    ref, got = np.asarray(ref, np.float64), np.asarray(got, np.float64)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _flat(x):
    if isinstance(x, (tuple, list)):
        return [y for z in x for y in _flat(z)]
    return [np.asarray(x)]


def _rows(blocks):
    """the global arrays of per-rank nested blocks, rank-major on x"""
    if isinstance(blocks[0], (tuple, list)):
        return tuple(_rows([b[j] for b in blocks])
                     for j in range(len(blocks[0])))
    return np.concatenate(blocks, 0)


@functools.lru_cache(maxsize=None)
def _inputs():
    rng = np.random.RandomState(11)

    def uni(lo, hi, n=N):
        return rng.uniform(lo, hi, (n,) * 3).astype('f4')

    dslots = tuple(tuple(uni(-0.5, 1.5) for _ in range(3)) for _ in range(2))
    valid = tuple((rng.uniform(size=(N,) * 3) < 0.8).astype('f4')
                  for _ in range(2))
    vel = tuple(tuple(uni(-1.0, 1.0) for _ in range(3)) for _ in range(2))
    deep = tuple(tuple(uni(-1.0, 2.0) for _ in range(3)) for _ in range(2))
    fsl = tuple(tuple(uni(-0.5, 1.5) for _ in range(3)) for _ in range(2))
    # the lattice state of test_torch_binned's N-body test (f8, 8^3)
    js = JaxSolver(JaxPM([NB] * 3, float(NB), dtype='f8'))
    dlin = js.linear_field(lambda k: 0.5 * jnp.ones_like(k), seed=42,
                           compat='native')
    disp, v0 = js.lpt_lattice(dlin, a0=0.3, shift=0.3, order=1)
    return dict(dslots=dslots, valid=valid, vel=vel, deep=deep, fsl=fsl,
                disp=tuple(np.asarray(d) for d in disp),
                v0=tuple(np.asarray(v) for v in v0))


def _cases(inp):
    c = []
    for bounds, kout in REBASES:
        d = inp['deep'] if bounds == (-1.0, 2.0) else inp['dslots']
        c.append(('rebase', (d, inp['valid'], bounds, (inp['vel'],),
                             kout)))
    c.append(('needed', (inp['dslots'], inp['valid'], (-0.5, 1.5))))
    for mode in ('spectral', 'gradient'):
        c.append(('force_binned', ([N] * 3, float(N), inp['fsl'],
                                   inp['valid'], FORCE_BOUNDS, mode)))
    for kw in (FIXED, ADAPTIVE):
        c.append(('nbody_binned', ([NB] * 3, float(NB), inp['disp'],
                                   inp['v0'], STEPS, kw)))
    return c


@pytest.fixture(scope='module')
def port():
    inp = _inputs()
    pool = concurrent.futures.ThreadPoolExecutor(1)
    fut = pool.submit(launch.spawn, CASES + ':run_cases', RANKS, 'gloo', 'cpu',
                      _cases(inp))
    pool.shutdown(wait=False)

    def result(k):
        return [r[k] for r in fut.result()]
    yield result
    fut.result()


@pytest.fixture(scope='module')
def jpm():
    return JaxProcessMesh(jax.devices()[:RANKS])


def _sharded(jpm, a):
    if isinstance(a, (tuple, list)):
        return tuple(_sharded(jpm, x) for x in a)
    return jax.device_put(jnp.asarray(a),
                          NamedSharding(jpm.mesh, P('x', None, None)))


def _t(a):
    if isinstance(a, (tuple, list)):
        return tuple(_t(x) for x in a)
    return torch.from_numpy(np.array(a))


def _bits_equal(ref, got):
    fr, fg = _flat(ref), _flat(got)
    assert len(fr) == len(fg)
    for r, g in zip(fr, fg):
        assert r.shape == g.shape and r.dtype == g.dtype
        assert np.array_equal(r.view(np.uint32) if r.dtype == np.float32
                              else r, g.view(np.uint32)
                              if g.dtype == np.float32 else g)


def test_sharded_rebase_bitwise_matches_jax(port, jpm):
    """row 12: JAX's rebase_fused_sharded (its Pallas kernel per slab in
    interpret mode) and the port's x-halo form on the same global state"""
    inp = _inputs()
    bounds, kout = REBASES[0]
    ref = jbn.rebase(_sharded(jpm, inp['dslots']),
                     _sharded(jpm, inp['valid']), bounds,
                     extras=(_sharded(jpm, inp['vel']),), nslots_out=kout,
                     impl='pallas', procmesh=jpm)
    got = port(0)
    _bits_equal(tuple(_flat(x) for x in ref[:3]),
                tuple(_flat(x) for x in _rows([g[:3] for g in got])))
    assert [g[3] for g in got] == [int(ref[3])] * RANKS


@pytest.mark.parametrize("case", range(len(REBASES)),
                         ids=['%s-%d' % c for c in REBASES])
def test_sharded_rebase_bitwise_matches_single_device(port, case):
    inp = _inputs()
    bounds, kout = REBASES[case]
    d = inp['deep'] if bounds == (-1.0, 2.0) else inp['dslots']
    ref = tbn.rebase(_t(d), _t(inp['valid']), bounds,
                     extras=(_t(inp['vel']),), nslots_out=kout)
    got = port(case)
    _bits_equal(tuple(_flat(x) for x in ref[:3]),
                tuple(_flat(x) for x in _rows([g[:3] for g in got])))
    assert [g[3] for g in got] == [int(ref[3])] * RANKS


def test_needed_slots_is_global(port):
    inp = _inputs()
    ref = int(tbn.needed_slots(_t(inp['dslots']), _t(inp['valid']),
                               (-0.5, 1.5)))
    assert port(len(REBASES)) == [ref] * RANKS


@pytest.mark.parametrize("mode", ['spectral', 'gradient'])
def test_force_binned_matches_single_device(port, mode):
    inp = _inputs()
    s = Solver(ParticleMesh([N] * 3, float(N), dtype='f4', device='cpu'))
    ref = s.force_binned(_t(inp['fsl']), _t(inp['valid']), FORCE_BOUNDS,
                         mode=mode)
    got = _rows(port(len(REBASES) + 1 + ['spectral', 'gradient']
                     .index(mode)))
    for k in range(2):
        for j in range(3):
            assert _rel(ref[k][j].numpy(), got[k][j]) <= TOL_FORCE, (k, j)


@pytest.mark.parametrize("mode", ['spectral', 'gradient'])
def test_force_binned_matches_jax(port, jpm, mode):
    """the sharded force_binned against the JAX package's Solver on
    ProcessMesh(jax.devices()[:4]), the same sharded state"""
    inp = _inputs()
    js = JaxSolver(JaxPM([N] * 3, float(N), dtype='f4', procmesh=jpm))
    ref = js.force_binned(_sharded(jpm, inp['fsl']),
                          _sharded(jpm, inp['valid']), FORCE_BOUNDS,
                          mode=mode)
    got = _rows(port(len(REBASES) + 1 + ['spectral', 'gradient']
                     .index(mode)))
    for k in range(2):
        for j in range(3):
            assert _rel(ref[k][j], got[k][j]) <= TOL_FORCE_JAX, (k, j)


def test_nbody_binned_fixed(port):
    """the counts exact, the density that of the JAX package's
    single-device run and of the port's"""
    inp = _inputs()
    got = port(len(REBASES) + 3)
    ds, vs, va = (_rows([g[j] for g in got]) for j in range(3))
    assert [g[3:] for g in got] == [(0, FIXED['nslots'])] * RANKS
    assert sum(int((v > 0).sum()) for v in va) == NB ** 3
    js = JaxSolver(JaxPM([NB] * 3, float(NB), dtype='f8'))
    with jax.disable_jit():
        jd, _, jva, jov = js.nbody_binned(
            tuple(jnp.asarray(d) for d in inp['disp']),
            tuple(jnp.asarray(v) for v in inp['v0']), STEPS, **FIXED)
    assert int(jov) == 0
    ref = np.asarray(jbn.paint_binned(jd, jva, bounds=(-1.0, 2.0)))
    rho = tbn.paint_binned(_t(ds), _t(va), bounds=(-1.0, 2.0)).numpy()
    np.testing.assert_allclose(rho, ref, atol=1e-8)
    ts = Solver(ParticleMesh([NB] * 3, float(NB), dtype='f8', device='cpu'))
    td, _, tva, _ = ts.nbody_binned(_t(inp['disp']), _t(inp['v0']), STEPS,
                                    **FIXED)
    np.testing.assert_allclose(
        rho, tbn.paint_binned(td, tva, bounds=(-1.0, 2.0)).numpy(),
        atol=1e-8)


def test_nbody_binned_adaptive_matches_jax(port, jpm):
    """slot by slot against the JAX package's sharded adaptive loop (the
    same initial fold by rebase, growth and rebases)"""
    inp = _inputs()
    js = JaxSolver(JaxPM([NB] * 3, float(NB), dtype='f8', procmesh=jpm))
    with jax.disable_jit():
        ref = js.nbody_binned(_sharded(jpm, inp['disp']),
                              _sharded(jpm, inp['v0']), STEPS, **ADAPTIVE)
    got = port(len(REBASES) + 4)
    K = len(ref[0])
    assert K > ADAPTIVE['nslots']
    assert [g[3:] for g in got] == [(int(ref[3]), K)] * RANKS
    assert int(ref[3]) == 0
    ds, vs, va = (_rows([g[j] for g in got]) for j in range(3))
    for k in range(K):
        np.testing.assert_array_equal(va[k], np.asarray(ref[2][k]))
        for j in range(3):
            assert _rel(ref[0][k][j], ds[k][j]) <= TOL_STATE, (k, j)
            assert _rel(ref[1][k][j], vs[k][j]) <= TOL_STATE, (k, j)
