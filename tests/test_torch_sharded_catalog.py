"""The port's sharded catalog path against the JAX package's 4-device
answers: the 1-d ghost exchange (``parallel/exchange.py``: decompose,
exchange, gather, reshard, the measurements), the sharded paint and
readout, the sharded noise, the power spectrum, the reductions and the
Solver (tune_exchange, force, lpt, nbody with rebalance).

The port runs as 4 gloo ranks on the CPU (``parallel/launch.spawn``,
the cases of ``tests/torch_sharded_catalog_cases.py``), rank b on block
b of every particle array and slab b of every mesh; the JAX package runs
``ProcessMesh(jax.devices()[:4])`` on the virtual devices of
``tests/conftest.py``.  The ranks' blocks, concatenated, are held
against the JAX package's global arrays:

- exact: the plan (send_idx, recv_valid, badness, kside, capacity,
  'auto' capacity, the exchange cost), the exchange of any array, every
  gather mode and ufunc, the measured ghosts and load, reshard's blocks
  where both packages order a home slab's sources alike, the poison of
  a residency breach and of a capacity overflow, and the sharded
  gadget and native noise (also against the port's one-device fill);
- 1e-10 of max (f8, 16^3): the sharded paint and readout (CIC, TSC,
  lanczos3, hsml, translate, derivative), with a plan or without,
  Solver.force in both modes and force_staged, the linear field and
  the 2LPT state, the reductions and fftpower;
- by ID: a 3-step nbody with rebalance=1.0 against the JAX package's
  run, 1e-8 of max in f8 and 1e-4 in f4; the f4 KDK loop with a reshard
  per segment, sorted, 1e-4.

At 4 ranks the ghost reach is one slab ((D - 1) // 2), so a window
deeper than a slab raises the same ValueError in both packages.  Two
faults of the JAX package at 4 devices are held as such (ROADMAP queue
3): its breach check misses a window that reaches two slabs from its
block, and its reshard orders a home slab's sources by rank, which puts
particles wrapped across the box's edge one block from home where their
windows reach two; its paint then loses their mass.  The ranks start
once for the module, in a thread, while the JAX side computes.
"""
import concurrent.futures
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pmesh_tpu import ParticleMesh as JaxPM
from pmesh_tpu.models.cosmology import Planck15 as JPlanck15
from pmesh_tpu.models.fastpm import Solver as JaxSolver, State as JaxState
from pmesh_tpu.models.powerspectrum import EHPower as JEHPower
from pmesh_tpu.ops import power as jpower
from pmesh_tpu.parallel import exchange as jex
from pmesh_tpu.parallel.pmesh import ProcessMesh as JaxProcessMesh
from pmesh_tpu_torch import ParticleMesh
from pmesh_tpu_torch.models.fastpm import Solver
from pmesh_tpu_torch.parallel import launch
from torch_sharded_catalog_cases import CASES

torch.set_num_threads(1)

RANKS = 4
N = 16
TOL = 1e-10
TOL_F4 = 1e-4
TOL_F8 = 1e-8
SHIFTS = (0.5, -1.25, 3.0)
HMAX = 1.8
IC = dict(n=8, box=32.0, seed=3, a0=0.1, steps=np.linspace(0.1, 0.4, 4))
NBODY_STEPS = np.linspace(0.5, 1.0, 4)          # 3 KDK steps
GATHER_KEYS = ('ghosts', 'sum', 'mean', 'any', 'local', 'all', 'mask',
               'pair', 'pos', 'grid0')
REDUCTIONS = ('sum', 'mean', 'max', 'min', 'prod')
UFUNCS = {'maximum': np.maximum, 'multiply': np.multiply, 'fmin': np.fmin,
          'arctan2': np.arctan2, 'lambda': lambda a, b: a + 2 * b}


def _rel(ref, got):
    ref, got = np.asarray(ref), np.asarray(got)
    assert ref.shape == got.shape, (ref.shape, got.shape)
    wide = np.complex128 if np.iscomplexobj(ref) else np.float64
    ref, got = ref.astype(wide), got.astype(wide)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _particles(n, seed=5, amp=1.0):
    Q = np.stack(np.meshgrid(*[np.arange(n, dtype='f8')] * 3,
                             indexing='ij'), -1).reshape(-1, 3)
    return Q + np.random.RandomState(seed).uniform(-amp, amp, Q.shape)


@functools.lru_cache(maxsize=None)
def _inputs():
    X = _particles(N)
    inp = dict(
        X=X, X3=_particles(N, seed=3), X7=_particles(N, seed=7),
        X9=_particles(N, seed=9),
        Xbad=np.roll(X, N ** 3 // RANKS, axis=0),
        # sorted by x-plane: both packages' reshard orders agree
        Xsorted=X[np.argsort(np.floor(np.mod(X[:, 0], N)), kind='stable')],
        Xodd=X[:-13],
        X32=_particles(32, amp=0.2),
        # lanczos3's window (3 cells) on 4-row slabs: a particle resharded
        # one block from home would reach two, so the input keeps every
        # slab's population (its particles within half a cell of a plane)
        Xdeep=_particles(N, seed=8, amp=0.5),
        vals=np.arange(N ** 3, dtype='f8') + 2.0,
        hsml=1.0 + np.random.RandomState(2).uniform(0, 0.8, (N ** 3,)))
    # block 2 holds a particle of slab 3 whose CIC window crosses into
    # slab 0 (the box's edge at 16)
    inp['Xwrap'] = _particles(N, amp=0.0) + 0.5
    inp['Xwrap'][2 * N ** 3 // RANKS, 0] = 15.7
    box = 37.5
    inp['Xbox'] = (_particles(N, amp=0.0) + np.random.RandomState(5)
                   .uniform(-1, 1, (N ** 3, 3))) * box / N
    inp['Xgrad'] = (_particles(N, amp=0.0) + np.random.RandomState(11)
                    .uniform(-1, 1, (N ** 3, 3))) * box / N
    r = np.random.RandomState(12)
    inp['X0'] = r.uniform(0, N, (2048, 3)).astype('f4')
    inp['V0'] = (0.3 * r.normal(size=(2048, 3))).astype('f4')
    r = np.random.RandomState(9)
    inp['Q'] = _particles(N, amp=0.0)
    inp['S0'] = 0.5 * r.normal(size=(N ** 3, 3))
    inp['Vn'] = 0.1 * r.normal(size=(N ** 3, 3))
    inp['x'] = r.normal(size=(N,) * 3)
    inp['y'] = r.normal(size=(N,) * 3)
    return inp


def _slots(n, seed=4):
    """a distinct value for every exchange slot of every rank (the slot
    count of the default CIC plan of X at 16^3: nl + 2 nl)"""
    return np.random.RandomState(seed).uniform(0.5, 1.5, (RANKS * 3 * n,))


def _cases(inp):
    nl = N ** 3 // RANKS
    c = [('plan', 'plan', (N, inp['X'], {})),
         ('plan_auto', 'plan', (N, inp['X'], {'capacity': 'auto'})),
         ('plan_tsc', 'plan', (N, inp['X3'], {}, None, 'tsc')),
         ('plan_shift', 'plan', (N, inp['X7'], {}, SHIFTS[1])),
         ('plan_hsml', 'plan', (N, inp['X'], {'smoothing': HMAX})),
         ('plan_odd', 'plan', (N, inp['Xodd'], {'capacity': 'auto'})),
         ('plan_32', 'plan', (32, inp['X32'], {'capacity': 'auto'})),
         ('wrap', 'plan', (N, inp['Xwrap'], {})),
         ('gather', 'gather', (N, inp['X'], inp['vals'], _slots(nl))),
         ('cic', 'paint', (N, inp['X'])),
         ('tsc', 'paint', (N, inp['X3'], 'tsc')),
         ('lanczos3', 'paint', (N, inp['Xdeep'], 'lanczos3')),
         ('odd', 'paint', (N, inp['Xodd'])),
         ('auto32', 'paint', (32, inp['X32'], 'cic', None, None, False,
                              {'capacity': 'auto'})),
         ('box', 'paint', (N, inp['Xbox'], 'cic', 37.5, None, True))]
    c += [('shift%d' % i, 'paint', (N, inp['X7'], 'cic', None, s))
          for i, s in enumerate(SHIFTS)]
    c += [('shift_grad', 'paint', (N, inp['X7'], 'cic', None, 0.75, True)),
          ('hsml', 'hsml', (N, inp['X'], inp['hsml'], HMAX)),
          ('breach', 'poison', (N, inp['Xbad'], {'kside': 1})),
          ('overflow', 'poison', (N, inp['X'], {'capacity': 1})),
          ('reshard', 'reshard', (N, inp['Xbad'], np.arange(N ** 3))),
          ('reshard_sorted', 'reshard', (N, inp['Xsorted'],
                                         np.arange(N ** 3))),
          ('reshard_wrap', 'reshard', (N, inp['X'], np.arange(N ** 3))),
          ('measure', 'measure', (N, inp['X'], 1.0)),
          ('measure_odd', 'measure', (N, inp['Xodd'], 1.0)),
          ('measure_32', 'measure', (32, inp['X32'], 1.0)),
          ('force_spectral', 'force', (N, float(N), inp['X9'])),
          ('force_gradient', 'force', (N, float(N), inp['X9'],
                                       'gradient')),
          ('force_box', 'force', (N, 37.5, inp['Xgrad'])),
          ('force_box_gradient', 'force', (N, 37.5, inp['Xgrad'],
                                           'gradient')),
          ('scan', 'scan', (N, inp['X'])),
          ('kdk', 'kdk', (N, inp['X0'], inp['V0'])),
          ('nbody_f4', 'nbody', (N, float(N), 'f4', inp['Q'], inp['S0'],
                                 inp['Vn'], NBODY_STEPS)),
          ('nbody_f8', 'nbody', (N, float(N), 'f8', inp['Q'], inp['S0'],
                                 inp['Vn'], NBODY_STEPS))]
    c += [('ic_' + compat, 'ic', (IC['n'], IC['box'], 'f8', IC['seed'],
                                  compat, IC['a0'], IC['steps']))
          for compat in ('gadget', 'native')]
    c += [('reductions', 'reductions', (N, inp['x'], inp['y'])),
          ('coarray', 'coarray', ()), ('refusals', 'refusals', ())]
    return c


@pytest.fixture(scope='module')
def port():
    """{label: [rank results]}, from one 4-rank gloo job started in a
    thread; the fixture returns a function that waits for it"""
    cases = _cases(_inputs())
    labels = [label for label, _, _ in cases]
    pool = concurrent.futures.ThreadPoolExecutor(1)
    fut = pool.submit(launch.spawn, CASES + ':run_cases', RANKS, 'gloo',
                      'cpu', [(name, args) for _, name, args in cases])
    pool.shutdown(wait=False)

    def result(label):
        return [r[labels.index(label)] for r in fut.result()]
    yield result
    fut.result()


@pytest.fixture(scope='module')
def jpm():
    return JaxProcessMesh(jax.devices()[:RANKS])


def _jpm(jpm, n=N, box=None, dtype='f8', resampler='cic', sharded=True):
    return JaxPM(Nmesh=[n] * 3, BoxSize=float(n) if box is None else box,
                 dtype=dtype, resampler=resampler,
                 procmesh=jpm if sharded else None)


def _cat(blocks, key=None):
    return np.concatenate([b if key is None else b[key] for b in blocks])


def _shift(pm, amount):
    return None if amount is None else pm.affine.shift(amount)


def _plan_eq(got, lay):
    """the ranks' plans against JAX's ShardedLayout, exactly"""
    send = np.asarray(lay.send_idx)
    valid = np.asarray(lay.recv_valid)
    for b, g in enumerate(got):
        np.testing.assert_array_equal(g['send_idx'], send[b])
        np.testing.assert_array_equal(g['recv_valid'], valid[b])
        np.testing.assert_array_equal(g['cost'], lay.get_exchange_cost())
        assert (g['kside'], g['capacity'], g['nl'], g['npart'],
                g['npart_pad'], g['recvlength']) == (
            lay.kside, lay.capacity, lay.nl, lay.npart, lay.npart_pad,
            lay.recvlength)
        assert np.array_equal(np.float32(g['badness']),
                              np.float32(lay.badness), equal_nan=True)


# --- the plan ----------------------------------------------------------------

@pytest.mark.parametrize("label,key,kw,shift,resampler", [
    ('plan', 'X', {}, None, 'cic'),
    ('plan_auto', 'X', {'capacity': 'auto'}, None, 'cic'),
    ('plan_tsc', 'X3', {}, None, 'tsc'),
    ('plan_shift', 'X7', {}, SHIFTS[1], 'cic'),
    ('plan_hsml', 'X', {'smoothing': HMAX}, None, 'cic'),
    ('plan_odd', 'Xodd', {'capacity': 'auto'}, None, 'cic'),
])
def test_decompose_builds_sharded_layout(port, jpm, label, key, kw, shift,
                                         resampler):
    """the plan of every rank is block b of JAX's plan, bit for bit"""
    pm = _jpm(jpm, resampler=resampler)
    lay = pm.decompose(jnp.asarray(_inputs()[key]),
                       transform=_shift(pm, shift), **kw)
    _plan_eq(port(label), lay)
    assert all(g['badness'] == 0.0 for g in port(label))
    assert sum(port(label)[0]['cost']) > 0


def test_measured_capacity(port, jpm):
    """capacity='auto' at 32^3 (4-row slabs... 8-row at 4 ranks): the
    same measured counts, reach and capacity, smaller than the block,
    and the paint that JAX's gives"""
    X = _inputs()['X32']
    counts, reach = jex.measure_ghosts(jpm, jnp.asarray(X)[:, 0] * 1.0, 32,
                                       X.shape[0], smoothing=1.0)
    for g in port('measure_32'):
        np.testing.assert_array_equal(g['counts'], counts)
        assert g['reach'] == reach
    pm = _jpm(jpm, 32)
    lay = pm.decompose(jnp.asarray(X), capacity='auto')
    _plan_eq(port('plan_32'), lay)
    assert lay.capacity < lay.nl
    got = port('auto32')
    assert _rel(pm.paint(jnp.asarray(X), layout=lay).value,
                _cat(got, 'paint')) <= TOL


@pytest.mark.parametrize("label,key", [('measure', 'X'),
                                       ('measure_odd', 'Xodd')])
def test_measure_ghosts_and_load(port, jpm, label, key):
    """measure_ghosts and measure_load, exactly, an uneven particle count
    padded with the JAX package's sentinels.  The JAX package's
    measure_load raises at an uneven count (it writes into a read-only
    view of a device array; ROADMAP queue 3): there the port's load is
    held to its definition on JAX's ghost counts instead"""
    X = jnp.asarray(_inputs()[key])
    counts, reach = jex.measure_ghosts(jpm, X[:, 0] * 1.0, N, X.shape[0],
                                       smoothing=1.0)
    got = port(label)
    for g in got:
        np.testing.assert_array_equal(g['counts'], counts)
        assert g['reach'] == reach
    if X.shape[0] % RANKS == 0:
        load = jex.measure_load(jpm, X[:, 0] * 1.0, N, 1.0)
        for g in got:
            for k, v in load.items():
                np.testing.assert_array_equal(g['load'][k], v)
        return
    with pytest.raises(ValueError, match="read-only"):
        jex.measure_load(jpm, X[:, 0] * 1.0, N, 1.0)
    load = got[0]['load']
    sent = load['ghosts_sent']
    # one channel each way at 4 ranks: rank j receives from j - 1 and j + 1
    # what they sent its way, and paints its block and those
    nl = -(-X.shape[0] // RANKS)
    assert sent.sum() == load['ghosts_recv'].sum()
    work = nl + load['ghosts_recv']
    work[-1] -= nl * RANKS - X.shape[0]
    np.testing.assert_array_equal(load['paint_work'], work)
    assert load['imbalance'] == work.max() / work.mean()
    home = (np.floor(np.mod(np.asarray(X[:, 0]), N)) // (N // RANKS))
    blocks = np.arange(X.shape[0]) // nl
    np.testing.assert_array_equal(
        load['residents'], np.bincount(blocks[home == blocks],
                                       minlength=RANKS))


@pytest.mark.parametrize("smoothing,n", [(1.0, 16), (1.5, 16), (3.0, 16),
                                         (4.5, 16), (1.0, 8)])
def test_plan_helpers_match(smoothing, n):
    """the channels, the default kside, the sentinel and the home block
    of the port's exchange (one process) against the JAX package's"""
    from pmesh_tpu_torch.parallel import exchange as ex
    rows = n // RANKS
    assert ex._channels(2) == jex._channels(2)
    assert ex._default_kside(smoothing, rows, RANKS) == jex._default_kside(
        smoothing, rows, RANKS, N0=n)
    assert ex._sentinel_pos(n, rows, RANKS) == jex._sentinel_pos(n, rows,
                                                                  RANKS)
    g = np.random.RandomState(1).uniform(-n, 2 * n, 1000)
    g[:4] = (-1e-7, n - 1e-9, 0.0, float(n))
    for dt in ('f4', 'f8'):
        np.testing.assert_array_equal(
            ex.home_block(torch.from_numpy(g.astype(dt)), n, RANKS).numpy(),
            np.asarray(jex.home_block(jnp.asarray(g.astype(dt)), n, RANKS)))


# --- exchange and gather -----------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_gather(jpm):
    inp = _inputs()
    pm = _jpm(jpm)
    X = jnp.asarray(inp['X'])
    lay = pm.decompose(X)
    v = jnp.asarray(inp['vals'])
    ghosts = lay.exchange(v)
    out = {mode: lay.gather(ghosts, mode)
           for mode in ('sum', 'mean', 'any', 'local')}
    out.update(ghosts=ghosts, all=lay.gather(ghosts, 'all'),
               mask=lay.ghost_mask(), pair=jnp.concatenate(
                   lay.exchange(v, 2 * v)), pos=lay.exchange(X),
               grid0=lay.exchange_grid0(X[:, 0]))
    d = jnp.asarray(_slots(N ** 3 // RANKS))
    for mode in REDUCTIONS:
        out['data_' + mode] = lay.gather(d, mode)
    for name, fn in UFUNCS.items():
        out['ufunc_' + name] = lay.gather(ghosts, fn)
        out['data_ufunc_' + name] = lay.gather(d, fn)
    return {k: np.asarray(v) for k, v in out.items()}


def _port_gather(port, key):
    got = port('gather')
    if key in ('ghosts', 'all', 'mask', 'pos', 'grid0'):
        return _cat(got, key)
    if key == 'pair':
        return np.concatenate([_cat([g['pair'][0] for g in got]),
                               _cat([g['pair'][1] for g in got])])
    return _cat(got, key)


@pytest.mark.parametrize("key", GATHER_KEYS)
def test_gather_modes_roundtrip(port, jpm, key):
    """exchange of a particle array and each gather mode, exactly"""
    ref = _jax_gather(jpm)[key]
    if key == 'pair':
        # JAX returns each array of the pair over all blocks in turn
        ref = ref.reshape(2, RANKS, -1)
        got = _port_gather(port, key).reshape(2, RANKS, -1)
        np.testing.assert_array_equal(got, ref)
        return
    np.testing.assert_array_equal(_port_gather(port, key), ref)
    if key in ('sum', 'mean', 'any', 'local'):
        # and the reference's meaning: mean/any/local give the values back
        if key != 'sum':
            np.testing.assert_array_equal(ref, _inputs()['vals'])
    assert port('gather')[0]['scalar'] == 3.0


@pytest.mark.parametrize("mode", REDUCTIONS + tuple(
    'ufunc_' + k for k in UFUNCS) + tuple('data_ufunc_' + k for k in UFUNCS))
def test_sharded_gather_ufuncs(port, jpm, mode):
    """the reductions and ufuncs on a distinct value per slot (and on the
    exchanged values), exactly; arctan2 within 1e-15 (torch's and XLA's
    arctan2 differ in the last bit)"""
    key = mode if mode.startswith(('ufunc', 'data_')) else 'data_' + mode
    ref = _jax_gather(jpm)[key]
    got = _cat(port('gather'), key)
    rtol = 1e-15 if mode.endswith('arctan2') else 0
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=0)
    assert all(g['object_refused'] for g in port('gather'))


# --- paint and readout -------------------------------------------------------

def _jax_paint(jpm, X, n=N, resampler='cic', box=None, shift=None,
               gradient=False, kw=None, **pkw):
    """JAX's sharded paint and readout with a plan, and its global paint
    and readout without one"""
    pm = _jpm(jpm, n, box=box, resampler=resampler)
    X = jnp.asarray(X)
    t = _shift(pm, shift)
    lay = pm.decompose(X, transform=t, **(kw or {}))
    rho = pm.paint(X, layout=lay, transform=t)
    out = dict(paint=rho.value, readout=rho.readout(X, layout=lay,
                                                    transform=t),
               badness=lay.badness)
    if gradient:
        out['grad'] = [rho.readout(X, layout=lay, transform=t, gradient=d)
                       for d in range(3)]
        out['paint_grad'] = pm.paint(X, layout=lay, transform=t,
                                     gradient=1).value
        v = jnp.linspace(1.0, 2.0, X.shape[0] // RANKS, dtype=X.dtype)
        v = jnp.concatenate([v] * RANKS)
        out['vjp'] = rho.readout_vjp(X, v, out_self=False, layout=lay,
                                     transform=t)[1]
    return out


@pytest.mark.parametrize("label,key,args", [
    ('cic', 'X', {}), ('tsc', 'X3', dict(resampler='tsc')),
    ('lanczos3', 'Xdeep', dict(resampler='lanczos3')),
    ('odd', 'Xodd', {}),
    ('shift0', 'X7', dict(shift=SHIFTS[0])),
    ('shift1', 'X7', dict(shift=SHIFTS[1])),
    ('shift2', 'X7', dict(shift=SHIFTS[2])),
])
def test_sharded_paint_readout_match(port, jpm, label, key, args):
    """paint and readout with the plan against JAX's sharded ones, and
    without a plan (resharded, decomposed and routed back) against
    JAX's global ones, 1e-10 of max"""
    ref = _jax_paint(jpm, _inputs()[key], **args)
    got = port(label)
    assert all(g['badness'] == 0.0 for g in got)
    for k in ('paint', 'readout'):
        assert _rel(ref[k], _cat(got, k)) <= TOL
        assert _rel(ref[k], _cat(got, k + '_free')) <= TOL
    # the one-device answer (the JAX package's own test)
    pm1 = _jpm(jpm, resampler=args.get('resampler', 'cic'), sharded=False)
    t1 = _shift(pm1, args.get('shift'))
    assert _rel(pm1.paint(jnp.asarray(_inputs()[key]), transform=t1).value,
                _cat(got, 'paint')) <= TOL


@pytest.mark.parametrize("label,key,box,shift", [
    ('box', 'Xbox', 37.5, None), ('shift_grad', 'X7', None, 0.75)])
def test_sharded_gradient_units(port, jpm, label, key, box, shift):
    """derivative readouts (with a plan and without), a derivative paint
    and readout_vjp's position part, in simulation units at BoxSize !=
    Nmesh and under a translate"""
    ref = _jax_paint(jpm, _inputs()[key], box=box, shift=shift,
                     gradient=True)
    got = port(label)
    for d in range(3):
        assert _rel(ref['grad'][d], _cat([g['grad'][d] for g in got])) \
            <= TOL
        assert _rel(ref['grad'][d], _cat([g['grad_free'][d] for g in got])) \
            <= TOL
    assert _rel(ref['paint_grad'], _cat(got, 'paint_grad')) <= TOL
    assert _rel(ref['vjp'], _cat(got, 'vjp')) <= TOL


def test_sharded_hsml_matches(port, jpm):
    """per-particle hsml with a static hsml_max; a plan too short for it
    raises, an hsml past it poisons the whole mesh"""
    inp = _inputs()
    pm = _jpm(jpm)
    X, h = jnp.asarray(inp['X']), jnp.asarray(inp['hsml'])
    lay = pm.decompose(X, smoothing=1.0 * HMAX)
    rho = pm.paint(X, hsml=h, hsml_max=HMAX, layout=lay)
    got = port('hsml')
    assert _rel(rho.value, _cat(got, 'paint')) <= TOL
    assert _rel(rho.readout(X, hsml=h, hsml_max=HMAX, layout=lay),
                _cat(got, 'readout')) <= TOL
    # without a plan: resharded, decomposed with the largest hsml's reach
    assert _rel(rho.value, _cat(got, 'paint_free')) <= TOL
    assert _rel(rho.readout(X, hsml=h, hsml_max=HMAX, layout=lay),
                _cat(got, 'readout_free')) <= TOL
    assert all(g['short_refused'] for g in got)
    assert np.isnan(_cat(got, 'over')).all()
    assert np.isnan(np.asarray(pm.paint(X, hsml=h * 2.0, hsml_max=HMAX,
                                        layout=lay).value)).all()


def test_deep_window_refused_past_one_slab(jpm):
    """a window reaching past the one-slab ghost reach of 4 ranks (8^3,
    2-row slabs, lanczos3) raises the same ValueError in both packages"""
    X = jnp.asarray(_particles(8))
    with pytest.raises(ValueError, match="exceeds the kside"):
        _jpm(jpm, 8, resampler='lanczos3').decompose(X)


# --- the poison --------------------------------------------------------------

@pytest.mark.parametrize("label,key,kw", [
    ('breach', 'Xbad', {'kside': 1}), ('overflow', 'X', {'capacity': 1})])
def test_poison(port, jpm, label, key, kw):
    """a residency breach and a capacity overflow: the same plan and NaN
    badness as JAX's, and NaN in the paint, readout, exchange and gather
    on every rank"""
    pm = _jpm(jpm)
    X = jnp.asarray(_inputs()[key])
    lay = pm.decompose(X, **kw)
    assert np.isnan(float(lay.badness))
    got = port(label)
    _plan_eq([g['plan'] for g in got], lay)
    for g in got:
        assert np.isnan(g['badness'])
        for k in ('paint', 'readout', 'exchange', 'gather'):
            assert np.isnan(g[k]).all(), k
    assert np.isnan(np.asarray(pm.paint(X, layout=lay).value)).all()


def test_wrap_breach_poisons(port, jpm):
    """the JAX package's breach check misses a window two slabs from its
    block on 4 devices (its ring-signed distance wraps): its paint drops
    that particle's mass with badness 0; the port poisons"""
    X = _inputs()['Xwrap']
    pm = _jpm(jpm)
    lay = pm.decompose(jnp.asarray(X))
    assert float(lay.badness) == 0.0
    mass = float(np.asarray(pm.paint(jnp.asarray(X), layout=lay).value)
                 .sum())
    assert abs(mass - N ** 3) > 0.1
    assert all(np.isnan(g['badness']) for g in port('wrap'))


# --- reshard -----------------------------------------------------------------

def _reshard_order(X, n):
    """the port's documented order: the x-plane, then the source block,
    then the input order"""
    plane = np.floor(np.mod(X[:, 0], n)).astype(int) % n
    src = np.arange(len(X)) // (len(X) // RANKS)
    return np.lexsort((np.arange(len(X)), src, plane))


@pytest.mark.parametrize("label,key", [('reshard', 'Xbad'),
                                       ('reshard_sorted', 'Xsorted'),
                                       ('reshard_wrap', 'X')])
def test_reshard_restores_residency(port, jpm, label, key):
    """reshard_particles: the documented order, bit for bit (IDs carried
    along); JAX's blocks where each home slab's particles come sorted by
    plane; the new blocks decompose with badness 0 and paint what one
    device paints"""
    X = _inputs()[key]
    got = port(label)
    ids = _cat(got, 'extra')
    order = _reshard_order(X, N)
    np.testing.assert_array_equal(ids, order)
    np.testing.assert_array_equal(_cat(got, 'X'), X[order])
    assert [len(g['X']) for g in got] == [N ** 3 // RANKS] * RANKS
    assert all(g['badness'] == 0.0 for g in got)
    pm1 = _jpm(jpm, sharded=False)
    assert _rel(pm1.paint(jnp.asarray(X)).value, _cat(got, 'paint')) <= TOL
    jX, jid = _jpm(jpm).reshard_particles(jnp.asarray(X),
                                          jnp.arange(N ** 3))
    if label == 'reshard_sorted':
        np.testing.assert_array_equal(ids, np.asarray(jid))
    if label == 'reshard_wrap':
        # JAX's order strands wrapped particles two slabs from home:
        # its paint of its own reshard loses their mass silently
        pm = _jpm(jpm)
        lay = pm.decompose(jX)
        assert float(lay.badness) == 0.0
        mass = float(np.asarray(pm.paint(jX, layout=lay).value).sum())
        assert abs(mass - N ** 3) > 0.5


# --- the Solver --------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_forces(jpm, box, key, mode):
    X = jnp.asarray(_inputs()[key])
    s4 = JaxSolver(_jpm(jpm, box=box))
    s1 = JaxSolver(_jpm(jpm, box=box, sharded=False))
    f4 = np.asarray(jax.jit(lambda X: s4.force(X, mode=mode))(X))
    f1 = np.asarray(jax.jit(lambda X: s1.force(X, mode=mode))(X))
    tune = s4.tune_exchange(X)
    return f4, f1, tune, s4.last_load


@pytest.mark.parametrize("label,box,key,mode", [
    ('force_spectral', float(N), 'X9', 'spectral'),
    ('force_gradient', float(N), 'X9', 'gradient'),
    ('force_box', 37.5, 'Xgrad', 'spectral'),
    ('force_box_gradient', 37.5, 'Xgrad', 'gradient')])
def test_sharded_force_matches(port, jpm, label, box, key, mode):
    """Solver.force on 4 ranks against JAX's 4-device force, JAX's
    one-device force and the port's one-device force, 1e-10 of max;
    force_staged and the force after tune_exchange the same; the tuned
    kside, capacity and load exactly JAX's"""
    f4, f1, tune, load = _jax_forces(jpm, box, key, mode)
    got = port(label)
    F = _cat(got, 'force')
    assert _rel(f4, F) <= TOL and _rel(f1, F) <= TOL
    s1 = Solver(ParticleMesh([N] * 3, box, dtype='f8', device='cpu'))
    own = s1.force(torch.from_numpy(_inputs()[key]), mode=mode).numpy()
    assert _rel(own, F) <= TOL
    assert _rel(f4, _cat(got, 'tuned')) <= TOL
    if mode == 'spectral':
        assert _rel(f4, _cat(got, 'staged')) <= TOL
    for g in got:
        assert g['tune'] == tune
        for k, v in load.items():
            np.testing.assert_array_equal(g['load'][k], v)


def test_exchange_under_scan(port, jpm):
    """decompose, paint, readout and a drift twice (JAX's jitted scan)"""
    pm = _jpm(jpm)

    @jax.jit
    def run(X):
        def step(X, _):
            lay = pm.decompose(X)
            v = pm.paint(X, layout=lay).readout(X, layout=lay)
            return X + 1e-3 * v[:, None], jnp.sum(v)
        return jax.lax.scan(step, X, None, length=2)

    X2, sums = run(jnp.asarray(_inputs()['X']))
    got = port('scan')
    assert _rel(X2, _cat(got, 'X')) <= TOL
    for g in got:
        np.testing.assert_allclose(g['sums'], np.asarray(sums), rtol=TOL)


def _keyed(X, V):
    a = np.concatenate([np.asarray(X), np.asarray(V)], axis=1)
    return a[np.lexsort(a.T[::-1])]


def test_sharded_kdk_with_reshard_in_loop(port, jpm):
    """the f4 KDK loop with a reshard per segment against JAX's run on
    one device (its 4-device reshard strands particles, ROADMAP queue
    3), sorted (reshard moves the particles), 1e-4"""
    inp = _inputs()

    def run(pm, X, V, nseg=2, nstep=2):
        s = JaxSolver(pm)
        for _ in range(nseg):
            X, V = pm.reshard_particles(X, V)
            for _ in range(nstep):
                V = V + 0.1 * s.force(X)
                X = jnp.mod(X + V, float(N))
        return X, V

    X4, V4 = run(_jpm(jpm, dtype='f4', sharded=False),
                 jnp.asarray(inp['X0']), jnp.asarray(inp['V0']))
    got = port('kdk')
    ref = _keyed(X4, V4)
    assert np.abs(_keyed(_cat(got, 'X'), _cat(got, 'V')) - ref).max() \
        <= TOL_F4 * np.abs(ref).max()


def _by_id(Q, *arrays, n=N, box=None):
    """arrays sorted by the particle IDs their Lagrangian Q give"""
    cell = (n if box is None else box) / n
    i = np.rint(np.asarray(Q, np.float64) / cell).astype(int) % n
    ids = (i[:, 0] * n + i[:, 1]) * n + i[:, 2]
    order = np.argsort(ids)
    assert (ids[order] == np.arange(n ** 3)).all()
    return [np.asarray(a)[order] for a in arrays]


@pytest.mark.parametrize("dtype", ['f4', 'f8'])
def test_nbody_rebalance_load_driven(port, jpm, dtype):
    """nbody(rebalance=1.0) on 4 ranks: the trigger fires, the load is
    at least 1.0, the particles stay on the rank's device, and the state,
    compared by ID, is JAX's one-device run's within 1e-8 (f8) or 1e-4
    (f4) of max.  (JAX's own 4-device run raises on its first rebalance
    here: its reshard strands particles two slabs from home, ROADMAP
    queue 3; test_reshard_restores_residency shows the fault.)"""
    inp = _inputs()
    tol = TOL_F8 if dtype == 'f8' else TOL_F4
    st = JaxState(*(jnp.asarray(inp[k], dtype) for k in ('Q', 'S0', 'Vn')))
    r1 = JaxSolver(_jpm(jpm, dtype=dtype, sharded=False)).nbody(
        st, NBODY_STEPS)
    S1, V1 = _by_id(r1.Q, r1.S, r1.V)
    got = port('nbody_' + dtype)
    assert all(g['calls'] >= 1 for g in got)
    assert all(g['load']['imbalance'] >= 1.0 for g in got)
    assert all(g['on'] == 'cpu' for g in got)
    S, V = _by_id(_cat(got, 'Q'), _cat(got, 'S'), _cat(got, 'V'))
    assert _rel(S1, S) <= tol and _rel(V1, V) <= tol


# --- noise, initial conditions, power ----------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_ic(jpm, compat):
    """JAX's noise, linear field and 2LPT state on one device and (for
    gadget) on 4, and its one-device 3-step nbody"""
    n, box = IC['n'], IC['box']
    out = {}
    runs = (('4', True), ('1', False)) if compat == 'gadget' \
        else (('1', False),)
    for name, sharded in runs:
        pm = _jpm(jpm, n, box=box, sharded=sharded)
        s = JaxSolver(pm, JPlanck15, B=2)
        noise = pm.generate_whitenoise(IC['seed'], type='complex',
                                       compat=compat)
        real = pm.generate_whitenoise(IC['seed'], type='real', compat=compat)
        dlin = s.linear_field(JEHPower(JPlanck15), IC['seed'], compat=compat)
        st = s.lpt(dlin, IC['a0'], order=2)
        out[name] = dict(noise=np.asarray(noise.value),
                         real=np.asarray(real.value),
                         dlin=np.asarray(dlin.value), Q=np.asarray(st.Q),
                         S=np.asarray(st.S), V=np.asarray(st.V))
        if not sharded:
            r = s.nbody(st, IC['steps'])
            out[name].update(fQ=np.asarray(r.Q), fS=np.asarray(r.S),
                             fV=np.asarray(r.V))
    return out


@pytest.mark.parametrize("compat", ['gadget', 'native'])
def test_sharded_whitenoise_bitwise(port, jpm, compat):
    """each rank's block of the noise is bitwise the same y columns of
    the port's one-device fill; of JAX's one-device and sharded fills
    bitwise for gadget, and for native within 1e-15 (its uniforms are
    bitwise JAX's, tests/test_torch_whitenoise.py; torch's and XLA's
    sin, cos and log differ in the last bit); the real noise within
    1e-10"""
    n = IC['n']
    ref = _jax_ic(jpm, compat)
    got = np.concatenate([g['noise'] for g in port('ic_' + compat)],
                         axis=1)
    pm1 = ParticleMesh([n] * 3, IC['box'], dtype='f8', device='cpu')
    own = pm1.generate_whitenoise(IC['seed'], type='complex',
                                  compat=compat).value.numpy()
    np.testing.assert_array_equal(got, own)
    rtol = 0 if compat == 'gadget' else 1e-15
    for k in ref:
        np.testing.assert_allclose(got, ref[k]['noise'], rtol=0,
                                   atol=rtol * np.abs(got).max())
    real = _cat(port('ic_' + compat), 'real')
    assert _rel(ref['1']['real'], real) <= TOL


@pytest.mark.parametrize("compat", ['gadget', 'native'])
def test_sharded_lpt_nbody_and_power(port, jpm, compat):
    """linear_field and lpt(order=2) on 4 ranks against JAX's one-device
    and (gadget) 4-device runs, 1e-10 of max; a 3-step nbody with
    rebalance=1.0 by ID against JAX's one-device run, 1e-8; fftpower of
    the sharded final density against one device's on the same
    particles, 1e-10"""
    n, box = IC['n'], IC['box']
    ref = _jax_ic(jpm, compat)
    got = port('ic_' + compat)
    dlin = np.concatenate([g['dlin'] for g in got], axis=1)
    for r in ref.values():
        assert _rel(r['dlin'], dlin) <= TOL
        for k in ('Q', 'S', 'V'):
            assert _rel(r[k], _cat(got, k)) <= TOL
    fS, fV = _by_id(_cat(got, 'fQ'), _cat(got, 'fS'), _cat(got, 'fV'),
                    n=n, box=box)
    S1, V1 = _by_id(ref['1']['fQ'], ref['1']['fS'], ref['1']['fV'], n=n,
                    box=box)
    assert _rel(S1, fS) <= TOL_F8 and _rel(V1, fV) <= TOL_F8
    assert got[0]['load']['imbalance'] >= 1.0
    pm1 = _jpm(jpm, n, box=box, sharded=False)
    X = jnp.asarray(_cat(got, 'fQ') + _cat(got, 'fS'))
    k, p, nm = jpower.fftpower(pm1.paint(X))
    assert _rel(k, got[0]['k']) <= TOL and _rel(p, got[0]['p']) <= TOL
    np.testing.assert_array_equal(got[0]['nmodes'], np.asarray(nm))


def test_reductions_and_power_match(port, jpm):
    """csum, cmean, cdot, cnorm of real slabs and of their spectra, and
    fftpower, against JAX's 4-device field, 1e-10"""
    inp = _inputs()
    pm = _jpm(jpm)
    a = pm.create(type='real', value=jnp.asarray(inp['x']))
    b = pm.create(type='real', value=jnp.asarray(inp['y']))
    ak, bk = a.r2c(), b.r2c()
    k, p, nm = jpower.fftpower(a)
    ref = dict(csum=a.csum(), cmean=a.cmean(), cdot=a.cdot(b),
               cnorm=a.cnorm(), ccdot=ak.cdot(bk), ccnorm=ak.cnorm(), k=k,
               p=p, nmodes=nm)
    for g in port('reductions'):
        for key, v in ref.items():
            np.testing.assert_allclose(g[key], np.asarray(v), rtol=TOL,
                                       atol=TOL * np.abs(np.asarray(v)).max())


# --- what stays refused, and CoArray -----------------------------------------

def test_refusals(port):
    """the lattice path on uneven and pencil meshes (item 8e; c2c
    meshes build on the slab route), a NotImplementedError naming its
    item; a window past the ghost reach, a ValueError.  Gradients through
    the exchange and the sharded paint and readout (8c) run: each result
    has a grad_fn and a finite gradient; global item access and
    reshaping and the untransposed layout (8d) answer: cgetitem the
    global mode on every rank, ravel the rank's block of the global flat
    field, mesh_coordinates block b of the points, start and slices the
    rank's slab, r2c(out=U) a layout c2r inverts"""
    for g in port('refusals'):
        assert all(g.values()), g


def test_coarray(port):
    """each rank reads any rank's block and the whole array; map runs on
    the blocks; unequal blocks raise"""
    full = np.arange(8 * RANKS, dtype='f8').reshape(4 * RANKS, 2)
    for g in port('coarray'):
        assert g['len'] == RANKS and g['uneven_refused']
        np.testing.assert_array_equal(g['block1'], full[4:8])
        np.testing.assert_array_equal(g['all'], full)
        np.testing.assert_array_equal(g['mapped'], full * 2 + 1)
