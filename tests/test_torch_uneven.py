"""The port on padded uneven slab meshes against the JAX package's
answers: 18^3 meshes on 5 ranks, and 20^3 on 8 ranks, whose last rank
holds an empty slab.

The port runs as 5 and 8 gloo ranks on the CPU (``parallel/launch.spawn``,
the cases of ``tests/torch_geometry_cases.py``; the two jobs start in
threads while the JAX side computes); the JAX package runs
``ProcessMesh(jax.devices()[:5])`` and ``[:8]`` on the virtual devices
of ``tests/conftest.py``.  A slab has rows = ceil(N0 / D) rows, the last
ones short or empty (18 over 5: 4, 4, 4, 4, 2; 20 over 8: 3 each, then
2, then none); the spectrum's y blocks likewise.  The ranks' blocks,
assembled, are held against the JAX package's global arrays (f8):

- exact: the route and geometry flags (``_uneven1d``, the replicated
  fallback where the slabs cannot reach across the dead seam), the plan
  (send_idx, recv_valid, badness, the kside with its dead seam slabs,
  capacity, 'auto'), the exchange and gather, the measured ghosts, and
  the load (on 8 ranks; on 5 on its definition, below);
- 1e-12 of max: the uneven r2c and c2r (a real, a c2c and a 2-d mesh);
- 1e-10 of max: the padded paint and readout (CIC, TSC, derivatives,
  hsml) with a plan and without, the forces, force_staged, the linear
  field and 2LPT, the reductions and fftpower; the noise bitwise;
- by ID: a 3-step nbody(rebalance=1.0) against the JAX package's
  one-device run, 1e-8 (f8) and 1e-4 (f4).

Two faults of the JAX package where the ranks do not divide the
particle count (18^3 over 5; ROADMAP queue 3): its measure_load (and so
its Solver.tune_exchange) raises, and its hsml paint weighs the ghosting
sentinels NaN.  There the port is held to the load's definition and to
JAX's one-device paint.  The lattice and binned paths on an uneven mesh
raise, naming ROADMAP item 8e.
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
from pmesh_tpu_torch.parallel import launch
from torch_geometry_cases import CASES

torch.set_num_threads(1)

RANKS = 5
WIDE = 8
N = 18
NE = 20                 # on WIDE ranks: the last slab is empty
TOL = 1e-10
TOL_FFT = 1e-12
TOL_F4 = 1e-4
TOL_F8 = 1e-8
HMAX = 1.4
IC = dict(n=N, box=72.0, seed=3, a0=0.1)
NBODY_STEPS = np.linspace(0.5, 1.0, 4)          # 3 KDK steps
GATHER_KEYS = ('ghosts', 'sum', 'mean', 'any', 'local', 'all', 'mask',
               'pair', 'pos', 'grid0', 'data_max', 'data_prod',
               'ufunc_arctan2', 'data_ufunc_lambda')
FFTS = {'real': ((N,) * 3, 'f8'), 'c2c': ((N,) * 3, 'c16'),
        '2d': ((N, N), 'f8')}
ROUTES = (512, 18, 16, 20, (18, 18), (16, 16))
ROUTES_WIDE = (20, 18, 16, 100)


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


def _x(shape, dtype, seed=0):
    r = np.random.RandomState(seed)
    x = r.normal(size=shape)
    return x + 1j * r.normal(size=shape) if dtype.startswith('c') else x


@functools.lru_cache(maxsize=None)
def _inputs():
    X = _particles(N)
    inp = dict(X=X, X3=_particles(N, seed=3), X9=_particles(N, seed=9),
               Xodd=X[:-13], XE=_particles(NE, seed=6),
               vals=np.arange(N ** 3, dtype='f8') + 2.0,
               hsml=1.0 + np.random.RandomState(2).uniform(0, 0.4,
                                                           (N ** 3,)))
    box = 37.5
    inp['Xbox'] = (_particles(N, amp=0.0) + np.random.RandomState(5)
                   .uniform(-1, 1, (N ** 3, 3))) * box / N
    r = np.random.RandomState(9)
    inp['Q'] = _particles(N, amp=0.0)
    inp['S0'] = 0.5 * r.normal(size=(N ** 3, 3))
    inp['Vn'] = 0.1 * r.normal(size=(N ** 3, 3))
    inp['x'] = r.normal(size=(N,) * 3)
    inp['y'] = r.normal(size=(N,) * 3)
    for k, (shape, dtype) in FFTS.items():
        inp['fft_' + k] = _x(shape, dtype)
    inp['fft_E'] = _x((NE,) * 3, 'f8')
    return inp


def _nslots():
    """the slots per rank of the default CIC plan of X: the block and
    2 kside block-long channels (kside 2 on 5 ranks)"""
    return -(-N ** 3 // RANKS) * 5


def _cases(inp):
    c = [('route_%s' % (n,), 'route', None, (n,)) for n in ROUTES]
    c += [('fft_' + k, 'fft', None, (shape, dtype, inp['fft_' + k]))
          for k, (shape, dtype) in FFTS.items()]
    c += [('plan', 'plan', None, (N, inp['X'], {})),
          ('plan_auto', 'plan', None, (N, inp['X'], {'capacity': 'auto'})),
          ('plan_odd', 'plan', None, (N, inp['Xodd'], {'capacity': 'auto'})),
          ('plan_tsc', 'plan', None, (N, inp['X3'], {}, None, 'tsc')),
          ('gather', 'gather', None, (N, inp['X'], inp['vals'], np.random
                                      .RandomState(4).uniform(
                                          0.5, 1.5, RANKS * _nslots()))),
          ('measure', 'measure', None, (N, inp['X'], 1.0)),
          ('cic', 'paint', None, (N, inp['X'])),
          ('tsc', 'paint', None, (N, inp['X3'], 'tsc')),
          ('box', 'paint', None, (N, inp['Xbox'], 'cic', 37.5, None, True)),
          ('hsml', 'paint', None, (N, inp['X'], 'cic', None, None, False,
                                   inp['hsml'], HMAX)),
          ('force', 'force', None, (N, float(N), inp['X9'])),
          ('force_box', 'force', None, (N, 37.5, inp['Xbox'])),
          ('reductions', 'reductions', None, (N, inp['x'], inp['y'])),
          ('refusals', 'refusals', None, (N,))]
    c += [('nbody_' + dt, 'nbody', None, (N, float(N), dt, inp['Q'],
                                          inp['S0'], inp['Vn'], NBODY_STEPS))
          for dt in ('f8', 'f4')]
    c += [('ic_' + compat, 'ic', None, (IC['n'], IC['box'], IC['seed'],
                                        compat, IC['a0']))
          for compat in ('gadget', 'native')]
    return c


def _cases_wide(inp):
    c = [('route_%s' % (n,), 'route', None, (n,)) for n in ROUTES_WIDE]
    c += [('fft', 'fft', None, ((NE,) * 3, 'f8', inp['fft_E'])),
          ('plan', 'plan', None, (NE, inp['XE'], {'capacity': 'auto'})),
          ('cic', 'paint', None, (NE, inp['XE'], 'cic', None, None, True)),
          ('force', 'force', None, (NE, float(NE), inp['XE']))]
    return c


def _start(pool, cases, world):
    labels = [label for label, _, _, _ in cases]
    fut = pool.submit(launch.spawn, CASES + ':run_cases', world, 'gloo',
                      'cpu', [(name, g, args) for _, name, g, args in cases])

    def result(label):
        return [r[labels.index(label)] for r in fut.result()]
    return fut, result


@pytest.fixture(scope='module')
def jobs():
    """(5-rank results, 8-rank results), each {label: [rank results]},
    from two gloo jobs started in threads"""
    inp = _inputs()
    pool = concurrent.futures.ThreadPoolExecutor(2)
    f5, r5 = _start(pool, _cases(inp), RANKS)
    f8, r8 = _start(pool, _cases_wide(inp), WIDE)
    pool.shutdown(wait=False)
    yield r5, r8
    f5.result()
    f8.result()


@pytest.fixture(scope='module')
def port(jobs):
    return jobs[0]


@pytest.fixture(scope='module')
def wide(jobs):
    return jobs[1]


@functools.lru_cache(maxsize=None)
def _jmesh(world):
    return JaxProcessMesh(jax.devices()[:world])


def _jpm(n=N, box=None, dtype='f8', resampler='cic', world=RANKS,
         sharded=True):
    nm = [n] * 3 if np.isscalar(n) else list(n)
    return JaxPM(Nmesh=nm, BoxSize=float(nm[0]) if box is None else box,
                 dtype=dtype, resampler=resampler,
                 procmesh=_jmesh(world) if sharded else None)


def _cat(blocks, key=None):
    return np.concatenate([b if key is None else b[key] for b in blocks])


def _assemble(fields):
    at = [f['at'] for f in fields]
    shape = tuple(max(a[d][1] for a in at) for d in range(len(at[0])))
    out = np.zeros(shape, dtype=fields[0]['value'].dtype)
    for f in fields:
        out[tuple(slice(lo, hi) for lo, hi in f['at'])] = f['value']
    return out


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


# --- geometry and transforms -------------------------------------------------

def _route_eq(got, jp):
    for g in got:
        assert (g['even'], g['uneven1d'], g['pencil2d']) == (
            jp._even_mesh, jp._uneven1d, jp._pencil2d)
        want = 'slab' if jp._even_mesh or jp._uneven1d else 'replicated'
        assert g['route'] == want


@pytest.mark.parametrize("n", ROUTES)
def test_route_matches_jax_flags(port, n):
    """on 5 ranks: the JAX package's _even_mesh and _uneven1d, with its
    arithmetic (512^3 and 18^3 uneven slabs, 16^3 replicated: its slabs
    cannot reach across the dead seam within the ring radius)"""
    _route_eq(port('route_%s' % (n,)), _jpm(n))


@pytest.mark.parametrize("n", ROUTES_WIDE)
def test_route_matches_jax_flags_8(wide, n):
    """on 8 ranks: 20^3 and 100^3 uneven, 18^3 replicated"""
    _route_eq(wide('route_%s' % (n,)), _jpm(n, world=WIDE))


def test_uneven_blocks(port, wide):
    """the padded slab contract: rank b owns [b c, min((b + 1) c, n)),
    c = ceil(n / D), of the real x rows and of the spectrum's y columns,
    the 2-d half spectrum's Ny // 2 + 1 = 10 split as N1's blocks"""
    got = port('route_18')
    assert [g['real'][0] for g in got] == [(0, 4), (4, 8), (8, 12),
                                           (12, 16), (16, 18)]
    assert [g['complex'][1] for g in got] == [g['real'][0] for g in got]
    assert [g['complex'][1] for g in port('route_(18, 18)')] == [
        (0, 4), (4, 8), (8, 10), (10, 10), (10, 10)]
    assert [g['real'][0] for g in wide('route_20')][-2:] == [(18, 20),
                                                             (20, 20)]


@pytest.mark.parametrize("kind", sorted(FFTS))
def test_uneven_fft_matches(port, kind):
    """the uneven r2c and c2r against JAX's 5-device _r2c_uneven: the y
    blocks assembled are its spectrum, the round trip the input, 1e-12"""
    shape, dtype = FFTS[kind]
    x = _inputs()['fft_' + kind]
    got = port('fft_' + kind)
    assert all(g['route'] == 'slab' for g in got)
    jc = _jpm(shape, dtype=dtype).create(type='real',
                                         value=jnp.asarray(x)).r2c()
    assert _rel(jc.value, _assemble([g['c'] for g in got])) <= TOL_FFT
    assert _rel(x, _assemble([g['back'] for g in got])) <= TOL_FFT
    assert _rel(jc.c2r().value, _assemble([g['back'] for g in got])) \
        <= TOL_FFT


def test_empty_slab_fft_matches(wide):
    """20^3 on 8 ranks, the last slab and y block empty: the same"""
    x = _inputs()['fft_E']
    got = wide('fft')
    assert got[-1]['back']['value'].shape[0] == 0
    jc = _jpm(NE, world=WIDE).create(type='real',
                                     value=jnp.asarray(x)).r2c()
    assert _rel(jc.value, _assemble([g['c'] for g in got])) <= TOL_FFT
    assert _rel(x, _assemble([g['back'] for g in got])) <= TOL_FFT


# --- the plan, exchange and gather -------------------------------------------

@pytest.mark.parametrize("label,key,kw,resampler", [
    ('plan', 'X', {}, 'cic'), ('plan_auto', 'X', {'capacity': 'auto'}, 'cic'),
    ('plan_odd', 'Xodd', {'capacity': 'auto'}, 'cic'),
    ('plan_tsc', 'X3', {}, 'tsc')])
def test_uneven_plan(port, label, key, kw, resampler):
    """the plan of every rank is block b of JAX's, bit for bit, with the
    padded slabs' rows and the kside's dead seam slabs"""
    lay = _jpm(resampler=resampler).decompose(jnp.asarray(_inputs()[key]),
                                              **kw)
    _plan_eq(port(label), lay)
    assert all(g['badness'] == 0.0 for g in port(label))


def test_empty_slab_plan(wide):
    """20^3 on 8 ranks: kside 3 (one slab of reach, one of headroom and
    the dead seam slab), the 'auto' plan JAX's"""
    lay = _jpm(NE, world=WIDE).decompose(jnp.asarray(_inputs()['XE']),
                                         capacity='auto')
    assert lay.kside == 3
    _plan_eq(wide('plan'), lay)


@functools.lru_cache(maxsize=None)
def _jax_gather():
    inp = _inputs()
    X = jnp.asarray(inp['X'])
    lay = _jpm().decompose(X)
    v = jnp.asarray(inp['vals'])
    ghosts = lay.exchange(v)
    out = {mode: lay.gather(ghosts, mode)
           for mode in ('sum', 'mean', 'any', 'local')}
    out.update(ghosts=ghosts, all=lay.gather(ghosts, 'all'),
               mask=lay.ghost_mask(), pair=jnp.concatenate(
                   lay.exchange(v, 2 * v)), pos=lay.exchange(X),
               grid0=lay.exchange_grid0(X[:, 0]))
    d = jnp.asarray(np.random.RandomState(4).uniform(0.5, 1.5,
                                                     RANKS * _nslots()))
    out['data_max'] = lay.gather(d, 'max')
    out['data_prod'] = lay.gather(d, 'prod')
    out['ufunc_arctan2'] = lay.gather(ghosts, np.arctan2)
    out['data_ufunc_lambda'] = lay.gather(d, lambda a, b: a + 2 * b)
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.mark.parametrize("key", GATHER_KEYS)
def test_uneven_gather(port, key):
    """the exchange and the gather modes on the padded slabs, exactly
    (arctan2 within 1e-15)"""
    ref = _jax_gather()[key]
    got = port('gather')
    if key == 'pair':
        got = np.concatenate([_cat([g['pair'][i] for g in got])
                              for i in (0, 1)])
    else:
        got = _cat(got, key)
    rtol = 1e-15 if key.endswith('arctan2') else 0
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=0)


def _load_by_definition(load, X, n, world, box=None):
    """the load's definition on the ghost counts: every particle sent is
    received, a rank paints its block and what it receives (the
    sentinels of the last block deducted), residents are the block's
    particles homed in its slab"""
    X = np.asarray(X)
    nl = -(-len(X) // world)
    rows = -(-n // world)
    assert load['ghosts_sent'].sum() == load['ghosts_recv'].sum()
    work = nl + load['ghosts_recv']
    work[-1] -= nl * world - len(X)
    np.testing.assert_array_equal(load['paint_work'], work)
    assert load['imbalance'] == work.max() / work.mean()
    g = X[:, 0] * (n / (n if box is None else box))
    home = np.floor(np.mod(g, n)) // rows
    blocks = np.arange(len(X)) // nl
    np.testing.assert_array_equal(
        load['residents'], np.bincount(blocks[home == blocks],
                                       minlength=world))


def test_uneven_measure(port):
    """measure_ghosts (with the dead seam slabs in the default kside),
    exactly; measure_load on its definition, as the JAX package's raises
    at a particle count the ranks do not divide (18^3 over 5; it writes
    into a read-only view of a device array, ROADMAP queue 3)"""
    X = jnp.asarray(_inputs()['X'])
    counts, reach = jex.measure_ghosts(_jmesh(RANKS), X[:, 0] * 1.0, N,
                                       X.shape[0], smoothing=1.0)
    with pytest.raises(ValueError, match="read-only"):
        jex.measure_load(_jmesh(RANKS), X[:, 0] * 1.0, N, 1.0)
    got = port('measure')
    for g in got:
        np.testing.assert_array_equal(g['counts'], counts)
        assert g['reach'] == reach
        np.testing.assert_array_equal(g['load']['ghosts_sent'],
                                      got[0]['load']['ghosts_sent'])
    _load_by_definition(got[0]['load'], X, N, RANKS)


# --- paint and readout -------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_paint(label, world=RANKS):
    inp = _inputs()
    n, key, res, box, grad, hs = {
        'cic': (N, 'X', 'cic', None, False, False),
        'tsc': (N, 'X3', 'tsc', None, False, False),
        'box': (N, 'Xbox', 'cic', 37.5, True, False),
        'hsml': (N, 'X', 'cic', None, False, True),
        'empty': (NE, 'XE', 'cic', None, True, False)}[label]
    X = jnp.asarray(inp[key])
    kw = dict(hsml=jnp.asarray(inp['hsml']), hsml_max=HMAX) if hs else {}
    out = {}
    for name, sharded in (('1', False), ('s', True)):
        pm = _jpm(n, box=box, resampler=res, world=world, sharded=sharded)
        lay = pm.decompose(X, smoothing=1.0 * HMAX if hs else None)
        rho = pm.paint(X, layout=lay, **kw)
        out[name] = dict(paint=np.asarray(rho.value),
                         readout=np.asarray(rho.readout(X, layout=lay,
                                                        **kw)))
        if grad:
            out[name]['grad'] = [np.asarray(rho.readout(X, layout=lay,
                                                        gradient=d))
                                 for d in range(3)]
            out[name]['paint_grad'] = np.asarray(
                pm.paint(X, layout=lay, gradient=1).value)
    return out


def _paint_eq(got, ref):
    assert all(g['badness'] == 0.0 for g in got)
    for r in ref.values():
        for k in ('paint', 'paint_free'):
            assert _rel(r['paint'], _assemble([g[k] for g in got])) <= TOL
        for k in ('readout', 'readout_free'):
            assert _rel(r['readout'], _cat(got, k)) <= TOL
        if 'grad' in r:
            for d in range(3):
                for k in ('grad', 'grad_free'):
                    assert _rel(r['grad'][d],
                                _cat([g[k][d] for g in got])) <= TOL
            assert _rel(r['paint_grad'],
                        _assemble([g['paint_grad'] for g in got])) <= TOL


@pytest.mark.parametrize("label", ['cic', 'tsc', 'box'])
def test_uneven_paint_readout(port, label):
    """the padded paint and readout with a plan and without one, against
    JAX's 5-device and one-device answers, 1e-10 (derivatives in
    simulation units at BoxSize != Nmesh)"""
    _paint_eq(port(label), _jax_paint(label))


def test_uneven_hsml_sentinels(port):
    """per-particle hsml with a static hsml_max against JAX's one-device
    answers, 1e-10.  The last block's sentinels (18^3 over 5 ranks) sit
    in the thin last slab and ghost; the JAX package exchanges their hsml
    as 0, and its window then weighs them NaN: NaN in its 5-device paint
    and readouts with badness 0 (ROADMAP queue 3).  The port gives the
    sentinels hsml 1."""
    ref = _jax_paint('hsml')
    assert np.isnan(ref['s']['paint']).any()
    assert np.isnan(ref['s']['readout']).any()
    _paint_eq(port('hsml'), {'1': ref['1']})


def test_empty_slab_paint_readout(wide):
    """20^3 on 8 ranks: the rank with no rows paints nothing and reads
    through its images; the same against JAX's 8-device and one-device
    answers"""
    got = wide('cic')
    assert got[-1]['paint']['value'].shape[0] == 0
    _paint_eq(got, _jax_paint('empty', WIDE))


# --- the Solver --------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_forces(n, box, key, world=RANKS):
    """JAX's one-device and sharded forces, and the plan parameters its
    tune_exchange fixes (kside, capacity), computed as it computes them:
    its tune_exchange itself raises where the ranks do not divide the
    particle count (its measure_load, ROADMAP queue 3)"""
    X = jnp.asarray(_inputs()[key])
    out = {}
    for name, sharded in (('1', False), ('s', True)):
        s = JaxSolver(_jpm(n, box=box, world=world, sharded=sharded))
        out[name] = dict(spectral=np.asarray(jax.jit(s.force)(X)),
                         gradient=np.asarray(jax.jit(
                             lambda X: s.force(X, mode='gradient'))(X)))
    fpm = _jpm(n, box=box, world=world)
    g0 = X[:, 0] * float(fpm.affine.scale[0])
    kside = jex._default_kside(1.0, -(-n // world), world, N0=n)
    counts, _ = jex.measure_ghosts(_jmesh(world), g0, n, X.shape[0], 1.0,
                                   kside=kside)
    out['tune'] = dict(kside=kside, capacity=max(16, int(np.ceil(
        float(counts.max()) * 1.5))))
    if X.shape[0] % world == 0:
        out['load'] = jex.measure_load(_jmesh(world), g0, n, 1.0,
                                       kside=kside)
    return out


def _force_eq(got, ref, X, n, world, box):
    for r in (ref['1'], ref['s']):
        for k, m in (('force', 'spectral'), ('staged', 'spectral'),
                     ('tuned', 'spectral'), ('gradient', 'gradient')):
            assert _rel(r[m], _cat(got, k)) <= TOL, k
    for g in got:
        assert g['tune'] == ref['tune']
        for k, v in ref.get('load', {}).items():
            np.testing.assert_array_equal(g['load'][k], v)
    _load_by_definition(got[0]['load'], X, n, world, box)


@pytest.mark.parametrize("label,box,key", [('force', float(N), 'X9'),
                                           ('force_box', 37.5, 'Xbox')])
def test_uneven_force(port, label, box, key):
    """Solver.force (both modes), force_staged and the force after
    tune_exchange against JAX's 5-device and one-device forces, 1e-10;
    the tuned kside and capacity JAX's, the load on its definition"""
    _force_eq(port(label), _jax_forces(N, box, key), _inputs()[key], N,
              RANKS, box)


def test_empty_slab_force(wide):
    """20^3 on 8 ranks: the same, the load exactly JAX's"""
    _force_eq(wide('force'), _jax_forces(NE, float(NE), 'XE', WIDE),
              _inputs()['XE'], NE, WIDE, float(NE))


def _by_id(Q, *arrays, n=N, box=None):
    cell = (n if box is None else box) / n
    i = np.rint(np.asarray(Q, np.float64) / cell).astype(int) % n
    ids = (i[:, 0] * n + i[:, 1]) * n + i[:, 2]
    order = np.argsort(ids)
    assert (ids[order] == np.arange(n ** 3)).all()
    return [np.asarray(a)[order] for a in arrays]


@pytest.mark.parametrize("dtype", ['f4', 'f8'])
def test_uneven_nbody_rebalance(port, dtype):
    """nbody(rebalance=1.0) on the padded slabs: the trigger fires and
    the state, by ID, is JAX's one-device run's within 1e-8 (f8) or 1e-4
    (f4) of max"""
    inp = _inputs()
    tol = TOL_F8 if dtype == 'f8' else TOL_F4
    st = JaxState(*(jnp.asarray(inp[k], dtype) for k in ('Q', 'S0', 'Vn')))
    r1 = JaxSolver(_jpm(dtype=dtype, sharded=False)).nbody(st, NBODY_STEPS)
    S1, V1 = _by_id(r1.Q, r1.S, r1.V)
    got = port('nbody_' + dtype)
    assert all(g['calls'] >= 1 for g in got)
    assert all(g['load']['imbalance'] >= 1.0 for g in got)
    S, V = _by_id(_cat(got, 'Q'), _cat(got, 'S'), _cat(got, 'V'))
    assert _rel(S1, S) <= tol and _rel(V1, V) <= tol


@functools.lru_cache(maxsize=None)
def _jax_ic(compat):
    pm = _jpm(IC['n'], box=IC['box'], sharded=False)
    s = JaxSolver(pm, JPlanck15, B=2)
    noise = pm.generate_whitenoise(IC['seed'], type='complex',
                                   compat=compat)
    real = pm.generate_whitenoise(IC['seed'], type='real', compat=compat)
    dlin = s.linear_field(JEHPower(JPlanck15), IC['seed'], compat=compat)
    st = s.lpt(dlin, IC['a0'], order=2)
    return dict(noise=np.asarray(noise.value), real=np.asarray(real.value),
                dlin=np.asarray(dlin.value), Q=np.asarray(st.Q),
                S=np.asarray(st.S), V=np.asarray(st.V))


@pytest.mark.parametrize("compat", ['gadget', 'native'])
def test_uneven_noise_and_lpt(port, compat):
    """each rank's y block of the noise is bitwise that block of the
    port's one-device fill (and of JAX's for gadget; native within
    1e-15); the real noise, the linear field and the 2LPT state (a 36^3
    B = 2 force mesh, uneven too) against JAX's one-device run, 1e-10"""
    ref = _jax_ic(compat)
    got = port('ic_' + compat)
    noise = _assemble([g['noise'] for g in got])
    own = ParticleMesh([IC['n']] * 3, IC['box'], dtype='f8', device='cpu') \
        .generate_whitenoise(IC['seed'], type='complex', compat=compat)
    np.testing.assert_array_equal(noise, own.value.numpy())
    rtol = 0 if compat == 'gadget' else 1e-15
    np.testing.assert_allclose(noise, ref['noise'], rtol=0,
                               atol=rtol * np.abs(noise).max())
    assert _rel(ref['real'], _assemble([g['real'] for g in got])) <= TOL
    assert _rel(ref['dlin'], _assemble([g['dlin'] for g in got])) <= TOL
    for k in ('Q', 'S', 'V'):
        assert _rel(ref[k], _cat(got, k)) <= TOL


def test_uneven_reductions_and_power(port):
    """csum, cmean, cdot, cnorm of real slabs and their spectra, and
    fftpower, against JAX's 5-device field, 1e-10"""
    inp = _inputs()
    pm = _jpm()
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


def test_uneven_refusals(port):
    """the lattice and binned paths on an uneven mesh raise naming
    ROADMAP item 8e; reverse mode through its exchange (item 8c) gives a
    paint with a grad_fn and a finite gradient"""
    for g in port('refusals'):
        assert all(g.values()) and len(g) == 6, g
