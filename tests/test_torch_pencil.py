"""The port on 2-d (npx, npy) pencil grids, and on 4 slab ranks its c2c,
2-d and replicated meshes, against the JAX package's answers.

The port runs as 4 gloo ranks on the CPU (``parallel/launch.spawn``,
the cases of ``tests/torch_geometry_cases.py``), on the (2, 2) and
(1, 4) grids built over the job's ranks; the JAX package runs
``ProcessMesh(jax.devices()[:4], shape=...)`` on the virtual devices of
``tests/conftest.py``.  The ranks' blocks, assembled, are held against
the JAX package's global arrays (f8, 16^3):

- exact: the route and geometry flags, the plan (send_idx, recv_valid,
  badness, the channels, capacities, 'auto'), the exchange of any array,
  every gather mode and ufunc (arctan2 within 1e-15), the measured
  ghosts and load, the poison of an overflow and of a breach;
- 1e-12 of max: the pencil r2c and c2r (a real mesh, a c2c mesh, and an
  anisotropic (16, 8, 12) mesh);
- 1e-10 of max: the paint and readout (CIC, TSC, hsml, translate,
  derivatives) with a plan and without, the forces, force_staged, the
  linear field and 2LPT, the reductions and fftpower;
- the gadget noise bitwise, the native noise bitwise against the port's
  one-device fill (its uniforms are bitwise JAX's;
  tests/test_torch_whitenoise.py);
- by ID: a 3-step nbody(rebalance=1.0) against the JAX package's
  one-device run, 1e-8 (f8) and 1e-4 (f4).

One fault of the JAX package on grids with a one-rank axis (ROADMAP
queue 3): its pencils paint that axis cut, with no ghost channel along
it, and drop the windows that cross the box's edge there.  On the (1, 4)
grid the port is held to the JAX package's one-device answers, and the
fault itself is shown.  The lattice and binned paths on a pencil mesh
raise, naming ROADMAP item 8e.
"""
import concurrent.futures
import functools
import warnings

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
from pmesh_tpu.parallel import exchange2d as jex2
from pmesh_tpu.parallel.pmesh import ProcessMesh as JaxProcessMesh
from pmesh_tpu_torch import ParticleMesh
from pmesh_tpu_torch.parallel import launch
from torch_geometry_cases import CASES

torch.set_num_threads(1)

RANKS = 4
N = 16
GRIDS = ((2, 2), (1, 4))
TOL = 1e-10
TOL_FFT = 1e-12
TOL_F4 = 1e-4
TOL_F8 = 1e-8
HMAX = 1.8
IC = dict(n=8, box=32.0, seed=3, a0=0.1)
NBODY_STEPS = np.linspace(0.5, 1.0, 4)          # 3 KDK steps
GATHER_KEYS = ('ghosts', 'sum', 'mean', 'any', 'local', 'all', 'mask',
               'pair', 'pos', 'grid0', 'grid1')
REDUCTIONS = ('sum', 'mean', 'max', 'min', 'prod')
UFUNCS = {'maximum': np.maximum, 'multiply': np.multiply, 'fmin': np.fmin,
          'arctan2': np.arctan2, 'lambda': lambda a, b: a + 2 * b}
FFTS = {'real': ((N,) * 3, 'f8'), 'c2c': ((N,) * 3, 'c16'),
        'aniso': ((16, 8, 12), 'f8')}
ROUTES = (((2, 2), 16), ((1, 4), 16), ((4, 1), 16), ((1, 4), 18),
          ((2, 2), (16, 16)), (None, 18), (None, 16), (None, (16, 16)))


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
    inp = dict(X=X, X3=_particles(N, seed=3), X7=_particles(N, seed=7),
               X9=_particles(N, seed=9), Xodd=X[:-13],
               vals=np.arange(N ** 3, dtype='f8') + 2.0,
               hsml=1.0 + np.random.RandomState(2).uniform(0, 0.8,
                                                           (N ** 3,)))
    # blocks moved two y-blocks from home: past ksides (1, 1) on (1, 4)
    inp['Xbad'] = X.copy()
    inp['Xbad'][:, 1] = np.mod(X[:, 1] + N / 2, N)
    box = 37.5
    inp['Xbox'] = (_particles(N, amp=0.0) + np.random.RandomState(5)
                   .uniform(-1, 1, (N ** 3, 3))) * box / N
    r = np.random.RandomState(9)
    inp['Q'] = _particles(N, amp=0.0)
    inp['S0'] = 0.5 * r.normal(size=(N ** 3, 3))
    inp['Vn'] = 0.1 * r.normal(size=(N ** 3, 3))
    inp['x'] = r.normal(size=(N,) * 3)
    inp['y'] = r.normal(size=(N,) * 3)
    inp['X18'] = _particles(18)
    inp['Xwide'] = _particles(4, amp=0.0) + 0.5
    inp['X2d'] = np.random.RandomState(4).uniform(0, N, (300, 2))
    for k, (shape, dtype) in FFTS.items():
        inp['fft_' + k] = _x(shape, dtype)
    inp['fft_2d'] = _x((N, N), 'f8')
    return inp


def _slots(nslots):
    """a distinct value for every exchange slot of every rank"""
    return np.random.RandomState(4).uniform(0.5, 1.5, (RANKS * nslots,))


def _nslots(grid):
    """the slots per rank of the default CIC plan of X at 16^3: the block
    and one block-long channel per Moore offset"""
    nl = N ** 3 // RANKS
    ch = {(2, 2): 3, (1, 4): 3}[grid]
    return nl * (1 + ch)


def _cases(inp):
    c = [('route_%s_%s' % (g, n), 'route', g, (n,)) for g, n in ROUTES]
    for g in GRIDS:
        c += [('%s_fft_%s' % (g, k), 'fft', g, (shape, dtype,
                                                  inp['fft_' + k]))
              for k, (shape, dtype) in FFTS.items()]
        c += [('%s_plan' % (g,), 'plan', g, (N, inp['X'], {})),
              ('%s_plan_auto' % (g,), 'plan', g,
               (N, inp['X'], {'capacity': 'auto'})),
              ('%s_plan_tsc' % (g,), 'plan', g, (N, inp['X3'], {}, None,
                                                 'tsc')),
              ('%s_plan_shift' % (g,), 'plan', g, (N, inp['X7'], {}, -1.25)),
              ('%s_plan_odd' % (g,), 'plan', g,
               (N, inp['Xodd'], {'capacity': 'auto'})),
              ('%s_gather' % (g,), 'gather', g,
               (N, inp['X'], inp['vals'], _slots(_nslots(g)))),
              ('%s_measure' % (g,), 'measure', g, (N, inp['X'], 1.0)),
              ('%s_measure_odd' % (g,), 'measure', g, (N, inp['Xodd'], 1.0)),
              ('%s_cic' % (g,), 'paint', g, (N, inp['X'])),
              ('%s_tsc' % (g,), 'paint', g, (N, inp['X3'], 'tsc')),
              ('%s_shift' % (g,), 'paint', g, (N, inp['X7'], 'cic', None,
                                               0.75, True)),
              ('%s_box' % (g,), 'paint', g, (N, inp['Xbox'], 'cic', 37.5,
                                             None, True)),
              ('%s_hsml' % (g,), 'paint', g, (N, inp['X'], 'cic', None, None,
                                              False, inp['hsml'], HMAX)),
              ('%s_force' % (g,), 'force', g, (N, float(N), inp['X9'])),
              ('%s_force_box' % (g,), 'force', g, (N, 37.5, inp['Xbox'])),
              ('%s_reductions' % (g,), 'reductions', g,
               (N, inp['x'], inp['y'])),
              ('%s_refusals' % (g,), 'refusals', g, (N,))]
        c += [('%s_nbody_%s' % (g, dt), 'nbody', g,
               (N, float(N), dt, inp['Q'], inp['S0'], inp['Vn'],
                NBODY_STEPS)) for dt in ('f8', 'f4')]
        c += [('%s_ic_%s' % (g, compat), 'ic', g,
               (IC['n'], IC['box'], IC['seed'], compat, IC['a0']))
              for compat in ('gadget', 'native')]
    c += [('(1, 4)_breach', 'poison', (1, 4), (N, inp['Xbad'],
                                               {'kside': (1, 1)})),
          ('(2, 2)_overflow', 'poison', (2, 2), (N, inp['X'],
                                                 {'capacity': 1})),
          ('(2, 2)_wide', 'poison', (2, 2), (4, inp['Xwide'], {}, 'tsc'))]
    # the slab route of c2c and 2-d meshes, and the replicated route
    c += [('slab_fft_c2c', 'fft', None, ((N,) * 3, 'c16', inp['fft_c2c'])),
          ('slab_fft_2d', 'fft', None, ((N, N), 'f8', inp['fft_2d'])),
          ('slab_c2c_paint', 'paint', None, (N, inp['X'], 'cic', None, None,
                                             False, None, None, 'c16')),
          ('replicated', 'replicated', None, (18, inp['X18']))]
    return c


@pytest.fixture(scope='module')
def port():
    """{label: [rank results]}, from one 4-rank gloo job started in a
    thread; the fixture returns a function that waits for it"""
    cases = _cases(_inputs())
    labels = [label for label, _, _, _ in cases]
    pool = concurrent.futures.ThreadPoolExecutor(1)
    fut = pool.submit(launch.spawn, CASES + ':run_cases', RANKS, 'gloo',
                      'cpu', [(name, g, args) for _, name, g, args in cases])
    pool.shutdown(wait=False)

    def result(label):
        return [r[labels.index(label)] for r in fut.result()]
    yield result
    fut.result()


@functools.lru_cache(maxsize=None)
def _jgrid(shape):
    return JaxProcessMesh(jax.devices()[:RANKS],
                          shape=None if shape is None else shape)


def _jpm(shape, n=N, box=None, dtype='f8', resampler='cic', sharded=True):
    nm = [n] * 3 if np.isscalar(n) else list(n)
    return JaxPM(Nmesh=nm, BoxSize=float(nm[0]) if box is None else box,
                 dtype=dtype, resampler=resampler,
                 procmesh=_jgrid(shape) if sharded else None)


def _cat(blocks, key=None):
    return np.concatenate([b if key is None else b[key] for b in blocks])


def _assemble(fields):
    """the global field from the ranks' blocks (each written where it
    lies; blocks of replicated fields agree)"""
    at = [f['at'] for f in fields]
    shape = tuple(max(a[d][1] for a in at) for d in range(len(at[0])))
    out = np.zeros(shape, dtype=fields[0]['value'].dtype)
    for f in fields:
        out[tuple(slice(lo, hi) for lo, hi in f['at'])] = f['value']
    return out


def _shift(pm, amount):
    return None if amount is None else pm.affine.shift(amount)


def _plan_eq(got, lay):
    """the ranks' 2-d plans against JAX's ShardedLayout2D, exactly"""
    for b, g in enumerate(got):
        assert tuple(g['offsets']) == lay.offsets
        assert tuple(g['caps']) == lay.caps
        for c in range(len(lay.offsets)):
            np.testing.assert_array_equal(g['send_idx'][c],
                                          np.asarray(lay.send_idx[c])[b])
            np.testing.assert_array_equal(g['recv_valid'][c],
                                          np.asarray(lay.recv_valid[c])[b])
        np.testing.assert_array_equal(g['cost'], lay.get_exchange_cost())
        assert (g['nl'], g['npart'], g['npart_pad'], g['recvlength']) == (
            lay.nl, lay.npart, lay.npart_pad, lay.recvlength)
        assert np.array_equal(np.float32(g['badness']),
                              np.float32(lay.badness), equal_nan=True)


# --- geometry and transforms -------------------------------------------------

@pytest.mark.parametrize("shape,n", ROUTES)
def test_route_matches_jax_flags(port, shape, n):
    """the route each geometry takes, from the JAX package's own flags:
    pencils where the grid divides N0 and N1 of a 3-d mesh, the slab
    where the ranks divide them, replicated elsewhere (a 2-d mesh on a
    2-d grid included, which the JAX package transforms by DFT matmuls)"""
    jp = _jpm(shape, n)
    got = port('route_%s_%s' % (shape, n))
    for g in got:
        assert (g['even'], g['uneven1d'], g['pencil2d']) == (
            jp._even_mesh, jp._uneven1d, jp._pencil2d)
    nd = 3 if np.isscalar(n) else len(n)
    want = ('slab' if jp._even_mesh or jp._uneven1d else
            'pencil' if jp._pencil2d and nd >= 3 else 'replicated')
    assert all(g['route'] == want for g in got)


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("kind", sorted(FFTS))
def test_pencil_fft_matches(port, grid, kind):
    """the pencil r2c and c2r: the blocks assembled are JAX's pencil
    transform (x whole, y over the grid's first axis, the padded z over
    its second, only its real columns kept), and the round trip the
    input, 1e-12"""
    shape, dtype = FFTS[kind]
    x = _inputs()['fft_' + kind]
    got = port('%s_fft_%s' % (grid, kind))
    assert all(g['route'] == 'pencil' for g in got)
    jp = _jpm(grid, shape, dtype=dtype)
    jc = jp.create(type='real', value=jnp.asarray(x)).r2c()
    assert _rel(jc.value, _assemble([g['c'] for g in got])) <= TOL_FFT
    assert _rel(x, _assemble([g['back'] for g in got])) <= TOL_FFT
    assert _rel(jc.c2r().value, _assemble([g['back'] for g in got])) \
        <= TOL_FFT


def test_zero_width_z_block(port):
    """16^3 on the (1, 4) grid: Zh = 9 pads to 12, so the last rank's z
    block is empty, and the transforms still agree (above)"""
    got = port('(1, 4)_fft_real')
    zs = [g['c']['at'][2] for g in got]
    assert zs == [(0, 3), (3, 6), (6, 9), (9, 9)]


# --- the plan, exchange and gather -------------------------------------------

@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("label,key,kw,shift,resampler", [
    ('plan', 'X', {}, None, 'cic'),
    ('plan_auto', 'X', {'capacity': 'auto'}, None, 'cic'),
    ('plan_tsc', 'X3', {}, None, 'tsc'),
    ('plan_shift', 'X7', {}, -1.25, 'cic'),
    ('plan_odd', 'Xodd', {'capacity': 'auto'}, None, 'cic'),
])
def test_decompose2d_builds_layout(port, grid, label, key, kw, shift,
                                   resampler):
    """the plan of every rank is block b of JAX's ShardedLayout2D, bit
    for bit: the ring-unique channels, per-channel capacities ('auto'
    measured), send_idx, recv_valid, badness and the exchange cost"""
    pm = _jpm(grid, resampler=resampler)
    lay = pm.decompose(jnp.asarray(_inputs()[key]),
                       transform=_shift(pm, shift), **kw)
    got = port('%s_%s' % (grid, label))
    _plan_eq(got, lay)
    assert all(g['badness'] == 0.0 for g in got)


@pytest.mark.parametrize("npx,npy,k", [(2, 2, 2), (1, 4, 2), (4, 1, 1),
                                       (3, 5, 2), (8, 1, 2)])
def test_plan_helpers_match(npx, npy, k):
    """the offsets, channels, default ksides and home block against the
    JAX package's (one process)"""
    from pmesh_tpu_torch.parallel import exchange2d as ex2
    assert ex2._axis_offsets(k, npx) == jex2._axis_offsets(k, npx)
    assert ex2._channels2d(k, k, npx, npy) == jex2._channels2d(k, k, npx,
                                                                npy)
    for s in (1.0, 1.5, 4.5):
        assert ex2._default_ksides(s, 16 // npx, 16 // npy) == \
            jex2._default_ksides(s, 16 // npx, 16 // npy)
    g = np.random.RandomState(1).uniform(-16, 32, (2, 500))
    g[:, :3] = ((-1e-7, 16 - 1e-9, 0.0), (16.0, 0.0, -1e-7))
    np.testing.assert_array_equal(
        ex2.home_block2d(torch.from_numpy(g[0]), torch.from_numpy(g[1]),
                         16, 16, npx, npy).numpy(),
        np.asarray(jex2.home_block2d(jnp.asarray(g[0]), jnp.asarray(g[1]),
                                     16, 16, npx, npy)))


@functools.lru_cache(maxsize=None)
def _jax_gather(grid):
    inp = _inputs()
    pm = _jpm(grid)
    X = jnp.asarray(inp['X'])
    lay = pm.decompose(X)
    v = jnp.asarray(inp['vals'])
    ghosts = lay.exchange(v)
    out = {mode: lay.gather(ghosts, mode)
           for mode in ('sum', 'mean', 'any', 'local')}
    out.update(ghosts=ghosts, all=lay.gather(ghosts, 'all'),
               mask=lay.ghost_mask(), pair=jnp.concatenate(
                   lay.exchange(v, 2 * v)), pos=lay.exchange(X),
               grid0=lay.exchange_grid(0, X[:, 0]),
               grid1=lay.exchange_grid(1, X[:, 1]))
    d = jnp.asarray(_slots(_nslots(grid)))
    for mode in REDUCTIONS:
        out['data_' + mode] = lay.gather(d, mode)
    for name, fn in UFUNCS.items():
        out['ufunc_' + name] = lay.gather(ghosts, fn)
        out['data_ufunc_' + name] = lay.gather(d, fn)
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("key", GATHER_KEYS)
def test_gather2d_modes(port, grid, key):
    """the exchange of a particle array, of both grid coordinates and of
    the positions, and each gather mode, exactly"""
    ref = _jax_gather(grid)[key]
    got = port('%s_gather' % (grid,))
    assert got[0]['slots'] == _nslots(grid)
    if key == 'pair':
        # JAX returns each array of the pair over all blocks in turn
        np.testing.assert_array_equal(
            np.concatenate([_cat([g['pair'][i] for g in got])
                            for i in (0, 1)]), ref)
        return
    np.testing.assert_array_equal(_cat(got, key), ref)
    if key in ('mean', 'any', 'local'):
        np.testing.assert_array_equal(ref, _inputs()['vals'])


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("mode", REDUCTIONS + tuple(
    'ufunc_' + k for k in UFUNCS) + tuple('data_ufunc_' + k for k in UFUNCS))
def test_gather2d_ufuncs(port, grid, mode):
    """the reductions and ufuncs on a distinct value per slot and on the
    exchanged values, exactly; arctan2 within 1e-15"""
    key = mode if mode.startswith(('ufunc', 'data_')) else 'data_' + mode
    ref = _jax_gather(grid)[key]
    got = _cat(port('%s_gather' % (grid,)), key)
    rtol = 1e-15 if mode.endswith('arctan2') else 0
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=0)


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("label,key", [('measure', 'X'),
                                       ('measure_odd', 'Xodd')])
def test_measure_ghosts2d_and_load(port, grid, label, key):
    """measure_ghosts2d and measure_load2d, exactly (an uneven count
    padded with the sentinels as the JAX package pads it).  The JAX
    package's measure_load2d raises at an uneven count, as its 1-d one
    does (it writes into a read-only view of a device array; ROADMAP
    queue 3): there the port's load is held to its definition on JAX's
    ghost counts"""
    X = jnp.asarray(_inputs()[key])
    mesh = _jgrid(grid)
    g0, g1 = X[:, 0] * 1.0, X[:, 1] * 1.0
    counts, reach = jex2.measure_ghosts2d(mesh, g0, g1, N, N, X.shape[0],
                                          1.0)
    got = port('%s_%s' % (grid, label))
    for g in got:
        np.testing.assert_array_equal(g['counts'], counts)
        assert tuple(g['reach']) == reach
    if X.shape[0] % RANKS == 0:
        load = jex2.measure_load2d(mesh, g0, g1, N, N, 1.0)
        for g in got:
            for k, v in load.items():
                np.testing.assert_array_equal(g['load'][k], v)
        return
    with pytest.raises(ValueError, match="read-only"):
        jex2.measure_load2d(mesh, g0, g1, N, N, 1.0)
    load = got[0]['load']
    nl = -(-X.shape[0] // RANKS)
    assert load['ghosts_sent'].sum() == load['ghosts_recv'].sum()
    work = nl + load['ghosts_recv']
    work[-1] -= nl * RANKS - X.shape[0]
    np.testing.assert_array_equal(load['paint_work'], work)
    assert load['imbalance'] == work.max() / work.mean()
    npx, npy = grid
    Xn = np.asarray(X)
    home = (np.floor(np.mod(Xn[:, 0], N)) // (N // npx) * npy
            + np.floor(np.mod(Xn[:, 1], N)) // (N // npy))
    blocks = np.arange(X.shape[0]) // nl
    np.testing.assert_array_equal(
        load['residents'], np.bincount(blocks[home == blocks],
                                       minlength=RANKS))


@pytest.mark.parametrize("grid,label,key,kw", [
    ((1, 4), 'breach', 'Xbad', {'kside': (1, 1)}),
    ((2, 2), 'overflow', 'X', {'capacity': 1})])
def test_poison2d(port, grid, label, key, kw):
    """a residency breach and a capacity overflow: JAX's plan and NaN
    badness, and NaN in the paint, readout, exchange and gather of
    every rank"""
    pm = _jpm(grid)
    lay = pm.decompose(jnp.asarray(_inputs()[key]), **kw)
    assert np.isnan(float(lay.badness))
    got = port('%s_%s' % (grid, label))
    _plan_eq([g['plan'] for g in got], lay)
    for g in got:
        for k in ('readout', 'exchange', 'gather'):
            assert np.isnan(g[k]).all(), k
        assert np.isnan(g['paint']['value']).all()


def test_wide_window_breach_poisons(port):
    """a TSC window on the (2, 2) grid at 4^3 (2-row blocks) covers the
    neighbouring block from both sides, which one image cannot paint:
    JAX's plan passes (badness 0) and its paint loses the far side's
    mass; the port poisons (ROADMAP queue 3)"""
    X = jnp.asarray(_inputs()['Xwide'])
    pm = _jpm((2, 2), 4, resampler='tsc')
    lay = pm.decompose(X)
    assert float(lay.badness) == 0.0
    mass = float(np.asarray(pm.paint(X, layout=lay).value).sum())
    assert abs(mass - 4 ** 3) > 1.0
    for g in port('(2, 2)_wide'):
        assert np.isnan(g['plan']['badness'])
        assert np.isnan(g['paint']['value']).all()


# --- paint and readout -------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_paint(grid, label):
    """JAX's answers for a paint case: its one-device paint and readouts,
    and its pencil paint with a plan"""
    inp = _inputs()
    key, res, box, shift, grad, hs = {
        'cic': ('X', 'cic', None, None, False, False),
        'tsc': ('X3', 'tsc', None, None, False, False),
        'shift': ('X7', 'cic', None, 0.75, True, False),
        'box': ('Xbox', 'cic', 37.5, None, True, False),
        'hsml': ('X', 'cic', None, None, False, True)}[label]
    X = jnp.asarray(inp[key])
    kw = dict(hsml=jnp.asarray(inp['hsml']), hsml_max=HMAX) if hs else {}
    out = {}
    for name, sharded in (('1', False), ('p', True)):
        pm = _jpm(grid, box=box, resampler=res, sharded=sharded)
        t = _shift(pm, shift)
        lay = pm.decompose(X, transform=t,
                           smoothing=1.0 * HMAX if hs else None)
        rho = pm.paint(X, layout=lay, transform=t, **kw)
        out[name] = dict(paint=np.asarray(rho.value))
        if sharded:
            continue
        out[name]['readout'] = np.asarray(rho.readout(X, transform=t, **kw))
        if grad:
            out[name]['grad'] = [np.asarray(rho.readout(X, transform=t,
                                                        gradient=d))
                                 for d in range(3)]
            out[name]['paint_grad'] = np.asarray(
                pm.paint(X, transform=t, gradient=1).value)
    return out


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("label", ['cic', 'tsc', 'shift', 'box', 'hsml'])
def test_pencil_paint_readout_match(port, grid, label):
    """paint and readout on the pencils with a plan, and without one
    (resharded, decomposed and routed back), against the JAX package's
    one-device answers, 1e-10 of max (derivatives in simulation units,
    under a translate and at BoxSize != Nmesh; hsml with a static
    hsml_max); on the (2, 2) grid also against JAX's pencil paint"""
    ref = _jax_paint(grid, label)
    got = port('%s_%s' % (grid, label))
    assert all(g['badness'] == 0.0 for g in got)
    for k in ('paint', 'paint_free'):
        assert _rel(ref['1']['paint'], _assemble([g[k] for g in got])) \
            <= TOL
    for k in ('readout', 'readout_free'):
        assert _rel(ref['1']['readout'], _cat(got, k)) <= TOL
    if 'grad' in ref['1']:
        for d in range(3):
            for k in ('grad', 'grad_free'):
                assert _rel(ref['1']['grad'][d],
                            _cat([g[k][d] for g in got])) <= TOL
        assert _rel(ref['1']['paint_grad'],
                    _assemble([g['paint_grad'] for g in got])) <= TOL
    if grid == (2, 2):
        assert _rel(ref['p']['paint'],
                    _assemble([g['paint'] for g in got])) <= TOL


def test_one_rank_axis_fault_of_the_reference():
    """the JAX package's pencil paint on the (1, 4) grid drops the
    windows that cross the box's edge along x, with badness 0 (ROADMAP
    queue 3); the port paints that axis periodically (the test above)"""
    X = jnp.asarray(_inputs()['X'])
    pm = _jpm((1, 4))
    lay = pm.decompose(X)
    assert float(lay.badness) == 0.0
    mass = float(np.asarray(pm.paint(X, layout=lay).value).sum())
    assert abs(mass - N ** 3) > 10.0


# --- the Solver --------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_forces(grid, box, key):
    X = jnp.asarray(_inputs()[key])
    s1 = JaxSolver(_jpm(grid, box=box, sharded=False))
    out = dict(spectral=np.asarray(jax.jit(s1.force)(X)),
               gradient=np.asarray(jax.jit(
                   lambda X: s1.force(X, mode='gradient'))(X)))
    sp = JaxSolver(_jpm(grid, box=box))
    out['tune'] = sp.tune_exchange(X)
    out['load'] = sp.last_load
    if grid == (2, 2):
        out['pencil'] = np.asarray(jax.jit(sp.force)(X))
    return out


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("label,box,key", [('force', float(N), 'X9'),
                                           ('force_box', 37.5, 'Xbox')])
def test_pencil_force_matches(port, grid, label, box, key):
    """Solver.force (both modes), force_staged and the force after
    tune_exchange on the pencils against the JAX package's one-device
    forces (and its pencil force on the (2, 2) grid), 1e-10; the tuned
    ksides, per-channel capacities and load exactly JAX's"""
    ref = _jax_forces(grid, box, key)
    got = port('%s_%s' % (grid, label))
    for k, r in (('force', 'spectral'), ('staged', 'spectral'),
                 ('tuned', 'spectral'), ('gradient', 'gradient')):
        assert _rel(ref[r], _cat(got, k)) <= TOL, k
    if 'pencil' in ref:
        assert _rel(ref['pencil'], _cat(got, 'force')) <= TOL
    for g in got:
        assert tuple(g['tune']['kside']) == tuple(ref['tune']['kside'])
        assert tuple(g['tune']['capacity']) == tuple(ref['tune']['capacity'])
        for k, v in ref['load'].items():
            np.testing.assert_array_equal(g['load'][k], v)
        assert len(g['warned']) == 0


def _by_id(Q, *arrays, n=N, box=None):
    """arrays sorted by the particle IDs their Lagrangian Q give"""
    cell = (n if box is None else box) / n
    i = np.rint(np.asarray(Q, np.float64) / cell).astype(int) % n
    ids = (i[:, 0] * n + i[:, 1]) * n + i[:, 2]
    order = np.argsort(ids)
    assert (ids[order] == np.arange(n ** 3)).all()
    return [np.asarray(a)[order] for a in arrays]


@functools.lru_cache(maxsize=None)
def _jax_nbody(dtype):
    inp = _inputs()
    st = JaxState(*(jnp.asarray(inp[k], dtype) for k in ('Q', 'S0', 'Vn')))
    r = JaxSolver(_jpm(None, dtype=dtype, sharded=False)).nbody(
        st, NBODY_STEPS)
    return _by_id(r.Q, r.S, r.V)


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("dtype", ['f4', 'f8'])
def test_pencil_nbody_rebalance(port, grid, dtype):
    """nbody(rebalance=1.0) on the pencils: the trigger fires, the tuned
    plan is 2-d, and the state, by ID, is the JAX package's one-device
    run's within 1e-8 (f8) or 1e-4 (f4) of max"""
    tol = TOL_F8 if dtype == 'f8' else TOL_F4
    S1, V1 = _jax_nbody(dtype)
    got = port('%s_nbody_%s' % (grid, dtype))
    assert all(g['calls'] >= 1 for g in got)
    assert all(g['load']['imbalance'] >= 1.0 for g in got)
    assert all(len(g['tune']['kside']) == 2 for g in got)
    S, V = _by_id(_cat(got, 'Q'), _cat(got, 'S'), _cat(got, 'V'))
    assert _rel(S1, S) <= tol and _rel(V1, V) <= tol


# --- noise, initial conditions, reductions -----------------------------------

@functools.lru_cache(maxsize=None)
def _jax_ic(compat):
    n, box = IC['n'], IC['box']
    pm = _jpm(None, n, box=box, sharded=False)
    s = JaxSolver(pm, JPlanck15, B=2)
    noise = pm.generate_whitenoise(IC['seed'], type='complex',
                                   compat=compat)
    real = pm.generate_whitenoise(IC['seed'], type='real', compat=compat)
    dlin = s.linear_field(JEHPower(JPlanck15), IC['seed'], compat=compat)
    st = s.lpt(dlin, IC['a0'], order=2)
    return dict(noise=np.asarray(noise.value), real=np.asarray(real.value),
                dlin=np.asarray(dlin.value), Q=np.asarray(st.Q),
                S=np.asarray(st.S), V=np.asarray(st.V))


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("compat", ['gadget', 'native'])
def test_pencil_noise_and_lpt(port, grid, compat):
    """each rank's block of the noise (z blocks past 0 included) is
    bitwise that block of the port's one-device fill, and of JAX's for
    gadget (native within 1e-15: torch's and XLA's sin, cos and log
    differ in the last bit); the real noise, the linear field and the
    2LPT state against JAX's one-device run, 1e-10"""
    n = IC['n']
    ref = _jax_ic(compat)
    got = port('%s_ic_%s' % (grid, compat))
    noise = _assemble([g['noise'] for g in got])
    assert any(g['noise']['at'][2][0] > 0 for g in got)
    own = ParticleMesh([n] * 3, IC['box'], dtype='f8', device='cpu') \
        .generate_whitenoise(IC['seed'], type='complex', compat=compat)
    np.testing.assert_array_equal(noise, own.value.numpy())
    rtol = 0 if compat == 'gadget' else 1e-15
    np.testing.assert_allclose(noise, ref['noise'], rtol=0,
                               atol=rtol * np.abs(noise).max())
    assert _rel(ref['real'], _assemble([g['real'] for g in got])) <= TOL
    assert _rel(ref['dlin'], _assemble([g['dlin'] for g in got])) <= TOL
    for k in ('Q', 'S', 'V'):
        assert _rel(ref[k], _cat(got, k)) <= TOL


@pytest.mark.parametrize("grid", GRIDS)
def test_pencil_reductions_and_power(port, grid):
    """csum, cmean, cdot, cnorm of real pencils and of their spectra
    (the hermitian weights by the global z index), and fftpower, against
    JAX's one-device field, 1e-10"""
    inp = _inputs()
    pm = _jpm(grid, sharded=False)
    a = pm.create(type='real', value=jnp.asarray(inp['x']))
    b = pm.create(type='real', value=jnp.asarray(inp['y']))
    ak, bk = a.r2c(), b.r2c()
    k, p, nm = jpower.fftpower(a)
    ref = dict(csum=a.csum(), cmean=a.cmean(), cdot=a.cdot(b),
               cnorm=a.cnorm(), ccdot=ak.cdot(bk), ccnorm=ak.cnorm(), k=k,
               p=p, nmodes=nm)
    for g in port('%s_reductions' % (grid,)):
        for key, v in ref.items():
            np.testing.assert_allclose(g[key], np.asarray(v), rtol=TOL,
                                       atol=TOL * np.abs(np.asarray(v)).max())


@pytest.mark.parametrize("grid", GRIDS)
def test_pencil_refusals(port, grid):
    """the lattice and binned paths on a pencil mesh raise naming ROADMAP
    item 8e (never the even-slab code); reverse mode through its
    exchange (item 8c) gives a paint with a grad_fn and a finite
    gradient"""
    for g in port('%s_refusals' % (grid,)):
        assert all(g.values()) and len(g) == 6, g


# --- c2c and 2-d meshes on slabs, and the replicated route -------------------

@pytest.mark.parametrize("label,shape,dtype,key", [
    ('slab_fft_c2c', (N,) * 3, 'c16', 'fft_c2c'),
    ('slab_fft_2d', (N, N), 'f8', 'fft_2d')])
def test_slab_c2c_and_2d_fft(port, label, shape, dtype, key):
    """a c2c mesh and a 2-d real mesh on 4 slab ranks: the y blocks
    assembled are JAX's 4-device transform (the 2-d half spectrum's
    Ny // 2 + 1 columns split as N1's blocks), the round trip the
    input, 1e-12"""
    x = _inputs()[key]
    got = port(label)
    assert all(g['route'] == 'slab' for g in got)
    jc = _jpm(None, shape, dtype=dtype).create(
        type='real', value=jnp.asarray(x)).r2c()
    assert _rel(jc.value, _assemble([g['c'] for g in got])) <= TOL_FFT
    assert _rel(x, _assemble([g['back'] for g in got])) <= TOL_FFT


def test_slab_c2c_paint(port):
    """the paint and readout of a c2c mesh on 4 slab ranks (the real
    part carries the mass) against JAX's 4-device c2c mesh, 1e-10"""
    X = jnp.asarray(_inputs()['X'])
    pm = _jpm(None, dtype='c16')
    lay = pm.decompose(X)
    rho = pm.paint(X, layout=lay)
    got = port('slab_c2c_paint')
    assert _rel(rho.value, _assemble([g['paint'] for g in got])) <= TOL
    assert _rel(rho.readout(X, layout=lay), _cat(got, 'readout')) <= TOL


def test_replicated_route(port):
    """18^3 on 4 ranks (no slab reaches across the dead seam): every rank
    holds the whole mesh, decompose warns as the JAX package's does, the
    paint (each rank's particles, summed) with a plan and without, the
    readout, the round trip and a force are JAX's 4-device answers,
    1e-10"""
    X = jnp.asarray(_inputs()['X18'])
    pm = _jpm(None, 18)
    with pytest.warns(RuntimeWarning, match="no sharded particle plan"):
        lay = pm.decompose(X)
    rho = pm.paint(X, layout=lay)
    with warnings.catch_warnings():
        warnings.simplefilter('ignore', RuntimeWarning)
        F = np.asarray(JaxSolver(pm).force(X))
    got = port('replicated')
    for g in got:
        assert g['route'] == 'replicated'
        assert any("no sharded particle plan" in w for w in g['warned'])
        for k in ('paint', 'paint_free'):
            assert g[k]['at'] == ((0, 18),) * 3
            assert _rel(rho.value, g[k]['value']) <= TOL
        assert _rel(rho.value, g['back']['value']) <= TOL
    assert _rel(rho.readout(X, layout=lay), _cat(got, 'readout')) <= TOL
    assert _rel(F, _cat(got, 'force')) <= TOL
