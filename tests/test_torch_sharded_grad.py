"""Reverse and forward mode on the port's sharded routes (ROADMAP item
8c): the collectives, the halo and the distributed transforms as
adjoint pairs, and the gradients of the exchange, the sharded paint and
readout, the lattice, ct2, binned and catalog paths, gathered from the
ranks, against the one-device gradient and ``jax.grad``.

The port runs as gloo ranks on the CPU (``parallel/launch.spawn``, the
cases of ``tests/torch_sharded_grad_cases.py``): one 4-rank job (the
slab route at 16^3 and, at 256 x 256 x 16, the ct2 slab; the (2, 2)
pencil grid built inside it; the replicated route at 18^3) and one
5-rank job (the uneven slabs at 18^3), started once for the module in
threads while the JAX side computes.  A collective that waits past the
jobs' 120 s timeout fails the job and its tests, not the suite.

- adjoint identities, f8, within 1e-12 of |A x| |y| summed over the
  ranks (a replicated side counted once): all_to_all over the mesh and
  over each grid axis (real and complex), all_to_all_v, the ring (four
  hops, one keeping its block) and torus exchanges, all_gather,
  all_reduce and pbroadcast, extend_x one hop and several deep and
  halo_planes, and r2c/c2r on the slab, uneven, pencil, c2c, 2-d and
  replicated geometries;
- against ``jax.grad`` of the JAX package's 4-device function: the
  sharded paint's gradient (``tests/test_exchange.py:300``), 1e-10;
  the sharded lattice paint through the Pallas kernel (interpret mode,
  ``tests/test_sharded_lattice.py:92``), 1e-6; readout_vjp with a plan
  (``tests/test_exchange.py:447``), 1e-10.  ``jax.grad`` of the JAX
  package's sharded r2c raises (ROADMAP queue 3), so its sharded
  catalog force, lpt and nbody have no gradient: the port's sharded
  force is held against ``jax.grad`` of the JAX package's one-device
  force instead, 1e-8;
- against the port's one-device gradient (which
  ``tests/test_torch_catalog_grad.py``, ``test_torch_grad.py`` and
  ``test_torch_binned_grad.py`` hold to ``jax.grad``), at those files'
  tolerances: the catalog 2LPT state, the 3-step nbody(rebalance=1.0)
  and the forward model, in reverse mode and ``torch.func.jvp``, 1e-8
  on every route; the lattice paint and readout 1e-6, force_lattice
  1e-5 (``xla``), 2e-5 (dense ``mxu``), nbody_lattice and lpt_lattice
  1e-4; the ct2 force in the ``mxu``, ``mxu_bf16`` and ``mxu_bf16s``
  forms and the gradient mode 5e-4; force_binned and nbody_binned 1e-8;
  the *_vjp/*_jvp methods 1e-10;
- the replicated route sums once: the readout's mesh gradient is the
  whole gradient on every rank, a readout without ``pbroadcast`` gives
  one rank's share, the paint's mass gradient is not P times too large;
- no silent detach: every sharded entry point given an input that
  requires grad returns a tensor with a grad_fn, or raises naming
  ROADMAP item 8d or 8e; the catalog gradient mode raises a ValueError
  in reverse mode, as on one device.
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
from pmesh_tpu.models.fastpm import Solver as JaxSolver
from pmesh_tpu.ops import gridpm as jgp
from pmesh_tpu.parallel.pmesh import ProcessMesh as JaxProcessMesh
from pmesh_tpu_torch.parallel import launch
from pmesh_tpu_torch.parallel.pmesh import ProcessMesh
from torch_sharded_grad_cases import CASES
import torch_sharded_grad_cases as tc

torch.set_num_threads(1)

N = 16                  # the slab and pencil meshes
NU = 18                 # uneven on 5 ranks, replicated on 4
CT2 = (256, 256, 16)
GRID = (2, 2)
TIMEOUT = 120           # seconds a collective may wait in these jobs
TOL_ADJOINT = 1e-12
TOL_EXACT = 1e-10
TOL_F8 = 1e-8
TOL_GRID = 1e-6
TOL_FORCE_XLA = 1e-5
TOL_FORCE_MXU = 2e-5
TOL_RUN = 1e-4
TOL_CT2 = 5e-4
STEPS = [0.1, 0.3, 0.5, 0.7]        # 2LPT at 0.1, 3 KDK steps


def _particles(n, seed=5, amp=1.0):
    Q = np.stack(np.meshgrid(*[np.arange(n, dtype='f8')] * 3,
                             indexing='ij'), -1).reshape(-1, 3)
    return Q + np.random.RandomState(seed).uniform(-amp, amp, Q.shape)


@functools.lru_cache(maxsize=None)
def _inputs():
    r = np.random.RandomState(11)
    inp = dict(X=_particles(N), Xu=_particles(NU, seed=6),
               Xbox=_particles(N, seed=9) * 37.5 / N,
               v=r.normal(size=N ** 3), w=r.normal(size=(N,) * 3),
               m=r.normal(size=(NU,) * 3))
    for n in (8, 9):
        inp['cat%d' % n] = dict(
            noise=r.normal(size=(n,) * 3), v=r.normal(size=(n,) * 3),
            W=r.normal(size=(n ** 3, 3)),
            S0=r.normal(size=(n ** 3, 3)) * 2.0,
            V0=r.normal(size=(n ** 3, 3)) * 0.5)
    inp['D'] = [r.uniform(0.05, 0.95, (N,) * 3) for _ in range(3)]
    inp['V'] = [r.uniform(-0.3, 0.3, (N,) * 3) for _ in range(3)]
    inp['W'] = [r.normal(size=(N,) * 3) for _ in range(3)]
    inp['Df4'] = [x.astype('f4') for x in inp['D']]
    inp['Vf4'] = [x.astype('f4') for x in inp['V']]
    inp['Wf4'] = [x.astype('f4') for x in inp['W']]
    inp['Dct2'] = [r.uniform(-0.4, 0.4, CT2).astype('f4') for _ in range(3)]
    inp['Wct2'] = [r.normal(size=CT2).astype('f4') for _ in range(3)]
    inp['Vb'] = [r.uniform(-0.3, 0.3, (N,) * 3) for _ in range(3)]
    return inp


def _catalog_args(n):
    c = _inputs()['cat%d' % n]
    return (n, 2, c['noise'], c['v'], c['W'], c['S0'], c['V0'], STEPS)


CT2_FORMS = (('mxu', 'spectral'), ('mxu', 'gradient'),
             ('mxu_bf16', 'spectral'), ('mxu_bf16s', 'spectral'))
FFT_SLAB = [((N,) * 3, 'f8'), ((N,) * 3, 'c16'), ((N, N), 'f8'),
            ((NU,) * 3, 'f8')]
FFT_GRID = [((N,) * 3, 'f8'), ((N, N), 'f8')]


def _cases4(inp):
    c = [('adjoint_comm', None, ()), ('adjoint_comm', GRID, ()),
         ('adjoint_halo', None, ()),
         ('adjoint_exchange', None, (inp['X'],)),
         ('adjoint_exchange', GRID, (inp['X'],)),
         ('adjoint_fft', None, (FFT_SLAB,)),
         ('adjoint_fft', GRID, (FFT_GRID,)),
         ('paint_grad', None, (N, inp['X'], 'cic')),
         ('paint_grad', GRID, (N, inp['X'], 'cic')),
         ('paint_grad', None, (NU, inp['Xu'], 'cic')),
         ('vjp_methods', None, (N, 37.5, inp['Xbox'], inp['v'], inp['w'])),
         ('replicated_sums', None, (NU, inp['Xu'], inp['m'])),
         ('catalog', None, _catalog_args(8)),
         ('catalog', GRID, _catalog_args(8)),
         ('catalog', None, _catalog_args(9)),
         ('lattice', None, (N, inp['D'], inp['V'], inp['W'], 'f8', 'xla')),
         ('lattice', None, (N, inp['Df4'], inp['Vf4'], inp['Wf4'], 'f4',
                            'mxu')),
         ('lattice', None, (N, inp['Df4'], inp['Vf4'], inp['Wf4'], 'f4',
                            'mxu_bf16')),
         ('ct2', None, (CT2, inp['Dct2'], inp['Wct2'], CT2_FORMS)),
         ('binned', None, (N, inp['D'], inp['Vb'], inp['W'])),
         ('grad_fn', None, ()), ('grad_fn', GRID, ())]
    return c


def _cases5(inp):
    return [('adjoint_comm', None, ()), ('adjoint_halo', None, ()),
            ('adjoint_fft', None, ([((NU,) * 3, 'f8')],)),
            ('paint_grad', None, (NU, inp['Xu'], 'cic')),
            ('catalog', None, _catalog_args(9))]


def _keyed(cases):
    """a unique label per case: name, grid, the mesh and the form"""
    out = []
    for name, shape, args in cases:
        key = [name, str(shape)]
        if name in ('paint_grad', 'catalog'):
            key.append(str(args[0]))
        if name == 'lattice':
            key.append(args[-1])
        out.append(" ".join(key))
    return out


def _spawn(world, cases):
    return launch.spawn(CASES + ':run_cases', world, 'gloo', 'cpu', cases,
                        timeout=TIMEOUT)


@pytest.fixture(scope='module')
def port():
    """{world: (labels, future of the job's rank results)}, both jobs
    started in threads; the fixture returns a lookup that waits"""
    inp = _inputs()
    jobs = {4: _cases4(inp), 5: _cases5(inp)}
    pool = concurrent.futures.ThreadPoolExecutor(3)
    futs = {w: pool.submit(_spawn, w, c) for w, c in jobs.items()}
    # the costliest one-device reference, while the ranks run
    _ONE['ct2'] = pool.submit(_run_one, 'ct2',
                              (CT2, inp['Dct2'], inp['Wct2'], CT2_FORMS))
    pool.shutdown(wait=False)

    def result(world, name, shape=None, tag=None):
        labels = _keyed(jobs[world])
        key = " ".join([name, str(shape)] + ([str(tag)] if tag is not None
                                              else []))
        i = labels.index(key)
        return [r[i] for r in futs[world].result()]
    yield result
    for f in futs.values():
        f.exception()


def _run_one(name, args):
    return tc._np(getattr(tc, 'case_' + name)(ProcessMesh(device='cpu'),
                                              None, *args))


_ONE = {}


def one(name, key, args):
    """the port's one-device result of case ``name`` on ``args``"""
    if key not in _ONE:
        _ONE[key] = _run_one(name, args)
    if isinstance(_ONE[key], concurrent.futures.Future):
        _ONE[key] = _ONE[key].result()
    return _ONE[key]


def _rel(ref, got):
    """max|got - ref| / max|ref| (max|got| where ref is all zeros: the
    CIC window's second derivative)"""
    ref, got = np.asarray(ref), np.asarray(got)
    assert ref.shape == got.shape, (ref.shape, got.shape)
    wide = np.complex128 if np.iscomplexobj(ref) else np.float64
    ref, got = ref.astype(wide), got.astype(wide)
    scale = np.abs(ref).max()
    return float(np.abs(got - ref).max() / (scale if scale > 0 else 1.0))


def _cat(blocks):
    return np.concatenate([np.asarray(b) for b in blocks])


def _assemble(parts, shape=None):
    """the global field from the ranks' {value, at} blocks"""
    if shape is None:
        shape = tuple(max(hi for _, hi in [p['at'][d] for p in parts])
                      for d in range(len(parts[0]['at'])))
    out = np.zeros(shape, dtype=np.asarray(parts[0]['value']).dtype)
    for p in parts:
        sl = tuple(slice(lo, hi) for lo, hi in p['at'])
        out[sl] = p['value']
    return out


def _fields(got, key, sub=None):
    """the global field of ``key`` (or of its ``sub``-th entry) from the
    ranks' results, each carrying ``at``"""
    return _assemble([dict(value=g[key] if sub is None else g[key][sub],
                           at=g['at']) for g in got])


# --- adjoint identities -------------------------------------------------------

def _check_adjoint(got):
    for name in got[0]:
        if name.startswith('route'):
            continue
        terms = [g[name] for g in got]
        t0 = terms[0]
        lhs = t0['lhs'] if t0['rep_out'] else sum(t['lhs'] for t in terms)
        rhs = t0['rhs'] if t0['rep_in'] else sum(t['rhs'] for t in terms)
        nax = t0['nax'] if t0['rep_out'] else np.sqrt(
            sum(t['nax'] ** 2 for t in terms))
        ny = t0['ny'] if t0['rep_out'] else np.sqrt(
            sum(t['ny'] ** 2 for t in terms))
        assert abs(lhs - rhs) <= TOL_ADJOINT * nax * ny, (name, lhs, rhs)
        assert nax > 0 and ny > 0, name


@pytest.mark.parametrize("world,shape", [(4, None), (4, GRID), (5, None)])
def test_collectives_are_adjoint(port, world, shape):
    """<A x, y> = <x, A^T y> for every collective, summed over the ranks
    (a replicated side once): all_to_all (real and complex; over the mesh
    and over each grid axis), all_to_all_v, the ring exchange with four
    hops (one keeping its block), the torus exchange, all_gather (its
    output rank-local, its backward the summed cotangents' block),
    all_reduce (identity backward) and pbroadcast (summing backward)"""
    got = port(world, 'adjoint_comm', shape)
    names = set(got[0])
    assert {'all_gather', 'all_reduce', 'pbroadcast'} <= names
    assert ('ring' in names) == (shape is None) == ('all_to_all_v' in names)
    _check_adjoint(got)


@pytest.mark.parametrize("world", [4, 5])
def test_halo_is_adjoint(port, world):
    """extend_x one hop deep and several (lo 6, hi 9 on 4-row slabs) and
    halo_planes: each halo plane's cotangent added back to its owner"""
    _check_adjoint(port(world, 'adjoint_halo'))


@pytest.mark.parametrize("shape", [None, GRID])
def test_exchange_is_adjoint(port, shape):
    """the ghost exchange (1-d plan on the slabs, 2-d on the pencil
    grid), its gather in the linear modes and the reshard's row route:
    the ghosts' cotangents scatter-added back to their particles, the
    rows' sent back to where they came from"""
    got = port(4, 'adjoint_exchange', shape)
    assert {'exchange', 'gather_sum', 'gather_mean', 'gather_any',
            'gather_local', 'reshard'} == set(got[0])
    _check_adjoint(got)


@pytest.mark.parametrize("world,shape,routes", [
    (4, None, {'slab', 'replicated'}), (4, GRID, {'pencil', 'replicated'}),
    (5, None, {'slab'})])
def test_transforms_are_adjoint(port, world, shape, routes):
    """r2c and c2r as real-linear maps, on the even slab (16^3 real, c2c
    and the 16^2 2-d mesh), the uneven slabs (18^3 on 5), the pencil grid
    and the replicated route (18^3 on 4, the 2-d mesh on a 2-d grid),
    through the field API and parallel/pfft"""
    got = port(world, 'adjoint_fft', shape)
    seen = {v for k, v in got[0].items() if k.startswith('route')}
    assert seen == routes
    _check_adjoint(got)


# --- the exchange, the paint and readout, the *_vjp methods ---------------

@pytest.fixture(scope='module')
def jpm():
    return JaxProcessMesh(jax.devices()[:4])


def test_sharded_paint_gradient_matches_jax(port, jpm):
    """d/dX sum(paint(X)^2) with a plan on 4 slab ranks against
    ``jax.grad`` of the JAX package's 4-device paint
    (``tests/test_exchange.py:300``), 1e-10"""
    X = _inputs()['X']
    pm4 = JaxPM(Nmesh=[N] * 3, BoxSize=float(N), dtype='f8', procmesh=jpm)

    def obj(X):
        lay = pm4.decompose(X)
        return jnp.sum(pm4.paint(X, layout=lay).value ** 2)
    want = np.asarray(jax.grad(obj)(jnp.asarray(X)))
    got = port(4, 'paint_grad', None, N)
    assert _rel(want, _cat(g['paint'] for g in got)) <= TOL_EXACT


@pytest.mark.parametrize("world,shape,n,route", [
    (4, None, N, 'slab'), (4, GRID, N, 'pencil'), (5, None, NU, 'slab'),
    (4, None, NU, 'replicated')])
def test_sharded_paint_readout_gradient(port, world, shape, n, route):
    """d/dX of sum(paint^2) + sum(readout^3), with a plan and without one
    (the path that reshards a copy and routes the values back), on every
    route, against the port's one-device gradient, 1e-10"""
    got = port(world, 'paint_grad', shape, n)
    assert got[0]['route'] == route
    X = _inputs()['X' if n == N else 'Xu']
    ref = one('paint_grad', ('paint_grad', n), (n, X, 'cic'))
    for kind in ('paint', 'plan', 'free'):
        assert _rel(ref[kind], _cat(g[kind] for g in got)) <= TOL_EXACT, kind


def test_vjp_methods_with_plan(port, jpm):
    """readout_vjp with a plan on 4 slab ranks (``tests/test_exchange.py
    :447``, BoxSize 37.5 so the derivative units show) against the JAX
    package's 4-device readout_vjp, 1e-10; paint_vjp, paint_jvp,
    readout_jvp, c2r_vjp and r2c_vjp against the port's one device"""
    inp = _inputs()
    got = port(4, 'vjp_methods', None)
    X = _cat(g['X'] for g in got)
    order = np.lexsort(X.T[::-1])
    pm4 = JaxPM(Nmesh=[N] * 3, BoxSize=37.5, dtype='f8', procmesh=jpm)
    Xj = jnp.asarray(inp['Xbox'])
    lay = pm4.decompose(Xj)
    rho = pm4.paint(Xj, layout=lay)
    v = jnp.asarray(inp['v'])
    _, want = rho.readout_vjp(Xj, v, out_self=False, layout=lay)
    ref_order = np.lexsort(inp['Xbox'].T[::-1])
    assert _rel(np.asarray(want)[ref_order],
                _cat(g['out_pos'] for g in got)[order]) <= TOL_EXACT
    ref = one('vjp_methods', 'vjp_methods',
              (N, 37.5, inp['Xbox'], inp['v'], inp['w']))
    for key in ('out_pos', 'pos_bar', 'mass_bar', 'readout_jvp'):
        assert _rel(np.asarray(ref[key])[ref_order],
                    _cat(g[key] for g in got)[order]) <= TOL_EXACT, key
    for key in ('out_self', 'paint_jvp', 'c2r_vjp', 'r2c_vjp'):
        want = np.asarray(ref[key]['value'])
        assert _rel(want, _assemble([g[key] for g in got],
                                    want.shape)) <= TOL_EXACT, key


def test_replicated_route_sums_once(port):
    """18^3 on 4 ranks (the replicated route): the readout's mesh
    gradient is the one-device gradient on every rank (pbroadcast sums
    the ranks' shares); a readout without pbroadcast gives each rank its
    share, which sums to it; the paint's mass gradient through the
    all_reduce is the one-device one, not P times it"""
    inp = _inputs()
    got = port(4, 'replicated_sums', None)
    ref = one('replicated_sums', 'replicated_sums',
              (NU, inp['Xu'], inp['m']))
    assert all(g['route'] == 'replicated' for g in got)
    for g in got:
        assert _rel(ref['mesh'], g['mesh']) <= TOL_EXACT
        assert _rel(ref['mesh'], g['share']) > 0.1
    assert _rel(ref['mesh'], sum(g['share'] for g in got)) <= TOL_EXACT
    assert _rel(ref['mass'], _cat(g['mass'] for g in got)) <= TOL_EXACT


# --- the catalog Solver -------------------------------------------------------

CATALOG = [(4, None, 8, ('slab', 'slab')), (4, GRID, 8, ('pencil', 'pencil')),
           (5, None, 9, ('slab', 'slab')),
           (4, None, 9, ('replicated', 'replicated'))]


@functools.lru_cache(maxsize=None)
def _jax_force_grad(n):
    """jax.grad of sum(F W) through the JAX package's one-device force
    (its sharded r2c has no gradient: ROADMAP queue 3)"""
    c = _inputs()['cat%d' % n]
    pm = JaxPM(Nmesh=[n] * 3, BoxSize=100.0, dtype='f8')
    s = JaxSolver(pm, JPlanck15, B=2)
    Q = np.asarray(pm.generate_uniform_particle_grid(shift=0.0))
    W = jnp.asarray(c['W'])
    return np.asarray(jax.jit(jax.grad(lambda X: jnp.sum(s.force(X) * W)))(
        jnp.asarray(Q + c['S0'])))


@pytest.mark.parametrize("world,shape,n,routes", CATALOG)
def test_catalog_force_gradient_matches_jax(port, world, shape, n, routes):
    """the sharded Solver.force and force_staged, d/dX sum(F W), against
    jax.grad of the JAX package's one-device force, 1e-8; gradient mode
    raises a ValueError in reverse mode, as on one device"""
    got = port(world, 'catalog', shape, n)
    assert got[0]['route'] == routes
    want = _jax_force_grad(n)
    for key in ('force', 'force_staged'):
        assert _rel(want, _cat(g[key] for g in got)) <= TOL_F8, key
    assert all('derivative' in g['gradient_mode'] for g in got)


@pytest.mark.parametrize("world,shape,n,routes", CATALOG)
def test_catalog_gradients_match_one_device(port, world, shape, n, routes):
    """the 2LPT state from the noise, a 3-step nbody(rebalance=1.0) (it
    reshards on the blocked routes) from (S, V), and the forward model
    (2LPT + nbody + the paint) from the noise, gathered from the ranks,
    against the port's one-device gradients, 1e-8; the model's
    torch.func.jvp against the one-device jvp and <grad, v>, 1e-8"""
    got = port(world, 'catalog', shape, n)
    ref = one('catalog', ('catalog', n), _catalog_args(n))
    shape3 = (n,) * 3
    for key in ('lpt', 'model'):
        assert _rel(ref[key], _assemble([dict(value=g[key], at=g['at'])
                                         for g in got], shape3)) <= TOL_F8
    for i in range(2):
        assert _rel(ref['nbody'][i], _cat(g['nbody'][i] for g in got)) \
            <= TOL_F8
    if routes[0] != 'replicated':
        assert got[0]['rebalanced']
    jvp = float(ref['model_jvp'])
    for g in got:
        assert abs(float(g['model_jvp']) - jvp) <= TOL_F8 * abs(jvp)
    assert abs(sum(g['model_dir'] for g in got) / (
        1 if routes[0] != 'replicated' else len(got)) - jvp) \
        <= TOL_F8 * abs(jvp)


# --- the lattice, ct2 and binned paths -----------------------------------------

def test_sharded_lattice_paint_gradient_matches_jax(port, jpm):
    """d/disp sum(paint_grid^2) on 4 slab ranks against jax.grad of the
    JAX package's 4-device Pallas lattice paint (interpret mode;
    ``tests/test_sharded_lattice.py:92``), 1e-6"""
    from jax.sharding import NamedSharding, PartitionSpec as P
    D = _inputs()['D']
    sh = NamedSharding(jpm.mesh, P('x', None, None))
    dsh = tuple(jax.device_put(jnp.asarray(d), sh) for d in D)
    want = jax.grad(lambda d: jnp.sum(jgp.paint_grid(
        d, bounds=(0., 1.), impl='pallas', procmesh=jpm) ** 2))(dsh)
    got = port(4, 'lattice', None, 'xla')
    for i in range(3):
        assert _rel(want[i], _fields(got, 'paint_scalar_mass', i) / 1.3 ** 2
                    ) <= TOL_GRID


@pytest.mark.parametrize("fft", ['xla', 'mxu', 'mxu_bf16'])
def test_sharded_lattice_gradients_match_one_device(port, fft):
    """paint_grid (a mesh mass, a replicated scalar mass) and
    readout_grid, a diffdir readout (native on the CPU), force_lattice
    (spectral and gradient mode), a 2-step nbody_lattice and lpt_lattice
    on 4 slab ranks at 16^3, gathered, against the port's one-device
    gradients at ``tests/test_torch_grad.py``'s tolerances"""
    inp = _inputs()
    f4 = fft != 'xla'
    args = (N, inp['Df4' if f4 else 'D'], inp['Vf4' if f4 else 'V'],
            inp['Wf4' if f4 else 'W'], 'f4' if f4 else 'f8', fft)
    got = port(4, 'lattice', None, fft)
    ref = one('lattice', ('lattice', fft), args)
    tols = dict(paint_mesh_mass=TOL_GRID, paint_scalar_mass=TOL_GRID,
                readout=TOL_GRID, readout_diffdir=TOL_GRID,
                force_spectral=TOL_FORCE_XLA if fft == 'xla'
                else TOL_FORCE_MXU,
                force_gradient=TOL_FORCE_XLA, nbody=TOL_RUN, lpt=TOL_RUN)
    checked = 0
    for key, tol in tols.items():
        if key not in ref:
            continue
        for i, want in enumerate(ref[key]):
            want = np.asarray(want)
            if want.ndim == 0:
                # the replicated scalar mass: the whole gradient everywhere
                for g in got:
                    assert _rel(want, g[key][i]) <= tol, key
            else:
                assert _rel(want, _fields(got, key, i)) <= tol, (key, i)
            checked += 1
    assert checked >= (6 if f4 else 26)
    assert all(g['poisoned'] for g in got)


def test_sharded_ct2_gradients_match_one_device(port):
    """the ct2 fft='mxu' force on a (256, 256, 16) slab over 4 ranks in
    the mxu, mxu_bf16 and mxu_bf16s forms and in gradient mode, d/disp
    sum(F W), gathered, against the port's one-device gradient, 5e-4;
    the transpose's sharded only=d passes equal the triple's members"""
    inp = _inputs()
    got = port(4, 'ct2', None)
    ref = one('ct2', 'ct2', (CT2, inp['Dct2'], inp['Wct2'], CT2_FORMS))
    for fft, mode in CT2_FORMS:
        key = '%s %s' % (fft, mode)
        for i in range(3):
            assert _rel(ref[key][i], _fields(got, key, i)) <= TOL_CT2, key
    assert all(g['only_gap'] == 0.0 for g in got)
    assert ref['only_gap'] == 0.0


def test_sharded_binned_gradients_match_one_device(port):
    """force_binned (spectral and gradient mode) and a 2-step
    nbody_binned with its rebase on 4 slab ranks at 16^3 on the CPU (the
    plain slab rebase over the drift halo), gathered, against the port's
    one-device gradients, 1e-8"""
    inp = _inputs()
    got = port(4, 'binned', None)
    ref = one('binned', 'binned', (N, inp['D'], inp['Vb'], inp['W']))
    for key in ('force_spectral', 'force_gradient', 'nbody'):
        for i, want in enumerate(ref[key]):
            assert _rel(want, _fields(got, key, i)) <= TOL_F8, (key, i)
    assert all(g['overflow'] == 0 for g in got) and ref['overflow'] == 0


@pytest.mark.parametrize("shape", [None, GRID])
def test_no_silent_detach(port, shape):
    """every sharded entry point given an input that requires grad
    returns a tensor with a grad_fn (or raises naming item 8e): the field
    API of item 8d (ravel, unravel, resample, ctranspose, the
    untransposed layout, upsample and downsample) among them"""
    for g in port(4, 'grad_fn', shape):
        assert list(g['bad']) == [], g
