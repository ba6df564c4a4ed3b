"""Rank functions of tests/test_torch_pencil.py and
tests/test_torch_uneven.py: what each rank of a
``pmesh_tpu_torch.parallel.launch.spawn`` job runs on the geometries of
ROADMAP item 8a (2-d pencil grids, padded uneven slabs, the replicated
route, and c2c and 2-d meshes on slabs).

Each case takes the job's 1-d ``ProcessMesh`` first, then the grid
shape it runs on (None: the job's 1-d grid; (npx, npy): a 2-d grid over
the same ranks, built once per shape by every rank together) and global
numpy inputs.  A rank cuts its own block of the particles (block b,
``torch_sharded_catalog_cases.block``) and of a mesh (its
``local_block``), runs the port and returns its own blocks as numpy
with the block's position, which the test module assembles and holds
against the JAX package's global answers.  This module imports neither
``jax`` nor the JAX package.  ``run_cases(pm, cases)`` runs a list of
``(name, shape, args)`` in one job.
"""
import warnings

import numpy as np
import torch

from pmesh_tpu_torch import ParticleMesh
from pmesh_tpu_torch.models.fastpm import Solver, State
from pmesh_tpu_torch.ops import power as tpower
from pmesh_tpu_torch.parallel.pmesh import ProcessMesh
from torch_sharded_catalog_cases import _np, _shift, block

CASES = __name__

_GRIDS = {}


def grid(pm, shape):
    """the 2-d grid of ``shape`` over the job's ranks (made once per
    shape, by every rank in the same order), or the job's 1-d grid"""
    if shape is None:
        return pm
    if shape not in _GRIDS:
        _GRIDS[shape] = ProcessMesh(shape=shape, device=pm.device)
    return _GRIDS[shape]


def _pm(mesh, n, box=None, dtype='f8', resampler='cic'):
    shape = (n,) * 3 if np.isscalar(n) else tuple(n)
    return ParticleMesh(shape, float(shape[0]) if box is None else box,
                        dtype=dtype, resampler=resampler, procmesh=mesh)


def mesh_block(pm8, a, ftype='real'):
    """this rank's block of the global field ``a`` of ``ftype``"""
    sl = tuple(slice(lo, hi) for lo, hi in pm8.local_block(ftype))
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)[sl])).to(
        pm8.device)


def _field(f):
    """a field's block and where it lies in the global field"""
    return dict(value=f.value, at=f.pm.local_block(type(f)))


def _plan(lay):
    if hasattr(lay, 'offsets'):
        return dict(send_idx=list(lay.send_idx),
                    recv_valid=list(lay.recv_valid),
                    badness=float(lay.badness), offsets=lay.offsets,
                    caps=lay.caps, nl=lay.nl, npart=lay.npart,
                    npart_pad=lay.npart_pad, cost=lay.get_exchange_cost(),
                    recvlength=lay.recvlength)
    return dict(send_idx=lay.send_idx, recv_valid=lay.recv_valid,
                badness=float(lay.badness), kside=lay.kside,
                capacity=lay.capacity, nl=lay.nl, npart=lay.npart,
                npart_pad=lay.npart_pad, cost=lay.get_exchange_cost(),
                recvlength=lay.recvlength)


def _rows(pm, a, rows):
    """this rank's ``rows`` rows of the global per-rank array ``a``"""
    a = np.asarray(a)
    return torch.from_numpy(np.ascontiguousarray(
        a[pm.rank * rows:(pm.rank + 1) * rows])).to(pm.device)


def case_route(pm, shape, n, dtype='f8', resampler='cic'):
    """the route and the JAX package's geometry flags"""
    pm8 = _pm(grid(pm, shape), n, dtype=dtype, resampler=resampler)
    return dict(route=pm8.route, even=pm8._even_mesh,
                uneven1d=pm8._uneven1d, pencil2d=pm8._pencil2d,
                real=pm8.local_block('real'),
                complex=pm8.local_block('complex'))


def case_fft(pm, shape, n, dtype, x):
    """r2c of the global field ``x`` and its c2r"""
    pm8 = _pm(grid(pm, shape), n, dtype=dtype)
    r = pm8.create(type='real', value=mesh_block(pm8, x))
    c = r.r2c()
    return dict(c=_field(c), back=_field(c.c2r()), route=pm8.route)


def case_plan(pm, shape, n, X, kw, shift=None, resampler='cic'):
    """the plan of decompose(**kw) on this rank's block"""
    pm8 = _pm(grid(pm, shape), n, resampler=resampler)
    return _plan(pm8.decompose(block(pm, X), transform=_shift(pm8, shift),
                               **kw))


def case_gather(pm, shape, n, X, vals, data):
    """exchange of ``vals`` and its gather in every mode; gathers of the
    per-slot ``data`` (the slots of every rank, in rank order) by the
    reductions and ufuncs; the mask, a pair, the positions and the
    grid coordinates exchanged"""
    mesh = grid(pm, shape)
    pm8 = _pm(mesh, n)
    Xb = block(pm, X)
    lay = pm8.decompose(Xb)
    v = block(pm, vals)
    ghosts = lay.exchange(v)
    out = {mode: lay.gather(ghosts, mode)
           for mode in ('sum', 'mean', 'any', 'local')}
    out['ghosts'] = ghosts
    out['all'] = lay.gather(ghosts, 'all')
    out['mask'] = lay.ghost_mask()
    out['pair'] = lay.exchange(v, 2 * v)
    out['pos'] = lay.exchange(Xb)
    if hasattr(lay, 'offsets'):
        out['grid0'] = lay.exchange_grid(0, Xb[:, 0])
        out['grid1'] = lay.exchange_grid(1, Xb[:, 1])
    else:
        out['grid0'] = lay.exchange_grid0(Xb[:, 0])
    d = _rows(pm, data, lay.slots_per_block)
    for mode in ('sum', 'mean', 'max', 'min', 'prod'):
        out['data_' + mode] = lay.gather(d, mode)
    for name, fn in (('maximum', np.maximum), ('multiply', np.multiply),
                     ('fmin', np.fmin), ('arctan2', np.arctan2),
                     ('lambda', lambda a, b: a + 2 * b)):
        out['ufunc_' + name] = lay.gather(ghosts, fn)
        out['data_ufunc_' + name] = lay.gather(d, fn)
    out['slots'] = lay.slots_per_block
    return out


def case_measure(pm, shape, n, X, smoothing):
    """measure_ghosts and measure_load (the route's) of this rank's
    block"""
    from pmesh_tpu_torch.parallel import exchange as ex
    from pmesh_tpu_torch.parallel import exchange2d as ex2
    mesh = grid(pm, shape)
    Xb = block(pm, X)
    if mesh.is2d:
        g0, g1 = Xb[:, 0] * 1.0, Xb[:, 1] * 1.0
        counts, reach = ex2.measure_ghosts2d(mesh, g0, g1, n, n, smoothing)
        load = ex2.measure_load2d(mesh, g0, g1, n, n, smoothing)
    else:
        g0 = Xb[:, 0] * 1.0
        counts, reach = ex.measure_ghosts(mesh, g0, n, smoothing)
        load = ex.measure_load(mesh, g0, n, smoothing)
    return dict(counts=counts, reach=reach, load=load)


def case_poison(pm, shape, n, X, kw, resampler='cic'):
    """a poisoned plan: its badness, paint, readout, exchange, gather"""
    pm8 = _pm(grid(pm, shape), n, resampler=resampler)
    Xb = block(pm, X)
    lay = pm8.decompose(Xb, **kw)
    rho = pm8.paint(Xb, layout=lay)
    g = lay.exchange(Xb[:, 0])
    return dict(plan=_plan(lay), paint=_field(rho),
                readout=rho.readout(Xb, layout=lay), exchange=g,
                gather=lay.gather(g, 'sum'))


def case_paint(pm, shape, n, X, resampler='cic', box=None, shift=None,
               gradient=False, hsml=None, hmax=None, dtype='f8'):
    """paint and readout with the plan and without one; with
    ``gradient`` the derivative readouts and a derivative paint; with
    ``hsml`` per-particle support scaling"""
    pm8 = _pm(grid(pm, shape), n, box=box, resampler=resampler,
              dtype=dtype)
    Xb = block(pm, X)
    t = _shift(pm8, shift)
    hb = None if hsml is None else block(pm, hsml)
    kw = {} if hsml is None else dict(hsml=hb, hsml_max=hmax)
    lay = pm8.decompose(Xb, transform=t,
                        smoothing=None if hmax is None else 1.0 * hmax)
    rho = pm8.paint(Xb, layout=lay, transform=t, **kw)
    out = dict(badness=float(lay.badness), paint=_field(rho),
               readout=rho.readout(Xb, layout=lay, transform=t, **kw),
               paint_free=_field(pm8.paint(Xb, transform=t, **kw)),
               readout_free=rho.readout(Xb, transform=t, **kw))
    if gradient:
        out['grad'] = [rho.readout(Xb, layout=lay, transform=t, gradient=d)
                       for d in range(3)]
        out['grad_free'] = [rho.readout(Xb, transform=t, gradient=d)
                            for d in range(3)]
        out['paint_grad'] = _field(pm8.paint(Xb, layout=lay, transform=t,
                                             gradient=1))
    return out


def case_force(pm, shape, n, box, X, dtype='f8'):
    """Solver.force in both modes and force_staged on this rank's block,
    before and after tune_exchange"""
    s = Solver(_pm(grid(pm, shape), n, box=box, dtype=dtype))
    Xb = block(pm, X)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter('always')
        out = dict(force=s.force(Xb), gradient=s.force(Xb, mode='gradient'),
                   staged=s.force_staged(Xb))
        out['tune'] = s.tune_exchange(Xb)
        out['load'] = s.last_load
        out['tuned'] = s.force(Xb)
    out['warned'] = [str(x.message) for x in w
                     if issubclass(x.category, RuntimeWarning)]
    return out


def case_nbody(pm, shape, n, box, dtype, Q, S0, V0, steps, rebalance=1.0):
    """nbody(rebalance=...) from the global state: this rank's final
    (Q, S, V) block, its last load and the reshards made"""
    s = Solver(_pm(grid(pm, shape), n, box=box, dtype=dtype))
    calls = []
    orig = s.fpm.reshard_particles

    def counting(*a):
        calls.append(1)
        return orig(*a)
    s.fpm.reshard_particles = counting
    dt = s.pm.torch_dtype
    r = s.nbody(State(*(block(pm, a).to(dt) for a in (Q, S0, V0))), steps,
                rebalance=rebalance)
    return dict(Q=r.Q, S=r.S, V=r.V, load=s.last_load, calls=len(calls),
                tune=s._exch_kwargs)


def case_ic(pm, shape, n, box, seed, compat, a0):
    """the noise (complex and real), linear_field and lpt (order 2)"""
    from pmesh_tpu_torch.models.cosmology import Planck15
    from pmesh_tpu_torch.models.powerspectrum import EHPower
    pm8 = _pm(grid(pm, shape), n, box=box)
    s = Solver(pm8, Planck15, B=2)
    noise = pm8.generate_whitenoise(seed, type='complex', compat=compat)
    real = pm8.generate_whitenoise(seed, type='real', compat=compat)
    dlin = s.linear_field(EHPower(Planck15), seed, compat=compat)
    st = s.lpt(dlin, a0, order=2)
    return dict(noise=_field(noise), real=_field(real), dlin=_field(dlin),
                Q=st.Q, S=st.S, V=st.V)


def case_reductions(pm, shape, n, x, y):
    """csum, cmean, cdot, cnorm of real blocks and of their spectra, and
    the power spectrum of the real field"""
    pm8 = _pm(grid(pm, shape), n)
    a = pm8.create(type='real', value=mesh_block(pm8, x))
    b = pm8.create(type='real', value=mesh_block(pm8, y))
    ak, bk = a.r2c(), b.r2c()
    k, p, nm = tpower.fftpower(a)
    return dict(csum=a.csum(), cmean=a.cmean(), cdot=a.cdot(b),
                cnorm=a.cnorm(), ccdot=ak.cdot(bk), ccnorm=ak.cnorm(),
                k=k, p=p, nmodes=nm)


def case_replicated(pm, shape, n, X):
    """the replicated route: the warning, a paint with a plan and
    without, a readout, a round trip and a force"""
    pm8 = _pm(grid(pm, shape), n)
    Xb = block(pm, X)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter('always')
        lay = pm8.decompose(Xb)
    rho = pm8.paint(Xb, layout=lay)
    return dict(route=pm8.route, warned=[str(x.message) for x in w
                                         if issubclass(x.category,
                                                       RuntimeWarning)],
                paint=_field(rho), paint_free=_field(pm8.paint(Xb)),
                readout=rho.readout(Xb, layout=lay),
                back=_field(rho.r2c().c2r()),
                force=Solver(pm8).force(Xb))


def _raises(fn, exc, match=None):
    try:
        fn()
    except exc as e:
        return match is None or match in str(e)
    return False


def case_refusals(pm, shape, n):
    """the lattice and binned paths on this geometry raise, naming item
    8e; reverse mode through its exchange (item 8c) gives a paint with a
    grad_fn and a finite gradient"""
    pm8 = _pm(grid(pm, shape), n, dtype='f4')
    s = Solver(pm8)
    real = pm8.create(type='real').shape
    disp = tuple(torch.zeros(real) for _ in range(3))
    dlin = pm8.generate_whitenoise(1, type='complex', compat='native')
    Xg = block(pm, np.random.RandomState(0).uniform(
        0, n, (64, 3)).astype('f4')).requires_grad_(True)
    m8e = "item 8e"
    out = dict(
        force_lattice=_raises(lambda: s.force_lattice(disp, (-1.0, 1.0)),
                              NotImplementedError, m8e),
        lpt_lattice=_raises(lambda: s.lpt_lattice(dlin, 0.1),
                            NotImplementedError, m8e),
        nbody_lattice=_raises(lambda: s.nbody_lattice(
            disp, disp, [0.1, 0.2], (-1.0, 1.0)), NotImplementedError, m8e),
        force_binned=_raises(lambda: s.force_binned(
            tuple(d[None] for d in disp), torch.ones((1,) + real,
                                                     dtype=torch.bool),
            (-1.0, 1.0)), NotImplementedError, m8e),
        nbody_binned=_raises(lambda: s.nbody_binned(
            disp, disp, [0.1, 0.2]), NotImplementedError, m8e))
    if pm8.blocked:
        out['grad_paint'] = _differentiates(lambda: pm8.paint(Xg).value, Xg)
    return out


def _differentiates(fn, x):
    """whether ``fn()`` carries a grad_fn and its sum of squares a finite
    gradient with respect to ``x``"""
    y = fn()
    g, = torch.autograd.grad((y * y).sum(), x)
    return y.grad_fn is not None and bool(torch.isfinite(g).all())


def run_cases(pm, cases):
    """the results of ``[(name, shape, args), ...]`` of this module's
    ``case_*`` functions, as numpy, in order"""
    g = globals()
    return [_np(g['case_' + name](pm, shape, *args))
            for name, shape, args in cases]
