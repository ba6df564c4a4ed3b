"""Rank functions of tests/test_torch_sharded_catalog.py: what each rank
of a ``pmesh_tpu_torch.parallel.launch.spawn`` job runs for the
sharded catalog path (the ghost exchange, the sharded paint and
readout, the noise, the power spectrum and the Solver).

Each takes the rank's ``ProcessMesh`` first and global numpy inputs
after, cuts its own block of the particles (:func:`block`: rows
``[b nl, (b + 1) nl)``, nl = ceil(N / D), the JAX package's device
blocks) and its slab of a mesh, runs the port and returns its own
blocks as numpy, which the test module concatenates and holds against
the JAX package's global answers.  This module imports neither ``jax``
nor the JAX package.  ``run_cases(pm, cases)`` runs a list of
``(name, args)`` of the ``case_*`` functions in one job.
"""
import numpy as np
import torch

from pmesh_tpu_torch import ParticleMesh
from pmesh_tpu_torch.models.fastpm import Solver, State
from pmesh_tpu_torch.ops import power as tpower
from pmesh_tpu_torch.parallel import exchange as ex

CASES = __name__


def _np(x):
    if isinstance(x, dict):
        return {k: _np(v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return tuple(_np(y) for y in x)
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return x


def block(pm, a):
    """this rank's block of the global particle array ``a``"""
    a = np.asarray(a)
    nl = -(-len(a) // pm.size)
    lo = min(pm.rank * nl, len(a))
    return torch.from_numpy(np.ascontiguousarray(a[lo:lo + nl])).to(
        pm.device)


def slab(pm, a):
    """this rank's rows of the global array ``a`` (a mesh, or the
    exchange slots of every rank)"""
    n = len(a) // pm.size
    return torch.from_numpy(np.ascontiguousarray(
        a[pm.rank * n:(pm.rank + 1) * n])).to(pm.device)


def _pm(pm, n, box=None, dtype='f8', resampler='cic'):
    return ParticleMesh([n] * 3, float(n) if box is None else box,
                        dtype=dtype, resampler=resampler, procmesh=pm)


def _plan(lay):
    return dict(send_idx=lay.send_idx, recv_valid=lay.recv_valid,
                badness=float(lay.badness), kside=lay.kside,
                capacity=lay.capacity, nl=lay.nl, npart=lay.npart,
                npart_pad=lay.npart_pad, cost=lay.get_exchange_cost(),
                slots=lay.slots_per_block, recvlength=lay.recvlength)


def _shift(pm8, amount):
    return None if amount is None else pm8.affine.shift(amount)


def case_plan(pm, n, X, kw, shift=None, resampler='cic'):
    """the plan of decompose(**kw) on this rank's block"""
    pm8 = _pm(pm, n, resampler=resampler)
    lay = pm8.decompose(block(pm, X), transform=_shift(pm8, shift), **kw)
    return _plan(lay)


def case_gather(pm, n, X, vals, data):
    """exchange of ``vals`` and its gather in every mode; gathers of the
    per-slot ``data`` (the global slots of every rank) by the reductions
    and ufuncs; the mask, the tuple and grid0 exchanges"""
    pm8 = _pm(pm, n)
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
    out['grid0'] = lay.exchange_grid0(Xb[:, 0])
    out['scalar'] = lay.exchange_scalar(3.0)
    d = slab(pm, data)
    for mode in ('sum', 'mean', 'max', 'min', 'prod'):
        out['data_' + mode] = lay.gather(d, mode)
    for name, fn in (('maximum', np.maximum), ('multiply', np.multiply),
                     ('fmin', np.fmin), ('arctan2', np.arctan2),
                     ('lambda', lambda a, b: a + 2 * b)):
        out['ufunc_' + name] = lay.gather(ghosts, fn)
        out['data_ufunc_' + name] = lay.gather(d, fn)
    try:
        lay.gather(ghosts, object())
    except NotImplementedError:
        out['object_refused'] = True
    return out


def case_paint(pm, n, X, resampler='cic', box=None, shift=None,
               gradient=False, kw=None):
    """paint and readout with the plan; paint and readout without one
    (resharded internally); with ``gradient`` the derivative readouts,
    a derivative paint and readout_vjp's position part"""
    pm8 = _pm(pm, n, box=box, resampler=resampler)
    Xb = block(pm, X)
    t = _shift(pm8, shift)
    lay = pm8.decompose(Xb, transform=t, **(kw or {}))
    rho = pm8.paint(Xb, layout=lay, transform=t)
    out = dict(badness=float(lay.badness), kside=lay.kside,
               paint=rho.value, readout=rho.readout(Xb, layout=lay,
                                                    transform=t),
               paint_free=pm8.paint(Xb, transform=t).value,
               readout_free=rho.readout(Xb, transform=t))
    if gradient:
        out['grad'] = [rho.readout(Xb, layout=lay, transform=t, gradient=d)
                       for d in range(3)]
        out['grad_free'] = [rho.readout(Xb, transform=t, gradient=d)
                            for d in range(3)]
        out['paint_grad'] = pm8.paint(Xb, layout=lay, transform=t,
                                      gradient=1).value
        v = torch.linspace(1.0, 2.0, Xb.shape[0], dtype=Xb.dtype)
        out['vjp'] = rho.readout_vjp(Xb, v, out_self=False, layout=lay,
                                     transform=t)[1]
    return out


def case_hsml(pm, n, X, hsml, hmax):
    """paint and readout with per-particle hsml; a plan too short for
    hsml_max (ValueError) and an hsml past it (NaN)"""
    pm8 = _pm(pm, n)
    Xb, hb = block(pm, X), block(pm, hsml)
    lay = pm8.decompose(Xb, smoothing=1.0 * hmax)
    rho = pm8.paint(Xb, hsml=hb, hsml_max=hmax, layout=lay)
    out = dict(paint=rho.value,
               readout=rho.readout(Xb, hsml=hb, hsml_max=hmax, layout=lay),
               paint_free=pm8.paint(Xb, hsml=hb).value,
               readout_free=rho.readout(Xb, hsml=hb))
    try:
        pm8.paint(Xb, hsml=hb, hsml_max=hmax, layout=pm8.decompose(Xb))
    except ValueError:
        out['short_refused'] = True
    out['over'] = pm8.paint(Xb, hsml=hb * 2.0, hsml_max=hmax,
                            layout=lay).value
    return out


def case_poison(pm, n, X, kw):
    """a poisoned plan (kw makes it breach residency or overflow): its
    badness, paint, readout, exchange and gather"""
    pm8 = _pm(pm, n)
    Xb = block(pm, X)
    lay = pm8.decompose(Xb, **kw)
    rho = pm8.paint(Xb, layout=lay)
    g = lay.exchange(Xb[:, 0])
    return dict(badness=float(lay.badness), paint=rho.value,
                readout=rho.readout(Xb, layout=lay), exchange=g,
                gather=lay.gather(g, 'sum'), plan=_plan(lay))


def case_reshard(pm, n, X, extra):
    """reshard_particles of (X, extra); the plan and paint of the new
    blocks"""
    pm8 = _pm(pm, n)
    Xok, Eok = pm8.reshard_particles(block(pm, X), block(pm, extra))
    lay = pm8.decompose(Xok)
    return dict(X=Xok, extra=Eok, badness=float(lay.badness),
                paint=pm8.paint(Xok, layout=lay).value)


def case_measure(pm, n, X, smoothing, kside=None):
    """measure_ghosts and measure_load of this rank's block"""
    g0 = block(pm, X)[:, 0] * 1.0
    counts, reach = ex.measure_ghosts(pm, g0, n, smoothing, kside=kside)
    return dict(counts=counts, reach=reach,
                load=ex.measure_load(pm, g0, n, smoothing, kside=kside))


def case_force(pm, n, box, X, mode='spectral', dtype='f8', B=1):
    """Solver.force (and force_staged) on this rank's block, before and
    after tune_exchange"""
    s = Solver(_pm(pm, n, box=box, dtype=dtype), B=B)
    Xb = block(pm, X)
    out = dict(force=s.force(Xb, mode=mode))
    if mode == 'spectral':
        out['staged'] = s.force_staged(Xb)
    out['tune'] = s.tune_exchange(Xb)
    out['load'] = s.last_load
    out['tuned'] = s.force(Xb, mode=mode)
    return out


def case_scan(pm, n, X, steps=2):
    """decompose, paint, readout and a drift, ``steps`` times"""
    pm8 = _pm(pm, n)
    Xb = block(pm, X)
    sums = []
    for _ in range(steps):
        lay = pm8.decompose(Xb)
        v = pm8.paint(Xb, layout=lay).readout(Xb, layout=lay)
        Xb = Xb + 1e-3 * v[:, None]
        sums.append(float(ex.comm.all_reduce(v.sum(), pm, 'sum')))
    return dict(X=Xb, sums=sums)


def case_kdk(pm, n, X0, V0, nseg=2, nstep=2):
    """the KDK loop of tests/test_exchange.py with a reshard per
    segment (f4)"""
    pm8 = _pm(pm, n, dtype='f4')
    s = Solver(pm8)
    X, V = block(pm, X0), block(pm, V0)
    for _ in range(nseg):
        X, V = pm8.reshard_particles(X, V)
        for _ in range(nstep):
            F = s.force(X)
            V = V + 0.1 * F
            X = torch.remainder(X + V, float(n))
    return dict(X=X, V=V)


def case_nbody(pm, n, box, dtype, Q, S0, V0, steps, rebalance=1.0):
    """nbody(rebalance=...) from the global state: this rank's final
    (Q, S, V) block, its last load and the reshards made"""
    s = Solver(_pm(pm, n, box=box, dtype=dtype))
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
                on=str(r.S.device))


def case_ic(pm, n, box, dtype, seed, compat, a0, steps):
    """the noise (complex and real), linear_field, lpt (order 2), a
    3-step nbody with rebalance=1.0 and fftpower of the final density"""
    from pmesh_tpu_torch.models.cosmology import Planck15
    from pmesh_tpu_torch.models.powerspectrum import EHPower
    pm8 = _pm(pm, n, box=box, dtype=dtype)
    s = Solver(pm8, Planck15, B=2)
    noise = pm8.generate_whitenoise(seed, type='complex', compat=compat)
    real = pm8.generate_whitenoise(seed, type='real', compat=compat)
    dlin = s.linear_field(EHPower(Planck15), seed, compat=compat)
    st = s.lpt(dlin, a0, order=2)
    r = s.nbody(st, steps, rebalance=1.0)
    k, p, nm = tpower.fftpower(pm8.paint(r.X))
    return dict(noise=noise.value, real=real.value, dlin=dlin.value,
                Q=st.Q, S=st.S, V=st.V, fQ=r.Q, fS=r.S, fV=r.V,
                load=s.last_load, k=k, p=p, nmodes=nm)


def case_reductions(pm, n, x, y):
    """csum, cdot, cnorm of real slabs and of their spectra, and the
    power spectrum of the real field"""
    pm8 = _pm(pm, n)
    a = pm8.create(type='real', value=slab(pm, x))
    b = pm8.create(type='real', value=slab(pm, y))
    ak, bk = a.r2c(), b.r2c()
    k, p, nm = tpower.fftpower(a)
    return dict(csum=a.csum(), cmean=a.cmean(), cdot=a.cdot(b),
                cnorm=a.cnorm(), ccdot=ak.cdot(bk), ccnorm=ak.cnorm(),
                k=k, p=p, nmodes=nm)


def case_coarray(pm):
    """CoArray of this rank's block of a (4D, 2) arange"""
    from pmesh_tpu_torch.parallel.coarray import CoArray
    full = np.arange(8 * pm.size, dtype='f8').reshape(4 * pm.size, 2)
    ca = CoArray(slab(pm, full), pm)
    out = dict(len=len(ca), block1=ca[1], all=ca.allgather(),
               mapped=ca.map(lambda v: v * 2 + 1).allgather())
    try:
        CoArray(torch.zeros(pm.rank + 1), pm)
    except ValueError:
        out['uneven_refused'] = True
    return out


def _raises(fn, exc, match=None):
    try:
        fn()
    except exc as e:
        return match is None or match in str(e)
    return False


def _differentiates(fn, x):
    """whether ``fn()`` carries a grad_fn and its sum of squares a finite
    gradient with respect to ``x``"""
    y = fn()
    g, = torch.autograd.grad((y * y).sum(), x)
    return y.grad_fn is not None and bool(torch.isfinite(g).all())


def case_refusals(pm):
    """what stays refused: the lattice path on the geometries 8a added
    (uneven slabs, replicated meshes, 2-d pencil grids: item 8e, which
    the meshes themselves no longer refuse, nor c2c meshes) and a window
    deeper than the ghost reach (ValueError); gradients through the
    exchange and the sharded paint and readout (8c) are no longer
    refused: each gives a result with a grad_fn and a finite gradient;
    nor are global item access and reshaping and the untransposed layout
    (8d): each answers (tests/test_torch_sharded_access.py holds them
    against the JAX package)"""
    from pmesh_tpu_torch.parallel.pmesh import ProcessMesh
    pm8 = _pm(pm, 8)
    X = torch.rand((64, 3), dtype=torch.float64,
                   generator=torch.Generator().manual_seed(0)) * 8
    Xb = X[pm.rank * 16:(pm.rank + 1) * 16]
    lay = pm8.decompose(Xb)
    rho = pm8.paint(Xb, layout=lay)
    # the gradients on a resharded block, whose plan is not poisoned
    Xr = pm8.reshard_particles(Xb)
    layr = pm8.decompose(Xr)
    rhor = pm8.paint(Xr, layout=layr)
    Xg = Xr.clone().requires_grad_(True)
    meshg = rhor.value.clone().requires_grad_(True)
    m8e = "item 8e"
    from pmesh_tpu_torch.parallel.comm import all_gather, all_reduce
    whole = all_gather(rhor.value, pm)
    c = rhor.r2c()
    # the DC mode lies in the first y block
    mine = c.value[0, 0, 0] if c.start[1] == 0 else c.value.new_zeros(())
    dc = all_reduce(mine.reshape(1), pm)[0].cpu().numpy()
    nl = -(-8 ** 3 // pm.size)
    U = pm8.create(type='untransposedcomplex')
    grid = ProcessMesh(shape=(2, pm.size // 2), device='cpu')

    def lattice(pm8):
        disp = tuple(torch.zeros(pm8.create(type='real').shape,
                                 dtype=torch.float64) for _ in range(3))
        return Solver(pm8).force_lattice(disp, (-1.0, 1.0))
    out = dict(
        uneven=_raises(lambda: lattice(_pm(pm, 2 * pm.size + 2)),
                       NotImplementedError, m8e),
        pencil=_raises(lambda: lattice(_pm(grid, 8)), NotImplementedError,
                       m8e),
        grad_paint=_differentiates(
            lambda: pm8.paint(Xg, layout=layr).value, Xg),
        grad_paint_free=_differentiates(lambda: pm8.paint(Xg).value, Xg),
        grad_readout=_differentiates(lambda: rhor.readout(Xg, layout=layr),
                                     Xg),
        grad_mesh=_differentiates(lambda: ex.readout_sharded(
            layr, meshg, Xr, pm8.affine.scale, 'cic'), meshg),
        grad_exchange=_differentiates(lambda: layr.exchange(Xg), Xg),
        grad_force=_differentiates(lambda: Solver(pm8).force(Xg), Xg),
        cgetitem=bool(c.cgetitem([0, 0, 0]) == dc
                      and rhor.cgetitem([2, 3, 4]) == float(whole[2, 3, 4])),
        ravel=bool(torch.equal(rhor.ravel(), whole.reshape(-1)[
            pm.rank * nl:(pm.rank + 1) * nl])),
        mesh_coordinates=bool(torch.equal(
            pm8.mesh_coordinates(dtype='i8'), pm8._mesh_points())),
        start=bool(rhor.start[0] == 8 // pm.size * pm.rank
                   and tuple(rhor.start[1:]) == (0, 0)
                   and torch.equal(whole[rhor.slices], rhor.value)),
        # the real field's x rows, the half z axis
        untransposed=bool(U.shape == rhor.shape[:2] + (5,)
                          and torch.allclose(rhor.r2c(out=U).c2r().value,
                                             rhor.value)),
        c2c=ParticleMesh([8] * 3, dtype='c16', procmesh=pm).route == 'slab',
        deep=_raises(lambda: _pm(pm, 8, resampler='lanczos3').decompose(Xb),
                     ValueError, "exceeds the kside"))
    return out


def run_cases(pm, cases):
    """the results of ``[(name, args), ...]`` of this module's ``case_*``
    functions, as numpy, in order"""
    g = globals()
    return [_np(g['case_' + name](pm, *args)) for name, args in cases]
