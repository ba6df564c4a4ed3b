"""Rank functions of tests/test_torch_sharded_grad.py: reverse and
forward mode on the sharded routes (ROADMAP item 8c), as each rank of a
``pmesh_tpu_torch.parallel.launch.spawn`` job runs them.

Each case takes the job's 1-d ``ProcessMesh`` first, then the grid shape
it runs on (None: the job's 1-d grid; (npx, npy): a 2-d grid over the
same ranks, ``torch_geometry_cases.grid``) and global numpy inputs.  A
rank cuts its own block of the particles and of the meshes, takes the
gradient (``torch.autograd``, every rank seeding its own loss) or the
tangent (``torch.func.jvp``), and returns its own blocks as numpy with
where they lie, which the test module assembles and holds against the
one-device gradients and ``jax.grad``.  The adjoint cases return, per
rank, the two sides of <A x, y> = <x, A^T y> with the norms that scale
them.  This module imports neither ``jax`` nor the JAX package.
``run_cases(pm, cases)`` runs a list of ``(name, shape, args)`` in one
job.
"""
import numpy as np
import torch

from pmesh_tpu_torch import ParticleMesh, RealField
from pmesh_tpu_torch.models.cosmology import Planck15
from pmesh_tpu_torch.models.fastpm import Solver, State
from pmesh_tpu_torch.models.powerspectrum import EHPower
from pmesh_tpu_torch.ops import binned as bn
from pmesh_tpu_torch.ops import gridpm as gp
from pmesh_tpu_torch.ops import paint as paint_ops
from pmesh_tpu_torch.parallel import comm, halo, pfft
from torch_geometry_cases import grid, mesh_block
from torch_sharded_catalog_cases import _np, block

CASES = __name__


def _pm(mesh, n, box=None, dtype='f8', resampler='cic'):
    shape = (n,) * 3 if np.isscalar(n) else tuple(n)
    return ParticleMesh(shape, float(shape[0]) if box is None else box,
                        dtype=dtype, resampler=resampler, procmesh=mesh,
                        device='cpu')


def _dot(a, b):
    """the real inner product, complex tensors as (re, im) pairs"""
    if a.is_complex():
        a, b = torch.view_as_real(a), torch.view_as_real(b)
    return (a * b).sum()


def _norm(a):
    return float(_dot(a, a).detach()) ** 0.5


def _rand(gen, shape, dtype=torch.float64):
    if dtype.is_complex:
        return torch.complex(torch.randn(shape, generator=gen,
                                         dtype=torch.float64),
                             torch.randn(shape, generator=gen,
                                         dtype=torch.float64))
    return torch.randn(shape, generator=gen, dtype=dtype)


def _adjoint(op, x, y, rep_in=False, rep_out=False):
    """one rank's terms of <A x, y> = <x, A^T y>: A^T y is the gradient
    of the rank's <A x, y> with every rank seeding its own.  A replicated
    side is counted once (the test takes rank 0's)"""
    x = x.clone().requires_grad_()
    ax = op(x)
    lhs = _dot(ax, y)
    xbar, = torch.autograd.grad(lhs, x)
    return dict(lhs=float(lhs.detach()), rhs=float(_dot(x.detach(), xbar)),
                nax=_norm(ax), ny=_norm(y), rep_in=rep_in, rep_out=rep_out)


# --- the adjoint identities -------------------------------------------------

def case_adjoint_comm(pm, shape):
    """<A x, y> = <x, A^T y> for each collective on this grid: the tiled
    all_to_all (over the mesh, or over each grid axis), all_to_all_v,
    the ring exchange with several hops (one that keeps its block), the
    torus exchange, all_gather, all_reduce and pbroadcast"""
    mesh = grid(pm, shape)
    P, r = pm.size, pm.rank
    gen = torch.Generator().manual_seed(100 + r)
    same = torch.Generator().manual_seed(7)
    out = {}
    axes = (mesh,) if shape is None else (mesh.along(0), mesh.along(1))
    for a, ax in enumerate(axes):
        n = ax.size
        x = _rand(gen, (3 * n, 2, 2 * n))
        y = _rand(gen, (3, 2, 2 * n * n))
        out['all_to_all%d' % a] = _adjoint(
            lambda t: comm.all_to_all(t, ax, 0, 2), x, y)
        xc = _rand(gen, (2 * n, 3), torch.complex128)
        yc = _rand(gen, (2, 3 * n), torch.complex128)
        out['all_to_all_c%d' % a] = _adjoint(
            lambda t: comm.all_to_all(t, ax, 0, 1), xc, yc)
    if shape is None:
        counts = [(r + 2 * j) % 3 for j in range(P)]
        recv = [(j + 2 * r) % 3 for j in range(P)]
        x = _rand(gen, (sum(counts), 2))
        y = _rand(gen, (sum(recv), 2))
        out['all_to_all_v'] = _adjoint(
            lambda t: comm.all_to_all_v(t, pm, counts)[0], x, y)
        hops = (1, -1, 2, P)
        xs = [_rand(gen, (3, 2)) for _ in hops]
        ys = [_rand(gen, (3, 2)) for _ in hops]
        out['ring'] = _adjoint(
            lambda t: torch.cat(comm.ring_exchange(
                [(t[3 * i:3 * i + 3], h) for i, h in enumerate(hops)], pm)),
            torch.cat(xs), torch.cat(ys))
    else:
        offs = ((1, 0), (0, 1), (1, 1))
        x = _rand(gen, (3 * len(offs), 2))
        y = _rand(gen, (3 * len(offs), 2))
        out['torus'] = _adjoint(
            lambda t: torch.cat(comm.torus_exchange(
                [(t[3 * i:3 * i + 3], o) for i, o in enumerate(offs)],
                mesh)), x, y)
    x = _rand(gen, (2, 3))
    y = _rand(gen, (2 * P, 3))
    out['all_gather'] = _adjoint(lambda t: comm.all_gather(t, mesh), x, y)
    out['all_reduce'] = _adjoint(lambda t: comm.all_reduce(t, mesh),
                                 _rand(gen, (4, 3)), _rand(same, (4, 3)),
                                 rep_out=True)
    out['pbroadcast'] = _adjoint(lambda t: comm.pbroadcast(t, mesh),
                                 _rand(same, (4, 3)), _rand(gen, (4, 3)),
                                 rep_in=True)
    return out


def case_adjoint_halo(pm, shape):
    """<A x, y> = <x, A^T y> for extend_x one hop deep and several (a
    halo deeper than the 4-row slab), and for halo_planes"""
    gen = torch.Generator().manual_seed(200 + pm.rank)
    rows = 4
    out = {}
    for name, lo, hi in (('one_hop', 1, 2), ('multi_hop', 6, 9)):
        x = _rand(gen, (rows, 3, 2))
        y = _rand(gen, (lo + rows + hi, 3, 2))
        out[name] = _adjoint(lambda t: halo.extend_x(t, lo, hi, pm), x, y)
    x = _rand(gen, (rows, 3, 2))
    y = _rand(gen, (5, 3, 2))
    out['planes'] = _adjoint(
        lambda t: torch.cat(halo.halo_planes(t, 2, 3, pm)), x, y)
    return out


def case_adjoint_exchange(pm, shape, X):
    """<A x, y> = <x, A^T y> for the ghost exchange of this grid's plan
    (the 1-d plan on the slab grid, the 2-d one on a pencil grid), its
    gather in the linear modes ('sum', 'mean', 'any', 'local') and the
    route that sends rows to other ranks (a reshard)"""
    mesh = grid(pm, shape)
    pm8 = _pm(mesh, 16)
    Xb = pm8.reshard_particles(block(pm, X))
    lay = pm8.decompose(Xb)
    gen = torch.Generator().manual_seed(500 + pm.rank)
    n, slots = Xb.shape[0], lay.slots_per_block
    out = {}
    out['exchange'] = _adjoint(lambda t: lay.exchange(t), _rand(gen, (n, 2)),
                               _rand(gen, (slots, 2)))
    for mode in ('sum', 'mean', 'any', 'local'):
        out['gather_' + mode] = _adjoint(
            lambda t: lay.gather(t, mode=mode), _rand(gen, (slots, 2)),
            _rand(gen, (n, 2)))
    # the reshard of a block that is not in x-plane order moves rows
    Xs = block(pm, X)
    m = Xs.shape[0]
    out['reshard'] = _adjoint(
        lambda t: pm8.reshard_particles(Xs, t)[1], _rand(gen, (m, 3)),
        _rand(gen, (pm8.reshard_particles(Xs).shape[0], 3)))
    return out


def case_adjoint_fft(pm, shape, meshes):
    """<A x, y> = <x, A^T y> for the distributed transforms of each
    (Nmesh, dtype) of ``meshes`` on this grid (the route its geometry
    takes): r2c from this rank's real block, c2r from its spectrum
    block, through the field API and through parallel/pfft.py"""
    mesh = grid(pm, shape)
    gen = torch.Generator().manual_seed(300 + pm.rank)
    out = {}
    for nmesh, dtype in meshes:
        pm8 = _pm(mesh, nmesh, dtype=dtype)
        real = pm8.create(type='real')
        cplx = pm8.create(type='complex')
        key = "%s %s %s" % ("x".join(map(str, nmesh)), dtype, pm8.route)
        x = _rand(gen, tuple(real.value.shape), real.value.dtype)
        y = _rand(gen, tuple(cplx.value.shape), cplx.value.dtype)
        out['r2c ' + key] = _adjoint(
            lambda t: pm8.create(type='real', value=t).r2c().value, x, y,
            rep_in=not pm8.blocked, rep_out=not pm8.blocked)
        x = _rand(gen, tuple(cplx.value.shape), cplx.value.dtype)
        y = _rand(gen, tuple(real.value.shape), real.value.dtype)
        out['c2r ' + key] = _adjoint(
            lambda t: pm8.create(type='complex', value=t).c2r().value, x, y,
            rep_in=not pm8.blocked, rep_out=not pm8.blocked)
        out['route ' + key] = pm8.route
        if pm8.route == 'slab':
            x = _rand(gen, tuple(real.value.shape), real.value.dtype)
            y = _rand(gen, tuple(cplx.value.shape), cplx.value.dtype)
            out['pfft ' + key] = _adjoint(
                lambda t: pfft.r2c(mesh, t, nmesh), x, y)
    return out


# --- one device against the ranks ------------------------------------------

def _field_grad(pm8, value):
    return dict(value=value, at=pm8.local_block('real'))


def case_vjp_methods(pm, shape, n, box, X, v, w):
    """the sharded *_vjp / *_jvp methods with a plan (readout_vjp as
    ``tests/test_exchange.py:447`` calls it), and the r2c/c2r vjps, of
    this rank's block"""
    mesh = grid(pm, shape)
    pm8 = _pm(mesh, n, box=box)
    Xb = block(pm, X)
    vb = block(pm, v)
    Xr, vr = pm8.reshard_particles(Xb, vb)
    lay = pm8.decompose(Xr)
    rho = pm8.paint(Xr, layout=lay)
    wf = pm8.create(type='real', value=mesh_block(pm8, w))
    out_self, out_pos = rho.readout_vjp(Xr, vr, layout=lay)
    pos_bar, mass_bar = pm8.paint_vjp(wf, Xr, layout=lay)
    pj = pm8.paint_jvp(Xr, v_pos=torch.ones_like(Xr) * vr[:, None],
                       layout=lay)
    rj = rho.readout_jvp(Xr, v_self=wf, v_pos=torch.ones_like(Xr)
                         * vr[:, None], layout=lay)
    c2r_bar = RealField.c2r_vjp(wf)
    r2c_bar = type(c2r_bar).r2c_vjp(c2r_bar)
    return dict(X=Xr, out_self=_field_grad(pm8, out_self.value),
                out_pos=out_pos, pos_bar=pos_bar, mass_bar=mass_bar,
                paint_jvp=_field_grad(pm8, pj.value), readout_jvp=rj,
                c2r_vjp=dict(value=c2r_bar.value,
                             at=pm8.local_block('complex')),
                r2c_vjp=_field_grad(pm8, r2c_bar.value))


def case_paint_grad(pm, shape, n, X, resampler):
    """d/dX of sum(paint(X)^2) with a plan (``tests/test_exchange.py:300``)
    and, with a plan and without one, of that plus sum(readout(rho,
    X)^3)"""
    mesh = grid(pm, shape)
    pm8 = _pm(mesh, n, resampler=resampler)
    out = {}
    x = block(pm, X).clone().requires_grad_()
    lay = pm8.decompose(x) if pm8.blocked else None
    loss = (pm8.paint(x, layout=lay).value ** 2).sum()
    out['paint'], = torch.autograd.grad(loss, x)
    for kind in ('plan', 'free'):
        x = block(pm, X).clone().requires_grad_()
        lay = pm8.decompose(x) if kind == 'plan' and pm8.blocked else None
        rho = pm8.paint(x, layout=lay)
        # a replicated loss plus rank-local partials: every rank seeds
        # its own (parallel/comm.py)
        loss = (rho.value ** 2).sum() \
            + (rho.readout(x, layout=lay) ** 3).sum()
        g, = torch.autograd.grad(loss, x)
        out[kind] = g
    out['route'] = pm8.route
    return out


def case_replicated_sums(pm, shape, n, X, m):
    """the replicated route both ways: the readout's mesh gradient is the
    whole gradient on every rank (pbroadcast); a readout of the mesh
    without it gives this rank's share only; the paint's mass gradient
    through the all_reduce is the gradient, not P times it"""
    pm8 = _pm(pm, n)
    Xb = block(pm, X)
    mesh = torch.from_numpy(m).clone().requires_grad_()
    val = pm8.create(type='real', value=mesh).readout(Xb)
    g_mesh, = torch.autograd.grad(val.sum(), mesh)
    mesh2 = torch.from_numpy(m).clone().requires_grad_()
    share = paint_ops.readout(mesh2, Xb, window='cic',
                              scale=pm8.affine.scale,
                              period=pm8.affine.period)
    g_share, = torch.autograd.grad(share.sum(), mesh2)
    mass = torch.full((Xb.shape[0],), 1.5, dtype=torch.float64,
                      requires_grad=True)
    rho = pm8.paint(Xb, mass=mass)
    g_mass, = torch.autograd.grad((rho.value ** 2).sum(), mass)
    return dict(route=pm8.route, mesh=g_mesh, share=g_share, mass=g_mass)


def case_catalog(pm, shape, n, B, noise, v, W, S0, V0, steps):
    """the catalog Solver's gradients on this grid's route: force (and
    force_staged) d/dX of sum(F W); the 2LPT state from the white noise
    (shaped as Solver.linear_field does) d/dnoise of sum(S^2 + 2 V^2);
    a 3-step nbody(rebalance=1.0) d/d(S, V) of sum(X^2 + 2 V^2); the
    whole forward model (2LPT + nbody + paint) d/dnoise of sum (rho -
    1)^2 and its torch.func.jvp along ``v``; gradient mode refused in
    reverse mode, as on one device"""
    mesh = grid(pm, shape)
    pm8 = _pm(mesh, n, box=100.0)
    solver = Solver(pm8, Planck15, B=B)
    Q = pm8.generate_uniform_particle_grid(shift=0.0)
    at = pm8.local_block('real')
    out = dict(route=(pm8.route, solver.fpm.route), at=at)
    X = (Q + block(pm, S0)).clone().requires_grad_()
    Wb = block(pm, W)
    out['force'] = torch.autograd.grad((solver.force(X) * Wb).sum(), X)[0]
    out['force_staged'] = torch.autograd.grad(
        (solver.force_staged(X) * Wb).sum(), X)[0]
    try:
        torch.autograd.grad((solver.force(X, mode='gradient') * Wb).sum(),
                            X)
        out['gradient_mode'] = 'no error'
    except ValueError as e:
        out['gradient_mode'] = str(e)
    x = mesh_block(pm8, noise).clone().requires_grad_()
    st = solver.lpt(_linear(solver, x), steps[0], order=2)
    out['lpt'] = torch.autograd.grad((st.S ** 2 + 2 * st.V ** 2).sum(),
                                     x)[0]
    S = block(pm, S0).clone().requires_grad_()
    Vv = block(pm, V0).clone().requires_grad_()
    s3 = Solver(pm8, Planck15, B=B)
    loads = []
    end = s3.nbody(State(Q, S, Vv), steps,
                   monitor=lambda a, st: loads.append(s3.last_load),
                   rebalance=1.0)
    out['nbody'] = torch.autograd.grad(
        (end.X ** 2 + 2 * end.V ** 2).sum(), (S, Vv))
    out['rebalanced'] = pm8.blocked and any(
        ld is not None and ld['imbalance'] > 1.0 for ld in loads)
    xm = mesh_block(pm8, noise).clone().requires_grad_()
    out['model'] = torch.autograd.grad(_model_loss(solver, xm, steps), xm)[0]
    vb = mesh_block(pm8, v)
    _, out['model_jvp'] = torch.func.jvp(
        lambda y: _model_loss(Solver(pm8, Planck15, B=B), y, steps),
        (mesh_block(pm8, noise),), (vb,))
    out['model_dir'] = float((out['model'] * vb).sum())
    return out


def _linear(solver, noise):
    """the white-noise real field ``noise`` shaped as
    Solver.linear_field shapes white noise"""
    power = EHPower(Planck15)

    def convolve(k, v):
        kmag = k.normp(2) ** 0.5
        return v * (power(kmag) / k.BoxSize.prod()) ** 0.5
    return solver.pm.create(type='real', value=noise).r2c().apply(convolve)


def _model_loss(solver, noise, steps):
    """sum (rho - 1)^2 over the force mesh after 2LPT and nbody from the
    white noise (the loss every rank holds)"""
    st = solver.lpt(_linear(solver, noise), steps[0], order=2)
    st = solver.nbody(st, steps)
    fpm = solver.fpm
    rho = fpm.paint(st.X).value * (float(fpm.Nmesh.prod())
                                   / float(solver.pm.Nmesh.prod()))
    return fpm.create(type='real', value=(rho - 1) ** 2).csum()


def case_lattice(pm, shape, n, D, V, W, dtype, fft):
    """the slab lattice path's gradients: paint_grid (displacements, a
    mesh mass, a replicated scalar mass) and readout_grid (two meshes,
    displacements), a diffdir readout (native on the CPU), force_lattice
    spectral and gradient mode d/disp of sum(F W), a 2-step
    nbody_lattice d/d(disp, vel) of sum(S^2 + 2 V^2), and lpt_lattice
    from a real field d/dfield of sum(disp^2 + 2 vel^2)"""
    pmh = pm if pm.size > 1 else None
    pm8 = _pm(pmh, n, dtype=dtype)
    cut = (lambda a: mesh_block(pm8, a))
    out = dict(at=pm8.local_block('real'))
    d = [cut(x).clone().requires_grad_() for x in D]
    w = [cut(x) for x in W]
    if fft == 'xla':
        mm = cut(W[0] * 0.1 + 1.0).clone().requires_grad_()
        ms = torch.tensor(1.3, dtype=d[0].dtype, requires_grad=True)
        rho = gp.paint_grid(d, mass=mm, bounds=(0.0, 1.0), procmesh=pmh)
        out['paint_mesh_mass'] = torch.autograd.grad(
            (rho ** 2).sum(), d + [mm])
        rho = gp.paint_grid(d, mass=ms, bounds=(0.0, 1.0), procmesh=pmh)
        out['paint_scalar_mass'] = torch.autograd.grad(
            (rho ** 2).sum(), d + [ms])
        m1, m2 = (cut(x).clone().requires_grad_() for x in W[1:])
        r = gp.readout_grid((m1, m2), d, bounds=(0.0, 1.0), procmesh=pmh)
        out['readout'] = torch.autograd.grad(
            (r[0] ** 3 + r[0] * r[1]).sum(), d + [m1, m2])
        r = gp.readout_grid(m1, d, bounds=(0.0, 1.0), diffdir=1,
                            procmesh=pmh)
        out['readout_diffdir'] = torch.autograd.grad((r ** 2).sum(),
                                                     d + [m1])
    s = Solver(pm8)
    modes = ('spectral', 'gradient') if fft == 'xla' else ('spectral',)
    for mode in modes:
        F = s.force_lattice(d, (-1.0, 1.0), fft=fft, mode=mode)
        out['force_' + mode] = torch.autograd.grad(
            sum((f * x).sum() for f, x in zip(F, w)), d)
    vel = [cut(x).clone().requires_grad_() for x in V]
    S, Vn = s.nbody_lattice(d, vel, [0.5, 0.52, 0.54], (-1.0, 1.0), fft=fft)
    out['nbody'] = torch.autograd.grad(
        sum((a * a).sum() + 2 * (b * b).sum() for a, b in zip(S, Vn)),
        d + vel)
    # bounds the displacements leave: the poison fires under autograd
    S, Vn = s.nbody_lattice(d, vel, [0.5, 0.52], (-0.01, 0.01), fft=fft)
    out['poisoned'] = all(bool(torch.isnan(x).all()) for x in S + Vn)
    if fft == 'xla':
        x = cut(W[0]).clone().requires_grad_()
        dk = pm8.create(type='real', value=x).r2c()
        disp, vv = s.lpt_lattice(dk, 0.1, order=2)
        out['lpt'] = torch.autograd.grad(
            sum((a * a).sum() + 2 * (b * b).sum() for a, b in zip(disp, vv)),
            x)
    return out


def case_ct2(pm, shape, n, D, W, forms):
    """the ct2 fft='mxu' force at a (256, 256, 16) slab in each DFT form
    of ``forms`` ('mxu' in spectral and gradient mode): d/disp of sum(F
    W); and the transpose's only=d passes against the triple's members"""
    pm8 = _pm(pm, n, dtype='f4')
    cut = (lambda a: mesh_block(pm8, a))
    s = Solver(pm8)
    out = dict(at=pm8.local_block('real'))
    d = [cut(x).clone().requires_grad_() for x in D]
    w = [cut(x) for x in W]
    for fft, mode in forms:
        F = s.force_lattice(d, (-1.0, 1.0), fft=fft, mode=mode)
        out['%s %s' % (fft, mode)] = torch.autograd.grad(
            sum((f * x).sum() for f, x in zip(F, w)), d)
    rho = w[0] * 0.1 + 1.0
    triple = s._mxu_force_raw(rho)
    out['only_gap'] = max(float((s._mxu_force_raw(rho, only=k)
                                 - triple[k]).abs().max())
                          for k in range(3))
    return out


def case_binned(pm, shape, n, D, V, W):
    """the slab binned path on the CPU: force_binned d/dslots of
    sum(valid F W) in both modes, and a 2-step nbody_binned (one rebase
    at its end) d/d(disp, vel) of the sum over its valid slots of (d^2 +
    2 v^2)"""
    pmh = pm if pm.size > 1 else None
    pm8 = _pm(pmh, n)
    cut = (lambda a: mesh_block(pm8, a))
    s = Solver(pm8)
    disp = [cut(x) for x in D]
    vel = [cut(x) for x in V]
    dslots, vslots, valid = bn.from_lattice(disp, vel, nslots=2)
    out = dict(at=pm8.local_block('real'))
    leaves = [[x.clone().requires_grad_() for x in dk] for dk in dslots]
    w = cut(W[0])
    for mode in ('spectral', 'gradient'):
        F = s.force_binned(leaves, valid, (-0.5, 1.5), mode=mode)
        loss = sum((vk * f * w).sum() for vk, fk in zip(valid, F)
                   for f in fk)
        out['force_' + mode] = torch.autograd.grad(
            loss, [x for lk in leaves for x in lk])
    d = [x.clone().requires_grad_() for x in disp]
    v = [x.clone().requires_grad_() for x in vel]
    ds, vs, va, ov = s.nbody_binned(d, v, [0.5, 0.52, 0.54], nslots=2,
                                    rebase_every=2, step_drift=0.25)
    loss = sum((vk * (a * a + 2 * b * b)).sum()
               for vk, dk, wk in zip(va, ds, vs) for a, b in zip(dk, wk))
    out['nbody'] = torch.autograd.grad(loss, d + v)
    out['overflow'] = int(ov)
    return out


def case_grad_fn(pm, shape):
    """every sharded entry point, given inputs that require grad,
    returns a tensor with a grad_fn (or raises naming 8e), the field API
    of item 8d among them: the names of those that do neither"""
    mesh = grid(pm, shape)
    pm8 = _pm(mesh, 8)
    gen = torch.Generator().manual_seed(400)
    X = (torch.rand((64, 3), generator=gen, dtype=torch.float64) * 8)
    X = pm8.reshard_particles(X[pm.rank * 16:(pm.rank + 1) * 16])
    Xg = X.clone().requires_grad_()
    lay = pm8.decompose(X)
    real = pm8.create(type='real')
    fg = real.value.clone().normal_(generator=gen).requires_grad_()
    field = pm8.create(type='real', value=fg)
    s = Solver(pm8)
    calls = dict(
        paint=lambda: pm8.paint(Xg, layout=lay).value,
        paint_free=lambda: pm8.paint(Xg).value,
        readout=lambda: field.readout(Xg, layout=lay),
        readout_free=lambda: field.readout(Xg),
        readout_gradient=lambda: field.readout(X, layout=lay, gradient=0),
        exchange=lambda: lay.exchange(Xg),
        gather=lambda: lay.gather(lay.exchange(Xg), mode='mean'),
        gather_max=lambda: lay.gather(lay.exchange(Xg), mode='max'),
        reshard=lambda: pm8.reshard_particles(Xg),
        r2c=lambda: field.r2c().value,
        c2r=lambda: field.r2c().c2r().value,
        csum=lambda: field.csum(),
        cdot=lambda: field.cdot(field),
        cnorm=lambda: field.r2c().cnorm(),
        force=lambda: s.force(Xg),
        force_staged=lambda: s.force_staged(Xg),
        lattice=lambda: s.force_lattice((fg * 0.1,) * 3, (-1.0, 1.0))[0],
        ravel=lambda: field.ravel(),
        unravel=lambda: pm8.unravel('real', field.ravel()).value,
        resample=lambda: field.resample(_pm(mesh, 4).create(
            type='real')).value,
        ctranspose=lambda: field.ctranspose((2, 0, 1)).value,
        untransposed=lambda: field.r2c(out=pm8.create(
            type='untransposedcomplex')).value,
        untransposed_c2r=lambda: field.cast(
            type='untransposedcomplex').c2r().value,
        upsample=lambda: _pm(mesh, 16).upsample(field).value,
        downsample=lambda: _pm(mesh, 4).downsample(field).value)
    bad = []
    for name, fn in calls.items():
        try:
            y = fn()
        except NotImplementedError as e:
            if 'item 8e' in str(e):
                continue
            raise
        if y.grad_fn is None:
            bad.append(name)
    return dict(bad=bad, route=pm8.route)


def card_lattice_backward(pm, disp, mass, meshes, w, bounds):
    """what each rank of the card-only test runs: the sharded lattice
    paint's (a mesh mass) and readout's (three meshes) gradients on this
    rank's slabs, on the x-halo kernels and on the plain slab forms
    (impl='torch') of the same CUDA tensors, and the kernels' launches
    in each run (forward and backward)"""
    from pmesh_tpu_torch.ops import gridpm_cuda
    dev = pm.device
    rows = disp[0].shape[0] // pm.size

    def cut(a):
        return torch.from_numpy(np.ascontiguousarray(
            a[pm.rank * rows:(pm.rank + 1) * rows])).to(dev)
    W = [cut(x) for x in w]

    def paint_loss(t, impl):
        return (gp.paint_grid(t[:3], mass=t[3], bounds=bounds, impl=impl,
                              procmesh=pm) * W[0]).sum()

    def readout_loss(t, impl):
        out = gp.readout_grid(tuple(t[:3]), t[3:], bounds=bounds,
                              impl=impl, procmesh=pm)
        return sum((o * x).sum() for o, x in zip(out, W))
    out = {}
    for name, fn, arrays in (('paint', paint_loss, list(disp) + [mass]),
                             ('readout', readout_loss,
                              list(meshes) + list(disp))):
        for impl in (None, 'torch'):
            leaves = [cut(a).requires_grad_() for a in arrays]
            gridpm_cuda.reset_launches()
            g = torch.autograd.grad(fn(leaves, impl), leaves)
            if dev.type == 'cuda':
                torch.cuda.synchronize(dev)
            out[name, impl] = dict(
                grads=[x.cpu().numpy() for x in g],
                launches={k: v for k, v in gridpm_cuda.LAUNCHES.items()
                          if v})
    return out


def run_cases(pm, cases):
    """the results of ``[(name, shape, args), ...]`` of this module's
    ``case_*`` functions, as numpy, in order"""
    g = globals()
    return [_np(g['case_' + name](pm, shape, *args))
            for name, shape, args in cases]
