"""Rank functions of tests/test_torch_sharded_access.py: the field API's
global item access, reshaping and untransposed layout (ROADMAP item
8d) on a slab, a 2-d pencil grid, padded uneven slabs and the replicated
route.

Each case takes the job's 1-d ``ProcessMesh`` first, then the grid
shape it runs on (None: the job's 1-d grid; (npx, npy): a 2-d grid over
the same ranks, ``torch_geometry_cases.grid``) and global numpy inputs.
A rank cuts its own block of a field (its ``local_block``), runs the
port and returns its blocks as numpy with the block's position, which
the test module assembles and holds against the JAX package's global
answers.  This module imports neither ``jax`` nor the JAX package;
``run_cases(pm, cases)`` runs a list of ``(name, shape, args)`` in one
job, and the cases also run in one process on a one-rank
``ProcessMesh(device='cpu')`` for the port's one-device answers.
"""
import numpy as np
import torch

from pmesh_tpu_torch import ParticleMesh
from torch_geometry_cases import grid, mesh_block
from torch_sharded_catalog_cases import _np

CASES = __name__


def _pm(mesh, n, dtype='f8'):
    return ParticleMesh((n,) * 3, float(n), dtype=dtype, procmesh=mesh)


def _field(f):
    """a field's block and where it lies in the global field"""
    return dict(value=f.value, at=f.pm.local_block(type(f)))


def _real(pm8, x):
    return pm8.create(type='real', value=mesh_block(pm8, x))


def case_access(pm, shape, n, x, index, sets, up, down):
    """every method of item 8d on the global real field ``x`` (n^3):
    start/slices, ravel/unravel (real and complex), mesh_coordinates,
    cgetitem at ``index`` and csetitem of ``sets`` ((index, value) pairs)
    on its spectrum, ctranspose, resample of the spectrum to ``up``^3
    and ``down``^3, preview, and the untransposed layout"""
    mesh = grid(pm, shape)
    pm8 = _pm(mesh, n)
    r = _real(pm8, x)
    c = r.r2c()
    out = dict(route=pm8.route, blocked=pm8.blocked, rank=pm.rank,
               start=r.start, slices=[(s.start, s.stop) for s in r.slices],
               cstart=c.start, real=_field(r), complex=_field(c))
    flat = r.ravel()
    back = pm8.create(type='real')
    back.unravel(flat)
    cflat = c.ravel()
    cback = pm8.unravel('complex', cflat)
    out.update(ravel=flat, cravel=cflat,
               unravel_equal=bool(torch.equal(back.value, r.value)),
               cunravel_equal=bool(torch.equal(cback.value, c.value)),
               ravel_inplace_equal=bool(torch.equal(r.ravel(out=Ellipsis),
                                                    flat)),
               coords=pm8.mesh_coordinates(), coords_i4=pm8.mesh_coordinates(
                   dtype='i4'))
    try:
        r.ravel(out=np.empty(n ** 3))
        out['ravel_out_refused'] = False
    except ValueError:
        out['ravel_out_refused'] = True
    out['cget'] = [c.cgetitem(i) for i in index]
    s = c.copy()
    out['cset_ret'] = [s.csetitem(i, y) for i, y in sets]
    out['cset'] = _field(s)
    out['cset_get'] = [s.cgetitem(i) for i, _ in sets]
    rs = r.copy()
    out['rset_ret'] = rs.csetitem([1, 2, 3], 7.5)
    out['rset'] = _field(rs)
    t = r.ctranspose((2, 0, 1))
    out['ctranspose'] = _field(t)
    out['ctranspose_route'] = t.pm.route
    for name, m in (('up', up), ('down', down)):
        o = _pm(mesh, m).create(type='real')
        c.resample(o)
        out['resample_' + name] = _field(o)
        oc = _pm(mesh, m).create(type='complex')
        r.resample(oc)
        out['resample_c_' + name] = _field(oc)
    out['preview'] = r.preview(axes=(0, 1))
    out['preview_c'] = c.preview(axes=(2,))
    out['preview_down'] = r.preview(Nmesh=down, axes=(1, 0))
    out['preview_up'] = r.preview(Nmesh=up, axes=(0,))
    # the untransposed layout: r2c into it, c2r out of it, casts both
    # ways, and its coordinates
    U = pm8.create(type='untransposedcomplex')
    u = r.r2c(out=U)
    out['U_is_out'] = u is U
    out['U'] = _field(u)
    out['U_c2r'] = _field(u.c2r())
    out['U_from_T'] = _field(c.cast(type='untransposedcomplex'))
    out['T_from_U'] = _field(u.cast(type='transposedcomplex'))
    out['U_from_real'] = _field(r.cast(type='untransposedcomplex'))
    out['U_k2'] = _field(u.apply(lambda k, v: v * k.normp(2)))
    out['U_cnorm'] = u.cnorm()
    R = pm8.create(type='real')
    out['R_out'] = _field(u.c2r(out=R))
    T = pm8.create(type='transposedcomplex')
    out['T_out'] = _field(r.cast(type='transposedcomplex', out=T))
    return out


def case_grads(pm, shape, n, x, w_down, w_flat, down):
    """d/dx of sum(w_down * resample(x to down^3)) and of sum(w_flat *
    ravel(x)), each rank's share of the loss, this rank's block of the
    gradient; and whether ravel, unravel, resample, ctranspose, the U
    casts and upsample carry a grad_fn"""
    mesh = grid(pm, shape)
    pm8 = _pm(mesh, n)
    pmd = _pm(mesh, down)
    xg = mesh_block(pm8, x).requires_grad_()
    r = pm8.create(type='real', value=xg)
    o = pmd.create(type='real')
    r.resample(o)
    loss = (o.value * mesh_block(pmd, w_down)).sum()
    g_resample, = torch.autograd.grad(loss, xg)
    flat = r.ravel()
    lo = min(mesh.rank * (-(-n ** 3 // mesh.size)), n ** 3) \
        if pm8.blocked else 0
    wf = torch.from_numpy(np.asarray(w_flat)[lo:lo + flat.shape[0]].copy())
    g_ravel, = torch.autograd.grad((flat * wf).sum(), xg)
    calls = dict(
        ravel=lambda: r.ravel(),
        unravel=lambda: pm8.unravel('real', r.ravel()).value,
        resample=lambda: r.resample(pmd.create(type='real')).value,
        ctranspose=lambda: r.ctranspose((1, 2, 0)).value,
        r2c_U=lambda: r.r2c(out=pm8.create(
            type='untransposedcomplex')).value,
        cast_U=lambda: r.r2c().cast(type='untransposedcomplex').value,
        c2r_U=lambda: r.cast(type='untransposedcomplex').c2r().value,
        upsample=lambda: _pm(mesh, 2 * n).upsample(r).value,
        downsample=lambda: pmd.downsample(r).value)
    bad = [k for k, fn in calls.items() if fn().grad_fn is None]
    return dict(resample=g_resample, ravel=g_ravel, bad=bad,
                at=pm8.local_block('real'), blocked=pm8.blocked)


def run_cases(pm, cases):
    """the results of ``[(name, shape, args), ...]`` of this module's
    ``case_*`` functions, as numpy, in order"""
    g = globals()
    return [_np(g['case_' + name](pm, shape, *args))
            for name, shape, args in cases]
