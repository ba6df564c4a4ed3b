"""Rank functions of the sharded tests: what each rank of a
``pmesh_tpu_torch.parallel.launch.spawn`` job runs.

Each takes the rank's ``ProcessMesh`` first, global numpy inputs after,
cuts its own slab with ``convert.to_slabs``, runs the sharded entry
point and returns its own block of the output as numpy (x rows of a real
mesh, the y-chunk of a spectrum), so the caller can reassemble the
global answer rank by rank.  This module imports neither ``jax`` nor
the JAX package, so a spawned rank does not either; the test modules,
which do, hold the blocks against the JAX package's global answers.

``run_cases(pm, cases)`` runs a list of ``(name, args)`` of the ``case_*``
functions in one job, so a test module starts its ranks once.  Spawn a
function of this module as ``CASES + ':function'``.
"""
import sys

import numpy as np
import torch

from pmesh_tpu_torch import convert
from pmesh_tpu_torch.ops import binned as bn
from pmesh_tpu_torch.ops import fft_mxu as fm
from pmesh_tpu_torch.ops import gridpm as gp
from pmesh_tpu_torch.parallel.halo import extend_x, halo_planes

# this module's name as a spawned rank imports it
CASES = __name__


def _np(x):
    if isinstance(x, dict):
        return {k: _np(v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return tuple(_np(y) for y in x)
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return x


def _real(pm, a):
    return convert.to_slabs(a, pm, axis=0)


def _spec(pm, a):
    return convert.to_slabs(a, pm, axis=1)


def case_extend(pm, a, lo, hi):
    """extend_x of the slab of ``a``, and its halo_planes when the halo
    fits one slab"""
    local = _real(pm, a)
    out = {'ext': extend_x(local, lo, hi, pm)}
    if lo <= local.shape[0] and hi <= local.shape[0]:
        out['planes'] = halo_planes(local, lo, hi, pm)
    return out


def case_paint(pm, disp, mass, bounds, window, diffdir=None):
    m = mass if mass is None or np.isscalar(mass) else _real(pm, mass)
    return gp.paint_grid(_real(pm, disp), m, bounds, window, diffdir,
                         procmesh=pm)


def case_readout(pm, meshes, disp, bounds, window, diffdir=None):
    return gp.readout_grid(_real(pm, meshes), _real(pm, disp), bounds,
                           window, diffdir, procmesh=pm)


def case_pfft(pm, nmesh, box, x):
    """r2c of the slab of ``x`` (the y-chunk) and c2r of that (the
    slab) through the ParticleMesh"""
    from pmesh_tpu_torch.pm import ParticleMesh, RealField
    pmesh = ParticleMesh(nmesh, box, dtype=x.dtype, procmesh=pm)
    k = pmesh.create(type=RealField, value=_real(pm, x)).r2c()
    return k.value, k.c2r().value


def case_ct2(pm, x, spec, kvecs, pk2, precision=None, sdt=None):
    """the sharded ct2 operators: the forward of x, the force triple and
    the Poisson potential of the given global spectrum ``spec`` =
    (r, i, nqr, nqi), and the force triple of the own forward"""
    xs = _real(pm, x)
    n2 = x.shape[2]
    fwd = fm.fft3_real_forward_half_ct2_sharded(
        pm, xs, precision=precision, spectrum_dtype=sdt)
    r, i = _spec(pm, spec[0]), _spec(pm, spec[1])
    nqr, nqi = (torch.from_numpy(np.asarray(a)).to(pm.device)
                for a in spec[2:])
    inv = fm.fft3_real_inverse_grad3_half_ct2_sharded(
        pm, r, i, nqr, nqi, n2, kvecs, precision=precision,
        poisson_k2=pk2)
    pot = fm.fft3_poisson_half_ct2_sharded(pm, r, i, nqr, nqi, n2, pk2,
                                           precision=precision)
    forces = fm.fft3_real_inverse_grad3_half_ct2_sharded(
        pm, *fwd, n2, kvecs, precision=precision, poisson_k2=pk2)
    return {'fwd': fwd, 'inv': inv, 'pot': pot, 'forces': forces}


def case_dense(pm, x, spec, kvecs, pk2):
    """the sharded dense operators (kernel-table row 9): the forward of
    x, the force triple of the given filtered global spectrum (r, i) and
    the forces of the own forward with 1/k^2 folded from ``pk2``"""
    xs = _real(pm, x)
    n2 = x.shape[2]
    fwd = fm.fft3_real_forward_half_sharded(pm, xs)
    inv = fm.fft3_real_inverse_grad3_half_sharded(
        pm, _spec(pm, spec[0]), _spec(pm, spec[1]), n2, kvecs)
    forces = fm.fft3_real_inverse_grad3_half_sharded(
        pm, *fwd, n2, kvecs, poisson_k2=pk2)
    return {'fwd': fwd, 'inv': inv, 'forces': forces}


def _solver(pm, nmesh, box, dtype='f4', resampler='cic'):
    from pmesh_tpu_torch.models.fastpm import Solver
    from pmesh_tpu_torch.pm import ParticleMesh
    return Solver(ParticleMesh(nmesh, box, dtype=dtype, resampler=resampler,
                               procmesh=pm))


def case_force(pm, nmesh, box, disp, bounds, mode='spectral', fft='xla'):
    solver = _solver(pm, nmesh, box, disp[0].dtype)
    return solver.force_lattice(_real(pm, disp), bounds, mode=mode, fft=fft)


def case_nbody(pm, nmesh, box, dlinear, a0, steps, bounds, fft='xla',
               order=2):
    """lpt_lattice from the global half spectrum ``dlinear`` (its
    y-chunk), then nbody_lattice: (disp, vel, S, V) slabs"""
    from pmesh_tpu_torch.pm import ComplexField
    solver = _solver(pm, nmesh, box, 'f4')
    dk = solver.pm.create(type=ComplexField, value=_spec(pm, dlinear))
    disp, vel = solver.lpt_lattice(dk, a0, order=order)
    S, V = solver.nbody_lattice(disp, vel, steps, bounds, fft=fft)
    return disp, vel, S, V


def case_rebase(pm, dslots, valid, bounds, extras=(), nslots_out=None):
    out = bn.rebase(_real(pm, dslots), _real(pm, valid), bounds,
                    extras=_real(pm, extras), nslots_out=nslots_out,
                    procmesh=pm)
    return out[:3] + (int(out[3]),)


def case_needed(pm, dslots, valid, bounds):
    return int(bn.needed_slots(_real(pm, dslots), _real(pm, valid), bounds,
                               procmesh=pm))


def case_force_binned(pm, nmesh, box, dslots, valid, bounds,
                      mode='spectral', fft='xla'):
    solver = _solver(pm, nmesh, box, dslots[0][0].dtype)
    return solver.force_binned(_real(pm, dslots), _real(pm, valid), bounds,
                               mode=mode, fft=fft)


def case_nbody_binned(pm, nmesh, box, disp, vel, steps, kw):
    """nbody_binned from the global lattice state: (dslots, vslots,
    valid) slabs, the overflow and the slot count"""
    solver = _solver(pm, nmesh, box, disp[0].dtype)
    ds, vs, va, ov = solver.nbody_binned(_real(pm, disp), _real(pm, vel),
                                         steps, **kw)
    return ds, vs, va, int(ov), len(ds)


def case_comm(pm):
    """the collectives on a (4P, 2P, 3) arange: this rank's x rows
    through the all_to_all (its y-chunk) and back, the all_gather, the
    all_to_all of bf16 and complex copies, the reductions of the rank
    and the bytes staged"""
    from pmesh_tpu_torch.parallel import comm
    P = pm.size
    full = np.arange(4 * P * 2 * P * 3, dtype='f4').reshape(4 * P, 2 * P, 3)
    comm.reset_staged()
    x = _real(pm, full)
    a2a = comm.all_to_all(x, pm, 1, 0)
    chunk = slice(2 * pm.rank, 2 * pm.rank + 2)
    bf = torch.from_numpy(full).to(torch.bfloat16)
    cx = torch.from_numpy(full + 1j * full)
    rank = torch.tensor(float(pm.rank), device=pm.device)
    return {'a2a': a2a, 'back': comm.all_to_all(a2a, pm, 0, 1),
            'gather': comm.all_gather(x, pm, 0),
            'a2a_bf16': comm.all_to_all(_real(pm, bf), pm, 1, 0).float(),
            'a2a_bf16_ref': bf[:, chunk].float(),
            'a2a_complex': comm.all_to_all(_real(pm, cx), pm, 1, 0),
            'sum': float(comm.all_reduce(rank, pm, 'sum')),
            'max': float(comm.all_reduce(rank, pm, 'max')),
            'min': float(comm.all_reduce(rank, pm, 'min')),
            'staged': dict(comm.STAGED_BYTES)}


def modules_loaded(pm):
    """the names of the modules this rank has imported"""
    return sorted(sys.modules)


def nbody_flat(pm, disp, bounds):
    """one KDK step of nbody_lattice from the global displacements
    ``disp`` (zero velocity, an 8^3 mesh): this rank's S[0] slab"""
    solver = _solver(pm, [8] * 3, 8.0)
    d = _real(pm, disp)
    S, _ = solver.nbody_lattice(d, tuple(torch.zeros_like(x) for x in d),
                                [0.5, 0.6], bounds)
    return _np(S[0])


def refusals(pm):
    """what a sharded mesh refuses: the lattice path on an x length the
    ranks do not divide (ROADMAP item 8e; the mesh itself takes the
    replicated route); and reverse mode through the sharded paint, which
    no longer raises: its gradient is finite on every rank"""
    from pmesh_tpu_torch.models.fastpm import Solver
    from pmesh_tpu_torch.pm import ParticleMesh
    out = []
    uneven = ParticleMesh([2 * pm.size + 1, 4, 4], 1.0, procmesh=pm)
    disp = tuple(torch.zeros(uneven.create(type='real').shape)
                 for _ in range(3))
    try:
        Solver(uneven).force_lattice(disp, (-1.0, 1.0))
    except NotImplementedError as e:
        if 'item 8e' in str(e):
            out.append('uneven')
    disp = tuple(torch.full((2, 4, 4), 0.25, requires_grad=True)
                 for _ in range(3))
    rho = gp.paint_grid(disp, procmesh=pm)
    grads = torch.autograd.grad((rho * rho).sum(), disp)
    if rho.grad_fn is not None and all(bool(torch.isfinite(g).all())
                                       for g in grads):
        out.append('grad')
    return out


def run_cases(pm, cases):
    """the results of ``[(name, args), ...]`` of this module's
    ``case_*`` functions, as numpy, in order"""
    g = globals()
    return [_np(g['case_' + name](pm, *args)) for name, args in cases]
