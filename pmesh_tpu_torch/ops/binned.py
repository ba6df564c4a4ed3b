"""Binned slot-lattice particles: the general-position fast path.

Counterpart of ``pmesh_tpu/ops/binned.py``.  The lattice path
(``ops/gridpm.py``) needs displacements inside static bounds, and its
cost grows as nv^3 with them.  This module keeps any particle
distribution in *slot-lattice* form: ``nslots`` mesh-shaped
sub-lattices, slot k of cell c holding the k-th particle homed in c as
a per-axis displacement in [0, 1) (cells):

    disp[k][d] : (mesh) per-axis displacement of slot k
    valid[k]   : (mesh) 1.0 where the slot holds a particle

- paint  = sum_k lattice-paint(disp_k, mass=valid_k);
- readout = per-slot lattice readouts of the same meshes;
- **rebase** folds accumulated integer drift back into cell
  reassignment: every (slot, integer offset) image of a cell arrives at
  the cell it drifted into, in a fixed order (k-major, offsets
  lexicographic), and the running arrival count is its slot.  No sort,
  no scatter.

A rebase runs as two parts, ``rebase_assign`` (new slot, re-centred
displacement, validity and a per-slot *route* code) and
``rebase_apply`` (replays the routes on the extra payloads, e.g. the
velocities).  Each has a plain PyTorch version here (the roll and
where scatter form of the JAX package's ``impl='xla'``) and a hand
CUDA kernel (``ops/binned_cuda.py``); :func:`route` chooses, as the JAX
package's gate does (``pmesh_tpu/ops/binned.py:289-291``): with
``impl=None`` the kernels for a 3-d state on a CUDA device (f32 or f64;
bf16 is refused there), the plain versions for a CPU or a 2-d state.
The kernels take drift offsets wider than the JAX package's Pallas
rebase ([-1, 1]), so the gate follows it on ``ndim`` alone.  The two are
bitwise equal.

Overflow (a cell receiving more than ``nslots`` particles) and escape
(a drift outside the declared bounds) are never silent: the count is
returned and the fields are NaN-poisoned.  Counts are exact integers.

On a slab-sharded state (``procmesh`` of P > 1 ranks; each rank holds
its x slab of every slot field) the rebase extends its inputs by the
drift's x reach from the ring neighbours (``parallel/halo.extend_x``)
and runs the x-halo slab form of both parts (the JAX package's
``rebase_fused_sharded``); the overflow and the particle counts are
summed over the ranks, so every rank poisons together, and the result
is bitwise the single-device rebase of the same global state.
``needed_slots`` takes the maximum over the ranks; the paint and
readout run the sharded lattice path of ``ops/gridpm.py``.  Reverse
mode runs through the sharded paint and readout (their vjps over the
slabs) and, on the CPU, through the plain slab rebase, whose drift halo
returns each halo plane's cotangent to its owner
(``parallel/halo.py``); the CUDA rebase refuses, as on one device.
"""
import itertools

import numpy as np
import torch

from . import gridpm as _gp

__all__ = ["from_lattice", "fold_lattice", "fold_needed", "rebase", "route",
           "rebase_assign_plain", "rebase_apply_plain", "paint_binned",
           "readout_binned", "occupancy", "from_positions", "needed_slots",
           "grow_slots"]


def from_lattice(disp, vel=None, nslots=2):
    """Wrap a lattice state (one particle per cell) as a binned state
    with ``nslots`` slots (slot 0 full, the rest empty).  Slot 0 holds
    the caller's tensors themselves; every empty slot owns its own
    zero tensors, so no tensor appears twice in the state."""
    ndim = len(disp)
    ref = disp[0]

    def _zeros():
        return tuple(torch.zeros_like(ref) for _ in range(ndim))

    dslots = (tuple(disp),) + tuple(_zeros() for _ in range(nslots - 1))
    valid = (torch.ones_like(ref),) + tuple(
        torch.zeros_like(ref) for _ in range(nslots - 1))
    if vel is None:
        return dslots, valid
    vslots = (tuple(vel),) + tuple(_zeros() for _ in range(nslots - 1))
    return dslots, vslots, valid


def _home_cells(g, shape):
    """Flat cell id and in-cell fraction of grid positions ``g`` (one
    tensor per axis, already wrapped into [0, n)).  The cell index is
    wrapped once more: a tiny negative position wraps to n - eps, which
    rounds to n in floating point, and that particle lives in cell 0."""
    flat = None
    fracs = []
    for x, n in zip(g, shape):
        c = torch.floor(x)
        fracs.append(x - c)
        ci = torch.remainder(c.to(torch.int64), n)
        flat = ci if flat is None else flat * n + ci
    return flat, fracs


def _ranks(flat):
    """(order, flat_sorted, rank-in-cell) of flat cell ids: one stable
    sort, then each element's distance from the start of its run."""
    order = torch.argsort(flat, stable=True)
    flat_s = flat[order]
    i = torch.arange(flat_s.numel(), device=flat.device)
    is_start = torch.ones_like(flat_s, dtype=torch.bool)
    is_start[1:] = flat_s[1:] != flat_s[:-1]
    start = torch.cummax(torch.where(is_start, i, 0), dim=0).values
    return order, flat_s, i - start


def _lattice_cells(disp):
    """Flat home cell, sort order and rank-in-cell of a lattice +
    displacement state (shared by fold_lattice and fold_needed).
    Returns (flat_sorted, order, rank, fracs): fracs are mesh-shaped
    displacements relative to the new home cell."""
    ndim = len(disp)
    shape = tuple(disp[0].shape)
    g = []
    for d in range(ndim):
        ax = torch.arange(shape[d], dtype=disp[d].dtype,
                          device=disp[d].device).reshape(
            (1,) * d + (-1,) + (1,) * (ndim - 1 - d))
        g.append(torch.remainder(ax + disp[d], shape[d]))
    flat, fracs = _home_cells(g, shape)
    order, flat_s, rank = _ranks(flat.reshape(-1))
    return flat_s, order, rank, fracs


def fold_needed(disp):
    """Max cell occupancy after folding a lattice + ARBITRARY
    displacement state: the minimum ``nslots`` for :func:`fold_lattice`
    (a 0-d tensor on the state's device)."""
    _, _, rank, _ = _lattice_cells(disp)
    return rank.max() + 1


def _slot_scatter(target, nslots, shape, dtype, device):
    """A function that writes sorted per-particle values into an
    ``(nslots,) + shape`` slot stack at ``target``.  The JAX package
    scatters into nslots * size + 1 elements with mode='drop' and drops
    the last; torch raises on an index out of range, so the overflowed
    particles are sent explicitly to that extra last element, which is
    then cut off."""
    size = int(np.prod(shape))

    def scatter(vals):
        f = torch.zeros(nslots * size + 1, dtype=dtype, device=device)
        f[target] = vals
        return f[:-1].reshape((nslots,) + tuple(shape))

    return scatter


def _slot_targets(flat_s, rank, nslots, size):
    """flat slot-stack targets; overflowed particles go to the sentinel
    element nslots * size.  Returns (target, overflow count)."""
    ok = rank < nslots
    overflow = (~ok).sum()
    target = torch.where(ok, rank * size + flat_s, nslots * size)
    return target, overflow


def _poison(overflow, dtype):
    """NaN where ``overflow`` > 0, else 0: added to every field of a
    state that lost particles."""
    return torch.where(overflow > 0, float('nan'), 0.0).to(dtype)


def fold_lattice(disp, vel=None, nslots=2):
    """Sort-based fold of a lattice + displacement state into an
    ``nslots``-slot binned state: one global sort plus one scatter per
    field, in O(N) memory for ANY excursion (a rebase over wide bounds
    would enumerate (hi - lo + 1)^ndim images).

    Overflow (a cell holding more than ``nslots`` particles) is counted
    and NaN-poisons the fields.  Returns (dslots, valid, overflow) or,
    with ``vel``, (dslots, vslots, valid, overflow)."""
    ndim = len(disp)
    shape = tuple(disp[0].shape)
    dtype, device = disp[0].dtype, disp[0].device
    size = int(np.prod(shape))
    flat_s, order, rank, fracs = _lattice_cells(disp)
    target, overflow = _slot_targets(flat_s, rank, nslots, size)
    scatter = _slot_scatter(target, nslots, shape, dtype, device)
    del flat_s, rank

    vfull = scatter(torch.ones(size, dtype=dtype, device=device))
    bad = _poison(overflow, dtype)

    def slots_of(fields):
        full = [scatter(f.reshape(-1)[order]) for f in fields]
        return tuple(tuple(full[d][k] + bad for d in range(ndim))
                     for k in range(nslots))

    dslots = slots_of(fracs)
    valid = tuple(vfull[k] for k in range(nslots))
    if vel is None:
        return dslots, valid, overflow
    return dslots, slots_of(vel), valid, overflow


def _icount(v):
    """EXACT particle count of a 0/1 validity field: an f32 sum drifts
    by several units past ~2^24 ones, and the poison contract would turn
    that drift into phantom overflow."""
    return (v > 0).sum()


def occupancy(valid):
    """Total particle count and max cell occupancy (0-d tensors)."""
    tot = sum(_icount(v) for v in valid)
    occ = sum(v for v in valid)
    return tot, occ.max()


def _drift_offsets(drift_bounds, ndim):
    lo, hi = drift_bounds
    dlo = int(np.floor(lo))
    dhi = int(np.floor(hi))
    return list(itertools.product(range(dlo, dhi + 1), repeat=ndim))


def _sharded(procmesh):
    return procmesh is not None and procmesh.size > 1


def _halo_depth(offsets):
    """(lo, hi) x planes a target slab's sources reach below and above:
    target row x takes source row x - o_x"""
    return max(0, offsets[-1][0]), max(0, -offsets[0][0])


def needed_slots(dslots, valid, drift_bounds, procmesh=None):
    """Max post-rebase cell occupancy of the current state: the slot
    count a :func:`rebase` needs to fold the drift without overflow.
    The counting half of the rebase with no payload movement, so an
    adaptive integrator can measure before it picks a slot count.  Returns
    a 0-d tensor (the maximum over the ranks of a sharded state);
    host-sync it to choose ``nslots_out``."""
    ndim = len(dslots[0])
    axes = tuple(range(ndim))
    offsets = _drift_offsets(drift_bounds, ndim)
    floors = tuple(tuple(torch.floor(d.detach()) for d in dk)
                   for dk in dslots)
    occ = tuple(v > 0 for v in valid)
    lo = rows = None
    if _sharded(procmesh):
        from ..parallel.halo import extend_x
        rows = dslots[0][0].shape[0]
        lo, hi = _halo_depth(offsets)
        floors = tuple(tuple(extend_x(f, lo, hi, procmesh) for f in fk)
                       for fk in floors)
        occ = tuple(extend_x(o, lo, hi, procmesh) for o in occ)
    count = torch.zeros(occ[0].shape, dtype=torch.int32,
                        device=occ[0].device)
    for off in offsets:
        for k in range(len(dslots)):
            sel = occ[k]
            for d in range(ndim):
                sel = sel & (floors[k][d] == off[d])
            count += torch.roll(sel.to(torch.int32), off, axes)
    if rows is None:
        return count.max()
    from ..parallel.comm import all_reduce
    return all_reduce(count[lo:lo + rows].max(), procmesh, 'max')


def grow_slots(valid, *slot_fields, nslots_new=None):
    """Append empty slots so a K-slot state becomes K'-slot (K' >= K).

    ``slot_fields``: any number of per-slot structures matching
    ``valid``'s nesting one level up (tuples over slots of per-axis
    tuples).  Returns (valid', fields'...)."""
    K = len(valid)
    Kn = int(nslots_new)
    if Kn < K:
        raise ValueError("grow_slots cannot shrink (%d -> %d); rebase "
                         "with nslots_out instead" % (K, Kn))
    ref = valid[0]
    out = [tuple(valid) + tuple(torch.zeros_like(ref)
                                for _ in range(Kn - K))]
    for f in slot_fields:
        ndim = len(f[0])
        pad = tuple(tuple(torch.zeros_like(ref) for _ in range(ndim))
                    for _ in range(Kn - K))
        out.append(tuple(f) + pad)
    return tuple(out)


# --- rebase -----------------------------------------------------------------
#
# Route codes: slot j of target cell t records which image filled it,
# code = k * n_off + (index of the offset in _drift_offsets), or -1 for
# an empty slot.  int16 holds them (K * n_off <= 32767).

ROUTE_DTYPE = torch.int16


def _route_check(K, n_off):
    if K * n_off > torch.iinfo(ROUTE_DTYPE).max:
        raise ValueError("rebase: %d slots x %d drift offsets overflow the "
                         "int16 route codes; narrow the drift bounds"
                         % (K, n_off))


def route(impl, device, ndim):
    """'cuda' (the rebase kernels) or 'torch' (the plain versions) for an
    ``ndim``-d binned state on ``device``: the rule of
    :func:`ops.gridpm.route` (module docstring), after the JAX package's
    gate ``pmesh_tpu/ops/binned.py:289-291`` on ``ndim``."""
    return _gp._route(impl, device, ndim, "pmesh_tpu/ops/binned.py:289-291")


def rebase_assign_plain(dslots, valid, offsets, nslots_out, rows=None,
                        xbase=None):
    """Plain PyTorch rebase assign (the scatter form of the JAX
    package's ``rebase(impl='xla')``).

    For every (slot k, offset) image in k-major, offset order: the
    particles of slot k whose floored displacement equals the offset
    arrive at cell c + offset; their arrival rank there is the running
    count, and rank j < nslots_out lands in slot j with the
    displacement re-centred (d - offset), validity 1 and the image's
    route code.  Returns (new_dslots, new_valid, routes, overflow), the
    overflow being the arrivals of rank >= nslots_out (0-d int64).

    ``rows``, ``xbase``: the x-halo slab form: the inputs hold x planes
    about a slab, the rolls run on them and the target rows [xbase,
    xbase + rows) are kept and counted (no roll wraps there when the
    halo covers the offsets)."""
    K = len(dslots)
    ndim = len(dslots[0])
    ref = dslots[0][0]
    axes = tuple(range(ndim))
    Kout = int(nslots_out)
    _route_check(K, len(offsets))
    keep = slice(None) if xbase is None else slice(xbase, xbase + rows)
    new_d = [[torch.zeros_like(ref) for _ in range(ndim)]
             for _ in range(Kout)]
    new_v = [torch.zeros_like(ref) for _ in range(Kout)]
    routes = [torch.full(ref.shape, -1, dtype=ROUTE_DTYPE,
                         device=ref.device) for _ in range(Kout)]
    one = torch.ones((), dtype=ref.dtype, device=ref.device)
    running = torch.zeros(ref.shape, dtype=torch.int32, device=ref.device)
    overflow = torch.zeros((), dtype=torch.int64, device=ref.device)
    for k in range(K):
        floors = [torch.floor(x) for x in dslots[k]]
        for oi, off in enumerate(offsets):
            sel = valid[k] > 0
            for d in range(ndim):
                sel = sel & (floors[d] == off[d])
            # the image arrives at cell c + off
            arr = torch.roll(sel, off, axes)
            rank = running
            running = running + arr.to(torch.int32)
            overflow = overflow + (arr & (rank >= Kout))[keep].sum()
            moved = [torch.roll(dslots[k][d] - off[d], off, axes)
                     for d in range(ndim)]
            code = torch.tensor(k * len(offsets) + oi, dtype=ROUTE_DTYPE,
                                device=ref.device)
            for j in range(Kout):
                put = arr & (rank == j)
                new_v[j] = torch.where(put, one, new_v[j])
                routes[j] = torch.where(put, code, routes[j])
                for d in range(ndim):
                    new_d[j][d] = torch.where(put, moved[d], new_d[j][d])
    return (tuple(tuple(x[keep] for x in slot) for slot in new_d),
            tuple(v[keep] for v in new_v), tuple(r[keep] for r in routes),
            overflow)


def rebase_apply_plain(extras, routes, offsets, xbase=None):
    """Plain PyTorch rebase apply: replays the routes of
    :func:`rebase_assign_plain` on extra per-slot payloads.  ``extras``
    is a tuple of K-slot structures (tuples over slots of per-axis
    tensors); returns the same with len(routes) slots, 0 in empty
    slots.  ``xbase``: the x-halo slab form, the extras holding x planes
    about the routes' rows (the routes are padded with empty slots to
    the extras' planes, and the routes' rows kept)."""
    if not extras:
        return ()
    if xbase is not None:
        rows = routes[0].shape[0]
        n_in = extras[0][0][0].shape[0]

        def pad(r):
            blank = torch.full((1,) + tuple(r.shape[1:]), -1, dtype=r.dtype,
                               device=r.device)
            return torch.cat([blank.expand((xbase,) + tuple(r.shape[1:])), r,
                              blank.expand((n_in - xbase - rows,)
                                           + tuple(r.shape[1:]))], 0)

        out = rebase_apply_plain(extras, tuple(pad(r) for r in routes),
                                 offsets)
        return tuple(tuple(tuple(x[xbase:xbase + rows] for x in slot)
                           for slot in e) for e in out)
    K = len(extras[0])
    ndim = len(extras[0][0])
    ref = extras[0][0][0]
    axes = tuple(range(ndim))
    out = [[[torch.zeros_like(ref) for _ in range(ndim)]
            for _ in routes] for _ in extras]
    for k in range(K):
        for oi, off in enumerate(offsets):
            code = k * len(offsets) + oi
            puts = [r == code for r in routes]
            for e, ex in enumerate(extras):
                for d in range(ndim):
                    moved = torch.roll(ex[k][d], off, axes)
                    for j, put in enumerate(puts):
                        out[e][j][d] = torch.where(put, moved, out[e][j][d])
    return tuple(tuple(tuple(slot) for slot in e) for e in out)


def rebase(dslots, valid, drift_bounds, extras=(), nslots_out=None,
           impl=None, procmesh=None):
    """Fold integer drift into cell reassignment.

    Parameters
    ----------
    dslots : tuple over slots of per-axis displacement tuples; values
        may have drifted anywhere within ``drift_bounds`` cells.
    valid : tuple over slots of occupancy masks (0/1, field dtype).
    drift_bounds : (lo, hi) floats, a static bound on the current
        displacements (the paint bounds used since the last rebase).
    extras : tuple of additional per-slot per-axis field tuples that
        move with the particles (e.g. velocities), nested like dslots.
    nslots_out : output slot count (default: len(dslots)).
    impl : None (the CUDA kernels for CUDA tensors, the plain versions
        for CPU tensors), 'torch' or 'cuda'.
    procmesh : None, or the ProcessMesh whose x slabs the fields are
        (module docstring); the overflow is then the global count.

    Returns (new_dslots, new_valid, new_extras, overflow): all
    displacements back in [0, 1); ``overflow`` (0-d int64) counts the
    particles that did not fit ``nslots_out`` slots or escaped the
    drift bounds, and the fields are NaN-poisoned when it is > 0.
    """
    return _rebase([dslots, valid, extras], drift_bounds, nslots_out, impl,
                   procmesh)


def _rebase(state, drift_bounds, nslots_out=None, impl=None, procmesh=None):
    """:func:`rebase` on a list [dslots, valid, extras], which it empties:
    when the caller holds no other reference, the old displacements and
    validity are freed once the assign has run, and the old extras once
    the apply has run, so old and new state never coexist for longer
    than one phase."""
    dslots, valid, extras = state
    state.clear()
    K = len(dslots)
    ndim = len(dslots[0])
    dtype = dslots[0][0].dtype
    Kout = K if nslots_out is None else int(nslots_out)
    offsets = _drift_offsets(drift_bounds, ndim)
    lo, hi = offsets[0][0], offsets[-1][0]

    # a sharded state: the inputs extended by the drift's x reach (the
    # x-halo slab form), the counts summed over the ranks
    rows = xbase = None

    def grow(fields):
        return fields

    def total(t):
        return t

    if _sharded(procmesh):
        from ..parallel.comm import all_reduce
        from ..parallel.halo import extend_x
        rows = dslots[0][0].shape[0]
        xbase, xhi = _halo_depth(offsets)

        def grow(fields):
            return tuple(extend_x(f, xbase, xhi, procmesh) for f in fields)

        def total(t):
            return all_reduce(t, procmesh, 'sum')

    total_in = total(sum(_icount(v) for v in valid))
    dslots = tuple(grow(dk) for dk in dslots)
    valid = grow(valid)
    if route(impl, dslots[0][0].device, ndim) == 'cuda':
        from . import binned_cuda as _k
        new_d, new_v, routes, overflow = _k.rebase_assign(
            dslots, valid, Kout, lo, hi, rows=rows, xbase=xbase)
        del dslots, valid
        extras = tuple(tuple(grow(ek) for ek in e) for e in extras)
        new_e = (_k.rebase_apply(extras, routes, lo, hi, xbase=xbase)
                 if extras else ())
    else:
        new_d, new_v, routes, overflow = rebase_assign_plain(
            dslots, valid, offsets, Kout, rows=rows, xbase=xbase)
        del dslots, valid
        extras = tuple(tuple(grow(ek) for ek in e) for e in extras)
        new_e = rebase_apply_plain(extras, routes, offsets, xbase=xbase)
    del extras, routes

    # losing a particle must never be silent: overflowed slots AND
    # particles whose drift escaped ``drift_bounds`` (their floor
    # matches no enumerated offset) both poison the result, on every
    # rank of a sharded state
    overflow = total(overflow)
    total_out = total(sum(_icount(v) for v in new_v))
    lost = total_in - total_out - overflow
    overflow = overflow + lost.abs()
    bad = _poison(overflow, dtype)
    new_d = tuple(tuple(x + bad for x in slot) for slot in new_d)
    new_e = tuple(tuple(tuple(x + bad for x in slot) for slot in e)
                  for e in new_e)
    return new_d, new_v, new_e, overflow


def paint_binned(dslots, valid, bounds=(0.0, 1.0), window='cic',
                 impl=None, procmesh=None):
    """Density of a binned state: the sum of per-slot lattice paints
    with the occupancy masks as masses."""
    out = None
    for dk, vk in zip(dslots, valid):
        p = _gp.paint_grid(tuple(dk), mass=vk, bounds=bounds,
                           window=window, impl=impl, procmesh=procmesh)
        out = p if out is None else out + p
    return out


def readout_binned(meshes, dslots, valid, bounds=(0.0, 1.0),
                   window='cic', impl=None, diffdir=None, procmesh=None):
    """Per-slot readouts of one or more meshes; returns, per slot, the
    tuple of per-mesh value fields (invalid slots read garbage: mask
    with ``valid`` before use, as the integrators do).

    diffdir='all' reads ONE mesh with the ndim derivative windows per
    slot (the gradient-mode force; always an ndim-tuple per slot)."""
    single = not isinstance(meshes, (tuple, list))
    ms = (meshes,) if single else tuple(meshes)
    if diffdir == 'all' and len(ms) != 1:
        raise ValueError("diffdir='all' takes exactly one mesh")
    outs = []
    for dk in dslots:
        if diffdir == 'all':
            outs.append(_gp.readout_grid(ms[0], tuple(dk), bounds=bounds,
                                         window=window, impl=impl,
                                         diffdir='all', procmesh=procmesh))
            continue
        vals = _gp.readout_grid(ms, tuple(dk), bounds=bounds,
                                window=window, impl=impl, diffdir=diffdir,
                                procmesh=procmesh)
        outs.append(vals[0] if single else vals)
    return tuple(outs)


def from_positions(pos, shape, nslots, scale=1.0):
    """Bin arbitrary positions (N, ndim) into a slot-lattice (the
    one-time catalog ingestion path; the integrators never sort).

    One global sort + rank-in-cell; particles beyond ``nslots`` per
    cell overflow (counted; fields poisoned).  Positions are in
    simulation units; ``scale`` converts them to grid cells.  Returns
    (dslots, valid, overflow)."""
    ndim = pos.shape[-1]
    shape = tuple(int(n) for n in shape)
    dtype, device = pos.dtype, pos.device
    size = int(np.prod(shape))
    g = [torch.remainder(pos[:, d] * scale, shape[d]) for d in range(ndim)]
    flat, frac = _home_cells(g, shape)
    order, flat_s, rank = _ranks(flat)
    target, overflow = _slot_targets(flat_s, rank, nslots, size)
    scatter = _slot_scatter(target, nslots, shape, dtype, device)
    valid = scatter(torch.ones(pos.shape[0], dtype=dtype, device=device))
    dfields = [scatter(frac[d][order]) for d in range(ndim)]
    bad = _poison(overflow, dtype)
    dslots = tuple(tuple(dfields[d][k] + bad for d in range(ndim))
                   for k in range(nslots))
    return dslots, tuple(valid[k] for k in range(nslots)), overflow
