"""The ghost exchange of particles on a 2-d (npx, npy) pencil grid.

Counterpart of ``pmesh_tpu/parallel/exchange2d.py``, the 2-d form of
``exchange.py``, whose contracts it keeps: rank b holds block b of every
particle array (rows ``[b nl, (b + 1) nl)``, nl = ceil(npart / D), padded
with inert sentinels), static per-channel capacities, the NaN poison on
an overflow or a residency breach (never silent), the local block as
channel 0 (a particle's home image never moves), and the gather modes.
The rank at grid coordinates (bx, by) (rank bx npy + by) owns the
(rows0, rows1, ...) pencil ``[bx rows0, (bx + 1) rows0) x [by rows1,
(by + 1) rows1)`` of the mesh; the grid's ranks must divide N0 and N1.

What differs from the 1-d plan, as in the JAX package:

- **Moore-neighbourhood channels.**  A channel is an offset (ox, oy) !=
  (0, 0); its images ride ``comm.torus_exchange`` over both grid axes
  at once (the JAX package's ``ppermute`` over ('x', 'y')).
- **Ring-unique offsets.**  On a ring of m ranks the offsets within
  reach k are the centred residues ``[-min(k, m // 2), min(k, (m - 1)
  // 2)]``: on a ring of 2, +1 and -1 are the same rank and the channel
  appears once, so small grids need no ring radius.
- **Exact membership.**  Per axis the smoothing ball covers a ring
  interval [dlo, dhi] of block offsets; a particle ships on (ox, oy) iff
  ox and oy both lie in their intervals.
- **Per-channel capacities.**  A face channel carries O(s / rows) of
  the block, a corner O(s^2 / (rows0 rows1)); ``capacity='auto'``
  measures each.
- **Grid coordinates are re-centred per receiver.**  The coordinate of
  a decomposed axis is unwrapped around the receiving pencil's centre
  (the nearest periodic image), not shifted by its channel: on a ring
  of 2 the wrap direction of one channel depends on the coordinate.

Where the port deliberately differs from the JAX package (ROADMAP queue
3): an axis of the grid with one rank (a (1, 4) or (4, 1) grid) has no
ghost channel along it, so its pencils paint and read it periodically;
the JAX package paints it as a cut axis and drops the windows that
cross the box's edge there (mass lost with badness 0).  And a window
that covers one block from both sides (wider than the ring on a ring of
2 or more ranks: one image cannot paint both) is a residency breach
here, which the JAX package misses.

Every call is a collective: all ranks make it together.  Reverse and
forward mode run through the exchange as through the 1-d plan's
(``exchange.py``): the plan is built from detached coordinates, and the
ghosts' cotangents ride ``comm.torus_exchange`` back along the reversed
offsets to their source particles.
"""
import numpy as np
import torch

from . import comm
from .exchange import (_check_hsml, _combine_channel, _counts, _diff_scale,
                       _gather_mode, sort_route)

__all__ = ["ShardedLayout2D", "decompose2d", "reshard2d",
           "measure_ghosts2d", "measure_load2d", "paint_sharded2d",
           "readout_sharded2d", "home_block2d"]


def _axis_offsets(k, np_ax):
    """the ring-unique centred offsets within reach k on an np_ax ring"""
    lo = -min(int(k), np_ax // 2)
    hi = min(int(k), (np_ax - 1) // 2)
    return tuple(range(lo, hi + 1))


def _channels2d(kx, ky, npx, npy):
    """the Moore-neighbourhood ghost channels (ox, oy) != (0, 0)"""
    return tuple((ox, oy)
                 for ox in _axis_offsets(kx, npx)
                 for oy in _axis_offsets(ky, npy)
                 if not (ox == 0 and oy == 0))


def _ball_interval(g, s, b, N, rows, np_ax):
    """the ring-signed block-offset interval [dlo, dhi] the smoothing
    ball [g - s, g + s] covers around home block ``b``"""
    gm = torch.remainder(g, N)
    slo = torch.floor(torch.remainder(gm - s, N) / rows).to(torch.int32)
    shi = torch.floor(torch.remainder(gm + s, N) / rows).to(torch.int32)
    half = np_ax // 2
    return (torch.remainder(slo - b + half, np_ax) - half,
            torch.remainder(shi - b + half, np_ax) - half)


def _member(m, dlo, dhi):
    """whether offset m lies in the ring interval [dlo, dhi] (dlo > dhi:
    the interval wraps)"""
    return torch.where(dlo <= dhi, (m >= dlo) & (m <= dhi),
                       (m >= dlo) | (m <= dhi))


def _axis_bad(dlo, dhi, offs, np_ax, width):
    """a ball touching a block no channel covers, or covering a block
    from both sides (``width``, the blocks the ball spans, past the
    ring): a residency breach"""
    wide = width > np_ax if np_ax > 1 else torch.zeros_like(
        dlo, dtype=torch.bool)
    if len(offs) == np_ax:
        return wide
    return wide | torch.where(dlo <= dhi, (dlo < offs[0]) | (dhi > offs[-1]),
                              torch.ones_like(dlo, dtype=torch.bool))


def _width(g, s, N, rows):
    """the number of blocks the smoothing ball [g - s, g + s] spans"""
    gm = torch.remainder(g, N)
    return (torch.floor((gm + s) / rows) - torch.floor((gm - s) / rows)
            + 1).to(torch.int32)


def _periods(layout, rest):
    """the paint's periods: an axis of the grid with one rank is whole on
    every rank and periodic, one split over several ranks is cut (its
    ghost images cover the straddle)"""
    return (layout.N0 if layout.npx == 1 else 0,
            layout.N1 if layout.npy == 1 else 0) + tuple(rest)


def _sentinel_ax(np_ax, rows):
    """the padding coordinate: the centre of the last block of an axis"""
    return (np_ax - 1 + 0.5) * rows


def home_block2d(g0, g1, N0, N1, npx, npy):
    """the home rank (bx npy + by) of grid coordinates (g0, g1)"""
    rows0, rows1 = N0 // npx, N1 // npy

    def home(g, N, rows, m):
        return torch.remainder(torch.div(
            torch.floor(torch.remainder(g, N)), rows,
            rounding_mode='floor').to(torch.int32), m)
    return home(g0, N0, rows0, npx) * npy + home(g1, N1, rows1, npy)


def _default_ksides(smoothing, rows0, rows1):
    """per axis the window's reach in blocks plus one block of headroom:
    the equal-count reshard can leave an edge particle one flat block
    from home, at most one step on each axis of the torus"""
    kx = int(np.ceil(float(smoothing) / rows0)) + 1
    ky = int(np.ceil(float(smoothing) / rows1)) + 1
    return max(1, kx), max(1, ky)


def _geometry(procmesh, N0, N1):
    npx, npy = procmesh.grid
    if N0 % npx or N1 % npy:
        raise ValueError(
            "decompose2d needs Nmesh[0] %% npx == 0 and Nmesh[1] %% npy == "
            "0; got Nmesh=(%d, %d) on a (%d, %d) grid" % (N0, N1, npx, npy))
    return npx, npy, N0 // npx, N1 // npy


def _padded2d(procmesh, g0, g1, nl, rows0, rows1):
    """this rank's coordinates padded with the sentinels to nl rows"""
    npx, npy = procmesh.grid
    n = g0.shape[0]
    if n == nl:
        return g0, g1
    out = []
    for g, sent in ((g0, _sentinel_ax(npx, rows0)),
                    (g1, _sentinel_ax(npy, rows1))):
        out.append(torch.cat([g, torch.full((nl - n,), sent, dtype=g.dtype,
                                            device=g.device)]))
    return tuple(out)


def _intervals(procmesh, g0, g1, s, N0, N1, rows0, rows1):
    npx, npy = procmesh.grid
    bx, by = procmesh.coords
    return (_ball_interval(g0, s, bx, N0, rows0, npx),
            _ball_interval(g1, s, by, N1, rows1, npy))


def _masks(chans, iv):
    (dlo0, dhi0), (dlo1, dhi1) = iv
    return [_member(ox, dlo0, dhi0) & _member(oy, dlo1, dhi1)
            for ox, oy in chans]


class ShardedLayout2D(object):
    """The capacity-padded ghost routing plan of this rank on a 2-d grid.

    Attributes
    ----------
    send_idx : tuple of (cap_c,) int32 tensors
        per channel, the local indices of the particles to ship (-1:
        empty slot); block b of the JAX package's (D, cap_c).
    recv_valid : tuple of (cap_c,) bool tensors
    badness : () float32 tensor, the same on every rank: 0, or NaN on an
        overflow or a residency breach on any rank.
    offsets, caps : the channels (ox, oy) and their capacities.
    """

    def __init__(self, procmesh, send_idx, recv_valid, badness, counts, N0,
                 N1, offsets, caps, smoothing):
        self.procmesh = procmesh
        self.send_idx = tuple(send_idx)
        self.recv_valid = tuple(recv_valid)
        self.badness = badness
        self.counts = list(counts)
        self.D = procmesh.size
        self.npart = sum(self.counts)
        self.nl = max(self.counts)
        self.npart_pad = self.nl * self.D
        self.nlocal = self.counts[procmesh.rank]
        self.N0, self.N1 = int(N0), int(N1)
        self.npx, self.npy = procmesh.grid
        self.rows0 = self.N0 // self.npx
        self.rows1 = self.N1 // self.npy
        self.offsets = tuple(tuple(o) for o in offsets)
        self.caps = tuple(int(c) for c in caps)
        self.smoothing = smoothing
        self.sendlength = self.npart
        self.recvlength = self.D * self.slots_per_block

    @property
    def slots_per_block(self):
        return self.nl + sum(self.caps)

    def _poison(self, x):
        if x.is_floating_point() or x.is_complex():
            return x + self.badness.to(x.real.dtype)
        return x

    def _recenter(self, g, axis):
        """a coordinate of decomposed ``axis`` unwrapped around this
        rank's pencil centre"""
        N = (self.N0, self.N1)[axis]
        rows = (self.rows0, self.rows1)[axis]
        center = (self.procmesh.coords[axis] + 0.5) * rows
        gm = torch.remainder(g, N)
        return gm - N * torch.round((gm - center) / N)

    def _exchange_one(self, a, fill, grid_axis):
        a = torch.as_tensor(a)
        if a.shape[0] != self.nlocal:
            raise ValueError("exchange expects leading axis %d, got %s"
                             % (self.nlocal, tuple(a.shape)))
        if self.nl > self.nlocal:
            # the sentinel rows hold ``fill`` (hsml 1, not 0: a sentinel
            # that ghosts must weigh 0, not NaN; ROADMAP queue 3)
            a = torch.cat([a, a.new_full((self.nl - self.nlocal,)
                                         + tuple(a.shape[1:]), fill)])
        if grid_axis is not None:
            a = self._recenter(a, grid_axis)
        tail = (1,) * (a.dim() - 1)
        fillv = torch.as_tensor(fill, dtype=a.dtype, device=a.device)
        sends = []
        for i, off in zip(self.send_idx, self.offsets):
            i = i.long()
            buf = a.index_select(0, i.clamp(min=0))
            sends.append((torch.where((i >= 0).reshape((-1,) + tail), buf,
                                      fillv), off))
        recvs = comm.torus_exchange(sends, self.procmesh)
        parts = [a]
        for rv, recv in zip(self.recv_valid, recvs):
            rv = rv.reshape((-1,) + tail)
            recv = torch.where(rv, recv, fillv)
            if grid_axis is not None:
                recv = torch.where(rv, self._recenter(recv, grid_axis), recv)
            parts.append(recv)
        return torch.cat(parts, 0)

    def exchange(self, *args, fill=0):
        """Ship ghost copies to every intersecting pencil: per argument
        of this rank's (nlocal, ...), its (slots_per_block, ...) slots
        (the local block, then the channels received; empty slots hold
        ``fill``); one argument returns one tensor."""
        if not args:
            return None
        r = tuple(self._poison(self._exchange_one(a, fill, None))
                  for a in args)
        return r[0] if len(r) == 1 else r

    def exchange_scalar(self, value):
        """scalars skip the exchange"""
        return value

    def exchange_grid(self, axis, g, fill=0.0):
        """the grid coordinate of decomposed ``axis`` (0 or 1), each image
        in its receiver's unwrapped frame (what the sharded paint and
        readout read)"""
        return self._poison(self._exchange_one(g, fill, int(axis)))

    def ghost_mask(self):
        """(slots_per_block,) bool: True where a slot holds a particle"""
        ones = torch.ones(self.nl, dtype=torch.bool,
                          device=self.badness.device)
        return torch.cat([ones] + list(self.recv_valid))

    def gather(self, data, mode='sum', out=None):
        """Reduce ghost images back to this rank's particles, with the
        modes of :meth:`exchange.ShardedLayout.gather`."""
        mode, combine = _gather_mode(mode)
        if mode == 'all':
            return data
        data = torch.as_tensor(data)
        if data.shape[0] != self.slots_per_block:
            raise ValueError(
                "gather expects the exchange result length %d, got %s"
                % (self.slots_per_block, tuple(data.shape)))
        nl = self.nl
        out = data[:nl]
        if mode != 'local':
            starts = np.concatenate([[0], np.cumsum(self.caps)])[:-1] + nl
            # the ghost results, routed back to their source blocks
            backs = comm.torus_exchange(
                [(data[int(st):int(st) + cap], (-ox, -oy))
                 for st, cap, (ox, oy) in zip(starts, self.caps,
                                              self.offsets)],
                self.procmesh)
            cnt = torch.ones(nl, dtype=data.dtype, device=data.device) \
                if mode == 'mean' else None
            for i, back in zip(self.send_idx, backs):
                out, cnt = _combine_channel(out, cnt, i.long(), back, mode,
                                            combine)
            if cnt is not None:
                out = out / cnt.reshape((-1,) + (1,) * (data.dim() - 1))
        return self._poison(out[:self.nlocal])

    def get_exchange_cost(self):
        """(D,) numpy: the ghost images each rank ships away"""
        t = sum((i >= 0).sum() for i in self.send_idx)
        t = torch.as_tensor(t, device=self.badness.device).reshape(1) \
            .to(torch.int64)
        return comm.to_numpy(comm.all_gather(t, self.procmesh))


def measure_ghosts2d(procmesh, g0, g1, N0, N1, smoothing, ksides=None):
    """(per-channel max ghost count over the ranks (numpy), the largest
    (x, y) block reach) of this rank's grid coordinates, padded with the
    sentinels as :func:`decompose2d` pads them; ``capacity='auto'``
    sizes its channels from it."""
    npx, npy, rows0, rows1 = _geometry(procmesh, N0, N1)
    if ksides is None:
        ksides = _default_ksides(smoothing, rows0, rows1)
    chans = _channels2d(ksides[0], ksides[1], npx, npy)
    nl = max(_counts(procmesh, g0.shape[0]))
    g0, g1 = _padded2d(procmesh, g0, g1, nl, rows0, rows1)
    iv = _intervals(procmesh, g0, g1, float(smoothing), N0, N1, rows0,
                    rows1)
    zero = torch.zeros((), dtype=torch.int64, device=g0.device)
    reach = [torch.maximum((-dlo).max(), dhi.max()).to(torch.int64)
             if g0.numel() else zero for dlo, dhi in iv]
    c = torch.stack([m.sum().to(torch.int64) for m in _masks(chans, iv)]
                    + reach)
    c = comm.to_numpy(comm.all_reduce(c, procmesh, 'max'))
    return c[:-2], (int(c[-2]), int(c[-1]))


def measure_load2d(procmesh, g0, g1, N0, N1, smoothing, ksides=None):
    """The work of every rank on this state (numpy, the same on every
    rank), as :func:`exchange.measure_load` reports it: ``residents``,
    ``ghosts_sent``, ``ghosts_recv``, ``paint_work`` and ``imbalance``."""
    npx, npy, rows0, rows1 = _geometry(procmesh, N0, N1)
    if ksides is None:
        ksides = _default_ksides(smoothing, rows0, rows1)
    chans = _channels2d(ksides[0], ksides[1], npx, npy)
    D = procmesh.size
    counts = _counts(procmesh, g0.shape[0])
    npart, nl = sum(counts), max(counts)
    npad = nl * D
    g0, g1 = _padded2d(procmesh, g0, g1, nl, rows0, rows1)
    bx, by = procmesh.coords
    g0m, g1m = torch.remainder(g0, N0), torch.remainder(g1, N1)
    res = ((g0m >= bx * rows0) & (g0m < (bx + 1) * rows0)
           & (g1m >= by * rows1) & (g1m < (by + 1) * rows1)).sum()
    iv = _intervals(procmesh, g0, g1, float(smoothing), N0, N1, rows0,
                    rows1)
    local = torch.stack([res] + [m.sum() for m in _masks(chans, iv)]) \
        .to(torch.int64)
    both = comm.to_numpy(comm.all_gather(local[None], procmesh))
    res, sent = both[:, 0], both[:, 1:]
    recv = np.zeros(D, np.int64)
    for c, (ox, oy) in enumerate(chans):
        for j in range(D):
            jx, jy = divmod(j, npy)
            recv[((jx + ox) % npx) * npy + (jy + oy) % npy] += sent[j, c]
    # the sentinels pad the last block and are homed in the last pencil
    if npad > npart:
        res[-1] -= npad - npart
    work = np.full(D, nl, np.int64) + recv
    if npad > npart:
        work[-1] -= npad - npart
    return {"residents": res, "ghosts_sent": sent.sum(axis=1),
            "ghosts_recv": recv, "paint_work": work,
            "imbalance": float(work.max() / max(work.mean(), 1e-300))}


def decompose2d(procmesh, g0, g1, N0, N1, smoothing, ksides=None,
                capacity=None, slack=1.3):
    """The :class:`ShardedLayout2D` of this rank's particles, whose grid
    coordinates along the two decomposed axes are ``g0`` and ``g1``.

    ksides : (kx, ky), the ghost reach in blocks per axis; default the
        window's reach plus one block each.
    capacity : None (the block length: never overflows), 'auto' (the
        measured per-channel counts times ``slack``, at least 8), an int
        for every channel, or one per channel.
    """
    npx, npy, rows0, rows1 = _geometry(procmesh, int(N0), int(N1))
    N0, N1 = int(N0), int(N1)
    g0, g1 = g0.detach(), g1.detach()
    s = float(smoothing)
    if 2 * s >= min(N0, N1):
        raise ValueError("smoothing %g covers the whole box" % s)
    if ksides is None:
        ksides = _default_ksides(s, rows0, rows1)
    kx, ky = int(ksides[0]), int(ksides[1])
    if s > kx * rows0 or s > ky * rows1:
        raise ValueError(
            "smoothing %g exceeds the (kx=%d, ky=%d) ghost reach of (%d, %d) "
            "cells; increase ksides" % (s, kx, ky, kx * rows0, ky * rows1))
    offs_x, offs_y = _axis_offsets(kx, npx), _axis_offsets(ky, npy)
    chans = _channels2d(kx, ky, npx, npy)
    counts = _counts(procmesh, g0.shape[0])
    nl = max(counts)
    if isinstance(capacity, str) and capacity == 'auto':
        cnt, _ = measure_ghosts2d(procmesh, g0, g1, N0, N1, s,
                                  ksides=(kx, ky))
        caps = tuple(max(8, int(np.ceil(float(c) * float(slack))))
                     for c in cnt)
    elif capacity is None:
        caps = (nl,) * len(chans)
    elif np.ndim(capacity) == 0:
        caps = (int(capacity),) * len(chans)
    else:
        caps = tuple(int(c) for c in capacity)
        if len(caps) != len(chans):
            raise ValueError("capacity sequence must have %d entries (one "
                             "per ghost channel), got %d"
                             % (len(chans), len(caps)))
    caps = tuple(min(c, nl) for c in caps)
    g0, g1 = _padded2d(procmesh, g0, g1, nl, rows0, rows1)
    iv = _intervals(procmesh, g0, g1, s, N0, N1, rows0, rows1)
    bad = (_axis_bad(*iv[0], offs_x, npx, _width(g0, s, N0, rows0))
           | _axis_bad(*iv[1], offs_y, npy, _width(g1, s, N1, rows1))).sum()
    arange = torch.arange(nl, dtype=torch.int32, device=g0.device)
    send_idx = []
    over = torch.zeros((), dtype=torch.int64, device=g0.device)
    for mask, cap in zip(_masks(chans, iv), caps):
        rank = torch.cumsum(mask.to(torch.int64), 0) - 1
        slot = torch.where(mask & (rank < cap), rank, cap)
        buf = torch.full((cap + 1,), -1, dtype=torch.int32, device=g0.device)
        buf[slot] = arange
        send_idx.append(buf[:cap])
        over = over + torch.clamp(mask.sum() - cap, min=0)
    badcount = comm.all_reduce((bad + over).to(torch.float32).reshape(1),
                               procmesh, 'sum')[0]
    badness = torch.where(badcount > 0, float('nan'), 0.0).to(torch.float32)
    # the received slots' validity: the sent slots' validity, permuted
    recv_valid = comm.torus_exchange(
        [(i >= 0, off) for i, off in zip(send_idx, chans)], procmesh)
    return ShardedLayout2D(procmesh, send_idx, recv_valid, badness, counts,
                           N0, N1, chans, caps, s)


def reshard2d(procmesh, g0, g1, N0, N1, *arrays):
    """Globally re-sort particle arrays into home-pencil order (the mpsort
    role): block b holds the b-th equal-count quantile of the particles
    ordered by home pencil, then source rank and each rank's own order
    (the JAX package's stable global sort by home pencil;
    :func:`exchange.sort_route`)."""
    npx, npy = procmesh.grid
    home = home_block2d(g0.detach(), g1.detach(), int(N0), int(N1), npx,
                        npy)
    return sort_route(procmesh, home, procmesh.size, *arrays)


# --- the sharded paint and readout -------------------------------------------

def _grid_coords2d(layout, pos, scale, translate):
    """the images' per-axis grid coordinates, axes 0 and 1 in each
    receiver's unwrapped frame; ``translate`` (cells) is added before
    the exchange"""
    pos = torch.as_tensor(pos)
    ndim = pos.shape[-1]
    if translate is None:
        translate = (0.0,) * ndim
    egs = []
    for d in range(ndim):
        g = pos[:, d] * torch.as_tensor(float(scale[d]), dtype=pos.dtype) \
            + torch.as_tensor(float(translate[d]), dtype=pos.dtype)
        egs.append(layout.exchange_grid(d, g) if d < 2
                   else layout.exchange(g))
    return egs


def _local_pos2d(layout, egs):
    bx, by = layout.procmesh.coords
    return torch.stack([egs[0] - bx * layout.rows0,
                        egs[1] - by * layout.rows1] + list(egs[2:]), dim=-1)


def _check_shape(layout, shape):
    if shape[0] != layout.N0 or shape[1] != layout.N1:
        raise ValueError("mesh shape %s does not match the layout's (N0, "
                         "N1)=(%d, %d)" % (shape, layout.N0, layout.N1))


def paint_sharded2d(layout, pos, mass, shape, scale, window, diffdir=None,
                    dtype=None, base=None, hsml=None, hsml_max=None,
                    translate=None):
    """This rank's pencil (rows0, rows1, ...) of the paint of every rank's
    particles (the arguments of :func:`exchange.paint_sharded`)."""
    from ..ops import paint as _paint_ops
    pos = torch.as_tensor(pos)
    shape = tuple(int(n) for n in shape)
    _check_shape(layout, shape)
    dtype = pos.dtype if dtype is None else dtype
    egs = _grid_coords2d(layout, pos, scale, translate)
    m = torch.broadcast_to(torch.as_tensor(mass, dtype=dtype,
                                           device=pos.device),
                           (pos.shape[0],))
    em = layout.exchange(m, fill=0)
    eh, hbad = _check_hsml(layout, window, hsml, hsml_max)
    zeros = torch.zeros((layout.rows0, layout.rows1) + shape[2:],
                        dtype=dtype, device=pos.device)
    out = _paint_ops.paint(zeros, _local_pos2d(layout, egs), mass=em,
                           window=window, scale=1.0, translate=0.0,
                           period=_periods(layout, shape[2:]),
                           diffdir=diffdir,
                           hsml=eh, hsml_max=hsml_max)
    out = _diff_scale((out,), scale, diffdir)[0]
    out = out + layout.badness.to(out.dtype)
    if hbad is not None:
        out = out + hbad.to(out.dtype)
    if base is not None:
        out = out + base
    return out


def readout_sharded2d(layout, meshes, pos, scale, window, diffdir=None,
                      hsml=None, hsml_max=None, translate=None):
    """The values of this rank's pencils ``meshes`` at every rank's
    particles (the arguments and returns of
    :func:`exchange.readout_sharded`)."""
    from ..ops import paint as _paint_ops
    multi = diffdir == 'all'
    single = not isinstance(meshes, (tuple, list)) and not multi
    meshes = (meshes,) if not isinstance(meshes, (tuple, list)) \
        else tuple(meshes)
    pos = torch.as_tensor(pos)
    ndim = pos.shape[-1]
    if multi and len(meshes) != 1:
        raise ValueError("diffdir='all' takes exactly one mesh")
    if tuple(meshes[0].shape[:2]) != (layout.rows0, layout.rows1):
        raise ValueError("mesh pencil %s does not match the layout's (%d, "
                         "%d)" % (tuple(meshes[0].shape), layout.rows0,
                                  layout.rows1))
    rest = tuple(meshes[0].shape[2:])
    egs = _grid_coords2d(layout, pos, scale, translate)
    eh, hbad = _check_hsml(layout, window, hsml, hsml_max)
    p = _local_pos2d(layout, egs)
    kw = dict(window=window, scale=1.0, translate=0.0,
              period=_periods(layout, rest), hsml=eh, hsml_max=hsml_max)
    if multi:
        vals = tuple(_paint_ops.readout(meshes[0], p, diffdir=d, **kw)
                     for d in range(ndim))
    else:
        vals = _paint_ops.readout(meshes[0] if len(meshes) == 1
                                  else meshes, p, diffdir=diffdir, **kw)
        vals = vals if isinstance(vals, tuple) else (vals,)
    # one ghost gather for all outputs, stacked on a trailing axis
    if len(vals) > 1:
        g = layout.gather(torch.stack(vals, dim=-1), mode='sum')
        outs = tuple(g[..., i] for i in range(len(vals)))
    else:
        outs = (layout.gather(vals[0], mode='sum'),)
    outs = _diff_scale(outs, scale, diffdir)
    if hbad is not None:
        outs = tuple(o + hbad.to(o.dtype) for o in outs)
    return outs[0] if single else outs
