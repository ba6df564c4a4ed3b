"""The slab-sharded ghost exchange of particles: the 1-d plan.

Counterpart of ``pmesh_tpu/parallel/exchange.py`` (the slab path; the
2-d pencil plan is ``exchange2d.py``).  The reference ships ragged
packed-Alltoallv buffers; the JAX package, with static shapes, plans
**capacity-padded** channels, and this port keeps its plan bit for bit,
on torch.distributed ranks:

- rank b holds block b of every particle array: the rows
  ``[b nl, (b + 1) nl)`` of the global array, nl = ceil(npart / D),
  the last blocks short (the blocks the JAX package's global arrays put
  on device b); a rank pads its block to nl with inert sentinels, as
  the JAX package pads the global array;
- the mesh's axis 0 is slab-decomposed over the same ranks: rows =
  ceil(N0 / D) each (``parallel/pmesh.py``).  Where D does not divide
  N0 the slabs are padded: the dead rows [N0, rows D) of the last slabs
  (whole dead slabs at the seam, or a thin last slab) take a paint's
  spill, which is dropped, and read as zeros, while the ghost image on
  the wrapped side paints and reads the real cells;
- *residency*: every particle of block b lies within ``kside`` slabs of
  slab b, its window's reach included.  :func:`reshard` makes it so;
  particles may then drift ``kside rows - smoothing`` cells before the
  next reshard;
- :func:`decompose` plans, per rank, 2 kside ghost channels of fixed
  capacity (to slab b - m and b + m); the ghosts ride
  ``comm.ring_exchange`` (the JAX package's ``lax.ppermute``).  The
  local block is channel 0: a particle's home image never moves.

A capacity overflow or a residency breach is never silent: the plan's
``badness`` (NaN, or 0) is summed over the ranks and folded into every
exchanged and gathered float, and into a painted mesh.

``exchange`` returns, per array, this rank's ``(nl + 2 kside capacity,
...)`` slots (the local block, then the channels received; empty slots
hold ``fill``), block b of the JAX package's ``(D L, ...)`` result;
``gather`` reduces them back to this rank's particles by sum, mean, any,
all, local, max, min, prod or any binary ufunc.  :func:`paint_sharded`
and :func:`readout_sharded` paint and read each rank's own slab from its
images.  Every call is a collective: all ranks make it together.

Reverse and forward mode run through all of it, with the convention of
``comm.py``.  The plan (``send_idx``, ``badness``, kside, capacity, the
reshard's order) is built from detached positions; the positions'
gradient flows through the exchanged coordinates.  ``exchange`` is a
gather by ``send_idx`` plus the ring exchange, whose transpose is the
scatter-add of the ghosts' cotangents onto their source particles;
``gather`` differentiates in every mode (the channels' cotangents ride
the ring back out), ``route`` sends the cotangent rows back to where
the rows came from, and the NaN poison still reaches every exchanged
float and painted mesh.
"""
import numpy as np
import torch

from . import comm

__all__ = ["ShardedLayout", "decompose", "reshard", "route", "sort_route",
           "home_block", "measure_ghosts", "measure_load", "paint_sharded",
           "readout_sharded"]


def _channels(kside):
    """(m, side) per ghost channel; side -1 sends to b - m, +1 to b + m"""
    return [(m, side) for m in range(1, kside + 1) for side in (-1, +1)]


def _slab_rows(N0, D):
    """rows per slab: ceil(N0 / D), the last slabs padded with dead
    rows where D does not divide N0"""
    return -(-int(N0) // int(D))


def _ball_channels(g, s, b, N0, rows, D):
    """ring-signed slab distances (dlo, dhi) of the smoothing ball
    [g - s, g + s] from home block ``b``, periodic in N0"""
    gm = torch.remainder(g, N0)
    slo = torch.floor(torch.remainder(gm - s, N0) / rows).to(torch.int32)
    shi = torch.floor(torch.remainder(gm + s, N0) / rows).to(torch.int32)
    half = D // 2
    return (torch.remainder(slo - b + half, D) - half,
            torch.remainder(shi - b + half, D) - half)


def _sentinel_pos(N0, rows, D):
    """the padding position: the physical center of the slab holding
    cell N0 - 1 (on an uneven mesh that slab can be thin, and its
    sentinels may ghost: they carry no mass, and measure_ghosts counts
    them under the same padding)"""
    sb = (int(N0) - 1) // int(rows)
    return (sb * rows + min((sb + 1) * rows, int(N0))) / 2.0


def home_block(pos0_grid, N0, D):
    """the home slab (rank) of axis-0 grid coordinates"""
    rows = _slab_rows(N0, D)
    return torch.remainder(
        torch.div(torch.floor(torch.remainder(pos0_grid, N0)), rows,
                  rounding_mode='floor').to(torch.int32), D)


def _dead_slabs(N0, rows, D):
    """the slabs past the physical mesh at the seam, which a ball
    wrapping the period N0 hops over in ring distance"""
    return (D - 1) - (int(N0) - 1) // rows


def _default_kside(smoothing, rows, D, N0=None):
    """the window's reach in slabs plus one slab of headroom (a cell of
    drift, and the quantile splits of :func:`reshard` that leave edge
    particles one block from home), plus the dead seam slabs of an
    uneven mesh, at most the ring radius"""
    kside = int(np.ceil(float(smoothing) / rows)) + 1
    if N0 is not None:
        kside += _dead_slabs(N0, rows, D)
    return min(max(1, kside), max(1, (D - 1) // 2))


def _counts(procmesh, n):
    """the particle count of every rank (a list), one all_gather"""
    t = torch.tensor([int(n)], dtype=torch.int64, device=procmesh.device)
    return [int(c) for c in comm.all_gather(t, procmesh).cpu()]


def _padded(procmesh, pos0_grid, N0, nl):
    """this rank's block padded with sentinels to nl rows"""
    rows = _slab_rows(N0, procmesh.size)
    n = pos0_grid.shape[0]
    if n == nl:
        return pos0_grid
    pad = torch.full((nl - n,), _sentinel_pos(N0, rows, procmesh.size),
                     dtype=pos0_grid.dtype, device=pos0_grid.device)
    return torch.cat([pos0_grid, pad])


def _ghost_counts(g, s, b, N0, rows, D, chans):
    dlo, dhi = _ball_channels(g, s, b, N0, rows, D)
    masks = [(dlo <= -m) if side < 0 else (dhi >= m) for m, side in chans]
    return dlo, dhi, masks


_UFUNC_MODES = {np.add: 'sum', np.maximum: 'max', np.fmax: 'max',
                np.minimum: 'min', np.fmin: 'min', np.multiply: 'prod'}


def _gather_mode(mode):
    """(mode string, binary combine function or None) of a gather mode"""
    if isinstance(mode, str):
        return mode, None
    if isinstance(mode, np.ufunc) and mode in _UFUNC_MODES:
        return _UFUNC_MODES[mode], None
    combine = None
    if isinstance(mode, np.ufunc):
        combine = getattr(torch, mode.__name__, None)
    elif callable(mode):
        combine = mode
    if combine is None:
        raise NotImplementedError(
            "unsupported gather reduction %r on the sharded path; pass a "
            "binary ufunc with a torch counterpart or a callable on "
            "tensors, or use gather(..., 'all') and reduce by hand"
            % (mode,))
    return 'ufunc', combine


def _combine_channel(out, cnt, i, back, mode, combine):
    """(out, cnt) with one channel's returned values ``back`` folded into
    the particles ``i`` (-1: an empty slot) by ``mode``"""
    tail = (1,) * (back.dim() - 1)
    ok = i >= 0
    okb = ok.reshape((-1,) + tail)
    safe = i.clamp(min=0)
    if mode in ('sum', 'mean'):
        out = out.index_add(0, safe, torch.where(
            okb, back, torch.zeros((), dtype=back.dtype,
                                   device=back.device)))
        if cnt is not None:
            cnt = cnt.index_add(0, safe, ok.to(cnt.dtype))
    elif mode == 'any':
        out = out.clone()
        out[i[ok]] = back[ok]
    elif mode in ('max', 'min', 'prod'):
        if mode == 'prod':
            ident = 1
        elif back.is_floating_point():
            ident = -np.inf if mode == 'max' else np.inf
        else:
            info = torch.iinfo(back.dtype)
            ident = info.min if mode == 'max' else info.max
        contrib = torch.where(okb, back, torch.as_tensor(
            ident, dtype=back.dtype, device=back.device))
        red = {'max': 'amax', 'min': 'amin', 'prod': 'prod'}
        index = safe.reshape((-1,) + tail).expand_as(contrib)
        out = out.scatter_reduce(0, index, contrib, red[mode])
    elif mode == 'ufunc':
        # one image per particle and channel: align the channel to the
        # particles, then combine
        aligned = torch.zeros_like(out)
        aligned[i[ok]] = back[ok]
        filled = torch.zeros(out.shape[0], dtype=torch.bool,
                             device=out.device)
        filled[i[ok]] = True
        out = torch.where(filled.reshape((-1,) + tail),
                          combine(out, aligned), out)
    else:
        raise NotImplementedError(mode)
    return out, cnt


class ShardedLayout(object):
    """The capacity-padded ghost routing plan of this rank.

    Attributes
    ----------
    send_idx : (C, cap) int32 tensor
        per ghost channel, the local indices of the particles to ship
        (-1: empty slot); block b of the JAX package's (D, C, cap).
    recv_valid : (C, cap) bool tensor
        which received slots of each channel hold a particle.
    badness : () float32 tensor, the same on every rank
        0, or NaN if any rank's plan overflowed its capacity or broke
        residency.
    npart, npart_pad, nl, nlocal : the global count, its padding to D
        equal blocks, the block length, and this rank's count.
    """

    def __init__(self, procmesh, send_idx, recv_valid, badness, counts, N0,
                 rows, kside, capacity, smoothing):
        self.procmesh = procmesh
        self.send_idx = send_idx
        self.recv_valid = recv_valid
        self.badness = badness
        self.counts = list(counts)
        self.D = procmesh.size
        self.npart = sum(self.counts)
        self.nl = max(self.counts)
        self.npart_pad = self.nl * self.D
        self.nlocal = self.counts[procmesh.rank]
        self.N0 = int(N0)
        self.rows = int(rows)
        self.kside = int(kside)
        self.capacity = int(capacity)
        self.smoothing = smoothing
        self.sendlength = self.npart
        self.recvlength = self.D * self.slots_per_block

    @property
    def slots_per_block(self):
        return self.nl + 2 * self.kside * self.capacity

    def _poison(self, x):
        if x.is_floating_point() or x.is_complex():
            return x + self.badness.to(x.real.dtype)
        return x

    def _send(self, a, fill):
        """the per-channel send buffers of ``a`` (nl, ...)"""
        out = []
        for c in range(self.send_idx.shape[0]):
            i = self.send_idx[c].long()
            ok = (i >= 0).reshape((-1,) + (1,) * (a.dim() - 1))
            buf = a.index_select(0, i.clamp(min=0))
            out.append(torch.where(ok, buf, torch.as_tensor(
                fill, dtype=a.dtype, device=a.device)))
        return out

    def _exchange_one(self, a, fill, grid0):
        """``grid0``: ``a`` is the axis-0 grid coordinate, re-centred on
        the sending block and shifted into each receiver's frame"""
        a = torch.as_tensor(a)
        if a.shape[0] != self.nlocal:
            raise ValueError("exchange expects leading axis %d, got %s"
                             % (self.nlocal, tuple(a.shape)))
        if self.nl > self.nlocal:
            # the sentinel rows hold ``fill`` (hsml 1, not 0: a sentinel
            # that ghosts must weigh 0, not NaN; ROADMAP queue 3)
            a = torch.cat([a, a.new_full((self.nl - self.nlocal,)
                                         + tuple(a.shape[1:]), fill)])
        b, N0, rows, D = self.procmesh.rank, self.N0, self.rows, self.D
        if grid0:
            g = torch.remainder(a, N0)
            a = g - N0 * torch.round((g - (b + 0.5) * rows) / N0)
        chans = _channels(self.kside)
        recvs = comm.ring_exchange(
            [(buf, side * m) for buf, (m, side)
             in zip(self._send(a, fill), chans)], self.procmesh)
        parts = [a]
        for c, ((m, side), recv) in enumerate(zip(chans, recvs)):
            rv = self.recv_valid[c].reshape((-1,) + (1,) * (a.dim() - 1))
            recv = torch.where(rv, recv, torch.as_tensor(
                fill, dtype=a.dtype, device=a.device))
            if grid0:
                # the sender b - side m wrapped past the ring: its
                # coordinates sit a period off in this receiver's frame
                src = b - side * m
                wrap = -1 if src < 0 else (1 if src >= D else 0)
                if wrap:
                    recv = torch.where(rv, recv + wrap * N0, recv)
            parts.append(recv)
        return torch.cat(parts, 0)

    def exchange(self, *args, fill=0):
        """Ship ghost copies to every intersecting slab: per argument of
        this rank's (nlocal, ...), its (slots_per_block, ...) slots (see
        the module docstring); one argument returns one tensor."""
        if not args:
            return None
        r = tuple(self._poison(self._exchange_one(a, fill, False))
                  for a in args)
        return r[0] if len(r) == 1 else r

    def exchange_scalar(self, value):
        """scalars skip the exchange"""
        return value

    def exchange_grid0(self, g0, fill=0.0):
        """the axis-0 grid coordinate, each image in its receiver's
        unwrapped frame (what the sharded paint and readout read)"""
        return self._poison(self._exchange_one(g0, fill, True))

    def ghost_mask(self):
        """(slots_per_block,) bool: True where a slot holds a particle"""
        ones = torch.ones(self.nl, dtype=torch.bool,
                          device=self.recv_valid.device)
        return torch.cat([ones] + list(self.recv_valid.unbind(0)))

    def gather(self, data, mode='sum', out=None):
        """Reduce ghost images back to this rank's particles.

        data : this rank's (slots_per_block, ...) slots, as exchange
            returns them.
        mode : 'sum' | 'mean' | 'any' | 'all' | 'local' | 'max' | 'min'
            | 'prod', a numpy ufunc (np.add, np.maximum, np.fmax,
            np.minimum, np.fmin and np.multiply map to those; any other
            ufunc with a torch function of its name, and any binary
            callable on tensors, combine each channel's values in
            channel order).
        """
        mode, combine = _gather_mode(mode)
        if mode == 'all':
            return data
        data = torch.as_tensor(data)
        if data.shape[0] != self.slots_per_block:
            raise ValueError(
                "gather expects the exchange result length %d, got %s"
                % (self.slots_per_block, tuple(data.shape)))
        nl, cap = self.nl, self.capacity
        chans = _channels(self.kside)
        out = data[:nl]
        if mode != 'local':
            # the ghost results, routed back to their source blocks
            backs = comm.ring_exchange(
                [(data[nl + c * cap: nl + (c + 1) * cap], -side * m)
                 for c, (m, side) in enumerate(chans)], self.procmesh)
            cnt = torch.ones(nl, dtype=data.dtype, device=data.device) \
                if mode == 'mean' else None
            for c, back in enumerate(backs):
                out, cnt = _combine_channel(out, cnt,
                                            self.send_idx[c].long(), back,
                                            mode, combine)
            if cnt is not None:
                out = out / cnt.reshape((-1,) + (1,) * (data.dim() - 1))
        return self._poison(out[:self.nlocal])

    def get_exchange_cost(self):
        """(D,) numpy: the ghost images each rank ships away"""
        t = (self.send_idx >= 0).sum().reshape(1).to(torch.int64)
        return comm.to_numpy(comm.all_gather(t, self.procmesh))


def measure_ghosts(procmesh, pos0_grid, N0, smoothing, kside=None):
    """(per-channel max ghost count over the ranks (numpy), the largest
    slab reach) of this rank's axis-0 grid coordinates, padded with the
    sentinels as :func:`decompose` pads them; :func:`decompose` with
    capacity='auto' sizes its channels from it."""
    D = procmesh.size
    rows = _slab_rows(N0, D)
    if kside is None:
        kside = _default_kside(smoothing, rows, D, N0)
    chans = _channels(kside)
    nl = max(_counts(procmesh, pos0_grid.shape[0]))
    g = _padded(procmesh, pos0_grid, N0, nl)
    dlo, dhi, masks = _ghost_counts(g, float(smoothing), procmesh.rank, N0,
                                    rows, D, chans)
    # a ball reaching half the ring or more wraps its upper distance
    # below the lower (the JAX package reads the wrapped one)
    dhi = torch.where(dhi < dlo, dhi + D, dhi)
    c = torch.stack([m.sum().to(torch.int64) for m in masks]
                    + [torch.maximum((-dlo).max(), dhi.max()).to(torch.int64)
                       if g.numel() else torch.zeros((), dtype=torch.int64,
                                                     device=g.device)])
    c = comm.to_numpy(comm.all_reduce(c, procmesh, 'max'))
    return c[:-1], int(c[-1])


def measure_load(procmesh, pos0_grid, N0, smoothing, kside=None):
    """The work of every rank on this state (numpy, the same on every
    rank): ``residents`` (particles of each block homed in its slab),
    ``ghosts_sent``, ``ghosts_recv``, ``paint_work`` (the block plus the
    ghosts received) and ``imbalance`` = max / mean of paint_work, 1.0
    being perfect.  Equal-count blocks balance the particles; the skew
    left is the clustering's, reported for a driver to act on."""
    D = procmesh.size
    rows = _slab_rows(N0, D)
    if kside is None:
        kside = _default_kside(smoothing, rows, D, N0)
    chans = _channels(kside)
    counts = _counts(procmesh, pos0_grid.shape[0])
    npart, nl = sum(counts), max(counts)
    npad = nl * D
    g = _padded(procmesh, pos0_grid, N0, nl)
    b = procmesh.rank
    gm = torch.remainder(g, N0)
    res = ((gm >= b * rows) & (gm < (b + 1) * rows)).sum()
    _, _, masks = _ghost_counts(g, float(smoothing), b, N0, rows, D, chans)
    local = torch.stack([res] + [m.sum() for m in masks]).to(torch.int64)
    both = comm.to_numpy(comm.all_gather(local[None], procmesh))
    res, sent = both[:, 0], both[:, 1:]
    recv = np.zeros(D, np.int64)
    for c, (m, side) in enumerate(chans):
        for j in range(D):
            recv[(j + side * m) % D] += sent[j, c]
    # the sentinels are deducted from the last block, where the JAX
    # package counts them
    if npad > npart and int(_sentinel_pos(N0, rows, D) // rows) == D - 1:
        res[-1] -= npad - npart
    work = np.full(D, nl, np.int64) + recv
    if npad > npart:
        work[-1] -= npad - npart
    return {"residents": res, "ghosts_sent": sent.sum(axis=1),
            "ghosts_recv": recv, "paint_work": work,
            "imbalance": float(work.max() / max(work.mean(), 1e-300))}


def decompose(procmesh, pos0_grid, N0, smoothing, kside=None,
              capacity=None, slack=1.3):
    """The :class:`ShardedLayout` of this rank's particles, whose axis-0
    grid coordinates are ``pos0_grid`` (nlocal,).

    kside : ghost channels per side; default the window's reach plus
        one slab, plus the dead seam slabs of an uneven mesh (at most the
        ring radius (D - 1) // 2; an uneven mesh whose reach across the
        seam needs more raises a ValueError).
    capacity : int | 'auto' | None — ghost slots per channel.  None is
        the block length (never overflows; every exchanged array is then
        (1 + 2 kside) times the particles).  'auto' measures the ghosts
        (:func:`measure_ghosts`), pads the largest count by ``slack``
        (at least 16), and grows a defaulted kside to the measured reach
        (a ValueError past the ring radius).
    """
    D = procmesh.size
    rows = _slab_rows(N0, D)
    pos0_grid = pos0_grid.detach()
    kside_given = kside is not None
    if kside is None:
        kside = _default_kside(smoothing, rows, D, N0)
        need = int(np.ceil(float(smoothing) / rows)) + 1 \
            + _dead_slabs(N0, rows, D)
        if rows * D != int(N0) and need > max(1, (D - 1) // 2):
            raise ValueError(
                "Nmesh[0]=%d is too small to slab-shard over %d devices "
                "(ghost reach %d slabs exceeds the ring radius %d); use "
                "fewer devices" % (N0, D, need, (D - 1) // 2))
    if 2 * kside + 1 > D:
        raise ValueError(
            "kside=%d ghost reach wraps the %d-device ring; use a "
            "smaller kside or more devices" % (kside, D))
    counts = _counts(procmesh, pos0_grid.shape[0])
    nl = max(counts)
    g = _padded(procmesh, pos0_grid, N0, nl)
    if capacity == 'auto':
        cnt, r = measure_ghosts(procmesh, pos0_grid, N0, smoothing,
                                kside=kside)
        if r > kside and not kside_given:
            rmax = (D - 1) // 2
            if r > rmax:
                raise ValueError(
                    "measured ghost reach %d slab-blocks exceeds the ring "
                    "radius %d on %d devices: the catalog is too clustered "
                    "for an equal-count slab residency — rebalance "
                    "(pm.reshard_particles) or use a 2-d process grid"
                    % (r, rmax, D))
            kside = r
            cnt, _ = measure_ghosts(procmesh, pos0_grid, N0, smoothing,
                                    kside=kside)
        capacity = max(int(np.ceil(float(cnt.max()) * float(slack))), 16)
    if capacity is None:
        capacity = nl
    capacity = int(min(capacity, nl))
    s = float(smoothing)
    if s > kside * rows:
        raise ValueError(
            "smoothing %g exceeds the kside=%d ghost reach (%d rows); "
            "increase kside" % (s, kside, kside * rows))
    chans = _channels(kside)
    dlo, dhi, masks = _ghost_counts(g, s, procmesh.rank, N0, rows, D, chans)
    # a ball reaching half the ring or more from the block wraps its
    # ring-signed distances (dhi < dlo): a breach too, which the JAX
    # package's check misses (ROADMAP queue 3)
    bad = ((dlo < -kside) | (dhi > kside) | (dhi < dlo)).sum()
    arange = torch.arange(nl, dtype=torch.int32, device=g.device)
    bufs = []
    over = torch.zeros((), dtype=torch.int64, device=g.device)
    for mask in masks:
        rank = torch.cumsum(mask.to(torch.int64), 0) - 1
        slot = torch.where(mask & (rank < capacity), rank, capacity)
        buf = torch.full((capacity + 1,), -1, dtype=torch.int32,
                         device=g.device)
        buf[slot] = arange
        bufs.append(buf[:capacity])
        over = over + torch.clamp(mask.sum() - capacity, min=0)
    send_idx = torch.stack(bufs) if bufs else torch.empty(
        (0, capacity), dtype=torch.int32, device=g.device)
    badcount = comm.all_reduce((bad + over).to(torch.float32).reshape(1),
                               procmesh, 'sum')[0]
    badness = torch.where(badcount > 0, float('nan'), 0.0).to(torch.float32)
    # the received slots' validity: the sent slots' validity, permuted
    oks = comm.ring_exchange([(send_idx[c] >= 0, side * m)
                              for c, (m, side) in enumerate(chans)], procmesh)
    recv_valid = torch.stack(oks) if oks else \
        torch.empty((0, capacity), dtype=torch.bool, device=g.device)
    return ShardedLayout(procmesh, send_idx, recv_valid, badness, counts,
                         N0, rows, kside, capacity, smoothing)


def _rows_bytes(arrays):
    """the rows of each array as bytes, side by side: (n, total) uint8
    and each array's (width, dtype, row shape)"""
    cols, spec = [], []
    for a in arrays:
        a = a.detach().contiguous()
        n = a.shape[0]
        flat = a.reshape(n, int(np.prod(a.shape[1:], dtype=np.int64)))
        if flat.dtype == torch.bool:
            flat = flat.to(torch.uint8)
        cols.append(flat.view(torch.uint8))
        spec.append((cols[-1].shape[1], a.dtype, tuple(a.shape[1:])))
    return torch.cat(cols, 1), spec


def _from_bytes(rows, spec):
    out, off = [], 0
    n = rows.shape[0]
    for width, dtype, shape in spec:
        b = rows[:, off:off + width].contiguous()
        off += width
        if dtype == torch.bool:
            a = b.view(torch.uint8).bool()
        else:
            a = b.view(dtype)
        out.append(a.reshape((n,) + shape))
    return out


class _Route(torch.autograd.Function):
    """The rows of :func:`route`: every array's rows and the slots
    travel as bytes in one all_to_all_v.  Transpose: the cotangent rows
    of the floating arrays, read at the slots, travel back the same way
    to the rows they came from; forward mode routes the tangents as the
    rows.  ``plan`` = (the counts sent, nout); ``stay`` and ``order``
    index the rows kept and the rows sent, in destination order.  The
    outputs end with the received rows' slots and counts (no
    derivative)."""

    @staticmethod
    def forward(procmesh, plan, slot, stay, order, *arrays):
        counts, nout = plan
        allrows, spec = _rows_bytes(list(arrays) + [slot])
        got, recv_counts = comm.all_to_all_v(allrows[order], procmesh,
                                             counts)
        rows = torch.cat([allrows[stay], got], 0)
        *vals, slots = _from_bytes(rows, spec)
        return tuple(_placed(v, slots, nout) for v in vals) + (
            slots, torch.tensor(recv_counts, dtype=torch.int64))

    @staticmethod
    def setup_context(ctx, inputs, output):
        procmesh, plan, slot, stay, order, *arrays = inputs
        ctx.mark_non_differentiable(*output[len(arrays):])
        ctx.procmesh, ctx.plan = procmesh, plan
        ctx.stay, ctx.order = stay, order
        ctx.slots = output[len(arrays)]
        ctx.recv_counts = tuple(int(c) for c in output[-1])
        ctx.specs = tuple(comm._spec(a) for a in arrays)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, *gs):
        _, nout = ctx.plan
        stay, order = ctx.stay, ctx.order
        pick = [j for j, spec in enumerate(ctx.specs)
                if (spec[1].is_floating_point or spec[1].is_complex)
                and ctx.needs_input_grad[5 + j]]
        grads = [None] * len(ctx.specs)
        if pick:
            cts = [(gs[j] if gs[j] is not None
                    else torch.zeros((nout,) + ctx.specs[j][0][1:],
                                     dtype=ctx.specs[j][1],
                                     device=ctx.specs[j][2]))[ctx.slots]
                   for j in pick]
            rows, spec = _rows_bytes(cts)
            ns = stay.shape[0]
            back, _ = comm.all_to_all_v(rows[ns:], ctx.procmesh,
                                        ctx.recv_counts)
            for j, kept, sent in zip(pick, _from_bytes(rows[:ns], spec),
                                     _from_bytes(back, spec)):
                shape, dtype, device = ctx.specs[j]
                g = torch.zeros(shape, dtype=dtype, device=device)
                g[stay] = kept
                g[order] = sent
                grads[j] = g
        return (None,) * 5 + tuple(grads)

    @staticmethod
    def jvp(ctx, _procmesh, _plan, _slot, _stay, _order, *ts):
        counts, nout = ctx.plan
        stay, order = ctx.stay, ctx.order
        out = []
        for t, (shape, dtype, device) in zip(ts, ctx.specs):
            if not (dtype.is_floating_point or dtype.is_complex):
                out.append(None)
                continue
            t = torch.zeros(shape, dtype=dtype, device=device) \
                if t is None else t
            got, _ = comm.all_to_all_v(t[order], ctx.procmesh, counts)
            out.append(_placed(torch.cat([t[stay], got], 0), ctx.slots,
                               nout))
        return tuple(out) + (None, None)


def _placed(v, slots, nout):
    """an (nout, ...) array holding row i of ``v`` at row slots[i]"""
    o = torch.empty((nout,) + tuple(v.shape[1:]), dtype=v.dtype,
                    device=v.device)
    o[slots] = v
    return o


def route(procmesh, dest, slot, nout, *arrays):
    """Send row i of each array to rank ``dest[i]``, where it lands at
    row ``slot[i]`` of an (nout, ...) array: returns those arrays on
    every rank.  Rows that stay on their rank do not travel; the rest
    move in one :func:`comm.all_to_all_v` of their bytes.
    Differentiable in the floating arrays (the cotangent rows travel
    back)."""
    D, me = procmesh.size, procmesh.rank
    dest = dest.to(torch.int64)
    stay = torch.nonzero(dest == me).flatten()
    order = torch.argsort(dest, stable=True)
    order = order[dest[order] != me]
    counts = tuple(torch.bincount(dest[order], minlength=D).cpu().tolist())
    outs = _Route.apply(procmesh, (counts, int(nout)),
                        slot.to(torch.int64), stay, order, *arrays)
    return list(outs[:len(arrays)])


def sort_route(procmesh, key, nkeys, *arrays):
    """Re-sort particle arrays over the ranks by an integer ``key`` in
    [0, nkeys) of each row: block b of the result holds the b-th
    equal-count quantile of the rows in (key, source rank, source row)
    order, ceil(npart / D) rows each, the last blocks short; the rows
    travel in one ragged all_to_all.  Returns the new blocks (one array:
    the array)."""
    D, me = procmesh.size, procmesh.rank
    key = key.to(torch.int64)
    n = key.shape[0]
    local = torch.bincount(key, minlength=nkeys)
    C = comm.to_numpy(comm.all_gather(local[None], procmesh))   # (src, key)
    npart = int(C.sum())
    if npart == 0:
        return arrays[0] if len(arrays) == 1 else tuple(arrays)
    nl = -(-npart // D)
    # the global position of each row: the rows of lower keys, those of
    # its key on lower ranks, then its rank among this rank's rows of the
    # same key
    base = np.concatenate([[0], np.cumsum(C.sum(axis=0))[:-1]]) \
        + C[:me].sum(axis=0)
    order = torch.argsort(key, stable=True)
    ks = key[order]
    first = torch.from_numpy(np.concatenate(
        [[0], np.cumsum(comm.to_numpy(local))[:-1]])).to(key.device)
    within = torch.arange(n, device=key.device) - first[ks]
    gpos = torch.empty_like(key)
    gpos[order] = torch.from_numpy(base).to(key.device)[ks] + within
    nout = min(nl, max(npart - me * nl, 0))
    out = route(procmesh, gpos // nl, gpos % nl, nout, *arrays)
    return out[0] if len(arrays) == 1 else tuple(out)


def reshard(procmesh, pos0_grid, N0, *arrays):
    """Globally re-sort particle arrays so block b holds the b-th
    equal-count quantile of the particles in x-plane order: the mpsort
    role, restoring the residency of :func:`decompose`.  Every rank
    passes its block and gets its new block (ceil(npart / D) rows, the
    last blocks short; :func:`sort_route`).

    The order is the mesh plane floor(x mod N0) major, then the source
    rank, then each rank's own order.  Where slab populations are
    uneven, the equal-count split puts a few particles one block from
    home, and this order makes them the ones in the planes next to that
    block.  The JAX package orders by home slab, then rank and input
    order, which can put particles from the far side of a slab (those
    wrapped across the box's edge, say) one block away, where their
    windows reach two blocks, past a 4-rank ring's reach (ROADMAP queue
    3).  Its blocks are this order's wherever each home slab's particles
    come plane-sorted."""
    N0 = int(N0)
    plane = torch.remainder(torch.floor(torch.remainder(
        pos0_grid.detach(), N0)), N0).to(torch.int64)
    return sort_route(procmesh, plane, N0, *arrays)


# --- the sharded paint and readout -------------------------------------------
#
# Each rank paints and reads only its own (rows, N1, ...) slab from its
# images: stencil cells outside the slab are dropped, since the image on
# the neighbouring rank covers them (the reference's local-canvas rule).
# On an uneven mesh a rank's slab is padded to ``rows`` with the dead
# rows past N0: a paint's spill there is dropped, a readout reads zeros.

def _real_rows(layout):
    """the rows of this rank's slab that lie on the mesh"""
    start, stop = layout.procmesh.block(layout.N0)
    return stop - start

def _grid_coords(layout, pos, scale, translate):
    """the images' per-axis grid coordinates; ``translate`` (cells) is
    added before the exchange, so the plan :func:`decompose` built from
    the same translated axis-0 coordinate covers the stencils"""
    pos = torch.as_tensor(pos)
    ndim = pos.shape[-1]
    if translate is None:
        translate = (0.0,) * ndim
    g = [pos[:, d] * torch.as_tensor(float(scale[d]), dtype=pos.dtype)
         + torch.as_tensor(float(translate[d]), dtype=pos.dtype)
         for d in range(ndim)]
    return [layout.exchange_grid0(g[0])] + [layout.exchange(x)
                                            for x in g[1:]]


def _check_hsml(layout, window, hsml, hsml_max):
    """the images' hsml and a poison for an hsml past ``hsml_max`` (on
    every rank); the layout's smoothing must cover hsml_max's reach"""
    from ..ops.kernels import find_window
    if hsml is None:
        return None, None
    if hsml_max is None:
        raise ValueError(
            "the sharded paint/readout needs a static hsml_max with "
            "per-particle hsml (the ghost reach is a static plan)")
    reach = find_window(window).support_float * 0.5 * float(hsml_max)
    if reach > layout.smoothing + 1e-9:
        raise ValueError(
            "hsml_max=%g needs a ghost reach of %g cells but the layout was "
            "built with smoothing=%g; decompose with "
            "smoothing=support/2*hsml_max" % (hsml_max, reach,
                                              layout.smoothing))
    hsml = torch.as_tensor(hsml)
    h = hsml.detach()
    top = h.max().reshape(1) if h.numel() else h.new_zeros(1)
    top = comm.all_reduce(top.to(torch.float64), layout.procmesh, 'max')[0]
    bad = torch.where(top > hsml_max, float('nan'), 0.0).to(torch.float32)
    return layout.exchange(hsml, fill=1.0), bad


def _diff_scale(outs, scale, diffdir):
    """the sim-to-grid factor of a derivative window, which the local
    stencils (in grid units) leave out"""
    if diffdir is None:
        return outs
    if diffdir == 'all':
        return tuple(o * float(scale[d]) for d, o in enumerate(outs))
    return tuple(o * float(scale[int(diffdir)]) for o in outs)


def _local_pos(layout, egs):
    rows = layout.rows
    return torch.stack([egs[0] - layout.procmesh.rank * rows]
                       + list(egs[1:]), dim=-1)


def paint_sharded(layout, pos, mass, shape, scale, window, diffdir=None,
                  dtype=None, base=None, hsml=None, hsml_max=None,
                  translate=None):
    """This rank's slab (rows_b, N1, ...) of the paint of every rank's
    particles (rows_b the slab's rows on the mesh).

    pos : this rank's (nlocal, ndim) positions in simulation units;
    mass : a scalar or (nlocal,); shape : the global mesh shape;
    scale, translate : the affine to grid units; base : a slab to add
    to; hsml, hsml_max : per-particle support scaling and its bound.
    """
    from ..ops import paint as _paint_ops
    pos = torch.as_tensor(pos)
    shape = tuple(int(n) for n in shape)
    if shape[0] != layout.N0:
        raise ValueError("mesh shape %s does not match the layout's N0=%d"
                         % (shape, layout.N0))
    dtype = pos.dtype if dtype is None else dtype
    egs = _grid_coords(layout, pos, scale, translate)
    m = torch.broadcast_to(torch.as_tensor(mass, dtype=dtype,
                                           device=pos.device),
                           (pos.shape[0],))
    em = layout.exchange(m, fill=0)
    eh, hbad = _check_hsml(layout, window, hsml, hsml_max)
    zeros = torch.zeros((layout.rows,) + shape[1:], dtype=dtype,
                        device=pos.device)
    # axis 0 unwrapped and not periodic (the images cover the straddle)
    out = _paint_ops.paint(zeros, _local_pos(layout, egs), mass=em,
                           window=window, scale=1.0, translate=0.0,
                           period=(0,) + shape[1:], diffdir=diffdir,
                           hsml=eh, hsml_max=hsml_max)
    nb = _real_rows(layout)
    if nb != layout.rows:
        out = out[:nb]
    out = _diff_scale((out,), scale, diffdir)[0]
    # a poisoned plan's NaN coordinates are dropped by the paint's
    # bounds: put the poison in the mesh itself
    out = out + layout.badness.to(out.dtype)
    if hbad is not None:
        out = out + hbad.to(out.dtype)
    if base is not None:
        out = out + base
    return out


def readout_sharded(layout, meshes, pos, scale, window, diffdir=None,
                    hsml=None, hsml_max=None, translate=None):
    """The values of this rank's slabs ``meshes`` (one, or a tuple read
    in one stencil pass) at every rank's particles: per mesh, this
    rank's (nlocal,) values.  ``diffdir='all'``: one mesh, the ndim
    derivative readouts in one stencil pass and one ghost gather,
    returned as an ndim-tuple."""
    from ..ops import paint as _paint_ops
    multi = diffdir == 'all'
    single = not isinstance(meshes, (tuple, list)) and not multi
    meshes = (meshes,) if not isinstance(meshes, (tuple, list)) \
        else tuple(meshes)
    pos = torch.as_tensor(pos)
    ndim = pos.shape[-1]
    if multi and len(meshes) != 1:
        raise ValueError("diffdir='all' takes exactly one mesh")
    nb = _real_rows(layout)
    if meshes[0].shape[0] != nb:
        raise ValueError("mesh slab of %d rows does not match the layout's "
                         "%d" % (meshes[0].shape[0], nb))
    if nb != layout.rows:
        meshes = tuple(torch.cat([m, m.new_zeros((layout.rows - nb,)
                                                 + tuple(m.shape[1:]))])
                       for m in meshes)
    shape = (layout.N0,) + tuple(meshes[0].shape[1:])
    egs = _grid_coords(layout, pos, scale, translate)
    eh, hbad = _check_hsml(layout, window, hsml, hsml_max)
    p = _local_pos(layout, egs)
    kw = dict(window=window, scale=1.0, translate=0.0,
              period=(0,) + shape[1:], hsml=eh, hsml_max=hsml_max)
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
