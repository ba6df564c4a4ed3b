"""The collectives of the sharded code, in one place, each differentiable.

- :func:`all_to_all`: the tiled ``jax.lax.all_to_all(x, axis,
  split_axis, concat_axis, tiled=True)``: split ``split_axis`` into P
  blocks, send block j to rank j, concatenate the blocks received from
  ranks 0..P-1 along ``concat_axis``; one ``all_to_all_single`` on a
  contiguous, permuted buffer;
- :func:`all_gather`: the tiled ``jax.lax.all_gather`` along an axis;
  :func:`gather` the same onto one rank;
- :func:`all_reduce`: sum, max or min of a tensor over the ranks
  (``jax.lax.psum`` / ``pmax``); :func:`pbroadcast`, its partner for
  reverse mode (below);
- :func:`ring_exchange`: the ring send/recv of plane blocks
  (``jax.lax.ppermute`` with fixed hops), over ``batch_isend_irecv``;
  :func:`torus_exchange` the same on a 2-d grid, each block shipped by
  an offset (ox, oy) over both grid axes at once (the ``ppermute``
  over ('x', 'y') of ``parallel/exchange2d.py``);
- :func:`all_to_all_v`: the ragged all_to_all of rows grouped by
  destination rank, the counts exchanged first (MPI's Alltoallv, the
  global sort of ``parallel/exchange.reshard``).

Backend rule, fixed when the ProcessMesh is built (``pm.staged``):
under NCCL device tensors go device to device; under gloo, CUDA tensors
are staged through host buffers for every collective but all_reduce,
because gloo implements only broadcast and all_reduce for CUDA tensors.
``STAGED_BYTES`` counts the bytes so staged (each direction), those of
the backward and of forward-mode tangents included.  Complex tensors
travel as their (re, im) pairs and bf16 tensors as a byte view (the last
axis twice as long), bool tensors as bytes: bit exact, and the backend
need not know bf16 or bool.

Derivatives.  Every collective here is linear, and each is a
``torch.autograd.Function`` whose backward is its transpose and whose
``jvp`` is the collective of the tangents (``torch.func.jvp``,
``torch.autograd.forward_ad``); the staging happens inside the
Function, so every node's input and output stays on the rank's device.
The convention is the ``psum``/``pbroadcast`` pairing of JAX's
``shard_map``:

- the gradient of a *blocked* tensor (particle blocks, slabs, pencils)
  is this rank's block of the global gradient;
- the gradient of a *replicated* tensor (the same on every rank) is the
  whole global gradient, on every rank;
- a loss that every rank holds (after a sum over the ranks, say) is
  seeded once per rank, by ``loss.backward()`` on every rank;
- so ``all_reduce``-sum (rank-local partials -> a replicated sum) has
  the identity as its backward, and where a replicated tensor meets
  rank-local data (the replicated route's readout, a replicated scalar
  mass painting blocked particles) :func:`pbroadcast` stands between
  them: the identity forward, an ``all_reduce``-sum backward.  Without
  it the replicated tensor's gradient is one rank's share; a sum in the
  wrong place makes it P times too large;
- ``all_gather``'s output is rank-local data (each rank reads its own
  copy): its backward is this rank's block of the cotangents summed over
  the ranks;
- ``all_to_all``'s backward is the inverse all_to_all, the ring and
  torus exchanges' the same blocks sent back along the reversed offsets,
  ``all_to_all_v``'s the rows sent back with the counts swapped.

Every rank builds the same graph and so issues its backward's
collectives in the same order (the autograd engine runs the ready nodes
of one device by sequence number).  ``gather`` and ``all_reduce`` by
'max' or 'min' have no derivative: given a tensor that requires grad
they raise (detach the decision's inputs first).  A rank must take part
in a differentiable collective exactly when the others do: a block that
is empty on one rank still carries its ``requires_grad``.

On a mesh of one rank every collective is the identity (no process
group is needed).  Every function takes a ``ProcessMesh`` or the
``GridAxis`` of one axis of a 2-d grid (``ProcessMesh.along``), and then
runs over that axis's process group.
"""
import numpy as np
import torch
import torch.distributed as dist

__all__ = ["all_to_all", "all_to_all_v", "all_gather", "gather",
           "all_reduce", "pbroadcast", "ring_exchange", "torus_exchange",
           "to_numpy", "STAGED_BYTES", "reset_staged"]

STAGED_BYTES = {"to_host": 0, "to_device": 0}


def reset_staged():
    for k in STAGED_BYTES:
        STAGED_BYTES[k] = 0


def _wire(x):
    """(tensor on the wire, function restoring the caller's dtype)"""
    if x.is_complex():
        return torch.view_as_real(x), torch.view_as_complex
    if x.dtype == torch.bfloat16:
        # gloo refuses int16; bytes are exact under any backend
        return x.contiguous().view(torch.uint8), \
            lambda t: t.view(torch.bfloat16)
    if x.dtype == torch.bool:
        return x.to(torch.uint8), lambda t: t.bool()
    return x, lambda t: t


def _to_wire(pm, t):
    """the buffer a collective reads: contiguous, on the host under
    staging"""
    t = t.contiguous()
    if pm.staged:
        STAGED_BYTES["to_host"] += t.numel() * t.element_size()
        return t.cpu()
    return t


def _from_wire(pm, t):
    if pm.staged:
        STAGED_BYTES["to_device"] += t.numel() * t.element_size()
        return t.to(pm.device)
    return t


def _empty_wire(pm, shape, dtype):
    return torch.empty(shape, dtype=dtype,
                       device='cpu' if pm.staged else pm.device)


def to_numpy(t):
    """a (small) tensor's values as a numpy array on the host, also for
    a tensor of a ``torch.func`` transform, which has no storage of its
    own (plan sizes, counts and loads)"""
    return np.asarray(t.tolist())


def _no_derivative(what, *tensors):
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad
            for t in tensors):
        raise RuntimeError(
            "%s has no derivative: detach its input (a collective never "
            "detaches a tensor that requires grad)" % what)


def _zeros_for(t, spec):
    """the tangent ``t``, or zeros of the primal's (shape, dtype, device)
    ``spec`` where forward mode gives None"""
    return torch.zeros(*spec) if t is None else t


def _spec(t):
    return (tuple(t.shape), t.dtype, t.device)


# --- the wire-level collectives (no autograd) --------------------------------

def _all_to_all(x, pm, a, c):
    P = pm.size
    w, back = _wire(x)
    # (P, block...) with block j of the split axis first
    send = w.unflatten(a, (P, w.shape[a] // P)).movedim(a, 0)
    send = _to_wire(pm, send)
    recv = _empty_wire(pm, send.shape, send.dtype)
    dist.all_to_all_single(recv, send, group=pm.group)
    recv = _from_wire(pm, recv)
    # recv[j] is rank j's block: put the rank axis before the concat
    # axis and merge the two, rank-major
    out = recv.movedim(0, c).flatten(c, c + 1)
    return back(out.contiguous())


def _all_gather(x, pm, ax):
    P = pm.size
    w, back = _wire(x)
    send = _to_wire(pm, w)
    recv = _empty_wire(pm, (P,) + tuple(send.shape), send.dtype)
    dist.all_gather(list(recv.unbind(0)), send, group=pm.group)
    recv = _from_wire(pm, recv)
    out = recv.movedim(0, ax).flatten(ax, ax + 1)
    return back(out.contiguous())


def _reduce_scatter(g, pm, ax):
    """this rank's block (along ``ax``) of ``g`` summed over the ranks:
    block j of every rank goes to rank j in one all_to_all"""
    P = pm.size
    blocks = _all_to_all(g.unflatten(ax, (P, g.shape[ax] // P))
                         .movedim(ax, 0), pm, 0, 0)
    return blocks.unflatten(0, (P, blocks.shape[0] // P)).sum(0)


def _all_reduce(x, pm, op):
    out = x.clone()
    if pm.size > 1:
        w = torch.view_as_real(out) if out.is_complex() else out
        dist.all_reduce(w, op=_OPS[op], group=pm.group)
    return out


def _all_to_all_v(x, pm, counts, recv_counts):
    w, back = _wire(x)
    send = _to_wire(pm, w)
    recv = _empty_wire(pm, (sum(recv_counts),) + tuple(send.shape[1:]),
                       send.dtype)
    dist.all_to_all_single(recv, send, output_split_sizes=list(recv_counts),
                           input_split_sizes=list(counts), group=pm.group)
    return back(_from_wire(pm, recv))


def _p2p_raw(blocks, pm):
    """send each ``(tensor, dst, src)`` of ``blocks`` to the group rank
    ``dst`` and receive a tensor of its shape and dtype from ``src``, in
    one ``batch_isend_irecv``; a block whose dst is this rank is kept"""
    out = [None] * len(blocks)
    ops, recvs = [], []
    for n, (t, dst, src) in enumerate(blocks):
        if dst == pm.rank:
            out[n] = t.clone()
            continue
        w, back = _wire(t)
        send = _to_wire(pm, w)
        recv = _empty_wire(pm, send.shape, send.dtype)
        ops.append(dist.P2POp(dist.isend, send, pm.ranks[dst],
                              group=pm.group))
        ops.append(dist.P2POp(dist.irecv, recv, pm.ranks[src],
                              group=pm.group))
        recvs.append((n, recv, back))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    for n, recv, back in recvs:
        out[n] = back(_from_wire(pm, recv))
    return out


# --- the Functions ------------------------------------------------------------

class _AllToAll(torch.autograd.Function):
    """the tiled all_to_all; transpose: split and concat swapped"""

    @staticmethod
    def forward(x, pm, a, c):
        return _all_to_all(x.detach(), pm, a, c)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.args = inputs[1:]

    @staticmethod
    def backward(ctx, g):
        pm, a, c = ctx.args
        return _AllToAll.apply(g.contiguous(), pm, c, a), None, None, None

    @staticmethod
    def jvp(ctx, t, *_):
        return _AllToAll.apply(t, *ctx.args)


class _AllGather(torch.autograd.Function):
    """all_gather; transpose: this rank's block of the summed
    cotangents"""

    @staticmethod
    def forward(x, pm, ax):
        return _all_gather(x.detach(), pm, ax)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.args = inputs[1:]

    @staticmethod
    def backward(ctx, g):
        pm, ax = ctx.args
        return _ReduceScatter.apply(g.contiguous(), pm, ax), None, None

    @staticmethod
    def jvp(ctx, t, *_):
        return _AllGather.apply(t, *ctx.args)


class _ReduceScatter(torch.autograd.Function):
    """the transpose of all_gather, whose transpose it has"""

    @staticmethod
    def forward(g, pm, ax):
        return _reduce_scatter(g.detach(), pm, ax)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.args = inputs[1:]

    @staticmethod
    def backward(ctx, g):
        return _AllGather.apply(g.contiguous(), *ctx.args), None, None

    @staticmethod
    def jvp(ctx, t, *_):
        return _ReduceScatter.apply(t, *ctx.args)


class _AllReduce(torch.autograd.Function):
    """psum: rank-local partials to their replicated sum; backward the
    identity (module docstring)"""

    @staticmethod
    def forward(x, pm):
        return _all_reduce(x.detach(), pm, 'sum')

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.pm = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return _PBroadcast.apply(g, ctx.pm), None

    @staticmethod
    def jvp(ctx, t, _pm):
        return _AllReduce.apply(t, ctx.pm)


class _AllReduceOrder(torch.autograd.Function):
    """pmax / pmin, which decide and have no derivative; a Function so
    that ``torch.func`` hands the collective plain tensors"""

    @staticmethod
    def forward(x, pm, op):
        return _all_reduce(x.detach(), pm, op)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.op = inputs[2]

    @staticmethod
    def backward(ctx, g):
        raise RuntimeError("all_reduce(op=%r) has no derivative" % ctx.op)

    @staticmethod
    def jvp(ctx, *_):
        raise RuntimeError("all_reduce(op=%r) has no derivative" % ctx.op)


class _PBroadcast(torch.autograd.Function):
    """pbroadcast: a replicated tensor handed to rank-local data; the
    identity forward, an all_reduce-sum backward"""

    @staticmethod
    def forward(x, pm):
        return x.view_as(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.pm = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return _AllReduce.apply(g, ctx.pm), None

    @staticmethod
    def jvp(ctx, t, _pm):
        return t.view_as(t)


class _AllToAllV(torch.autograd.Function):
    """the ragged all_to_all with known counts; transpose: the rows sent
    back with the counts swapped"""

    @staticmethod
    def forward(x, pm, counts, recv_counts):
        return _all_to_all_v(x.detach(), pm, counts, recv_counts)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.args = inputs[1:]

    @staticmethod
    def backward(ctx, g):
        pm, counts, recv_counts = ctx.args
        return (_AllToAllV.apply(g.contiguous(), pm, recv_counts, counts),
                None, None, None)

    @staticmethod
    def jvp(ctx, t, *_):
        return _AllToAllV.apply(t, *ctx.args)


class _P2P(torch.autograd.Function):
    """point-to-point blocks: block n goes to ``route[n][0]`` and one
    arrives from ``route[n][1]``; transpose: the route reversed"""

    @staticmethod
    def forward(pm, route, *tensors):
        return tuple(_p2p_raw([(t.detach(), d, s) for t, (d, s)
                               in zip(tensors, route)], pm))

    @staticmethod
    def setup_context(ctx, inputs, output):
        pm, route, *tensors = inputs
        ctx.pm, ctx.route = pm, route
        ctx.specs = tuple(_spec(t) for t in output)
        ctx.in_specs = tuple(_spec(t) for t in tensors)

    @staticmethod
    def backward(ctx, *gs):
        back = tuple((s, d) for d, s in ctx.route)
        gs = tuple(_zeros_for(g, spec).contiguous()
                   for g, spec in zip(gs, ctx.specs))
        return (None, None) + tuple(_P2P.apply(ctx.pm, back, *gs))

    @staticmethod
    def jvp(ctx, _pm, _route, *ts):
        ts = tuple(_zeros_for(t, spec) for t, spec in zip(ts, ctx.in_specs))
        return tuple(_P2P.apply(ctx.pm, ctx.route, *ts))


# --- the public collectives ---------------------------------------------------

def all_to_all(x, pm, split_axis, concat_axis):
    """The tiled all_to_all of ``x`` over the ranks of ``pm`` (see the
    module docstring); ``x.shape[split_axis]`` must divide by P."""
    P = pm.size
    if P == 1:
        return x
    nd = x.dim()
    a, c = split_axis % nd, concat_axis % nd
    if x.shape[a] % P:
        raise ValueError("all_to_all: axis %d of length %d does not split "
                         "into %d blocks" % (a, x.shape[a], P))
    return _AllToAll.apply(x, pm, a, c)


def all_gather(x, pm, axis=0):
    """The blocks of every rank concatenated along ``axis`` (rank-major),
    on every rank."""
    if pm.size == 1:
        return x
    return _AllGather.apply(x, pm, axis % x.dim())


def gather(x, pm, dst=0, axis=0):
    """The blocks of every rank concatenated along ``axis`` on rank
    ``dst`` (None on the others); no derivative."""
    P = pm.size
    if P == 1:
        return x
    _no_derivative("gather", x)
    w, back = _wire(x.detach())
    send = _to_wire(pm, w)
    recv = None
    if pm.rank == dst:
        recv = _empty_wire(pm, (P,) + tuple(send.shape), send.dtype)
    dist.gather(send, list(recv.unbind(0)) if recv is not None else None,
                dst=pm.ranks[dst], group=pm.group)
    if recv is None:
        return None
    recv = _from_wire(pm, recv)
    ax = axis % x.dim()
    return back(recv.movedim(0, ax).flatten(ax, ax + 1).contiguous())


_OPS = {'sum': dist.ReduceOp.SUM, 'max': dist.ReduceOp.MAX,
        'min': dist.ReduceOp.MIN}


def all_reduce(x, pm, op='sum'):
    """A new tensor: ``x`` reduced over the ranks by 'sum', 'max' or
    'min' (device to device under either backend; a complex tensor as
    its (re, im) pairs, so only by 'sum').  The sum is differentiable
    (module docstring); 'max' and 'min' refuse a tensor that requires
    grad."""
    if op not in _OPS:
        raise ValueError("op must be 'sum', 'max' or 'min' (got %r)" % (op,))
    if pm.size > 1 and x.is_complex() and op != 'sum':
        raise ValueError("a complex tensor reduces by 'sum' only")
    if op != 'sum':
        _no_derivative("all_reduce(op=%r)" % op, x)
        if pm.size == 1:
            return x.clone()
        return _AllReduceOrder.apply(x, pm, op)
    if pm.size == 1:
        return x.clone()
    return _AllReduce.apply(x, pm)


def pbroadcast(x, pm):
    """``x``, a replicated tensor, handed to rank-local computation: the
    identity, whose backward sums the cotangents over the ranks (module
    docstring)."""
    if pm.size == 1:
        return x
    return _PBroadcast.apply(x, pm)


def all_to_all_v(x, pm, counts):
    """The rows of ``x``, grouped by destination rank (``counts[j]`` rows
    for rank j, in rank order), sent to their ranks: returns the rows
    received, grouped by source rank, and the count from each source (a
    list).  The counts travel first, in one all_to_all of P integers;
    the rows' derivative sends them back."""
    P = pm.size
    counts = [int(c) for c in counts]
    if len(counts) != P or sum(counts) != x.shape[0]:
        raise ValueError("all_to_all_v: %d counts summing to %d for %d rows "
                         "on %d ranks" % (len(counts), sum(counts),
                                          x.shape[0], P))
    if P == 1:
        return x, counts
    recv_counts = _exchange_counts(pm, counts)
    return _AllToAllV.apply(x, pm, tuple(counts), tuple(recv_counts)), \
        recv_counts


def _exchange_counts(pm, counts):
    """the count each rank sends this one, given the count this one
    sends each rank (one all_to_all of P integers)"""
    sc = _empty_wire(pm, (pm.size,), torch.int64)
    sc.copy_(torch.tensor([int(c) for c in counts], dtype=torch.int64))
    rc = torch.empty_like(sc)
    dist.all_to_all_single(rc, sc, group=pm.group)
    return [int(c) for c in rc.cpu()]


def _p2p(blocks, pm):
    """send each ``(tensor, dst, src)`` of ``blocks`` to the group rank
    ``dst`` and receive a tensor of its shape and dtype from ``src``, in
    one ``batch_isend_irecv`` (differentiable: module docstring); a
    block whose dst is this rank is kept"""
    if not blocks:
        return []
    route = tuple((int(d), int(s)) for _, d, s in blocks)
    return list(_P2P.apply(pm, route, *(t for t, _, _ in blocks)))


def ring_exchange(blocks, pm):
    """Send each ``(tensor, hop)`` of ``blocks`` to rank (r + hop) % P
    and receive, for each, a tensor of the same shape and dtype from
    rank (r - hop) % P; one ``batch_isend_irecv`` for all of them.  A hop
    that is a multiple of P keeps the tensor."""
    P, r = pm.size, pm.rank
    return _p2p([(t, (r + hop) % P, (r - hop) % P) for t, hop in blocks],
                pm)


def torus_exchange(blocks, pm):
    """Send each ``(tensor, (ox, oy))`` of ``blocks`` from this rank, at
    (bx, by) on the 2-d grid of ``pm``, to the rank at
    ((bx + ox) % npx, (by + oy) % npy), and receive one of the same shape
    and dtype from ((bx - ox) % npx, (by - oy) % npy); one
    ``batch_isend_irecv`` for all of them.  Each ordered pair of ranks may
    carry one block at most: distinct offsets modulo the grid."""
    npx, npy = pm.grid
    bx, by = pm.coords

    def flat(x, y):
        return (x % npx) * npy + y % npy
    return _p2p([(t, flat(bx + ox, by + oy), flat(bx - ox, by - oy))
                 for t, (ox, oy) in blocks], pm)
