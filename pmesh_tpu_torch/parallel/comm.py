"""The collectives of the slab-sharded code, in one place.

- :func:`all_to_all`: the tiled ``jax.lax.all_to_all(x, axis,
  split_axis, concat_axis, tiled=True)``: split ``split_axis`` into P
  blocks, send block j to rank j, concatenate the blocks received from
  ranks 0..P-1 along ``concat_axis``; one ``all_to_all_single`` on a
  contiguous, permuted buffer;
- :func:`all_gather`: the tiled ``jax.lax.all_gather`` along an axis;
  :func:`gather` the same onto one rank;
- :func:`all_reduce`: sum, max or min of a tensor over the ranks
  (``jax.lax.psum`` / ``pmax``);
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
``STAGED_BYTES`` counts the bytes so staged (each direction).  Complex
tensors travel as their (re, im) pairs and bf16 tensors as a byte view
(the last axis twice as long), bool tensors as bytes: bit exact, and
the backend need not know bf16 or bool.

On a mesh of one rank every collective is the identity (no process
group is needed).  Every function takes a ``ProcessMesh`` or the
``GridAxis`` of one axis of a 2-d grid (``ProcessMesh.along``), and then
runs over that axis's process group.
"""
import torch
import torch.distributed as dist

__all__ = ["all_to_all", "all_to_all_v", "all_gather", "gather",
           "all_reduce", "ring_exchange", "torus_exchange", "STAGED_BYTES",
           "reset_staged"]

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


def all_gather(x, pm, axis=0):
    """The blocks of every rank concatenated along ``axis`` (rank-major),
    on every rank."""
    P = pm.size
    if P == 1:
        return x
    w, back = _wire(x)
    send = _to_wire(pm, w)
    recv = _empty_wire(pm, (P,) + tuple(send.shape), send.dtype)
    dist.all_gather(list(recv.unbind(0)), send, group=pm.group)
    recv = _from_wire(pm, recv)
    ax = axis % x.dim()
    out = recv.movedim(0, ax).flatten(ax, ax + 1)
    return back(out.contiguous())


def gather(x, pm, dst=0, axis=0):
    """The blocks of every rank concatenated along ``axis`` on rank
    ``dst`` (None on the others)."""
    P = pm.size
    if P == 1:
        return x
    w, back = _wire(x)
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
    its (re, im) pairs, so only by 'sum')."""
    if op not in _OPS:
        raise ValueError("op must be 'sum', 'max' or 'min' (got %r)" % (op,))
    out = x.clone()
    if pm.size > 1:
        if out.is_complex() and op != 'sum':
            raise ValueError("a complex tensor reduces by 'sum' only")
        w = torch.view_as_real(out) if out.is_complex() else out
        dist.all_reduce(w, op=_OPS[op], group=pm.group)
    return out


def all_to_all_v(x, pm, counts):
    """The rows of ``x``, grouped by destination rank (``counts[j]`` rows
    for rank j, in rank order), sent to their ranks: returns the rows
    received, grouped by source rank, and the count from each source (a
    list).  The counts travel first, in one all_to_all of P integers."""
    P = pm.size
    counts = [int(c) for c in counts]
    if len(counts) != P or sum(counts) != x.shape[0]:
        raise ValueError("all_to_all_v: %d counts summing to %d for %d rows "
                         "on %d ranks" % (len(counts), sum(counts),
                                          x.shape[0], P))
    if P == 1:
        return x, counts
    sc = _empty_wire(pm, (P,), torch.int64)
    sc.copy_(torch.tensor(counts, dtype=torch.int64))
    rc = torch.empty_like(sc)
    dist.all_to_all_single(rc, sc, group=pm.group)
    recv_counts = [int(c) for c in rc.cpu()]
    w, back = _wire(x)
    send = _to_wire(pm, w)
    recv = _empty_wire(pm, (sum(recv_counts),) + tuple(send.shape[1:]),
                       send.dtype)
    dist.all_to_all_single(recv, send, output_split_sizes=recv_counts,
                           input_split_sizes=counts, group=pm.group)
    return back(_from_wire(pm, recv)), recv_counts


def _p2p(blocks, pm):
    """send each ``(tensor, dst, src)`` of ``blocks`` to the group rank
    ``dst`` and receive a tensor of its shape and dtype from ``src``, in
    one ``batch_isend_irecv``; a block whose dst is this rank is kept"""
    out = [None] * len(blocks)
    ops, recvs = [], []
    for n, (t, dst, src) in enumerate(blocks):
        if dst == pm.rank:
            out[n] = t
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
