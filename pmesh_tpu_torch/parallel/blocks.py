"""Moving a global array between block layouts over the ranks.

The field API on a sharded mesh (``pm.py``) holds every field as one
box-shaped block per rank (``ParticleMesh.local_block``); a box is a
tuple of per-axis ``(start, stop)`` in global indices.  These functions
move a global array between two such layouts, or between a box layout
and the blocks of its C-ordered flat array (rank b holds
``[b nl, min((b + 1) nl, n))``, nl = ceil(n / P), as every particle
array is held).  Each moves its data with one ``comm.all_to_all_v``, so
it is exact and differentiable as that is (its backward sends the
cotangents back).  Every rank calls each function with the same
geometry; the layouts are pure functions of it.
"""
import numpy as np
import torch

from .comm import all_to_all_v

__all__ = ["redistribute", "flat_block", "aligned", "ravel", "unravel"]


def _meet(a, b):
    """the intersection of two boxes, or None where it is empty"""
    box = tuple((max(a0, b0), min(a1, b1)) for (a0, a1), (b0, b1)
                in zip(a, b))
    return box if all(lo < hi for lo, hi in box) else None


def _slices(box, origin):
    return tuple(slice(lo - o, hi - o) for (lo, hi), o in zip(box, origin))


def redistribute(value, pm, src, dst, perm=None):
    """This rank's block of a global array in the layout ``dst``, from
    ``value``, this rank's block in the layout ``src``.

    src, dst : one box per rank of ``pm`` (the same box on every rank
        where each holds the whole array); the boxes of ``dst`` are in
        the coordinates of the output, which is the input with its axes
        permuted by ``perm`` (output axis k is input axis perm[k]; None:
        no permutation).
    """
    ndim = value.dim()
    perm = list(range(ndim)) if perm is None else [int(a) for a in perm]
    inv = [perm.index(a) for a in range(ndim)]
    me = pm.rank
    mine = src[me]
    out_box = dst[me]
    out_shape = tuple(hi - lo for lo, hi in out_box)

    def in_src(box):
        # a box of the output in the input's coordinates
        return tuple(box[inv[a]] for a in range(ndim))

    pieces, counts = [], []
    for r in range(pm.size):
        cut = _meet(mine, in_src(dst[r]))
        if cut is None:
            counts.append(0)
            continue
        piece = value[_slices(cut, [lo for lo, _ in mine])].permute(perm)
        pieces.append(piece.reshape(-1))
        counts.append(pieces[-1].numel())
    send = torch.cat(pieces) if pieces else value.new_zeros((0,))
    recv, got = all_to_all_v(send, pm, counts)
    out = value.new_zeros(out_shape)
    want = in_src(out_box)
    at = 0
    for s in range(pm.size):
        cut = _meet(src[s], want)
        if cut is None:
            continue
        box = tuple(cut[perm[k]] for k in range(ndim))
        n = int(np.prod([hi - lo for lo, hi in box]))
        out[_slices(box, [lo for lo, _ in out_box])] = recv[at:at + n] \
            .reshape([hi - lo for lo, hi in box])
        at += n
    assert at == sum(got)
    return out


def flat_block(n, P, b):
    """(start, stop) of block b of a flat array of n items over P ranks:
    ``[b nl, min((b + 1) nl, n))``, nl = ceil(n / P)"""
    nl = -(-int(n) // int(P))
    return min(b * nl, n), min((b + 1) * nl, n)


def _flat_index(box, shape, device):
    """the C-order global flat index of every point of ``box`` (in the
    box's own C order: ascending)"""
    g = torch.zeros((), dtype=torch.int64, device=device)
    for (lo, hi), n in zip(box, shape):
        g = g.unsqueeze(-1) * int(n) + torch.arange(lo, hi, device=device)
    return g.reshape(-1)


def _owners(lo, hi, shape, owner, device):
    """the rank that holds each point of the flat range [lo, hi) of an
    array of ``shape``: ``owner(index)``, index the per-axis indices"""
    flat = torch.arange(lo, hi, device=device)
    index = []
    for n in reversed(shape):
        index.append(torch.remainder(flat, int(n)))
        flat = torch.div(flat, int(n), rounding_mode='floor')
    return owner(index[::-1])


def aligned(boxes, shape):
    """whether each rank's box is its block of the flat array already (an
    even slab: whole planes, as many points as the flat block), so that
    ravel and unravel move nothing"""
    n, P = int(np.prod(shape)), len(boxes)
    plane = int(np.prod(shape[1:]))
    return all(tuple(box[1:]) == tuple((0, int(m)) for m in shape[1:])
               and (box[0][0] * plane, box[0][1] * plane)
               == flat_block(n, P, r) for r, box in enumerate(boxes))


def ravel(value, pm, box, shape, owner):
    """This rank's block of the C-ordered flat array of a global array of
    ``shape`` (:func:`flat_block`), from ``value``, its block ``box``.

    ``owner(index)`` gives, for per-axis index tensors, the rank whose
    box holds each point.  A box is a run of C order whose flat indices
    ascend, so each rank's points go out in order; the receiver puts the
    runs of each source into place.  (Where the boxes are
    :func:`aligned`, the caller reshapes instead.)"""
    n, P = int(np.prod(shape)), pm.size
    nl = -(-n // P)
    g = _flat_index(box, shape, value.device)
    counts = torch.bincount(torch.div(g, nl, rounding_mode='floor'),
                            minlength=P).tolist() if g.numel() else [0] * P
    recv, _ = all_to_all_v(value.reshape(-1), pm, counts)
    lo, hi = flat_block(n, P, pm.rank)
    src = _owners(lo, hi, shape, owner, value.device)
    order = torch.argsort(src, stable=True)
    # recv holds the points of the range grouped by source rank, in
    # ascending flat index within each: the range sorted by owner
    return recv[torch.argsort(order)]


def unravel(flat, pm, box, shape, owner):
    """The inverse of :func:`ravel`: this rank's block ``box`` of the
    global array of ``shape`` whose C-ordered flat array's block this
    rank holds in ``flat``."""
    n, P = int(np.prod(shape)), pm.size
    lo, hi = flat_block(n, P, pm.rank)
    if flat.shape[0] != hi - lo:
        raise ValueError("unravel: this rank holds %d items of the flat "
                         "array, not %d" % (hi - lo, flat.shape[0]))
    dst = _owners(lo, hi, shape, owner, flat.device)
    order = torch.argsort(dst, stable=True)
    counts = torch.bincount(dst, minlength=P).tolist() if dst.numel() \
        else [0] * P
    recv, _ = all_to_all_v(flat[order], pm, counts)
    # each source's points of this box arrive in ascending flat index,
    # the sources in rank order: the box's own C order
    return recv.reshape([b - a for a, b in box])
