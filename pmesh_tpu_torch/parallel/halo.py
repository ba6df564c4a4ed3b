"""Mesh halo exchange for slab-sharded fields.

Counterpart of ``pmesh_tpu/parallel/halo.py``.  The lattice fast paths
(``ops/gridpm.py``, ``ops/binned.py``) express their x-axis window
through *extended* slabs: row j of an extension holds global plane
(my_start - lo + j).  On one rank the extension is a wrap; on several
the extra planes live on ring neighbours and come over
``comm.ring_exchange`` (the JAX package's ``lax.ppermute``).

Both functions are differentiable through the exchange's transpose:
each halo plane's cotangent travels back to the rank that owns the
plane (over as many hops as it came) and is added to that plane's
gradient there.
"""
import torch

from .comm import ring_exchange

__all__ = ["halo_planes", "extend_x"]


def halo_planes(local, lo, hi, pm):
    """The halo planes alone: (lo_arr, hi_arr) of (lo, ...) and
    (hi, ...) rows, lo_arr[j] holding global plane (my_start - lo + j)
    and hi_arr[j] plane (my_start + rows + j).  Halos up to one slab
    deep (use :func:`extend_x` beyond)."""
    rows = local.shape[0]
    if lo > rows or hi > rows:
        raise ValueError("halo_planes supports halos up to one slab "
                         "(lo=%d hi=%d rows=%d)" % (lo, hi, rows))
    tail, head = local[rows - lo:], local[:hi]
    if pm.size == 1:
        return tail.clone(), head.clone()
    blocks = []
    if lo > 0:
        # my tail planes go to my +1 neighbour's lo halo
        blocks.append((tail, 1))
    if hi > 0:
        blocks.append((head, -1))
    got = ring_exchange(blocks, pm)
    lo_arr = got.pop(0) if lo > 0 else tail
    hi_arr = got.pop(0) if hi > 0 else head
    return lo_arr, hi_arr


def extend_x(local, lo, hi, pm):
    """``local`` (rows, ...) extended by ``lo`` halo planes below and
    ``hi`` above, fetched from ring neighbours: a (lo + rows + hi, ...)
    tensor whose row j holds global plane (my_start - lo + j), with the
    periodic wrap implied by the ring.  Any depth: a halo deeper than
    one slab takes whole slabs from further ranks (several hops)."""
    rows = local.shape[0]
    if lo == 0 and hi == 0:
        return local
    if lo <= rows and hi <= rows:
        lo_arr, hi_arr = halo_planes(local, lo, hi, pm)
        return torch.cat([lo_arr, local, hi_arr], 0)
    # multi-hop: slab b - m arrives at b for the lower side, b + m for
    # the upper, m = 1, 2, ... until the depth is covered
    blocks, takes = [], []
    need, m = lo, 1
    while need > 0:
        take = min(rows, need)
        blocks.append((local, m))
        takes.append(('lo', take))
        need -= take
        m += 1
    need, m = hi, 1
    while need > 0:
        take = min(rows, need)
        blocks.append((local, -m))
        takes.append(('hi', take))
        need -= take
        m += 1
    got = ring_exchange(blocks, pm)
    left, right = [], []
    for (side, take), t in zip(takes, got):
        if side == 'lo':
            left.append(t[rows - take:])
        else:
            right.append(t[:take])
    left.reverse()
    return torch.cat(left + [local] + right, 0)
