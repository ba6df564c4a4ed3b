"""ProcessMesh: a 1-d slab grid or a 2-d (npx, npy) pencil grid over a
torch.distributed process group.

Counterpart of ``pmesh_tpu/parallel/pmesh.py``.  The JAX package holds
global arrays with NamedShardings and drops into shard_map; this port
holds **rank-local blocks**, one process per rank with explicit
collectives (``parallel/comm.py``).

The 1-d grid (``shape=None``) is a ring of P ranks.  The 2-d grid
(``shape=(npx, npy)``, the reference's pfft pencil grid) puts rank r at
grid coordinates ``(r // npy, r % npy)``, as jax linearizes an
('x', 'y') device mesh; its ranks along each grid axis form a process
group of their own (:meth:`ProcessMesh.along`), over which the pencil
transforms run their all_to_alls.  Building a 2-d grid is a collective:
every process of the default group builds it, in the same order.

Blocks of an axis of length n over the m ranks of a grid axis
(:meth:`ProcessMesh.block`): the rank at coordinate b owns
``[b c, min((b + 1) c, n))`` with ``c = ceil(n / m)``, possibly empty.
That is the JAX package's padded uneven slab (``_slab_rows``, the dead
seam slabs of ``parallel/exchange.py``); where m divides n it is the
even block n / m.  ``pm.py`` says which block of which axis a field
holds on each geometry.

A mesh of one rank needs no process group: without an initialized
torch.distributed it is the single rank 0.
"""
import os

import torch
import torch.distributed as dist

__all__ = ["ProcessMesh"]


def _default_device(rank):
    """cuda:<local rank % device count>; raises without CUDA"""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: a ProcessMesh places its rank on the GPU by "
            "default; pass device='cpu' to run on the CPU")
    local = int(os.environ.get("LOCAL_RANK", rank))
    return torch.device('cuda', local % torch.cuda.device_count())


def block_of(n, m, b, chunk=None):
    """(start, stop) of block b of an axis of length n split over m ranks
    in chunks of ``chunk`` (default ceil(n / m)); empty past the end"""
    c = -(-int(n) // int(m)) if chunk is None else int(chunk)
    return min(b * c, int(n)), min((b + 1) * c, int(n))


class GridAxis(object):
    """The ranks of one axis of a 2-d grid that share this rank's other
    coordinate: a process group of ``size`` ranks in which this rank is
    ``rank``, the collectives' view of a ProcessMesh (``parallel/comm``
    reads ``size``, ``rank``, ``ranks``, ``group``, ``staged`` and
    ``device``)."""

    def __init__(self, group, ranks, rank, staged, device):
        self.group = group
        self.ranks = tuple(ranks)
        self.size = len(self.ranks)
        self.rank = rank
        self.staged = staged
        self.device = device


class ProcessMesh(object):
    """A slab (1-d) or pencil (2-d) decomposition over a
    torch.distributed process group.

    Parameters
    ----------
    group : process group, or None for the default (WORLD) group; with
        torch.distributed not initialized, the mesh is one rank.
    axis : str
        the first axis name, default 'x' (kept for the JAX package's API).
    shape : None for the 1-d grid over every rank, or (npx, npy) with
        npx * npy ranks for the 2-d pencil grid.
    device : torch device of this rank's blocks; default
        cuda:<local rank % device count> (raises without CUDA: pass
        'cpu').
    axes : the two axis names of the 2-d grid.

    ``backend`` is the group's backend ('nccl', 'gloo', or None for one
    rank without a group).  Under gloo, CUDA tensors are staged through
    host buffers for every collective but ``all_reduce``
    (``parallel/comm.py``); the rule is fixed here, when the mesh is
    built.
    """

    def __init__(self, group=None, axis='x', shape=None, device=None,
                 axes=('x', 'y')):
        self.group = group
        if dist.is_available() and dist.is_initialized():
            self.size = dist.get_world_size(group)
            self.rank = dist.get_rank(group)
            self.backend = str(dist.get_backend(group))
            self.ranks = tuple(dist.get_process_group_ranks(group)
                               if group is not None
                               else range(self.size))
        else:
            if group is not None:
                raise ValueError("a process group was given but "
                                 "torch.distributed is not initialized")
            self.size, self.rank, self.backend = 1, 0, None
            self.ranks = (0,)
        if shape is None:
            self.axis = axis
            self.axes = (axis,)
            self.grid = (self.size,)
            self.coords = (self.rank,)
        else:
            shape = tuple(int(s) for s in shape)
            if len(shape) != 2 or shape[0] * shape[1] != self.size:
                raise ValueError(
                    "shape must be (npx, npy) with npx*npy == the number of "
                    "ranks; got %r for %d ranks" % (shape, self.size))
            self.axes = tuple(axes)
            self.axis = self.axes[0]
            self.grid = shape
            self.coords = divmod(self.rank, shape[1])
        if device is None:
            device = _default_device(self.rank)
        device = torch.device(device)
        if device.type == 'cuda' and device.index is None:
            device = torch.device('cuda', torch.cuda.current_device())
        self.device = device
        # gloo carries CUDA tensors only through broadcast and all_reduce
        self.staged = self.backend == 'gloo' and device.type == 'cuda'
        if self.backend == 'nccl' and device.type != 'cuda':
            raise ValueError("the NCCL backend needs CUDA devices")
        self._along = self._axis_groups() if self.is2d else (self,)

    def _axis_groups(self):
        """the GridAxis of each grid axis; every rank makes every group,
        in the same order (new_group is collective over WORLD)"""
        npx, npy = self.grid
        bx, by = self.coords
        flat = [[self.ranks[x * npy + y] for y in range(npy)]
                for x in range(npx)]
        mine = [None, None]
        # axis 0: the ranks of one column (fixed y, x = 0 .. npx - 1);
        # axis 1: those of one row (fixed x)
        for a, lines in ((0, [[flat[x][y] for x in range(npx)]
                               for y in range(npy)]),
                         (1, flat)):
            for line in lines:
                g = dist.new_group(ranks=line) if len(line) > 1 else None
                if self.ranks[self.rank] in line:
                    mine[a] = GridAxis(g, line, self.coords[a], self.staged,
                                       self.device)
        return tuple(mine)

    @property
    def is2d(self):
        return len(self.grid) == 2

    @property
    def shape(self):
        return self.grid

    def along(self, a):
        """the collectives' view of grid axis ``a``: on the 1-d grid the
        mesh itself, on the 2-d grid the :class:`GridAxis` of the ranks
        that share this rank's other coordinate"""
        return self._along[a]

    def block(self, n, a=0, chunk=None):
        """(start, stop) of this rank's block of an axis of length n split
        over grid axis ``a`` (see the module docstring)"""
        return block_of(n, self.grid[a], self.coords[a], chunk)

    def slab(self, n):
        """(start, stop) of this rank's block of an axis of length n over
        the 1-d grid: ``[r c, min((r + 1) c, n))``, c = ceil(n / P)"""
        if self.is2d:
            raise ValueError("slab() is the 1-d grid's block; use block()")
        return self.block(n)

    def _key(self):
        return (self.ranks, self.axes, self.grid, str(self.device))

    def __eq__(self, other):
        return isinstance(other, ProcessMesh) and self._key() == other._key()

    def __hash__(self):
        return hash(self._key())

    def __repr__(self):
        grid = "x".join(str(s) for s in self.grid)
        return ("ProcessMesh(rank %d of %d, grid %s, backend %s, device %s)"
                % (self.rank, self.size, grid, self.backend, self.device))
