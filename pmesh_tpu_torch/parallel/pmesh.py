"""ProcessMesh: a 1-d slab grid over a torch.distributed process group.

Counterpart of ``pmesh_tpu/parallel/pmesh.py``.  The JAX package holds
global arrays with NamedShardings and drops into shard_map; this port
holds **rank-local slabs**, one process per rank with explicit
collectives (``parallel/comm.py``):

- rank r owns x rows ``[r * N0 / P, (r + 1) * N0 / P)`` of every real
  mesh (the JAX package's ``real_spec``, P('x', None, None));
- rank r owns y-chunk r, ``[r * N1 / P, (r + 1) * N1 / P)``, of every
  transposed spectrum, whose x axis is whole (``transposed_spec``,
  P(None, 'x', None)).

A mesh of one rank needs no process group: without an initialized
torch.distributed it is the single rank 0.  The 2-d pencil grid of the
JAX package (``shape=(npx, npy)``) is not ported.
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


class ProcessMesh(object):
    """A slab (1-d) decomposition over a torch.distributed process group.

    Parameters
    ----------
    group : process group, or None for the default (WORLD) group; with
        torch.distributed not initialized, the mesh is one rank.
    axis : str
        the mesh axis name, default 'x' (kept for the JAX package's API).
    shape : must be None: the 2-d (npx, npy) pencil grid is not ported.
    device : torch device of this rank's slabs; default
        cuda:<local rank % device count> (raises without CUDA: pass
        'cpu').

    ``backend`` is the group's backend ('nccl', 'gloo', or None for one
    rank without a group).  Under gloo, CUDA tensors are staged through
    host buffers for every collective but ``all_reduce``
    (``parallel/comm.py``); the rule is fixed here, when the mesh is
    built.
    """

    def __init__(self, group=None, axis='x', shape=None, device=None):
        if shape is not None:
            raise NotImplementedError(
                "2-d (npx, npy) pencil process grids are not ported yet "
                "(ROADMAP queue 1, item 8a); use the 1-d slab grid")
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
        self.axis = axis
        self.grid = (self.size,)
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

    def _key(self):
        return (self.ranks, self.axis, self.grid, str(self.device))

    def __eq__(self, other):
        return isinstance(other, ProcessMesh) and self._key() == other._key()

    def __hash__(self):
        return hash(self._key())

    def __repr__(self):
        return ("ProcessMesh(rank %d of %d, backend %s, device %s)"
                % (self.rank, self.size, self.backend, self.device))

    def slab(self, n):
        """(start, stop) of this rank's block of an axis of length n;
        raises unless the ranks divide n"""
        if n % self.size:
            raise NotImplementedError(
                "an axis of length %d does not split into %d equal slabs; "
                "uneven meshes are not ported yet (ROADMAP queue 1, item 8a)"
                % (n, self.size))
        rows = n // self.size
        return self.rank * rows, (self.rank + 1) * rows
