"""CoArray: one-sided access to the blocks of the ranks (experimental).

Counterpart of ``pmesh_tpu/parallel/coarray.py``, the parity shim of
the reference's pmesh/coarray.py, which its own docstring calls a
failed experiment in one-sided MPI-style messaging and which nothing in
the library uses.  Here each rank holds its block; "fetch rank r's
block" is an ``all_gather`` and an index, so every access is a
collective that all ranks make together.  Nothing in the port uses it.

Usage::

    ca = CoArray(local_block, procmesh)   # this rank's block
    blk = ca[r]          # rank r's block (numpy, on every rank)
    ca2 = ca.map(fn)     # fn applied to each rank's block, where it lies
"""
import numpy as np
import torch

from .comm import all_gather

__all__ = ["CoArray"]


class CoArray(object):
    """This rank's block of an array laid out in equal blocks over the
    ranks of ``procmesh`` along axis 0."""

    def __init__(self, value, procmesh):
        value = torch.as_tensor(value, device=procmesh.device)
        self.procmesh = procmesh
        sizes = all_gather(torch.tensor([value.shape[0]],
                                        device=procmesh.device), procmesh)
        if len(set(int(s) for s in sizes.cpu())) != 1:
            raise ValueError("the blocks must be of one length (got %s)"
                             % sizes.cpu().tolist())
        self.value = value

    @property
    def blocksize(self):
        return self.value.shape[0]

    def __len__(self):
        return self.procmesh.size

    def __getitem__(self, rank):
        """Rank ``rank``'s block, to the host (a collective)."""
        rank = int(rank)
        b = self.blocksize
        return self.allgather()[rank * b:(rank + 1) * b]

    def map(self, fn):
        """A new CoArray of ``fn`` of each rank's block, computed where
        the block lies."""
        return CoArray(fn(self.value), self.procmesh)

    def allgather(self):
        """The whole array on the host (a collective)."""
        return np.asarray(all_gather(self.value, self.procmesh).cpu())
