"""Domain decomposition and the Layout routing plan, built on the host.

Counterpart of ``pmesh_tpu/parallel/domain.py``, on one process and on
tensors, as the JAX package's works on global arrays:

- :class:`FakeComm`: the single-process stand-in for an MPI
  communicator (collective scalars are identities);
- :class:`GridND`: the N-d grid of cubinoid domains, ``DomainAssign``
  mapping domains onto ranks, degenerate-domain masking, the load
  measurement and the greedy load balance;
- :meth:`GridND.decompose`: for every particle, the domains its
  smoothing ball intersects (with the periodic wrap), mapped through
  DomainAssign with repeated ranks deduplicated: a :class:`Layout`;
- :class:`Layout`: the exact routing plan.  ``exchange`` gathers the
  ghost images grouped by destination rank (the reference's packed
  Alltoallv receive buffer, viewed globally); ``gather`` reduces them
  back to their particles by sum, mean, any, all, local or a numpy
  ufunc.  A Layout built with no plan is the trivial single-domain one
  (``ParticleMesh.decompose`` on one device), whose exchange and gather
  are identities.

The plan is host-built (numpy) from concrete positions; ``exchange``
and ``gather`` are torch gathers and scatter-adds over it, on the
data's device, and differentiate under autograd.  The slab-sharded
ghost plan over torch.distributed ranks is ``parallel/exchange.py``.
"""
import heapq
import itertools

import numpy as np
import torch

__all__ = ["Layout", "GridND", "FakeComm"]


class FakeComm(object):
    """Single-process stand-in for an MPI communicator: collective
    scalars are identities."""
    rank = 0
    size = 1

    def allreduce(self, value, op=None):
        return value

    def allgather(self, value):
        return [value]

    def bcast(self, value, root=0):
        return value

    def barrier(self):
        pass

    Barrier = barrier

    def Allreduce(self, sendbuf, recvbuf=None, op=None):
        return sendbuf


def _host(x):
    """a numpy view of a tensor or array-like"""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class Layout(object):
    """Routing plan of a domain decomposition (the reference's
    ``pmesh.domain.Layout``).  Image j is a copy of source particle
    ``indices[j]`` delivered to rank ``ranks[j]`` (non-decreasing).
    Without ``indices`` the plan is trivial: one image per particle.

    Build it with :meth:`GridND.decompose` or
    ``ParticleMesh.decompose``."""

    def __init__(self, npart, nranks=1, counts=None, indices=None,
                 ranks=None, smoothing=0, comm=None):
        self.comm = comm if comm is not None else FakeComm()
        self.smoothing = smoothing
        self.npart = int(npart)
        if indices is None:
            counts, ranks, nranks = [self.npart], None, 1
        self.nranks = nranks
        self.sendcounts = np.asarray(
            counts if counts is not None else [self.npart], dtype='i8')
        self.indices = None if indices is None else np.asarray(indices,
                                                                'i8')
        self.ranks = ranks
        self.sendlength = self.npart
        self.recvlength = (self.npart if indices is None
                           else len(self.indices))
        self.recvcounts = self.sendcounts
        self.offsets = np.concatenate([[0], np.cumsum(self.sendcounts)])
        self._primary_mask = None

    @property
    def trivial(self):
        return self.indices is None

    def _index(self, device):
        return torch.from_numpy(self.indices).to(device)

    def exchange(self, *args):
        """Deliver data to the intersecting domains: per argument, its
        images grouped by destination rank (the argument itself for a
        trivial plan); one argument returns one tensor."""
        if not args:
            return None
        if not self.trivial:
            args = tuple(torch.as_tensor(a).index_select(
                0, self._index(torch.as_tensor(a).device)) for a in args)
        return args[0] if len(args) == 1 else tuple(args)

    def exchange_scalar(self, value):
        """scalars skip the exchange"""
        return value

    def gather(self, data, mode='sum', out=None):
        """Reduce images back to their particles.  Modes: 'sum', 'mean',
        'any' (the last image of each particle), 'all' (the images
        unreduced), 'local' (the image on the particle's primary, lowest
        rank) or a numpy ufunc (reduced on the host, ``reduceat``)."""
        if self.trivial:
            if mode in ('sum', 'any', 'mean', 'all', 'local') \
                    or isinstance(mode, np.ufunc):
                return data
            raise NotImplementedError(mode)
        if mode == 'all':
            return data
        data = torch.as_tensor(data)
        if data.shape[0] != self.recvlength:
            raise ValueError(
                "gather expects data of the exchange result length %d, "
                "got %d" % (self.recvlength, data.shape[0]))
        idx = self._index(data.device)
        shape = (self.sendlength,) + tuple(data.shape[1:])
        if mode in ('sum', 'mean'):
            s = data.new_zeros(shape).index_add(0, idx, data)
            if mode == 'sum':
                return s
            n = np.bincount(self.indices, minlength=self.sendlength)
            n = torch.from_numpy(n.reshape((-1,) + (1,) * (data.dim() - 1)))
            return s / n.to(device=data.device, dtype=data.dtype)
        if mode == 'any':
            # the last image of each particle, as a scatter in image order
            last = np.full(self.sendlength, -1, dtype='i8')
            last[self.indices] = np.arange(self.recvlength)
            has = np.nonzero(last >= 0)[0]
            out = data.new_zeros(shape)
            out[torch.from_numpy(has).to(data.device)] = data[
                torch.from_numpy(last[has]).to(data.device)]
            return out
        if mode == 'local':
            sel = np.nonzero(self._primary_image_mask())[0]
            out = data.new_zeros(shape)
            out[torch.from_numpy(self.indices[sel]).to(data.device)] = data[
                torch.from_numpy(sel).to(data.device)]
            return out
        if isinstance(mode, np.ufunc):
            # the host reduction of the reference (reduceat over the
            # images sorted by particle)
            order = np.argsort(self.indices, kind='stable')
            n = np.bincount(self.indices, minlength=self.sendlength)
            off = np.zeros(self.sendlength, dtype='intp')
            off[1:] = np.cumsum(n)[:-1]
            red = mode.reduceat(_host(data)[order], off)
            return torch.from_numpy(np.ascontiguousarray(red)).to(
                data.device)
        raise NotImplementedError(mode)

    def _primary_image_mask(self):
        """the first image (lowest rank) of each particle"""
        if self._primary_mask is None:
            mask = np.zeros(self.recvlength, dtype='?')
            order = np.argsort(self.indices, kind='stable')
            firsts = order[np.unique(self.indices[order],
                                     return_index=True)[1]]
            mask[firsts] = True
            self._primary_mask = mask
        return self._primary_mask

    def get_exchange_cost(self):
        """Per-rank count of items sent to another rank; all data
        originates on rank 0 of the single process."""
        cost = np.array(self.sendcounts, dtype='i8', copy=True)
        if len(cost) > 0:
            cost[0] = 0
        return cost


class GridND(object):
    """Domain decomposition on a uniform N-d grid of cubinoids
    (reference domain.py:320-652).  ``DomainAssign`` maps each of
    ``prod(shape)`` domains onto one of ``comm.size`` logical ranks;
    :meth:`loadbalance` rewrites it from measured loads and
    :meth:`decompose` consumes it."""

    def __init__(self, edges, comm=None, periodic=True, DomainAssign=None):
        self.edges = [np.asarray(g, dtype='f8') for g in edges]
        self.shape = np.array([len(g) - 1 for g in edges], dtype='int32')
        self.ndim = len(self.shape)
        self.periodic = periodic
        self.size = int(np.prod(self.shape))
        self.comm = comm if comm is not None else FakeComm()
        if DomainAssign is None:
            if self.comm.size >= self.size:
                DomainAssign = np.arange(self.size, dtype='int32')
            else:
                DomainAssign = np.empty(self.size, dtype='int32')
                for i in range(self.comm.size):
                    start = i * self.size // self.comm.size
                    end = (i + 1) * self.size // self.comm.size
                    DomainAssign[start:end] = i
        self.DomainAssign = np.asarray(DomainAssign, dtype='int32')
        # a degenerate domain has an empty edge along some axis and
        # receives no particles
        dd = np.zeros(tuple(self.shape), dtype='?')
        for i, edge in enumerate(self.edges):
            d1 = edge[1:] == edge[:-1]
            dd |= d1.reshape([-1 if ii == i else 1
                              for ii in range(self.ndim)])
        self.DomainDegenerate = dd.ravel()
        self._update_primary_regions()

    @classmethod
    def uniform(cls, BoxSize, comm=None, periodic=True):
        """A near-cubical domain grid for ``comm.size`` ranks."""
        comm = comm if comm is not None else FakeComm()
        ndim = len(BoxSize)
        r = (1.0 * comm.size / np.prod(BoxSize) * min(BoxSize)) \
            ** (1.0 / ndim)
        shape = np.array([r * (BoxSize[i] / min(BoxSize))
                          for i in range(ndim)])
        imax = shape.argmax()
        shape = np.int32(shape)
        shape[shape < 1] = 1
        shape[imax] = 1
        shape[imax] = comm.size // np.prod(shape)
        edges = [np.linspace(0, BoxSize[i], shape[i] + 1, endpoint=True)
                 for i in range(ndim)]
        return cls(edges, comm, periodic)

    def _transformed(self, pos, transform):
        pos = _host(pos)
        if transform is not None:
            pos = _host(transform(pos))
        return pos[..., :self.ndim]

    def _sil_sir(self, pos, smoothing, transform):
        """per-axis domain patch [sil, sir) of every particle"""
        chunk = self._transformed(pos, transform)
        n = len(chunk)
        sil = np.empty((self.ndim, n), dtype='i8')
        sir = np.empty((self.ndim, n), dtype='i8')
        sm = np.empty(self.ndim, dtype='f8')
        sm[:] = smoothing
        for j in range(self.ndim):
            tmp = chunk[:, j]
            if self.periodic:
                boxsize = self.edges[j][-1]
                c = np.remainder(tmp, boxsize)
                l = np.digitize((c - sm[j]) % boxsize, self.edges[j])
                r = np.digitize((c + sm[j]) % boxsize, self.edges[j])
                p = np.digitize(c, self.edges[j])
                sil[j] = p - (p - l) % self.shape[j] - 1
                sir[j] = p + (r - p) % self.shape[j]
            else:
                l = np.digitize(tmp - sm[j], self.edges[j])
                r = np.digitize(tmp + sm[j], self.edges[j])
                sil[j] = np.clip(l - 1, 0, self.shape[j])
                sir[j] = np.clip(r, 0, self.shape[j])
        return sil, sir

    def decompose(self, pos, smoothing=0, transform=None):
        """The exact :class:`Layout` of these positions (a tensor or an
        array; read on the host)."""
        pos = _host(pos)
        npart = len(pos)
        nranks = self.comm.size
        if npart == 0:
            return Layout(npart=0, nranks=nranks,
                          counts=np.zeros(nranks, dtype='i8'),
                          indices=np.empty(0, dtype='i8'),
                          ranks=np.empty(0, dtype='i8'),
                          smoothing=smoothing, comm=self.comm)
        sil, sir = self._sil_sir(pos, smoothing, transform)
        # every patch offset up to the largest patch extent per axis,
        # masked beyond each particle's own [sil, sir)
        extents = [int(np.max(sir[j] - sil[j])) for j in range(self.ndim)]
        strides = np.ones(self.ndim, dtype='i8')
        for j in range(self.ndim - 2, -1, -1):
            strides[j] = strides[j + 1] * self.shape[j + 1]
        parts, ranks = [], []
        for offs in itertools.product(*[range(max(e, 0)) for e in extents]):
            valid = np.ones(npart, dtype='?')
            target = np.zeros(npart, dtype='i8')
            for j in range(self.ndim):
                t = sil[j] + offs[j]
                valid &= t < sir[j]
                if self.periodic:
                    t = np.remainder(t, self.shape[j])
                target += t * strides[j]
            target = np.where(valid, target, 0)
            valid &= ~self.DomainDegenerate[target]
            sel = np.nonzero(valid)[0]
            parts.append(sel)
            ranks.append(self.DomainAssign[target][sel])
        part = np.concatenate(parts) if parts else np.empty(0, 'i8')
        rank = np.concatenate(ranks) if ranks else np.empty(0, 'i8')
        # one copy per (particle, rank): a patch over two domains of one
        # rank ships once
        key = np.unique(part * np.int64(nranks) + rank)
        part, rank = key // nranks, key % nranks
        # grouped by destination rank, source order within each
        order = np.lexsort((part, rank))
        part, rank = part[order], rank[order]
        return Layout(npart=npart, nranks=nranks,
                      counts=np.bincount(rank, minlength=nranks),
                      indices=part, ranks=rank, smoothing=smoothing,
                      comm=self.comm)

    def _domain_of(self, pos, transform):
        chunk = self._transformed(pos, transform)
        sil = np.empty((self.ndim, len(chunk)), dtype='i8')
        for j in range(self.ndim):
            t = chunk[:, j]
            if self.periodic:
                t = np.remainder(t, self.edges[j][-1])
            sil[j] = np.digitize(t, self.edges[j]) - 1
        mode = 'raise' if self.periodic else 'clip'
        return np.ravel_multi_index(sil, tuple(self.shape), mode=mode)

    def load(self, pos, transform=None, gamma=2):
        """Per-domain cost: the particle count to the power ``gamma``."""
        if len(pos) == 0:
            return np.zeros(self.size)
        counts = np.bincount(self._domain_of(pos, transform),
                             minlength=self.size)
        return counts.astype('f8') ** gamma

    def loadbalance(self, domainload):
        """Greedy heap bin-packing of the domains onto the ranks;
        rewrites DomainAssign and the primary regions."""
        if self.size <= self.comm.size:
            return
        domains = sorted([(domainload[i], i) for i in range(self.size)],
                         reverse=True)
        processes = [(0, i) for i in range(self.comm.size)]
        heapq.heapify(processes)
        for dload, dindex in domains:
            pload, rank = heapq.heappop(processes)
            self.DomainAssign[dindex] = rank
            heapq.heappush(processes, (pload + dload, rank))
        self._update_primary_regions()

    def _update_primary_regions(self):
        """per rank, the (start, end) boxes of its domains"""
        regions = []
        for r in range(self.comm.size):
            my = np.nonzero(self.DomainAssign == r)[0]
            if len(my) == 0:
                regions.append(None)
                continue
            start = np.empty((len(my), self.ndim))
            end = np.empty((len(my), self.ndim))
            for i, dom in enumerate(my):
                di = np.unravel_index(dom, tuple(self.shape))
                start[i] = [g[k] for g, k in zip(self.edges, di)]
                end[i] = [g[k + 1] for g, k in zip(self.edges, di)]
            regions.append({'start': start, 'end': end})
        self.primary_regions = regions
        self.primary_region = regions[self.comm.rank]

    def isprimary(self, pos, transform=None, rank=None):
        """True where pos falls in ``rank``'s primary region (a numpy
        bool array)."""
        if rank is None:
            rank = self.comm.rank
        region = self.primary_regions[rank]
        if region is None:
            return np.zeros(len(pos), dtype='?')
        chunk = self._transformed(pos, transform)
        if self.periodic:
            chunk = np.remainder(chunk, np.array(
                [self.edges[j][-1] for j in range(self.ndim)]))
        r = np.zeros(len(chunk), dtype='?')
        for j in range(len(region['start'])):
            r |= ((chunk >= region['start'][j])
                  & (chunk < region['end'][j])).all(axis=-1)
        return r

    def which_rank(self, pos, transform=None):
        """The rank owning each position's home domain."""
        return self.DomainAssign[self._domain_of(pos, transform)]
