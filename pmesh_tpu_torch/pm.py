"""ParticleMesh and Field types: the part of the core API that the
FastPM lattice path runs.

Counterpart of ``pmesh_tpu/pm.py``.  A field holds one torch tensor in
``.value`` on its ParticleMesh's ``device``; a tensor on another
device raises instead of being moved.  Arithmetic is done on
``.value``.  The device defaults to the current CUDA device; CPU use is
asked for with ``device='cpu'``.

With a ``procmesh`` of P > 1 ranks (``parallel/pmesh.py``) a field's
value is this rank's block: x rows ``[r N0/P, (r+1) N0/P)`` of a real
field, y columns ``[r N1/P, (r+1) N1/P)`` of the transposed complex
field (whole x, half z), as the JAX package's ``real_spec`` and
``transposed_spec`` lay out the global arrays.  ``r2c``/``c2r`` are the
slab transforms of ``parallel/pfft.py`` and the coordinates of
``apply`` are the block's own.  The ranks must divide N0 and N1 (the
JAX package's ``_even_mesh``); its uneven and replicated fallbacks are
not ported.
"""
import numpy as np
import torch

from .window import FindResampler
from .ops import fft as _fft

__all__ = ["ParticleMesh", "RealField", "ComplexField", "Field", "xlist",
           "resolve_device"]


def resolve_device(device=None):
    """The torch device an entry point runs on: ``device`` as given
    (a bare 'cuda' pinned to the current CUDA device), or with None the
    current CUDA device.  Without CUDA, None raises: the port does not
    fall back to the CPU unless asked."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pmesh_tpu_torch runs on the GPU by default; "
                "pass device='cpu' to run on the CPU")
        device = 'cuda'
    device = torch.device(device)
    if device.type == 'cuda' and device.index is None:
        device = torch.device('cuda', torch.cuda.current_device())
    return device


class xlist(list):
    """A list of broadcastable coordinate tensors with ``normp``."""

    def normp(self, p=2, zeromode=None):
        kk = sum([ki.abs() ** p for ki in self])
        if zeromode is not None:
            kk = torch.where(kk == 0, zeromode, kk)
        return kk


def _same_device(a, b):
    return a.type == b.type and (a.type == 'cpu' or a.index == b.index)


class Field(object):
    """Base class of RealField and ComplexField: ``.value`` is a tensor
    of the field's shape and dtype on ``pm.device``."""

    def __init__(self, pm, value=None):
        self.pm = pm
        self.BoxSize = pm.BoxSize
        self.Nmesh = pm.Nmesh
        self.ndim = pm.ndim
        shape, dtype = pm._shape_dtype(type(self))
        if value is None:
            value = torch.zeros(shape, dtype=dtype, device=pm.device)
        else:
            if not isinstance(value, torch.Tensor):
                value = torch.as_tensor(value, device=pm.device)
            if not _same_device(value.device, pm.device):
                raise ValueError(
                    "value lies on %s but the ParticleMesh is on %s"
                    % (value.device, pm.device))
            value = value.to(dtype)
            if tuple(value.shape) != shape:
                value = torch.broadcast_to(value, shape).contiguous()
        self.value = value

    @property
    def dtype(self):
        return self.value.dtype

    def apply(self, func, kind):
        """A new field func(coords, value), cast to this field's dtype."""
        x = self.pm._apply_coords(type(self), kind)
        result = func(x, self.value)
        if isinstance(result, Field):
            result = result.value
        return self.pm.create(type=type(self),
                              value=torch.as_tensor(result).to(self.dtype))


class RealField(Field):
    def r2c(self):
        """Real-to-complex transform, normalized by prod(Nmesh)^-1."""
        return self.pm.create(type=ComplexField,
                              value=self.pm._r2c_value(self.value))


class ComplexField(Field):
    """The hermitian half spectrum of a real field."""

    def c2r(self):
        """Unnormalized complex-to-real transform (inverse of r2c)."""
        return self.pm.create(type=RealField,
                              value=self.pm._c2r_value(self.value))

    def apply(self, func, kind="wavenumber"):
        if kind not in ('wavenumber', 'index'):
            raise ValueError("kind must be 'wavenumber' or 'index'")
        return Field.apply(self, func, kind)


_TYPES = {'real': RealField, 'complex': ComplexField}


def _field_type(t):
    if isinstance(t, str):
        if t not in _TYPES:
            raise ValueError("type must be real or complex")
        return _TYPES[t]
    if not (isinstance(t, type) and issubclass(t, Field)):
        raise TypeError("type must be a subclass of Field")
    return t


class ParticleMesh(object):
    """Geometry and transforms of a periodic mesh on one torch device.

    Parameters
    ----------
    Nmesh : sequence of int
    BoxSize : float or sequence of float
    dtype : 'f4' or 'f8'
    resampler : window name or ResampleWindow
    device : torch device of every field made from this mesh; default
        the current CUDA device (raises without CUDA: pass 'cpu'), or the
        procmesh's device
    procmesh : None, or a ``parallel.pmesh.ProcessMesh``: fields hold
        this rank's slab (module docstring).
    """

    def __init__(self, Nmesh, BoxSize=1.0, dtype='f8', resampler='cic',
                 device=None, procmesh=None):
        self.Nmesh = np.array(Nmesh, dtype='i8')
        self.ndim = len(self.Nmesh)
        self.BoxSize = np.empty(self.ndim, dtype='f8')
        self.BoxSize[:] = BoxSize
        self.dtype = np.dtype(dtype)
        if self.dtype not in (np.dtype('f4'), np.dtype('f8')):
            raise ValueError("dtype must be f4 or f8")
        self.torch_dtype = (torch.float32 if self.dtype == np.dtype('f4')
                            else torch.float64)
        self.complex_dtype = (torch.complex64
                              if self.dtype == np.dtype('f4')
                              else torch.complex128)
        self.procmesh = procmesh
        if procmesh is not None:
            from .parallel.pmesh import ProcessMesh
            if not isinstance(procmesh, ProcessMesh):
                raise NotImplementedError(
                    "procmesh must be a pmesh_tpu_torch.parallel.pmesh."
                    "ProcessMesh (the 1-d slab grid); other process grids "
                    "are not ported yet (ROADMAP queue 1, item 8)")
            if device is not None and not _same_device(
                    resolve_device(device), procmesh.device):
                raise ValueError("device %s is not the procmesh's %s"
                                 % (device, procmesh.device))
            device = procmesh.device
        self.device = resolve_device(device)
        self.resampler = FindResampler(resampler)
        self._coords_cache = {}
        if self.sharded:
            if self.ndim != 3:
                raise NotImplementedError(
                    "sharded meshes are 3-d here (the JAX package's 2-d "
                    "slab transforms are not ported)")
            # the slab layouts need equal blocks of x and y
            for d in (0, 1):
                procmesh.slab(int(self.Nmesh[d]))

    @property
    def sharded(self):
        """whether fields are rank-local blocks (a procmesh of P > 1)"""
        return self.procmesh is not None and self.procmesh.size > 1

    def _global_shape(self, field_type):
        if issubclass(field_type, RealField):
            return tuple(int(n) for n in self.Nmesh)
        return tuple(int(n) for n in self.Nmesh[:-1]) \
            + (int(self.Nmesh[-1]) // 2 + 1,)

    def local_block(self, field_type):
        """(axis, start, stop) of this rank's block of a field of
        ``field_type`` ('real', 'complex' or a class): x rows of a real
        field, y columns of the transposed complex one; the whole x axis
        on one rank."""
        field_type = _field_type(field_type)
        axis = 1 if issubclass(field_type, ComplexField) else 0
        n = self._global_shape(field_type)[axis]
        if not self.sharded:
            return axis, 0, n
        start, stop = self.procmesh.slab(n)
        return axis, start, stop

    def _shape_dtype(self, field_type):
        shape = list(self._global_shape(field_type))
        axis, start, stop = self.local_block(field_type)
        shape[axis] = stop - start
        dtype = (self.torch_dtype if issubclass(field_type, RealField)
                 else self.complex_dtype)
        return tuple(shape), dtype

    def _r2c_value(self, value):
        if self.sharded:
            from .parallel import pfft
            return pfft.r2c(self.procmesh, value)
        return _fft.r2c(value)

    def _c2r_value(self, value):
        if self.sharded:
            from .parallel import pfft
            return pfft.c2r(self.procmesh, value, self.Nmesh,
                            self.torch_dtype)
        return _fft.c2r(value, self.Nmesh, self.torch_dtype)

    def create_coords(self, field_type, return_indices=False):
        """Broadcastable coordinate tensors: positions of a real field,
        wavenumbers of a complex one (in the mesh's real dtype, the
        Nyquist index of every axis taken as -N/2), or indices; on a
        sharded mesh, those of this rank's block."""
        field_type = _field_type(field_type)
        iscomplex = issubclass(field_type, ComplexField)
        if iscomplex not in self._coords_cache:
            x, i = [], []
            shape = self._global_shape(field_type)
            axis, start, stop = self.local_block(field_type)
            fdtype = 'f8' if self.dtype.itemsize >= 8 else 'f4'
            for d in range(self.ndim):
                # this rank's block of the global coordinates
                lo, hi = (start, stop) if d == axis else (0, shape[d])
                t = [1] * self.ndim
                t[d] = hi - lo
                ind = np.arange(lo, hi)
                ri = np.arange(lo, hi).astype(fdtype)
                ri[ri >= self.Nmesh[d] // 2] -= self.Nmesh[d]
                if iscomplex:
                    wi = ri * (2 * np.pi / self.Nmesh[d])
                    xi = (wi * self.Nmesh[d]
                          / self.BoxSize[d]).astype(fdtype)
                else:
                    xi = (ri * (self.BoxSize[d]
                                / self.Nmesh[d])).astype(fdtype)
                x.append(torch.from_numpy(xi.reshape(t)).to(self.device))
                i.append(torch.from_numpy(ind.reshape(t)).to(self.device))
            self._coords_cache[iscomplex] = (x, i)
        x, i = self._coords_cache[iscomplex]
        return list(i if return_indices else x)

    def _apply_coords(self, field_type, kind):
        s = xlist(self.create_coords(field_type,
                                     return_indices=(kind == 'index')))
        s.BoxSize = self.BoxSize
        s.Nmesh = self.Nmesh
        return s

    def reshape(self, Nmesh=None, BoxSize=None):
        """A ParticleMesh with another resolution on the same device."""
        if Nmesh is None:
            Nmesh = self.Nmesh
        elif np.isscalar(Nmesh):
            Nmesh = [Nmesh for _ in range(self.ndim)]
        if BoxSize is None:
            BoxSize = self.BoxSize[:len(Nmesh)]
        elif np.isscalar(BoxSize):
            BoxSize = [BoxSize for _ in range(len(Nmesh))]
        if len(BoxSize) != len(Nmesh):
            raise ValueError("dimension of BoxSize and Nmesh disagree")
        return ParticleMesh(Nmesh, BoxSize, dtype=self.dtype,
                            resampler=self.resampler, device=self.device,
                            procmesh=self.procmesh)

    def create(self, type=None, value=None):
        """A new field of ``type`` ('real', 'complex' or a Field class)."""
        return _field_type(type)(self, value=value)
