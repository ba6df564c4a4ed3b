"""ParticleMesh and Field types: the part of the core API that the
FastPM lattice path runs.

Counterpart of ``pmesh_tpu/pm.py``.  A field holds one torch tensor in
``.value`` on its ParticleMesh's ``device``; a tensor on another
device raises instead of being moved.  Arithmetic is done on
``.value``.  This slice has one device and no sharding.  The device
defaults to the current CUDA device; CPU use is asked for with
``device='cpu'``.
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
                              value=_fft.r2c(self.value))


class ComplexField(Field):
    """The hermitian half spectrum of a real field."""

    def c2r(self):
        """Unnormalized complex-to-real transform (inverse of r2c)."""
        return self.pm.create(
            type=RealField,
            value=_fft.c2r(self.value, self.Nmesh, self.pm.torch_dtype))

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
        the current CUDA device (raises without CUDA: pass 'cpu')
    procmesh : must be None; sharded meshes are not ported yet.
    """

    def __init__(self, Nmesh, BoxSize=1.0, dtype='f8', resampler='cic',
                 device=None, procmesh=None):
        if procmesh is not None:
            raise NotImplementedError(
                "sharded meshes are not ported yet (ROADMAP queue 1, "
                "item 8)")
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
        self.device = resolve_device(device)
        self.procmesh = None
        self.resampler = FindResampler(resampler)
        self._coords_cache = {}

    def _shape_dtype(self, field_type):
        if issubclass(field_type, RealField):
            return tuple(int(n) for n in self.Nmesh), self.torch_dtype
        shape = tuple(int(n) for n in self.Nmesh[:-1]) \
            + (int(self.Nmesh[-1]) // 2 + 1,)
        return shape, self.complex_dtype

    def create_coords(self, field_type, return_indices=False):
        """Broadcastable coordinate tensors: positions of a real field,
        wavenumbers of a complex one (in the mesh's real dtype, the
        Nyquist index of every axis taken as -N/2), or indices."""
        field_type = _field_type(field_type)
        iscomplex = issubclass(field_type, ComplexField)
        if iscomplex not in self._coords_cache:
            x, i = [], []
            shape, _ = self._shape_dtype(field_type)
            fdtype = 'f8' if self.dtype.itemsize >= 8 else 'f4'
            for d in range(self.ndim):
                n = shape[d]
                t = [1] * self.ndim
                t[d] = n
                ind = np.arange(n)
                ri = np.arange(n).astype(fdtype)
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
                            resampler=self.resampler, device=self.device)

    def create(self, type=None, value=None):
        """A new field of ``type`` ('real', 'complex' or a Field class)."""
        return _field_type(type)(self, value=value)
