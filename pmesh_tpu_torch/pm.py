"""ParticleMesh and Field types: the core API.

Counterpart of ``pmesh_tpu/pm.py``.  A field holds one torch tensor in
``.value`` on its ParticleMesh's ``device``; a tensor on another
device raises instead of being moved.  Arithmetic is done on
``.value``, and an ``out=`` of the JAX package's API rebinds
``out.value``; the item setters (``__setitem__``, ``csetitem``) rebind a
changed copy, as the JAX package's ``.at[].set`` does, so a tensor the
field was made from is never written.  The device defaults to the
current CUDA device; CPU use is asked for with ``device='cpu'``.

What is here: the field arithmetic and comparison, ``cast``, the
coordinates and slab iterators, ``r2c``/``c2r`` (``torch.fft``, cuFFT
on the card), ``apply``, the collective reductions ``csum``/``cmean``/
``cdot``/``cnorm``, the item access by global index ``cgetitem``/
``csetitem`` (with the hermitian dual of a half spectrum kept in
step), ``ravel``/``unravel``, the Fourier ``resample`` and the host
``preview``, ``ctranspose``, the generic ``readout`` and ``paint``
(``ops/paint.py``) with ``upsample``/``downsample`` and the analytic
``*_vjp``/``*_jvp`` operators, the particle grid, the single-domain
``decompose`` and the white noise.  The transposed and untransposed
complex fields are one layout on one device (and on the replicated
route): the hermitian half spectrum, or with a complex dtype ('c8',
'c16') the full c2c spectrum, whose real fields are complex too.

With a ``procmesh`` of P > 1 ranks (``parallel/pmesh.py``) the mesh
takes one of three routes (``ParticleMesh.route``), chosen by the JAX
package's tests ``_even_mesh``, ``_uneven1d`` and ``_pencil2d`` with
the same arithmetic:

- ``'slab'``, a 1-d grid whose ranks divide N0 and N1, or an uneven
  mesh whose slabs reach across the dead seam (``_uneven1d``): a real
  field's value is this rank's x rows ``[r c0, min((r+1) c0, N0))``,
  the transposed complex field's its y columns ``[r c1, min((r+1) c1,
  Ny))`` (whole x, half z), c0 = ceil(N0/P), c1 = ceil(N1/P), Ny the
  spectrum's y length (the half Ny//2+1 of a 2-d real mesh); the last
  blocks of an uneven mesh are short or empty;
- ``'pencil'``, a 2-d (npx, npy) grid whose ranks divide N0 and N1 (3-d
  meshes): the rank at (bx, by) holds the real pencil of x block bx and
  y block by, and of the spectrum the y block bx (N1/npx) and the z
  block by of the spectrum's last axis padded to a multiple of npy (its
  real columns only);
- ``'replicated'``, every other geometry (the JAX package's GSPMD
  fallback), and a 2-d mesh on a 2-d grid (which the JAX package
  transforms by DFT matmuls): every rank holds the whole field and
  transforms it alone; a paint is each rank's paint of its own
  particles summed over the ranks, a readout is local, and
  ``decompose`` warns as the JAX package's does.

``r2c``/``c2r`` are the transforms of ``parallel/pfft.py`` and the
coordinates of ``apply`` are the block's own, with global indices.
Particle arrays are held in blocks on every route: rank b holds block b
of the global (N, ndim) array (``parallel/exchange.py``).  On a slab
``decompose`` builds the 1-d ghost plan (a ``ShardedLayout``), on a
pencil the 2-d one (a ``ShardedLayout2D``, ``parallel/exchange2d.py``);
``reshard_particles`` restores its residency, ``paint`` and ``readout``
with that plan paint and read each rank's block from its images, and
without one they reshard a copy, decompose and route the values back,
so that any positions give the global answer.  The particle grid is
block b of the lattice's points in C order, the white noise each rank's
own block of the fill, and the reductions ``csum``/``cdot``/``cnorm``
sum over the ranks' blocks.

The field API answers on every route, with these conventions (the
data moves by ``parallel/blocks.py``, over ``comm.all_to_all_v``, so
that what is differentiable on one device stays so):

- ``Field.start`` and ``slices`` are this rank's block in global
  indices: ``value`` is the global field's ``[slices]``;
- ``mesh_coordinates`` and ``ravel`` give rank b block b of the
  C-ordered points and flat array, ``[b nl, (b + 1) nl)`` with nl =
  ceil(npoints / P), as every particle array is held, so their rows
  pair one to one and the blocks in rank order are the global ravel;
  ``unravel`` takes that block (on an even slab the real slab is its
  own block and nothing moves).  Where every rank holds the whole
  field (the replicated route), ``ravel``/``unravel`` are the
  one-device ones, and ``mesh_coordinates`` still block b;
- ``cgetitem`` returns the same value on every rank (the owner's,
  summed over the ranks); ``csetitem`` writes on the ranks that hold
  the index and its hermitian dual;
- the untransposed complex field takes the real field's blocks (x on a
  slab, (x, y) on a pencil: the JAX package's ``untransposed_spec``);
  ``r2c(out=U)``, ``c2r`` and ``cast`` move the spectrum between it and
  the transposed layout;
- ``resample`` gathers the source spectrum on every rank (as the JAX
  package does) and fills each rank's block of the target; ``preview``
  is the same numpy array on every rank, the blocks' partial sums
  summed over the ranks; ``ctranspose`` is this rank's block of the
  permuted field on ``pm.reshape`` of the same process mesh.

Reverse and forward mode run through every route, with the convention
of ``parallel/comm.py``: the gradient of a blocked field or particle
array is this rank's block of the global gradient, that of a field
every rank holds whole the whole gradient on every rank, and a loss
every rank holds is seeded on every rank.  On the replicated route the
paint's sum over the ranks passes its cotangent through, and the
readout hands the whole mesh to the rank's particles through
``comm.pbroadcast`` (:meth:`ParticleMesh.local_view`), whose backward
sums the mesh's cotangent over the ranks.
"""
import functools

import numpy as np
import torch

from .window import Affine, FindResampler
from .ops import fft as _fft
from .ops import paint as _paint_ops
from .parallel.domain import Layout

__all__ = ["ParticleMesh", "RealField", "ComplexField",
           "TransposedComplexField", "UntransposedComplexField", "Field",
           "xlist", "resolve_device", "build_index", "reindex"]

_gettype = type


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


def _rank_sum(pm, value):
    """a 0-d sum of this rank's block, summed over the ranks (the sum
    itself where every rank holds the whole field)"""
    if not pm.blocked:
        return value
    from .parallel.comm import all_reduce
    return all_reduce(value, pm.procmesh, 'sum')


def is_inplace(out):
    return out is Ellipsis


class xlist(list):
    """A list of broadcastable coordinate tensors with ``normp``."""

    def normp(self, p=2, zeromode=None):
        kk = sum([ki.abs() ** p for ki in self])
        if zeromode is not None:
            kk = torch.where(kk == 0, zeromode, kk)
        return kk


class slabiter(object):
    """Iteration over the slowest axis: each x row of the field's value
    (the whole value for ndim <= 2), with ``.x`` and ``.i`` iterating the
    coordinates of the same rows.  The rows are views of ``.value``;
    change a field through ``apply`` or ``__setitem__``."""

    def __init__(self, field):
        self.field = field
        self.nslabs = field.shape[0] if field.ndim > 2 else 1
        self.x = _xslabiter(field, 'x', self.nslabs)
        self.i = _xslabiter(field, 'i', self.nslabs)

    def __iter__(self):
        f = self.field
        if f.ndim <= 2:
            yield f.value
            return
        for irow in range(self.nslabs):
            yield f.value[irow]


class _xslabiter(object):
    def __init__(self, field, attr, nslabs):
        self.field = field
        self.attr = attr
        self.nslabs = nslabs

    def _xlist(self, coords):
        s = xlist(coords)
        s.BoxSize = self.field.BoxSize
        s.Nmesh = self.field.Nmesh
        return s

    def __iter__(self):
        f = self.field
        coords = getattr(f, self.attr)
        if f.ndim <= 2:
            yield self._xlist(coords)
            return
        for irow in range(self.nslabs):
            yield self._xlist(
                [coords[0].reshape(-1)[irow].reshape((1,) * (f.ndim - 1))
                 if d == 0 else coords[d][0] for d in range(f.ndim)])


def _same_device(a, b):
    return a.type == b.type and (a.type == 'cpu' or a.index == b.index)


class Field(object):
    """Base class of RealField and the complex fields: ``.value`` is a
    tensor of the field's shape and dtype on ``pm.device``."""

    def __init__(self, pm, value=None):
        self.pm = pm
        self.BoxSize = pm.BoxSize
        self.Nmesh = pm.Nmesh
        self.ndim = pm.ndim
        shape, dtype = pm._shape_dtype(type(self))
        self.cshape = np.array(pm._global_shape(type(self)), dtype='intp')
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

    def __repr__(self):
        return '%s:%r' % (type(self).__name__, self.value)

    @property
    def shape(self):
        return tuple(self.value.shape)

    @property
    def csize(self):
        return int(np.prod(self.cshape))

    @property
    def dtype(self):
        return self.value.dtype

    @property
    def size(self):
        return self.value.numel()

    @property
    def start(self):
        """the global index of this rank's block's first point (0 where
        the field is whole)"""
        return np.array([lo for lo, _ in self.pm.local_block(type(self))],
                        dtype='intp')

    @property
    def slices(self):
        """this rank's block of the global field (the whole field on one
        device and on the replicated route)"""
        return tuple(slice(lo, hi)
                     for lo, hi in self.pm.local_block(type(self)))

    @property
    def real(self):
        return self.value.real

    @property
    def imag(self):
        return self.value.imag

    @property
    def flat(self):
        return self.value.reshape(-1)

    def __getitem__(self, index):
        return self.value[index]

    def __setitem__(self, index, value):
        """Set ``value[index]``: ``.value`` is rebound to a changed copy."""
        if isinstance(value, Field):
            value = value.value
        if index is Ellipsis:
            value = torch.as_tensor(value, device=self.pm.device)
            self.value = torch.broadcast_to(
                value.to(self.dtype), self.shape).contiguous()
            return
        v = self.value.clone()
        v[index] = value
        self.value = v

    def numpy(self):
        """The field value as a host numpy array."""
        return self.value.detach().cpu().numpy()

    def __array__(self, dtype=None, copy=None):
        a = self.numpy()
        return a.astype(dtype) if dtype is not None else a

    # --- arithmetic: a field of the same type where the result keeps the
    # shape and is not boolean, else the bare tensor
    def _cast_binop(self, other):
        return other.value if isinstance(other, Field) else other

    def _wrap(self, value):
        if tuple(value.shape) != tuple(self.value.shape) \
                or value.dtype == torch.bool:
            return value
        return self.pm.create(type=_gettype(self), value=value)

    def __add__(self, other):
        return self._wrap(self.value + self._cast_binop(other))
    __radd__ = __add__

    def __sub__(self, other):
        return self._wrap(self.value - self._cast_binop(other))

    def __rsub__(self, other):
        return self._wrap(self._cast_binop(other) - self.value)

    def __mul__(self, other):
        return self._wrap(self.value * self._cast_binop(other))
    __rmul__ = __mul__

    def __truediv__(self, other):
        return self._wrap(self.value / self._cast_binop(other))

    def __rtruediv__(self, other):
        return self._wrap(self._cast_binop(other) / self.value)

    def __pow__(self, other):
        return self._wrap(self.value ** self._cast_binop(other))

    def __neg__(self):
        return self._wrap(-self.value)

    def __abs__(self):
        return self._wrap(self.value.abs())

    def __iadd__(self, other):
        self.value = self.value + self._cast_binop(other)
        return self

    def __isub__(self, other):
        self.value = self.value - self._cast_binop(other)
        return self

    def __imul__(self, other):
        self.value = self.value * self._cast_binop(other)
        return self

    def __itruediv__(self, other):
        self.value = self.value / self._cast_binop(other)
        return self

    def __eq__(self, other):
        return self.value == self._cast_binop(other)

    # elementwise __eq__ with identity hashing, as torch tensors do
    __hash__ = object.__hash__

    def copy(self):
        return self.pm.create(_gettype(self), value=self.value.clone())

    def _check_compatible(self, other):
        if isinstance(other, Field):
            if not isinstance(other, _gettype(self)):
                raise TypeError(
                    "type of two operands of cdot must be the same type")
        elif tuple(other.shape) != self.shape:
            raise ValueError("operand of shape %s is not a field of shape %s"
                             % (tuple(other.shape), self.shape))

    # --- coordinates ---
    @property
    def x(self):
        return self.pm.create_coords(_gettype(self), return_indices=False)

    @property
    def i(self):
        return self.pm.create_coords(_gettype(self), return_indices=True)

    @property
    def slabs(self):
        return slabiter(self)

    @property
    def compressed(self):
        """whether the field stores the hermitian-compressed half
        spectrum"""
        if self.Nmesh[-1] == self.cshape[-1]:
            return False
        if self.Nmesh[-1] // 2 + 1 == self.cshape[-1]:
            return True
        raise ValueError("inconsistent Nmesh %s / cshape %s"
                         % (self.Nmesh, self.cshape))

    # --- item access by global index
    def _normalize_index(self, index):
        index = np.array(index, copy=True)
        if len(index) == self.ndim + 1:
            comp = int(index[-1])
            index1 = index[:-1]
        elif len(index) == self.ndim:
            comp = None
            index1 = index
        else:
            raise IndexError("only vector index is supported; for complex "
                             "append 0/1 for real/imag")
        index1[index1 < 0] += self.Nmesh[index1 < 0]
        return tuple(int(i) for i in index1), comp

    def _dual(self, ind):
        return tuple((int(self.Nmesh[d]) - ind[d]) % int(self.Nmesh[d])
                     for d in range(self.ndim))

    def _stored(self, ind):
        """whether the global field stores the global index ``ind``"""
        return all(ind[d] < self.cshape[d] for d in range(self.ndim))

    def _local(self, ind):
        """the index within this rank's block of the global index ``ind``,
        or None where another rank holds it"""
        block = self.pm.local_block(type(self))
        if not all(lo <= i < hi for i, (lo, hi) in zip(ind, block)):
            return None
        return tuple(i - lo for i, (lo, _) in zip(ind, block))

    def cgetitem(self, index):
        """The value at a global index (a numpy scalar); with a trailing
        0 or 1, its real or imaginary part.  A mode of a half spectrum
        stored only as its conjugate is read from its dual.  On a blocked
        route the rank that holds it reads it and every rank returns it
        (a sum over the ranks)."""
        ind, comp = self._normalize_index(index)
        conj = False
        if not self._stored(ind):
            ind = self._dual(ind)
            conj = True
            if not self._stored(ind):
                raise IndexError("index %s out of bounds for shape %s"
                                 % (ind, tuple(self.cshape)))
        v = self.value.detach()
        if self.pm.blocked:
            from .parallel.comm import all_reduce
            at = self._local(ind)
            v = v[at] if at is not None else v.new_zeros(())
            v = all_reduce(v.reshape(1), self.pm.procmesh, 'sum')[0]
        else:
            v = v[ind]
        v = v.cpu().numpy()
        if conj:
            v = np.conjugate(v)
        if comp is None:
            return v[()]
        return (v.imag if comp == 1 else v.real)[()]

    def csetitem(self, index, y):
        """Set the value at a global index (with a trailing 0 or 1, its
        real or imaginary part) and, on a complex field, its hermitian
        dual where that is stored: a self-conjugate mode keeps only the
        real part.  On a blocked route the ranks that hold the index and
        its dual write them.  Returns the value cgetitem then reads (on
        every rank)."""
        ind, comp = self._normalize_index(index)
        v = self.value.clone()

        def write(i, f):
            # v[i] = f(v[i]) on the rank that holds global index i
            at = self._local(i)
            if at is not None:
                v[at] = f(complex(v[at].item()))

        if not isinstance(self, BaseComplexField):
            if comp is not None:
                raise IndexError("real field has no real/imag index")
            write(ind, lambda _: y)
            self.value = v
            return y

        dual = self._dual(ind)
        has_local = self._stored(ind)
        has_dual = self._stored(dual)
        stored = has_local or has_dual
        y_in = y
        dualy = y_in
        if comp == 1:
            dualy = -dualy
            if has_local and has_dual and ind == dual:
                y_in = 0
                dualy = 0
            if has_local:
                write(ind, lambda old: old.real + 1j * y_in)
            if has_dual:
                write(dual, lambda old: old.real + 1j * dualy)
        elif comp == 0:
            if has_local:
                write(ind, lambda old: 1j * old.imag + y_in)
            if has_dual:
                write(dual, lambda old: 1j * old.imag + y_in)
        else:
            dualy = np.conjugate(dualy)
            if has_local and has_dual and ind == dual:
                dualy = dualy.real
                y_in = np.real(y_in) if np.iscomplexobj(y_in) else y_in
            if has_local:
                write(ind, lambda _: y_in)
            if has_dual:
                write(dual, lambda _: dualy)
        self.value = v
        # an index stored only as its conjugate still takes the value
        return y_in if stored else 0

    # --- global reshaping
    def ravel(self, out=None):
        """The C-ordered flat value (a view where the value is
        contiguous); on a blocked route this rank's block of the global
        flat array (module docstring).  ``out`` takes only None or
        Ellipsis: use the returned tensor."""
        if out is not None and not is_inplace(out):
            raise ValueError("ravel(out=...) cannot fill a caller buffer; "
                             "pass out=None or out=... and use the returned "
                             "tensor")
        if not self.pm.blocked or self.pm._flat_aligned(type(self)):
            return self.value.reshape(-1)
        from .parallel import blocks
        return blocks.ravel(self.value, self.pm.procmesh,
                            self.pm.local_block(type(self)),
                            tuple(self.cshape), self.pm._owner(type(self)))

    def unravel(self, flat):
        """Rebind ``.value`` to the C-ordered ``flat`` (a tensor on the
        mesh's device, a numpy array or a field); on a blocked route
        ``flat`` is this rank's block of the global flat array, as
        :meth:`ravel` returns it."""
        if isinstance(flat, Field):
            flat = flat.value
        flat = torch.as_tensor(flat, device=self.pm.device)
        if not _same_device(flat.device, self.pm.device):
            raise ValueError("flat lies on %s but the ParticleMesh is on %s"
                             % (flat.device, self.pm.device))
        flat = flat.reshape(-1).to(self.dtype)
        if not self.pm.blocked or self.pm._flat_aligned(type(self)):
            self.value = flat.reshape(self.shape)
            return
        from .parallel import blocks
        self.value = blocks.unravel(flat, self.pm.procmesh,
                                    self.pm.local_block(type(self)),
                                    tuple(self.cshape),
                                    self.pm._owner(type(self)))

    def sort(self, out=None):
        return self.ravel(out)

    def cast(self, type, out=None):
        """This field as a field of ``type``, keeping its meaning: a real
        field goes through r2c to a complex type and back through c2r."""
        type = _field_type(type)
        if isinstance(self, RealField) and issubclass(type, BaseComplexField):
            r = self.r2c(out=self.pm.create(type))
        elif isinstance(self, BaseComplexField) and issubclass(type,
                                                               RealField):
            r = self.c2r()
        else:
            r = self.pm.create(type, value=self.pm._relayout(
                self.value, _gettype(self), type))
        if isinstance(out, Field):
            out.value = r.value.to(out.dtype)
            return out
        return r

    def resample(self, out):
        """Resample into ``out``, a field of another ParticleMesh, by
        keeping the Fourier modes both meshes hold and zeroing the rest:
        self-conjugate modes are made real, and every mode on a Nyquist
        plane of either mesh is zeroed.  A mesh of the same size is a
        :meth:`cast`.  Returns ``out``.

        The modes are those of this field's spectrum: the JAX package
        indexes a real field's spectrum with the real field's own shape
        (``pmesh_tpu/pm.py:517-519``), which reads the wrong modes when
        the last axis is compressed; the port reads the spectrum's
        shape.

        On a sharded mesh (``out`` on the same process mesh) every rank
        gathers the source spectrum, as the JAX package does, and fills
        its block of the target's."""
        if not isinstance(out, Field):
            raise TypeError("out must be a Field")
        if all(out.Nmesh == self.Nmesh):
            return self.cast(type=_gettype(out), out=out)
        selfc = self.cast(type=TransposedComplexField)
        complex = out.pm.create(type=TransposedComplexField)
        ind = build_index(
            [reindex(self.Nmesh[d], out.Nmesh[d])[np.arange(lo, hi)]
             for d, (lo, hi) in enumerate(
                 out.pm.local_block(TransposedComplexField))],
            selfc.cshape)
        ind = torch.from_numpy(ind).to(self.pm.device)
        flat = self.pm._whole(selfc.value, TransposedComplexField,
                              out.pm.blocked).reshape(-1)
        cvalue = torch.where(ind >= 0, flat[ind.clamp(min=0)], 0)
        ii = complex.i
        selfconj = functools.reduce(
            torch.logical_and,
            [(int(n) - i0) % int(n) == i0 for i0, n in zip(ii, out.Nmesh)])
        cvalue = torch.where(selfconj, cvalue.real.to(cvalue.dtype), cvalue)
        nyquist = functools.reduce(
            torch.logical_or,
            [(i0 == int(n) // 2) | (i0 == int(m) // 2)
             for i0, n, m in zip(ii, out.Nmesh, self.Nmesh)])
        complex.value = torch.where(nyquist, 0, cvalue)
        out.value = complex.cast(type=_gettype(out)).value
        return out

    def preview(self, Nmesh=None, axes=None, resampler=None, method=None):
        """The field as a host numpy array: resampled to ``Nmesh``
        (through ``downsample`` or ``upsample`` of the real field,
        keeping the mean) and summed over the axes not in ``axes``, the
        kept axes in the order ``axes`` gives.  On a sharded mesh every
        rank returns the same array: the one-device result, summed over
        the ranks' blocks."""
        if axes is None:
            axes = range(self.ndim)
        if not hasattr(axes, '__iter__'):
            axes = (axes,)
        axes = list(axes)
        field = self.c2r() if isinstance(self, BaseComplexField) else self
        if Nmesh is not None and np.all(np.asarray(Nmesh) == field.Nmesh):
            Nmesh = None
        if Nmesh is not None:
            pm = field.pm.reshape(Nmesh)
            if method is None:
                method = ('downsample' if np.any(np.asarray(Nmesh)
                                                 < field.Nmesh)
                          else 'upsample')
            if method == 'downsample':
                field = pm.downsample(field, resampler=resampler,
                                      keep_mean=True)
            elif method == 'upsample':
                field = pm.upsample(field, resampler=resampler,
                                    keep_mean=True)
            else:
                raise ValueError("method must be downsample or upsample")
        removeaxes = sorted(set(range(field.ndim)) - set(axes))
        v = field.value.detach()
        if removeaxes:
            v = v.sum(dim=tuple(removeaxes))
        if field.pm.blocked:
            # this rank's partial sums in place in the kept axes' global
            # shape, summed over the ranks
            from .parallel.comm import all_reduce
            kept = [a for a in range(field.ndim) if a not in removeaxes]
            part = v.new_zeros(tuple(int(field.Nmesh[a]) for a in kept))
            part[tuple(field.slices[a] for a in kept)] = v
            v = all_reduce(part, field.pm.procmesh, 'sum')
        # the kept axes in increasing order, permuted to ``axes``'
        current = [a for a in range(field.ndim) if a not in removeaxes]
        perm = [current.index(a) for a in axes]
        if perm != list(range(len(perm))):
            v = v.permute(perm)
        return v.detach().cpu().numpy()

    def apply(self, func, kind, out=None):
        """func(coords, value), cast to this field's dtype: a new field,
        or with ``out`` (Ellipsis: this field) rebound into it."""
        x = self.pm._apply_coords(_gettype(self), kind)
        result = func(x, self.value)
        if isinstance(result, Field):
            result = result.value
        result = torch.as_tensor(result).to(self.dtype)
        if out is None:
            return self.pm.create(type=_gettype(self), value=result)
        if is_inplace(out):
            out = self
        if not isinstance(out, Field):
            raise TypeError("out must be None, Ellipsis or a Field")
        out.value = result
        return out


class RealField(Field):
    def r2c(self, out=None):
        """Real-to-complex transform, normalized by prod(Nmesh)^-1."""
        value = self.pm._r2c_value(self.value)
        if out is None or is_inplace(out) or out is self:
            return self.pm.create(type=ComplexField, value=value)
        out.value = self.pm._relayout(value, TransposedComplexField,
                                      _gettype(out)).to(out.dtype)
        return out

    def apply(self, func, kind="relative", out=None):
        if kind not in ('relative', 'index', 'absolute'):
            raise ValueError("kind must be 'relative', 'index' or "
                             "'absolute'")
        return Field.apply(self, func, kind, out)

    def csum(self, dtype=None):
        """Sum over the whole mesh (a 0-d tensor; on a sharded mesh the
        blocks' sums summed over the ranks)."""
        v = self.value if dtype is None else self.value.to(dtype)
        return _rank_sum(self.pm, v.sum())

    def cmean(self, dtype=None):
        return self.csum(dtype=dtype) / self.csize

    def cdot(self, other):
        self._check_compatible(other)
        return _rank_sum(self.pm, (self.value * self._cast_binop(other)).sum())

    def cnorm(self):
        return self.cdot(self)

    def readout(self, pos, hsml=None, out=None, resampler=None,
                transform=None, gradient=None, layout=None, hsml_max=None):
        """The field's values at ``pos`` (N, ndim) through the generic
        readout (``ops/paint.py``); ``gradient`` = d reads the derivative
        along axis d in the units of ``pos``; ``layout`` is a
        :meth:`ParticleMesh.decompose` plan.  Returns a new tensor.

        On a sharded mesh ``pos`` is this rank's block of particles: with
        a ``ShardedLayout`` (``ShardedLayout2D``) the sharded readout
        reads each rank's slab (pencil) from the images; without one the
        particles are resharded, decomposed and read, and the values
        routed back.  Where every rank holds the whole field, each reads
        its own particles."""
        if out is not None:
            raise TypeError("out= is not supported: use the return value")
        if transform is None:
            transform = self.pm.affine
        resampler = FindResampler(self.pm.resampler if resampler is None
                                  else resampler)
        value = self.value.real if self.pm._is_c2c else self.value
        if self.pm.blocked:
            return self.pm._readout_sharded(value, pos, hsml, resampler,
                                            transform, gradient, layout,
                                            hsml_max)
        value = self.pm.local_view(value)
        if layout is not None:
            pos = layout.exchange(pos)
            hsml = layout.exchange(hsml) if hsml is not None else None
        r = _paint_ops.readout(value, pos, window=resampler.window,
                               scale=transform.scale,
                               translate=transform.translate,
                               period=transform.period, diffdir=gradient,
                               hsml=hsml, hsml_max=hsml_max)
        if layout is not None:
            r = layout.gather(r, mode='sum')
        return r

    def readout_vjp(self, pos, v, resampler=None, transform=None,
                    gradient=None, out_self=None, out_pos=None, layout=None):
        """The vjp of ``readout`` against the cotangent ``v`` (N,):
        (the paint of ``v``, the (N, ndim) sum of v times each diffdir
        readout).  ``out_self`` or ``out_pos`` False skips that part."""
        if out_pos is not False:
            if gradient is not None:
                raise ValueError("gradient of gradient is not supported")
            out_pos = torch.stack(
                [self.readout(pos, resampler=resampler, transform=transform,
                              gradient=d, layout=layout) * v
                 for d in range(pos.shape[1])], dim=-1)
        if out_self is not False:
            out_self = self.pm.paint(pos, mass=v, resampler=resampler,
                                     transform=transform, gradient=gradient,
                                     hold=False, layout=layout)
        return out_self, out_pos

    def readout_jvp(self, pos, v_self=None, v_pos=None, resampler=None,
                    transform=None, gradient=None, layout=None):
        """The jvp of ``readout`` along the tangents ``v_self`` (a
        RealField) and ``v_pos`` (N, ndim)."""
        jvp = torch.zeros(len(pos), dtype=torch.as_tensor(pos).dtype,
                          device=self.pm.device)
        if v_pos is not None:
            for d in range(self.ndim):
                jvp = jvp + self.readout(
                    pos, resampler=resampler, transform=transform,
                    gradient=d, layout=layout) * v_pos[..., d]
        if v_self is not None:
            jvp = jvp + v_self.readout(pos, resampler=resampler,
                                       transform=transform, gradient=None,
                                       layout=layout)
        return jvp

    def paint(self, pos, mass=1.0, resampler=None, transform=None,
              hold=False, gradient=None, layout=None):
        """Paint ``pos`` into this field (added to it with ``hold``)."""
        return self.pm.paint(pos, mass=mass, resampler=resampler,
                             transform=transform, hold=hold,
                             gradient=gradient, layout=layout, out=self)

    def c2r_vjp(v, out=None):
        """The vjp of ``c2r`` against the real cotangent ``v``: its r2c
        times prod(Nmesh) (called on the cotangent,
        ``RealField.c2r_vjp(v)``)."""
        out = v.r2c(out)
        out.value = out.value * float(np.prod(out.pm.Nmesh))
        return out

    def ctranspose(self, axes):
        """The field with its axes permuted to ``axes``, on a mesh whose
        Nmesh and BoxSize are permuted alike (on a sharded mesh, of the
        same process mesh: this rank's block of the permuted field)."""
        axes = [int(a) for a in axes]
        if sorted(axes) != list(range(self.ndim)):
            raise ValueError("axes must be a permutation of range(ndim)")
        pm = self.pm.reshape(BoxSize=self.BoxSize[axes],
                             Nmesh=self.Nmesh[axes])
        if self.pm.blocked and pm.blocked:
            from .parallel import blocks
            value = blocks.redistribute(
                self.value, self.pm.procmesh, self.pm._boxes(RealField),
                pm._boxes(RealField), perm=axes)
        else:
            value = self.pm._whole(self.value, RealField,
                                   pm.blocked).permute(axes)
            value = value[tuple(slice(lo, hi) for lo, hi
                                in pm.local_block(RealField))]
        return pm.create(type=RealField, value=value.contiguous())


class BaseComplexField(Field):
    """The hermitian half spectrum of a real field (on a c2c mesh, the
    full spectrum)."""

    def c2r(self, out=None):
        """Unnormalized complex-to-real transform (inverse of r2c)."""
        value = self.pm._c2r_value(self.pm._relayout(
            self.value, _gettype(self), TransposedComplexField))
        if out is None or is_inplace(out) or out is self:
            return self.pm.create(type=RealField, value=value)
        out.value = value.to(out.dtype)
        return out

    def apply(self, func, kind="wavenumber", out=None):
        if kind not in ('wavenumber', 'circular', 'index'):
            raise ValueError("kind must be 'wavenumber', 'circular' or "
                             "'index'")
        return Field.apply(self, func, kind, out)

    def _expand_hermitian(self, i, y):
        """Double the weight of modes whose conjugate is not stored."""
        if not self.compressed:
            return y
        mask = (i[-1] != 0) & (i[-1] != self.Nmesh[-1] // 2)
        return y + mask * y

    def cnorm(self, metric=None, norm=lambda x: x.real ** 2 + x.imag ** 2):
        """Sum of norm(v) over all modes, the conjugates included."""

        def filter2(k, y):
            y = norm(y)
            if metric is not None:
                y = y * metric(k.normp(p=2) ** 0.5)
            return y
        r = self.apply(filter2)
        r = r.apply(self._expand_hermitian, kind='index', out=Ellipsis)
        return _rank_sum(self.pm, r.value.sum()).real

    def cdot(self, other, metric=None):
        """sum conj(other) * self over all modes, the conjugates
        included."""
        if isinstance(other, Field):
            if not isinstance(other, _gettype(self)):
                raise TypeError(
                    "type of two operands of cdot must be the same type")
            other = other.value
        r = self.pm.create(type=_gettype(self),
                           value=torch.conj(other) * self.value)
        r.apply(self._expand_hermitian, kind='index', out=Ellipsis)
        if metric is not None:
            r.apply(lambda k, y: y * metric(k.normp() ** 0.5), out=Ellipsis)
        return _rank_sum(self.pm, r.value.sum())

    def cdot_vjp(self, v, metric=None):
        """The vjp of ``cdot`` against ``other``: this field times the
        cotangent ``v``, weighted by ``metric`` of |k|."""
        r = self * v
        if metric is not None:
            r.apply(lambda k, y: y * metric(k.normp() ** 0.5), out=Ellipsis)
        return r

    def r2c_vjp(v, out=None):
        """The vjp of ``r2c`` against the complex cotangent ``v``: its
        c2r over prod(Nmesh) (``ComplexField.r2c_vjp(v)``)."""
        out = v.c2r(out)
        out.value = out.value * float(np.prod(out.pm.Nmesh) ** -1.0)
        return out

    def decompress_vjp(v, out=None):
        """The hermitian weighting of a half-spectrum cotangent ``v``:
        self-conjugate modes once, every other mode twice."""
        mask = functools.reduce(
            torch.logical_and,
            [(int(n) - ii) % int(n) == ii for ii, n in zip(v.i, v.Nmesh)])
        value = torch.where(mask, v.value, 2 * v.value)
        if out is None or is_inplace(out):
            return v.pm.create(type=_gettype(v), value=value)
        out.value = value
        return out


class TransposedComplexField(BaseComplexField):
    """The complex field r2c returns (on a sharded mesh, this rank's block:
    y columns on a slab, y and z blocks on a pencil)."""


class UntransposedComplexField(BaseComplexField):
    """The complex field in the input layout: on one device the same
    array as the transposed one; on a blocked route the real field's
    blocks (x rows on a slab, x and y blocks on a pencil)."""


ComplexField = TransposedComplexField

_TYPES = {'real': RealField, 'complex': ComplexField,
          'transposedcomplex': TransposedComplexField,
          'untransposedcomplex': UntransposedComplexField}


def _field_type(t):
    if isinstance(t, str):
        if t not in _TYPES:
            raise ValueError("type must be real or complex")
        return _TYPES[t]
    if not (isinstance(t, type) and issubclass(t, Field)):
        raise TypeError("type must be a subclass of Field")
    return t


class ParticleMesh(object):
    """Geometry, transforms and particle methods of a periodic mesh on
    one torch device.

    Parameters
    ----------
    Nmesh : sequence of int
    BoxSize : float or sequence of float
    dtype : 'f4' or 'f8', or 'c8' or 'c16' for a complex (c2c) mesh,
        whose real fields are complex too
    resampler : window name or ResampleWindow
    device : torch device of every field made from this mesh; default
        the current CUDA device (raises without CUDA: pass 'cpu'), or the
        procmesh's device
    procmesh : None, or a ``parallel.pmesh.ProcessMesh`` (1-d or 2-d):
        fields hold this rank's block on the route its geometry takes
        (``route``, module docstring).
    """

    def __init__(self, Nmesh, BoxSize=1.0, dtype='f8', resampler='cic',
                 device=None, procmesh=None):
        self.Nmesh = np.array(Nmesh, dtype='i8')
        self.ndim = len(self.Nmesh)
        self.BoxSize = np.empty(self.ndim, dtype='f8')
        self.BoxSize[:] = BoxSize
        self.dtype = np.dtype(dtype)
        if self.dtype not in _COMPLEX_OF:
            raise ValueError("dtype must be f8, f4, c16 or c8")
        self._is_c2c = self.dtype.kind == 'c'
        # the dtype of a real field and of a complex one: both complex on
        # a c2c mesh
        self.torch_dtype = _torch_dtype(self.dtype)
        self.complex_dtype = _torch_dtype(_COMPLEX_OF[self.dtype])
        self.procmesh = procmesh
        if procmesh is not None:
            from .parallel.pmesh import ProcessMesh
            if not isinstance(procmesh, ProcessMesh):
                raise TypeError(
                    "procmesh must be a pmesh_tpu_torch.parallel.pmesh."
                    "ProcessMesh, got %r" % (procmesh,))
            if device is not None and not _same_device(
                    resolve_device(device), procmesh.device):
                raise ValueError("device %s is not the procmesh's %s"
                                 % (device, procmesh.device))
            device = procmesh.device
        self.device = resolve_device(device)
        self.resampler = FindResampler(resampler)
        # simulation units -> mesh units; global meshes translate by 0
        self.affine = Affine(self.ndim, translate=0,
                             scale=1.0 * self.Nmesh / self.BoxSize,
                             period=self.Nmesh)
        self.affine_grid = Affine(self.ndim, translate=0, scale=1.0,
                                  period=self.Nmesh)
        self._coords_cache = {}
        self.route = self._route()

    def _route(self):
        """the JAX package's geometry tests (``pmesh_tpu/pm.py:924-960``,
        the same arithmetic) and the route they give (module
        docstring)"""
        self._even_mesh, self._pencil2d, self._uneven1d = True, False, False
        if not self.sharded:
            return 'single'
        if self.ndim < 2:
            raise ValueError(
                "distributed 1-d meshes are not supported (the reference is "
                "also single-rank there); drop procmesh")
        N0, N1 = int(self.Nmesh[0]), int(self.Nmesh[1])
        D = self.procmesh.size
        if self.procmesh.is2d:
            self._even_mesh = False
            self._pencil2d = all(n % s == 0 for n in (N0, N1)
                                 for s in self.procmesh.grid)
            return 'pencil' if self._pencil2d and self.ndim >= 3 \
                else 'replicated'
        self._even_mesh = N0 % D == 0 and N1 % D == 0
        if self._even_mesh:
            return 'slab'
        # the padded slabs must reach across the dead seam within the
        # ring radius
        rows = -(-N0 // D)
        s = self.resampler.support * 0.5
        need = int(np.ceil(s / rows)) + 1 + (D - 1) - (N0 - 1) // rows
        self._uneven1d = need <= max(1, (D - 1) // 2)
        return 'slab' if self._uneven1d else 'replicated'

    @property
    def sharded(self):
        """whether particle arrays are rank-local blocks (a procmesh of
        P > 1 ranks)"""
        return self.procmesh is not None and self.procmesh.size > 1

    @property
    def blocked(self):
        """whether fields are rank-local blocks (the slab and pencil
        routes); on the replicated route every rank holds the whole
        field"""
        return self.route in ('slab', 'pencil')

    def _global_shape(self, field_type):
        if issubclass(field_type, RealField) or self._is_c2c:
            return tuple(int(n) for n in self.Nmesh)
        return tuple(int(n) for n in self.Nmesh[:-1]) \
            + (int(self.Nmesh[-1]) // 2 + 1,)

    def _split(self, field_type):
        """(global shape, split) of a field of ``field_type``: split[d] is
        None for a whole axis d, or (grid axis, chunk): the rank at grid
        coordinate b holds ``[b chunk, (b + 1) chunk)`` of it (module
        docstring)"""
        field_type = _field_type(field_type)
        shape = self._global_shape(field_type)
        split = [None] * self.ndim
        if not self.blocked:
            return shape, split
        grid = self.procmesh.grid

        def chunk(n, a):
            return (a, -(-int(n) // grid[a]))
        transposed = issubclass(field_type, BaseComplexField) and not \
            issubclass(field_type, UntransposedComplexField)
        if self.route == 'slab':
            if transposed:
                # the y blocks of the spectrum are those of N1, also
                # where its y axis is the half spectrum (2-d real meshes)
                split[1] = chunk(self.Nmesh[1], 0)
            else:
                split[0] = chunk(shape[0], 0)
        elif transposed:
            split[1] = chunk(shape[1], 0)
            split[-1] = chunk(shape[-1], 1)
        else:
            # the real field's pencils; the untransposed spectrum's too
            split[0] = chunk(shape[0], 0)
            split[1] = chunk(shape[1], 1)
        return shape, split

    def _block_at(self, field_type, coords):
        """the block of the rank at grid ``coords`` (None: the whole
        field)"""
        from .parallel.pmesh import block_of
        shape, split = self._split(field_type)
        return tuple((0, n) if s is None or coords is None
                     else block_of(n, None, coords[s[0]], s[1])
                     for n, s in zip(shape, split))

    def local_block(self, field_type):
        """the (start, stop) of each axis of this rank's block of a field
        of ``field_type`` (a type string or class), as the route lays it
        out (module docstring); the whole axes on one rank and on the
        replicated route."""
        coords = self.procmesh.coords if self.blocked else None
        return self._block_at(field_type, coords)

    def _coords_of(self, rank):
        grid = self.procmesh.grid
        return (rank,) if len(grid) == 1 else divmod(rank, grid[1])

    def _boxes(self, field_type):
        """every rank's block of a field of ``field_type``, in rank order
        (the whole field for each where the field is not blocked)"""
        if not self.blocked:
            whole = self._block_at(field_type, None)
            return [whole] * (self.procmesh.size if self.sharded else 1)
        return [self._block_at(field_type, self._coords_of(r))
                for r in range(self.procmesh.size)]

    def _owner(self, field_type):
        """owner(index): the rank whose block of a field of
        ``field_type`` holds each point of the per-axis index tensors"""
        _, split = self._split(field_type)
        npy = self.procmesh.grid[-1] if self.procmesh.is2d else 1
        scale = (npy, 1) if self.procmesh.is2d else (1,)

        def owner(index):
            r = torch.zeros_like(index[0])
            for i, s in zip(index, split):
                if s is not None:
                    r = r + torch.div(i, s[1], rounding_mode='floor') \
                        * scale[s[0]]
            return r
        return owner

    def _flat_aligned(self, field_type):
        from .parallel import blocks
        return blocks.aligned(self._boxes(field_type),
                              self._global_shape(_field_type(field_type)))

    def _relayout(self, value, src_type, dst_type):
        """``value``, this rank's block of a field of ``src_type``, as its
        block in the layout of ``dst_type`` (the transposed and
        untransposed spectra differ on a blocked route)"""
        src_type, dst_type = _field_type(src_type), _field_type(dst_type)
        src, dst = self._boxes(src_type), self._boxes(dst_type)
        if src == dst:
            return value
        from .parallel import blocks
        return blocks.redistribute(value, self.procmesh, src, dst)

    def _whole(self, value, field_type, blocked_out=False):
        """the whole global field on every rank, from ``value``, this
        rank's block of a field of ``field_type``: on a blocked route each
        rank's block in place in zeros, summed over the ranks (a
        replicated tensor, whose cotangent each block takes back as
        ``all_reduce``'s identity backward does); handed to rank-local
        data through ``comm.pbroadcast`` when ``blocked_out``"""
        from .parallel.comm import all_reduce, pbroadcast
        if self.blocked:
            whole = value.new_zeros(self._global_shape(
                _field_type(field_type)))
            whole[tuple(slice(lo, hi) for lo, hi
                        in self.local_block(field_type))] = value
            value = all_reduce(whole, self.procmesh, 'sum')
        if blocked_out and self.sharded:
            value = pbroadcast(value, self.procmesh)
        return value

    def _shape_dtype(self, field_type):
        shape = tuple(stop - start
                      for start, stop in self.local_block(field_type))
        dtype = (self.torch_dtype if issubclass(field_type, RealField)
                 else self.complex_dtype)
        return shape, dtype

    def _r2c_value(self, value):
        from .parallel import pfft
        if self.route == 'slab':
            return pfft.r2c(self.procmesh, value, self.Nmesh)
        if self.route == 'pencil':
            return pfft.r2c_pencil(self.procmesh, value, self.Nmesh)
        return _fft.r2c(value)

    def _c2r_value(self, value):
        from .parallel import pfft
        if self.route == 'slab':
            return pfft.c2r(self.procmesh, value, self.Nmesh,
                            self.torch_dtype)
        if self.route == 'pencil':
            return pfft.c2r_pencil(self.procmesh, value, self.Nmesh,
                                   self.torch_dtype)
        return _fft.c2r(value, self.Nmesh, self.torch_dtype)

    def create_coords(self, field_type, return_indices=False):
        """Broadcastable coordinate tensors: positions of a real field,
        wavenumbers of a complex one (in the mesh's real dtype, the
        Nyquist index of every axis taken as -N/2), or indices; on a
        sharded mesh, those of this rank's block (global indices)."""
        field_type = _field_type(field_type)
        iscomplex = issubclass(field_type, BaseComplexField)
        block = self.local_block(field_type)
        key = (iscomplex, block)
        if key not in self._coords_cache:
            x, i = [], []
            fdtype = 'f8' if self.dtype.itemsize >= 8 else 'f4'
            for d, (lo, hi) in enumerate(block):
                # this rank's block of the global coordinates
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
            self._coords_cache[key] = (x, i)
        x, i = self._coords_cache[key]
        return list(i if return_indices else x)

    def _apply_coords(self, field_type, kind):
        coords = self.create_coords(field_type,
                                    return_indices=(kind == 'index'))
        if kind == 'circular':
            coords = [ki * float(L / n) for ki, L, n
                      in zip(coords, self.BoxSize, self.Nmesh)]
        s = xlist(coords)
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

    def resize(self, Nmesh):
        return self.reshape(Nmesh=Nmesh)

    def respawn(self, comm=None, np=None):
        """The same geometry on one device (the JAX package's respawn
        onto a new communicator, which drops the process mesh)."""
        return ParticleMesh(self.Nmesh, self.BoxSize, dtype=self.dtype,
                            resampler=self.resampler, device=self.device)

    def create(self, type=None, value=None, mode=None):
        """A new field of ``type`` ('real', 'complex',
        'transposedcomplex', 'untransposedcomplex' or a Field class;
        ``mode`` is the reference's name for it)."""
        if mode is not None and type is None:
            type = mode
        return _field_type(type)(self, value=value)

    def unravel(self, type, flat):
        """A new field of ``type`` holding the C-ordered ``flat``."""
        r = self.create(type=type)
        r.unravel(flat)
        return r

    # --- particles ---
    def mesh_coordinates(self, dtype=None):
        """The integer coordinates of every mesh point, (prod(Nmesh),
        ndim) in ``dtype`` (default the mesh's), C order; on a sharded
        mesh this rank's rows, block b of them (``_mesh_points``), as
        every particle array is held."""
        if dtype is None:
            dtype = self.dtype
        return self._mesh_points().to(_torch_dtype(dtype))

    def _mesh_points(self):
        """the (n, ndim) int64 indices of this rank's block of the mesh's
        points in C order: block b, [b nl, (b + 1) nl) with nl =
        ceil(npoints / P), as every particle array is held (the whole
        mesh on one device; a slab's own points on an even slab mesh)"""
        total = int(np.prod(self.Nmesh))
        lo, hi = 0, total
        if self.sharded:
            nl = -(-total // self.procmesh.size)
            lo = min(self.procmesh.rank * nl, total)
            hi = min(lo + nl, total)
        flat = torch.arange(lo, hi, device=self.device)
        cols = []
        for n in self.Nmesh[::-1]:
            cols.append(torch.remainder(flat, int(n)))
            flat = torch.div(flat, int(n), rounding_mode='floor')
        return torch.stack(cols[::-1], dim=-1)

    def generate_uniform_particle_grid(self, shift=0.5, dtype=None,
                                       return_id=False):
        """One particle per mesh point at (i + shift) * BoxSize / Nmesh
        (formed in f8, then cast to ``dtype``); with ``return_id`` also
        the C-order id of each (int64).  On a sharded mesh, block b of
        the grid's points in C order (``_mesh_points``)."""
        if dtype is None:
            dtype = self.dtype
        shift = torch.as_tensor(np.broadcast_to(shift, self.ndim).copy(),
                                dtype=torch.float64, device=self.device)
        cell = torch.as_tensor(self.BoxSize / self.Nmesh,
                               dtype=torch.float64, device=self.device)
        isource = self._mesh_points()
        source = ((isource.to(torch.float64) + shift) * cell) \
            .to(_torch_dtype(dtype))
        if not return_id:
            return source
        id = isource[:, 0]
        for i in range(1, self.ndim):
            id = id * int(self.Nmesh[i]) + isource[:, i]
        return source, id

    def decompose(self, pos, smoothing=None, transform=None, kside=None,
                  capacity=None):
        """The domain plan of ``pos``: on one device the trivial
        single-domain Layout, whose exchange and gather are identities;
        on a slab mesh the slab ghost plan of this rank's block of
        particles (``parallel/exchange.decompose``), on a pencil mesh the
        2-d one (``parallel/exchange2d.decompose2d``, ``kside`` a pair),
        in the frame of ``transform``, with its ``kside`` and
        ``capacity``.  On the replicated route the trivial Layout, with
        the JAX package's RuntimeWarning."""
        if smoothing is None:
            smoothing = self.resampler
        try:
            smoothing = FindResampler(smoothing).support * 0.5
        except TypeError:
            pass
        if transform is None:
            transform = self.affine
        if self.route == 'slab':
            from .parallel import exchange
            return exchange.decompose(
                self.procmesh, self._grid(pos, transform, 0),
                int(self.Nmesh[0]), float(smoothing), kside=kside,
                capacity=capacity)
        if self.route == 'pencil':
            from .parallel import exchange2d
            return exchange2d.decompose2d(
                self.procmesh, self._grid(pos, transform, 0),
                self._grid(pos, transform, 1), int(self.Nmesh[0]),
                int(self.Nmesh[1]), float(smoothing), ksides=kside,
                capacity=capacity)
        if self.route == 'replicated':
            import warnings
            warnings.warn(
                "pm.decompose: no sharded particle plan for this geometry "
                "(procmesh %s, Nmesh %s) -- every rank holds the whole mesh, "
                "paints its own particles and sums the meshes over the "
                "ranks; use a mesh whose extents divide the process grid"
                % (self.procmesh.grid, tuple(int(n) for n in self.Nmesh)),
                RuntimeWarning, stacklevel=2)
        return Layout(smoothing=smoothing, npart=len(pos))

    def local_view(self, value):
        """``value``, a mesh every rank holds whole on the replicated
        route, handed to this rank's particles: ``comm.pbroadcast``,
        whose backward sums the mesh's cotangent over the ranks (the
        identity elsewhere)"""
        if not self.sharded or self.blocked:
            return value
        from .parallel.comm import pbroadcast
        return pbroadcast(value, self.procmesh)

    @staticmethod
    def _grid(pos, transform, d):
        """the axis-d grid coordinate of ``pos`` under ``transform``, in
        the positions' dtype"""
        pos = torch.as_tensor(pos)
        return pos[:, d] * torch.as_tensor(float(transform.scale[d]),
                                           dtype=pos.dtype) \
            + torch.as_tensor(float(transform.translate[d]), dtype=pos.dtype)

    def reshard_particles(self, pos, *arrays):
        """Re-sort this rank's particle arrays (``pos`` and ``arrays``,
        rows aligned) into equal-count blocks over the ranks, as
        ``decompose``'s residency wants: in x-plane order on a slab mesh
        (``parallel/exchange.reshard``), in home-pencil order on a pencil
        mesh (``parallel/exchange2d.reshard2d``).  Returns the new
        blocks, ``pos`` first.  On one device and on the replicated
        route, the arguments."""
        if not self.blocked:
            return (pos,) + tuple(arrays) if arrays else pos
        pos = torch.as_tensor(pos)
        return self._reshard(pos, self.affine, pos, *arrays)

    def _reshard(self, pos, transform, *arrays):
        """``arrays`` resharded by the grid coordinates of ``pos`` under
        ``transform`` (the route's reshard)"""
        if self.route == 'slab':
            from .parallel import exchange
            out = exchange.reshard(self.procmesh,
                                   self._grid(pos, transform, 0),
                                   int(self.Nmesh[0]), *arrays)
        else:
            from .parallel import exchange2d
            out = exchange2d.reshard2d(
                self.procmesh, self._grid(pos, transform, 0),
                self._grid(pos, transform, 1), int(self.Nmesh[0]),
                int(self.Nmesh[1]), *arrays)
        return out

    def _unplanned(self, pos, smoothing, transform, *arrays):
        """a copy of this rank's particles resharded and decomposed, for a
        paint or readout given no plan: (layout, pos, arrays, (source
        rank, source row) of each row)"""
        pos = torch.as_tensor(pos)
        n = pos.shape[0]
        src = torch.full((n,), self.procmesh.rank, dtype=torch.int64,
                         device=pos.device)
        row = torch.arange(n, device=pos.device)
        out = self._reshard(pos, transform, pos, src, row, *arrays)
        pos, src, row, arrays = out[0], out[1], out[2], out[3:]
        layout = self.decompose(pos, smoothing=smoothing,
                                transform=transform, capacity='auto')
        return layout, pos, arrays, (src, row)

    def _hsml_reach(self, resampler, hsml, hsml_max):
        """(smoothing, hsml_max) of a paint or readout given no plan: the
        window's half support, times the largest hsml over the ranks"""
        if hsml is None:
            return resampler.support * 0.5, hsml_max
        if hsml_max is None:
            from .parallel.comm import all_reduce
            h = torch.as_tensor(hsml).detach()
            top = h.max().reshape(1) if h.numel() else h.new_zeros(1)
            hsml_max = float(all_reduce(top.to(torch.float64), self.procmesh,
                                        'max')[0])
        return resampler.window.support_float * 0.5 * float(hsml_max), \
            hsml_max

    def _sharded_ops(self):
        """(plan type, sharded paint, sharded readout) of the route"""
        if self.route == 'slab':
            from .parallel import exchange as ex
            return ex.ShardedLayout, ex.paint_sharded, ex.readout_sharded
        from .parallel import exchange2d as ex2
        return (ex2.ShardedLayout2D, ex2.paint_sharded2d,
                ex2.readout_sharded2d)

    def _readout_sharded(self, value, pos, hsml, resampler, transform,
                         gradient, layout, hsml_max):
        """RealField.readout on a slab or pencil mesh (its docstring)"""
        from .parallel import exchange
        plan, _, readout = self._sharded_ops()
        if isinstance(layout, plan):
            return readout(
                layout, value, pos, transform.scale, resampler.window,
                diffdir=gradient, hsml=hsml, hsml_max=hsml_max,
                translate=transform.translate)
        smoothing, hsml_max = self._hsml_reach(resampler, hsml, hsml_max)
        n = torch.as_tensor(pos).shape[0]
        extra = () if hsml is None else (torch.as_tensor(hsml),)
        layout, p, extra, (src, row) = self._unplanned(
            pos, smoothing, transform, *extra)
        vals = readout(
            layout, value, p, transform.scale, resampler.window,
            diffdir=gradient, hsml=extra[0] if extra else None,
            hsml_max=hsml_max, translate=transform.translate)
        return exchange.route(self.procmesh, src, row, n, vals)[0]

    def _paint_sharded(self, pos, hsml, mass, resampler, transform, base,
                       gradient, layout, hsml_max):
        """ParticleMesh.paint on a slab or pencil mesh: this rank's
        block"""
        from .parallel import exchange
        plan, paint, _ = self._sharded_ops()
        if not isinstance(layout, plan):
            smoothing, hsml_max = self._hsml_reach(resampler, hsml,
                                                   hsml_max)
            pos = torch.as_tensor(pos)
            extra = []
            if isinstance(mass, torch.Tensor) and mass.dim() > 0:
                extra.append(mass)
            if hsml is not None:
                extra.append(torch.as_tensor(hsml))
            layout, pos, extra, _ = self._unplanned(pos, smoothing,
                                                    transform, *extra)
            extra = list(extra)
            if isinstance(mass, torch.Tensor) and mass.dim() > 0:
                mass = extra.pop(0)
            if hsml is not None:
                hsml = extra.pop(0)
        return paint(
            layout, pos, mass, tuple(int(n) for n in self.Nmesh),
            transform.scale, resampler.window, diffdir=gradient,
            dtype=torch.empty((), dtype=self.torch_dtype).real.dtype,
            base=base, hsml=hsml, hsml_max=hsml_max,
            translate=transform.translate)

    def paint(self, pos, hsml=None, mass=1.0, resampler=None, transform=None,
              hold=False, gradient=None, layout=None, out=None,
              hsml_max=None):
        """Paint particles to a RealField through the generic paint
        (``ops/paint.py``): a new field, or ``out`` rebound (its value
        added to with ``hold``).  ``hsml`` scales each particle's
        support; ``gradient`` = d paints with the derivative window.

        On a sharded mesh ``pos`` (and an array ``mass`` or ``hsml``) is
        this rank's block of particles and the field this rank's block:
        with a ``ShardedLayout`` (``ShardedLayout2D``) each rank paints
        its slab (pencil) from the images; without one the particles are
        resharded and decomposed first.  On the replicated route each
        rank paints its own particles into the whole mesh, and the meshes
        are summed over the ranks."""
        if transform is None:
            transform = self.affine
        resampler = FindResampler(self.resampler if resampler is None
                                  else resampler)
        if out is None:
            out = self.create(type=RealField)
        base = out.value if hold else None
        if base is not None and self._is_c2c:
            base = base.real
        if self.blocked:
            painted = self._paint_sharded(
                pos, hsml, mass, resampler, transform, base, gradient,
                layout, hsml_max)
            out.value = painted.to(out.dtype)
            return out
        if layout is not None:
            pos = layout.exchange(pos)
            mass = layout.exchange_scalar(mass)
            hsml = layout.exchange_scalar(hsml)
        replicated = self.route == 'replicated'
        zeros = torch.zeros_like(out.value.real if self._is_c2c
                                 else out.value)
        if replicated:
            from .parallel.comm import all_reduce
        painted = _paint_ops.paint(zeros if base is None or replicated
                                   else base, pos, mass=mass,
                                   window=resampler.window,
                                   scale=transform.scale,
                                   translate=transform.translate,
                                   period=transform.period,
                                   diffdir=gradient, hsml=hsml,
                                   hsml_max=hsml_max)
        if replicated:
            painted = all_reduce(painted, self.procmesh, 'sum')
            if base is not None:
                painted = painted + base
        out.value = painted.to(out.dtype)
        return out

    def paint_jvp(self, pos, mass=1.0, v_pos=None, v_mass=None,
                  resampler=None, transform=None, gradient=None, layout=None,
                  out=None):
        """The jvp of ``paint`` along the tangents ``v_pos`` (N, ndim)
        and ``v_mass``: one diffdir-d paint of v_pos[:, d] * mass per
        axis plus the paint of ``v_mass``, a RealField (``out``
        rebound)."""
        if gradient is not None:
            raise ValueError("gradient of gradient is not supported")
        if out is None:
            out = self.create(type=RealField)
        out.value = torch.zeros_like(out.value)
        if v_pos is not None:
            for d in range(pos.shape[1]):
                out = self.paint(pos, mass=v_pos[..., d] * mass,
                                 resampler=resampler, transform=transform,
                                 gradient=d, hold=True, layout=layout,
                                 out=out)
        if v_mass is not None:
            out = self.paint(pos, mass=v_mass, resampler=resampler,
                             transform=transform, gradient=None, hold=True,
                             layout=layout, out=out)
        return out

    def paint_vjp(self, v, pos, mass=1.0, resampler=None, transform=None,
                  gradient=None, out_pos=None, out_mass=None, layout=None):
        """The vjp of ``paint`` against the RealField cotangent ``v``:
        ((N, ndim) mass times each diffdir readout of v, the readout of
        v).  ``out_pos`` or ``out_mass`` False skips that part."""
        if out_pos is not False:
            if gradient is not None:
                raise ValueError("gradient of gradient is not supported")
            out_pos = torch.stack(
                [v.readout(pos, resampler=resampler, transform=transform,
                           gradient=d, layout=layout) * mass
                 for d in range(pos.shape[1])], dim=-1)
        if out_mass is not False:
            out_mass = v.readout(pos, resampler=resampler,
                                 transform=transform, gradient=gradient,
                                 layout=layout)
        return out_pos, out_mass

    def upsample(self, source, resampler=None, keep_mean=False):
        """``source`` (a RealField of another mesh) read out at this
        mesh's points; scaled by the ratio of the cell volumes unless
        ``keep_mean``."""
        if not isinstance(source, RealField):
            raise TypeError("source must be a RealField")
        q = self.mesh_coordinates(dtype=self.dtype)
        transform = Affine(self.ndim, translate=0,
                           scale=1.0 * source.Nmesh / self.Nmesh,
                           period=source.Nmesh)
        f = source.readout(q, resampler=resampler, transform=transform)
        if not keep_mean:
            f = f * float((source.pm.Nmesh.prod() / source.pm.BoxSize.prod())
                          / (self.Nmesh.prod() / self.BoxSize.prod()))
        return self.paint(q, mass=f, resampler='nnb',
                          transform=self.affine_grid)

    def downsample(self, source, resampler=None, keep_mean=False):
        """``source`` (a RealField of another mesh) painted onto this
        mesh point by point; divided by the ratio of the cell volumes
        with ``keep_mean``."""
        if not isinstance(source, RealField):
            raise TypeError("source must be a RealField")
        q = source.pm.mesh_coordinates(dtype=self.dtype)
        f = source.readout(q, resampler='nnb',
                           transform=source.pm.affine_grid)
        transform = self.affine_grid.rescale(1.0 * self.Nmesh / source.Nmesh)
        if keep_mean:
            f = f / float((source.pm.Nmesh.prod() / source.pm.BoxSize.prod())
                          / (self.Nmesh.prod() / self.BoxSize.prod()))
        return self.paint(q, mass=f, resampler=resampler,
                          transform=transform)

    def generate_whitenoise(self, seed, unitary=False, mean=0,
                            type=ComplexField, mode=None, compat='gadget'):
        """Resolution-invariant hermitian white noise
        (``whitenoise.py``): compat='gadget' reproduces N-GenIC's modes
        bit for bit (a host fill, moved to the device), compat='native'
        is the counter-based generator on the device, bitwise the JAX
        package's under x64.  The DC mode is ``mean``; the field is cast
        to ``type``."""
        from . import whitenoise
        if mode is not None and type is None:
            type = mode
        type = _field_type(type)
        complex_type = (UntransposedComplexField
                        if issubclass(type, RealField) else type)
        start = None
        if self.blocked:
            # each rank fills only its own block of the transposed
            # spectrum; a real field is their c2r
            complex_type = TransposedComplexField \
                if complex_type is UntransposedComplexField else complex_type
            start = tuple(lo for lo, _ in self.local_block(complex_type))
        shape, dtype = self._shape_dtype(complex_type)
        value = whitenoise.generate(
            tuple(int(n) for n in self.Nmesh), shape, seed, bool(unitary),
            dtype=dtype, compat=compat, start=start, device=self.device)
        complex = self.create(type=complex_type, value=value)

        def filter(k, v):
            mask = functools.reduce(torch.logical_and,
                                    [ki == 0 for ki in k])
            return torch.where(mask, mean, v)
        complex.apply(filter, out=Ellipsis)
        return complex.cast(type=type)


# the complex dtype of each mesh dtype
_COMPLEX_OF = {np.dtype('f4'): np.dtype('c8'), np.dtype('f8'): np.dtype('c16'),
               np.dtype('c8'): np.dtype('c8'),
               np.dtype('c16'): np.dtype('c16')}


def _torch_dtype(dtype):
    return {np.dtype('f4'): torch.float32, np.dtype('f8'): torch.float64,
            np.dtype('c8'): torch.complex64,
            np.dtype('c16'): torch.complex128,
            np.dtype('i4'): torch.int32,
            np.dtype('i8'): torch.int64}[np.dtype(dtype)]


def build_index(indices, fullshape):
    """The C-order linear index (int64 numpy) of every combination of
    the per-axis ``indices`` in an array of ``fullshape``; -1 where any
    axis index is -1."""
    localshape = [len(i) for i in indices]
    ndim = len(localshape)
    ind = np.zeros(localshape, dtype='i8')
    mask = np.zeros(localshape, dtype='?')
    for d in range(ndim):
        i = np.asarray(indices[d]).reshape(
            [-1 if dd == d else 1 for dd in range(ndim)])
        ind[...] *= fullshape[d]
        ind[...] += i
        mask |= i == -1
    ind[mask] = -1
    return ind


def reindex(Nsrc, Ndest):
    """The index of each mode of an Ndest mesh in an Nsrc mesh, -1
    where the Nsrc mesh has no such mode."""
    reindex = np.arange(Ndest)
    reindex[Ndest // 2 + 1:] = np.arange(Nsrc - Ndest // 2 + 1, Nsrc, 1)
    reindex[Nsrc // 2 + 1: Ndest - Nsrc // 2 + 1] = -1
    return reindex
