"""Lattice-structured paint/readout: the N-body fast path.

Counterpart of ``pmesh_tpu/ops/gridpm.py``.  Particles are born on the
mesh lattice and keep lattice order, so the state is a per-axis
mesh-shaped displacement ``s`` (in cells) and a window paint of all
particles decomposes over the integer target offsets ``v``::

    mesh[p] = sum_q m(q) prod_d K(v_d - s_d(q)),   v = p - q
            = sum_v roll(m * prod_d K(v_d - s_d), v)

``readout`` is the mirror image with inverse rolls.  Offsets span
``offset_range(bounds)``; displacements outside ``bounds`` lose mass,
so callers validate them (``displacement_bounds``), and more than
``GRID_LIMIT`` offsets raise.

Two implementations, chosen per call by ``impl``:

- the plain version (``impl='torch'``): the roll-accumulate loop above
  in PyTorch, the counterpart of the JAX package's ``impl='xla'``;
- the hand CUDA kernels (``impl='cuda'``, ``ops/gridpm_cuda.py``), the
  counterpart of its Pallas kernels.

``impl=None`` takes the kernels for CUDA tensors and the plain version
for CPU tensors.  The kernels take 3-d f32 meshes; anything else on a
CUDA tensor raises there.  A failed build or launch raises and is
never replaced by the plain version.  Gradients flow through the plain
version only (autograd); the kernels refuse tensors that require grad.
"""
import numpy as np
import torch

from .kernels import find_window

__all__ = ["paint_grid", "readout_grid", "offset_range",
           "displacement_bounds", "GRID_LIMIT"]

# the lattice path refuses more shift passes than this
GRID_LIMIT = 1728  # 12^3


def offset_range(lo, hi, window):
    """Integer target offsets [vmin, vmax] that can receive weight from
    a displacement in [lo, hi] through ``window`` (support/2 reach)."""
    win = find_window(window)
    h = win.support / 2.0
    eps = 1e-6
    vmin = int(np.floor(lo - h + eps)) + 1
    vmax = int(np.ceil(hi + h - eps)) - 1
    if vmax < vmin:
        vmax = vmin
    return vmin, vmax


def displacement_bounds(disp):
    """(min, max) over all displacement components, as 0-d tensors on
    the displacements' device (no host sync)."""
    lo = disp[0].min()
    hi = disp[0].max()
    for s in disp[1:]:
        lo = torch.minimum(lo, s.min())
        hi = torch.maximum(hi, s.max())
    return lo, hi


def _axis_weight(win, diff, v, s):
    # weight of target offset v for displacement s along one axis; the
    # diff kernel -W'(v - s) is +d/ds of the interpolation
    x = v - s
    return -win.diff(x) if diff else win.kernel(x)


def _decode(i, nvs):
    out = []
    rem = i
    for n in reversed(nvs):
        out.append(rem % n)
        rem = rem // n
    return tuple(reversed(out))


def _use_cuda(impl, t):
    if impl is None:
        return t.is_cuda
    if impl == 'cuda':
        if not t.is_cuda:
            raise ValueError("impl='cuda' needs CUDA tensors (got %s)"
                             % t.device)
        return True
    if impl == 'torch':
        return False
    raise ValueError("impl must be None, 'torch' or 'cuda' (got %r)"
                     % (impl,))


def _shift_loop(meshes, disp, mass, bounds, window, diffdir, mode,
                impl=None):
    """The shift-sum loop shared by paint and readout.

    mode='paint':   sum_v roll(w_v * mass, +v) (meshes is None)
    mode='readout': tuple(sum_v w_v * roll(m, -v) for m in meshes), or
                    the ndim derivative readouts of meshes[0] for
                    diffdir='all'
    """
    win = find_window(window)
    ndim = len(disp)
    vmin, vmax = offset_range(float(bounds[0]), float(bounds[1]), win)
    nv = vmax - vmin + 1
    nvs = (nv,) * ndim
    total = nv ** ndim
    if total > GRID_LIMIT:
        raise ValueError(
            "offset volume %d exceeds GRID_LIMIT=%d; displacements too "
            "large for the lattice path" % (total, GRID_LIMIT))
    dtype = disp[0].dtype
    shape = disp[0].shape
    if mass is None:
        mass = 1.0
    if isinstance(mass, torch.Tensor):
        mass = mass.to(dtype)

    if _use_cuda(impl, disp[0]):
        from . import gridpm_cuda as _k
        if mode == 'paint':
            return _k.paint_lattice(disp, mass, vmin, vmax, win,
                                    diffdir=diffdir)
        if diffdir == 'all':
            return _k.readout_lattice(meshes[:1], disp, vmin, vmax, win,
                                      diffdir='all')
        # one launch per mesh, as the JAX package issues on the TPU
        return tuple(_k.readout_lattice((m,), disp, vmin, vmax, win,
                                        diffdir=diffdir)[0]
                     for m in meshes)

    if diffdir == 'all' and mode == 'readout':
        return tuple(_shift_loop(meshes[:1], disp, None, bounds, win, d,
                                 mode, impl)[0]
                     for d in range(ndim))

    def weights(vvec):
        w = None
        for d in range(ndim):
            wd = _axis_weight(win, diffdir == d, vvec[d], disp[d])
            w = wd if w is None else w * wd
        return w.to(dtype)

    axes = tuple(range(ndim))
    offsets = [tuple(vmin + o for o in _decode(i, nvs))
               for i in range(total)]

    if mode == 'paint':
        out = torch.zeros(shape, dtype=dtype, device=disp[0].device)
        for vvec in offsets:
            out = out + torch.roll(weights(vvec) * mass, vvec, axes)
        return out

    outs = [torch.zeros(shape, dtype=dtype, device=disp[0].device)
            for _ in meshes]
    for vvec in offsets:
        w = weights(vvec)
        neg = tuple(-v for v in vvec)
        outs = [o + w * torch.roll(m, neg, axes)
                for o, m in zip(outs, meshes)]
    return tuple(outs)


def paint_grid(disp, mass=None, bounds=(0.0, 1.0), window='cic',
               diffdir=None, impl=None):
    """Paint lattice particles displaced by ``disp`` onto their own mesh.

    Parameters
    ----------
    disp : tuple of ndim tensors, each of the mesh shape
        per-axis displacement from the home cell, in CELL units.
    mass : None (1), a scalar, or a mesh-shaped tensor
    bounds : (lo, hi) floats: static displacement bounds in cells.
        Out-of-bounds displacements silently lose mass; validate with
        :func:`displacement_bounds`.
    diffdir : None, or the axis whose window is replaced by -W'
    impl : None, 'torch' or 'cuda' (see the module docstring)
    """
    return _shift_loop(None, tuple(disp), mass, bounds, window, diffdir,
                       'paint', impl)


def readout_grid(mesh, disp, bounds=(0.0, 1.0), window='cic',
                 diffdir=None, impl=None):
    """Read one mesh (or a tuple of meshes, sharing the weights) at the
    displaced lattice sites.

    ``diffdir`` = d reads with -W' along axis d: the derivative of the
    interpolated field with respect to the particle position (in CELL
    units).  ``diffdir='all'`` takes one mesh and returns the tuple of
    all ndim derivative readouts.
    """
    single = not isinstance(mesh, (tuple, list))
    meshes = (mesh,) if single else tuple(mesh)
    if diffdir == 'all':
        if len(meshes) != 1:
            raise ValueError("diffdir='all' takes exactly one mesh")
        return _shift_loop(meshes, tuple(disp), None, bounds, window,
                           'all', 'readout', impl)
    out = _shift_loop(meshes, tuple(disp), None, bounds, window, diffdir,
                      'readout', impl)
    return out[0] if single else out
