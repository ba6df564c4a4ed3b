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

:func:`route` decides between them, as the JAX package's gate does
(``pmesh_tpu/ops/gridpm.py:172``): with ``impl=None`` a 3-d mesh on a
CUDA device goes to the kernels, whatever its dtype (they take f32,
bf16 and f64, and refuse any other), and every other mesh (a CPU tensor,
or a 2-d mesh, for which the JAX package has no Pallas kernel and runs
XLA) to the plain version; ``impl='cuda'`` on a 2-d mesh raises.  A
failed build or launch raises and is never replaced by the plain
version.

Reverse mode: ``paint_grid`` and ``readout_grid`` (without ``diffdir``)
are ``torch.autograd.Function``s whose backward is the JAX package's
custom vjp (``pmesh_tpu/ops/gridpm.py:376-443``), computed by the same
implementation as the forward, so on the card the backward launches the
paint and readout kernels:

- paint: mass_bar = readout of v_bar (summed for a scalar mass),
  s_bar_d = mass * (the diffdir-d readout of v_bar);
- readout: mesh_bar = the paint of each v_bar with the displacements,
  s_bar_d = sum over meshes of v_bar * (the diffdir-d readout).

A diffdir paint or readout has no such rule: on the CPU the plain roll
version differentiates natively, as the JAX package's XLA version does;
on CUDA tensors that require grad it raises, as the JAX package's Pallas
kernels have no autodiff rule (``pmesh_tpu/ops/gridpm.py:482-486``).
The CUDA wrappers themselves refuse tensors that require grad.

Slab-sharded meshes (``procmesh`` of P > 1 ranks, the JAX package's
``_shift_sharded``): every rank holds its x slab of the displacements
and meshes.  The x window reaches ``lo``/``hi`` planes into the ring
neighbours' slabs, which ``parallel/halo.extend_x`` fetches (any depth,
so the deep-window case is the same code); the x-halo slab form of the
kernels then reads the extended slab and writes the rank's rows with no
x wrap.  The plain versions run the roll loop on the extended slab and
keep the middle rows (``paint_slab_plain``, ``readout_slab_plain``).
Reverse mode runs through the sharded path too, with the convention of
``parallel/comm.py``: ``_Paint`` and ``_Readout`` take the procmesh, and
their backward is the sharded readouts and paints that the JAX
package's custom vjp calls (``pmesh_tpu/ops/gridpm.py:391-443``), so on
the card it launches the x-halo kernels; the halo's transpose returns
each halo plane's cotangent to its owner.  A scalar mass tensor is
replicated: it meets the rank's slab through ``comm.pbroadcast``, so its
gradient is summed over the ranks.  A diffdir paint or readout follows
the one-device rule: the plain slab form differentiates natively on the
CPU (through the halo), the kernels refuse.
"""
import numpy as np
import torch

from .kernels import find_window

__all__ = ["paint_grid", "readout_grid", "offset_range", "route",
           "displacement_bounds", "GRID_LIMIT", "paint_slab_plain",
           "readout_slab_plain"]

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


def _route(impl, device, ndim, gate):
    device = torch.device(device)
    if impl not in (None, 'torch', 'cuda'):
        raise ValueError("impl must be None, 'torch' or 'cuda' (got %r)"
                         % (impl,))
    if impl == 'torch':
        return 'torch'
    if impl == 'cuda':
        if device.type != 'cuda':
            raise ValueError("impl='cuda' needs CUDA tensors (got %s)"
                             % device)
        if ndim != 3:
            raise NotImplementedError(
                "impl='cuda': the CUDA kernels take 3-d meshes, as the JAX "
                "package's Pallas kernels do (%s); a %d-d mesh runs the "
                "plain version (impl=None or 'torch')" % (gate, ndim))
        return 'cuda'
    return 'cuda' if device.type == 'cuda' and ndim == 3 else 'torch'


def route(impl, device, ndim):
    """'cuda' (the hand kernels) or 'torch' (the plain version) for a
    lattice paint or readout of an ``ndim``-d mesh on ``device``: the JAX
    package's gate (``pmesh_tpu/ops/gridpm.py:172``) with the device in
    place of the backend.  ``impl=None``: the kernels for a 3-d mesh on a
    CUDA device, whatever its dtype (the kernels take f32, bf16 and f64
    and refuse the others: no dtype reaches the plain version on the card
    unless asked), the plain version for a CPU mesh or a 2-d one;
    ``impl='torch'``: the plain version; ``impl='cuda'``: the kernels,
    raising for a CPU device (ValueError) or a 2-d mesh
    (NotImplementedError)."""
    return _route(impl, device, ndim, "pmesh_tpu/ops/gridpm.py:172")


def _use_cuda(impl, t, ndim):
    return route(impl, t.device, ndim) == 'cuda'


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

    if _use_cuda(impl, disp[0], ndim):
        from . import gridpm_cuda as _k
        if mode == 'paint':
            return _k.paint_lattice(disp, mass, vmin, vmax, win,
                                    diffdir=diffdir)
        return _readout_launches(_k, meshes, disp, vmin, vmax, win, diffdir)

    if diffdir == 'all' and mode == 'readout':
        return tuple(_shift_loop(meshes[:1], disp, None, bounds, win, d,
                                 mode, impl)[0]
                     for d in range(ndim))

    # a sub-32-bit storage (bf16) is computed in f32 and each output
    # rounded once, as the TPU kernels (_cdtype) and the CUDA kernels do
    store = dtype
    if dtype.itemsize < 4:
        dtype = torch.float32
        disp = tuple(d.to(dtype) for d in disp)
        if isinstance(mass, torch.Tensor):
            mass = mass.to(dtype)
        if meshes is not None:
            meshes = tuple(m.to(dtype) for m in meshes)

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
        return out.to(store)

    outs = [torch.zeros(shape, dtype=dtype, device=disp[0].device)
            for _ in meshes]
    for vvec in offsets:
        w = weights(vvec)
        neg = tuple(-v for v in vvec)
        outs = [o + w * torch.roll(m, neg, axes)
                for o, m in zip(outs, meshes)]
    return tuple(o.to(store) for o in outs)


def _readout_launches(k, meshes, disp, vmin, vmax, win, diffdir, xbase=None):
    """the readout kernel over ``meshes``: one launch for up to three
    meshes, which share the displacements and the weights.  The JAX
    package issues one call per mesh because on v5e a multi-mesh call's
    larger VMEM working set pipelined worse
    (``pmesh_tpu/ops/gridpm_pallas.py:482-486``); on the card the staged
    tile of three meshes fits shared memory with room to spare, and one
    launch reads the displacements and forms the weights once instead of
    three times."""
    if diffdir == 'all':
        return k.readout_lattice(meshes[:1], disp, vmin, vmax, win,
                                 diffdir='all', xbase=xbase)
    return sum((k.readout_lattice(meshes[i:i + 3], disp, vmin, vmax, win,
                                  diffdir=diffdir, xbase=xbase)
                for i in range(0, len(meshes), 3)), ())


def _sharded(procmesh):
    return procmesh is not None and procmesh.size > 1


def paint_slab_plain(disp_ext, mass_ext, lo, rows, bounds, window,
                     diffdir=None):
    """Plain x-halo slab paint: the roll loop on the extended slab
    (displacements and mesh mass of lo + rows + hi planes, the window's
    reach ``lo`` >= v_max and hi >= -v_min), rows [lo, lo + rows) kept:
    no roll there wraps."""
    out = _shift_loop(None, disp_ext, mass_ext, bounds, window, diffdir,
                      'paint', impl='torch')
    return out[lo:lo + rows]


def readout_slab_plain(meshes_ext, disp, lo, bounds, window, diffdir=None):
    """Plain x-halo slab readout: the meshes hold lo + rows + hi planes
    (lo >= -v_min, hi >= v_max) about the ``rows`` planes of ``disp``;
    the displacements are padded to the extended slab with zeros, the
    roll loop runs there and rows [lo, lo + rows) are kept."""
    rows = disp[0].shape[0]
    n_in = meshes_ext[0].shape[0]
    pad = [(torch.zeros((lo,) + d.shape[1:], dtype=d.dtype, device=d.device),
            torch.zeros((n_in - lo - rows,) + d.shape[1:], dtype=d.dtype,
                        device=d.device)) for d in disp]
    dext = tuple(torch.cat([a, d, b], 0) for d, (a, b) in zip(disp, pad))
    outs = _shift_loop(tuple(meshes_ext), dext, None, bounds, window,
                       diffdir, 'readout', impl='torch')
    return tuple(o[lo:lo + rows] for o in outs)


def _shift_sharded(meshes, disp, mass, bounds, window, diffdir, mode,
                   procmesh, impl):
    """The shift-sum over the x slabs of ``procmesh``: extend the inputs
    by the window's x reach from the ring neighbours, then the x-halo
    form of the kernels (CUDA tensors) or the plain loop on the extended
    slab."""
    from ..parallel.halo import extend_x
    win = find_window(window)
    vmin, vmax = offset_range(float(bounds[0]), float(bounds[1]), win)
    rows = disp[0].shape[0]
    cuda = _use_cuda(impl, disp[0], len(disp))
    if mode == 'paint':
        # output row i gathers source rows i - v_x, v_x in [vmin, vmax]
        lo, hi = max(0, vmax), max(0, -vmin)
        dext = tuple(extend_x(d, lo, hi, procmesh) for d in disp)
        mesh_mass = isinstance(mass, torch.Tensor) and mass.dim() > 0
        mext = extend_x(mass, lo, hi, procmesh) if mesh_mass else mass
        if cuda:
            from . import gridpm_cuda as _k
            return _k.paint_lattice(dext, mext, vmin, vmax, win,
                                    diffdir=diffdir, rows=rows, xbase=lo)
        return paint_slab_plain(dext, mext, lo, rows, bounds, win, diffdir)
    # particle row i reads mesh rows i + v_x
    lo, hi = max(0, -vmin), max(0, vmax)
    mext = tuple(extend_x(m, lo, hi, procmesh) for m in meshes)
    if not cuda:
        return readout_slab_plain(mext, disp, lo, bounds, win, diffdir)
    from . import gridpm_cuda as _k
    return _readout_launches(_k, mext, disp, vmin, vmax, win, diffdir,
                             xbase=lo)


def _detached(t):
    return t.detach() if isinstance(t, torch.Tensor) else t


def _tracks(tensors):
    """whether autograd records an op on ``tensors``"""
    return torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in tensors)


def _no_kernel_rule(what, impl, disp):
    if _use_cuda(impl, disp[0], len(disp)):
        raise NotImplementedError(
            "%s: gradients through a diffdir paint or readout have no rule "
            "on the CUDA kernels, as the JAX package's Pallas kernels have "
            "none (pmesh_tpu/ops/gridpm.py:482-486); differentiate it on "
            "the CPU (impl='torch')" % what)


def _shift(meshes, disp, mass, bounds, window, diffdir, mode, impl,
           procmesh):
    """the shift-sum on one device, or over the slabs of ``procmesh``"""
    if procmesh is not None:
        return _shift_sharded(meshes, disp, mass, bounds, window, diffdir,
                              mode, procmesh, impl)
    return _shift_loop(meshes, disp, mass, bounds, window, diffdir, mode,
                       impl)


class _Paint(torch.autograd.Function):
    """paint with the JAX package's custom vjp (``_paint_bwd``);
    ``mass`` is a tensor (a mesh or 0-d) or None, ``cfg`` = (bounds,
    window, impl, scalar mass used when ``mass`` is None, procmesh or
    None)."""

    @staticmethod
    def forward(ctx, cfg, mass, *disp):
        bounds, window, impl, scalar, pmh = cfg
        ctx.cfg = cfg
        ctx.save_for_backward(mass, *disp)
        m = scalar if mass is None else mass.detach()
        return _shift(None, tuple(d.detach() for d in disp), m, bounds,
                      window, None, 'paint', impl, pmh)

    @staticmethod
    def backward(ctx, v):
        bounds, window, impl, scalar, pmh = ctx.cfg
        mass, *disp = ctx.saved_tensors
        disp = tuple(d.detach() for d in disp)
        v = v.detach().contiguous()
        mass_bar = None
        if ctx.needs_input_grad[1]:
            mb = _shift((v,), disp, None, bounds, window, None, 'readout',
                        impl, pmh)[0]
            mass_bar = (mb if mass.dim() > 0 else mb.sum()).to(mass.dtype)
        disp_bar = [None] * len(disp)
        if any(ctx.needs_input_grad[2:]):
            rds = _shift((v,), disp, None, bounds, window, 'all', 'readout',
                         impl, pmh)
            m = scalar if mass is None else mass.detach().to(v.dtype)
            disp_bar = [m * r for r in rds]
        return (None, mass_bar) + tuple(disp_bar)


class _Readout(torch.autograd.Function):
    """readout of ``nmesh`` meshes with the JAX package's custom vjp
    (``_readout_bwd``); ``tensors`` = meshes + disp, ``cfg`` = (bounds,
    window, impl, procmesh or None)."""

    @staticmethod
    def forward(ctx, cfg, nmesh, *tensors):
        bounds, window, impl, pmh = cfg
        ctx.cfg, ctx.nmesh = cfg, nmesh
        ctx.save_for_backward(*tensors)
        det = tuple(t.detach() for t in tensors)
        return _shift(det[:nmesh], det[nmesh:], None, bounds, window, None,
                      'readout', impl, pmh)

    @staticmethod
    def backward(ctx, *vbar):
        bounds, window, impl, pmh = ctx.cfg
        nmesh = ctx.nmesh
        saved = tuple(t.detach() for t in ctx.saved_tensors)
        meshes, disp = saved[:nmesh], saved[nmesh:]
        vbar = tuple(v.detach().contiguous() for v in vbar)
        need = ctx.needs_input_grad[2:]
        mesh_bar = tuple(
            _shift(None, disp, vb, bounds, window, None, 'paint', impl, pmh)
            if need[j] else None for j, vb in enumerate(vbar))
        disp_bar = []
        for d in range(len(disp)):
            if not need[nmesh + d]:
                disp_bar.append(None)
                continue
            rds = _shift(meshes, disp, None, bounds, window, d, 'readout',
                         impl, pmh)
            acc = None
            for vb, rd in zip(vbar, rds):
                acc = vb * rd if acc is None else acc + vb * rd
            disp_bar.append(acc)
        return (None, None) + mesh_bar + tuple(disp_bar)


def paint_grid(disp, mass=None, bounds=(0.0, 1.0), window='cic',
               diffdir=None, impl=None, procmesh=None):
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
    procmesh : None, or the ProcessMesh whose x slabs ``disp`` and
        ``mass`` are (module docstring)

    Differentiable in ``disp`` and a tensor ``mass`` (module docstring),
    on one rank and on the slabs.
    """
    disp = tuple(disp)
    pmh = procmesh if _sharded(procmesh) else None
    if pmh is not None and isinstance(mass, torch.Tensor):
        mass = mass.to(disp[0].dtype)
    if not _tracks(disp + (mass,)):
        m = _detached(mass)
        return _shift(None, tuple(_detached(d) for d in disp),
                      1.0 if m is None and pmh is not None else m, bounds,
                      window, diffdir, 'paint', impl, pmh)
    if diffdir is not None:
        _no_kernel_rule("paint_grid", impl, disp)
        return _shift(None, disp,
                      1.0 if mass is None and pmh is not None else mass,
                      bounds, window, diffdir, 'paint', impl, pmh)
    bounds = (float(bounds[0]), float(bounds[1]))
    if isinstance(mass, torch.Tensor):
        if pmh is not None and mass.dim() == 0:
            from ..parallel.comm import pbroadcast
            mass = pbroadcast(mass, pmh)
        return _Paint.apply((bounds, window, impl, None, pmh), mass, *disp)
    scalar = 1.0 if mass is None else float(mass)
    return _Paint.apply((bounds, window, impl, scalar, pmh), None, *disp)


def readout_grid(mesh, disp, bounds=(0.0, 1.0), window='cic',
                 diffdir=None, impl=None, procmesh=None):
    """Read one mesh (or a tuple of meshes, sharing the weights) at the
    displaced lattice sites.

    ``diffdir`` = d reads with -W' along axis d: the derivative of the
    interpolated field with respect to the particle position (in CELL
    units).  ``diffdir='all'`` takes one mesh and returns the tuple of
    all ndim derivative readouts.  Differentiable in the meshes and
    ``disp`` (module docstring).
    """
    single = not isinstance(mesh, (tuple, list))
    meshes = (mesh,) if single else tuple(mesh)
    disp = tuple(disp)
    if diffdir == 'all' and len(meshes) != 1:
        raise ValueError("diffdir='all' takes exactly one mesh")
    pmh = procmesh if _sharded(procmesh) else None
    if not _tracks(meshes + disp):
        out = _shift(tuple(_detached(m) for m in meshes),
                     tuple(_detached(d) for d in disp), None, bounds, window,
                     diffdir, 'readout', impl, pmh)
    elif diffdir is not None:
        _no_kernel_rule("readout_grid", impl, disp)
        out = _shift(meshes, disp, None, bounds, window, diffdir, 'readout',
                     impl, pmh)
    else:
        cfg = ((float(bounds[0]), float(bounds[1])), window, impl, pmh)
        out = _Readout.apply(cfg, len(meshes), *meshes, *disp)
    if diffdir == 'all':
        return tuple(out)
    return out[0] if single else tuple(out)
