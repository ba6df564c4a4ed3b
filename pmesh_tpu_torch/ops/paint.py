"""The generic particle <-> mesh resampling: paint and readout of
arbitrary particle positions through any of the 24 windows.

Counterpart of ``pmesh_tpu/ops/paint.py``.  Every particle's S^ndim
stencil (S the window's support in cells, or the support scaled by the
particle's ``hsml``) is evaluated one stencil offset at a time: the
per-axis weights and wrapped target indices are formed once, and each
offset adds one flat index and one weight per particle.  The paint
commits an offset with ``index_add_`` and the readout with a gather, so
about one (N,) index buffer is live at a time, as the JAX package
sequences its offsets above ``_SEQUENTIAL_N`` particles.  A target
index outside the mesh (a non-periodic axis, or a particle outside the
mesh) points at one sentinel element past the flat mesh, which is
sliced off the paint and reads 0: the JAX package's ``mode='drop'`` and
``mode='fill'``.

The JAX package paints here with an XLA scatter-add, not a Pallas
kernel, so this module has no hand kernel: on the card the same torch
calls run on CUDA tensors (``index_add_``'s float atomics sum in an
arbitrary order, so a paint on the card agrees with the CPU to rounding,
not bitwise).

Derivatives: ``paint`` and ``readout`` are ``torch.autograd.Function``s
carrying the JAX package's ``custom_jvp`` rules
(``pmesh_tpu/ops/paint.py:384-460``) as their ``jvp`` (forward mode:
``torch.func.jvp``, ``torch.autograd.forward_ad``) and those rules'
transposes as their ``backward``:

- paint: d_out = d_mesh + the paint of d_mass + sum over d of the
  diffdir-d paint of mass * d_pos[:, d]; transposed, mesh_bar = v,
  mass_bar = readout of v (summed for a scalar mass), pos_bar[:, d] =
  mass * (the diffdir-d readout of v);
- readout: d_out = the readout of d_mesh + sum over d of d_pos[:, d] *
  (the diffdir-d readout); transposed, mesh_bar = the paint of each
  v_bar at the particles (with the readout's own diffdir), pos_bar[:, d]
  = sum over meshes of v_bar * (the diffdir-d readout).

A diffdir-d weight is W'(x) times the affine scale, so the position
derivatives come out in the units of ``pos``.  Either rule raises for
a position tangent of a diffdir paint or readout ("gradient of
gradient"), as in the JAX package, whose rule sees an instantiated zero
tangent there even when only the mesh or mass has one.  The backward is
itself made of differentiable torch ops on the saved inputs, so a
second derivative (``torch.func.jvp`` of ``torch.func.grad``, or a
double backward) differentiates it natively, as JAX differentiates the
transposed rule.  ``hsml`` takes no derivative.
"""
import itertools

import numpy as np
import torch

from .kernels import find_window

__all__ = ["paint", "readout", "PaintGeometry"]


class PaintGeometry(object):
    """Static geometry of a paint/readout call: window, mesh shape,
    affine (scale, translate, period), diffdir and, with per-particle
    ``hsml``, the stencil size."""

    def __init__(self, window, shape, scale, translate, period, diffdir=None,
                 hsml_support=None):
        self.window = find_window(window)
        self.shape = tuple(int(n) for n in shape)
        self.ndim = len(self.shape)
        self.scale = tuple(float(s) for s in np.broadcast_to(scale, self.ndim))
        self.translate = tuple(
            float(t) for t in np.broadcast_to(translate, self.ndim))
        self.period = tuple(
            int(p) for p in np.broadcast_to(period, self.ndim))
        self.diffdir = diffdir
        self.hsml_support = hsml_support

    def with_diffdir(self, diffdir):
        return PaintGeometry(self.window, self.shape, self.scale,
                             self.translate, self.period, diffdir,
                             self.hsml_support)


def _window_params(geom):
    """(support, its ceiling S, left reach, shift, native/support)"""
    w = geom.window
    s_float = w.support_float
    isupport = int(np.ceil(s_float))
    left = (isupport - 1) // 2
    shift = s_float / 2.0 - isupport // 2
    return s_float, isupport, left, shift, w.nativesupport / s_float


def _fill_base(geom, pos, hsml):
    """Per-axis base indices (int64) and fractional offsets of every
    particle, and the window scaling: (ipos, dxs, vfac, isup, S);
    vfac and isup are per particle with ``hsml``."""
    w = geom.window
    dtype = pos.dtype
    s_float, isupport, left, shift, vfactor = _window_params(geom)
    if hsml is not None:
        # the stencil is sized for the largest hsml; offsets beyond a
        # particle's own support weigh 0
        hsml = torch.as_tensor(hsml, dtype=dtype, device=pos.device)
        sp = s_float * hsml
        isup = torch.clamp(torch.ceil(sp).to(torch.int64), min=1)
        left_p = torch.div(isup - 1, 2, rounding_mode='floor')
        shift_p = sp / 2.0 - torch.div(isup, 2, rounding_mode='floor')
        vfac = w.nativesupport / sp
        S = geom.hsml_support
    else:
        isup = None
        vfac = vfactor
        S = isupport
    ipos, dxs = [], []
    for d in range(geom.ndim):
        gd = pos[:, d] * geom.scale[d] + geom.translate[d]
        if hsml is not None:
            ip = (torch.floor(gd + shift_p) - left_p).to(torch.int64)
        else:
            ip = torch.floor(gd + shift).to(torch.int64) - left
        ipos.append(ip)
        dxs.append((gd - ip).to(dtype))
    return ipos, dxs, vfac, isup, S


def _kweight(geom, dx_d, d, i, vfac, isup):
    """Window weight of stencil offset i along axis d."""
    w = geom.window
    x = (dx_d - i) * vfac
    if geom.diffdir == d:
        ki = w.diff(x) * (geom.scale[d] * vfac * vfac)
    else:
        ki = w.kernel(x) * vfac
    if isup is not None:
        ki = torch.where(i < isup, ki, 0.0)
    return ki.to(dx_d.dtype)


def _stencil(geom, pos, hsml):
    """For each axis d and offset i < S: the flat-index term of the
    wrapped target (its index times the axis stride, or the mesh size
    where the target lies outside the mesh) and the weight."""
    ipos, dxs, vfac, isup, S = _fill_base(geom, pos, hsml)
    size = int(np.prod(geom.shape, dtype=np.int64))
    terms, weights = [], []
    for d in range(geom.ndim):
        stride = int(np.prod(geom.shape[d + 1:], dtype=np.int64))
        td, kd = [], []
        for i in range(S):
            t = ipos[d] + i
            if geom.period[d] > 0:
                t = torch.remainder(t, geom.period[d])
            ok = (t >= 0) & (t < geom.shape[d])
            td.append(torch.where(ok, t * stride, size))
            kd.append(_kweight(geom, dxs[d], d, i, vfac, isup))
        terms.append(td)
        weights.append(kd)
    del ipos, dxs
    return terms, weights, S, size


def _offsets(geom, terms, weights, S, base):
    """Yield the flat index and weight of each stencil offset, in the
    JAX package's order.  A target outside the mesh has index ``size``
    (the sentinel).  The weight is ``base`` times the axis weights in
    increasing axis order for a small stencil (S^ndim <= 64, the JAX
    package's unrolled route), decreasing for a large one (its loop)."""
    ndim = geom.ndim
    size = terms[0][0].new_tensor(int(np.prod(geom.shape, dtype=np.int64)))
    axes = range(ndim) if S ** ndim <= 64 else range(ndim - 1, -1, -1)
    for o in itertools.product(range(S), repeat=ndim):
        idx = terms[0][o[0]]
        for d in range(1, ndim):
            idx = idx + terms[d][o[d]]
        if ndim > 1:
            # any axis outside adds at least ``size``
            idx = torch.minimum(idx, size)
        w = base
        for d in axes:
            w = weights[d][o[d]] if w is None else w * weights[d][o[d]]
        yield idx, w


def _paint_impl(mesh, pos, mass, hsml, geom):
    """mesh + the paint of the particles (no autograd)."""
    N = pos.shape[0]
    if N == 0:
        return mesh.clone()
    terms, weights, S, size = _stencil(geom, pos, hsml)
    mass = torch.broadcast_to(mass.to(mesh.dtype), (N,))
    flat = torch.cat([mesh.reshape(-1), mesh.new_zeros(1)])
    for idx, w in _offsets(geom, terms, weights, S, mass):
        flat.index_add_(0, idx, w.to(flat.dtype))
    return flat[:size].reshape(geom.shape)


def _readout_impl(meshes, pos, hsml, geom):
    """The values of each mesh of ``meshes`` at the particles, sharing
    one index and weight computation (no autograd)."""
    N = pos.shape[0]
    outs = [torch.zeros(N, dtype=pos.dtype, device=pos.device)
            for _ in meshes]
    if N == 0:
        return outs
    terms, weights, S, size = _stencil(geom, pos, hsml)
    flats = [torch.cat([m.reshape(-1), m.new_zeros(1)]) for m in meshes]
    for idx, w in _offsets(geom, terms, weights, S, None):
        for j, fm in enumerate(flats):
            outs[j] = outs[j] + fm[idx] * w
    return outs


def _hsml_support(window, hsml, hsml_max):
    """The stencil size for per-particle hsml (None without hsml)."""
    if hsml is None:
        return None
    if hsml_max is None:
        hsml_max = float(torch.as_tensor(hsml).max())
    return int(np.ceil(window.support_float * float(hsml_max)))


def _no_second_order(geom):
    if geom.diffdir is not None:
        raise ValueError("gradient of gradient is not supported: the "
                         "positions of a diffdir paint or readout take no "
                         "derivative")


def _add(a, b):
    return b if a is None else a + b


class _Paint(torch.autograd.Function):
    """paint with the JAX package's ``_paint_jvp`` as its forward rule
    and that rule's transpose as its backward"""

    @staticmethod
    def forward(geom, mesh, pos, mass, hsml):
        return _paint_impl(mesh.detach(), pos.detach(), mass.detach(),
                           hsml, geom)

    @staticmethod
    def setup_context(ctx, inputs, output):
        geom, mesh, pos, mass, hsml = inputs
        ctx.geom = geom
        ctx.save_for_backward(pos, mass, hsml)
        ctx.save_for_forward(pos, mass, hsml)

    @staticmethod
    def backward(ctx, v):
        geom = ctx.geom
        pos, mass, hsml = ctx.saved_tensors
        v = v.contiguous()
        mesh_bar = v if ctx.needs_input_grad[1] else None
        pos_bar = mass_bar = None
        if ctx.needs_input_grad[3]:
            mb, = _readout_impl((v,), pos, hsml, geom)
            mass_bar = (mb if mass.dim() > 0 else mb.sum()).to(mass.dtype)
        if ctx.needs_input_grad[2]:
            _no_second_order(geom)
            cols = [_readout_impl((v,), pos, hsml, geom.with_diffdir(d))[0]
                    for d in range(geom.ndim)]
            pos_bar = (torch.stack(cols, dim=-1)
                       * mass.to(v.dtype).reshape(-1, 1)).to(pos.dtype)
        return None, mesh_bar, pos_bar, mass_bar, None

    @staticmethod
    def jvp(ctx, _geom, d_mesh, d_pos, d_mass, _hsml):
        """the mesh tangent, plus a paint of the mass tangent, plus one
        diffdir-d paint of mass * d_pos[:, d] per axis"""
        geom = ctx.geom
        pos, mass, hsml = ctx.saved_tensors
        zeros = torch.zeros(geom.shape, dtype=mass.dtype, device=pos.device)
        N = pos.shape[0]
        dout = d_mesh
        if d_mass is not None:
            dm = torch.broadcast_to(d_mass.to(mass.dtype), (N,))
            dout = _add(dout, _paint_impl(zeros, pos, dm, hsml, geom))
        if d_pos is not None:
            _no_second_order(geom)
            m = torch.broadcast_to(mass, (N,))
            for d in range(geom.ndim):
                dout = _add(dout, _paint_impl(
                    zeros, pos, m * d_pos[:, d].to(mass.dtype), hsml,
                    geom.with_diffdir(d)))
        if dout is None:
            dout = zeros
        # the primal is a view of a flat buffer (``_paint_impl``); forward
        # AD wants the tangent laid out the same way
        flat = dout.new_empty(dout.numel() + 1)
        flat[:-1] = dout.reshape(-1)
        return flat[:-1].reshape(geom.shape)


class _Readout(torch.autograd.Function):
    """readout of ``nmesh`` meshes with the JAX package's
    ``_readout_jvp`` as its forward rule and that rule's transpose as
    its backward"""

    @staticmethod
    def forward(geom, pos, hsml, *meshes):
        return tuple(_readout_impl(tuple(m.detach() for m in meshes),
                                   pos.detach(), hsml, geom))

    @staticmethod
    def setup_context(ctx, inputs, output):
        geom, pos, hsml, *meshes = inputs
        ctx.geom = geom
        ctx.save_for_backward(pos, hsml, *meshes)
        ctx.save_for_forward(pos, hsml, *meshes)

    @staticmethod
    def backward(ctx, *vbar):
        geom = ctx.geom
        pos, hsml, *meshes = ctx.saved_tensors
        vbar = tuple(v.contiguous() for v in vbar)
        mesh_bar = tuple(
            _paint_impl(torch.zeros_like(m), pos, vb, hsml, geom)
            if ctx.needs_input_grad[3 + j] else None
            for j, (m, vb) in enumerate(zip(meshes, vbar)))
        pos_bar = None
        if ctx.needs_input_grad[1]:
            _no_second_order(geom)
            cols = []
            for d in range(geom.ndim):
                rds = _readout_impl(meshes, pos, hsml, geom.with_diffdir(d))
                acc = None
                for vb, rd in zip(vbar, rds):
                    acc = vb * rd if acc is None else acc + vb * rd
                cols.append(acc)
            pos_bar = torch.stack(cols, dim=-1).to(pos.dtype)
        return (None, pos_bar, None) + mesh_bar

    @staticmethod
    def jvp(ctx, _geom, d_pos, _hsml, *d_meshes):
        """each mesh's tangent read out, plus d_pos[:, d] times the
        diffdir-d readout of the mesh, summed over the axes"""
        geom = ctx.geom
        pos, hsml, *meshes = ctx.saved_tensors
        douts = [None] * len(meshes)
        for j, dm in enumerate(d_meshes):
            if dm is not None:
                douts[j], = _readout_impl((dm,), pos, hsml, geom)
        if d_pos is not None:
            _no_second_order(geom)
            for d in range(geom.ndim):
                rds = _readout_impl(meshes, pos, hsml, geom.with_diffdir(d))
                dp = d_pos[:, d].to(pos.dtype)
                douts = [_add(o, rd * dp) for o, rd in zip(douts, rds)]
        return tuple(torch.zeros_like(pos[:, 0]) if o is None else o
                     for o in douts)


def paint(mesh, pos, mass=1.0, window='cic', scale=1.0, translate=0.0,
          period=0, diffdir=None, hsml=None, hsml_max=None):
    """``mesh`` plus the paint of the particles at ``pos`` (N, ndim): a
    new tensor; ``mesh`` is not changed.

    mass : scalar or (N,); cast to the mesh's dtype
    window : window name or ops.kernels.Window
    scale, translate, period : the affine from positions to mesh units
        (``translate`` and ``period`` in cells; period 0 does not wrap)
    diffdir : None, or the axis whose window is replaced by W' (times
        the scale)
    hsml, hsml_max : per-particle support scaling and its largest value
        (read from ``hsml`` when None)

    Differentiable in ``mesh``, ``pos`` and a tensor ``mass``.
    """
    pos = torch.as_tensor(pos)
    if hsml is not None:
        hsml = torch.as_tensor(hsml, device=pos.device)
    win = find_window(window)
    geom = PaintGeometry(win, mesh.shape, scale, translate, period, diffdir,
                         _hsml_support(win, hsml, hsml_max))
    mass = torch.as_tensor(mass, device=mesh.device).to(mesh.dtype)
    return _Paint.apply(geom, mesh, pos, mass, hsml)


def readout(mesh, pos, window='cic', scale=1.0, translate=0.0, period=0,
            diffdir=None, hsml=None, hsml_max=None):
    """The values of ``mesh`` at the particles ``pos`` (N, ndim).

    ``mesh`` may be a tuple of meshes (returns a tuple) or carry a
    leading batch axis (M, *shape) (returns (M, N)): all M meshes are
    read with one index and weight computation, as the PM force reads
    its three force meshes.  The other parameters are those of
    :func:`paint`.  Differentiable in the meshes and ``pos``.
    """
    pos = torch.as_tensor(pos)
    if hsml is not None:
        hsml = torch.as_tensor(hsml, device=pos.device)
    win = find_window(window)
    ndim = pos.shape[-1]
    if isinstance(mesh, (list, tuple)):
        meshes, kind = tuple(mesh), 'tuple'
    elif mesh.dim() == ndim + 1:
        meshes, kind = tuple(mesh.unbind(0)), 'batch'
    else:
        meshes, kind = (mesh,), 'single'
    geom = PaintGeometry(win, meshes[0].shape, scale, translate, period,
                         diffdir, _hsml_support(win, hsml, hsml_max))
    outs = _Readout.apply(geom, pos, hsml, *meshes)
    if kind == 'tuple':
        return tuple(outs)
    if kind == 'batch':
        return torch.stack(tuple(outs))
    return outs[0]
