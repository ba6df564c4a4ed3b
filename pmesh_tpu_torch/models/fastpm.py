"""FastPM particle-mesh N-body solver: the catalog, lattice and binned
paths.

Counterpart of ``pmesh_tpu/models/fastpm.py``.

The catalog path holds the particles as (N, ndim) tensors: a
``State`` of the Lagrangian grid Q, the displacement S and the velocity
V, in box units.  ``Solver.linear_field`` shapes white noise to P(k),
``Solver.lpt`` (and the module-level ``lpt``) reads the 1LPT and 2LPT
displacements at the particle grid, ``Solver.force`` is the PM force
(``decompose`` -> the generic paint -> r2c -> the force transfer ->
c2r -> the generic readout of the three force meshes in one pass, or
one Poisson potential and its derivative readouts in gradient mode),
``force_staged`` the same force with each direction's mesh freed
before the next, and ``Solver.nbody`` the KDK loop, one force per step,
with the coefficients in the state's dtype on the device.  Its FFTs are
``torch.fft`` (cuFFT on the card) and its paint and readout those of
``ops/paint.py``; the JAX package reaches no Pallas kernel on this
path.  On a sharded mesh (a ``ParticleMesh(procmesh=pm)`` of P > 1
ranks) each rank holds block b of the particle arrays.  On the slab and
pencil routes (``pm.py``) the force runs the ghost exchange of
``parallel/exchange.py`` (``exchange2d.py`` on a pencil grid):
``decompose`` with the kside (ksides) and capacity (per-channel
capacities) ``tune_exchange`` measured, the sharded paint, the slab
(pencil) FFTs and the sharded readout (one fused ``diffdir='all'``
readout in gradient mode); on the replicated route every rank paints
its particles into the whole mesh, the meshes are summed and each rank
reads its own particles.  The density's normalization counts the
particles of every rank.  ``nbody(rebalance=...)`` measures the load
after each step and, past the threshold, reshards the particles and
re-tunes the exchange; these decisions are taken on detached values,
and the gradient flows through the reshards.  Reverse and forward mode
(``torch.autograd``, ``torch.func.jvp``) run through the catalog path on
one device and on every sharded route (with the convention of
``parallel/comm.py``: on the replicated route the readout reads the
summed mesh through ``comm.pbroadcast``), on the card and on the CPU
alike:
the generic paint and readout carry the JAX package's ``custom_jvp``
rules and their transposes, ``torch.fft`` its own.  In gradient mode
the positions of the derivative readouts take no derivative: the
backward and the jvp raise there, as ``jax.grad`` and ``jax.jvp`` do.

The rest of this module is the lattice and binned paths: the
kick/drift factor families, ``leapfrog_factors``, and ``lpt_lattice`` (2LPT
initial conditions), ``force_lattice`` and ``nbody_lattice`` (the KDK
leapfrog on the lattice), and ``force_binned`` and ``nbody_binned``
(the slot-lattice state of ``ops/binned.py``, with a periodic rebase
and optional adaptive slot growth).  The state is mesh-shaped tensors
(displacement and velocity, in cells) on the mesh's device; the JAX
``lax.scan`` becomes a Python loop over the steps that keeps the
state, the coefficients and the poison checks on the device, with no
host sync inside a step.

One force is: lattice paint -> r2c -> three spectral force filters and
c2r (or one Poisson potential) -> lattice readouts.  With ``fft='xla'``
the FFTs are ``torch.fft``; with ``fft='mxu'`` (f32, 3-d) they are the
DFT passes of ``ops/fft_mxu.py`` (split-Nyquist Cooley-Tukey at ct2
shapes, dense elsewhere), with the 1/k^2 filter and the SuperLanczos
i*k_d folded into the inverse; ``fft='mxu_bf16'`` runs those passes
with single-pass bf16 products and ``fft='mxu_bf16s'`` stores the ct2
spectrum in bf16 between them, as the JAX package's modes do.  Paint,
readout, rebase and the DFT passes run the hand CUDA kernels for CUDA
tensors (``ops/gridpm.py``, ``ops/binned.py``, ``ops/fft_mxu.py``).

Reverse mode runs through the lattice path: ``torch.autograd`` takes
``force_lattice``, ``nbody_lattice`` and ``lpt_lattice`` end to end.  The
paint and readout carry the JAX package's custom vjps
(``ops/gridpm.py``), ``torch.fft`` its own autograd, and the
``fft='mxu'`` force triple and potential are ``torch.autograd.Function``s
with the JAX package's ``linear_call`` transposes (``_MxuForce``,
``_MxuPotential``), so on the card the backward runs the same kernels
as the forward.  The binned path takes gradients on the CPU, where the
fold, the rebase and the diffdir readouts are plain PyTorch (as the
JAX package's XLA versions take them).  On the card ``force_binned``
takes them in spectral mode, its backward on the lattice kernels; the
CUDA rebase (so ``nbody_binned``) and a diffdir lattice readout (so the
gradient-mode forces) refuse, as the JAX package's Pallas kernels have
no rule.

Slab-sharded runs: a Solver on a ``ParticleMesh(procmesh=pm)`` of P > 1
ranks takes and returns this rank's x slabs of every state field
(``parallel/pmesh.py``).  The paint, readout and rebase run the x-halo
slab forms (``ops/gridpm.py``, ``ops/binned.py``), ``fft='xla'`` the
slab transforms of ``parallel/pfft.py`` and the mxu modes the sharded
DFT pipelines of ``ops/fft_mxu.py`` (ct2 when the ranks also divide N0
and N1, as the JAX package's ``_mxu_setup`` requires).  These paths
need an even 1-d slab mesh: on a pencil, uneven or replicated mesh they
raise a NotImplementedError (ROADMAP queue 1, item 8e; the JAX package
runs its single-device program on the global arrays there).
Whatever decides for every rank is global: the NaN poison of
``nbody_lattice``, the particle count of ``force_binned``, the rebase
overflow and the needed slot count of the adaptive loop.  As in the JAX
package the sharded binned loops wrap the lattice state as slots and
fold it with a rebase over the state's whole drift (the sort-based fold
is single-device).
Reverse mode runs through the sharded lattice and binned paths as on one
device: the x-halo paint and readout carry their vjps over the slabs
(``ops/gridpm.py``), the slab transforms and the sharded DFT pipelines
their transposes (the mxu force triple's ``only=d`` passes run sharded),
and the plain slab rebase differentiates on the CPU; on the card the
CUDA rebase and the derivative lattice readouts refuse, as on one
device.
"""
import numpy as np
import torch

from ..pm import ParticleMesh, RealField
from ..ops import transfer as tf
from ..ops import paint as _paint_ops
from ..ops import gridpm as _gp
from ..ops import binned as _bn
from ..ops import fft_mxu as _fm
from ..parallel import exchange as _ex
from ..parallel.comm import all_reduce
from .cosmology import Planck15

__all__ = ["Solver", "State", "lpt", "leapfrog_factors", "FastPM", "Quinn",
           "TVE", "VTE", "Naive"]


class State(object):
    """Particle state of the catalog path: the Lagrangian grid Q, the
    displacement S and the velocity V, (N, ndim) tensors in box units."""

    def __init__(self, Q, S, V):
        self.Q = Q
        self.S = S
        self.V = V

    @property
    def X(self):
        return self.Q + self.S


# --- kick / drift factor families ------------------------------------------

def _quad(func, lo, hi, n=256):
    """Fixed-order trapezoid quadrature on the host."""
    x = np.linspace(lo, hi, n)
    return float(np.trapezoid([func(xi) for xi in x], x))


class FastPM:
    """Growth-factor-exact kick and drift (the FastPM scheme)."""
    def __init__(self, pt):
        self.pt = pt

    def K(self, ai, af, ar):
        pt = self.pt
        return 1 / (ar ** 2 * float(pt.E(ar))) * (
            float(pt.Gf(af)) - float(pt.Gf(ai))) / float(pt.gf(ar))

    def D(self, ai, af, ar):
        pt = self.pt
        return 1 / (ar ** 3 * float(pt.E(ar))) * (
            float(pt.Gp(af)) - float(pt.Gp(ai))) / float(pt.gp(ar))


class Quinn:
    """Standard symplectic quadrature factors (Quinn et al)."""
    def __init__(self, pt):
        self.pt = pt

    def K(self, ai, af, ar):
        return _quad(lambda a: 1.0 / (a * a * float(self.pt.E(a))), ai, af)

    def D(self, ai, af, ar):
        return _quad(lambda a: 1.0 / (a ** 3 * float(self.pt.E(a))), ai, af)


class TVE:
    """H = T + (E + V) split: drift has no explicit time dependence."""
    def __init__(self, pt):
        self.pt = pt

    def K(self, ai, af, ar):
        return _quad(lambda a: 1.0 / (a * a * float(self.pt.E(a))), ai, af)

    def D(self, ai, af, ar):
        return ar ** -2 * _quad(
            lambda a: 1.0 / (a * float(self.pt.E(a))), ai, af)


class VTE:
    """H = (T + E) + V split: kick has no explicit time dependence."""
    def __init__(self, pt):
        self.pt = pt

    def K(self, ai, af, ar):
        return ar ** -1 * _quad(
            lambda a: 1.0 / (a * float(self.pt.E(a))), ai, af)

    def D(self, ai, af, ar):
        return _quad(lambda a: 1.0 / (a ** 3 * float(self.pt.E(a))), ai, af)


class Naive:
    def __init__(self, pt):
        self.pt = pt

    def K(self, ai, af, ar):
        return 1.0 / (ar * ar * float(self.pt.E(ar))) * (af - ai)

    def D(self, ai, af, ar):
        return 1.0 / (ar ** 3 * float(self.pt.E(ar))) * (af - ai)


_FACTORS = {'fastpm': FastPM, 'quinn': Quinn, 'tve': TVE, 'vte': VTE,
            'naive': Naive}


def leapfrog_factors(time_steps, factors, scheme='symp2'):
    """The per-step kick/drift coefficient table, on the host.

    Returns (K1, D1, K2) f8 numpy arrays for symp2 (KDK); symp1
    returns (K1, D1, 0)."""
    Ks1, Ds1, Ks2 = [], [], []
    for ai, af in zip(time_steps[:-1], time_steps[1:]):
        if scheme == 'symp2':
            ac = (ai * af) ** 0.5
            Ks1.append(factors.K(ai, ac, ai))
            Ds1.append(factors.D(ai, af, ac))
            Ks2.append(factors.K(ac, af, af))
        elif scheme == 'symp1':
            Ks1.append(factors.K(ai, af, ai))
            Ds1.append(factors.D(ai, af, af))
            Ks2.append(0.0)
        else:
            raise ValueError("scheme must be symp1 or symp2")
    return (np.asarray(Ks1, dtype='f8'), np.asarray(Ds1, dtype='f8'),
            np.asarray(Ks2, dtype='f8'))


# the DFT forms of each fft mode: (precision, spectrum_dtype) of the
# ops/fft_mxu.py operators, as the JAX package passes them
_MXU = {'mxu': (None, None), 'mxu_bf16': ('bf16', None),
        'mxu_bf16s': (None, torch.bfloat16)}


def _check_force_args(fft, mode):
    if fft != 'xla' and fft not in _MXU:
        raise ValueError("unknown fft backend %r (use 'xla', 'mxu', "
                         "'mxu_bf16' or 'mxu_bf16s')" % (fft,))
    if mode not in ('spectral', 'gradient'):
        raise ValueError("mode must be 'spectral' or 'gradient'")


class _MxuForce(torch.autograd.Function):
    """The fft='mxu' force triple T: rho -> (f_0, f_1, f_2), a linear
    map, with the JAX package's ``linear_call`` transpose
    (``pmesh_tpu/models/fastpm.py:549-577``): each direction is a
    circular convolution with a real odd kernel (i k_d / k^2), so
    T_d^T = -T_d and rho_bar = -sum_d T_d(ct_d), one direction at a time
    (``only=d``).  The backward runs the forward's DFT form (``form`` =
    (precision, spectrum_dtype)).  Nothing is saved for the backward."""

    @staticmethod
    def forward(ctx, solver, rho, form=(None, None)):
        ctx.solver, ctx.form = solver, form
        return solver._mxu_force_raw(rho.detach(), form)

    @staticmethod
    def backward(ctx, *ct):
        acc = None
        for d, c in enumerate(ct):
            f = ctx.solver._mxu_force_raw(c.detach().contiguous(), ctx.form,
                                          only=d)
            acc = f if acc is None else acc + f
        return None, -acc, None


class _MxuPotential(torch.autograd.Function):
    """The ct2 fft='mxu' Poisson potential, a circular convolution with
    a real even kernel (-1/k^2): self-adjoint, so its transpose is
    itself (``pmesh_tpu/models/fastpm.py:648-666``), in the forward's DFT
    form."""

    @staticmethod
    def forward(ctx, solver, rho, form=(None, None)):
        ctx.solver, ctx.form = solver, form
        return solver._mxu_potential_raw(rho.detach(), form)

    @staticmethod
    def backward(ctx, ct):
        return None, ctx.solver._mxu_potential_raw(ct.detach().contiguous(),
                                                   ctx.form), None


class Solver(object):
    """FastPM solver on the lattice and on the binned slot-lattice.

    Parameters
    ----------
    pm : ParticleMesh
        the IC-resolution mesh (one particle per mesh point); its
        device holds the whole state.
    cosmology : Cosmology (default Planck15)
    B : int
        force-mesh boost factor; the lattice path needs B=1.
    force_resampler : window of the force mesh (default 'cic')
    """

    def __init__(self, pm, cosmology=None, B=1, force_resampler='cic'):
        self.pm = pm
        self.cosmology = cosmology if cosmology is not None else Planck15
        self.fpm = pm.reshape(Nmesh=pm.Nmesh * B) if B != 1 else pm
        if force_resampler is not None:
            self.fpm = ParticleMesh(
                Nmesh=self.fpm.Nmesh, BoxSize=self.fpm.BoxSize,
                dtype=self.fpm.dtype, resampler=force_resampler,
                device=self.fpm.device, procmesh=self.fpm.procmesh)
        # the sharded exchange plan's kside and capacity, measured by
        # tune_exchange (empty: decompose's defaults, a capacity of the
        # whole block); the load it measured last
        self._exch_kwargs = {}
        self.last_load = None

    @property
    def _pmh(self):
        """the ProcessMesh of a sharded force mesh, else None, for the
        lattice and binned paths, whose slab forms need an even 1-d slab
        mesh (the JAX package's ``_even_mesh`` gate): any other sharded
        geometry raises"""
        for pm in (self.pm, self.fpm):
            if pm.sharded and not (pm.route == 'slab' and pm._even_mesh):
                raise NotImplementedError(
                    "the lattice and binned paths need one device or an "
                    "even 1-d slab mesh; a %s mesh (grid %s, Nmesh %s) is "
                    "not ported yet (ROADMAP queue 1, item 8e)"
                    % (pm.route, pm.procmesh.grid,
                       tuple(int(n) for n in pm.Nmesh)))
        return self.fpm.procmesh if self.fpm.sharded else None

    def _count(self, X):
        """the number of particles of every rank"""
        if not self.fpm.sharded:
            return X.shape[0]
        t = torch.tensor([X.shape[0]], dtype=torch.int64, device=X.device)
        return int(all_reduce(t, self.fpm.procmesh, 'sum')[0])

    def tune_exchange(self, X, slack=1.5):
        """Measure the ghosts of the particles ``X`` (this rank's block)
        and fix the sharded exchange's kside and capacity for the forces
        that follow: the largest channel count times ``slack`` (at least
        16); a later overflow poisons.  Also measures the load
        (``last_load``).  Returns the plan's parameters; None on one
        device and on the replicated route, where there is nothing to
        tune.  On a pencil mesh the plan is the 2-d one: ksides (kx, ky)
        and one capacity per channel, each its count times ``slack`` (at
        least 8)."""
        fpm = self.fpm
        if not fpm.blocked:
            return None
        X = X.detach()
        g0 = fpm._grid(X, fpm.affine, 0)
        smoothing = fpm.resampler.support * 0.5
        N0 = int(fpm.Nmesh[0])
        if fpm.route == 'pencil':
            return self._tune_exchange2d(X, g0, smoothing, slack)
        kside = _ex._default_kside(
            smoothing, _ex._slab_rows(N0, fpm.procmesh.size),
            fpm.procmesh.size, N0)
        counts, reach = _ex.measure_ghosts(fpm.procmesh, g0, N0, smoothing,
                                           kside=kside)
        if reach > kside:
            raise ValueError(
                "particles reach %d slabs from home (> kside=%d): reshard "
                "before tuning (pm.reshard_particles)" % (reach, kside))
        capacity = max(16, int(np.ceil(float(counts.max()) * float(slack))))
        self._exch_kwargs = dict(kside=kside, capacity=capacity)
        self.last_load = _ex.measure_load(fpm.procmesh, g0, N0, smoothing,
                                          kside=kside)
        return self._exch_kwargs

    def _tune_exchange2d(self, X, g0, smoothing, slack):
        """tune_exchange on a pencil mesh"""
        from ..parallel import exchange2d as _ex2
        fpm = self.fpm
        g1 = fpm._grid(X, fpm.affine, 1)
        npx, npy = fpm.procmesh.grid
        N0, N1 = int(fpm.Nmesh[0]), int(fpm.Nmesh[1])
        ks = _ex2._default_ksides(smoothing, N0 // npx, N1 // npy)
        counts, reach = _ex2.measure_ghosts2d(fpm.procmesh, g0, g1, N0, N1,
                                              smoothing, ksides=ks)
        if reach[0] > ks[0] or reach[1] > ks[1]:
            raise ValueError(
                "particles reach %s blocks from home (> ksides=%s): reshard "
                "before tuning (pm.reshard_particles)" % (reach, ks))
        caps = tuple(max(8, int(np.ceil(float(c) * float(slack))))
                     for c in counts)
        self._exch_kwargs = dict(kside=ks, capacity=caps)
        self.last_load = _ex2.measure_load2d(fpm.procmesh, g0, g1, N0, N1,
                                             smoothing, ksides=ks)
        return self._exch_kwargs

    def _measure_load(self, X):
        """the load of the particles ``X`` under the tuned plan (the
        route's measure_load)"""
        fpm = self.fpm
        smoothing = fpm.resampler.support * 0.5
        kside = self._exch_kwargs.get('kside')
        X = X.detach()
        g0 = fpm._grid(X, fpm.affine, 0)
        if fpm.route == 'pencil':
            from ..parallel import exchange2d as _ex2
            return _ex2.measure_load2d(
                fpm.procmesh, g0, fpm._grid(X, fpm.affine, 1),
                int(fpm.Nmesh[0]), int(fpm.Nmesh[1]), smoothing,
                ksides=kside)
        return _ex.measure_load(fpm.procmesh, g0, int(fpm.Nmesh[0]),
                                smoothing, kside=kside)

    def _read_sharded(self, layout, meshes, X, diffdir=None):
        """the route's sharded readout of this rank's blocks ``meshes``
        at ``X`` with the plan ``layout`` (slab and pencil meshes)"""
        fpm = self.fpm
        a = fpm.affine
        return fpm._sharded_ops()[2](layout, meshes, X, a.scale,
                                     fpm.resampler.window, diffdir=diffdir,
                                     translate=a.translate)

    # --- catalog path: initial conditions ---------------------------------

    def linear_field(self, power, seed, unitary=False, compat='gadget'):
        """The linear density contrast in Fourier space at z=0: white
        noise of ``seed`` shaped by sqrt(P(k) / volume)."""
        gauss = self.pm.generate_whitenoise(seed, unitary=unitary,
                                            type='complex', compat=compat)

        def convolve(k, v):
            kmag = k.normp(2) ** 0.5
            return v * (power(kmag) / k.BoxSize.prod()) ** 0.5
        return gauss.apply(convolve)

    def lpt(self, dlinear, a0, order=2, shift=0.0):
        """1LPT (order 1) or 2LPT initial displacements and velocities
        at the particle grid (``shift`` cells off the mesh points),
        scaled to time a0: a :class:`State`."""
        pm = self.pm
        pt = self.cosmology
        Q = pm.generate_uniform_particle_grid(shift=shift)

        DX1 = torch.stack([
            dlinear.apply(tf.dx1_transfer(d)).c2r().readout(Q)
            for d in range(pm.ndim)], dim=-1)
        D1 = float(pt.D1(a0))
        f1 = float(pt.f1(a0))
        E0 = float(pt.E(a0))
        S = DX1 * D1
        V = DX1 * (D1 * f1 * a0 ** 2 * E0)
        if order >= 2 and pm.ndim == 3:
            # the 2LPT source sum_{a<b} phi_aa phi_bb - phi_ab^2, with
            # phi_ab = k_a k_b / k^2 dlinear
            def phi_ab(a, b):
                def filt(k, v):
                    return v * k[a] * k[b] / k.normp(2, zeromode=1.0)
                return dlinear.apply(filt).c2r().value

            diag = [phi_ab(d, d) for d in range(3)]
            src = 0.0
            for a in range(3):
                for b in range(a + 1, 3):
                    src = src + (diag[a] * diag[b] - phi_ab(a, b) ** 2)
            del diag
            source2 = pm.create(type=RealField, value=src).r2c()
            del src
            DX2 = torch.stack([
                source2.apply(tf.dx1_transfer(d)).c2r().readout(Q)
                for d in range(3)], dim=-1)
            # D2 carries the -3/7
            D2 = float(pt.D2(a0))
            f2 = float(pt.f2(a0))
            S = S + DX2 * D2
            V = V + DX2 * (D2 * f2 * a0 ** 2 * E0)
        return State(Q, S, V)

    # --- catalog path: force -----------------------------------------------

    def force(self, X, factor=None, mode='spectral'):
        """PM gravity at the particles ``X`` (N, ndim), in box units:
        paint -> r2c -> the force transfer of each direction -> c2r ->
        one readout of the ndim force meshes sharing its indices and
        weights.  The density is normalized by prod(Nmesh) / N.

        mode='gradient' takes one Poisson potential and its derivative
        readouts (-W'(v - s) along each axis, in simulation units: no
        cell factor), a third of the inverse FFTs.

        On a sharded mesh ``X`` is this rank's block: the plan is
        decomposed with ``tune_exchange``'s parameters, and the readouts
        are the sharded ones (gradient mode's fused in one pass).
        """
        if mode not in ('spectral', 'gradient'):
            raise ValueError("mode must be 'spectral' or 'gradient'")
        fpm = self.fpm
        N = self._count(X)
        if factor is None:
            factor = 1.5 * self.cosmology.Om0
        layout = fpm.decompose(X, **self._exch_kwargs)
        rho = fpm.paint(X, layout=layout)
        rhok = (rho * (float(fpm.Nmesh.prod()) / N)).r2c()
        del rho
        a = fpm.affine
        if mode == 'gradient':
            phi = rhok.apply(tf.poisson()).c2r()
            del rhok
            if fpm.blocked:
                vals = [-v for v in self._read_sharded(layout, phi.value, X,
                                                       'all')]
            else:
                vals = [-phi.readout(X, layout=layout, gradient=d)
                        for d in range(fpm.ndim)]
            return torch.stack(vals, dim=-1) * factor
        meshes = tuple(rhok.apply(tf.force_transfer(d)).c2r().value
                       for d in range(fpm.ndim))
        del rhok
        if fpm.blocked:
            vals = self._read_sharded(layout, meshes, X)
        else:
            vals = _paint_ops.readout(tuple(fpm.local_view(m)
                                            for m in meshes), X,
                                      window=fpm.resampler.window,
                                      scale=a.scale, translate=a.translate,
                                      period=a.period)
        return torch.stack(vals, dim=-1) * factor

    def force_staged(self, X, factor=None):
        """The spectral :meth:`force`, one direction at a time: each
        direction's force mesh is read and freed before the next is
        made, so one mesh is live beside the spectrum (on a sharded
        mesh, one slab of it and one plan for the paint and the three
        readouts)."""
        fpm = self.fpm
        N = self._count(X)
        if factor is None:
            factor = 1.5 * self.cosmology.Om0
        layout = fpm.decompose(X, **self._exch_kwargs) if fpm.blocked \
            else None
        rho = fpm.paint(X, layout=layout)
        rhok = (rho * (float(fpm.Nmesh.prod()) / N)).r2c()
        del rho
        a = fpm.affine
        cols = []
        for d in range(fpm.ndim):
            mesh = rhok.apply(tf.force_transfer(d)).c2r().value
            if fpm.blocked:
                cols.append(self._read_sharded(layout, mesh, X))
            else:
                cols.append(_paint_ops.readout(
                    fpm.local_view(mesh), X, window=fpm.resampler.window,
                    scale=a.scale,
                    translate=a.translate, period=a.period))
            del mesh
        return torch.stack(cols, dim=-1) * factor

    # --- catalog path: time integration ------------------------------------

    def nbody(self, state, time_steps, factors='fastpm', scheme='symp2',
              monitor=None, force_mode='spectral', rebalance=None):
        """The KDK loop of the catalog path from ``state``: one force
        per step (``force_mode``: see :meth:`force`), the coefficients
        in the state's dtype on its device.  ``monitor(a, state)`` is
        called after each step.  Returns the final :class:`State`.

        On a sharded mesh the state is this rank's block; the exchange
        is tuned on the initial state unless ``tune_exchange`` ran
        before.  ``rebalance`` (a float; does nothing on one device)
        measures the load after each step (``last_load``) and, when its
        max / mean exceeds the threshold, reshards (Q, S, V, F) into
        home-slab (home-pencil) order and re-tunes the exchange: the
        particles then change ranks and order.  On the replicated route
        there is no plan to tune and nothing to rebalance.
        """
        fac = _FACTORS[factors](self.cosmology) \
            if isinstance(factors, str) else factors
        dtype, device = state.S.dtype, state.S.device
        K1, D1s, K2 = (torch.as_tensor(c, device=device).to(dtype)
                       for c in leapfrog_factors(time_steps, fac, scheme))
        fpm = self.fpm
        Q, S, V = state.Q, state.S, state.V
        if fpm.blocked and not self._exch_kwargs:
            self.tune_exchange(Q + S)
        F = self.force(Q + S, mode=force_mode)
        for i, af in enumerate(time_steps[1:]):
            V = V + F * K1[i]
            S = S + V * D1s[i]
            F = self.force(Q + S, mode=force_mode)
            V = V + F * K2[i]
            if rebalance is not None and fpm.blocked:
                X = Q + S
                self.last_load = self._measure_load(X)
                if self.last_load['imbalance'] > float(rebalance):
                    _, Q, S, V, F = fpm.reshard_particles(X, Q, S, V, F)
                    self._exch_kwargs = {}
                    self.tune_exchange(Q + S)
            if monitor is not None:
                monitor(af, State(Q, S, V))
        return State(Q, S, V)

    def lpt_lattice(self, dlinear, a0, shift=0.0, order=1):
        """LPT state in lattice form: (disp, vel), ndim mesh-shaped
        tensors each, in CELLS.  The displacement kernels are sampled
        at the unshifted lattice sites, so the c2r mesh IS the
        per-particle displacement.  Like the other lattice paths it
        needs one device or an even 1-d slab mesh (``_pmh`` raises
        otherwise)."""
        self._pmh
        pm = self.pm
        pt = self.cosmology
        cell = float(pm.BoxSize[0] / pm.Nmesh[0])
        DX1 = tuple(dlinear.apply(tf.dx1_transfer(d)).c2r().value / cell
                    for d in range(pm.ndim))
        D1 = float(pt.D1(a0))
        f1 = float(pt.f1(a0))
        E0 = float(pt.E(a0))
        disp = tuple(dx * D1 + shift for dx in DX1)
        vel = tuple(dx * (D1 * f1 * a0 ** 2 * E0) for dx in DX1)
        if order >= 2 and pm.ndim == 3:
            # 2LPT source from the strain products
            def phi_ab(a, b):
                def filt(k, v):
                    k2 = k.normp(2, zeromode=1.0)
                    return v * k[a] * k[b] / k2
                return dlinear.apply(filt).c2r().value

            diag = [phi_ab(d, d) for d in range(3)]
            src = 0.0
            for a in range(3):
                for b in range(a + 1, 3):
                    src = src + (diag[a] * diag[b] - phi_ab(a, b) ** 2)
            source2 = pm.create(type=RealField, value=src).r2c()
            DX2 = tuple(
                source2.apply(tf.dx1_transfer(d)).c2r().value / cell
                for d in range(3))
            D2 = float(pt.D2(a0))
            f2 = float(pt.f2(a0))
            disp = tuple(s + dx2 * D2 for s, dx2 in zip(disp, DX2))
            vel = tuple(v + dx2 * (D2 * f2 * a0 ** 2 * E0)
                        for v, dx2 in zip(vel, DX2))
        return disp, vel

    def force_lattice(self, disp, bounds, factor=None, mode='spectral',
                      fft='xla'):
        """PM gravity force at the lattice particles.

        Parameters
        ----------
        disp : tuple of ndim mesh-shaped displacement tensors (cells).
        bounds : (lo, hi) static displacement bounds in cells.
        mode : 'spectral' | 'gradient'
            'spectral' differentiates in k-space (three inverse FFTs);
            'gradient' takes one Poisson potential and the
            derivative-window readout.
        fft : 'xla' (torch.fft) or 'mxu' (the DFT passes, f32: ct2 or
            dense by shape; the gradient mode takes the field path at
            shapes that are not ct2, as the JAX package does);
            'mxu_bf16' the same passes with single-pass bf16 products;
            'mxu_bf16s' with f32 products and the ct2 spectrum stored in
            bf16 between the passes (the dense pipeline keeps f32, as
            the JAX package's does).

        Returns the ndim force meshes (box-unit acceleration).
        """
        fpm = self.fpm
        if tuple(fpm.Nmesh) != tuple(self.pm.Nmesh):
            raise ValueError("the lattice path needs B=1 "
                             "(force mesh == particle lattice)")
        _check_force_args(fft, mode)
        if factor is None:
            factor = 1.5 * self.cosmology.Om0
        cell = float(fpm.BoxSize[0] / fpm.Nmesh[0])
        kind = fpm.resampler.window.kind
        pmh = self._pmh

        rho = _gp.paint_grid(disp, bounds=bounds, window=kind, procmesh=pmh)
        if mode == 'spectral':
            vals = _gp.readout_grid(self._spectral_meshes(rho, fft), disp,
                                    bounds=bounds, window=kind, procmesh=pmh)
        else:
            # F_d = -d(phi)/dx_d; the diffdir readout is the derivative
            # in cell units, so F_d = -readout_d / cell
            phi = self._potential_mesh(rho, fft)
            if fpm.ndim == 3:
                rds = _gp.readout_grid(phi, disp, bounds=bounds,
                                       window=kind, diffdir='all',
                                       procmesh=pmh)
            else:
                rds = tuple(_gp.readout_grid(phi, disp, bounds=bounds,
                                             window=kind, diffdir=d)
                            for d in range(fpm.ndim))
            vals = tuple(-r / cell for r in rds)
        return tuple(v * factor for v in vals)

    def _potential_mesh(self, rho, fft='xla'):
        """The (tf.poisson-signed) potential of a painted 1+delta
        density, shared by the lattice and binned gradient-mode forces:
        the ct2 DFT route for the mxu modes on an f32 3-d mesh of a ct2
        shape (one x pass and one zy inverse), else the field path."""
        phi = None
        if fft in _MXU and self.fpm.ndim == 3 \
                and rho.dtype == torch.float32:
            phi = self._mxu_potential(rho, _MXU[fft])
        if phi is None:
            phi = self.fpm.create(type=RealField, value=rho).r2c() \
                .apply(tf.poisson()).c2r().value
        return phi

    def _spectral_meshes(self, rho, fft='xla'):
        """The ndim directional force meshes of a painted 1+delta
        density, shared by the lattice and binned spectral forces."""
        if fft in _MXU:
            if self.fpm.ndim != 3:
                raise ValueError("fft='mxu' is 3-d only")
            if rho.dtype != torch.float32:
                raise ValueError(
                    "fft='mxu' computes in f32; use a dtype='f4' mesh or "
                    "fft='xla' for f64 runs")
            return _MxuForce.apply(self, rho, _MXU[fft])
        rhok = self.fpm.create(type=RealField, value=rho).r2c()
        return tuple(rhok.apply(tf.force_transfer(d)).c2r().value
                     for d in range(self.fpm.ndim))

    def _mxu_setup(self):
        """The static tables of the fft='mxu' paths: the mesh shape,
        the per-axis k^2 tables (f4, natural order; z over the half axis)
        as tuples of floats, the SuperLanczos difference kernels k_d (f8
        tuples, zero at Nyquist, as the half-spectrum gradient needs) and
        whether the shape takes the ct2 pipeline (else the dense one): on
        a sharded mesh only when the ranks divide N0 and N1, as the JAX
        package's rule has it (``pmesh_tpu/models/fastpm.py:611-624``;
        the sharded ParticleMesh already requires that)."""
        fpm = self.fpm
        shape = tuple(int(n) for n in fpm.Nmesh)
        if not hasattr(self, '_mxu_cache'):
            ks = [np.fft.fftfreq(n, d=float(b) / n) * 2 * np.pi
                  for n, b in zip(shape[:2], fpm.BoxSize[:2])]
            ks.append(np.fft.rfftfreq(
                shape[2], d=float(fpm.BoxSize[2]) / shape[2]) * 2 * np.pi)
            # the SuperLanczos order-1 difference kernel of
            # tf.force_transfer
            kd = []
            for d, n in enumerate(shape):
                cell = float(fpm.BoxSize[d]) / n
                w = ks[d] * cell
                kd.append(tuple(
                    (1.0 / (6.0 * cell)
                     * (8 * np.sin(w) - np.sin(2 * w))).tolist()))
            pk2 = tuple(tuple(float(v) for v in (k ** 2).astype('f4'))
                        for k in ks)
            self._mxu_cache = (pk2, tuple(kd))
        pk2, kd = self._mxu_cache
        pmh = self._pmh
        ct = _fm.is_ct2(shape) and (pmh is None or (
            shape[0] % pmh.size == 0 and shape[1] % pmh.size == 0))
        return shape, pk2, kd, ct

    def _mxu_potential(self, rho, form=(None, None)):
        """The Poisson potential through the ct2 DFT passes in the DFT
        ``form`` (precision, spectrum_dtype), or None at shapes that are
        not ct2 (the caller takes the field path)."""
        if not self._mxu_setup()[3]:
            return None
        return _MxuPotential.apply(self, rho, form)

    def _mxu_potential_raw(self, rho, form=(None, None)):
        shape, pk2, kd, ct = self._mxu_setup()
        precision, sdt = form
        pmh = self._pmh
        if pmh is not None:
            r, i, nqr, nqi = _fm.fft3_real_forward_half_ct2_sharded(
                pmh, rho, precision=precision, spectrum_dtype=sdt)
            return _fm.fft3_poisson_half_ct2_sharded(
                pmh, r, i, nqr, nqi, n2=shape[2], poisson_k2=pk2,
                precision=precision)
        r, i, nqr, nqi = _fm.fft3_real_forward_half_ct2(
            rho, precision=precision, spectrum_dtype=sdt)
        return _fm.fft3_poisson_half_ct2(r, i, nqr, nqi, n2=shape[2],
                                         poisson_k2=pk2, precision=precision)

    def _mxu_force_raw(self, rho, form=(None, None), only=None):
        """The spectral force meshes through the DFT passes: one
        forward, then the 1/k^2 filter and the i*k_d force kernel folded
        into the inverse x pass and the per-axis inverse tables; the ct2
        pipeline at ct2 shapes, the dense one elsewhere (where the JAX
        package applies 1/k^2 as an elementwise pass, the dense x pass
        folds it from the same 1-d tables).  ``only`` = d gives that
        direction alone, for the transpose of the operator: one x pass
        and one zy inverse at ct2 shapes, the triple's member elsewhere,
        as the JAX package does.  ``form`` = (precision, spectrum_dtype)
        of the passes; the dense pipeline ignores the storage dtype, as
        the JAX package's does."""
        shape, pk2, kd, ct = self._mxu_setup()
        precision, sdt = form
        pmh = self._pmh
        if not ct:
            if pmh is not None:
                r, i = _fm.fft3_real_forward_half_sharded(
                    pmh, rho, precision=precision)
                out = _fm.fft3_real_inverse_grad3_half_sharded(
                    pmh, r, i, n2=shape[2], kvecs=kd, precision=precision,
                    poisson_k2=pk2)
                return out if only is None else out[only]
            r, i = _fm.fft3_real_forward_half(rho, precision=precision)
            out = _fm.fft3_real_inverse_grad3_half(
                r, i, n2=shape[2], kvecs=kd, precision=precision,
                poisson_k2=pk2)
            return out if only is None else out[only]
        if pmh is not None:
            r, i, nqr, nqi = _fm.fft3_real_forward_half_ct2_sharded(
                pmh, rho, precision=precision, spectrum_dtype=sdt)
            return _fm.fft3_real_inverse_grad3_half_ct2_sharded(
                pmh, r, i, nqr, nqi, n2=shape[2], kvecs=kd,
                precision=precision, poisson_k2=pk2, only=only)
        r, i, nqr, nqi = _fm.fft3_real_forward_half_ct2(
            rho, precision=precision, spectrum_dtype=sdt)
        return _fm.fft3_real_inverse_grad3_half_ct2(
            r, i, nqr, nqi, n2=shape[2], kvecs=kd, precision=precision,
            poisson_k2=pk2, only=only)

    def nbody_lattice(self, disp, vel, time_steps, bounds,
                      factors='fastpm', scheme='symp2',
                      force_mode='spectral', fft='xla'):
        """KDK loop in lattice form; ``disp``, ``vel`` and the kick are
        in cells.  Returns the final (S, V).

        A displacement outside ``bounds`` would silently lose mass in
        the paint, so the moment one appears (checked after every
        drift, on the device) both S and V are poisoned with NaN: on a
        sharded mesh on every rank, whichever rank's slab left the
        bounds."""
        fac = _FACTORS[factors](self.cosmology) \
            if isinstance(factors, str) else factors
        dtype = disp[0].dtype
        device = disp[0].device
        # the coefficients ride in the state dtype, on the device
        K1, D1s, K2 = (torch.as_tensor(a, device=device).to(dtype)
                       for a in leapfrog_factors(time_steps, fac, scheme))
        cell = float(self.pm.BoxSize[0] / self.pm.Nmesh[0])
        lo_b, hi_b = float(bounds[0]), float(bounds[1])

        def force_cells(S):
            F = self.force_lattice(S, bounds, mode=force_mode, fft=fft)
            return tuple(f / cell for f in F)

        pmh = self._pmh

        def poison(S, V):
            lo, hi = _gp.displacement_bounds(tuple(s.detach() for s in S))
            bad = ((lo < lo_b) | (hi > hi_b)).to(dtype)
            if pmh is not None:
                bad = all_reduce(bad, pmh, 'max')
            bad = torch.where(bad > 0, float('nan'), 0.0).to(dtype)
            return (tuple(s + bad for s in S), tuple(v + bad for v in V))

        S, V = poison(tuple(disp), tuple(vel))
        F = force_cells(S)
        for k1, d1, k2 in zip(K1, D1s, K2):
            V = tuple(v + f * k1 for v, f in zip(V, F))
            S = tuple(s + v * d1 for s, v in zip(S, V))
            S, V = poison(S, V)
            F = force_cells(S)
            V = tuple(v + f * k2 for v, f in zip(V, F))
        return S, V

    # --- binned slot-lattice path -----------------------------------------
    #
    # Any particle distribution (clustered late-time states) as nslots
    # sub-lattices whose displacements stay in [0, 1) + drift: the
    # general-position path without a scatter (ops/binned.py).

    def force_binned(self, dslots, valid, bounds, factor=None, fft='xla',
                     mode='spectral'):
        """PM gravity for a binned state: per-slot force value fields
        (mask with ``valid``; invalid slots read garbage).

        mode='gradient' takes ONE Poisson potential and reads it with
        the fused derivative window per slot: nslots readout passes
        instead of 3 * nslots."""
        fpm = self.fpm
        if tuple(fpm.Nmesh) != tuple(self.pm.Nmesh):
            raise ValueError("the binned path needs B=1 "
                             "(force mesh == particle lattice)")
        _check_force_args(fft, mode)
        if factor is None:
            factor = 1.5 * self.cosmology.Om0
        kind = fpm.resampler.window.kind
        pmh = self._pmh
        rho = _bn.paint_binned(dslots, valid, bounds=bounds, window=kind,
                               procmesh=pmh)
        # normalize to 1+delta for a general particle count (all ranks')
        ntot = sum(v.sum() for v in valid)
        if pmh is not None:
            ntot = all_reduce(ntot, pmh, 'sum')
        rho = rho * (float(fpm.Nmesh.prod()) / ntot)
        if mode == 'gradient':
            cell = float(fpm.BoxSize[0] / fpm.Nmesh[0])
            phi = self._potential_mesh(rho, fft)
            vals = _bn.readout_binned(phi, dslots, valid, bounds=bounds,
                                      window=kind, diffdir='all',
                                      procmesh=pmh)
            return tuple(tuple(-v * factor / cell for v in slot)
                         for slot in vals)
        vals = _bn.readout_binned(self._spectral_meshes(rho, fft), dslots,
                                  valid, bounds=bounds, window=kind,
                                  procmesh=pmh)
        return tuple(tuple(v * factor for v in slot) for slot in vals)

    def _binned_loop(self, disp, time_steps, rebase_every, step_drift,
                     factors, scheme, fft, force_mode):
        """What both binned integrators share: the per-step coefficient
        triples (0-d tensors on the device, in the state dtype), the
        paint bounds, the force in cells per slot and one KDK step."""
        fac = _FACTORS[factors](self.cosmology) \
            if isinstance(factors, str) else factors
        dtype, device = disp[0].dtype, disp[0].device
        K1, D1s, K2 = (torch.as_tensor(a, device=device).to(dtype)
                       for a in leapfrog_factors(time_steps, fac, scheme))
        cell = float(self.pm.BoxSize[0] / self.pm.Nmesh[0])
        drift = float(step_drift) * rebase_every
        bounds = (-drift, 1.0 + drift)

        def force_cells(dslots, valid):
            F = self.force_binned(dslots, valid, bounds, fft=fft,
                                  mode=force_mode)
            return tuple(tuple(f / cell for f in slot) for slot in F)

        def kdk(dslots, vslots, valid, F, co):
            k1, d1, k2 = co
            vslots = tuple(tuple(v + f * k1 for v, f in zip(vk, fk))
                           for vk, fk in zip(vslots, F))
            dslots = tuple(tuple(s + v * d1 for s, v in zip(dk, vk))
                           for dk, vk in zip(dslots, vslots))
            F = force_cells(dslots, valid)
            vslots = tuple(tuple(v + f * k2 for v, f in zip(vk, fk))
                           for vk, fk in zip(vslots, F))
            return dslots, vslots, F

        return list(zip(K1, D1s, K2)), bounds, force_cells, kdk

    def nbody_binned(self, disp, vel, time_steps, nslots=2, rebase_every=4,
                     step_drift=0.25, factors='fastpm', scheme='symp2',
                     fft='xla', force_mode='spectral', adaptive=False):
        """KDK loop on the binned state with a periodic rebase:
        displacements stay within (-drift, 1 + drift) cells for ever, so
        there is no nv^3 cost wall and no silent mass loss (an overflow
        or an out-of-budget drift poisons the state with NaN and is
        counted in the returned overflow).

        ``disp``/``vel`` are lattice-form per-axis meshes (cells);
        ``step_drift`` bounds |velocity * dt| per step, and every
        ``rebase_every`` steps the state is rebased.  The loop keeps
        the state, the coefficients and the overflow count on the
        device, with no host sync.  Returns (dslots, vslots, valid,
        overflow).

        ``adaptive=True`` measures the needed slot count before every
        rebase (ops/binned.needed_slots, one integer synced to the host)
        and grows the state instead of poisoning it; the returned slot
        count is ``len(dslots)`` and ``self.last_binned_stats`` records
        the growth events."""
        _check_force_args(fft, force_mode)
        if adaptive:
            return self._nbody_binned_adaptive(
                disp, vel, time_steps, nslots, rebase_every, step_drift,
                factors, scheme, fft, force_mode)
        coeffs, bounds, force_cells, kdk = self._binned_loop(
            disp, time_steps, rebase_every, step_drift, factors, scheme,
            fft, force_mode)
        pmh = self._pmh
        if pmh is None:
            # the sort-based fold takes any initial excursion in O(N)
            # memory
            dslots, vslots, valid, overflow = _bn.fold_lattice(
                disp, vel, nslots=nslots)
        else:
            dslots, vslots, valid, overflow = self._sharded_fold(
                disp, vel, nslots, nslots)
        F = force_cells(dslots, valid)
        R = int(rebase_every)
        done = 0
        while done < len(coeffs):
            for co in coeffs[done:done + R]:
                dslots, vslots, F = kdk(dslots, vslots, valid, F, co)
            done += R
            # the force is recomputed after the rebase rather than moved
            # by it: moving F would cost 3 * nslots more meshes
            del F
            state = [dslots, vslots, valid]
            del dslots, vslots, valid
            dslots, vslots, valid, ov = _rebase_prog(state, bounds,
                                                     procmesh=pmh)
            overflow = overflow + ov
            if done < len(coeffs):
                F = force_cells(dslots, valid)
        return dslots, vslots, valid, overflow

    def _nbody_binned_adaptive(self, disp, vel, time_steps, nslots,
                               rebase_every, step_drift, factors, scheme,
                               fft, force_mode):
        """Superstep loop with measured slot growth (see
        :meth:`nbody_binned`, adaptive=True).  The KDK steps between
        rebases stay on the device; each rebase boundary syncs the
        needed slot count to the host."""
        coeffs, bounds, force_cells, kdk = self._binned_loop(
            disp, time_steps, rebase_every, step_drift, factors, scheme,
            fft, force_mode)
        pmh = self._pmh
        if pmh is None:
            # the fold measures the needed slot count from the in-cell
            # ranks
            K = max(nslots, int(_bn.fold_needed(disp)))
            dslots, vslots, valid, overflow = _bn.fold_lattice(disp, vel,
                                                               nslots=K)
        else:
            dslots, vslots, valid, overflow = self._sharded_fold(
                disp, vel, nslots, None)
            K = len(dslots)
        # an initial fold that already grew the state counts as growth
        growth_events = int(K > nslots)
        R = int(rebase_every)
        done = 0
        while done < len(coeffs):
            F = force_cells(dslots, valid)
            for co in coeffs[done:done + R]:
                dslots, vslots, F = kdk(dslots, vslots, valid, F, co)
            done += R
            del F
            Kout = max(K, int(_bn.needed_slots(dslots, valid, bounds,
                                               procmesh=pmh)))
            growth_events += int(Kout > K)
            state = [dslots, vslots, valid]
            del dslots, vslots, valid
            dslots, vslots, valid, ov = _rebase_prog(state, bounds, Kout,
                                                     procmesh=pmh)
            overflow = overflow + ov
            K = Kout
        # observability for benches and monitors: how often the state
        # grew and where it ended up
        self.last_binned_stats = {'growth_events': growth_events,
                                  'final_nslots': K,
                                  'overflow': int(overflow)}
        return dslots, vslots, valid, overflow

    def _sharded_fold(self, disp, vel, nslots, nslots_out):
        """The sharded loops' initial fold (the JAX package's,
        ``pmesh_tpu/models/fastpm.py:982-991`` and ``1134-1144``): the
        lattice state wrapped as ``nslots`` slots, then one rebase over the
        global extremes of the displacements, widened to (0, 1), into
        ``nslots_out`` slots (None: the global needed slot count, at
        least ``nslots``).  Returns (dslots, vslots, valid, overflow)."""
        pmh = self._pmh
        dslots, vslots, valid = _bn.from_lattice(disp, vel, nslots=nslots)
        lo, hi = _gp.displacement_bounds(tuple(d.detach() for d in disp))
        lo = float(all_reduce(lo, pmh, 'min'))
        hi = float(all_reduce(hi, pmh, 'max'))
        b0 = (min(lo, 0.0), max(hi, 1.0))
        if nslots_out is None:
            nslots_out = max(nslots, int(_bn.needed_slots(
                dslots, valid, b0, procmesh=pmh)))
        state = [dslots, vslots, valid]
        del dslots, vslots, valid
        return _rebase_prog(state, b0, nslots_out, procmesh=pmh)


def _rebase_prog(state, bounds, nslots_out=None, procmesh=None):
    """One rebase with velocities of a binned state held in the list
    ``state`` = [dslots, vslots, valid], which it empties.  It takes the
    place of the JAX package's donated jit program: with no other
    reference held, the old displacements and validity are freed after
    the assign and the old velocities after the apply, so the old and
    new state never coexist for longer than one phase.  Returns
    (dslots, vslots, valid, overflow)."""
    dslots, vslots, valid = state
    state.clear()
    inner = [dslots, valid, (vslots,)]
    del dslots, vslots, valid
    dslots, valid, (vslots,), overflow = _bn._rebase(inner, bounds,
                                                     nslots_out,
                                                     procmesh=procmesh)
    return dslots, vslots, valid, overflow


def lpt(pm, dlinear, a0, cosmology=None, order=2, shift=0.0):
    """The LPT :class:`State` of ``Solver(pm, cosmology).lpt``."""
    return Solver(pm, cosmology).lpt(dlinear, a0, order=order, shift=shift)
