"""PM gravity N-body simulations (CLI).

Counterpart of ``pmesh_tpu/models/gravpm.py``: 2LPT initial conditions
from a linear power spectrum, the FastPM leapfrog, P(k) measured at the
requested snapshot times, and snapshots written as bigfile (the
reference ecosystem container, ``utils/bigfile.py``) or numpy .npz.
:func:`read_ic` reads positions back from any bigfile Gadget snapshot.

Two modes, as in the JAX package: the catalog mode (``Solver.lpt`` and
``Solver.nbody``: the generic paint and readout, any boost), and the
lattice mode (``lattice=True``, boost 1: ``lpt_lattice`` and
``nbody_lattice`` on the mesh-shaped state, whose paint, readout and,
with ``fft`` 'mxu', 'mxu_bf16' or 'mxu_bf16s', DFT passes are the hand
CUDA kernels on the card).  Everything runs on ``device`` (default the
current CUDA device).

Run on the card:  python -m pmesh_tpu_torch.models.gravpm --nmesh 64 \\
          --boost 2 --steps 10 --output /tmp/run
"""
import os
from argparse import ArgumentParser

import numpy as np

from ..pm import ParticleMesh
from ..ops.power import fftpower
from ..utils.timers import Timers
from .cosmology import Planck15
from .powerspectrum import EHPower
from .fastpm import Solver

__all__ = ["main", "run_sim", "read_ic", "lattice_bounds"]


def _host(t):
    return t.detach().cpu().numpy()


def run_sim(nmesh=64, boxsize=256.0, boost=2, resampler='tsc',
            seed=120577, ainit=0.1, afinal=1.0, steps=10, order=2,
            unitary=True, compat='native', dtype='f8',
            snapshot_times=(), output=None, monitor_print=True,
            procmesh=None, lattice=False, fft='xla',
            force_mode='spectral', snapshot_format='bigfile', device=None,
            timers=None):
    """Run the IC -> N-body -> P(k) pipeline; returns the final state (a
    catalog ``State``, or the lattice ``(disp, vel)``) and the list of
    measured spectra ``(a, k, P)`` (numpy).

    ``steps`` time steps are spaced evenly in a from ``ainit`` to
    ``afinal`` (steps - 1 KDK steps).  lattice=True needs boost=1; its
    displacement bounds are :func:`lattice_bounds`.  ``fft`` picks the
    lattice force's transforms ('xla', 'mxu', 'mxu_bf16', 'mxu_bf16s').
    ``timers`` (a ``utils.timers.Timers``) accumulates the phases 'ic',
    'nbody' and 'measure' (the snapshots: painting, P(k) and writing,
    also those taken inside the N-body loop).
    """
    if lattice and boost != 1:
        raise ValueError("lattice=True requires boost=1 (the force "
                         "mesh must equal the particle lattice)")
    if force_mode not in ('spectral', 'gradient'):
        raise ValueError("force_mode must be 'spectral' or "
                         "'gradient', got %r" % (force_mode,))
    timers = Timers() if timers is None else timers
    pm = ParticleMesh(BoxSize=boxsize, Nmesh=[nmesh] * 3,
                      resampler=resampler, dtype=dtype, device=device,
                      procmesh=procmesh)
    solver = Solver(pm, Planck15, B=boost, force_resampler=resampler)
    power = EHPower(Planck15, redshift=0.0)

    with timers['ic']:
        dlin = solver.linear_field(power, seed=seed, unitary=unitary,
                                   compat=compat)
    if lattice:
        return _run_lattice(pm, solver, dlin, ainit, afinal, steps,
                            order, snapshot_times, output,
                            monitor_print, fft, force_mode, timers)
    with timers['ic']:
        state = solver.lpt(dlin, a0=ainit, order=order, shift=0.0)
    del dlin

    time_steps = np.linspace(ainit, afinal, steps, endpoint=True)
    spectra = []
    snapshot_times = sorted(snapshot_times)

    def measure(a, state):
        with timers['measure']:
            rho = pm.paint(state.X)
            k, p, n = fftpower(
                rho, Nbins=nmesh // 4,
                remove_shotnoise=float(np.prod(pm.BoxSize))
                / state.Q.shape[0])
            k, p = _host(k), _host(p)
            spectra.append((a, k, p))
            if monitor_print:
                print("a = %.3f   P(k~%.3g) = %.5g" % (a, k[1], p[1]))
            if output is not None:
                _write_snapshot(output, a, state, k, p, pm,
                                fmt=snapshot_format)

    measured = set()

    def monitor(a, state):
        due = [tm for tm in snapshot_times if a >= tm - 1e-9]
        if due:
            # one measurement per crossing, however many marks it
            # passed; tagged by the scale factor actually measured
            measure(a, state)
            measured.add(round(float(a), 12))
            for tm in due:
                snapshot_times.remove(tm)

    use_monitor = monitor if snapshot_times else None
    with timers['nbody']:
        state = solver.nbody(state, time_steps, factors='fastpm',
                             scheme='symp2', monitor=use_monitor,
                             force_mode=force_mode)
    if round(float(afinal), 12) not in measured:
        measure(afinal, state)
    return state, spectra


def lattice_bounds(solver, disp, ainit, afinal):
    """The lattice run's displacement bounds in cells: the LPT extremes
    of ``disp`` widened to their largest magnitude grown linearly to
    ``afinal``, with a 30 % quasilinear margin, in both directions."""
    from ..ops import gridpm
    lo, hi = (float(b) for b in gridpm.displacement_bounds(disp))
    pt = solver.cosmology
    grow = float(pt.D1(afinal)) / float(pt.D1(ainit))
    amp = max(abs(lo), abs(hi)) * 1.3 * grow
    return (min(lo, -amp), max(hi, amp))


def _run_lattice(pm, solver, dlin, ainit, afinal, steps, order,
                 snapshot_times, output, monitor_print, fft='xla',
                 force_mode='spectral', timers=None):
    """The lattice-form run: mesh-shaped state, shift-sum paint and
    readout, snapshots between segments of nbody_lattice calls.  A
    displacement past the bounds poisons the state with NaN inside the
    loop (``nbody_lattice``)."""
    from ..ops import gridpm

    nmesh = int(pm.Nmesh[0])
    cell = float(pm.BoxSize[0]) / nmesh
    with timers['ic']:
        disp, vel = solver.lpt_lattice(dlin, a0=ainit, order=order)
    del dlin
    bounds = lattice_bounds(solver, disp, ainit, afinal)

    spectra = []
    pmh = pm.procmesh if pm.sharded else None

    def measure(a, disp):
        with timers['measure']:
            rho = gridpm.paint_grid(disp, bounds=bounds,
                                    window=pm.resampler.window.kind,
                                    procmesh=pmh)
            field = pm.create(type='real', value=rho)
            k, p, n = fftpower(field, Nbins=nmesh // 4,
                               remove_shotnoise=float(
                                   np.prod(pm.BoxSize)) / nmesh ** 3)
            k, p = _host(k), _host(p)
            spectra.append((a, k, p))
            if monitor_print:
                print("a = %.3f   P(k~%.3g) = %.5g" % (a, k[1], p[1]))
            if output is not None:
                _write_lattice_snapshot(output, a, disp, vel, cell, k, p)

    # marks before ainit cannot be reached by a forward integration;
    # a mark AT ainit measures the ICs
    marks = sorted(set(
        [t for t in snapshot_times
         if ainit - 1e-12 <= t <= afinal + 1e-12] + [afinal]))
    all_steps = np.linspace(ainit, afinal, steps, endpoint=True)
    a0 = ainit
    for am in marks:
        seg = [a for a in all_steps if a0 - 1e-12 < a <= am + 1e-12]
        seg = sorted(set([a0] + seg + [am]))
        if len(seg) >= 2:
            with timers['nbody']:
                disp, vel = solver.nbody_lattice(disp, vel, seg, bounds,
                                                 force_mode=force_mode,
                                                 fft=fft)
        measure(am, disp)
        a0 = am
    return (disp, vel), spectra


def _write_lattice_snapshot(output, a, disp, vel, cell, k, p):
    os.makedirs(output, exist_ok=True)
    fn = os.path.join(output, "snapshot_a%.4f.npz" % a)
    np.savez(fn, a=a,
             DispX=_host(disp[0]), DispY=_host(disp[1]),
             DispZ=_host(disp[2]),
             VelX=_host(vel[0]), VelY=_host(vel[1]), VelZ=_host(vel[2]),
             cell=cell, k=k, power=p)
    print("wrote", fn)


def _write_snapshot(output, a, state, k, p, pm=None, fmt='bigfile'):
    os.makedirs(output, exist_ok=True)
    n = state.Q.shape[0]
    if fmt == 'npz':
        fn = os.path.join(output, "snapshot_a%.4f.npz" % a)
        np.savez(fn, a=a, Position=_host(state.X),
                 Velocity=_host(state.V), ID=np.arange(n), k=k, power=p)
        print("wrote", fn)
        return
    # the reference's Gadget layout: particle type 1 blocks and a root
    # header block
    from ..utils import bigfile as _bf
    fn = os.path.join(output, "snapshot_a%.4f" % a)
    attrs = {'Time': float(a), 'TotNumPart':
             np.array([0, n, 0, 0, 0, 0], dtype='i8')}
    if pm is not None:
        attrs['BoxSize'] = float(pm.BoxSize[0])
    _bf.write_block(fn, 'header', data=None, attrs=attrs)
    _bf.write_block(fn, '1/Position', _host(state.X))
    _bf.write_block(fn, '1/Velocity', _host(state.V))
    _bf.write_block(fn, '1/ID', np.arange(n, dtype='i8'))
    _bf.write_block(fn, 'PowerSpectrum/k', k)
    _bf.write_block(fn, 'PowerSpectrum/P', p)
    print("wrote", fn)


def read_ic(path, ptype=1):
    """Position/Velocity/ID of particle type ``ptype`` from a bigfile
    Gadget snapshot, as numpy arrays (Velocity and ID None where
    absent), and the root attributes: (pos, vel, ids, attrs)."""
    from ..utils import bigfile as _bf
    f = _bf.BigFile(path)
    prefix = '%d/' % ptype
    pos = f[prefix + 'Position'].read()
    vel = (f[prefix + 'Velocity'].read()
           if prefix + 'Velocity' in f else None)
    ids = (f[prefix + 'ID'].read()
           if prefix + 'ID' in f else None)
    return pos, vel, ids, f.attrs


def main(argv=None):
    ap = ArgumentParser(description="FastPM gravity N-body simulation")
    ap.add_argument("--nmesh", type=int, default=64,
                    help="particle grid per side")
    ap.add_argument("--boxsize", type=float, default=256.0)
    ap.add_argument("--boost", type=int, default=2,
                    help="force mesh boost factor")
    ap.add_argument("--resampler", type=str, default='tsc')
    ap.add_argument("--seed", type=int, default=120577)
    ap.add_argument("--ainit", type=float, default=0.1)
    ap.add_argument("--afinal", type=float, default=1.0)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--order", type=int, default=2, choices=[1, 2],
                    help="LPT order of the ICs")
    ap.add_argument("--compat", type=str, default='native',
                    choices=['native', 'gadget'],
                    help="whitenoise stream")
    ap.add_argument("--dtype", type=str, default='f8')
    ap.add_argument("--snapshot-times", type=float, nargs='*',
                    default=[])
    ap.add_argument("--output", type=str, default=None)
    ap.add_argument("--lattice", action='store_true',
                    help="mesh-shaped fast path (requires --boost 1)")
    ap.add_argument("--fft", type=str, default='xla',
                    choices=['xla', 'mxu', 'mxu_bf16', 'mxu_bf16s'],
                    help="transform backend for the lattice force")
    ap.add_argument("--force-mode", type=str, default='spectral',
                    choices=['spectral', 'gradient'],
                    help="force family: 3 spectral inverses, or one "
                         "Poisson inverse + derivative-window "
                         "readouts (the QPM route)")
    ap.add_argument("--format", type=str, default='bigfile',
                    choices=['bigfile', 'npz'],
                    help="snapshot container format")
    ap.add_argument("--device", type=str, default=None,
                    help="torch device (default the current CUDA device)")
    ns = ap.parse_args(argv)

    timers = Timers()
    state, spectra = run_sim(
        nmesh=ns.nmesh, boxsize=ns.boxsize, boost=ns.boost,
        resampler=ns.resampler, seed=ns.seed, ainit=ns.ainit,
        afinal=ns.afinal, steps=ns.steps, order=ns.order,
        compat=ns.compat, dtype=ns.dtype,
        snapshot_times=ns.snapshot_times, output=ns.output,
        lattice=ns.lattice, fft=ns.fft, force_mode=ns.force_mode,
        snapshot_format=ns.format, device=ns.device, timers=timers)
    print(timers)
    return state, spectra


if __name__ == '__main__':
    main()
