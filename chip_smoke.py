#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (pmesh_tpu_torch) end to end on one
NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero:

1. a CUDA device must be present (there is no CPU path); print the
   card's name and power limit as nvidia-smi reports them;
2. build the CUDA kernels from pmesh_tpu_torch/csrc with nvcc;
3. hold each kernel against its plain PyTorch version at 512^3 f32,
   CIC, on the same tensors on the card, for three displacement bounds
   (nv = 3 and 5 offsets per axis), and time both;
4. drive the FastPM lattice path at 512^3 f32 through the user's entry
   points: Solver.lpt_lattice (2LPT) then Solver.nbody_lattice (5 KDK
   steps, spectral force) and one gradient-mode force_lattice, with
   the kernels' launch counters read around the run; check that the
   state is finite, that a paint of it conserves mass and that the
   kernels carried the run; time one KDK step with CUDA events;
5. run the same path at 32^3 on the card and on the CPU (plain
   versions, pocketfft) from the same seed and compare.

The second-to-last line is the kernels' JSON record, the last line
the device record.
"""
import json
import subprocess
import sys
import time

import numpy as np
import torch

N = 512
BOX = 1024.0            # Mpc/h: 2 Mpc/h cells
BOUNDS = (-1.0, 1.0)    # main-path displacement bounds, nv = 3
COMPARE_BOUNDS = ((-1.0, 1.0), (0.0, 2.0), (-2.0, 2.0))
A0 = 0.1
STEPS = np.linspace(0.1, 0.2, 6)   # 5 KDK steps
SIGMA0 = 0.05           # rms first-order displacement at A0, cells
SPECTRAL_INDEX = -1.0   # P(k) ~ k^n of the linear field
SEED = 42
TOL_KERNEL = 1e-5       # max|kernel - plain| / max|plain|
TOL_MASS = 1e-5
TOL_SMALL = 1e-4        # 32^3 card vs CPU, of max|S|

KERNELS = {
    "paint_lattice": "pmesh_tpu/ops/gridpm_pallas.py:491",
    "readout_lattice": "pmesh_tpu/ops/gridpm_pallas.py:171",
}


def log(*args):
    print(*args, flush=True)


def cuda_ms(fn, reps):
    """Mean device time of fn() over reps calls, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def linear_field(pm, gen):
    """Seeded white noise shaped to P(k) ~ k^SPECTRAL_INDEX, scaled so
    the rms first-order displacement at A0 is SIGMA0 cells."""
    from pmesh_tpu_torch import RealField
    from pmesh_tpu_torch.ops import transfer as tf
    noise = torch.randn(tuple(int(n) for n in pm.Nmesh), generator=gen,
                        device=pm.device, dtype=pm.torch_dtype)
    half = SPECTRAL_INDEX / 4.0   # |delta_k| ~ (k^2)^(n/4)
    dk = pm.create(type=RealField, value=noise).r2c().apply(
        lambda k, v: v * torch.where(k.normp(2) > 0,
                                     k.normp(2, zeromode=1.0) ** half, 0.0))
    cell = float(pm.BoxSize[0] / pm.Nmesh[0])
    sigma = float(dk.apply(tf.dx1_transfer(0)).c2r().value.std()) / cell
    from pmesh_tpu_torch.models.cosmology import Planck15
    scale = SIGMA0 / (sigma * Planck15.D1(A0))
    return pm.create(type=type(dk), value=dk.value * scale)


def phase_device():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need one",
              file=sys.stderr)
        sys.exit(1)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    log(smi.stdout.strip().splitlines()[0])
    log("phase 1 device: %s, torch %s, CUDA %s, %d device(s)"
        % (torch.cuda.get_device_name(0), torch.__version__,
           torch.version.cuda, torch.cuda.device_count()))


def phase_build():
    from pmesh_tpu_torch.native import cuda
    info = cuda.build("gridpm")
    ptxas = [ln.strip() for ln in info["log"].splitlines()
             if "registers" in ln or "spill" in ln]
    log("phase 2 build: gridpm.cu with nvcc %s in %.3f s"
        % (" ".join(cuda.NVCC_FLAGS), info["seconds"]))
    for ln in ptxas:
        log("  ptxas: " + ln)
    return info["seconds"]


def phase_compare(dev):
    """kernel vs plain at N^3; returns {kernel: record} at BOUNDS."""
    from pmesh_tpu_torch.ops import gridpm as gp
    from pmesh_tpu_torch.ops import gridpm_cuda
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    shape = (N,) * 3
    meshes = tuple(torch.randn(shape, generator=gen, device=dev)
                   for _ in range(3))
    records = {}
    for bounds in COMPARE_BOUNDS:
        lo, hi = bounds
        disp = tuple(lo + (hi - lo) * torch.rand(shape, generator=gen,
                                                 device=dev)
                     for _ in range(3))
        vmin, vmax = gp.offset_range(lo, hi, 'cic')
        cases = {
            "paint": ("paint_lattice",
                      lambda impl: (gp.paint_grid(disp, bounds=bounds,
                                                  impl=impl),)),
            "readout 1 mesh": ("readout_lattice",
                               lambda impl: (gp.readout_grid(
                                   meshes[0], disp, bounds, impl=impl),)),
            "readout diffdir=0": ("readout_lattice",
                                  lambda impl: (gp.readout_grid(
                                      meshes[0], disp, bounds, diffdir=0,
                                      impl=impl),)),
            "readout diffdir='all'": ("readout_lattice",
                                      lambda impl: gp.readout_grid(
                                          meshes[0], disp, bounds,
                                          diffdir='all', impl=impl)),
            # the three meshes in ONE launch of the kernel
            "readout 3 meshes": ("readout_lattice",
                                 lambda impl: (
                                     gp.readout_grid(meshes, disp, bounds,
                                                     impl='torch')
                                     if impl == 'torch' else
                                     gridpm_cuda.readout_lattice(
                                         meshes, disp, vmin, vmax,
                                         'cic'))),
        }
        for name, (kernel, fn) in cases.items():
            plain = fn('torch')
            got = fn('cuda')
            abs_err = max(float((g - p).abs().max())
                          for g, p in zip(got, plain))
            scale = max(float(p.abs().max()) for p in plain)
            rel = abs_err / scale
            ms = cuda_ms(lambda: fn('cuda'), 5)
            plain_ms = cuda_ms(lambda: fn('torch'), 1)
            ok = rel <= TOL_KERNEL and np.isfinite(rel)
            log("phase 3 compare: %-22s bounds=%-11s nv=%d  max|k-p|/max|p|"
                " = %.3e (tol %.0e) %s  kernel %.3f ms  plain %.3f ms"
                % (name, bounds, vmax - vmin + 1, rel, TOL_KERNEL,
                   "ok" if ok else "FAIL", ms, plain_ms))
            if not ok:
                raise AssertionError("%s disagrees with its plain version"
                                     % name)
            if bounds == BOUNDS and name in ("paint", "readout 1 mesh"):
                records[kernel] = dict(max_abs_err=abs_err, ms=ms,
                                       plain_ms=plain_ms)
            elif kernel in records and bounds == BOUNDS:
                records[kernel]["max_abs_err"] = max(
                    records[kernel]["max_abs_err"], abs_err)
        del disp
    del meshes
    torch.cuda.empty_cache()
    return records


def run_path(pm, dlinear, steps):
    from pmesh_tpu_torch.models.fastpm import Solver
    solver = Solver(pm)
    disp, vel = solver.lpt_lattice(dlinear, A0, order=2)
    S, V = solver.nbody_lattice(disp, vel, steps, BOUNDS, fft='xla')
    return solver, disp, vel, S, V


def phase_main(dev):
    from pmesh_tpu_torch import ParticleMesh
    from pmesh_tpu_torch.ops import gridpm as gp
    from pmesh_tpu_torch.ops import gridpm_cuda
    pm = ParticleMesh([N] * 3, BoxSize=BOX, dtype='f4', resampler='cic',
                      device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    dlinear = linear_field(pm, gen)
    nsteps = len(STEPS) - 1

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gridpm_cuda.reset_launches()
    t0 = time.perf_counter()
    solver, disp, vel, S, V = run_path(pm, dlinear, STEPS)
    Fg = solver.force_lattice(S, BOUNDS, mode='gradient', fft='xla')
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(gridpm_cuda.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30

    lpt_max = max(float(d.abs().max()) for d in disp)
    finite = all(bool(torch.isfinite(x).all()) for x in S + V + Fg)
    smax = max(float(s.abs().max()) for s in S)
    rho = gp.paint_grid(S, bounds=BOUNDS)
    mass_err = abs(float(rho.double().sum()) - N ** 3) / N ** 3
    log("phase 4 main path: %d^3 f4 cic, lpt_lattice(order=2) max|disp| "
        "%.4f cells, nbody_lattice %d KDK steps a=%.3f..%.3f + 1 gradient "
        "force in %.3f s (first run), finite %s, final max|S| %.4f cells, "
        "mass error %.3e (tol %.0e), launches %s (need paint >= %d, "
        "readout >= %d), peak %.2f GB"
        % (N, lpt_max, nsteps, STEPS[0], STEPS[-1], wall, finite, smax,
           mass_err, TOL_MASS, json.dumps(launches), nsteps + 1,
           3 * (nsteps + 1), peak_gb))
    if not finite:
        raise AssertionError("the state is not finite (bounds poison?)")
    if not smax < BOUNDS[1]:
        raise AssertionError("displacements left the bounds")
    if not mass_err <= TOL_MASS:
        raise AssertionError("paint does not conserve mass")
    if launches["paint_lattice"] < nsteps + 1 \
            or launches["readout_lattice"] < 3 * (nsteps + 1):
        raise AssertionError("the kernels did not carry the main path")
    del S, V, Fg, rho

    # one KDK step: (6-step run - 1-step run) / 5, each from the same
    # LPT state; both runs include lpt_lattice and the initial force
    def run(nst):
        return lambda: run_path(pm, dlinear, STEPS[:nst + 1])
    t1 = cuda_ms(run(1), 1)
    t6 = cuda_ms(run(nsteps), 1)
    step_ms = (t6 - t1) / (nsteps - 1)
    f_spec = cuda_ms(lambda: solver.force_lattice(disp, BOUNDS), 3)
    f_grad = cuda_ms(lambda: solver.force_lattice(
        disp, BOUNDS, mode='gradient'), 3)
    log("phase 4 timing: %.3f ms per KDK step (%d-step run %.3f ms, "
        "1-step run %.3f ms), force_lattice spectral %.3f ms, gradient "
        "%.3f ms" % (step_ms, nsteps, t6, t1, f_spec, f_grad))
    del solver, disp, vel, dlinear
    torch.cuda.empty_cache()
    return launches, step_ms


def phase_small(dev):
    """32^3: the path on the card (kernels, cuFFT) against the same
    path on the CPU (plain versions, pocketfft)."""
    from pmesh_tpu_torch import ParticleMesh, RealField
    from pmesh_tpu_torch.models.fastpm import Solver
    n = 32
    noise = np.random.RandomState(SEED).normal(size=(n,) * 3).astype('f4')
    out = {}
    for device in ('cpu', dev):
        pm = ParticleMesh([n] * 3, BoxSize=64.0, dtype='f4',
                          resampler='cic', device=device)
        dk = pm.create(type=RealField,
                       value=torch.from_numpy(noise).to(device)).r2c()
        dk = dk.apply(lambda k, v: 0.3 * v * torch.where(
            k.normp(2) > 0, k.normp(2, zeromode=1.0) ** -0.25, 0.0))
        solver = Solver(pm)
        disp, vel = solver.lpt_lattice(dk, A0, order=2)
        S, V = solver.nbody_lattice(disp, vel, STEPS[:4], BOUNDS)
        out[str(device)] = [x.cpu().numpy() for x in S + V]
    ref, got = out['cpu'], out[str(dev)]
    smax = max(np.abs(s).max() for s in ref[:3])
    err = max(np.abs(a - b).max() for a, b in zip(ref[:3], got[:3])) / smax
    vmax = max(np.abs(v).max() for v in ref[3:])
    verr = max(np.abs(a - b).max() for a, b in zip(ref[3:], got[3:])) / vmax
    ok = (np.isfinite(err) and err <= TOL_SMALL and verr <= TOL_SMALL
          and 0.01 < smax < BOUNDS[1])
    log("phase 5 small input: 32^3 3 KDK steps, card vs CPU max|dS|/max|S|"
        " = %.3e, max|dV|/max|V| = %.3e (tol %.0e), max|S| %.4f %s"
        % (err, verr, TOL_SMALL, smax, "ok" if ok else "FAIL"))
    if not ok:
        raise AssertionError("the card and the CPU disagree at 32^3")


def main():
    phase_device()
    dev = torch.device('cuda', 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_build()
    records = phase_compare(dev)
    launches, _ = phase_main(dev)
    phase_small(dev)
    kernels = []
    for name, replaces in KERNELS.items():
        kernels.append(dict(name=name, route="cuda",
                            source="pmesh_tpu_torch/csrc/gridpm.cu",
                            replaces=replaces, launches=launches[name],
                            **records[name]))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
