"""Time the KDK step of the lattice path (chip_smoke.py's phase-4 run) on
the first GPU, for each FFT: lpt_lattice at a = 0.1 from seeded white
noise with P(k) ~ k^-1 (rms first-order displacement 0.05 cells), then
nbody_lattice to a = 0.2 inside (-1, 1), at N^3 in a 2N Mpc/h box.

    python3 tools/time_lattice_step.py [--root DIR] [--n N] [--fft F ...]

--root imports pmesh_tpu_torch from DIR (an unpacked checkout of another
commit: time two commits in one call, in the order A, B, B, A); the
default is this checkout.  Prints the card's name and power limit, then
one line per FFT: ms per KDK step (CUDA events around a 5- and a 1-step
run, their difference / 4, after a warm-up run), and the peak device
memory of the 5-step run.
"""
import argparse
import os
import subprocess
import sys

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--root', default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument('--n', type=int, default=512)
    ap.add_argument('--fft', nargs='+', default=['mxu_bf16', 'mxu', 'xla'])
    a = ap.parse_args()
    sys.path.insert(0, os.path.abspath(a.root))
    import torch
    from pmesh_tpu_torch import ParticleMesh, RealField
    from pmesh_tpu_torch.models.cosmology import Planck15
    from pmesh_tpu_torch.models.fastpm import Solver
    from pmesh_tpu_torch.ops import transfer as tf
    if not torch.cuda.is_available():
        sys.exit("time_lattice_step: needs a CUDA GPU")
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True).stdout.strip()
    dev = torch.device('cuda')
    N, a0, steps = a.n, 0.1, np.linspace(0.1, 0.2, 6)
    pm = ParticleMesh([N] * 3, BoxSize=2.0 * N, dtype='f4', resampler='cic',
                      device=dev)
    gen = torch.Generator(device=dev).manual_seed(42)
    noise = torch.randn((N,) * 3, generator=gen, device=dev)
    dk = pm.create(type=RealField, value=noise).r2c().apply(
        lambda k, v: v * torch.where(k.normp(2) > 0,
                                     k.normp(2, zeromode=1.0) ** -0.25, 0.0))
    sigma = float(dk.apply(tf.dx1_transfer(0)).c2r().value.std()) / 2.0
    dlinear = pm.create(type=type(dk),
                        value=dk.value * (0.05 / (sigma * Planck15.D1(a0))))
    solver = Solver(pm)

    def run(fft, nst):
        disp, vel = solver.lpt_lattice(dlinear, a0, order=2)
        return solver.nbody_lattice(disp, vel, steps[:nst + 1], (-1.0, 1.0),
                                    fft=fft)

    def cuda_ms(fn):
        torch.cuda.synchronize()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        t1.synchronize()
        return t0.elapsed_time(t1)

    print(card)
    print("root %s, torch %s, %d^3" % (os.path.abspath(a.root),
                                       torch.__version__, N))
    for fft in a.fft:
        run(fft, 1)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t5 = cuda_ms(lambda: run(fft, 5))
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        t1 = cuda_ms(lambda: run(fft, 1))
        print("fft=%-9s %.3f ms per KDK step (5-step run %.3f ms, 1-step "
              "run %.3f ms), peak %.2f GiB" % (fft, (t5 - t1) / 4, t5, t1,
                                               peak), flush=True)


if __name__ == "__main__":
    main()
