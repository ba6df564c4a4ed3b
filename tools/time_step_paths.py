"""Time the two step paths that chip_smoke.py times but
tools/time_lattice_step.py does not, on the first GPU:

- bench.py's clustered superstep: the 384^3 caustic flow grown by
  nbody_binned(adaptive=True, fft='mxu') (chip_smoke's phase 5 run),
  then ms per KDK step of the superstep (two KDK steps of two forces and
  a rebase) from the grown state with fft='mxu' and 'xla', in the order
  mxu, xla, xla, mxu, a warm-up then two timed each, as phase 5 does;
- reverse mode at 512^3: ms per KDK step of the gradient of a
  nbody_lattice loss with respect to the initial (disp, vel) (a 2-step
  minus a 1-step run, forward alone and forward + backward), fft='mxu'
  and 'xla', as phase 4d does.

    python3 tools/time_step_paths.py [--root DIR]

--root imports pmesh_tpu_torch and chip_smoke.py's helpers from DIR (an
unpacked checkout of another commit: time two commits in one call, in
the order A, B, B, A); the default is this checkout.  Prints the card's
name and power limit, then one line per path.
"""
import argparse
import os
import subprocess
import sys
import time


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--root', default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    a = ap.parse_args()
    sys.path.insert(0, os.path.abspath(a.root))
    import torch
    import chip_smoke as cs
    if not torch.cuda.is_available():
        sys.exit("time_step_paths: needs a CUDA GPU")
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True).stdout.strip()
    print("%s; root %s" % (card, os.path.abspath(a.root)), flush=True)
    dev = torch.device('cuda', 0)
    torch.cuda.set_device(dev)

    _, grown = cs.phase_binned_clustered(dev)
    ms = {}
    for fft in ('mxu', 'xla', 'xla', 'mxu'):
        for rep in range(3):
            if rep == 1:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            cs.clustered_superstep(grown['solver'], grown['dslots'],
                                   grown['vslots'], grown['valid'], fft)
        torch.cuda.synchronize()
        ms.setdefault(fft, []).append((time.perf_counter() - t0) / 4 * 1e3)
    print("clustered %d^3 K=%d superstep, ms per KDK step: mxu %s, xla %s"
          % (cs.NC, len(grown['dslots']),
             ", ".join("%.3f" % t for t in ms['mxu']),
             ", ".join("%.3f" % t for t in ms['xla'])), flush=True)
    del grown
    torch.cuda.empty_cache()

    from pmesh_tpu_torch import ParticleMesh
    from pmesh_tpu_torch.models.fastpm import Solver
    pm = ParticleMesh([cs.N] * 3, BoxSize=cs.BOX, dtype='f4',
                      resampler='cic', device=dev)
    dlinear = cs.linear_field(pm, torch.Generator(device=dev)
                              .manual_seed(cs.SEED))
    solver = Solver(pm)
    state = sum(solver.lpt_lattice(dlinear, cs.A0, order=2), ())
    for fft in ('mxu', 'xla'):
        t = {}
        for nst in (1, 2):
            steps = cs.GRAD_STEPS[:nst + 1]
            for back in (False, True):
                t[(nst, back)] = cs.cuda_ms(
                    lambda: cs.grad_run(solver, state, steps, fft, back), 1)
        print("reverse mode %d^3 fft=%r, ms per KDK step: forward %.3f, "
              "forward + backward %.3f" % (cs.N, fft,
                                           t[(2, False)] - t[(1, False)],
                                           t[(2, True)] - t[(1, True)]),
              flush=True)


if __name__ == '__main__':
    main()
