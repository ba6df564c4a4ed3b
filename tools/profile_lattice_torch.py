"""Device time of the port's 512^3 lattice KDK step by kernel family.

Runs 2 KDK steps of ``nbody_lattice`` from chip_smoke.py's LPT state
(N, BOX, SEED, A0, STEPS, BOUNDS) with each ``fft`` (default 'mxu',
'mxu_bf16', 'mxu_bf16s' and 'xla') under ``torch.profiler`` and prints
the host wall time, the device busy time (the union of the kernel
intervals), the idle share and the device time of each kernel family
(chip_smoke.family; other kernels by name).  Needs an NVIDIA GPU; run
from the repository root:

    python3 tools/profile_lattice_torch.py [--fft mxu xla ...]
"""
import argparse
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from pmesh_tpu_torch import ParticleMesh  # noqa: E402
from pmesh_tpu_torch.models.fastpm import Solver  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--fft', nargs='+',
                    default=['mxu', 'mxu_bf16', 'mxu_bf16s', 'xla'])
    ffts = ap.parse_args().fft
    if not torch.cuda.is_available():
        sys.exit("profile_lattice_torch: needs a CUDA GPU")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    dev = torch.device('cuda', 0)
    torch.cuda.set_device(dev)
    pm = ParticleMesh([cs.N] * 3, BoxSize=cs.BOX, dtype='f4', device=dev)
    dlin = cs.linear_field(pm, torch.Generator(device=dev).manual_seed(cs.SEED))
    solver = Solver(pm)
    disp, vel = solver.lpt_lattice(dlin, cs.A0, order=2)
    steps = cs.STEPS[:3]
    for fft in ffts:
        solver.nbody_lattice(disp, vel, steps, cs.BOUNDS, fft=fft)
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            solver.nbody_lattice(disp, vel, steps, cs.BOUNDS, fft=fft)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        fams, spans = {}, []
        for e in prof.events():
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue
            a, b = e.time_range.start, e.time_range.end
            spans.append((a, b))
            f = cs.family(e.name)
            if f == "other":
                f = e.name[:40]
            fams[f] = fams.get(f, 0.0) + (b - a) / 1e3
        busy = cs.busy_us(spans) / 1e3
        print("fft=%s 2 KDK steps at %d^3: wall %.3f ms, device busy %.3f ms, "
              "idle %.4f" % (fft, cs.N, wall, busy, 1 - busy / wall))
        for f, ms in sorted(fams.items(), key=lambda kv: -kv[1])[:12]:
            print("   %-42s %9.3f ms %5.1f %%" % (f, ms, 100 * ms / busy))


if __name__ == "__main__":
    main()
