"""Time the binned rebase kernels (csrc/binned.cu) on the first GPU at the
binned paths' shapes:

- 512^3, K = 2 -> 2, drift bounds (-0.5, 1.5): 27 offsets (the main
  binned path's rebase, chip_smoke.py phase 6);
- 384^3, K = 4 -> 4, the same bounds (the clustered path's, phase 5);
- 512^3, K = 2 -> 3, bounds (-1.0, 2.0): 64 offsets;
- the x-halo slab form: a 128-row slab of a 4-rank 512^3 state with
  its halo planes, K = 2 -> 2 (row 12 of PERF.md's kernel table);
- rebase_apply of the velocities on the main case's routes, beside
  them: a kernel this tool's subject does not change.

Each state is chip_smoke.rebase_state's (displacements in [0.05, 0.95)
plus a drift inside the bounds, slot k a fraction fill[k] full), made
from a fixed seed by this checkout's chip_smoke.py, so two commits time
the same inputs.

    python3 tools/time_rebase_kernels.py [--root DIR] [--reps R] [--ptxas]
        [--no-kernels] [--steps]

--root imports pmesh_tpu_torch from DIR (an unpacked checkout of another
commit: time two commits in one call, in the order A, B, B, A); the
default is this checkout.  Prints the card's name and power limit (with
--ptxas, builds csrc/binned.cu anew and prints its build time and each
kernel's ptxas report: registers, spills, stack), then one line per
case: the kernel's mean time over R launches after a warm-up (CUDA
events), its bound (the inputs read once and the outputs written once
over 3.35 TB/s, or chip_smoke.REBASE_OPS operations per input slot-cell
over 67 TFLOP/s, whichever is larger, as chip_smoke.py bounds them), the
overflow and a digest of the outputs (sha1 of their bytes: two commits
whose digests agree computed bitwise the same outputs from the same
inputs).  --no-kernels skips them.  --steps times the two step paths
that launch the assign: chip_smoke.py's phase 6 (the 512^3 K = 2 binned
step, its own log line) and bench.py's clustered 384^3 superstep on the
state phase 5 grows (ms per KDK step, fft='mxu' then 'xla', a warm-up
then two timed each, as tools/time_step_paths.py times it).
"""
import argparse
import hashlib
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (label, mesh size or slab rows, drift bounds, fill per slot, Kout)
CASES = (("512^3 K=2->2 27 offsets", 512, (-0.5, 1.5), (1.0, 0.25), 2),
         ("384^3 K=4->4 27 offsets", 384, (-0.5, 1.5),
          (1.0, 0.25, 0.1, 0.05), 4),
         ("512^3 K=2->3 64 offsets", 512, (-1.0, 2.0), (1.0, 0.25), 3))
SLAB_ROWS, SLAB_N = 128, 512


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--root', default=HERE)
    ap.add_argument('--reps', type=int, default=10)
    ap.add_argument('--ptxas', action='store_true')
    ap.add_argument('--no-kernels', action='store_true')
    ap.add_argument('--steps', action='store_true')
    a = ap.parse_args()
    # this checkout's states and yardsticks (chip_smoke imports only
    # numpy and torch)
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    sys.path.insert(0, os.path.abspath(a.root))
    import torch
    from pmesh_tpu_torch.native import cuda
    from pmesh_tpu_torch.ops import binned as bn
    from pmesh_tpu_torch.ops import binned_cuda as bc
    if not torch.cuda.is_available():
        sys.exit("time_rebase_kernels: needs a CUDA GPU")
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True).stdout.strip()
    print("%s; root %s; torch %s" % (card, os.path.abspath(a.root),
                                     torch.__version__), flush=True)
    if a.ptxas:
        info = cuda.build("binned")
        print("build binned.cu: %.1f s" % info["seconds"])
        kernel = "?"
        for ln in info["log"].splitlines():
            if "Compiling entry function" in ln:
                kernel = ln.split("'")[1]
            elif "registers" in ln or "spill" in ln:
                print("  ptxas %s: %s" % (kernel, ln.strip()))
    dev = torch.device('cuda', 0)

    def timed(fn):
        fn()
        torch.cuda.synchronize()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(a.reps):
            fn()
        t1.record()
        t1.synchronize()
        return t0.elapsed_time(t1) / a.reps

    def flat(x):
        if isinstance(x, (tuple, list)):
            return [y for z in x for y in flat(z)]
        return [x]

    def case(label, fn, reads, ops):
        out = fn()
        torch.cuda.synchronize()
        outs = flat(out)
        digest = hashlib.sha1(b"".join(
            o.contiguous().reshape(-1).view(torch.uint8).cpu().numpy()
            .tobytes() for o in outs)).hexdigest()[:12]
        over = " overflow %d" % int(out[3]) if len(out) == 4 else ""
        ms = timed(fn)
        rec = cs.record(0.0, ms, None, cs.nbytes(reads, outs[:-1] if over
                                                 else outs), ops)
        bound = rec["bound_ms"]
        print("%-48s %8.3f ms  bound %.3f ms by %-10s (%.1fx)%s  digest %s"
              % (label, ms, bound, rec["bound_by"], ms / bound, over,
                 digest), flush=True)
        del out, outs

    def state(n, bounds, fill, seed):
        gen = torch.Generator(device=dev).manual_seed(seed)
        drift = min(0.05 - bounds[0], bounds[1] - 0.95)
        return cs.rebase_state(dev, gen, n, drift, fill)

    def cases():
        for c, (label, n, bounds, fill, kout) in enumerate(CASES):
            dslots, vslots, valid = state(n, bounds, fill, 40 + c)
            offsets = bn._drift_offsets(bounds, 3)
            lo, hi = offsets[0][0], offsets[-1][0]
            case("%s assign" % label,
                 lambda: bc.rebase_assign(dslots, valid, kout, lo, hi),
                 (dslots, valid), cs.REBASE_OPS * len(fill) * n ** 3)
            if c == 0:
                routes = bc.rebase_assign(dslots, valid, kout, lo, hi)[2]
                case("%s apply (unchanged)" % label,
                     lambda: bc.rebase_apply((vslots,), routes, lo, hi),
                     (vslots, routes), 0)
                del routes
            del dslots, vslots, valid
            torch.cuda.empty_cache()
        # the x-halo slab: SLAB_ROWS rows and their halo planes
        label, _, bounds, fill, kout = CASES[0]
        offsets = bn._drift_offsets(bounds, 3)
        lo, hi = offsets[0][0], offsets[-1][0]
        xlo, xhi = bn._halo_depth(offsets)
        n_in = xlo + SLAB_ROWS + xhi
        dslots, vslots, valid = state(SLAB_N, bounds, fill, 50)
        dx = tuple(tuple(d[:n_in].contiguous() for d in dk)
                   for dk in dslots)
        vx = tuple(v[:n_in].contiguous() for v in valid)
        del dslots, vslots, valid
        case("slab %d rows of %d^3 K=2->%d assign"
             % (SLAB_ROWS, SLAB_N, kout),
             lambda: bc.rebase_assign(dx, vx, kout, lo, hi, rows=SLAB_ROWS,
                                      xbase=xlo),
             (dx, vx), cs.REBASE_OPS * len(fill) * n_in * SLAB_N ** 2)
        del dx, vx
        torch.cuda.empty_cache()

    if not a.no_kernels:
        cases()
    if not a.steps:
        return
    torch.cuda.set_device(dev)
    cs.phase_binned_timed(dev)
    _, grown = cs.phase_binned_clustered(dev)
    ms = {}
    for fft in ('mxu', 'xla'):
        for rep in range(3):
            if rep == 1:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            cs.clustered_superstep(grown['solver'], grown['dslots'],
                                   grown['vslots'], grown['valid'], fft)
        torch.cuda.synchronize()
        ms[fft] = (time.perf_counter() - t0) / 4 * 1e3
    print("clustered %d^3 K=%d superstep, ms per KDK step: mxu %.3f, xla "
          "%.3f" % (cs.NC, len(grown['dslots']), ms['mxu'], ms['xla']),
          flush=True)


if __name__ == '__main__':
    main()
