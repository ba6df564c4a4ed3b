"""Time the lattice paint and readout kernels (csrc/gridpm.cu,
csrc/gridpm64.cu) on the first GPU at the main paths' shapes:

- 512^3, CIC in (-1, 1) (nv = 3, the lattice path): the paint with a
  scalar mass (the forward force) and with a mass mesh of normal values
  (the readout's backward), the readout of one mesh, of three meshes in
  one launch (the spectral force) and 'all' (the gradient force and the
  paint's backward);
- 384^3, CIC in (-0.5, 1.5) (nv = 4, the binned paths' per-slot bounds):
  the paint with a mass mesh (the occupancy mask) and the one- and
  three-mesh readouts;
- the x-halo slab form on a 128-row slab of 512^3 (4 ranks), nv = 3;
- each in f32 and in bf16 storage;
- in f64 storage (the f8 meshes): the 512^3 cases at nv = 3, 5 (CIC in
  (-2, 2)) and 7 (CIC in (-3, 3), gravpm's lattice mode at 2048 Mpc/h),
  and the 128-row slab at nv = 3, with the bound's operations over the
  FP64 rate (34 TFLOP/s).

    python3 tools/time_lattice_kernels.py [--root DIR] [--reps R] [--ptxas]
        [--xc X [X ...]] [--only f32 bf16 f64]

--root imports pmesh_tpu_torch from DIR (an unpacked checkout of another
commit: time two commits in one call, in the order A, B, B, A); the
default is this checkout.  Prints the card's name and power limit (with
--ptxas, builds csrc/gridpm.cu, gridpm64.cu and gridpm64w.cu anew and prints each
build's time and each kernel's ptxas report: registers, stack frame,
spills), then one line per
case: the kernel's mean time over R
launches after a warm-up (CUDA events), its bound (the larger of the
inputs read once and the outputs written once over 3.35 TB/s, and the
operations the function needs, chip_smoke.paint_ops / readout_ops,
over 67 TFLOP/s (34 for f64), as chip_smoke.py bounds them) and a
digest of its outputs (sha1 of their bytes: two commits whose digests
agree computed bitwise the same outputs from the same seeded inputs).
--xc then times the f32 cases again with the planner's planes per block
capped at each X (ops/gridpm_cuda.XC_MAX) in turn.
"""
import argparse
import hashlib
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--root', default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument('--reps', type=int, default=10)
    ap.add_argument('--ptxas', action='store_true')
    ap.add_argument('--xc', type=int, nargs='*', default=[])
    ap.add_argument('--only', nargs='*', default=['f32', 'bf16', 'f64'])
    a = ap.parse_args()
    # this checkout's yardsticks (chip_smoke imports only numpy and torch)
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    sys.path.insert(0, os.path.abspath(a.root))
    import torch
    from pmesh_tpu_torch.native import cuda
    from pmesh_tpu_torch.ops import gridpm as gp
    from pmesh_tpu_torch.ops import gridpm_cuda as gc
    if not torch.cuda.is_available():
        sys.exit("time_lattice_kernels: needs a CUDA GPU")
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True).stdout.strip()
    print("%s; root %s; torch %s" % (card, os.path.abspath(a.root),
                                     torch.__version__), flush=True)
    if a.ptxas:
        # build anew; per kernel ptxas's registers, stack frame and spills
        for name in ("gridpm", "gridpm64", "gridpm64w"):
            if os.path.exists(os.path.join(cuda.CSRC, name + ".cu")):
                info = cuda.build(name)
                print("build %s.cu: %.1f s" % (name, info["seconds"]),
                      flush=True)
                for kernel, line in cs.ptxas_lines(info["log"]):
                    print("  ptxas %s: %s" % (kernel, line), flush=True)
    dev = torch.device('cuda')
    gen = torch.Generator(device=dev).manual_seed(12)

    def state(shape, bounds, dtype, mask):
        """displacements, three meshes and a mass mesh: an occupancy
        mask of 0 and 1 (the binned paths), or normal values (a
        readout's cotangent, which its backward paints)"""
        lo, hi = bounds
        disp = tuple((lo + (hi - lo) * torch.rand(
            shape, generator=gen, device=dev)).to(dtype) for _ in range(3))
        meshes = tuple(torch.randn(shape, generator=gen, device=dev)
                       .to(dtype) for _ in range(3))
        mass = torch.rand(shape, generator=gen, device=dev)
        mass = (mass < 0.7) if mask else torch.randn(
            shape, generator=gen, device=dev)
        return disp, meshes, mass.to(dtype)

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

    def nbytes(ts):
        return sum(t.numel() * t.element_size() for t in ts)

    def case(label, fn, reads, ops, f64=False):
        out = fn()
        out = out if isinstance(out, tuple) else (out,)
        torch.cuda.synchronize()
        digest = hashlib.sha1(b"".join(
            o.contiguous().view(torch.uint8).cpu().numpy().tobytes()
            for o in out)).hexdigest()[:12]
        ms = timed(fn)
        rec = (cs.f64_record if f64 else cs.record)(
            0.0, ms, None, nbytes(reads) + nbytes(out), ops)
        bound = rec["bound_ms"]
        print("%-44s %8.3f ms  bound %.3f ms by %-10s (%.1fx)  digest %s"
              % (label, ms, bound, rec["bound_by"], ms / bound, digest),
              flush=True)
        del out

    def cases(dtype, tag):
        """every case at one storage dtype, from the same seeded inputs"""
        gen.manual_seed(12)
        f64 = dtype == torch.float64
        sizes = (((512, (-1.0, 1.0)), (512, (-2.0, 2.0)), (512, (-3.0, 3.0)))
                 if f64 else ((512, (-1.0, 1.0)), (384, (-0.5, 1.5))))
        for n, bounds in sizes:
            shape = (n,) * 3
            disp, meshes, mass = state(shape, bounds, dtype, n == 384)
            vmin, vmax = gp.offset_range(*bounds, 'cic')
            nv = vmax - vmin + 1
            head = "%d^3 nv=%d %s" % (n, nv, tag)
            if n == 512:
                case("%s paint" % head, lambda: gc.paint_lattice(
                    disp, None, vmin, vmax, 'cic'), disp,
                    cs.paint_ops(nv, n ** 3), f64)
            case("%s paint, mass mesh" % head, lambda: gc.paint_lattice(
                disp, mass, vmin, vmax, 'cic'), disp + (mass,),
                cs.paint_ops(nv, n ** 3, mass=True), f64)
            case("%s readout 1 mesh" % head, lambda: gc.readout_lattice(
                meshes[:1], disp, vmin, vmax, 'cic'), disp + meshes[:1],
                cs.readout_ops(nv, n ** 3), f64)
            case("%s readout 3 meshes" % head, lambda: gc.readout_lattice(
                meshes, disp, vmin, vmax, 'cic'), disp + meshes,
                cs.readout_ops(nv, n ** 3, 3), f64)
            if n == 512:
                case("%s readout 'all'" % head, lambda: gc.readout_lattice(
                    meshes[:1], disp, vmin, vmax, 'cic', diffdir='all'),
                    disp + meshes[:1], cs.readout_ops(nv, n ** 3,
                                                      diff_all=True), f64)
            del disp, meshes, mass
            torch.cuda.empty_cache()
        # the x-halo slab form: rank 0's 128 rows of a 4-rank 512^3 mesh
        bounds, rows = (-1.0, 1.0), 128
        vmin, vmax = gp.offset_range(*bounds, 'cic')
        nv = vmax - vmin + 1
        lo, hi = max(0, vmax), max(0, -vmin)
        disp, meshes, _ = state((lo + rows + hi, 512, 512), bounds, dtype,
                                True)
        case("slab %d rows nv=3 %s paint" % (rows, tag),
             lambda: gc.paint_lattice(disp, None, vmin, vmax, 'cic',
                                      rows=rows, xbase=lo), disp,
             cs.paint_ops(nv, rows * 512 ** 2), f64)
        lo = max(0, -vmin)
        rdisp = tuple(d[lo:lo + rows].contiguous() for d in disp)
        case("slab %d rows nv=3 %s readout 3 meshes" % (rows, tag),
             lambda: gc.readout_lattice(meshes, rdisp, vmin, vmax, 'cic',
                                        xbase=lo), rdisp + meshes,
             cs.readout_ops(nv, rows * 512 ** 2, 3), f64)
        del disp, meshes, rdisp
        torch.cuda.empty_cache()

    for tag, dtype in (('f32', torch.float32), ('bf16', torch.bfloat16),
                       ('f64', torch.float64)):
        if tag in a.only:
            cases(dtype, tag)
    default = getattr(gc, 'XC_MAX', None)
    for xc in a.xc:
        gc.XC_MAX = xc
        cases(torch.float32, 'f32 xc<=%d' % xc)
    gc.XC_MAX = default

if __name__ == '__main__':
    main()
