"""Time variants of the f64 lattice kernels' per-width tables on the
first GPU: csrc/gridpm64.cu and gridpm64w.cu built with some of their
tables (ROWS64_READOUT, ROWS64_READOUT_ALL, ROWS64_PAINT,
ZCELLS64_PAINT) replaced, each variant's outputs held bitwise to the
first variant's, and each timed at 512^3.

    python3 tools/time_f64_variants.py [--variant NAME[:MACRO=v,v,..[;..]]]
        [--nv 3 5 7] [--ops paint readout] [--reps R] [--sass]

Each --variant is a name and the tables it replaces (12 entries, one per
nv); a bare name builds the tables as they stand.  The default is one
variant, 'tree'.  For each variant the script builds both libraries (all
builds in parallel, into _checkout/variants/, which .gitignore lists),
prints ptxas's registers, stack frame and spills of every instance, and
with --sass the FP64 (DFMA, DMUL, DADD) and shared-load (LDS) instruction
counts in the SASS (cuobjdump) of the paint with a mass mesh and of the
readouts at each --nv.  Then, with the planner's tables set to match:

- at each --nv, CIC (bounds (-k, k) for odd nv = 2k + 1, (-k + 1.5, k -
  0.5) for even nv = 2k), on a (37, 45, 51) mesh: the paint (scalar, mass mesh,
  derivative along z, the x-halo form) and the readouts (one mesh, three,
  'all') of every variant against the first: 'bitwise True' where every
  output is torch.equal;
- at 512^3: the kernel's mean time over R launches (CUDA events) after a
  warm-up, variants in the order V1 .. Vn Vn .. V1, printed per read and
  summed up at the end.

Prints the card's name, power limit and SM clocks first.
"""
import argparse
import collections
import ctypes
import os
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TABLES = ("ROWS64_READOUT", "ROWS64_READOUT_ALL", "ROWS64_PAINT",
          "ZCELLS64_PAINT")
# the planner's table of each
PLANNER = {"ROWS64_READOUT": 'readout', "ROWS64_READOUT_ALL": 'readout_all',
           "ROWS64_PAINT": 'paint', "ZCELLS64_PAINT": None}


def parse_variant(text):
    name, _, spec = text.partition(':')
    tables = {}
    for item in filter(None, spec.split(';')):
        macro, _, vals = item.partition('=')
        vals = tuple(int(v) for v in vals.split(','))
        if macro not in TABLES or len(vals) != 12:
            sys.exit("time_f64_variants: bad table %r" % item)
        tables[macro] = vals
    return name, tables


def bounds_of(nv):
    k = nv // 2
    return (-float(k), float(k)) if nv % 2 else (-k + 1.5, k - 0.5)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--variant', action='append', default=[])
    ap.add_argument('--nv', type=int, nargs='*', default=[3, 5, 7])
    ap.add_argument('--ops', nargs='*', default=['paint', 'readout'])
    ap.add_argument('--reps', type=int, default=10)
    ap.add_argument('--sass', action='store_true')
    a = ap.parse_args()
    sys.path.insert(0, HERE)
    import torch
    import chip_smoke as cs
    from pmesh_tpu_torch.native import cuda
    from pmesh_tpu_torch.ops import gridpm as gp
    from pmesh_tpu_torch.ops import gridpm_cuda as gc
    if not torch.cuda.is_available():
        sys.exit("time_f64_variants: needs a CUDA GPU")
    print(subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit,clocks.sm,clocks.max.sm',
         '--format=csv,noheader'], capture_output=True,
        text=True).stdout.strip(), flush=True)
    variants = [parse_variant(v) for v in a.variant or ['tree']]
    with open(os.path.join(cuda.CSRC, 'gridpm64.cu')) as f:
        src = f.read()
    current = {m: tuple(int(v) for v in re.search(
        r"#define %s \{([\d, ]+)\}" % m, src).group(1).split(','))
        for m in TABLES}
    out_dir = os.path.join(HERE, '_checkout', 'variants')
    os.makedirs(out_dir, exist_ok=True)
    nvcc = cuda.find_nvcc()

    def build(job):
        (name, tables), wide = job
        text = src
        for macro, vals in tables.items():
            text = re.sub(r"#define %s \{[\d, ]+\}" % macro,
                          "#define %s {%s}" % (macro, ", ".join(map(str, vals))),
                          text)
        path = os.path.join(out_dir, name + ('w' if wide else '') + '.cu')
        with open(path, 'w') as f:
            f.write(('#define GRIDPM64_WIDE 1\n' if wide else '') + text)
        lib = path[:-3] + '.so'
        t0 = time.perf_counter()
        proc = subprocess.run([nvcc] + cuda.NVCC_FLAGS
                              + ['-I', cuda.CSRC, '-o', lib, path],
                              capture_output=True, text=True)
        if proc.returncode:
            sys.exit("time_f64_variants: nvcc failed on %s:\n%s"
                     % (path, proc.stdout + proc.stderr))
        return lib, time.perf_counter() - t0, proc.stdout + proc.stderr

    jobs = [(v, wide) for v in variants for wide in (False, True)]
    with ThreadPoolExecutor(len(jobs)) as pool:
        built = dict(zip([(v[0], w) for v, w in jobs],
                         pool.map(build, jobs)))
    cuobjdump = os.path.join(os.path.dirname(nvcc), 'cuobjdump')
    for name, tables in variants:
        print("variant %s: %s" % (name, "; ".join(
            "%s=%s" % (m, ",".join(map(str, v)))
            for m, v in tables.items()) or "the tables as they stand"))
        for wide in (False, True):
            lib, seconds, log = built[(name, wide)]
            print("  build %s: %.1f s" % (os.path.basename(lib), seconds))
            for kernel, line in cs.ptxas_lines(log):
                if 'registers' in line or 'stack' in line:
                    print("    ptxas %s: %s" % (kernel, line))
            if a.sass:
                sass(cuobjdump, lib, a.nv, cs.demangle)
    sys.stdout.flush()

    dev = torch.device('cuda')
    f8 = torch.float64

    def use(name, tables):
        libs = {'gridpm64': built[(name, False)][0],
                'gridpm64w': built[(name, True)][0]}
        for lib in libs:
            gc._libs.pop(lib, None)
        gc._cuda.load = lambda lib: ctypes.CDLL(libs[lib])
        merged = dict(current, **tables)
        gc.ROWS64 = {PLANNER[m]: merged[m] for m in TABLES if PLANNER[m]}
        gc.ZCELLS64 = merged["ZCELLS64_PAINT"]

    def cases(disp, meshes, mass, vmin, vmax, ragged):
        out = {}
        if 'paint' in a.ops:
            out['paint'] = lambda: gc.paint_lattice(disp, None, vmin, vmax,
                                                    'cic')
            out['paint, mass mesh'] = lambda: gc.paint_lattice(
                disp, mass, vmin, vmax, 'cic')
            if ragged:
                out['paint diffdir 2'] = lambda: gc.paint_lattice(
                    disp, mass, vmin, vmax, 'cic', diffdir=2)
                lo, hi = max(0, vmax), max(0, -vmin)
                rows = disp[0].shape[0] - lo - hi
                out['paint x-halo'] = lambda: gc.paint_lattice(
                    disp, mass, vmin, vmax, 'cic', rows=rows, xbase=lo)
        if 'readout' in a.ops:
            out['readout 1 mesh'] = lambda: gc.readout_lattice(
                meshes[:1], disp, vmin, vmax, 'cic')
            out['readout 3 meshes'] = lambda: gc.readout_lattice(
                meshes, disp, vmin, vmax, 'cic')
            out["readout 'all'"] = lambda: gc.readout_lattice(
                meshes[:1], disp, vmin, vmax, 'cic', diffdir='all')
        return out

    def state(shape, bounds, seed):
        gen = torch.Generator(device=dev).manual_seed(seed)
        lo, hi = bounds
        disp = tuple(lo + (hi - lo) * torch.rand(shape, generator=gen,
                                                 device=dev, dtype=f8)
                     for _ in range(3))
        meshes = tuple(torch.randn(shape, generator=gen, device=dev,
                                   dtype=f8) for _ in range(3))
        mass = torch.randn(shape, generator=gen, device=dev, dtype=f8)
        return disp, meshes, mass

    def tupled(o):
        return o if isinstance(o, tuple) else (o,)

    for nv in a.nv:
        vmin, vmax = gp.offset_range(*bounds_of(nv), 'cic')
        disp, meshes, mass = state((37, 45, 51), bounds_of(nv), 5)
        first = None
        for name, tables in variants:
            use(name, tables)
            got = {k: tupled(fn()) for k, fn in cases(
                disp, meshes, mass, vmin, vmax, True).items()}
            first = first or got
            same = all(torch.equal(x, y) for k in got
                       for x, y in zip(got[k], first[k]))
            print("nv %d (37, 45, 51) %s: bitwise %s" % (nv, name, same),
                  flush=True)

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

    order = variants + variants[::-1]
    ms = collections.defaultdict(list)
    for nv in a.nv:
        vmin, vmax = gp.offset_range(*bounds_of(nv), 'cic')
        disp, meshes, mass = state((512,) * 3, bounds_of(nv), 12)
        labels = list(cases(disp, meshes, mass, vmin, vmax, False))
        for label in labels:
            for name, tables in order:
                use(name, tables)
                fn = cases(disp, meshes, mass, vmin, vmax, False)[label]
                t = timed(fn)
                ms[(nv, label, name)].append(t)
                print("512^3 nv %d %-18s %-8s %9.3f ms" % (nv, label, name,
                                                           t), flush=True)
        del disp, meshes, mass
        torch.cuda.empty_cache()
    print("summary (ms, reads in the order above)")
    for nv in a.nv:
        for label in [k[1] for k in ms if k[0] == nv and k[2] ==
                      variants[0][0]]:
            print("512^3 nv %d %-18s %s" % (nv, label, "  ".join(
                "%s %s" % (name, ", ".join("%.3f" % t for t in
                                           ms[(nv, label, name)]))
                for name, _ in variants)))


def sass(cuobjdump, lib, nvs, demangle):
    """per paint (mass mesh) and readout instance at the widths ``nvs``:
    its FP64 and shared-load instruction counts in the SASS"""
    text = subprocess.run([cuobjdump, '-sass', lib], capture_output=True,
                          text=True).stdout
    counts, fn = {}, None
    for ln in text.splitlines():
        m = re.search(r'Function : (\S+)', ln)
        if m:
            fn = demangle(m.group(1))
            counts[fn] = collections.Counter()
            continue
        m = re.search(r'/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)',
                      ln)
        if m and fn:
            counts[fn][m.group(1)] += 1
    for fn, c in sorted(counts.items()):
        m = re.match(r'(paint64<(\d+), true>|readout64<(\d+), \d>)', fn)
        if m and int(m.group(2) or m.group(3)) in nvs:
            print("    sass %s: DFMA %d DMUL %d DADD %d LDS %d, of %d"
                  % (fn, c['DFMA'], c['DMUL'], c['DADD'], c['LDS'],
                     sum(c.values())))


if __name__ == '__main__':
    main()
