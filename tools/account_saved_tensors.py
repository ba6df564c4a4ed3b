"""Where reverse mode's device memory goes, on the first GPU.

    python3 tools/account_saved_tensors.py [--runs lattice-xla lattice-mxu
        catalog] [--out FILE]

Each run is a reverse run of chip_smoke.py, its forward pass wrapped in
``torch.autograd.graph.saved_tensors_hooks``:

- ``lattice-xla``, ``lattice-mxu``: phase 4d's, the gradient of
  sum(S^2 + 2 V^2) after 2 KDK steps of nbody_lattice at 512^3 (3
  forces) with respect to the initial (disp, vel) of the 2LPT state;
- ``catalog``: phase 13(a)'s, the gradient of sum (rho - 1)^2 after
  2LPT and 2 KDK steps of Solver.nbody (256^3 particles, a 512^3 B = 2
  force mesh, 3 forces) with respect to the white noise.

Every tensor that autograd saves for the backward is counted once per
storage (a view counts the whole storage it keeps alive) and given to
the op that saved it: the innermost frame of pmesh_tpu_torch on the
Python stack when it is saved names the family (the lattice or generic
paint and readout, the fft='mxu' force triple or potential, the FFTs of
ops/fft.py, the spectral filters of Field.apply and ops/transfer.py,
and the rest, the kicks, drifts, normalizations and LPT sums, as
elementwise), and the force it was saved during or after (the window
from one force call to the next; the first window also holds the LPT).

Beside the table, from the caching allocator: the bytes allocated
before the forward (the inputs), after it (what the graph and the
outputs hold), the peak allocated over forward + backward, and the peak
reserved (allocated plus the allocator's cache).  Prints the card's
name and power limit, one JSON line per run, and a markdown table per
run; ``--out`` also writes the JSON lines to a file.  Each run runs in
a process of its own.
"""
import argparse
import collections
import gc
import json
import os
import subprocess
import sys

PORT = os.sep + "pmesh_tpu_torch" + os.sep


def family(frame):
    """the op family of the innermost pmesh_tpu_torch frame, and that
    frame's qualified name"""
    while frame is not None:
        path = frame.f_code.co_filename
        if PORT in path:
            name = frame.f_code.co_qualname
            low = name.lower()
            rel = path.split(PORT, 1)[1]
            if rel in ("ops/gridpm.py", "ops/paint.py"):
                kind = "lattice" if rel == "ops/gridpm.py" else "generic"
                if "paint" in low:
                    return "%s paint" % kind, name
                if "readout" in low:
                    return "%s readout" % kind, name
            if "mxu" in low:
                return "mxu force / potential", name
            if rel == "ops/fft.py" or low.endswith(("r2c", "c2r")):
                return "fft", name
            if (rel == "ops/transfer.py" or low.endswith("apply")
                    or "filt" in low or "convolve" in low):
                return "filter", name
            return "elementwise", name
        frame = frame.f_back
    return "elementwise", "(outside the port)"


class SavedTensors(object):
    """the saved_tensors_hooks of one forward pass and their account"""

    def __init__(self):
        self.window = 0
        self.seen = set()
        self.bytes = collections.Counter()
        self.by_window = collections.Counter()
        self.names = collections.defaultdict(collections.Counter)

    def pack(self, t):
        storage = t.untyped_storage()
        key = (storage.data_ptr(), str(t.device))
        if key not in self.seen:
            self.seen.add(key)
            fam, name = family(sys._getframe(1))
            n = storage.nbytes()
            self.bytes[fam] += n
            self.by_window[self.window] += n
            self.names[fam][name] += n
        return t

    @staticmethod
    def unpack(t):
        return t

    def count_forces(self, solver, method):
        """advance the window at every call of solver.<method>"""
        inner = getattr(solver, method)

        def counted(*args, **kwargs):
            self.window += 1
            return inner(*args, **kwargs)
        setattr(solver, method, counted)


def lattice_run(cs, dev, fft):
    """phase 4d's run: (leaves, loss function, solver, force method)"""
    import torch
    from pmesh_tpu_torch import ParticleMesh
    from pmesh_tpu_torch.models.fastpm import Solver
    pm = ParticleMesh([cs.N] * 3, BoxSize=cs.BOX, dtype='f4',
                      resampler='cic', device=dev)
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    solver = Solver(pm)
    state = sum(solver.lpt_lattice(cs.linear_field(pm, gen), cs.A0,
                                   order=2), ())
    leaves = [t.detach().clone().requires_grad_() for t in state]

    def loss():
        S, V = solver.nbody_lattice(leaves[:3], leaves[3:], cs.GRAD_STEPS,
                                    cs.BOUNDS, fft=fft)
        return sum((s * s).sum() + 2 * (v * v).sum() for s, v in zip(S, V))
    return leaves, loss, solver, "force_lattice"


def catalog_run(cs, dev):
    """phase 13(a)'s run"""
    solver, power, noise = cs.catalog_setup(dev)
    leaves = [noise.detach().clone().requires_grad_()]
    return (leaves, lambda: cs.catalog_loss(solver, power, leaves[0]),
            solver, "force")


def account(cs, dev, run):
    import torch
    if run == "catalog":
        leaves, loss_fn, solver, method = catalog_run(cs, dev)
    else:
        leaves, loss_fn, solver, method = lattice_run(cs, dev,
                                                      run.split("-")[1])
    acc = SavedTensors()
    acc.count_forces(solver, method)
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    with torch.autograd.graph.saved_tensors_hooks(acc.pack, acc.unpack):
        loss = loss_fn()
    torch.cuda.synchronize()
    after = torch.cuda.memory_allocated()
    peak_fwd = torch.cuda.max_memory_allocated()
    grads = torch.autograd.grad(loss, leaves)
    torch.cuda.synchronize()
    out = dict(
        run=run, forces=acc.window,
        saved_gb={k: v / 2 ** 30 for k, v in acc.bytes.most_common()},
        saved_total_gb=sum(acc.bytes.values()) / 2 ** 30,
        saved_by_force_window_gb={str(k): v / 2 ** 30 for k, v
                                  in sorted(acc.by_window.items())},
        largest_savers={k: {n: b / 2 ** 30 for n, b in c.most_common(3)}
                        for k, c in acc.names.items()},
        inputs_gb=before / 2 ** 30, after_forward_gb=after / 2 ** 30,
        peak_forward_gb=peak_fwd / 2 ** 30,
        peak_allocated_gb=torch.cuda.max_memory_allocated() / 2 ** 30,
        peak_reserved_gb=torch.cuda.max_memory_reserved() / 2 ** 30,
        finite=all(bool(torch.isfinite(g).all()) for g in grads))
    # the closure holds the leaves and the solver: free them all before
    # the next run's "before"
    del grads, loss, leaves, solver, acc, loss_fn
    gc.collect()
    torch.cuda.empty_cache()
    return out


def table(out):
    lines = ["| %s: saved by | GB | GB per force | share |" % out["run"],
             "|---|---|---|---|"]
    total = out["saved_total_gb"]
    for k, v in out["saved_gb"].items():
        lines.append("| %s | %.3f | %.3f | %.1f %% |"
                     % (k, v, v / out["forces"], 100 * v / total))
    lines.append("| all saved tensors | %.3f | %.3f | |"
                 % (total, total / out["forces"]))
    lines.append("| allocated before / after the forward, peak "
                 "allocated, peak reserved | %.3f / %.3f, %.3f, %.3f | | |"
                 % (out["inputs_gb"], out["after_forward_gb"],
                    out["peak_allocated_gb"], out["peak_reserved_gb"]))
    return "\n".join(lines)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--runs', nargs='+',
                    default=['lattice-xla', 'lattice-mxu', 'catalog'],
                    choices=['lattice-xla', 'lattice-mxu', 'catalog'])
    ap.add_argument('--out', default=None)
    a = ap.parse_args()
    if len(a.runs) > 1:
        # each run in a process of its own: the cuFFT plan cache and the
        # DFT passes' scratch buffers of one run stay allocated under the
        # next one's "before"
        lines = []
        for run in a.runs:
            proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                                   '--runs', run], capture_output=True,
                                  text=True)
            sys.stdout.write(proc.stdout)
            if proc.returncode:
                sys.exit("account_saved_tensors: run %s failed:\n%s"
                         % (run, proc.stderr))
            lines += [ln for ln in proc.stdout.splitlines()
                      if ln.startswith('{')]
        results = [json.loads(ln) for ln in lines]
    else:
        results = [run_here(a.runs[0])]
    if a.out:
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
        with open(a.out, "w") as f:
            for out in results:
                f.write(json.dumps(out) + "\n")


def run_here(run):
    """one run in this process: prints the card, the JSON line and the
    table; returns the record"""
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import torch
    import chip_smoke as cs
    if not torch.cuda.is_available():
        sys.exit("account_saved_tensors: needs a CUDA GPU")
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    dev = torch.device('cuda', 0)
    torch.cuda.set_device(dev)
    out = account(cs, dev, run)
    out["card"] = card
    print(json.dumps(out), flush=True)
    print(table(out), flush=True)
    return out


if __name__ == "__main__":
    main()
