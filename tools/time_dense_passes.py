"""Time the dense forward DFT passes of fft='mxu' on the first GPU: the
six forms of zy_fwd_half and x_dense (the forward x pass and the dual
inverse with the 1/k^2 fold; f32 products and bf16 products) at N^3,
each against its plain version on the same inputs, and break each pass
down into its device kernels with torch.profiler.

    python3 tools/time_dense_passes.py [--root DIR] [--n N]

--root imports pmesh_tpu_torch from DIR (an unpacked checkout of another
commit: time two commits in one call, in the order A, B, B, A); the
default is this checkout.  Prints the card's name and power limit, one
line per form (kernel ms: mean of 10 launches after a warm-up, CUDA
events; max|kernel - plain| / max|plain|) and one line per form of
device ms by kernel.
"""
import argparse
import os
import subprocess
import sys
import time

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--root', default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument('--n', type=int, default=384)
    a = ap.parse_args()
    sys.path.insert(0, os.path.abspath(a.root))
    import torch
    from pmesh_tpu_torch.ops import fft_mxu as fm
    if not torch.cuda.is_available():
        sys.exit("time_dense_passes: needs a CUDA GPU")
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True).stdout.strip()
    dev = torch.device('cuda')
    N = a.n
    Zh = N // 2 + 1
    gen = torch.Generator(device=dev).manual_seed(5)
    x = 1.0 + 0.3 * torch.randn((N,) * 3, generator=gen, device=dev)
    wz = fm._cached(fm._dft_half_np, N, Zh)
    wf, wi = fm._cached(fm._dft_np, N, -1), fm._cached(fm._dft_np, N, +1)
    kv = tuple(np.sin(np.fft.fftfreq(N) * 2 * np.pi))
    wg = fm._cached(fm._dft_fold_np, N, kv)
    k2 = (np.asarray(kv, np.float32) ** 2,) * 2 + (
        np.asarray(kv[:Zh], np.float32) ** 2,)
    pr, pi = fm._zy_fwd_dense_call(x, wz, wf, impl='torch')
    forms = []
    for prec in (None, 'bf16'):
        name = prec or 'f32'
        forms += [
            ('zy_fwd_half %s' % name, lambda impl, p=prec:
             fm._zy_fwd_dense_call(x, wz, wf, precision=p, impl=impl)),
            ('x_dense forward %s' % name, lambda impl, p=prec:
             fm._x_dense_call(pr, pi, wf, 1.0 / N ** 3, precision=p,
                              impl=impl)),
            ('x_dense dual inverse %s' % name, lambda impl, p=prec:
             fm._x_dense_call(pr, pi, wi, 1.0, wx2=wg, k2=k2, precision=p,
                              impl=impl))]

    def cuda_ms(fn, reps=10):
        fn()
        torch.cuda.synchronize()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(reps):
            fn()
        t1.record()
        t1.synchronize()
        return t0.elapsed_time(t1) / reps

    print(card)
    print("root %s, torch %s, %d^3" % (os.path.abspath(a.root),
                                       torch.__version__, N))
    t_start = time.time()
    for name, fn in forms:
        got, ref = fn('cuda'), fn('torch')
        rel = max(float((g - r).abs().max() / r.abs().max())
                  for g, r in zip(got, ref))
        del got, ref
        print("%-28s kernel %.3f ms, max|k-p|/max|p| %.3e"
              % (name, cuda_ms(lambda: fn('cuda')), rel), flush=True)
    for name, fn in forms:
        fn('cuda')
        torch.cuda.synchronize()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                fn('cuda')
            torch.cuda.synchronize()
        by = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                k = e.name.replace('(anonymous namespace)::', '')
                k = k.replace('void ', '').split('(')[0]
                by[k] = by.get(k, 0.0) + (e.time_range.end
                                          - e.time_range.start) / 3e3
        print("%-28s device ms by kernel: %s" % (name, ", ".join(
            "%s %.3f" % kv for kv in sorted(by.items(),
                                            key=lambda kv: -kv[1]))),
              flush=True)
    print("%.1f s" % (time.time() - t_start))


if __name__ == "__main__":
    main()
