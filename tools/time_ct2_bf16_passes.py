"""Time the bf16-product forms of the forward ct2 DFT passes of
fft='mxu_bf16' on the first GPU: zy_fwd_ct2 and xct_multi (the forward x
pass and the dual inverse with the 1/k^2 fold), each on f32 spectra and
on bf16 spectra (precision='bf16' with out_dtype=bfloat16), at N^3, each
against its plain version on the same inputs, and break each pass down
into its device kernels with torch.profiler.

    python3 tools/time_ct2_bf16_passes.py [--root DIR] [--n N]

--root imports pmesh_tpu_torch from DIR (an unpacked checkout of another
commit: time two commits in one call, in the order A, B, B, A); the
default is this checkout.  Prints the card's name and power limit, one
line per form (kernel ms: mean of 10 launches after a warm-up, CUDA
events; the device memory one call allocates beyond its inputs;
max|kernel - plain| / max|plain| of the outputs upcast to f32) and one
line per form of device ms by kernel.
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
    ap.add_argument('--n', type=int, default=512)
    a = ap.parse_args()
    sys.path.insert(0, os.path.abspath(a.root))
    import torch
    from pmesh_tpu_torch.ops import fft_mxu as fm
    if not torch.cuda.is_available():
        sys.exit("time_ct2_bf16_passes: needs a CUDA GPU")
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True).stdout.strip()
    dev = torch.device('cuda')
    N = a.n
    Zm = N // 2
    bf16 = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(5)
    x = 1.0 + 0.3 * torch.randn((N,) * 3, generator=gen, device=dev)
    wz = fm._cached(fm._z_fwd_tabs, N, Zm)
    wf, wi = fm._cached(fm._ct_fwd_mats_np, N), fm._cached(fm._ct_inv_mats_np,
                                                           N)
    kv = tuple(np.sin(np.fft.fftfreq(N) * 2 * np.pi))
    wg = fm._cached(fm._ct_inv_mats_np, N, tuple(fm._ct_table(N, kv)))
    k2 = tuple(fm._ct_table(N, np.asarray(kv, np.float32) ** 2)
               .astype(np.float32) for _ in range(2)) + (
        fm._zct_table(N, np.asarray(kv, np.float32) ** 2)
        .astype(np.float32),)
    pr, pi, _ = fm._zy_fwd_ct2_call(x, N, Zm, wz, wf, impl='torch')
    hr, hi = pr.to(bf16), pi.to(bf16)
    forms = []
    for st in (None, bf16):
        name = 'bf16' if st is None else 'bf16_bf16s'
        p, q = (pr, pi) if st is None else (hr, hi)
        forms += [
            ('zy_fwd_ct2 %s' % name, lambda impl, st=st:
             fm._zy_fwd_ct2_call(x, N, Zm, wz, wf, precision='bf16',
                                 out_dtype=st, impl=impl)[:2]),
            ('xct_multi forward %s' % name, lambda impl, st=st, p=p, q=q:
             fm._xct_call_multi(p, q, wf, 1.0 / N ** 3, precision='bf16',
                                out_dtype=st, impl=impl)),
            ('xct_multi dual inverse %s' % name, lambda impl, st=st, p=p, q=q:
             fm._xct_call_multi(p, q, wi, 1.0, inverse=True, wx2=wg, k2=k2,
                                precision='bf16', out_dtype=st, impl=impl))]

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
        rel = max(float((g.float() - r.float()).abs().max()
                        / r.float().abs().max()) for g, r in zip(got, ref))
        del got, ref
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = fn('cuda')
        torch.cuda.synchronize()
        extra = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
        del out
        print("%-34s kernel %.3f ms, peak %.3f GiB beyond the inputs, "
              "max|k-p|/max|p| %.3e"
              % (name, cuda_ms(lambda: fn('cuda')), extra, rel), flush=True)
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
        print("%-34s device ms by kernel: %s" % (name, ", ".join(
            "%s %.3f" % kv for kv in sorted(by.items(),
                                            key=lambda kv: -kv[1]))),
              flush=True)
    print("%.1f s" % (time.time() - t_start))


if __name__ == "__main__":
    main()
