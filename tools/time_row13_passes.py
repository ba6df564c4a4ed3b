"""Time row 13's two zy passes on the first GPU, each form against its
plain version on the same inputs, and break each down into its device
kernels with torch.profiler:

- zy_inv_full (the full-spectrum inverse: the complex z DFT, then the
  real part of the y DFT) at N^3 and at the ragged (96, 80, 75), on a
  density 1 + 0.3 N(0, 1) transformed over y and z (its mean in the DC
  column), by the plain tables and by the i k_z-folded z table;
- zy_fwd_half_ct (the half-CT pass 1: the dense z half-DFT, then the y
  Cooley-Tukey stage) at N^3 and at (256, 512, 30), on such a density;

f32 products and bf16 products ('bf16').

    python3 tools/time_row13_passes.py [--root DIR] [--n N]

--root imports pmesh_tpu_torch from DIR (an unpacked checkout of another
commit: time two commits in one call, in the order A, B, B, A); the
default is this checkout.  Prints the card's name and power limit, one
line per case (kernel ms: mean of 10 launches after a warm-up, CUDA
events; plain ms: one call; the device memory one call allocates beyond
its inputs; max|kernel - plain| / max|plain|; the tensor-core share: 2 x
real FMA of the products x products per FMA (6 f32, 1 bf16) / kernel
time / 989 TFLOP/s) and one line per case of device ms by kernel.
"""
import argparse
import os
import subprocess
import sys
import time

import numpy as np

PEAK_BF16 = 989e12


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--root', default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument('--n', type=int, default=512)
    a = ap.parse_args()
    sys.path.insert(0, os.path.abspath(a.root))
    import torch
    from pmesh_tpu_torch.ops import fft_mxu as fm
    from pmesh_tpu_torch.ops import fft_mxu_ref as ref
    if not torch.cuda.is_available():
        sys.exit("time_row13_passes: needs a CUDA GPU")
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True).stdout.strip()
    dev = torch.device('cuda')
    gen = torch.Generator(device=dev).manual_seed(13)

    def sl(n):
        w = np.fft.fftfreq(n) * 2 * np.pi
        return tuple((8 * np.sin(w) - np.sin(2 * w)) / 6.0)

    def density(shape):
        return 1.0 + 0.3 * torch.randn(shape, generator=gen, device=dev)

    def inv_fma(n0, N1, N2):
        return 4.0 * n0 * N1 * N2 * N2 + 2.0 * n0 * N1 * N1 * N2

    def fwd_fma(n0, N1, N2):
        Ry, My = fm._ct_factor(N1)
        Zh = N2 // 2 + 1
        return 2.0 * n0 * N1 * N2 * Zh + 4.0 * n0 * Zh * Ry * My * My

    cases = []
    for shape in ((a.n,) * 3, (96, 80, 75)):
        n0, N1, N2 = shape
        k = torch.fft.fftn(density(shape), dim=(1, 2), norm='forward')
        rr, ii = k.real.contiguous(), k.imag.contiguous()
        del k
        wy = fm._cached(fm._dft_np, N1, +1)
        AB = fm._cached(ref._z_inv_full_np, N2, None)
        ABg = fm._cached(ref._z_inv_full_np, N2, sl(N2))
        for tabs, what in ((AB, 'plain'), (ABg, 'kz-folded')):
            for form in ('f32', 'bf16'):
                prec = 'bf16' if form == 'bf16' else None
                cases.append((
                    'zy_inv_full %s %s %s' % (form, shape, what),
                    inv_fma(*shape), 6 if form == 'f32' else 1,
                    lambda impl, rr=rr, ii=ii, wy=wy, tabs=tabs, prec=prec:
                    (ref._zy_inv_full_call(rr, ii, wy, tabs, precision=prec,
                                           impl=impl),)))
    for shape in ((a.n,) * 3, (256, 512, 30)):
        n0, N1, N2 = shape
        x = density(shape)
        wz = fm._cached(fm._dft_half_np, N2, N2 // 2 + 1)
        wy = fm._cached(fm._ct_fwd_mats_np, N1)
        for form in ('f32', 'bf16'):
            prec = 'bf16' if form == 'bf16' else None
            cases.append((
                'zy_fwd_half_ct %s %s' % (form, shape),
                fwd_fma(*shape), 6 if form == 'f32' else 1,
                lambda impl, x=x, wz=wz, wy=wy, prec=prec:
                ref._zy_fwd_half_ct_call(x, wz, wy, precision=prec,
                                         impl=impl)))

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
    print("root %s, torch %s" % (os.path.abspath(a.root), torch.__version__))
    t_start = time.time()
    for name, fma, products, fn in cases:
        got, want = fn('cuda'), fn('torch')
        rel = max(float((g - r).abs().max() / r.abs().max())
                  for g, r in zip(got, want))
        del got, want
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = fn('cuda')
        torch.cuda.synchronize()
        extra = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
        del out
        ms = cuda_ms(lambda: fn('cuda'))
        plain_ms = cuda_ms(lambda: fn('torch'), 1)
        share = products * 2 * fma / (ms * 1e-3) / PEAK_BF16
        print("%-52s kernel %.3f ms, plain %.3f ms, peak %.3f GiB beyond "
              "the inputs, max|k-p|/max|p| %.3e, tensor-core share %.3f "
              "(%.1f G real FMA x %d)"
              % (name, ms, plain_ms, extra, rel, share, fma / 1e9,
                 products), flush=True)
        torch.cuda.empty_cache()
    for name, _, _, fn in cases:
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
        print("%-52s device ms by kernel: %s" % (name, ", ".join(
            "%s %.3f" % kv for kv in sorted(by.items(),
                                            key=lambda kv: -kv[1]))),
              flush=True)
    print("%.1f s" % (time.time() - t_start))


if __name__ == "__main__":
    main()
