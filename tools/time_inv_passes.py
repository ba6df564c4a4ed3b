"""Time the inverse zy DFT passes of fft='mxu' on the first GPU, in each
form, each against its plain version on the same inputs, and break each
pass down into its device kernels with torch.profiler:

- zy_inv_ct2 (with the Nyquist plane) and zy_inv_ct2_dual (the plane on
  set A, i k_y and i k_z folded into the other set) at N^3 (ct2, dense z
  stage) and on a (16, N, 2 N) slab (the z-CT stage), f32 products on f32
  and on bf16 spectra ('f32', 'bf16s') and bf16 products ('bf16');
- zy_inv_half at NC^3 and at the slab shape (NC / 4, NC, NC / 2 + 1) of
  4 ranks (row 9), f32 and bf16 products.

The spectra are 1/k^2-filtered forward transforms of a density
1 + 0.3 N(0, 1), inverted along x; the folded tables carry the
SuperLanczos i k of the force.

    python3 tools/time_inv_passes.py [--root DIR] [--n N] [--nc NC]

--root imports pmesh_tpu_torch from DIR (an unpacked checkout of another
commit: time two commits in one call, in the order A, B, B, A); the
default is this checkout.  Prints the card's name and power limit, one
line per form (kernel ms: mean of 10 launches after a warm-up, CUDA
events; the device memory one call allocates beyond its inputs;
max|kernel - plain| / max|plain|) and one line per form of device ms by
kernel.
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
    ap.add_argument('--nc', type=int, default=384)
    a = ap.parse_args()
    sys.path.insert(0, os.path.abspath(a.root))
    import torch
    from pmesh_tpu_torch.ops import fft_mxu as fm
    if not torch.cuda.is_available():
        sys.exit("time_inv_passes: needs a CUDA GPU")
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True).stdout.strip()
    dev = torch.device('cuda')
    gen = torch.Generator(device=dev).manual_seed(5)
    bf16 = torch.bfloat16

    def sl(n, half=False):
        w = (np.fft.rfftfreq(n) if half else np.fft.fftfreq(n)) * 2 * np.pi
        return (8 * np.sin(w) - np.sin(2 * w)) / 6.0

    def spectrum(shape):
        """the x-inverted, 1/k^2-filtered half spectrum of a density (the
        input of a force's zy inverse), natural order"""
        x = 1.0 + 0.3 * torch.randn(shape, generator=gen, device=dev)
        k = torch.fft.rfftn(x, norm='forward')
        kk = sum(torch.as_tensor(
            (2 * np.pi * (np.fft.rfftfreq(n) if d == 2 else
                          np.fft.fftfreq(n))) ** 2, dtype=torch.float32,
            device=dev).reshape([-1 if e == d else 1 for e in range(3)])
                 for d, n in enumerate(shape))
        k = torch.where(kk > 0, k / torch.where(kk > 0, kk, 1.0), 0.0)
        return torch.fft.ifft(k, dim=0) * shape[0]

    forms = []
    for shape in ((a.n,) * 3, (16, a.n, 2 * a.n)):
        n0, N1, n2 = shape
        Zm = n2 // 2
        s = spectrum(shape)
        perm = torch.as_tensor(fm._ct_permute(N1), device=dev)
        sp = torch.empty_like(s[:, :, :Zm])
        sp[:, perm] = s[:, :, :Zm]
        if fm._use_zct_fwd(n2, Zm):
            zp = torch.as_tensor(fm._zct_perm(n2), device=dev)
            sp = torch.empty_like(sp).index_copy_(2, zp, sp)
        rr, ii = sp.real.contiguous(), sp.imag.contiguous()
        plane = s[:, :, Zm].real.contiguous()
        Wy = fm._cached(fm._ct_inv_mats_np, N1)
        Wyg = fm._cached(fm._ct_inv_mats_np, N1, tuple(sl(N1)))
        AB = fm._cached(fm._z_inv_tabs, n2, Zm)
        ABg = fm._cached(fm._z_inv_tabs, n2, Zm, tuple(sl(n2, True)))
        tag = '%d^3' % a.n if n0 == a.n else '(%d, %d, %d)' % shape
        for form in ('f32', 'bf16s', 'bf16'):
            p, q = (rr, ii) if form != 'bf16s' else (rr.to(bf16),
                                                     ii.to(bf16))
            prec = 'bf16' if form == 'bf16' else None
            forms += [
                ('zy_inv_ct2 %s %s' % (form, tag),
                 lambda impl, p=p, q=q, prec=prec, AB=AB, Wy=Wy, n2=n2,
                 plane=plane: (fm._zy_inv_ct2_call(
                     p, q, Wy, AB, n2, plane=plane, precision=prec,
                     impl=impl),)),
                ('zy_inv_ct2_dual %s %s' % (form, tag),
                 lambda impl, p=p, q=q, prec=prec, AB=AB, ABg=ABg, Wy=Wy,
                 Wyg=Wyg, n2=n2, plane=plane: fm._zy_inv_ct2_call_dual(
                     p, q, Wyg, AB, Wy, ABg, n2, planeA=plane,
                     precision=prec, impl=impl))]
        del s, sp
    for shape in ((a.nc,) * 3, (a.nc // 4, a.nc, a.nc)):
        n0, N1, n2 = shape
        Zh = n2 // 2 + 1
        s = spectrum(shape)
        rr, ii = s.real.contiguous(), s.imag.contiguous()
        wy = fm._cached(fm._dft_np, N1, +1)
        AB = fm._cached(fm._irfft_mats_np, n2, Zh)
        tag = '%d^3' % a.nc if n0 == N1 else '(%d, %d, %d)' % (n0, N1, Zh)
        for form in ('f32', 'bf16'):
            prec = 'bf16' if form == 'bf16' else None
            forms.append(
                ('zy_inv_half %s %s' % (form, tag),
                 lambda impl, rr=rr, ii=ii, wy=wy, AB=AB, prec=prec:
                 (fm._zy_inv_dense_call(rr, ii, wy, AB, precision=prec,
                                        impl=impl),)))
        del s

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
        print("%-40s kernel %.3f ms, peak %.3f GiB beyond the inputs, "
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
        print("%-40s device ms by kernel: %s" % (name, ", ".join(
            "%s %.3f" % kv for kv in sorted(by.items(),
                                            key=lambda kv: -kv[1]))),
              flush=True)
    print("%.1f s" % (time.time() - t_start))


if __name__ == "__main__":
    main()
