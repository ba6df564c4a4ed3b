"""Time the forward ct2 DFT passes of the port with the operand ring of
the split-precision routine 3 slices deep (``csrc/fft_mxu.cu`` as it is,
TC_DEPTH = 3) and 2 deep (a copy with TC_DEPTH = 2), on one GPU.

Builds both forms side by side under ``pmesh_tpu_torch/_build/ring/``,
then times ``zy_fwd_ct2`` at 512^3 and on a (16, 512, 1024) slab, the
forward ``xct_multi`` and its dual inverse with the 1/k^2 fold at 512^3
(CUDA events, mean of 10 calls after a warm-up) in the order 2, 3, 3, 2
deep, checks that both forms give bitwise the same outputs, and prints
each pass's device time by kernel (``torch.profiler``, 3 deep) and the
card's name and power limit:

    python3 tools/ring_depth_torch.py
"""
import ctypes
import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np  # noqa: E402
import torch  # noqa: E402

from pmesh_tpu_torch.native import cuda as nc  # noqa: E402
from pmesh_tpu_torch.ops import fft_mxu as fm  # noqa: E402
from pmesh_tpu_torch.ops import fft_mxu_cuda as fk  # noqa: E402

DEPTH = 'constexpr int TC_DEPTH = 3;'


def build(out, depth):
    """compile fft_mxu.cu with TC_DEPTH = depth into out; ptxas lines"""
    src = open(os.path.join(nc.CSRC, 'fft_mxu.cu')).read()
    assert DEPTH in src
    cu = os.path.join(out, 'fft_mxu_d%d.cu' % depth)
    with open(cu, 'w') as f:
        f.write(src.replace(DEPTH, 'constexpr int TC_DEPTH = %d;' % depth))
    lib = os.path.join(out, 'libfft_mxu_d%d.so' % depth)
    p = subprocess.run([nc.find_nvcc()] + nc.NVCC_FLAGS + ['-o', lib, cu],
                       capture_output=True, text=True)
    if p.returncode != 0:
        raise RuntimeError(p.stdout + p.stderr)
    return ctypes.CDLL(lib)


def cuda_ms(fn, reps=10):
    fn()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA GPU")
    out = os.path.join(nc.BUILD_DIR, 'ring')
    os.makedirs(out, exist_ok=True)
    with ThreadPoolExecutor(2) as ex:
        libs = dict(zip((2, 3), ex.map(lambda d: build(out, d), (2, 3))))

    def use(depth):
        fk._lib = None
        nc.load = lambda name: libs[depth]
        fk._load()

    dev = torch.device('cuda')
    gen = torch.Generator(device=dev).manual_seed(5)
    N = 512
    x = 1.0 + 0.3 * torch.randn((N,) * 3, generator=gen, device=dev)
    wz, wf = fm._z_fwd_tabs(N, N // 2), fm._ct_fwd_mats_np(N)
    wi = fm._ct_inv_mats_np(N)
    slab = (16, 512, 1024)
    xs = 1.0 + 0.3 * torch.randn(slab, generator=gen, device=dev)
    wzs, wys = fm._z_fwd_tabs(slab[2], slab[2] // 2), fm._ct_fwd_mats_np(512)
    k2 = tuple(np.random.RandomState(1).uniform(0, 2, n).astype('f4')
               for n in (N, N, N // 2))
    for t in k2:
        t[0] = 0.0
    use(3)
    pr, pi, _ = fm._zy_fwd_ct2_call(x, N, N // 2, wz, wf, impl='cuda')
    cases = {
        'zy_fwd_ct2 512^3': lambda: fm._zy_fwd_ct2_call(
            x, N, N // 2, wz, wf, impl='cuda'),
        'zy_fwd_ct2 slab': lambda: fm._zy_fwd_ct2_call(
            xs, slab[2], slab[2] // 2, wzs, wys, impl='cuda'),
        'xct_multi fwd 512^3': lambda: fm._xct_call_multi(
            pr, pi, wf, 1.0 / N ** 3, impl='cuda'),
        'xct_multi dual 512^3': lambda: fm._xct_call_multi(
            pr, pi, wi, 1.0, inverse=True, wx2=wi, k2=k2, impl='cuda'),
    }
    times = {k: {2: [], 3: []} for k in cases}
    outs = {}
    for depth in (2, 3, 3, 2):
        use(depth)
        for k, f in cases.items():
            outs.setdefault((k, depth), f())
            times[k][depth].append(cuda_ms(f))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    for k in cases:
        same = all(bool(torch.equal(a, b))
                   for a, b in zip(outs[(k, 2)], outs[(k, 3)]))
        print("%-22s 2 deep %s ms, 3 deep %s ms, bitwise equal %s"
              % (k, " ".join("%.3f" % t for t in times[k][2]),
                 " ".join("%.3f" % t for t in times[k][3]), same))
    use(3)
    from torch.profiler import ProfilerActivity, profile
    for k, f in cases.items():
        f()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                f()
            torch.cuda.synchronize()
        rows = []
        for e in prof.key_averages():
            t = getattr(e, 'device_time_total', 0)
            if t > 0:
                name = re.sub(r'\(anonymous namespace\)::|void ', '', e.key)
                rows.append((t / 5 / 1e3, name.split('(')[0]))
        print("%-22s by kernel (3 deep): %s" % (k, "; ".join(
            "%s %.3f ms" % (n, t) for t, n in sorted(rows, reverse=True))))


if __name__ == "__main__":
    main()
