"""How far the port's plain f32 ct2 forward transform sits from the same
transform with every product summed in f64, per output and per column.

Runs the public forward ``fft3_real_forward_half_ct2`` (``impl='torch'``)
on 1 + 0.3 N(0, 1) once as it is and once with ``ops/fft_mxu._mm``
summing each product in f64, and prints max|f32 - f64| / max|f64| of
each output, with and without the column that carries the mean (y = z =
0), and without the stored z columns [0, 8): the z = 0 plane and the
first 8 modes of z chunk 0, which the CUDA kernels form in f32 as the
plain version does (``csrc/fft_mxu.cu``, QZ).  On the CPU by default (about 30 s and a few
GB at the default shape), or on the first GPU with ``--cuda``:

    python3 tools/plain_f32_gap.py [N0 N1 N2] [--cuda]
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np  # noqa: E402
import torch  # noqa: E402

from pmesh_tpu_torch.ops import fft_mxu as fm  # noqa: E402


def main():
    args = [a for a in sys.argv[1:] if a != '--cuda']
    dev = 'cuda' if '--cuda' in sys.argv[1:] else 'cpu'
    shape = tuple(int(v) for v in args[:3]) or (512, 256, 1024)
    x = torch.from_numpy((1.0 + 0.3 * np.random.RandomState(14).normal(
        size=shape)).astype('f4')).to(dev)
    t0 = time.time()
    f32 = fm.fft3_real_forward_half_ct2(x, impl='torch')
    orig = fm._mm
    fm._mm = lambda a, b, bf16=False: torch.matmul(a.double(), b.double())
    try:
        f64 = fm.fft3_real_forward_half_ct2(x, impl='torch')
    finally:
        fm._mm = orig
    for name, a, b in zip(("real", "imag", "nyquist real", "nyquist imag"),
                          f32, f64):
        d = (a - b).abs() / b.abs().max()
        text = "%.3e of max" % float(d.max())
        if d.dim() == 3:
            text += (", without the (y, z) = (0, 0) column %.3e, without z"
                     " columns [0, 8) %.3e" % (float(d[:, 1:].max().clamp_min(
                         d[:, 0, 1:].max())), float(d[..., 8:].max())))
        print("%s %-13s plain f32 vs f64 products: %s" % (shape, name, text))
    print("%.1f s" % (time.time() - t0))


if __name__ == "__main__":
    main()
