"""How far the port's plain f32 forward transform sits from the same
transform with every product summed in f64, per output and per column.

Runs the public forward (``fft3_real_forward_half_ct2`` at a ct2 shape,
``fft3_real_forward_half``, the dense pipeline, at every other one;
``impl='torch'``) on 1 + 0.3 N(0, 1) once as it is and once with
``ops/fft_mxu._mm`` summing each product in f64, and prints max|f32 -
f64| / max|f64| of each output.  The CUDA kernels form a few outputs
in f32 chains as the plain version does (``csrc/fft_mxu.cu``, QZ): the
first QZ stored z columns (the first modes of z chunk 0; in the dense
pipeline the first QZ z modes) and the (y, z) = (0, 0) column of the x
stage, whose z = 0 plane the y stage also forms so.  The script prints
the gap with and without those, and for the dense pipeline each of the
first 12 z columns and the last one apart, with the columns whose gap
exceeds 1e-5 of max.  On the CPU by default (about 30 s and a few GB
at the default shape), or on the first GPU with ``--cuda``:

    python3 tools/plain_f32_gap.py [N0 N1 N2] [--cuda]
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np  # noqa: E402
import torch  # noqa: E402

from pmesh_tpu_torch.ops import fft_mxu as fm  # noqa: E402

QZ = 8          # the kernels' chained z columns (csrc/fft_mxu.cu)
TOL = 1e-5      # the kernels' tolerance against plain, of max


def main():
    args = [a for a in sys.argv[1:] if a != '--cuda']
    dev = 'cuda' if '--cuda' in sys.argv[1:] else 'cpu'
    shape = tuple(int(v) for v in args[:3]) or (512, 256, 1024)
    x = torch.from_numpy((1.0 + 0.3 * np.random.RandomState(14).normal(
        size=shape)).astype('f4')).to(dev)
    forward = (fm.fft3_real_forward_half_ct2 if fm.is_ct2(shape)
               else fm.fft3_real_forward_half)
    t0 = time.time()
    f32 = forward(x, impl='torch')
    orig = fm._mm
    fm._mm = lambda a, b, bf16=False: torch.matmul(a.double(), b.double())
    try:
        f64 = forward(x, impl='torch')
    finally:
        fm._mm = orig
    for name, a, b in zip(("real", "imag", "nyquist real", "nyquist imag"),
                          f32, f64):
        d = (a - b).abs() / b.abs().max()
        text = "%.3e of max" % float(d.max())
        if d.dim() == 3:
            # the x stage's (y, z) = (0, 0) column out
            rest = d.clone()
            rest[:, 0, 0] = 0
            text += (", without the (y, z) = (0, 0) column %.3e, without it"
                     " and z columns [0, %d) %.3e"
                     % (float(rest.max()), QZ, float(rest[..., QZ:].max())))
            if not fm.is_ct2(shape):
                col = rest.amax((0, 1)).cpu().numpy()
                text += ("; by z column (0, 0) line out: %s ... last %.3e; "
                         "columns beyond %.0e: %s"
                         % (" ".join("%.2e" % v for v in col[:12]),
                            col[-1], TOL,
                            [int(q) for q in np.nonzero(col > TOL)[0]]))
        print("%s %-13s plain f32 vs f64 products: %s" % (shape, name, text))
    print("%.1f s" % (time.time() - t0))


if __name__ == "__main__":
    main()
