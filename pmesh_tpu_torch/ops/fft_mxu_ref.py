"""The older DFT-as-matmul pipelines of ``fft='mxu'`` (kernel-table row
13): the dense full-spectrum 3-d transforms and the first Cooley-Tukey
half pipeline.

Counterpart of ``pmesh_tpu/ops/fft_mxu_ref.py``, which the JAX package
keeps as its ground-truth MXU implementation for tests:

- ``fft3_real_forward``, ``fft3_real_inverse`` and
  ``fft3_real_inverse_grad3``: the full (N0, N1, N2) spectrum at any
  shape, the forward scaled by 1/(N0 N1 N2) when ``norm``, the inverse
  unnormalized and real.  A gradient folds i*k_d into axis d's inverse
  DFT table, on the side of its spectrum index: the columns of the x and
  y tables, the rows of the z table.  The z wavenumbers run over all N2
  modes (fftfreq, not rfftfreq);
- ``fft3_real_forward_half_ct`` and ``fft3_real_inverse_grad3_half_ct``:
  the half spectrum (N0, N1, N2 // 2 + 1) with the x and y axes
  Cooley-Tukey factored (R * 128k long, R > 1) and chunk-permuted (slot
  ``j * M + q`` holds mode ``j + R * q``, ``fft_mxu._ct_permute``), the
  z-Nyquist column kept at index Zh - 1 (the ct2 pipeline splits it off).

Each entry point runs a zy pass per x-plane and an x pass, as the JAX
package's Pallas kernels split the work.  The x passes are those of
``ops/fft_mxu.py``: the dense ``_x_dense_call`` at width N2 and the CT
``_xct_call_multi`` at width Zh.  The zy passes have plain PyTorch
versions (``*_plain``, matmuls) and hand CUDA kernels
(``ops/fft_mxu_cuda.zy_fwd_full``, ``zy_inv_full``, ``zy_fwd_half_ct``
and ``zy_inv_half_ct``).  ``impl`` chooses as in ``ops/fft_mxu.py``:
None takes the kernels for CUDA tensors and the plain versions for CPU
tensors.  The JAX package runs the two inverse x passes of a force
triple (plain and i*k_x-folded) as two launches; here they are one dual
launch on one read of the spectrum.  The full-spectrum inverse runs z
then y, as the JAX kernel does, so that ``precision='bf16'``
(single-pass bf16 products, on every entry point) rounds the same
intermediate.
"""
import torch

from . import fft_mxu as _fm

__all__ = ["fft3_real_forward", "fft3_real_inverse",
           "fft3_real_inverse_grad3", "fft3_real_forward_half_ct",
           "fft3_real_inverse_grad3_half_ct"]


def _z_inv_full_np(n2, kvec=None):
    """(A, B) = (Re Wz, -Im Wz) of the (n2, n2) inverse z DFT, with
    i * kvec folded into its rows when given: the real part of
    (yr + i yi) @ Wz is yr @ A + yi @ B."""
    wr, wi = _fm._dft_np(n2, +1)
    if kvec is not None:
        wr, wi = _fm._fold_i_freq(wr, wi, kvec, 'left')
    return wr, -wi


def _ct_check(N0, N1):
    if _fm._ct_factor(N0)[0] == 1 or _fm._ct_factor(N1)[0] == 1:
        raise ValueError("CT needs Nmesh[0] and Nmesh[1] to factor as "
                         "R*128k (got %d, %d); use the dense "
                         "fft3_real_forward_half" % (N0, N1))


# --- the zy passes: plain versions and dispatch -------------------------------

def zy_fwd_half_ct_plain(x, wz, wy, bf16=False):
    """Row 13 half-CT pass 1, plain: real (n0, N1, N2) -> (r, i)
    (n0, N1, Zh): the (N2, Zh) half-DFT pair ``wz``, then the y CT by
    the ``_ct_fwd_mats_np(N1)`` pair ``wy`` (y chunk-permuted out)."""
    p = x.to(torch.float32)
    wzr, wzi = (_fm._t(a, p) for a in wz)
    return _fm._ct_fwd_plain(_fm._mm(p, wzr, bf16), _fm._mm(p, wzi, bf16),
                             *(_fm._t(a, p) for a in wy), bf16=bf16)


def zy_inv_full_plain(rr, ii, wy, AB, bf16=False):
    """Row 13 full-spectrum zy inverse, plain: (n0, N1, N2) spectrum ->
    real (n0, N1, N2): the complex z product by Wz, whose (N2, N2) pair
    enters as ``AB`` = (Re Wz, -Im Wz), then the real part of the
    inverse y DFT ``wy``; z first, as the JAX kernel."""
    xr, xi = rr.to(torch.float32), ii.to(torch.float32)
    A, B = (_fm._t(a, xr) for a in AB)
    zr = _fm._mm(xr, A, bf16) + _fm._mm(xi, B, bf16)
    zi = _fm._mm(xi, A, bf16) - _fm._mm(xr, B, bf16)
    wyr, wyi = (_fm._t(a, xr) for a in wy)
    return _fm._mm(wyr, zr, bf16) - _fm._mm(wyi, zi, bf16)


def _zy_fwd_full_call(x, wz, wy, precision=None, impl=None):
    """full-spectrum pass 1: the (N2, N2) z DFT and the y DFT"""
    bf16 = _fm._bf16_products(precision)
    if _fm._use_cuda(impl, x):
        from . import fft_mxu_cuda as _k
        x, = _fm._f32_pass(x)
        return _k.zy_fwd_full(x, wz, wy, bf16=bf16)
    return _fm.zy_fwd_half_plain(x, wz, wy, bf16)


def _zy_inv_full_call(rr, ii, wy, AB, precision=None, impl=None):
    """full-spectrum inverse zy pass: the real part of the inverse z and
    y DFTs, AB = ``_z_inv_full_np``"""
    bf16 = _fm._bf16_products(precision)
    if _fm._use_cuda(impl, rr):
        from . import fft_mxu_cuda as _k
        rr, ii = _fm._f32_pass(rr, ii)
        return _k.zy_inv_full(rr, ii, wy, AB, bf16=bf16)
    return zy_inv_full_plain(rr, ii, wy, AB, bf16)


def _zy_fwd_half_ct_call(x, wz, wy, precision=None, impl=None):
    bf16 = _fm._bf16_products(precision)
    if _fm._use_cuda(impl, x):
        from . import fft_mxu_cuda as _k
        x, = _fm._f32_pass(x)
        return _k.zy_fwd_half_ct(x, wz, wy, bf16=bf16)
    return zy_fwd_half_ct_plain(x, wz, wy, bf16)


def _zy_inv_half_ct_call(rr, ii, Wy, AB, n2, precision=None, impl=None):
    """half-CT inverse zy pass: the inverse y CT, then the (Zh, n2)
    irfft pair ``AB``"""
    bf16 = _fm._bf16_products(precision)
    if _fm._use_cuda(impl, rr):
        from . import fft_mxu_cuda as _k
        rr, ii = _fm._f32_pass(rr, ii)
        return _k.zy_inv_half_ct(rr, ii, Wy, AB, n2, bf16=bf16)
    return _fm.zy_inv_ct2_plain(rr, ii, Wy, AB, n2, bf16=bf16)


# --- the full-spectrum entry points -------------------------------------------

def fft3_real_forward(x, norm=True, precision=None, impl=None):
    """full-spectrum forward 3-d FFT of a real f32 (N0, N1, N2) mesh:
    (real, imag) of the same shape, scaled by 1/(N0 N1 N2) when
    ``norm`` (the engine's r2c convention)."""
    N0, N1, N2 = x.shape
    wz = _fm._cached(_fm._dft_np, N2, -1)
    wy = _fm._cached(_fm._dft_np, N1, -1)
    wx = _fm._cached(_fm._dft_np, N0, -1)
    kw = dict(precision=precision, impl=impl)
    pr, pi = _zy_fwd_full_call(x, wz, wy, **kw)
    scale = 1.0 / (N0 * N1 * N2) if norm else 1.0
    return _fm._x_dense_call(pr, pi, wx, scale, **kw)


def fft3_real_inverse(r, i, grad=None, kvec=None, precision=None,
                      impl=None):
    """the unnormalized inverse of :func:`fft3_real_forward`, real part
    (``c2r(r2c(x)) == x`` when the forward used norm=True).

    grad : None or an axis; then the spectrum is multiplied by
        i * kvec along that axis first, folded into the axis's DFT table.
    kvec : the wavenumbers of that axis, a sequence of its length."""
    if grad is not None and kvec is None:
        raise ValueError("grad=%r needs kvec (a static tuple of the "
                         "wavenumbers along that axis)" % (grad,))
    if grad not in (None, 0, 1, 2):
        raise ValueError("grad must be None, 0, 1 or 2 (got %r)" % (grad,))
    N0, N1, N2 = r.shape
    kvec = None if kvec is None else tuple(float(v) for v in kvec)
    wx = (_fm._cached(_fm._dft_fold_np, N0, kvec) if grad == 0
          else _fm._cached(_fm._dft_np, N0, +1))
    wy = (_fm._cached(_fm._dft_fold_np, N1, kvec) if grad == 1
          else _fm._cached(_fm._dft_np, N1, +1))
    AB = _fm._cached(_z_inv_full_np, N2, kvec if grad == 2 else None)
    kw = dict(precision=precision, impl=impl)
    sr, si = _fm._x_dense_call(r, i, wx, 1.0, **kw)
    return _zy_inv_full_call(sr, si, wy, AB, **kw)


def fft3_real_inverse_grad3(r, i, kvecs, precision=None, impl=None):
    """the spectral force triple of one full spectrum (r, i): the real
    inverses of i*k_d times it, d = 0, 1, 2.  The y and z gradients fold
    into the zy tables and share the plain x pass; the x gradient folds
    into the second table set of the same (dual) x pass.

    kvecs : three wavenumber sequences of lengths N0, N1, N2."""
    N0, N1, N2 = r.shape
    kvecs = _fm._tuples(kvecs)
    wx = _fm._cached(_fm._dft_np, N0, +1)
    wy = _fm._cached(_fm._dft_np, N1, +1)
    wx_g = _fm._cached(_fm._dft_fold_np, N0, kvecs[0])
    wy_g = _fm._cached(_fm._dft_fold_np, N1, kvecs[1])
    AB = _fm._cached(_z_inv_full_np, N2, None)
    AB_g = _fm._cached(_z_inv_full_np, N2, kvecs[2])
    kw = dict(precision=precision, impl=impl)
    sr, si, gr, gi = _fm._x_dense_call(r, i, wx, 1.0, wx2=wx_g, **kw)
    fy = _zy_inv_full_call(sr, si, wy_g, AB, **kw)
    fz = _zy_inv_full_call(sr, si, wy, AB_g, **kw)
    del sr, si
    fx = _zy_inv_full_call(gr, gi, wy, AB, **kw)
    return fx, fy, fz


# --- the first-CT half entry points -------------------------------------------

def fft3_real_forward_half_ct(x, norm=True, precision=None, impl=None):
    """hermitian-half forward FFT of a real f32 (N0, N1, N2) mesh with
    CT-factored x and y: (r, i) of shape (N0, N1, N2 // 2 + 1), x and y
    chunk-permuted, scaled by 1/(N0 N1 N2) when ``norm``."""
    N0, N1, N2 = x.shape
    _ct_check(N0, N1)
    Zh = N2 // 2 + 1
    wz = _fm._cached(_fm._dft_half_np, N2, Zh)
    wy = _fm._cached(_fm._ct_fwd_mats_np, N1)
    wx = _fm._cached(_fm._ct_fwd_mats_np, N0)
    kw = dict(precision=precision, impl=impl)
    pr, pi = _zy_fwd_half_ct_call(x, wz, wy, **kw)
    scale = 1.0 / (N0 * N1 * N2) if norm else 1.0
    return _fm._xct_call_multi(pr, pi, wx, scale, **kw)


def fft3_real_inverse_grad3_half_ct(r, i, n2, kvecs, precision=None,
                                    impl=None):
    """the CT spectral force triple: the real inverses of i*k_d times
    the chunk-permuted half spectrum (r, i) of
    :func:`fft3_real_forward_half_ct`, i*k_d folded into the per-chunk
    inverse tables and the irfft matrices.

    kvecs : natural-order wavenumbers of lengths N0, N1 and Zh; the x
        and y ones must vanish at the Nyquist index of an even axis."""
    N0, N1, Zh = r.shape
    _fm._check_kvecs(kvecs, N0, N1)
    _ct_check(N0, N1)
    if n2 // 2 + 1 != Zh:
        raise ValueError("n2=%d does not give the %d half-spectrum columns"
                         % (n2, Zh))
    if len(kvecs[2]) != Zh:
        raise ValueError("kvecs[2] must have length Zh=%d" % Zh)
    kvecs = _fm._tuples(kvecs)
    wy = _fm._cached(_fm._ct_inv_mats_np, N1)
    wx = _fm._cached(_fm._ct_inv_mats_np, N0)
    wx_g = _fm._cached(_fm._ct_inv_mats_np, N0, kvecs[0])
    wy_g = _fm._cached(_fm._ct_inv_mats_np, N1, kvecs[1])
    AB_p = _fm._cached(_fm._irfft_mats_np, n2, Zh)
    AB_g = _fm._cached(_fm._irfft_mats_np, n2, Zh, kvecs[2])
    kw = dict(precision=precision, impl=impl)
    sr, si, gr, gi = _fm._xct_call_multi(r, i, wx, 1.0, inverse=True,
                                         wx2=wx_g, **kw)
    fy = _zy_inv_half_ct_call(sr, si, wy_g, AB_p, n2, **kw)
    fz = _zy_inv_half_ct_call(sr, si, wy, AB_g, n2, **kw)
    del sr, si
    fx = _zy_inv_half_ct_call(gr, gi, wy, AB_p, n2, **kw)
    return fx, fy, fz
