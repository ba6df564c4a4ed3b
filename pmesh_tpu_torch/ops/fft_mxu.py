"""The DFT-as-matmul FFT of ``fft='mxu'``: the split-Nyquist
Cooley-Tukey pipeline and, at every other shape, the dense one.

Counterpart of the single-device part of ``pmesh_tpu/ops/fft_mxu.py``.
A real (N0, N1, N2) mesh whose x and y lengths split as R * M (R in
{8, 4, 2}, M a multiple of 128) and whose z length is even takes the
ct2 pipeline: small dense DFT matrices wrapped in R-way butterflies:

  pass 1 (``_zy_fwd_ct2_call``, kernel-table row 6): per x-plane, the
      z half-DFT (dense, or z-CT when ``_use_zct_fwd``) to Zm = N2 // 2
      modes, then the y CT; the z-Nyquist column leaves as a raw
      alternating row sum;
  pass 2 (``_xct_call_multi``, row 5): the x CT, forward x scale or
      inverse, with an optional second table set on the same input and
      an optional 1/k^2 fold from three 1-d tables;
  inverse (``_zy_inv_ct2_call``, row 7, and ``_zy_inv_ct2_call_dual``,
      row 8): the inverse y CT then the z half -> real, optionally plus
      the inverted Nyquist plane with weights (-1)^n.

The layout is the JAX package's: slot ``j * M + q`` of the x and y axes
holds mode ``j + R * q`` (``_ct_permute``), z is stored in the order of
``_zct_perm`` when the z-CT gate is on, and the z-Nyquist plane is a
separate (N0, N1) pair in natural order.

Every other f32 3-d shape takes the dense pipeline, in natural order
with the z-Nyquist column kept among the Zh = N2 // 2 + 1 half-spectrum
columns (kernel-table rows 3 and 4):

  forward (``fft3_real_forward_half``, row 3): per x-plane the z
      half-DFT and the dense y DFT (``_zy_fwd_dense_call``), then the
      dense x DFT times 1/(N0 N1 N2) (``_x_dense_call``);
  force triple (``fft3_real_inverse_grad3_half``, row 4): the inverse
      x DFT, plain and with i*k_x folded into its columns, as one dual
      pass that can fold 1/k^2 in too (``_x_dense_call``), then three
      inverse y DFTs with z half -> real (``_zy_inv_dense_call``).

Complex data is carried as (real, imag) f32 pairs.  The forward
transform is scaled by 1/(N0 N1 N2) and the inverse is unnormalized,
as ``ops/fft.py``.

Each of the seven passes has a plain PyTorch version here (``*_plain``,
batched matmuls; the CPU path and the reference the kernels are held
against) and a hand CUDA kernel (``ops/fft_mxu_cuda.py``,
``csrc/fft_mxu.cu``).  ``impl=None`` takes the kernel for CUDA tensors
and the plain version for CPU tensors; ``impl='cuda'`` on a CPU tensor
raises and nothing falls back.  The small (N0, N1) Nyquist-plane DFTs
(``_plane_fft2``) stay ``torch.matmul``, as the JAX package leaves them
to XLA outside its kernels.

The two bf16 forms of the JAX package are here too:

- ``precision='bf16'`` (``fft='mxu_bf16'``) on every public operator:
  single-pass bf16 products, as ``jax.lax.Precision('default')`` runs
  them on the MXU: each operand of each product (data and table) rounded
  to bf16, the sum kept in f32.  The plain versions round with
  ``_rb``/``_mm`` exactly where the JAX kernels' products round; the
  kernels run them on the tensor cores;
- ``spectrum_dtype=torch.bfloat16`` (``fft='mxu_bf16s'``) on the ct2
  forward: the spectrum is stored in bf16 between the passes (the zy
  forward's and the x passes' outputs), with f32 products; the ct2
  inverses keep a bf16 input's x-pass outputs in bf16.  The real meshes
  and the Nyquist plane stay f32, and the dense pipeline has no storage
  dtype, as in the JAX package.

The slab-sharded forms of both pipelines (``*_sharded``, the end of
this module) run the same passes per rank on the slabs of
``parallel/pmesh.py`` with all_to_all transposes between them.

Left out on purpose: the TPU tuning (``TUNE``, the block-size pickers,
the compiler parameters).
"""
import numpy as np
import torch

__all__ = ["fft3_real_forward_half_ct2", "fft3_real_inverse_grad3_half_ct2",
           "fft3_poisson_half_ct2", "is_ct2", "fft3_real_forward_half",
           "fft3_real_inverse_grad3_half",
           "fft3_real_forward_half_ct2_sharded",
           "fft3_real_inverse_grad3_half_ct2_sharded",
           "fft3_poisson_half_ct2_sharded", "fft3_real_forward_half_sharded",
           "fft3_real_inverse_grad3_half_sharded"]


# --- static tables (numpy, the JAX package's math) ---------------------------

def _dft_np(n, sign):
    k = np.arange(n)
    W = np.exp(sign * 2j * np.pi * np.outer(k, k) / n)
    return W.real.astype(np.float32), W.imag.astype(np.float32)


def _dft_half_np(n, zh):
    k = np.arange(n)[:, None] * np.arange(zh)[None, :]
    W = np.exp(-2j * np.pi * k / n)
    return W.real.astype(np.float32), W.imag.astype(np.float32)


def _irfft_mats_np(n, zh, grad_kvec=None, nyquist_last=True):
    """(A, B) with out = Zr @ A + Zi @ B reconstructing the real inverse
    along z; grad_kvec folds an extra i*k_z factor.  nyquist_last=False:
    the zh columns exclude the Nyquist mode (the split-Nyquist pipeline
    handles it separately)."""
    m = np.full(zh, 2.0)
    m[0] = 1.0
    if n % 2 == 0 and nyquist_last:
        m[-1] = 1.0
    theta = 2 * np.pi * np.arange(zh)[:, None] * np.arange(n)[None, :] / n
    c = np.cos(theta) * m[:, None]
    s_ = np.sin(theta) * m[:, None]
    if grad_kvec is None:
        A, B = c, -s_
    else:
        kz = np.asarray(grad_kvec, dtype=np.float64)[:, None]
        A, B = -kz * s_, -kz * c
    return A.astype(np.float32), B.astype(np.float32)


def _fold_i_freq(Wr, Wi, freqs, side):
    """fold diag(i * freqs) into a (numpy) DFT matrix (rows:
    side='left', columns: side='right'): multiplying the spectrum by
    i*k_d before an inverse transform becomes a change of the matrix."""
    f = np.asarray(freqs, dtype=np.float32)
    if side == 'left':
        return -Wi * f[:, None], Wr * f[:, None]
    return -Wi * f[None, :], Wr * f[None, :]


def _dft_fold_np(n, freqs):
    """the inverse dense DFT pair of length n with i*freqs folded into
    its columns (the dense pipeline's gradient tables)."""
    return _fold_i_freq(*_dft_np(n, +1), freqs, 'right')


def _zct_factor(N2):
    """(Rz, K, Mq): Rz forward chunks, contraction K = N2 // Rz,
    Mq = Zm // Rz stored modes per chunk.  (1, N2, Zm) = stay dense."""
    for Rz in (8, 4, 2):
        if N2 % (2 * Rz) == 0 and (N2 // Rz) % 128 == 0:
            return Rz, N2 // Rz, (N2 // 2) // Rz
    return 1, N2, N2 // 2


def _zct_order(Rz):
    """storage order of the forward z chunks: {j, j + Rz/2} pairs
    adjacent, so the Ri = Rz/2 inverse reads contiguous columns."""
    if Rz % 2 == 0 and Rz > 2:
        out = []
        for j in range(Rz // 2):
            out += [j, j + Rz // 2]
        return out
    return list(range(Rz))


def _use_zct_fwd(N2, Zm):
    Rz, K, Mq = _zct_factor(N2)
    return Rz > 1 and Zm == N2 // 2


def _use_zct_inv(N2, Zm):
    if not _use_zct_fwd(N2, Zm):
        return False
    Rz, K, Mq = _zct_factor(N2)
    return Rz == 8 and ((N2 // 2) // (Rz // 2)) % 128 == 0


def _zct_perm(N2):
    """stored slot of each natural z mode k (k < Zm)."""
    Rz, K, Mq = _zct_factor(N2)
    order = _zct_order(Rz)
    pos = np.empty(Rz, np.int64)
    for p, j in enumerate(order):
        pos[j] = p
    k = np.arange(N2 // 2)
    return pos[k % Rz] * Mq + k // Rz


def _zct_table(N2, table):
    """reorder a natural-order z-mode table (len >= Zm) into the stored
    slot order: stored[s] holds table[k(s)]."""
    Zm = N2 // 2
    t = np.asarray(table)[:Zm]
    out = np.empty_like(t)
    out[_zct_perm(N2)] = t
    return out


def _zct_fwd_mats_np(N2):
    """(Er, Ei) of shape (Rz, K, Mq) in storage order: X_block_p =
    u_{order[p]} @ (Er[p] + i Ei[p])."""
    Rz, K, Mq = _zct_factor(N2)
    Er = np.empty((Rz, K, Mq), np.float32)
    Ei = np.empty((Rz, K, Mq), np.float32)
    m = np.arange(K)
    for p, j in enumerate(_zct_order(Rz)):
        q = np.arange(Mq)
        E = np.exp(-2j * np.pi * np.outer(m, j + Rz * q) / N2)
        Er[p] = E.real
        Ei[p] = E.imag
    return Er, Ei


def _zct_inv_mats_np(N2, grad_kvec=None, negate=False):
    """(A, B) of shape (Ri, Kin, Kb) consuming the stored-order
    spectrum: inverse chunk j reads stored columns [j*Kin, (j+1)*Kin).
    grad_kvec folds i*k_z (natural-order table); negate folds an overall
    -1 (the Poisson potential sign)."""
    Rz, K, Mq = _zct_factor(N2)
    Ri = Rz // 2 if Rz == 8 else Rz
    Kin = (N2 // 2) // Ri
    Kb = N2 // Ri
    order = _zct_order(Rz)
    A = np.empty((Ri, Kin, Kb), np.float32)
    B = np.empty((Ri, Kin, Kb), np.float32)
    m = np.arange(Kb)
    for j4 in range(Ri):
        # the storage blocks whose forward residue j8 == j4 (mod Ri), in
        # storage order: contiguous by construction of _zct_order
        blocks = [j8 for j8 in order if j8 % Ri == j4]
        ks = np.concatenate([j8 + Rz * np.arange(Mq) for j8 in blocks])
        w = np.where(ks == 0, 1.0, 2.0)
        th = 2 * np.pi * np.outer(ks, m) / N2
        c = np.cos(th) * w[:, None]
        s = np.sin(th) * w[:, None]
        if grad_kvec is None:
            Aj, Bj = c, -s
        else:
            kz = np.asarray(grad_kvec, np.float64)[ks][:, None]
            Aj, Bj = -kz * s, -kz * c
        if negate:
            Aj, Bj = -Aj, -Bj
        A[j4], B[j4] = Aj, Bj
    return A, B


def _z_fwd_tabs(N2, Zm):
    """forward z tables: z-CT (Er, Ei) 3-d when gated, else the dense
    half-DFT pair (2-d); the passes dispatch on ndim."""
    if _use_zct_fwd(N2, Zm):
        return _zct_fwd_mats_np(N2)
    return _dft_half_np(N2, Zm)


def _z_inv_tabs(n2, Zm, grad_kvec=None, negate=False):
    """inverse z tables matching the _z_fwd_tabs storage order: z-CT
    (A, B) 3-d when the fused inverse pays, else dense irfft matrices
    with rows permuted to the stored order."""
    if _use_zct_inv(n2, Zm):
        return _zct_inv_mats_np(n2, grad_kvec=grad_kvec, negate=negate)
    gk = None if grad_kvec is None else np.asarray(grad_kvec)[:Zm]
    A, B = _irfft_mats_np(n2, Zm, grad_kvec=gk, nyquist_last=False)
    if _use_zct_fwd(n2, Zm):
        perm = _zct_perm(n2)
        Ap = np.empty_like(A)
        Bp = np.empty_like(B)
        Ap[perm] = A
        Bp[perm] = B
        A, B = Ap, Bp
    if negate:
        A, B = -A, -B
    return A, B


def _ct_factor(n):
    """(R, M) split: the largest radix in {8, 4, 2} keeping M a multiple
    of 128.  (1, n) means no split."""
    for R in (8, 4, 2):
        if n % R == 0 and (n // R) % 128 == 0:
            return R, n // R
    return 1, n


def _ct_permute(n):
    """slot index of each mode: mode k is stored at slot
    (k % R) * M + k // R, so ``natural[k] = stored[_ct_permute(n)[k]]``."""
    R, M = _ct_factor(n)
    k = np.arange(n)
    return (k % R) * M + k // R


def _ct_table(n, table):
    """reorder a natural-order per-axis table into the stored order:
    slot j*M + q holds mode j + R*q."""
    R, M = _ct_factor(n)
    s = np.arange(n)
    return np.asarray(table)[(s // M) + R * (s % M)]


def _ct_fwd_mats_np(n):
    """per-chunk forward matrices (R, M, M): W_j[q, m] =
    W_M^{qm} * W_N^{mj} (twiddle in the columns)."""
    R, M = _ct_factor(n)
    q = np.arange(M)
    m = np.arange(M)
    Wr = np.empty((R, M, M), np.float32)
    Wi = np.empty((R, M, M), np.float32)
    for j in range(R):
        W = np.exp(-2j * np.pi * (np.outer(q, m) / M + m[None, :] * j / n))
        Wr[j] = W.real
        Wi[j] = W.imag
    return Wr, Wi


def _ct_inv_mats_np(n, fold_kvec=None):
    """per-chunk inverse matrices (R, M, M): W_j[m, q] =
    W_M^{-mq} * W_N^{-mj}, optionally with diag(i * k_perm_j) folded
    into the columns."""
    R, M = _ct_factor(n)
    q = np.arange(M)
    m = np.arange(M)
    Wr = np.empty((R, M, M), np.float32)
    Wi = np.empty((R, M, M), np.float32)
    kv = None if fold_kvec is None else np.asarray(fold_kvec, np.float64)
    for j in range(R):
        W = np.exp(2j * np.pi * (np.outer(m, q) / M + m[:, None] * j / n))
        if kv is not None:
            W = W * (1j * kv[j + R * q])[None, :]
        Wr[j] = W.real
        Wi[j] = W.imag
    return Wr, Wi


def _butter(R, sign):
    """numpy complex butterfly constants W_R^{sign * r j}."""
    r = np.arange(R)
    return np.exp(sign * 2j * np.pi * np.outer(r, r) / R)


def _poisson_tables(poisson_k2, N0, N1, Zm):
    """the 1/k^2 tables of the ct2 inverse entry points: the DC-zeroed
    inverse filter of the (N0, N1) Nyquist plane (numpy f32) and the
    storage-permuted 1-d tables folded into the x pass."""
    k2p = (np.asarray(poisson_k2[0], np.float32)[:, None]
           + np.asarray(poisson_k2[1], np.float32)[None, :]
           + np.float32(poisson_k2[2][Zm]))
    invk2p = np.where(k2p > 0, 1.0 / np.where(k2p > 0, k2p, 1.0),
                      0.0).astype(np.float32)
    k2z = np.asarray(poisson_k2[2][:Zm], np.float32)
    if _use_zct_fwd(2 * Zm, Zm):
        k2z = _zct_table(2 * Zm, k2z).astype(np.float32)
    k2m = (_ct_table(N0, poisson_k2[0]).astype(np.float32),
           _ct_table(N1, poisson_k2[1]).astype(np.float32),
           k2z)
    return invk2p, k2m


_CACHE = {}


def _cached(fn, *args):
    """fn(*args) built once per hashable argument tuple: the public
    operators use the same numpy objects call after call, so each table
    is uploaded once per device (``_on_device``)."""
    key = (fn.__name__,) + args
    if key not in _CACHE:
        _CACHE[key] = fn(*args)
    return _CACHE[key]


_DEVICE_COPIES = {}


def _on_device(a, device):
    """the f32 copy of numpy table ``a`` on ``device``, made once per
    table object and device: no host-to-device copy, which would stall
    the host, inside a step."""
    key = (id(a), str(device))
    hit = _DEVICE_COPIES.get(key)
    if hit is None or hit[0] is not a:
        hit = (a, torch.as_tensor(np.ascontiguousarray(a, np.float32),
                                  device=device))
        _DEVICE_COPIES[key] = hit
    return hit[1]


def _f32(table):
    return np.asarray(table, np.float32)


def is_ct2(shape):
    """whether a 3-d mesh shape takes the split-Nyquist CT pipeline:
    x and y lengths R * 128k, z length even."""
    N0, N1, N2 = (int(n) for n in shape)
    return _ct_factor(N0)[0] > 1 and _ct_factor(N1)[0] > 1 and N2 % 2 == 0


# --- the bf16 forms -----------------------------------------------------------

def _bf16_products(precision):
    """whether ``precision`` asks for the single-pass bf16 products of
    the JAX package's ``precision='bf16'`` (``jax.lax.Precision
    ('default')``: each operand of each product rounded to bf16, the sum
    kept in f32); None or 'f32' (JAX's three-pass f32-exact products)
    give f32 products."""
    if precision in (None, 'f32'):
        return False
    if precision == 'bf16':
        return True
    raise ValueError("precision must be None, 'f32' or 'bf16' (got %r)"
                     % (precision,))


def _storage(dtype):
    """the spectrum storage dtype: f32 (None) or bf16"""
    if dtype is None or dtype == torch.float32:
        return torch.float32
    if dtype == torch.bfloat16:
        return torch.bfloat16
    raise ValueError("spectrum_dtype must be None, torch.float32 or "
                     "torch.bfloat16 (got %r)" % (dtype,))


def _rb(t, bf16):
    """``t`` rounded to the nearest bf16 (ties to even, as the MXU
    rounds an operand) and kept f32, when ``bf16``"""
    return t.to(torch.bfloat16).to(torch.float32) if bf16 else t


def _mm(a, b, bf16=False):
    """one product of a plain pass; under ``bf16`` both operands (data
    and table) are rounded to bf16 first, and since the product of two
    bf16 values is exact in f32, only the order of the f32 sum differs
    from the MXU's single pass"""
    return torch.matmul(_rb(a, bf16), _rb(b, bf16))


# --- plain PyTorch versions of the seven passes ------------------------------
#
# Each rounds, under ``bf16``, exactly where the JAX kernel's products
# round: a product's operands after the butterfly sum, the 1/k^2 fold or a
# negation formed in f32 before it; everything after a product (its scale,
# an inverse butterfly, the z-CT combination, the plane) stays f32 until
# the next product rounds it as its operand.  ``out_dtype`` is the storage
# of a ct2 pass's spectrum output (bf16: rounded once, at the end).

def _t(a, like):
    return torch.as_tensor(np.asarray(a), dtype=torch.float32,
                           device=like.device)


def _signs(n, like):
    """(-1)^j for j < n, f32 on ``like``'s device."""
    return _t(np.where(np.arange(n) % 2 == 0, 1.0, -1.0), like)


def _cmadd(acc, xr, xi, c):
    """acc (r, i) += c * (xr + i xi) for a numpy complex constant c,
    skipping the zero terms as the JAX package does."""
    ar, ai = acc
    cr, ci = float(np.real(c)), float(np.imag(c))

    def term(coef, a, b):
        if a is None or abs(coef) < 1e-30:
            return b
        t = a if abs(coef - 1) < 1e-12 else (
            -a if abs(coef + 1) < 1e-12 else a * coef)
        return t if b is None else b + t

    ar = term(cr, xr, ar)
    ar = term(-ci, xi, ar)
    ai = term(ci, xr, ai)
    ai = term(cr, xi, ai)
    return ar, ai


def _ct_fwd_plain(xr, xi, wr, wi, bf16=False):
    """CT transform along axis -2 of (..., n, C): xi may be None (real
    input); wr/wi are (R, M, M) tensors.  Chunk-permuted output."""
    R, M = wr.shape[0], wr.shape[1]
    B = _butter(R, -1)
    xs_r = [xr[..., r * M:(r + 1) * M, :] for r in range(R)]
    xs_i = [None if xi is None else xi[..., r * M:(r + 1) * M, :]
            for r in range(R)]
    outs_r, outs_i = [], []
    for j in range(R):
        acc = (None, None)
        for r in range(R):
            acc = _cmadd(acc, xs_r[r], xs_i[r], B[r, j])
        ur, ui = acc
        if ui is None:
            outs_r.append(_mm(wr[j], ur, bf16))
            outs_i.append(_mm(wi[j], ur, bf16))
        else:
            outs_r.append(_mm(wr[j], ur, bf16) - _mm(wi[j], ui, bf16))
            outs_i.append(_mm(wr[j], ui, bf16) + _mm(wi[j], ur, bf16))
    return torch.cat(outs_r, -2), torch.cat(outs_i, -2)


def _ct_inv_plain(xr, xi, wr, wi, bf16=False):
    """inverse CT along axis -2 of chunk-permuted (..., n, C); natural
    order out."""
    R, M = wr.shape[0], wr.shape[1]
    B = _butter(R, +1)
    ys = []
    for j in range(R):
        pr = xr[..., j * M:(j + 1) * M, :]
        pi = xi[..., j * M:(j + 1) * M, :]
        ys.append((_mm(wr[j], pr, bf16) - _mm(wi[j], pi, bf16),
                   _mm(wr[j], pi, bf16) + _mm(wi[j], pr, bf16)))
    outs_r, outs_i = [], []
    for r in range(R):
        acc = (None, None)
        for j in range(R):
            acc = _cmadd(acc, ys[j][0], ys[j][1], B[r, j])
        outs_r.append(acc[0])
        outs_i.append(acc[1])
    return torch.cat(outs_r, -2), torch.cat(outs_i, -2)


def _zct_fwd_plain(p, Er, Ei, N2, bf16=False):
    """forward z-CT of real rows p (..., N2) -> stored-order (zr, zi)
    (..., Zm); Er/Ei are (Rz, K, Mq) tensors."""
    Rz, K, Mq = _zct_factor(N2)
    xs = [p[..., r * K:(r + 1) * K] for r in range(Rz)]
    Bt = _butter(Rz, -1)
    us = {}
    for j in range(Rz // 2 + 1):
        acc = (None, None)
        for r in range(Rz):
            acc = _cmadd(acc, xs[r], None, Bt[r, j])
        us[j] = acc
    outs_r, outs_i = [], []
    for pblk, j in enumerate(_zct_order(Rz)):
        if j <= Rz // 2:
            ur, ui = us[j]
        else:
            ur, ui = us[Rz - j]
            ui = None if ui is None else -ui
        if ui is None:
            outs_r.append(_mm(ur, Er[pblk], bf16))
            outs_i.append(_mm(ur, Ei[pblk], bf16))
        else:
            outs_r.append(_mm(ur, Er[pblk], bf16) - _mm(ui, Ei[pblk], bf16))
            outs_i.append(_mm(ur, Ei[pblk], bf16) + _mm(ui, Er[pblk], bf16))
    return torch.cat(outs_r, -1), torch.cat(outs_i, -1)


def _zct_inv_plain(yr, yi, A, B, bf16=False):
    """inverse z-CT of stored-order (yr, yi) (..., Zm) -> real (..., n2);
    A/B are (Ri, Kin, Kb) tensors."""
    Ri, Kin = A.shape[0], A.shape[1]
    cs = _butter(Ri, +1)
    Ps, Qs = [], []
    for j in range(Ri):
        xr = yr[..., j * Kin:(j + 1) * Kin]
        xi = yi[..., j * Kin:(j + 1) * Kin]
        Ps.append(_mm(xr, A[j], bf16) + _mm(xi, B[j], bf16))
        Qs.append(_mm(xi, A[j], bf16) - _mm(xr, B[j], bf16))

    def addto(acc, coef, x):
        if abs(coef) < 1e-30:
            return acc
        t = x if abs(coef - 1) < 1e-12 else (
            -x if abs(coef + 1) < 1e-12 else coef * x)
        return t if acc is None else acc + t

    blocks = []
    for c in range(Ri):
        acc = None
        for j in range(Ri):
            acc = addto(acc, float(np.real(cs[j, c])), Ps[j])
            acc = addto(acc, -float(np.imag(cs[j, c])), Qs[j])
        blocks.append(acc)
    return torch.cat(blocks, -1)


def _z_inv_plain(yr, yi, A, B, bf16=False):
    if A.dim() == 3:
        return _zct_inv_plain(yr, yi, A, B, bf16)
    return _mm(yr, A, bf16) + _mm(yi, B, bf16)


def zy_fwd_ct2_plain(x, wz, wy, bf16=False, out_dtype=torch.float32):
    """Row 6, plain: real (n0, N1, N2) -> (r, i) (n0, N1, Zm) in stored
    order, stored as ``out_dtype``, and the raw f32 Nyquist row sum nq
    (n0, N1) = sum_n x (-1)^n.  wz: the (2-d dense or 3-d z-CT) pair of
    ``_z_fwd_tabs``; wy: the pair of ``_ct_fwd_mats_np(N1)``."""
    N2 = x.shape[2]
    p = x.to(torch.float32)
    nq = (p * _signs(N2, p)).sum(-1)
    wzr, wzi = (_t(a, p) for a in wz)
    if wzr.dim() == 3:
        zr, zi = _zct_fwd_plain(p, wzr, wzi, N2, bf16)
    else:
        zr, zi = _mm(p, wzr, bf16), _mm(p, wzi, bf16)
    yr, yi = _ct_fwd_plain(zr, zi, *(_t(a, p) for a in wy), bf16=bf16)
    return yr.to(out_dtype), yi.to(out_dtype), nq


def xct_multi_plain(pr, pi, wx, scale, inverse=False, wx2=None, k2=None,
                    bf16=False, out_dtype=torch.float32):
    """Row 5, plain: the x CT of an (N0, n1, W) complex block, forward
    (times ``scale``) or inverse, with an optional second table set
    ``wx2`` on the same input and an optional 1/k^2 fold from the 1-d
    tables ``k2`` = (k2x (N0,), k2y (n1,), k2z (W,)), DC set to 0.
    Returns (r, i) or (r, i, r2, i2), stored as ``out_dtype``."""
    f = _ct_inv_plain if inverse else _ct_fwd_plain
    return _x_pass_plain(pr, pi, wx, scale, wx2, k2, f, bf16, out_dtype)


def _x_pass_plain(pr, pi, wx, scale, wx2, k2, transform, bf16=False,
                  out_dtype=torch.float32):
    """what the x passes share: the input upcast to f32, the optional
    1/k^2 fold (DC set to 0), then ``transform`` along x for one or two
    table sets, times ``scale``, stored as ``out_dtype``.  Returns (r, i)
    or (r, i, r2, i2)."""
    N0, n1, W = pr.shape
    xr, xi = pr.to(torch.float32), pi.to(torch.float32)
    if k2 is not None:
        kk = (_t(k2[0], xr).reshape(N0, 1, 1) + _t(k2[1], xr).reshape(1, n1, 1)
              + _t(k2[2], xr).reshape(1, 1, W))
        invk2 = torch.where(kk > 0.0,
                            1.0 / torch.where(kk > 0.0, kk, 1.0), 0.0)
        xr, xi = xr * invk2, xi * invk2
    xr, xi = xr.reshape(N0, n1 * W), xi.reshape(N0, n1 * W)
    out = []
    for w in (wx,) if wx2 is None else (wx, wx2):
        wr, wi = (_t(a, xr) for a in w)
        rr, ii = transform(xr, xi, wr, wi, bf16)
        out += [(rr * scale).reshape(N0, n1, W).to(out_dtype),
                (ii * scale).reshape(N0, n1, W).to(out_dtype)]
    return tuple(out)


def _dense_plain(xr, xi, wr, wi, bf16=False):
    """dense complex DFT along axis -2: (wr + i wi) @ (xr + i xi)."""
    return (_mm(wr, xr, bf16) - _mm(wi, xi, bf16),
            _mm(wr, xi, bf16) + _mm(wi, xr, bf16))


def zy_fwd_half_plain(x, wz, wy, bf16=False):
    """Row 3 pass 1, plain: real (n0, N1, N2) -> (r, i) (n0, N1, Zh),
    natural order: the z half-DFT pair ``wz`` = ``_dft_half_np(N2,
    Zh)``, then the dense y DFT pair ``wy`` = ``_dft_np(N1, -1)``."""
    p = x.to(torch.float32)
    wzr, wzi = (_t(a, p) for a in wz)
    return _dense_plain(_mm(p, wzr, bf16), _mm(p, wzi, bf16),
                        *(_t(a, p) for a in wy), bf16=bf16)


def x_dense_plain(pr, pi, wx, scale, wx2=None, k2=None, bf16=False):
    """Rows 3 and 4 x pass, plain: the dense x DFT of an (N0, n1, W)
    complex block by the (N0, N0) pair ``wx`` (forward or inverse, by
    the table) times ``scale``, with an optional second pair ``wx2`` on
    the same input and an optional 1/k^2 fold from the natural-order
    1-d tables ``k2`` = (k2x (N0,), k2y (n1,), k2z (W,)), DC set to 0.
    Returns (r, i) or (r, i, r2, i2)."""
    return _x_pass_plain(pr, pi, wx, scale, wx2, k2, _dense_plain, bf16)


def zy_inv_half_plain(rr, ii, wy, AB, bf16=False):
    """Row 4 zy pass, plain: (n0, N1, Zh) natural-order spectrum ->
    real (n0, N1, n2): the dense inverse y DFT pair ``wy`` (plain or
    with i*k_y folded), then z half -> real by the (Zh, n2) pair ``AB``
    of ``_irfft_mats_np`` (plain or with i*k_z folded)."""
    xr, xi = rr.to(torch.float32), ii.to(torch.float32)
    yr, yi = _dense_plain(xr, xi, *(_t(a, xr) for a in wy), bf16=bf16)
    A, B = (_t(a, xr) for a in AB)
    return _mm(yr, A, bf16) + _mm(yi, B, bf16)


def _zy_inv_one(xr, xi, Wy, AB, n2, plane, bf16):
    yr, yi = _ct_inv_plain(xr, xi, *(_t(a, xr) for a in Wy), bf16=bf16)
    out = _z_inv_plain(yr, yi, *(_t(a, xr) for a in AB), bf16=bf16)
    if plane is not None:
        out = out + plane.to(torch.float32)[:, :, None] * _signs(n2, out)
    return out


def zy_inv_ct2_plain(rr, ii, Wy, AB, n2, plane=None, bf16=False):
    """Row 7, plain: (n0, N1, Zm) stored-order spectrum (f32 or bf16)
    -> real f32 (n0, N1, n2): the inverse y CT (``_ct_inv_mats_np`` pair
    ``Wy``), then the z inverse (dense (Zm, n2) or z-CT (Ri, Kin, Kb)
    pair ``AB``, by ndim), plus ``plane`` (n0, N1) times (-1)^n if
    given."""
    return _zy_inv_one(rr.to(torch.float32), ii.to(torch.float32), Wy, AB,
                       n2, plane, bf16)


def zy_inv_ct2_dual_plain(rr, ii, WyA, ABA, WyB, ABB, n2, planeA=None,
                          bf16=False):
    """Row 8, plain: two table sets on one input; the plane goes to set
    A only.  Returns (outA, outB)."""
    xr, xi = rr.to(torch.float32), ii.to(torch.float32)
    return (_zy_inv_one(xr, xi, WyA, ABA, n2, planeA, bf16),
            _zy_inv_one(xr, xi, WyB, ABB, n2, None, bf16))


# --- dispatch -----------------------------------------------------------------
#
# ``precision`` (None/'f32' or 'bf16') selects the products, ``out_dtype``
# (f32 or bf16) the storage of a ct2 pass's spectrum output; the zy
# inverses read the storage their input has and write f32 meshes.

def _use_cuda(impl, t):
    if impl is None:
        return t.is_cuda
    if impl == 'cuda':
        if not t.is_cuda:
            raise ValueError("impl='cuda' needs CUDA tensors (got %s)"
                             % t.device)
        return True
    if impl == 'torch':
        return False
    raise ValueError("impl must be None, 'torch' or 'cuda' (got %r)"
                     % (impl,))


def _f32_pass(*tensors):
    """the tensors a kernel pass reads, an f64 one cast to f32: the JAX
    package casts an f64 input to f32 at its passes
    (``pmesh_tpu/ops/fft_mxu.py:1112``) and the plain versions compute in
    f32, so the kernels, which take f32 and bf16, return what both return
    (None passes through)"""
    return tuple(t.to(torch.float32) if isinstance(t, torch.Tensor)
                 and t.dtype == torch.float64 else t for t in tensors)


def _zy_fwd_ct2_call(x, N2, Zm, wz, wy, precision=None,
                     out_dtype=torch.float32, impl=None):
    """pass 1 (row 6) on an (n0, N1, N2) block -> (r, i, nq)."""
    bf16, sdt = _bf16_products(precision), _storage(out_dtype)
    if x.shape[2] != N2 or Zm != N2 // 2:
        raise ValueError("_zy_fwd_ct2_call: N2=%d, Zm=%d do not fit %s"
                         % (N2, Zm, tuple(x.shape)))
    if _use_cuda(impl, x):
        from . import fft_mxu_cuda as _k
        x, = _f32_pass(x)
        return _k.zy_fwd_ct2(x, wz, wy, bf16=bf16, out_dtype=sdt)
    return zy_fwd_ct2_plain(x, wz, wy, bf16, sdt)


def _xct_call_multi(pr, pi, wx, scale, inverse=False, wx2=None, k2=None,
                    precision=None, out_dtype=torch.float32, impl=None):
    """pass 2 (row 5): the x CT of an (N0, n1, W) block; returns (r, i)
    or (r, i, r2, i2).  The kernel stores its output as its input is
    stored (JAX's callers pass the input's dtype as ``out_dtype``)."""
    bf16, sdt = _bf16_products(precision), _storage(out_dtype)
    if _use_cuda(impl, pr):
        pr, pi = _f32_pass(pr, pi)
        if sdt != pr.dtype:
            raise NotImplementedError(
                "xct_multi: the CUDA kernel stores its output as its input "
                "is stored (input %s, out_dtype %s)" % (pr.dtype, sdt))
        from . import fft_mxu_cuda as _k
        return _k.xct_multi(pr, pi, wx, scale, inverse=inverse, wx2=wx2,
                            k2=k2, bf16=bf16)
    return xct_multi_plain(pr, pi, wx, scale, inverse=inverse, wx2=wx2,
                           k2=k2, bf16=bf16, out_dtype=sdt)


def _zy_inv_ct2_call(rr, ii, Wy, AB, n2, plane=None, precision=None,
                     impl=None):
    """inverse pass (row 7) on an (n0, N1, Zm) block -> (n0, N1, n2)."""
    bf16 = _bf16_products(precision)
    if _use_cuda(impl, rr):
        from . import fft_mxu_cuda as _k
        rr, ii, plane = _f32_pass(rr, ii, plane)
        return _k.zy_inv_ct2(rr, ii, Wy, AB, n2, plane=plane, bf16=bf16)
    return zy_inv_ct2_plain(rr, ii, Wy, AB, n2, plane=plane, bf16=bf16)


def _zy_inv_ct2_call_dual(rr, ii, WyA, ABA, WyB, ABB, n2, planeA=None,
                          precision=None, impl=None):
    """dual inverse pass (row 8): (outA, outB) from one (rr, ii) read."""
    bf16 = _bf16_products(precision)
    if _use_cuda(impl, rr):
        from . import fft_mxu_cuda as _k
        rr, ii, planeA = _f32_pass(rr, ii, planeA)
        return _k.zy_inv_ct2_dual(rr, ii, WyA, ABA, WyB, ABB, n2,
                                  planeA=planeA, bf16=bf16)
    return zy_inv_ct2_dual_plain(rr, ii, WyA, ABA, WyB, ABB, n2,
                                 planeA=planeA, bf16=bf16)


def _zy_fwd_dense_call(x, wz, wy, precision=None, impl=None):
    """row 3 pass 1 on an (n0, N1, N2) block -> (r, i) (n0, N1, Zh)."""
    bf16 = _bf16_products(precision)
    if _use_cuda(impl, x):
        from . import fft_mxu_cuda as _k
        x, = _f32_pass(x)
        return _k.zy_fwd_half(x, wz, wy, bf16=bf16)
    return zy_fwd_half_plain(x, wz, wy, bf16)


def _x_dense_call(pr, pi, wx, scale, wx2=None, k2=None, precision=None,
                  impl=None):
    """the dense x pass (rows 3 and 4) of an (N0, n1, W) block; returns
    (r, i) or (r, i, r2, i2)."""
    bf16 = _bf16_products(precision)
    if _use_cuda(impl, pr):
        from . import fft_mxu_cuda as _k
        pr, pi = _f32_pass(pr, pi)
        return _k.x_dense(pr, pi, wx, scale, wx2=wx2, k2=k2, bf16=bf16)
    return x_dense_plain(pr, pi, wx, scale, wx2=wx2, k2=k2, bf16=bf16)


def _zy_inv_dense_call(rr, ii, wy, AB, precision=None, impl=None):
    """row 4 zy pass on an (n0, N1, Zh) block -> (n0, N1, n2)."""
    bf16 = _bf16_products(precision)
    if _use_cuda(impl, rr):
        from . import fft_mxu_cuda as _k
        rr, ii = _f32_pass(rr, ii)
        return _k.zy_inv_half(rr, ii, wy, AB, bf16=bf16)
    return zy_inv_half_plain(rr, ii, wy, AB, bf16)


def _plane_fft2(nq_r, nq_i, N0, N1, sign, scale=1.0, bf16=False):
    """2-d complex DFT of the (N0, N1) Nyquist plane with plain matmuls
    (symmetric DFT matrices: left-multiply transforms x, right-multiply
    y).  nq_i may be None (real input).  Natural order.  Under ``bf16``
    the operands are rounded as XLA's DEFAULT-precision dot rounds them
    on the TPU."""
    dev = nq_r.device
    wxr, wxi = (_on_device(a, dev) for a in _cached(_dft_np, N0, sign))
    wyr, wyi = (_on_device(a, dev) for a in _cached(_dft_np, N1, sign))
    if nq_i is None:
        ar = _mm(wxr, nq_r, bf16)
        ai = _mm(wxi, nq_r, bf16)
    else:
        ar = _mm(wxr, nq_r, bf16) - _mm(wxi, nq_i, bf16)
        ai = _mm(wxr, nq_i, bf16) + _mm(wxi, nq_r, bf16)
    sr = _mm(ar, wyr, bf16) - _mm(ai, wyi, bf16)
    si = _mm(ar, wyi, bf16) + _mm(ai, wyr, bf16)
    return sr * scale, si * scale


# --- the public ct2 operators -------------------------------------------------

def fft3_real_forward_half_ct2(x, norm=True, precision=None,
                               spectrum_dtype=None, impl=None):
    """split-Nyquist CT forward of a real f32 (N0, N1, N2) mesh: returns
    (r, i, nqr, nqi), the main (N0, N1, N2//2) spectrum with
    chunk-permuted x/y axes (and z in ``_zct_perm`` order when
    ``_use_zct_fwd``), and the z-Nyquist plane spectrum (N0, N1) in
    natural x/y order; scaled by 1/(N0 N1 N2) when ``norm``.

    precision : None/'f32' (f32 products) or 'bf16' (single-pass bf16
        products, f32 sums).
    spectrum_dtype : None (f32) or torch.bfloat16: the storage of (r, i)
        and of the spectrum between the two passes; the products stay
        as ``precision`` says and the Nyquist plane stays f32."""
    N0, N1, N2 = x.shape
    Zm = N2 // 2
    if not is_ct2(x.shape):
        raise ValueError("ct2 needs N0/N1 = R*128k and even N2 (got %s)"
                         % (tuple(x.shape),))
    bf16, sdt = _bf16_products(precision), _storage(spectrum_dtype)
    wz = _cached(_z_fwd_tabs, N2, Zm)
    wy = _cached(_ct_fwd_mats_np, N1)
    wx = _cached(_ct_fwd_mats_np, N0)
    pr, pi, nq = _zy_fwd_ct2_call(x, N2, Zm, wz, wy, precision=precision,
                                  out_dtype=sdt, impl=impl)
    scale = 1.0 / (N0 * N1 * N2) if norm else 1.0
    rr, ii = _xct_call_multi(pr, pi, wx, scale, precision=precision,
                             out_dtype=sdt, impl=impl)
    del pr, pi
    nqr, nqi = _plane_fft2(nq, None, N0, N1, -1, np.float32(scale), bf16)
    return rr, ii, nqr, nqi


def _check_kvecs(kvecs, N0, N1):
    for d, n in ((0, N0), (1, N1)):
        if n % 2 == 0 and abs(kvecs[d][n // 2]) > 1e-12:
            raise ValueError(
                "kvecs[%d] must vanish at the Nyquist index for the "
                "half-spectrum gradient" % d)


def _spectrum_storage(r):
    """the storage of a ct2 inverse's x-pass outputs: that of its input
    spectrum (bf16 stays bf16, as JAX keeps a bf16 input's
    intermediates in bf16)"""
    return torch.bfloat16 if r.dtype == torch.bfloat16 else torch.float32


def fft3_real_inverse_grad3_half_ct2(r, i, nqr, nqi, n2, kvecs,
                                     precision=None, poisson_k2=None,
                                     only=None, impl=None):
    """split-Nyquist CT spectral force triple: the unnormalized inverses
    of i*k_d times the spectrum, d = 0, 1, 2.  The z gradient's Nyquist
    contribution vanishes (kvecs[2] is Nyquist-zero), so only fx and fy
    carry the plane.

    kvecs : three natural-order tuples (len N0, N1, >= Zm), the x and y
        ones zero at Nyquist.
    precision : None/'f32' or 'bf16' (single-pass bf16 products).
    poisson_k2 : None or three natural-order k^2 tuples (len N0, N1,
        Zm+1); then (r, i, nqr, nqi) are the raw forward spectrum and
        1/k^2 (DC zeroed) folds into the x pass.
    only : None or 0/1/2: just that direction (one x pass and one zy
        inverse), for the transpose of the force operator.

    A bf16 (r, i) (``spectrum_dtype=torch.bfloat16`` of the forward)
    keeps the x-pass outputs in bf16; the force meshes are f32."""
    N0, N1, Zm = r.shape
    _check_kvecs(kvecs, N0, N1)
    bf16, sdt = _bf16_products(precision), _spectrum_storage(r)
    kvecs = _tuples(kvecs)
    wy = _cached(_ct_inv_mats_np, N1)
    wx = _cached(_ct_inv_mats_np, N0)
    wx_g = _cached(_ct_inv_mats_np, N0, kvecs[0])
    wy_g = _cached(_ct_inv_mats_np, N1, kvecs[1])
    AB_p = _cached(_z_inv_tabs, n2, Zm)
    AB_g = _cached(_z_inv_tabs, n2, Zm, kvecs[2])

    kx = _on_device(_cached(_f32, kvecs[0]), r.device)
    ky = _on_device(_cached(_f32, kvecs[1]), r.device)
    k2m = None
    if poisson_k2 is not None:
        invk2p, k2m = _cached(_poisson_tables, _tuples(poisson_k2), N0, N1,
                              Zm)
        invk2p = _on_device(invk2p, r.device)
        nqr = nqr * invk2p
        nqi = nqi * invk2p
    plane_x = plane_y = None
    if only in (None, 0):
        plane_x = _plane_fft2(-nqi * kx[:, None], nqr * kx[:, None], N0, N1,
                              +1, bf16=bf16)[0]
    if only in (None, 1):
        plane_y = _plane_fft2(-nqi * ky[None, :], nqr * ky[None, :], N0, N1,
                              +1, bf16=bf16)[0]
    kw = dict(precision=precision, impl=impl)
    xkw = dict(inverse=True, k2=k2m, out_dtype=sdt, **kw)

    if only == 0:
        gr, gi = _xct_call_multi(r, i, wx_g, 1.0, **xkw)
        return _zy_inv_ct2_call(gr, gi, wy, AB_p, n2, plane=plane_x, **kw)
    if only in (1, 2):
        sr, si = _xct_call_multi(r, i, wx, 1.0, **xkw)
        if only == 1:
            return _zy_inv_ct2_call(sr, si, wy_g, AB_p, n2, plane=plane_y,
                                    **kw)
        return _zy_inv_ct2_call(sr, si, wy, AB_g, n2, **kw)
    if only is not None:
        raise ValueError("only must be None, 0, 1 or 2")
    sr, si, gr, gi = _xct_call_multi(r, i, wx, 1.0, wx2=wx_g, **xkw)
    # fy and fz share the (sr, si) read: one dual pass
    fy, fz = _zy_inv_ct2_call_dual(sr, si, wy_g, AB_p, wy, AB_g, n2,
                                   planeA=plane_y, **kw)
    del sr, si
    fx = _zy_inv_ct2_call(gr, gi, wy, AB_p, n2, plane=plane_x, **kw)
    return fx, fy, fz


def _tuples(tables):
    return tuple(tuple(float(v) for v in t) for t in tables)


def fft3_poisson_half_ct2(r, i, nqr, nqi, n2, poisson_k2, precision=None,
                          impl=None):
    """split-Nyquist CT Poisson potential phi = -IFFT(spec / k^2) (the
    tf.poisson sign) with the DC mode zeroed: one x pass (1/k^2 folded
    from the 1-d tables) and one zy inverse.  The -1 folds into the z
    tables and the Nyquist plane.  ``precision`` and a bf16 (r, i) as in
    :func:`fft3_real_inverse_grad3_half_ct2`."""
    N0, N1, Zm = r.shape
    bf16 = _bf16_products(precision)
    wy = _cached(_ct_inv_mats_np, N1)
    wx = _cached(_ct_inv_mats_np, N0)
    AB_p = _cached(_z_inv_tabs, n2, Zm, None, True)
    invk2p, k2m = _cached(_poisson_tables, _tuples(poisson_k2), N0, N1, Zm)
    invk2p = _on_device(invk2p, r.device)
    plane = -_plane_fft2(nqr * invk2p, nqi * invk2p, N0, N1, +1,
                         bf16=bf16)[0]
    sr, si = _xct_call_multi(r, i, wx, 1.0, inverse=True, k2=k2m,
                             precision=precision,
                             out_dtype=_spectrum_storage(r), impl=impl)
    return _zy_inv_ct2_call(sr, si, wy, AB_p, n2, plane=plane,
                            precision=precision, impl=impl)


# --- the dense public operators (rows 3 and 4) -------------------------------

def fft3_real_forward_half(x, norm=True, precision=None, impl=None):
    """hermitian-half forward FFT of a real f32 (N0, N1, N2) mesh at any
    shape: returns (r, i) of shape (N0, N1, N2 // 2 + 1) in natural
    order, scaled by 1/(N0 N1 N2) when ``norm``; ``precision`` None/'f32'
    or 'bf16' (single-pass bf16 products)."""
    N0, N1, N2 = x.shape
    Zh = N2 // 2 + 1
    wz = _cached(_dft_half_np, N2, Zh)
    wy = _cached(_dft_np, N1, -1)
    wx = _cached(_dft_np, N0, -1)
    pr, pi = _zy_fwd_dense_call(x, wz, wy, precision=precision, impl=impl)
    scale = 1.0 / (N0 * N1 * N2) if norm else 1.0
    return _x_dense_call(pr, pi, wx, scale, precision=precision, impl=impl)


def _dense_k2_tables(poisson_k2, N0, N1, Zh):
    """the natural-order f32 1-d k^2 tables folded into the inverse x
    pass, checked against the spectrum's shape."""
    k2 = tuple(np.asarray(t, np.float32) for t in poisson_k2)
    if tuple(len(t) for t in k2) != (N0, N1, Zh):
        raise ValueError("poisson_k2 tables of lengths %s do not fit the "
                         "(%d, %d, %d) half spectrum"
                         % (tuple(len(t) for t in k2), N0, N1, Zh))
    return k2


def fft3_real_inverse_grad3_half(r, i, n2, kvecs, precision=None,
                                 poisson_k2=None, impl=None):
    """the spectral force triple from a natural-order HALF spectrum
    (r, i) of shape (N0, N1, Zh): the unnormalized inverses of i*k_d
    times the spectrum, d = 0, 1, 2.  The y and z gradients fold into
    the zy-pass tables and share one x pass; the x gradient folds into
    the second table set of that pass.

    kvecs : three natural-order tables (len N0, N1, Zh); kvecs[0] and
        kvecs[1] must vanish at the Nyquist index of an even axis (a
        nonzero odd multiplier there breaks the hermitian symmetry the
        half-spectrum doubling relies on).
    precision : None/'f32' or 'bf16' (single-pass bf16 products).
    poisson_k2 : None, or three natural-order k^2 tables (len N0, N1,
        Zh): then 1/k^2 (DC zeroed) folds into the x pass, and (r, i)
        is the raw forward spectrum.  The default None keeps the JAX
        package's signature and meaning (the caller filters the
        spectrum first); the solver passes the tables, which saves the
        elementwise filter pass over the spectrum.  The fold multiplies
        in f32 before the x product rounds its operand, as the JAX
        solver's elementwise filter does."""
    N0, N1, Zh = r.shape
    _check_kvecs(kvecs, N0, N1)
    if len(kvecs[2]) != Zh:
        raise ValueError("kvecs[2] must have length Zh=%d" % Zh)
    if n2 // 2 + 1 != Zh:
        raise ValueError("n2=%d does not give the %d half-spectrum columns"
                         % (n2, Zh))
    kvecs = _tuples(kvecs)
    wy = _cached(_dft_np, N1, +1)
    wx = _cached(_dft_np, N0, +1)
    wx_g = _cached(_dft_fold_np, N0, kvecs[0])
    wy_g = _cached(_dft_fold_np, N1, kvecs[1])
    AB_p = _cached(_irfft_mats_np, n2, Zh)
    AB_g = _cached(_irfft_mats_np, n2, Zh, kvecs[2])
    k2 = None
    if poisson_k2 is not None:
        k2 = _cached(_dense_k2_tables, _tuples(poisson_k2), N0, N1, Zh)
    kw = dict(precision=precision, impl=impl)
    # both inverse x passes from one read of (r, i)
    sr, si, gr, gi = _x_dense_call(r, i, wx, 1.0, wx2=wx_g, k2=k2, **kw)
    fy = _zy_inv_dense_call(sr, si, wy_g, AB_p, **kw)
    fz = _zy_inv_dense_call(sr, si, wy, AB_g, **kw)
    del sr, si
    fx = _zy_inv_dense_call(gr, gi, wy, AB_p, **kw)
    return fx, fy, fz


# --- the slab-sharded pipelines -------------------------------------------
#
# The counterparts of the JAX package's ``*_sharded`` entry points
# (``pmesh_tpu/ops/fft_mxu.py:1341-1720``) on the rank-local slabs of
# ``parallel/pmesh.py``: a real mesh is this rank's x slab (N0/P, N1, N2),
# a spectrum its y-chunk (N0, N1/P, W) of the transposed layout, whole x.
# The zy passes run per slab, one all_to_all (``parallel/comm.py``) moves
# the spectrum between the layouts, and the x pass runs on the y-chunk:
# the same kernels as on one device, at the slab shapes.  At ct2 shapes
# the all_to_all splits the chunk-permuted y axis, so the 1/k^2 fold takes
# the rank's chunk of the permuted y table; the z-Nyquist plane is
# all-gathered and transformed replicated in the forward, and sliced per
# slab in the inverse.  The dense x pass folds 1/k^2 from the rank's chunk
# of the natural-order y table (the JAX package's sharded dense path
# applies 1/k^2 elementwise on the transposed spectrum before the
# inverse; the fold is the same product).

def _a2a_fwd(pm, t):
    """slab (n0, N1, W) -> y-chunk (N0, n1, W)"""
    from ..parallel.comm import all_to_all
    return all_to_all(t, pm, split_axis=1, concat_axis=0)


def _a2a_back(pm, t):
    """y-chunk (N0, n1, W) -> slab (n0, N1, W)"""
    from ..parallel.comm import all_to_all
    return all_to_all(t, pm, split_axis=0, concat_axis=1)


def _check_sharded(pm, N0, N1, what):
    if N0 % pm.size or N1 % pm.size:
        raise ValueError("%s needs Nmesh[0] and Nmesh[1] divisible by the "
                         "rank count (%d; got %d, %d)"
                         % (what, pm.size, N0, N1))


def _chunk(table, rank, size):
    """rank's block of a 1-d table, as a new f32 numpy array (cached by
    the callers, so each block is uploaded to the device once)"""
    t = np.asarray(table, np.float32)
    n = len(t) // size
    return np.ascontiguousarray(t[rank * n:(rank + 1) * n])


def _sharded_ct2_k2(poisson_k2, N0, N1, Zm, rank, size):
    """the ct2 inverse's 1/k^2 tables on a y-chunk: the plane filter and
    (k2x, this rank's chunk of the permuted k2y, k2z)"""
    invk2p, k2m = _cached(_poisson_tables, poisson_k2, N0, N1, Zm)
    return invk2p, (k2m[0], _chunk(k2m[1], rank, size), k2m[2])


def _slab_rows(plane, pm):
    """this rank's rows of a replicated (N0, N1) plane"""
    n0 = plane.shape[0] // pm.size
    return plane[pm.rank * n0:(pm.rank + 1) * n0].contiguous()


def fft3_real_forward_half_ct2_sharded(pm, x, norm=True, precision=None,
                                       spectrum_dtype=None, impl=None):
    """slab-sharded ct2 forward: pass 1 (z half + y CT) on this rank's
    slab x (N0/P, N1, N2), one all_to_all splitting the permuted y axis,
    the x CT on the y-chunk.  Returns (r, i) (N0, N1/P, Zm), chunk
    permuted as :func:`fft3_real_forward_half_ct2`'s, and the z-Nyquist
    plane spectrum (nqr, nqi) (N0, N1), replicated on every rank.  A
    bf16 ``spectrum_dtype`` also halves the all_to_all's bytes."""
    n0, N1, N2 = x.shape
    N0 = n0 * pm.size
    Zm = N2 // 2
    if not is_ct2((N0, N1, N2)):
        raise ValueError("ct2 needs N0/N1 = R*128k and even N2 (got %s)"
                         % ((N0, N1, N2),))
    _check_sharded(pm, N0, N1, "fft3_real_forward_half_ct2_sharded")
    from ..parallel.comm import all_gather
    bf16, sdt = _bf16_products(precision), _storage(spectrum_dtype)
    wz = _cached(_z_fwd_tabs, N2, Zm)
    wy = _cached(_ct_fwd_mats_np, N1)
    wx = _cached(_ct_fwd_mats_np, N0)
    pr, pi, nq = _zy_fwd_ct2_call(x, N2, Zm, wz, wy, precision=precision,
                                  out_dtype=sdt, impl=impl)
    pr, pi = _a2a_fwd(pm, pr), _a2a_fwd(pm, pi)
    scale = 1.0 / (N0 * N1 * N2) if norm else 1.0
    rr, ii = _xct_call_multi(pr, pi, wx, scale, precision=precision,
                             out_dtype=sdt, impl=impl)
    del pr, pi
    nq = all_gather(nq, pm, axis=0)
    nqr, nqi = _plane_fft2(nq, None, N0, N1, -1, np.float32(scale), bf16)
    return rr, ii, nqr, nqi


def fft3_real_inverse_grad3_half_ct2_sharded(pm, r, i, nqr, nqi, n2, kvecs,
                                             precision=None,
                                             poisson_k2=None, only=None,
                                             impl=None):
    """slab-sharded ct2 force triple (see
    :func:`fft3_real_inverse_grad3_half_ct2`): the x CT inverses on this
    rank's y-chunk (r, i) (N0, N1/P, Zm) (the plain and k_x-folded sets
    in one dual pass), all_to_all back, the ct2 zy inverses on the slab
    with the replicated Nyquist planes sliced to its rows.  Returns the
    force slabs (N0/P, N1, n2); ``only`` = d one direction."""
    N0, n1, Zm = r.shape
    N1 = n1 * pm.size
    _check_sharded(pm, N0, N1, "fft3_real_inverse_grad3_half_ct2_sharded")
    _check_kvecs(kvecs, N0, N1)
    bf16, sdt = _bf16_products(precision), _spectrum_storage(r)
    kvecs = _tuples(kvecs)
    wy = _cached(_ct_inv_mats_np, N1)
    wx = _cached(_ct_inv_mats_np, N0)
    wx_g = _cached(_ct_inv_mats_np, N0, kvecs[0])
    wy_g = _cached(_ct_inv_mats_np, N1, kvecs[1])
    AB_p = _cached(_z_inv_tabs, n2, Zm)
    AB_g = _cached(_z_inv_tabs, n2, Zm, kvecs[2])
    kx = _on_device(_cached(_f32, kvecs[0]), r.device)
    ky = _on_device(_cached(_f32, kvecs[1]), r.device)
    k2l = None
    if poisson_k2 is not None:
        invk2p, k2l = _cached(_sharded_ct2_k2, _tuples(poisson_k2), N0, N1,
                              Zm, pm.rank, pm.size)
        invk2p = _on_device(invk2p, r.device)
        nqr = nqr * invk2p
        nqi = nqi * invk2p
    plane_x = plane_y = None
    if only in (None, 0):
        plane_x = _slab_rows(_plane_fft2(-nqi * kx[:, None], nqr * kx[:, None],
                                         N0, N1, +1, bf16=bf16)[0], pm)
    if only in (None, 1):
        plane_y = _slab_rows(_plane_fft2(-nqi * ky[None, :], nqr * ky[None, :],
                                         N0, N1, +1, bf16=bf16)[0], pm)
    kw = dict(precision=precision, impl=impl)
    xkw = dict(inverse=True, k2=k2l, out_dtype=sdt, **kw)
    if only is not None:
        if only not in (0, 1, 2):
            raise ValueError("only must be None, 0, 1 or 2")
        sr, si = _xct_call_multi(r, i, wx_g if only == 0 else wx, 1.0, **xkw)
        sr, si = _a2a_back(pm, sr), _a2a_back(pm, si)
        if only == 0:
            return _zy_inv_ct2_call(sr, si, wy, AB_p, n2, plane=plane_x, **kw)
        if only == 1:
            return _zy_inv_ct2_call(sr, si, wy_g, AB_p, n2, plane=plane_y,
                                    **kw)
        return _zy_inv_ct2_call(sr, si, wy, AB_g, n2, **kw)
    sr, si, gr, gi = _xct_call_multi(r, i, wx, 1.0, wx2=wx_g, **xkw)
    sr, si = _a2a_back(pm, sr), _a2a_back(pm, si)
    fy, fz = _zy_inv_ct2_call_dual(sr, si, wy_g, AB_p, wy, AB_g, n2,
                                   planeA=plane_y, **kw)
    del sr, si
    gr, gi = _a2a_back(pm, gr), _a2a_back(pm, gi)
    fx = _zy_inv_ct2_call(gr, gi, wy, AB_p, n2, plane=plane_x, **kw)
    return fx, fy, fz


def fft3_poisson_half_ct2_sharded(pm, r, i, nqr, nqi, n2, poisson_k2,
                                  precision=None, impl=None):
    """slab-sharded ct2 Poisson potential (see
    :func:`fft3_poisson_half_ct2`): one x pass with 1/k^2 folded on the
    y-chunk, all_to_all back, one zy inverse per slab.  Returns this
    rank's potential slab (N0/P, N1, n2)."""
    N0, n1, Zm = r.shape
    N1 = n1 * pm.size
    _check_sharded(pm, N0, N1, "fft3_poisson_half_ct2_sharded")
    bf16 = _bf16_products(precision)
    wy = _cached(_ct_inv_mats_np, N1)
    wx = _cached(_ct_inv_mats_np, N0)
    AB_p = _cached(_z_inv_tabs, n2, Zm, None, True)
    invk2p, k2l = _cached(_sharded_ct2_k2, _tuples(poisson_k2), N0, N1, Zm,
                          pm.rank, pm.size)
    invk2p = _on_device(invk2p, r.device)
    plane = -_plane_fft2(nqr * invk2p, nqi * invk2p, N0, N1, +1,
                         bf16=bf16)[0]
    sr, si = _xct_call_multi(r, i, wx, 1.0, inverse=True, k2=k2l,
                             precision=precision,
                             out_dtype=_spectrum_storage(r), impl=impl)
    sr, si = _a2a_back(pm, sr), _a2a_back(pm, si)
    return _zy_inv_ct2_call(sr, si, wy, AB_p, n2, plane=_slab_rows(plane, pm),
                            precision=precision, impl=impl)


def fft3_real_forward_half_sharded(pm, x, norm=True, precision=None,
                                   impl=None):
    """slab-sharded dense forward (kernel-table row 9): the zy pass on
    this rank's slab x (N0/P, N1, N2) -> (N0/P, N1, Zh), one all_to_all,
    the dense x DFT on the y-chunk.  Returns (r, i) (N0, N1/P, Zh),
    natural order, scaled by 1/(N0 N1 N2) when ``norm``."""
    n0, N1, N2 = x.shape
    N0 = n0 * pm.size
    _check_sharded(pm, N0, N1, "fft3_real_forward_half_sharded")
    Zh = N2 // 2 + 1
    wz = _cached(_dft_half_np, N2, Zh)
    wy = _cached(_dft_np, N1, -1)
    wx = _cached(_dft_np, N0, -1)
    pr, pi = _zy_fwd_dense_call(x, wz, wy, precision=precision, impl=impl)
    pr, pi = _a2a_fwd(pm, pr), _a2a_fwd(pm, pi)
    scale = 1.0 / (N0 * N1 * N2) if norm else 1.0
    return _x_dense_call(pr, pi, wx, scale, precision=precision, impl=impl)


def _sharded_dense_k2(poisson_k2, N0, N1, Zh, rank, size):
    k2 = _cached(_dense_k2_tables, poisson_k2, N0, N1, Zh)
    return k2[0], _chunk(k2[1], rank, size), k2[2]


def fft3_real_inverse_grad3_half_sharded(pm, r, i, n2, kvecs, precision=None,
                                         poisson_k2=None, impl=None):
    """slab-sharded dense force triple (row 9; see
    :func:`fft3_real_inverse_grad3_half`): this rank's y-chunk (r, i)
    (N0, N1/P, Zh) through one dual inverse x pass (plain and k_x-folded;
    1/k^2 folded from ``poisson_k2`` when given, else (r, i) is the
    filtered spectrum, as the JAX package's signature has it), two
    all_to_alls back and three zy inverses per slab.  Returns the force
    slabs (N0/P, N1, n2)."""
    N0, n1, Zh = r.shape
    N1 = n1 * pm.size
    _check_sharded(pm, N0, N1, "fft3_real_inverse_grad3_half_sharded")
    _check_kvecs(kvecs, N0, N1)
    if len(kvecs[2]) != Zh:
        raise ValueError("kvecs[2] must have length Zh=%d" % Zh)
    if n2 // 2 + 1 != Zh:
        raise ValueError("n2=%d does not give the %d half-spectrum columns"
                         % (n2, Zh))
    kvecs = _tuples(kvecs)
    wy = _cached(_dft_np, N1, +1)
    wx = _cached(_dft_np, N0, +1)
    wx_g = _cached(_dft_fold_np, N0, kvecs[0])
    wy_g = _cached(_dft_fold_np, N1, kvecs[1])
    AB_p = _cached(_irfft_mats_np, n2, Zh)
    AB_g = _cached(_irfft_mats_np, n2, Zh, kvecs[2])
    k2 = None
    if poisson_k2 is not None:
        k2 = _cached(_sharded_dense_k2, _tuples(poisson_k2), N0, N1, Zh,
                     pm.rank, pm.size)
    kw = dict(precision=precision, impl=impl)
    sr, si, gr, gi = _x_dense_call(r, i, wx, 1.0, wx2=wx_g, k2=k2, **kw)
    sr, si = _a2a_back(pm, sr), _a2a_back(pm, si)
    fy = _zy_inv_dense_call(sr, si, wy_g, AB_p, **kw)
    fz = _zy_inv_dense_call(sr, si, wy, AB_g, **kw)
    del sr, si
    gr, gi = _a2a_back(pm, gr), _a2a_back(pm, gi)
    fx = _zy_inv_dense_call(gr, gi, wy, AB_p, **kw)
    return fx, fy, fz
