"""The port's older DFT-as-matmul pipelines (kernel-table row 13,
``pmesh_tpu_torch.ops.fft_mxu_ref``) against the JAX package's
``pmesh_tpu.ops.fft_mxu_ref``, whose Pallas kernels run in interpret
mode on the CPU as its own tests run them.

- the full-spectrum entry points (``fft3_real_forward``,
  ``fft3_real_inverse`` with grad None/0/1/2, ``fft3_real_inverse_grad3``)
  at (8, 16, 32) and the ragged (6, 10, 14): 3e-6 of max|JAX| (f32
  matmuls summed in another order);
- the first-CT half entry points (``fft3_real_forward_half_ct``,
  ``fft3_real_inverse_grad3_half_ct``) at (256, 256, 16) and
  (256, 512, 10), the smallest shapes whose x and y lengths split as
  R * 128k with R > 1 (R = 2 and 4 here): 3e-6 of max|JAX|.  The JAX
  package's plane-block picker would unroll every x-plane of these
  shapes into one interpret-mode kernel body; the tests set its
  ``TUNE`` block to 2 planes, which changes the blocking, not the math;
- what both packages refuse: a nonzero x or y wavenumber at Nyquist in
  the half-spectrum gradient, a non-CT shape for the CT forward; and
  that ``precision='bf16'`` runs (its values: test_torch_fft_bf16.py).

About 30 s in one process, most of it JAX compiling its kernels.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pmesh_tpu.ops import fft_mxu as jfm
from pmesh_tpu.ops import fft_mxu_ref as jref
from pmesh_tpu_torch.ops import fft_mxu as fm
from pmesh_tpu_torch.ops import fft_mxu_ref as ref

torch.set_num_threads(1)

TOL = 3e-6
DENSE_SHAPES = [(8, 16, 32), (6, 10, 14)]
CT_SHAPES = [(256, 256, 16), (256, 512, 10)]


def _rel(jax_out, got):
    want = np.asarray(jax_out)
    got = got.numpy()
    assert want.shape == got.shape and got.dtype == np.float32
    return np.abs(want - got).max() / np.abs(want).max()


def _field(seed, shape):
    return np.random.RandomState(seed).normal(size=shape).astype('f4')


def _kvec(n, half=False):
    """a SuperLanczos-shaped wavenumber table, zero at Nyquist"""
    w = (np.fft.rfftfreq(n) if half else np.fft.fftfreq(n)) * 2 * np.pi
    return tuple(((8 * np.sin(w) - np.sin(2 * w)) / 6.0).tolist())


def _fftfreq(n):
    """the plain wavenumbers 2 pi fftfreq, nonzero at Nyquist"""
    return tuple((np.fft.fftfreq(n) * 2 * np.pi).tolist())


@pytest.fixture(scope="module", params=DENSE_SHAPES, ids=str)
def dense(request):
    """(shape, JAX spectrum, port spectrum) of one seeded field"""
    shape = request.param
    x = _field(1, shape)
    return (shape, jref.fft3_real_forward(jnp.asarray(x)),
            ref.fft3_real_forward(torch.from_numpy(x)))


@pytest.fixture(scope="module", params=CT_SHAPES, ids=str)
def half_ct(request):
    shape = request.param
    N0, N1, N2 = shape
    key = 'bx:%dx%dx%d' % (N0, N1, N2 // 2 + 1)
    jfm.TUNE[key] = 2
    x = _field(2, shape)
    yield (shape, jref.fft3_real_forward_half_ct(jnp.asarray(x)),
           ref.fft3_real_forward_half_ct(torch.from_numpy(x)))
    jfm.TUNE.pop(key, None)


def test_forward_matches_jax(dense):
    shape, want, got = dense
    for w, g in zip(want, got):
        assert _rel(w, g) <= TOL


@pytest.mark.parametrize("grad", [None, 0, 1, 2])
def test_inverse_matches_jax(dense, grad):
    shape, (jr, ji), (tr, ti) = dense
    kv = None if grad is None else _fftfreq(shape[grad])
    want = jref.fft3_real_inverse(jr, ji, grad=grad, kvec=kv)
    got = ref.fft3_real_inverse(tr, ti, grad=grad, kvec=kv)
    assert _rel(want, got) <= TOL


def test_inverse_grad3_matches_jax(dense):
    shape, (jr, ji), (tr, ti) = dense
    kvecs = tuple(_kvec(n) for n in shape)
    want = jref.fft3_real_inverse_grad3(jr, ji, kvecs=kvecs)
    got = ref.fft3_real_inverse_grad3(tr, ti, kvecs=kvecs)
    for w, g in zip(want, got):
        assert _rel(w, g) <= TOL


def test_roundtrip_and_numpy(dense):
    """the forward is numpy's fftn / N^3 and the inverse undoes it"""
    shape, _, (tr, ti) = dense
    x = _field(1, shape)
    truth = np.fft.fftn(x.astype('f8')) / x.size
    got = tr.numpy() + 1j * ti.numpy()
    assert np.abs(got - truth).max() <= TOL * np.abs(truth).max()
    back = ref.fft3_real_inverse(tr, ti).numpy()
    assert np.abs(back - x).max() <= 2e-5


def test_forward_half_ct_matches_jax(half_ct):
    shape, want, got = half_ct
    for w, g in zip(want, got):
        assert g.shape == (shape[0], shape[1], shape[2] // 2 + 1)
        assert _rel(w, g) <= TOL
    # unpermuted, it is numpy's rfftn / N^3 with the Nyquist column kept
    p0, p1 = fm._ct_permute(shape[0]), fm._ct_permute(shape[1])
    x = _field(2, shape)
    truth = np.fft.rfftn(x.astype('f8')) / x.size
    spec = (got[0].numpy() + 1j * got[1].numpy())[p0][:, p1]
    assert np.abs(spec - truth).max() <= TOL * np.abs(truth).max()


def test_inverse_grad3_half_ct_matches_jax(half_ct):
    shape, (jr, ji), (tr, ti) = half_ct
    kvecs = (_kvec(shape[0]), _kvec(shape[1]), _kvec(shape[2], half=True))
    want = jref.fft3_real_inverse_grad3_half_ct(jr, ji, n2=shape[2],
                                                kvecs=kvecs)
    got = ref.fft3_real_inverse_grad3_half_ct(tr, ti, shape[2], kvecs)
    for w, g in zip(want, got):
        assert g.shape == shape
        assert _rel(w, g) <= TOL


def test_half_ct_refusals():
    """a nonzero x wavenumber at Nyquist breaks the hermitian doubling:
    both packages raise; the CT forward needs R * 128k x and y lengths"""
    shape = (256, 256, 16)
    Zh = shape[2] // 2 + 1
    r = np.zeros((256, 256, Zh), 'f4')
    kvecs = (_fftfreq(256), _kvec(256), _kvec(16, half=True))
    with pytest.raises(ValueError, match='Nyquist'):
        jref.fft3_real_inverse_grad3_half_ct(jnp.asarray(r), jnp.asarray(r),
                                             n2=16, kvecs=kvecs)
    with pytest.raises(ValueError, match='Nyquist'):
        ref.fft3_real_inverse_grad3_half_ct(torch.from_numpy(r),
                                            torch.from_numpy(r), 16, kvecs)
    with pytest.raises(ValueError, match='R\\*128k'):
        jref.fft3_real_forward_half_ct(jnp.zeros((96, 256, 16)))
    with pytest.raises(ValueError, match='R\\*128k'):
        ref.fft3_real_forward_half_ct(torch.zeros((96, 256, 16)))


def test_refusals():
    x = torch.zeros((4, 4, 4))
    r, i = ref.fft3_real_forward(x, precision='bf16')
    assert r.dtype == i.dtype == torch.float32
    assert ref.fft3_real_inverse(r, i, precision='bf16').dtype == torch.float32
    with pytest.raises(ValueError, match='precision'):
        ref.fft3_real_forward(x, precision='tf32')
    with pytest.raises(ValueError, match='kvec'):
        ref.fft3_real_inverse(x, x, grad=1)
    with pytest.raises(ValueError, match='impl'):
        ref.fft3_real_forward(x, impl='triton')
    with pytest.raises(ValueError, match='CUDA tensors'):
        ref.fft3_real_forward(x, impl='cuda')
