"""The port's white noise (pmesh_tpu_torch.whitenoise), its C++ host
runtime and the inside-out index (pmesh_tpu_torch.invariant) against
the JAX package's, on the CPU.

Tolerances: gadget noise bitwise (3-d compressed and full, a sub-box,
unitary, complex64, 1-d and 2-d); native noise bitwise in its uniforms
(u1, u2: threefry bits, held against jax.random directly) and within
1e-15 in the field (compressed, full, unitary, an odd mesh), resolution
invariant bitwise; ranlxd streams bitwise; the invariant index exact.
"""
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pmesh_tpu import ParticleMesh as JaxPM
from pmesh_tpu import invariant as jinv
from pmesh_tpu import whitenoise as jwn
from pmesh_tpu.native import runtime as jrt
from pmesh_tpu_torch import ParticleMesh, invariant as tinv
from pmesh_tpu_torch import whitenoise as twn
from pmesh_tpu_torch.native import runtime as trt

torch.set_num_threads(1)


def _jax(Nmesh, shape, seed, unitary=False, compat='gadget', start=None,
         dtype=None):
    return np.asarray(jwn.generate(Nmesh, shape, seed, unitary, dtype=dtype,
                                   compat=compat, start=start))


def _torch(Nmesh, shape, seed, unitary=False, compat='gadget', start=None,
           dtype=None):
    return twn.generate(Nmesh, shape, seed, unitary, dtype=dtype,
                        compat=compat, start=start, device='cpu').numpy()


GADGET = {
    'half': dict(Nmesh=(16,) * 3, shape=(16, 16, 9), seed=1),
    'full': dict(Nmesh=(8,) * 3, shape=(8, 8, 8), seed=5),
    'subbox': dict(Nmesh=(16,) * 3, shape=(8, 4, 4), seed=1,
                   start=(2, 3, 2)),
    'unitary': dict(Nmesh=(8,) * 3, shape=(8, 8, 5), seed=3, unitary=True),
    'illustris': dict(Nmesh=(4,) * 3, shape=(4, 4, 3), seed=5463),
    '1d': dict(Nmesh=(64,), shape=(33,), seed=1),
    '2d': dict(Nmesh=(16, 16), shape=(16, 9), seed=2),
    '2d_subbox': dict(Nmesh=(16, 16), shape=(8, 4), seed=2, start=(2, 2)),
}


@pytest.mark.parametrize("case", sorted(GADGET))
def test_gadget_bitwise(case):
    kw = GADGET[case]
    ref = _jax(**kw)
    got = _torch(**kw)
    assert got.dtype == ref.dtype == np.complex128
    assert np.array_equal(got, ref)


def test_gadget_refuses_n1_above_n0():
    """the gadget fill seeds an N0 x N0 table and reads it for every
    j < N1: with N1 > N0 it reads past the table's end (the JAX
    package's fill gives no defined answer there), so the port refuses;
    N1 <= N0 and any N2 still fill, bitwise the JAX package's"""
    for Nmesh, shape in (((6, 10, 7), (6, 10, 4)), ((4, 8, 4), (4, 8, 3))):
        with pytest.raises(ValueError, match='Nmesh\\[1\\] <= Nmesh\\[0\\]'):
            _torch(Nmesh, shape, 1)
        pm = ParticleMesh(Nmesh=list(Nmesh), device='cpu')
        with pytest.raises(ValueError, match='seed table'):
            pm.generate_whitenoise(1, type='complex')
    kw = dict(Nmesh=(10, 6, 7), shape=(10, 6, 4), seed=4)
    assert np.array_equal(_torch(**kw), _jax(**kw))


def test_gadget_complex64_bitwise():
    kw = dict(Nmesh=(8,) * 3, shape=(8, 8, 5), seed=7)
    ref = _jax(dtype=jnp.complex64, **kw)
    got = _torch(dtype=torch.complex64, **kw)
    assert got.dtype == ref.dtype == np.complex64
    assert np.array_equal(got, ref)


def test_ranlxd_and_build():
    assert np.array_equal(trt.ranlxd(12345, 1000), jrt.ranlxd(12345, 1000))
    # the port builds its own library from its own copy of the sources
    path = trt._lib_path()
    assert os.path.isfile(path)
    assert os.path.basename(os.path.dirname(path)) == "_build"
    assert os.path.dirname(os.path.dirname(path)) == os.path.dirname(
        os.path.dirname(trt.__file__))
    for name in ("ranlxd.cc", "ranlxd.h", "whitenoise.cc", "invariant.cc"):
        with open(os.path.join(trt.SRC, name), "rb") as f:
            mine = f.read()
        with open(os.path.join(os.path.dirname(jrt.__file__), "src", name),
                  "rb") as f:
            assert f.read() == mine


def _jax_uniforms(Nmesh, shape, seed):
    """u1, u2 of every mode as the JAX package draws them: fold_in of
    the representative's components into fold_in(key(0), seed), then
    uniform(key, (2,), float64)."""
    ndim = len(Nmesh)
    m = []
    for d in range(ndim):
        t = [1] * ndim
        t[d] = shape[d]
        i = np.arange(shape[d])
        m.append(np.where(i >= Nmesh[d] // 2, i - Nmesh[d], i).reshape(t))
    mneg = [np.where(m[d] == -(Nmesh[d] // 2), m[d], -m[d])
            for d in range(ndim)]
    gt = np.zeros(shape, bool)
    eq = np.ones(shape, bool)
    for d in range(ndim):
        gt = gt | (eq & (m[d] > mneg[d]))
        eq = eq & (m[d] == mneg[d])
    rep = [np.broadcast_to(np.where(gt | eq, m[d], mneg[d]), shape)
           .reshape(-1).astype(np.int32).view(np.uint32) for d in range(ndim)]
    base = jax.random.fold_in(jax.random.key(0), jnp.uint32(seed))

    def one(*words):
        k = base
        for w in words:
            k = jax.random.fold_in(k, w)
        return jax.random.uniform(k, (2,), dtype=jnp.float64)
    u = np.asarray(jax.vmap(one)(*[jnp.asarray(r) for r in rep]))
    return u[:, 0].reshape(shape), u[:, 1].reshape(shape)


@pytest.mark.parametrize("Nmesh, shape", [((8, 8, 8), (8, 8, 5)),
                                          ((6, 10, 7), (6, 10, 7))])
def test_native_uniforms_bitwise(Nmesh, shape):
    ref = _jax_uniforms(Nmesh, shape, 42)
    got = twn.native_uniforms(Nmesh, shape, 42, 'cpu')
    for r, g in zip(ref, got):
        assert g.dtype == torch.float64
        assert np.array_equal(g.numpy(), r)


NATIVE = {
    'half': dict(Nmesh=(16,) * 3, shape=(16, 16, 9), seed=42),
    'full': dict(Nmesh=(8,) * 3, shape=(8, 8, 8), seed=7),
    'unitary': dict(Nmesh=(8,) * 3, shape=(8, 8, 5), seed=3, unitary=True),
    'odd': dict(Nmesh=(6, 10, 7), shape=(6, 10, 4), seed=11),
    '2d': dict(Nmesh=(16, 12), shape=(16, 7), seed=2),
}


@pytest.mark.parametrize("case", sorted(NATIVE))
def test_native_matches_jax(case):
    kw = NATIVE[case]
    ref = _jax(compat='native', **kw)
    got = _torch(compat='native', **kw)
    assert got.dtype == ref.dtype == np.complex128
    assert np.abs(got - ref).max() <= 1e-15 * np.abs(ref).max()
    # the DC mode, and the imaginary part of self-conjugate modes, are
    # exactly 0 on both sides
    assert got.reshape(-1)[0] == 0
    assert np.array_equal(got.imag == 0, ref.imag == 0)


def test_native_resolution_invariance():
    small = _torch((8, 8, 8), (8, 8, 5), 42, compat='native')
    big = _torch((16, 16, 16), (16, 16, 9), 42, compat='native')
    for ix in range(-3, 4):
        for iy in range(-3, 4):
            assert np.array_equal(small[ix % 8, iy % 8, :4],
                                  big[ix % 16, iy % 16, :4])


@pytest.mark.parametrize("compat", ['gadget', 'native'])
@pytest.mark.parametrize("ftype", ['complex', 'untransposedcomplex',
                                   'real'])
def test_generate_whitenoise_matches_jax(compat, ftype):
    jpm = JaxPM(Nmesh=[8] * 3, BoxSize=8.0, dtype='f8')
    tpm = ParticleMesh(Nmesh=[8] * 3, BoxSize=8.0, dtype='f8', device='cpu')
    ref = jpm.generate_whitenoise(9, type=ftype, mean=0.5, compat=compat)
    got = tpm.generate_whitenoise(9, type=ftype, mean=0.5, compat=compat)
    assert got.__class__.__name__ == ref.__class__.__name__
    assert got.value.dtype == (torch.float64 if ftype == 'real'
                               else torch.complex128)
    ref = np.asarray(ref.value)
    assert np.abs(got.numpy() - ref).max() <= 1e-12 * np.abs(ref).max()
    if ftype != 'real':
        assert got.numpy()[0, 0, 0] == 0.5
        if compat == 'gadget':
            assert np.array_equal(got.numpy(), ref)


def test_whitenoise_field_types():
    tpm = ParticleMesh(Nmesh=[8] * 3, BoxSize=8.0, dtype='f4', device='cpu')
    from pmesh_tpu_torch import pm as tpmmod
    for ftype, cls in (('complex', tpmmod.TransposedComplexField),
                       ('transposedcomplex', tpmmod.TransposedComplexField),
                       ('untransposedcomplex',
                        tpmmod.UntransposedComplexField),
                       ('real', tpmmod.RealField)):
        f = tpm.generate_whitenoise(1, type=ftype)
        assert isinstance(f, cls)
    assert f.value.dtype == torch.float32


def _invariant_cases():
    x1 = np.arange(-4, 5).reshape(-1, 1)
    x2 = np.stack(np.meshgrid(np.arange(-2, 2), np.arange(-2, 2),
                              indexing='ij'), axis=-1)
    x3 = np.stack(np.meshgrid(*[np.arange(-3, 3)] * 3, indexing='ij'),
                  axis=-1)
    return [(x1, 6, False, None), (x1, 6, True, None),
            (x2, 4, False, None), (x2, 4, True, None),
            (x3, 6, False, None), (x3, 6, True, None),
            (x3, [6, 6, 8], True, 40),
            (np.random.RandomState(3).randint(-16, 16, (500, 3)), 32, True,
             None)]


@pytest.mark.parametrize("case", range(8))
def test_invariant_index_exact(case):
    x, Nmesh, compressed, maxlength = _invariant_cases()[case]
    ref = jinv.get_index(x, Nmesh, compressed=compressed,
                         maxlength=maxlength)
    got = tinv.get_index(x, Nmesh, compressed=compressed,
                         maxlength=maxlength)
    assert got.dtype == np.int64
    assert np.array_equal(got, ref)


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid")
    for compat in ('gadget', 'native'):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            twn.generate((8,) * 3, (8, 8, 5), 1, compat=compat)
