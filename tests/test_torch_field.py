"""The port's field core against the JAX package's: c2c meshes, item
access by global index, ravel/unravel, resample, upsample/downsample,
preview, ctranspose, respawn, the slab iterator, and the analytic
``*_vjp``/``*_jvp`` methods with forward mode through the generic paint
and readout (mirroring the rest of tests/test_pm.py and
tests/test_gradient.py:136-233).

Inputs are numpy arrays made from a seed and fed to both packages, f8
unless stated.  Tolerances: fields and FFTs within 1e-10 of max|ref|
(c8 meshes 1e-5); the vjp/jvp methods and torch.func.jvp within 1e-8 of
the JAX package's, and within rtol 1e-5 of central differences
(BASELINE.md).
"""
import numpy as np
from numpy.testing import assert_allclose
import jax
import jax.numpy as jnp
import pytest
import torch

from pmesh_tpu import ParticleMesh as JaxPM
from pmesh_tpu import RealField as JRealField
from pmesh_tpu import TransposedComplexField as JComplexField
from pmesh_tpu_torch import ParticleMesh, RealField, convert
from pmesh_tpu_torch.pm import TransposedComplexField, build_index, reindex
from pmesh_tpu import pm as jpm_module

torch.set_num_threads(1)

TOL_FIELD = 1e-10
TOL_VJP = 1e-8
RTOL_FD = 1e-5


def _np(x):
    if hasattr(x, 'value'):
        x = x.value
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _rel(ref, got):
    ref, got = _np(ref), _np(got)
    assert ref.shape == got.shape, (ref.shape, got.shape)
    scale = np.abs(ref).max()
    return np.abs(ref - got).max() / (scale if scale > 0 else 1.0)


def _pms(Nmesh, BoxSize=8.0, dtype='f8', resampler='cic'):
    return (JaxPM(Nmesh=list(Nmesh), BoxSize=BoxSize, dtype=dtype,
                  resampler=resampler),
            ParticleMesh(Nmesh=list(Nmesh), BoxSize=BoxSize, dtype=dtype,
                         resampler=resampler, device='cpu'))


def _fields(jpm, tpm, type, value):
    return (jpm.create(type=type, value=jnp.asarray(value)),
            convert.field_from_numpy(tpm, value, type=type))


def _real_pair(shape, seed=0, **kw):
    jpm, tpm = _pms(shape, **kw)
    x = np.random.RandomState(seed).normal(size=shape)
    jr, tr = _fields(jpm, tpm, 'real', x)
    return jpm, tpm, jr, tr


# --- c2c meshes -------------------------------------------------------------

@pytest.mark.parametrize("dtype", ['c16', 'c8'])
def test_shape_c2c(dtype):
    jpm, tpm = _pms([4, 6], dtype=dtype)
    for t in ('real', 'complex', 'untransposedcomplex'):
        jf, tf = jpm.create(type=t), tpm.create(type=t)
        assert tf.shape == tuple(jf.shape)
        assert tuple(tf.cshape) == tuple(jf.cshape)
        assert str(tf.dtype).split('.')[-1] == str(jf.dtype)
        assert tf.compressed == jf.compressed is False
    assert tpm._is_c2c and tpm.complex_dtype == tpm.torch_dtype


@pytest.mark.parametrize("shape,dtype", [((8, 8), 'c16'), ((8, 6, 4), 'c16'),
                                         ((8, 6, 4), 'c8')])
def test_fft_c2c_matches_jax(shape, dtype):
    jpm, tpm = _pms(shape, dtype=dtype)
    rng = np.random.RandomState(42)
    v = (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(dtype)
    jr, tr = _fields(jpm, tpm, 'real', v)
    jc, tc = jr.r2c(), tr.r2c()
    tol = TOL_FIELD if dtype == 'c16' else 1e-5
    assert isinstance(tc, TransposedComplexField)
    assert _rel(jc, tc) <= tol
    assert _rel(jc.c2r(), tc.c2r()) <= tol
    assert _rel(v, tc.c2r()) <= tol


def test_c2c_apply_coords_and_paint():
    jpm, tpm = _pms([8, 6, 4], BoxSize=[8.0, 6.0, 2.0], dtype='c16')
    rng = np.random.RandomState(3)
    v = rng.normal(size=(8, 6, 4)) + 1j * rng.normal(size=(8, 6, 4))
    jc, tc = _fields(jpm, tpm, 'complex', v)

    def laplace(k, x):
        return x / k.normp(2, zeromode=1.0)
    assert _rel(jc.apply(laplace), tc.apply(laplace)) <= TOL_FIELD

    def circ(w, x):
        return x * w[0] + w[2]
    assert _rel(jc.apply(circ, kind='circular'),
                tc.apply(circ, kind='circular')) <= TOL_FIELD
    assert _rel(jc.cnorm(), tc.cnorm()) <= TOL_FIELD
    pos = rng.uniform(0, 6, size=(40, 3))
    jp, tp = jpm.paint(pos), tpm.paint(torch.from_numpy(pos))
    assert tp.dtype == torch.complex128
    assert _rel(jp, tp) <= TOL_FIELD
    assert _rel(jp.readout(pos), tp.readout(torch.from_numpy(pos))) \
        <= TOL_FIELD


# --- items, slabs, reshaping -------------------------------------------------

def test_real_imag_and_items():
    jpm, tpm = _pms([4, 6])
    x = np.random.RandomState(1).normal(size=(4, 6))
    jc, tc = _fields(jpm, tpm, 'complex', jpm.create(
        type='real', value=x).r2c().value)
    assert _rel(jc.real, tc.real) == 0 and _rel(jc.imag, tc.imag) == 0
    assert _rel(jc[1:3, 2], tc[1:3, 2]) == 0
    assert tc.size == jc.size and tc.slices == jc.slices
    assert (tc.start == jc.start).all()
    assert _rel(jc.flat, tc.flat) == 0
    held = tc.value
    jc[2, 1] = 5 - 2j
    tc[2, 1] = 5 - 2j
    assert _rel(jc, tc) == 0
    assert held[2, 1] != 5 - 2j     # a changed copy is rebound
    jc[...] = 3.0
    tc[...] = 3.0
    assert _rel(jc, tc) == 0
    assert_allclose(np.asarray(tc), np.asarray(jc))


def _cset_sequence(shape, comp, seed):
    jpm, tpm = _pms(shape, BoxSize=float(shape[0]))
    jc, tc = jpm.create(type='transposedcomplex'), \
        tpm.create(type='transposedcomplex')
    rng = np.random.RandomState(seed)
    for flat in range(int(np.prod(shape))):
        ind = list(np.unravel_index(flat, shape))
        if comp is not None:
            ind = ind + [comp]
            y = rng.normal()
        else:
            y = complex(rng.normal(), rng.normal())
        rj, rt = jc.csetitem(ind, y), tc.csetitem(ind, y)
        assert_allclose(rt, rj, atol=1e-15)
        gj, gt = jc.cgetitem(ind), tc.cgetitem(ind)
        assert_allclose(gt, gj, atol=1e-15)
        assert_allclose(gt, rt, atol=1e-12)
        dual = [(-i) % n for i, n in zip(ind, shape)]
        if comp is None:
            assert_allclose(tc.cgetitem(dual), np.conjugate(gt), atol=1e-12)
    return jc, tc


@pytest.mark.parametrize("shape", [(4, 4), (4, 4, 4), (5, 6), (3, 4, 5)])
@pytest.mark.parametrize("comp", [None, 0, 1])
def test_cgetitem_csetitem_every_index(shape, comp):
    """every global index set in turn: the returned value is what
    cgetitem reads, the dual holds the conjugate, and the field is the
    JAX package's after each step (it stays hermitian: c2r then r2c
    gives it back)"""
    jc, tc = _cset_sequence(shape, comp, seed=len(shape) + (comp or 0))
    assert _rel(jc, tc) == 0
    back = tc.c2r().r2c()
    for flat in range(int(np.prod(shape))):
        ind = list(np.unravel_index(flat, shape))
        assert_allclose(back.cgetitem(ind), tc.cgetitem(ind), atol=1e-10)


def test_csetitem_real_dual_and_c2c():
    jpm, tpm = _pms([8, 8])
    for pm in (jpm, tpm):
        real = pm.create(type='real', value=0.0)
        real.csetitem([1, 3], 5.0)
        assert real.cgetitem([1, -5]) == 5.0
        with pytest.raises(IndexError):
            real.csetitem([1, 3, 0], 1.0)
        comp = pm.create(type='complex', value=0.0)
        comp.csetitem([1, 0], 1 + 2j)
        assert_allclose(comp.cgetitem([-1, 0]), 1 - 2j)
        comp.csetitem([0, 0], 3 + 4j)
        assert_allclose(comp.cgetitem([0, 0]), 3.0)
        assert_allclose(comp.cgetitem([3, 7, 1]), 0.0)
    # a c2c spectrum stores every mode and its dual: as in the JAX
    # package, both are written
    jpm, tpm = _pms([4, 4], dtype='c16')
    jc, tc = jpm.create(type='complex'), tpm.create(type='complex')
    for c in (jc, tc):
        c.csetitem([1, 3], 2 + 1j)
        c.csetitem([2, 2, 1], 0.5)
        c.csetitem([0, 1, 0], 0.25)
    assert _rel(jc, tc) == 0
    assert tc.cgetitem([3, 1]) == 2 - 1j


def test_ravel_unravel_sort():
    jpm, tpm, jr, tr = _real_pair((4, 6, 5), seed=2)
    assert _rel(jr.ravel(), tr.ravel()) == 0
    assert _rel(jr.sort(), tr.sort(out=Ellipsis)) == 0
    with pytest.raises(ValueError):
        tr.ravel(out=np.zeros(120))
    flat = np.random.RandomState(3).normal(size=120)
    t2 = tpm.unravel('real', flat)
    assert _rel(jpm.unravel('real', jnp.asarray(flat)), t2) == 0
    tc = tr.r2c()
    tc2 = tpm.create(type='complex')
    tc2.unravel(tc.ravel())
    assert torch.equal(tc2.value, tc.value)


def test_build_index_and_reindex():
    for nsrc, ndst in ((8, 4), (4, 8), (6, 10), (9, 5), (8, 8)):
        assert (reindex(nsrc, ndst) == jpm_module.reindex(nsrc, ndst)).all()
    idx = [np.array([0, 2, -1]), np.array([1, -1]), np.array([0, 3])]
    assert (build_index(idx, (4, 5, 6))
            == jpm_module.build_index(idx, (4, 5, 6))).all()


RESAMPLE = [((8, 8), (4, 4)), ((4, 4), (8, 8)), ((8, 6, 8), (4, 8, 6)),
            ((6, 6), (10, 4))]


@pytest.mark.parametrize("src,dst", RESAMPLE)
def test_resample_complex_matches_jax(src, dst):
    jpm1, tpm1 = _pms(src)
    jpm2, tpm2 = _pms(dst)
    x = np.random.RandomState(5).normal(size=src)
    jc = jpm1.create(type='real', value=x).r2c()
    tc = convert.field_from_numpy(tpm1, np.asarray(jc.value))
    jo, to = jpm2.create(type='complex'), tpm2.create(type='complex')
    jc.resample(jo)
    assert tc.resample(to) is to
    assert _rel(jo, to) <= TOL_FIELD
    # into a real field of the target
    jr2, tr2 = jpm2.create(type='real'), tpm2.create(type='real')
    jc.resample(jr2)
    tc.resample(tr2)
    assert _rel(jr2, tr2) <= TOL_FIELD


@pytest.mark.parametrize("src,dst", RESAMPLE)
def test_resample_real_reads_the_spectrum(src, dst):
    """a real field resamples through its own spectrum: the port equals
    the JAX package's resample of that spectrum.  The JAX package's real
    -field resample indexes the half spectrum with the real shape
    (pmesh_tpu/pm.py:517-519), so it reads the wrong modes where the
    last axis is compressed; the port deliberately differs there."""
    jpm1, tpm1, jr, tr = _real_pair(src, seed=6)
    jpm2, tpm2 = _pms(dst)
    jo = jpm2.create(type='complex')
    jr.r2c().resample(jo)
    to = tpm2.create(type='real')
    tr.resample(to)
    assert _rel(jo.c2r(), to) <= TOL_FIELD
    assert abs(float(to.cmean()) - float(jr.cmean())) <= 1e-12
    jrr = jpm2.create(type='real')
    jr.resample(jrr)
    assert _rel(jrr, to) > 1e-3


def test_resample_same_size_casts():
    jpm, tpm, jr, tr = _real_pair((6, 4), seed=7)
    jo, to = jpm.create(type='complex'), tpm.create(type='complex')
    jr.resample(jo)
    tr.resample(to)
    assert _rel(jo, to) <= TOL_FIELD


def test_whitenoise_resolution_invariance():
    pms = {n: ParticleMesh(BoxSize=8.0, Nmesh=[n] * 3, device='cpu')
           for n in (8, 16, 32)}
    c16 = pms[16].generate_whitenoise(seed=99, type='complex')
    c32 = pms[32].generate_whitenoise(seed=99, type='complex')
    d16, d32 = pms[8].create(type='complex'), pms[8].create(type='complex')
    c16.resample(d16)
    c32.resample(d32)
    assert float((d16.value - d32.value).abs().max()) <= 1e-13


@pytest.mark.parametrize("resampler", ['cic', 'tsc', 'nnb', 'lanczos2'])
@pytest.mark.parametrize("keep_mean", [False, True])
def test_upsample_downsample_match_jax(resampler, keep_mean):
    jpm1, tpm1, jr, tr = _real_pair((4, 6), seed=8, BoxSize=[8.0, 6.0])
    jpm2, tpm2 = _pms([8, 12], BoxSize=[8.0, 6.0])
    ju = jpm2.upsample(jr, resampler=resampler, keep_mean=keep_mean)
    tu = tpm2.upsample(tr, resampler=resampler, keep_mean=keep_mean)
    assert isinstance(tu, RealField)
    assert _rel(ju, tu) <= TOL_FIELD
    jd = jpm1.downsample(ju, resampler=resampler, keep_mean=keep_mean)
    td = tpm1.downsample(tu, resampler=resampler, keep_mean=keep_mean)
    assert _rel(jd, td) <= TOL_FIELD


def test_upsample_3d_keeps_a_constant():
    _, tpm1 = _pms([4, 4, 4])
    _, tpm2 = _pms([8, 8, 8])
    up = tpm2.upsample(tpm1.create(type='real', value=3.0),
                       resampler='cic', keep_mean=True)
    assert_allclose(up.numpy(), 3.0, rtol=1e-12)


PREVIEWS = [dict(), dict(axes=(0, 1)), dict(axes=(2, 0)), dict(axes=1),
            dict(Nmesh=4), dict(Nmesh=[8, 4, 8], axes=(1,)),
            dict(Nmesh=16, axes=(0, 2), resampler='tsc'),
            dict(Nmesh=4, method='upsample')]


@pytest.mark.parametrize("kw", PREVIEWS)
def test_preview_matches_jax(kw):
    jpm, tpm, jr, tr = _real_pair((8, 8, 8), seed=9)
    got = tr.preview(**kw)
    ref = jr.preview(**kw)
    assert isinstance(got, np.ndarray)
    assert _rel(ref, got) <= TOL_FIELD
    assert _rel(jr.r2c().preview(**kw), tr.r2c().preview(**kw)) <= 1e-9
    with pytest.raises(ValueError):
        tr.preview(Nmesh=4, method='nearest')


@pytest.mark.parametrize("shape,axes", [((4, 8), [1, 0]),
                                        ((4, 6, 5), [2, 0, 1]),
                                        ((4, 6, 5), [0, 2, 1])])
def test_ctranspose(shape, axes):
    jpm, tpm, jr, tr = _real_pair(shape, seed=10,
                                  BoxSize=[float(n) + 1 for n in shape])
    jt, tt = jr.ctranspose(axes), tr.ctranspose(axes)
    assert tt.shape == tuple(jt.shape)
    assert (tt.pm.BoxSize == jt.pm.BoxSize).all()
    assert _rel(jt, tt) == 0
    with pytest.raises(ValueError):
        tr.ctranspose([0] * len(shape))


def test_reshape_and_respawn():
    jpm, tpm = _pms([4, 4], resampler='tsc')
    t2 = tpm.respawn(None)
    j2 = jpm.respawn(jpm.comm)
    assert (t2.Nmesh == j2.Nmesh).all() and (t2.BoxSize == j2.BoxSize).all()
    assert t2.dtype == j2.dtype and t2.device == tpm.device
    assert t2.resampler.kind == tpm.resampler.kind
    assert t2.procmesh is None
    assert (tpm.reshape(Nmesh=8).Nmesh == [8, 8]).all()


def test_slab_iter_matches_jax():
    for shape in ((4, 5, 6), (4, 6)):
        jpm, tpm, jr, tr = _real_pair(shape, seed=11)
        jc, tc = jr.r2c(), tr.r2c()
        for jf, tf in ((jr, tr), (jc, tc)):
            count = 0
            for jx, tx, ji, ti, js, ts in zip(
                    jf.slabs.x, tf.slabs.x, jf.slabs.i, tf.slabs.i,
                    jf.slabs, tf.slabs):
                assert len(tx) == len(shape)
                assert _rel(jx.normp(2), tx.normp(2)) <= TOL_FIELD
                assert all(_rel(a, b) == 0 for a, b in zip(ji, ti))
                assert _rel(js, ts) <= TOL_FIELD
                count += 1
            assert count == (shape[0] if len(shape) > 2 else 1)


# --- the analytic vjp/jvp methods (tests/test_gradient.py:136-233) ----------

def central_diff(f, x, eps=1e-5):
    x = np.asarray(x, dtype='f8')
    g = np.zeros_like(x)
    for idx in np.ndindex(*x.shape):
        xp, xm = x.copy(), x.copy()
        xp[idx] += eps
        xm[idx] -= eps
        g[idx] = (float(f(xp)) - float(f(xm))) / (2 * eps)
    return g


def _particles(n, ndim, box, seed):
    rng = np.random.RandomState(seed)
    return (rng.uniform(1, box - 1, size=(n, ndim)),
            rng.uniform(0.5, 2.0, size=n), rng.normal(size=(n, ndim)),
            rng.normal(size=n))


@pytest.mark.parametrize("resampler", ['cic', 'tsc'])
def test_readout_vjp_method(resampler):
    jpm, tpm, jr, tr = _real_pair((8, 8), seed=42, resampler=resampler)
    pos, _, _, _ = _particles(4, 2, 8.0, 42)
    v = np.random.RandomState(1).uniform(size=4)
    js, jp = jr.readout_vjp(jnp.asarray(pos), jnp.asarray(v))
    ts, tp = tr.readout_vjp(torch.from_numpy(pos), torch.from_numpy(v))
    assert _rel(js, ts) <= TOL_VJP and _rel(jp, tp) <= TOL_VJP
    assert tr.readout_vjp(torch.from_numpy(pos), torch.from_numpy(v),
                          out_self=False)[0] is False
    with pytest.raises(ValueError):
        tr.readout_vjp(torch.from_numpy(pos), torch.from_numpy(v),
                       gradient=0)
    # the vjp against central differences of sum(v * readout)

    def obj_pos(p):
        return float((tr.readout(torch.from_numpy(p))
                      * torch.from_numpy(v)).sum())
    assert_allclose(_np(tp), central_diff(obj_pos, pos), rtol=RTOL_FD,
                    atol=1e-8)

    def obj_mesh(m):
        f = tpm.create(type='real', value=torch.from_numpy(m))
        return float((f.readout(torch.from_numpy(pos))
                      * torch.from_numpy(v)).sum())
    assert_allclose(_np(ts), central_diff(obj_mesh, tr.numpy()),
                    rtol=RTOL_FD, atol=1e-8)


@pytest.mark.parametrize("resampler", ['cic', 'tsc'])
def test_paint_vjp_method(resampler):
    jpm, tpm = _pms([8, 8], resampler=resampler)
    pos, mass, _, _ = _particles(4, 2, 8.0, 43)
    v = np.random.RandomState(2).uniform(size=(8, 8))
    jv, tv = _fields(jpm, tpm, 'real', v)
    jp, jm = jpm.paint_vjp(jv, jnp.asarray(pos), mass=jnp.asarray(mass))
    tp, tm = tpm.paint_vjp(tv, torch.from_numpy(pos),
                           mass=torch.from_numpy(mass))
    assert _rel(jp, tp) <= TOL_VJP and _rel(jm, tm) <= TOL_VJP

    def obj(p, m):
        return float((tpm.paint(torch.from_numpy(p),
                                mass=torch.from_numpy(m)).value
                      * tv.value).sum())
    assert_allclose(_np(tp), central_diff(lambda p: obj(p, mass), pos),
                    rtol=RTOL_FD, atol=1e-8)
    assert_allclose(_np(tm), central_diff(lambda m: obj(pos, m), mass),
                    rtol=RTOL_FD, atol=1e-8)


def test_decompress_c2r_r2c_cdot_vjp():
    jpm, tpm, jr, tr = _real_pair((4, 6), seed=12)
    jc, tc = jr.r2c(), tr.r2c()
    assert _rel(JComplexField.decompress_vjp(jc),
                TransposedComplexField.decompress_vjp(tc)) <= TOL_FIELD
    d = TransposedComplexField.decompress_vjp(
        tpm.create(type='complex', value=1.0))
    assert d.value[0, 0] == 1.0 and d.value[1, 1] == 2.0
    assert _rel(JRealField.c2r_vjp(jr), RealField.c2r_vjp(tr)) <= TOL_FIELD
    assert _rel(JComplexField.r2c_vjp(jc),
                TransposedComplexField.r2c_vjp(tc)) <= TOL_FIELD
    jr2, tr2 = _fields(jpm, tpm, 'real',
                       np.random.RandomState(13).normal(size=(4, 6)))
    jc2, tc2 = jr2.r2c(), tr2.r2c()
    metric = lambda k: k + 1.0    # noqa: E731
    assert _rel(jc.cdot_vjp(jc2), tc.cdot_vjp(tc2)) <= TOL_FIELD
    assert _rel(jc.cdot_vjp(jc2, metric=metric),
                tc.cdot_vjp(tc2, metric=metric)) <= TOL_FIELD


def _jax_paint(jpm, pos, mass):
    return jpm.paint(pos, mass=mass).value


@pytest.mark.parametrize("ndim,resampler", [(2, 'cic'), (3, 'cic'),
                                            (3, 'tsc')])
def test_jvp_matches_jax(ndim, resampler):
    """torch.func.jvp through paint and readout gives the JAX package's
    custom_jvp tangents, and the explicit *_jvp methods"""
    shape = (6,) * ndim
    jpm, tpm = _pms(shape, BoxSize=6.0, resampler=resampler)
    pos, mass, v_pos, v_mass = _particles(20, ndim, 6.0, 14)
    P, M, VP, VM = (torch.from_numpy(a) for a in (pos, mass, v_pos, v_mass))
    _, jt = jax.jvp(lambda p, m: _jax_paint(jpm, p, m),
                    (jnp.asarray(pos), jnp.asarray(mass)),
                    (jnp.asarray(v_pos), jnp.asarray(v_mass)))
    out, tt = torch.func.jvp(lambda p, m: tpm.paint(p, mass=m).value,
                             (P, M), (VP, VM))
    assert _rel(jt, tt) <= TOL_VJP
    assert _rel(_jax_paint(jpm, pos, mass), out) <= TOL_FIELD
    assert _rel(jt, tpm.paint_jvp(P, mass=M, v_pos=VP, v_mass=VM)) <= TOL_VJP
    # the mass tangent alone, and forward AD's dual tensors
    _, jt = jax.jvp(lambda m: _jax_paint(jpm, jnp.asarray(pos), m),
                    (jnp.asarray(mass),), (jnp.asarray(v_mass),))
    import torch.autograd.forward_ad as fwAD
    with fwAD.dual_level():
        dual = tpm.paint(P, mass=fwAD.make_dual(M, VM)).value
        tt = fwAD.unpack_dual(dual).tangent
    assert _rel(jt, tt) <= TOL_VJP

    mesh = np.random.RandomState(15).normal(size=shape)
    v_mesh = np.random.RandomState(16).normal(size=shape)
    jm, tm = _fields(jpm, tpm, 'real', mesh)
    jv, tv = _fields(jpm, tpm, 'real', v_mesh)

    def jread(mv, p):
        return jpm.create(type='real', value=mv).readout(p)

    def tread(mv, p):
        return tpm.create(type='real', value=mv).readout(p)
    _, jt = jax.jvp(jread, (jm.value, jnp.asarray(pos)),
                    (jv.value, jnp.asarray(v_pos)))
    _, tt = torch.func.jvp(tread, (tm.value, P), (tv.value, VP))
    assert _rel(jt, tt) <= TOL_VJP
    assert _rel(jt, tm.readout_jvp(P, v_self=tv, v_pos=VP)) <= TOL_VJP
    assert _rel(jm.readout_jvp(jnp.asarray(pos), v_pos=jnp.asarray(v_pos)),
                tm.readout_jvp(P, v_pos=VP)) <= TOL_VJP


def test_jvp_of_a_batched_readout_and_diffdir():
    from pmesh_tpu.ops import paint as jpaint
    from pmesh_tpu_torch.ops import paint as tpaint
    rng = np.random.RandomState(17)
    meshes = rng.normal(size=(3, 6, 6, 6))
    tangents = rng.normal(size=(3, 6, 6, 6))
    pos, _, v_pos, _ = _particles(15, 3, 6.0, 18)
    kw = dict(window='tsc', scale=1.0, period=6)
    _, jt = jax.jvp(lambda m, p: jpaint.readout(tuple(m), p, **kw),
                    (jnp.asarray(meshes), jnp.asarray(pos)),
                    (jnp.asarray(tangents), jnp.asarray(v_pos)))
    _, tt = torch.func.jvp(
        lambda m, p: tpaint.readout(tuple(m.unbind(0)), p, **kw),
        (torch.from_numpy(meshes), torch.from_numpy(pos)),
        (torch.from_numpy(tangents), torch.from_numpy(v_pos)))
    assert all(_rel(a, b) <= TOL_VJP for a, b in zip(jt, tt))
    # forward mode through a diffdir readout raises, as in the JAX
    # package, whose custom_jvp rule sees an instantiated zero position
    # tangent even when only the mesh has a tangent
    with pytest.raises(ValueError, match='gradient of gradient'):
        jax.jvp(lambda m: jpaint.readout(m, jnp.asarray(pos), diffdir=1,
                                         **kw),
                (jnp.asarray(meshes[0]),), (jnp.asarray(tangents[0]),))
    with pytest.raises(ValueError, match='gradient of gradient'):
        torch.func.jvp(
            lambda m: tpaint.readout(m, torch.from_numpy(pos), diffdir=1,
                                     **kw),
            (torch.from_numpy(meshes[0]),), (torch.from_numpy(tangents[0]),))


def test_jvp_composes_with_explicit_methods():
    """torch.func.jvp through paint/readout equals the explicit *_jvp
    operators, and forward-over-reverse (jvp of grad) gives the JAX
    package's Hessian-vector product"""
    jpm, tpm = _pms([4, 4, 4])
    pos, mass, v_pos, v_mass = _particles(30, 3, 8.0, 11)
    pos = np.random.RandomState(11).uniform(0, 8, (30, 3))
    P, M, VP, VM = (torch.from_numpy(a) for a in (pos, mass, v_pos, v_mass))
    _, tangent = torch.func.jvp(lambda p, m: tpm.paint(p, mass=m).value,
                                (P, M), (VP, VM))
    want = tpm.paint_jvp(P, mass=M, v_pos=VP, v_mass=VM)
    assert_allclose(tangent.numpy(), want.numpy(), rtol=1e-10, atol=1e-12)
    mesh = tpm.create(type='real',
                      value=torch.from_numpy(
                          np.random.RandomState(3).normal(size=(4, 4, 4))))
    v_mesh = tpm.create(type='real',
                        value=torch.from_numpy(
                            np.random.RandomState(4).normal(size=(4, 4, 4))))
    _, tangent = torch.func.jvp(
        lambda mv, p: tpm.create(type='real', value=mv).readout(p),
        (mesh.value, P), (v_mesh.value, VP))
    want = mesh.readout_jvp(P, v_self=v_mesh, v_pos=VP)
    assert_allclose(tangent.numpy(), want.numpy(), rtol=1e-10, atol=1e-12)

    def jloss(p):
        return jnp.sum(jpm.paint(p).value ** 2)

    def tloss(p):
        return (tpm.paint(p).value ** 2).sum()
    _, jh = jax.jvp(jax.grad(jloss), (jnp.asarray(pos),),
                    (jnp.asarray(v_pos),))
    _, th = torch.func.jvp(torch.func.grad(tloss), (P,), (VP,))
    assert np.isfinite(th.numpy()).all()
    assert _rel(jh, th) <= TOL_VJP
    # and double backward: the gradient of <grad, v_pos>
    p = P.clone().requires_grad_(True)
    g, = torch.autograd.grad(tloss(p), p, create_graph=True)
    hv, = torch.autograd.grad((g * VP).sum(), p)
    assert _rel(jh, hv) <= TOL_VJP
