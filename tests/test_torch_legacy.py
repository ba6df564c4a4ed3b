"""The port's deprecated legacy package (``pmesh_tpu_torch/legacy/``):
the five tests of ``tests/test_legacy.py`` on the port, and its outputs
against the JAX package's legacy modules on the same seeded numpy
inputs, within 1e-10 of max|JAX| in f8 (CPU):
- ``cic`` and ``tsc`` paint and readout, wrapped and non-periodic;
- the callable-window ``lanczos`` paint and readout, for each window
  (``linear``, ``cubic``, ``lanczos2``, ``lanczos3``, ``kaiser``), with
  a period and in ``mode='ignore'``; ``mode='raise'`` refuses a
  particle beyond the window's reach, as the JAX package does eagerly;
- the stateful ``ParticleMesh`` pipeline: the painted mesh, its
  transform, the five transfers, the c2r with the SuperLanczos
  derivative, the readout and the pop, and ``PowerSpectrum``'s bins;
- every transfer of ``TransferFunction`` on the same spectrum.
"""
import warnings

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from numpy.testing import assert_allclose

torch.set_num_threads(1)

TOL = 1e-10

with warnings.catch_warnings():
    warnings.simplefilter("ignore", DeprecationWarning)
    from pmesh_tpu.legacy import cic as jcic, tsc as jtsc
    from pmesh_tpu.legacy import lanczos as jlz
    from pmesh_tpu.legacy.particlemesh import ParticleMesh as JaxLegacyPM
    from pmesh_tpu.legacy.transfer import TransferFunction as JTF
    from pmesh_tpu_torch.legacy import cic, tsc, lanczos
    from pmesh_tpu_torch.legacy.particlemesh import ParticleMesh
    from pmesh_tpu_torch.legacy.transfer import TransferFunction


def _rel(ref, got):
    ref = np.asarray(ref)
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    assert ref.shape == got.shape
    return np.abs(ref - got).max() / np.abs(ref).max()


# --- the five tests of tests/test_legacy.py, on the port -----------------

def test_legacy_particlemesh_pipeline():
    pm = ParticleMesh(BoxSize=16.0, Nmesh=16, dtype='f8', device='cpu')
    rng = np.random.RandomState(42)
    pos = rng.uniform(0, 16, size=(100, 3))

    pm.clear()
    pm.paint(pos)
    assert_allclose(float(pm.real.sum()), 100.0, rtol=1e-10)
    pm.r2c()
    pm.push()
    pm.transfer([
        TransferFunction.RemoveDC,
        TransferFunction.Trilinear,
        TransferFunction.Gaussian(1.25),
        TransferFunction.Poisson,
        TransferFunction.Constant(4 * np.pi * 43007.1),
    ])
    pm.c2r([TransferFunction.SuperLanzcos(0)])
    acc = pm.readout(pos).numpy()
    assert np.isfinite(acc).all()
    pm.pop()
    # after pop, the DC mode of the original transform is back
    assert abs(pm.complex.reshape(-1)[0]) > 0


def test_legacy_transfer_powerspectrum():
    pm = ParticleMesh(BoxSize=16.0, Nmesh=16, dtype='f8', device='cpu')
    rng = np.random.RandomState(1)
    pos = rng.uniform(0, 16, size=(1000, 3))
    pm.r2c(pos)
    wout = np.zeros(8)
    psout = np.zeros(8)
    pm.transfer([
        TransferFunction.NormalizeDC,
        TransferFunction.RemoveDC,
        TransferFunction.PowerSpectrum(wout, psout),
    ])
    assert (psout >= 0).all()
    assert np.isfinite(wout).all()


def test_legacy_cic_matches_window():
    from pmesh_tpu_torch.window import Affine, FindResampler
    CIC = FindResampler('cic')

    rng = np.random.RandomState(42)
    pos = torch.tensor(rng.uniform(0, 8, size=(50, 2)))
    mesh = torch.zeros((8, 8), dtype=torch.float64)
    r1 = cic.paint(pos, mesh, mode='wrap', period=8)
    r2 = CIC.paint(torch.zeros((8, 8), dtype=torch.float64), pos,
                   transform=Affine(2, period=8))
    assert_allclose(r1.numpy(), r2.numpy(), atol=1e-12)
    v1 = cic.readout(r1, pos, mode='wrap', period=8)
    assert np.isfinite(v1.numpy()).all()


def test_legacy_tsc():
    pos = np.array([[4.0, 4.0]])
    r = tsc.paint(pos, np.zeros((8, 8)), mode='wrap', period=8,
                  device='cpu')
    assert_allclose(float(r.sum()), 1.0, rtol=1e-12)


def test_legacy_tools():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        from pmesh_tpu_torch.legacy.tools import Rotator, FromRoot, Timers

    with Rotator():
        pass

    @FromRoot()
    def f(x):
        return x * 2
    assert f(21) == 42
    T = Timers()
    with T['phase']:
        pass
    assert T['phase'].count == 1


def test_legacy_modules_warn_on_import():
    import importlib
    import sys
    for name in ('tools', 'cic', 'tsc', 'lanczos', 'transfer',
                 'particlemesh'):
        full = 'pmesh_tpu_torch.legacy.' + name
        saved = sys.modules.pop(full)
        try:
            with pytest.warns(DeprecationWarning):
                importlib.import_module(full)
        finally:
            sys.modules[full] = saved


# --- against the JAX package's legacy modules -----------------

@pytest.mark.parametrize("mod", ['cic', 'tsc'])
@pytest.mark.parametrize("mode", ['wrap', 'ignore'])
def test_cic_tsc_match_jax(mod, mode):
    jmod, tmod = {'cic': (jcic, cic), 'tsc': (jtsc, tsc)}[mod]
    rng = np.random.RandomState(3)
    pos = rng.uniform(-1, 9, size=(200, 3))
    base = rng.normal(size=(8, 8, 8))
    weights = rng.uniform(0.5, 1.5, 200)
    ref = jmod.paint(pos, base, weights=weights, mode=mode, period=8)
    got = tmod.paint(pos, base, weights=weights, mode=mode, period=8,
                     device='cpu')
    assert _rel(ref, got) <= TOL
    ref = jmod.readout(np.asarray(ref), pos, mode=mode, period=8)
    got = tmod.readout(got, pos, mode=mode, period=8)
    assert _rel(ref, got) <= TOL


WINDOWS = {'linear': (jlz.linear, lanczos.linear),
           'cubic': (jlz.cubic, lanczos.cubic),
           'lanczos2': (jlz.lanczos2, lanczos.lanczos2),
           'lanczos3': (jlz.lanczos3, lanczos.lanczos3),
           'kaiser': (jlz.kaiser(2.5, 1.5), lanczos.kaiser(2.5, 1.5))}


@pytest.mark.parametrize("name,ndim", [(n, 2) for n in sorted(WINDOWS)]
                         + [('lanczos2', 3)])
def test_lanczos_windows_match_jax(name, ndim):
    """2-d meshes, and one 3-d: the JAX side evaluates each of the
    (2 support)^ndim offsets op by op"""
    jw, tw = WINDOWS[name]
    assert jw.support == tw.support
    assert abs(jw.integral - tw.integral) <= TOL * abs(jw.integral)
    dx = np.linspace(-3.5, 3.5, 141)
    assert _rel(jw(jnp.asarray(dx)), tw(torch.tensor(dx))) <= TOL
    rng = np.random.RandomState(4)
    pos = rng.uniform(0, 12, size=(150, ndim))
    base = rng.normal(size=(12,) * ndim)
    for kw in (dict(period=12), dict(mode='ignore')):
        ref = jlz.paint(pos, base, weights=0.7, window=jw, **kw)
        got = lanczos.paint(pos, torch.tensor(base), weights=0.7, window=tw,
                            **kw)
        assert _rel(ref, got) <= TOL
        ref = jlz.readout(ref, pos, window=jw, **kw)
        got = lanczos.readout(got, pos, window=tw, **kw)
        assert _rel(ref, got) <= TOL


def test_lanczos_raise_refuses_like_jax():
    pos = np.array([[1.0, 1.0, 1.0], [-2.5, 1.0, 1.0]])
    with pytest.raises(ValueError, match="outside the mesh"):
        jlz.paint(pos, np.zeros((8, 8, 8)), window=jlz.linear)
    with pytest.raises(ValueError, match="outside the mesh"):
        lanczos.paint(pos, torch.zeros((8, 8, 8), dtype=torch.float64),
                      window=lanczos.linear)
    with pytest.raises(ValueError, match="outside the mesh"):
        lanczos.readout(torch.zeros((8, 8, 8), dtype=torch.float64), pos,
                        window=lanczos.linear)
    # within the reach of the window: both paint it, and drop what falls
    # outside
    pos[1, 0] = -0.5
    ref = jlz.paint(pos, np.zeros((8, 8, 8)), window=jlz.linear)
    got = lanczos.paint(pos, torch.zeros((8, 8, 8), dtype=torch.float64),
                        window=lanczos.linear)
    assert _rel(ref, got) <= TOL


def _pipelines(dtype='f8'):
    jpm = JaxLegacyPM(BoxSize=16.0, Nmesh=16, dtype=dtype)
    tpm = ParticleMesh(BoxSize=16.0, Nmesh=16, dtype=dtype, device='cpu')
    return jpm, tpm


CHAIN = ('RemoveDC', 'Trilinear', 'Gaussian', 'Poisson', 'Constant')


def _chain(T):
    return [T.RemoveDC, T.Trilinear, T.Gaussian(1.25), T.Poisson,
            T.Constant(4 * np.pi * 43007.1)]


def test_legacy_pipeline_matches_jax():
    """every stage of tests/test_legacy.py's pipeline, with mass"""
    rng = np.random.RandomState(42)
    pos = rng.uniform(0, 16, size=(300, 3))
    mass = rng.uniform(0.5, 1.5, 300)
    jpm, tpm = _pipelines()
    for pm in (jpm, tpm):
        pm.clear()
        pm.paint(pos, mass=mass)
    assert _rel(jpm.real, tpm.real) <= TOL
    for pm in (jpm, tpm):
        pm.r2c()
        pm.push()
    assert _rel(jpm.complex, tpm.complex) <= TOL
    jpm.transfer(_chain(JTF))
    tpm.transfer(_chain(TransferFunction))
    assert _rel(jpm.complex, tpm.complex) <= TOL
    jpm.c2r([JTF.SuperLanzcos(0)])
    tpm.c2r([TransferFunction.SuperLanzcos(0)])
    assert _rel(jpm.real, tpm.real) <= TOL
    assert _rel(jpm.readout(pos), tpm.readout(pos)) <= TOL
    for pm in (jpm, tpm):
        pm.pop()
    assert _rel(jpm.complex, tpm.complex) <= TOL
    # the coordinate lists and the transforms
    for a, b in zip(jpm.w + jpm.r, tpm.w + tpm.r):
        assert _rel(a, b) <= TOL
    assert _rel(jpm.transform(pos), tpm.transform(torch.tensor(pos))) <= TOL
    assert _rel(jpm.transform0(pos), tpm.transform0(pos)) <= TOL


@pytest.fixture(scope='module')
def transformed():
    """both legacy meshes after r2c of the same particles, and that
    spectrum (each test sets it back before its transfer)"""
    pos = np.random.RandomState(5).uniform(0, 16, size=(1000, 3))
    jpm, tpm = _pipelines()
    jpm.r2c(pos)
    tpm.r2c(pos)
    return jpm, tpm, jpm.complex, tpm.complex


@pytest.mark.parametrize("name", ['NormalizeDC', 'Laplace', 'SuperLanzcos3',
                                  'PowerSpectrum'] + list(CHAIN))
def test_transfer_functions_match_jax(name, transformed):
    jpm, tpm = transformed[:2]
    jpm.complex, tpm.complex = transformed[2:]
    outs = []
    for pm, T in ((jpm, JTF), (tpm, TransferFunction)):
        if name == 'PowerSpectrum':
            wout, psout = np.zeros(8), np.zeros(8)
            pm.transfer([T.NormalizeDC, T.RemoveDC,
                         T.PowerSpectrum(wout, psout)])
            outs.append((wout, psout))
            continue
        f = {'SuperLanzcos3': lambda: T.SuperLanzcos(1),
             'Gaussian': lambda: T.Gaussian(1.25),
             'Constant': lambda: T.Constant(2.5)}.get(
                 name, lambda: getattr(T, name))()
        pm.transfer([f])
        outs.append((pm.complex,))
    for ref, got in zip(*outs):
        assert _rel(ref, got) <= TOL
