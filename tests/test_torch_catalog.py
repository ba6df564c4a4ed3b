"""The port's field core and catalog FastPM path against the JAX
package's, on the same numpy inputs made from a seed (8^3 meshes, the
force mesh 16^3 with B = 2; f8 unless stated).

Tolerances: the transfers, cdot/cnorm/csum, measure_power/fftpower,
the power spectra and GridIC within 1e-10 of max|ref|; linear_field and
Solver.lpt(order=2) within 1e-10; Solver.force in both modes and
force_staged within 1e-8; a 3-step nbody within 1e-8; the catalog force
against the port's own force_lattice(fft='xla') within 1e-10 (the JAX
package's identity, tests/test_fastpm_lattice.py); in f4 the same run
within 1e-4.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pmesh_tpu import ParticleMesh as JaxPM
from pmesh_tpu.models import cosmology as jcosmo
from pmesh_tpu.models import fastpm as jfastpm
from pmesh_tpu.models import genic as jgenic
from pmesh_tpu.models import powerspectrum as jps
from pmesh_tpu.ops import power as jpower
from pmesh_tpu.ops import transfer as jtf
from pmesh_tpu_torch import ParticleMesh, convert
from pmesh_tpu_torch.models import cosmology as tcosmo
from pmesh_tpu_torch.models import fastpm as tfastpm
from pmesh_tpu_torch.models import genic as tgenic
from pmesh_tpu_torch.models import powerspectrum as tps
from pmesh_tpu_torch.ops import power as tpower
from pmesh_tpu_torch.ops import transfer as ttf

torch.set_num_threads(1)

N = 8
BOX = 32.0
STEPS = np.linspace(0.1, 0.4, 4)    # 3 KDK steps
A0 = 0.1


def _rel(ref, got):
    ref = np.asarray(ref)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    assert ref.shape == got.shape
    scale = np.abs(ref).max()
    return np.abs(ref - got).max() / (scale if scale > 0 else 1.0)


def _meshes(dtype='f8', box=BOX):
    jpm = JaxPM(Nmesh=[N] * 3, BoxSize=box, dtype=dtype)
    tpm = ParticleMesh(Nmesh=[N] * 3, BoxSize=box, dtype=dtype, device='cpu')
    return jpm, tpm


def _complex(jpm, tpm, seed=1):
    rng = np.random.RandomState(seed)
    x = rng.normal(size=(N,) * 3)
    jc = jpm.create(type='real', value=jnp.asarray(x)).r2c()
    return jc, convert.field_from_numpy(tpm, np.asarray(jc.value))


TRANSFERS = {
    'laplace': (lambda tf: tf.laplace(), 'wavenumber'),
    'poisson': (lambda tf: tf.poisson(), 'wavenumber'),
    'gaussian': (lambda tf: tf.gaussian(2.5), 'wavenumber'),
    'longrange': (lambda tf: tf.longrange(1.5), 'wavenumber'),
    'longrange0': (lambda tf: tf.longrange(0), 'wavenumber'),
    'constant': (lambda tf: tf.constant(2.5), 'wavenumber'),
    'remove_dc': (lambda tf: tf.remove_dc(), 'wavenumber'),
    'normalize_dc': (lambda tf: tf.normalize_dc(), 'wavenumber'),
    'super_lanzcos_diff': (lambda tf: tf.super_lanzcos_diff(1), 'circular'),
    'super_lanzcos_diff0': (lambda tf: tf.super_lanzcos_diff(2, order=0),
                            'circular'),
    'cic_decompensate': (lambda tf: tf.cic_decompensate(), 'circular'),
    'gradient': (lambda tf: tf.gradient(0), 'wavenumber'),
    'force_transfer': (lambda tf: tf.force_transfer(2), 'wavenumber'),
    'dx1_transfer': (lambda tf: tf.dx1_transfer(1), 'wavenumber'),
}


@pytest.mark.parametrize("name", sorted(TRANSFERS))
def test_transfer_matches_jax(name):
    jpm, tpm = _meshes()
    jc, tc = _complex(jpm, tpm)
    jc.value = jc.value + 0.25     # a DC mode normalize_dc can divide by
    tc.value = tc.value + 0.25
    make, kind = TRANSFERS[name]
    ref = jc.apply(make(jtf), kind=kind)
    got = tc.apply(make(ttf), kind=kind)
    assert _rel(ref.value, got.value) <= 1e-10


def test_reductions_and_arithmetic_match_jax():
    jpm, tpm = _meshes()
    jc, tc = _complex(jpm, tpm, 2)
    jc2, tc2 = _complex(jpm, tpm, 3)
    rng = np.random.RandomState(4)
    x, y = rng.normal(size=(2,) + (N,) * 3)
    jr = jpm.create(type='real', value=jnp.asarray(x))
    tr = convert.field_from_numpy(tpm, x)
    jr2 = jpm.create(type='real', value=jnp.asarray(y))
    tr2 = convert.field_from_numpy(tpm, y)
    metric = (lambda k: k ** 2, lambda k: k ** 2)
    pairs = [
        (jr.csum(), tr.csum()), (jr.cmean(), tr.cmean()),
        (jr.cdot(jr2), tr.cdot(tr2)), (jr.cnorm(), tr.cnorm()),
        (jc.cnorm(), tc.cnorm()), (jc.cdot(jc2), tc.cdot(tc2)),
        (jc.cnorm(metric=metric[0]), tc.cnorm(metric=metric[1])),
        (jc.cdot(jc2, metric=metric[0]), tc.cdot(tc2, metric=metric[1])),
    ]
    for ref, got in pairs:
        assert abs(complex(got) - complex(ref)) <= 1e-10 * abs(complex(ref))
    # arithmetic keeps the field type; a comparison gives a tensor
    for op in (lambda a, b: a + b, lambda a, b: a - 2.0 * b,
               lambda a, b: (a * b) / 3.0, lambda a, b: -a + abs(b),
               lambda a, b: 1.0 - a ** 2):
        ref, got = op(jr, jr2), op(tr, tr2)
        assert type(got).__name__ == 'RealField'
        assert _rel(ref.value, got.value) <= 1e-12
    assert torch.equal(tr == tr, torch.ones((N,) * 3, dtype=torch.bool))
    c = tr.copy()
    c += 1.0
    assert _rel(jr.value + 1.0, c.value) <= 1e-15 and c is not tr
    # cast: real -> complex -> real is the identity; out= rebinds
    back = tr.cast('complex').cast('real')
    assert _rel(x, back.value) <= 1e-12
    out = tpm.create(type='untransposedcomplex')
    assert tr.cast('untransposedcomplex', out=out) is out
    assert _rel(jr.cast('untransposedcomplex').value, out.value) <= 1e-12


def test_power_matches_jax():
    jpm, tpm = _meshes()
    rng = np.random.RandomState(5)
    x = rng.uniform(0.5, 1.5, size=(N,) * 3)
    jr = jpm.create(type='real', value=jnp.asarray(x))
    tr = convert.field_from_numpy(tpm, x)
    for kw in (dict(), dict(Nbins=3), dict(kedges=np.array([0.05, 0.3, 0.6])),
               dict(normalize=False, remove_shotnoise=2.0)):
        ref = jpower.fftpower(jr, **kw)
        got = tpower.fftpower(tr, **kw)
        for r, g in zip(ref, got):
            assert _rel(r, g) <= 1e-10
    jc, tc = _complex(jpm, tpm, 6)
    for r, g in zip(jpower.measure_power(jc, dk=0.3),
                    tpower.measure_power(tc, dk=0.3)):
        assert _rel(r, g) <= 1e-10


def test_power_spectra_and_cosmology_match_jax():
    k = np.logspace(-4, 1.5, 200)
    k[0] = 0.0
    jeh = jps.EHPower(jcosmo.Planck15, redshift=0.5)
    teh = tps.EHPower(tcosmo.Planck15, redshift=0.5)
    assert _rel(jeh(jnp.asarray(k)), teh(torch.from_numpy(k))) <= 1e-10
    table_k = np.logspace(-3, 1, 40)
    table_p = 1e4 * table_k / (1 + (table_k / 0.02) ** 2.5)
    jt = jps.PowerSpectrum(table_k, table_p, sigma8=0.8)
    tt = tps.PowerSpectrum(table_k, table_p, sigma8=0.8)
    assert _rel(jt(jnp.asarray(k)), tt(torch.from_numpy(k))) <= 1e-10
    assert abs(float(tps.sigma_r(tt)) - 0.8) <= 1e-10
    jn = jps.normalize_sigma8(jeh, 0.7)
    tn = tps.normalize_sigma8(teh, 0.7)
    assert _rel(jn(jnp.asarray(k)), tn(torch.from_numpy(k))) <= 1e-10
    a = np.array([0.1, 0.5, 1.0])
    for name in ('efunc', 'Om', 'Gp2', 'gp2', 'Gf2', 'gf2'):
        ref = np.asarray(getattr(jcosmo.Planck15, name)(jnp.asarray(a)))
        got = getattr(tcosmo.Planck15, name)(a)
        np.testing.assert_allclose(got, ref, rtol=1e-10)
    np.testing.assert_allclose(tcosmo.Planck15.Ea(np.array([0.0, 1.0])),
                               np.asarray(jcosmo.Planck15.Ea(
                                   jnp.asarray([0.0, 1.0]))), rtol=1e-12)


def test_window_resize_and_compensation():
    from pmesh_tpu import window as jwin
    from pmesh_tpu_torch import window as twin
    jpm, tpm = _meshes()
    jc, tc = _complex(jpm, tpm, 7)
    for name, support in (('tsc', -1), ('cic', 3.5), ('lanczos2', 6)):
        jr = jwin.FindResampler(name).resize(support) if support > 0 \
            else jwin.FindResampler(name)
        tr = twin.FindResampler(name).resize(support) if support > 0 \
            else twin.FindResampler(name)
        assert tr.support == jr.support
        ref = jc.apply(jr.get_compensation(), kind='circular')
        got = tc.apply(tr.get_compensation(), kind='circular')
        assert _rel(ref.value, got.value) <= 1e-10
    a = twin.Affine(3, scale=2.0, translate=1.0, period=8)
    assert list(a.rescale(0.5).scale) == [1.0] * 3
    assert list(a.shift(2).translate) == [3.0] * 3


def test_resampler_paint_readout_resized_match_jax():
    from pmesh_tpu import window as jwin
    from pmesh_tpu_torch import window as twin
    rng = np.random.RandomState(8)
    pos = rng.uniform(0, N, size=(100, 3))
    mesh = rng.normal(size=(N,) * 3)
    jr = jwin.FindResampler('tsc').resize(4.5)
    tr = twin.FindResampler('tsc').resize(4.5)
    jt = jwin.Affine(3, period=N)
    tt = twin.Affine(3, period=N)
    ref = jr.paint(jnp.zeros((N,) * 3), jnp.asarray(pos), transform=jt)
    got = tr.paint(torch.zeros((N,) * 3, dtype=torch.float64),
                   torch.from_numpy(pos), transform=tt)
    assert _rel(ref, got) <= 1e-10
    ref = jr.readout(jnp.asarray(mesh), jnp.asarray(pos), transform=jt)
    got = tr.readout(torch.from_numpy(mesh), torch.from_numpy(pos),
                     transform=tt)
    assert _rel(ref, got) <= 1e-10


def test_particle_grid_layout_and_field_paint():
    jpm, tpm = _meshes()
    jq, jid = jpm.generate_uniform_particle_grid(shift=0.25, return_id=True)
    tq, tid = tpm.generate_uniform_particle_grid(shift=0.25, return_id=True)
    assert _rel(jq, tq) <= 1e-15
    assert np.array_equal(np.asarray(jid), tid.numpy())
    assert np.array_equal(np.asarray(jpm.mesh_coordinates('i4')),
                          tpm.mesh_coordinates('i4').numpy())
    layout = tpm.decompose(tq)
    assert layout.exchange(tq) is tq and layout.gather(tid) is tid
    rng = np.random.RandomState(9)
    pos = rng.uniform(0, BOX, size=(300, 3))
    mass = rng.uniform(size=300)
    hsml = rng.uniform(0.5, 1.2, size=300)
    ref = jpm.paint(jnp.asarray(pos), mass=jnp.asarray(mass),
                    hsml=jnp.asarray(hsml))
    got = tpm.paint(torch.from_numpy(pos), mass=torch.from_numpy(mass),
                    hsml=torch.from_numpy(hsml), layout=tpm.decompose(pos))
    assert _rel(ref.value, got.value) <= 1e-10
    # hold=True adds to out; RealField.paint is that
    got2 = got.copy()
    got2.paint(torch.from_numpy(pos), mass=torch.from_numpy(mass),
               hold=True, resampler='tsc')
    ref2 = jpm.paint(jnp.asarray(pos), mass=jnp.asarray(mass),
                     resampler='tsc', out=ref.copy(), hold=True)
    assert _rel(ref2.value, got2.value) <= 1e-10
    for d in (None, 0, 2):
        ref = ref2.readout(jnp.asarray(pos), gradient=d, resampler='pcs')
        got = got2.readout(torch.from_numpy(pos), gradient=d, resampler='pcs',
                           layout=tpm.decompose(pos))
        assert _rel(ref, got) <= 1e-10


def test_gridic_matches_jax():
    jP = jps.EHPower(jcosmo.Planck15)
    tP = tps.EHPower(tcosmo.Planck15)
    ref, rstats = jgenic.GridIC(jP, BOX, N, 0.1, seed=17, order=1)
    got, gstats = tgenic.GridIC(tP, BOX, N, 0.1, seed=17, order=1,
                                device='cpu')
    for key in ('Position', 'Q', 'ZA', '2LPT', 'ICDensity'):
        assert _rel(ref[key], got[key]) <= 1e-10, key
    assert np.array_equal(np.asarray(ref['ID']), got['ID'].numpy())
    for key in ('stdZA', 'std2LPT'):
        assert abs(gstats[key] - rstats[key]) <= 1e-10 * rstats[key]
    if not torch.cuda.is_available():
        # the default device is the card's: without one, GridIC raises
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tgenic.GridIC(tP, BOX, N, 0.1, seed=17)


class _Run(object):
    """One catalog run on both sides: linear field, 2LPT, the forces on
    the LPT state, and 3 KDK steps."""

    def __init__(self, dtype):
        jpm, tpm = _meshes(dtype)
        self.js = jfastpm.Solver(jpm, B=2)
        self.ts = tfastpm.Solver(tpm, B=2)
        jP = jps.EHPower(jcosmo.Planck15)
        tP = tps.EHPower(tcosmo.Planck15)
        self.jd = self.js.linear_field(jP, 42)
        self.td = self.ts.linear_field(tP, 42)
        self.jlpt = self.js.lpt(self.jd, A0, order=2)
        self.tlpt = self.ts.lpt(self.td, A0, order=2)
        self.jf = {m: self.js.force(self.jlpt.X, mode=m)
                   for m in ('spectral', 'gradient')}
        self.tf = {m: self.ts.force(self.tlpt.X, mode=m)
                   for m in ('spectral', 'gradient')}
        self.jstaged = self.js.force_staged(self.jlpt.X)
        self.tstaged = self.ts.force_staged(self.tlpt.X)
        self.jend = self.js.nbody(self.jlpt, STEPS)
        self.tend = self.ts.nbody(self.tlpt, STEPS)


@pytest.fixture(scope='module')
def run_f8():
    return _Run('f8')


@pytest.fixture(scope='module')
def run_f4():
    return _Run('f4')


def test_linear_field_and_lpt_match_jax(run_f8):
    r = run_f8
    assert _rel(r.jd.value, r.td.value) <= 1e-10
    for a in ('Q', 'S', 'V'):
        assert _rel(getattr(r.jlpt, a), getattr(r.tlpt, a)) <= 1e-10, a
    assert r.tlpt.S.dtype == torch.float64
    # order 1 and the module-level lpt
    ref = jfastpm.lpt(r.js.pm, r.jd, 0.2, order=1, shift=0.5)
    got = tfastpm.lpt(r.ts.pm, r.td, 0.2, order=1, shift=0.5)
    for a in ('Q', 'S', 'V'):
        assert _rel(getattr(ref, a), getattr(got, a)) <= 1e-10, a


@pytest.mark.parametrize("mode", ['spectral', 'gradient', 'staged'])
def test_force_matches_jax(run_f8, mode):
    r = run_f8
    if mode == 'staged':
        assert _rel(r.jstaged, r.tstaged) <= 1e-8
        assert _rel(r.jf['spectral'], r.tstaged) <= 1e-8
    else:
        assert _rel(r.jf[mode], r.tf[mode]) <= 1e-8


def test_nbody_matches_jax(run_f8):
    r = run_f8
    assert _rel(r.jend.S, r.tend.S) <= 1e-8
    assert _rel(r.jend.V, r.tend.V) <= 1e-8
    assert torch.equal(r.tend.Q, r.tlpt.Q)


def test_nbody_monitor_equals_loop(run_f8):
    r = run_f8
    seen = []
    end = r.ts.nbody(r.tlpt, STEPS,
                     monitor=lambda a, s: seen.append((a, s.S.clone())))
    assert [a for a, _ in seen] == list(STEPS[1:])
    assert torch.equal(end.S, r.tend.S) and torch.equal(end.V, r.tend.V)
    assert torch.equal(seen[-1][1], r.tend.S)
    # gradient mode runs too, and the state stays finite
    end = r.ts.nbody(r.tlpt, STEPS[:2], force_mode='gradient')
    assert bool(torch.isfinite(end.S).all())


def test_nbody_f4_matches_jax(run_f4):
    r = run_f4
    assert r.tend.S.dtype == torch.float32
    assert _rel(r.jd.value, r.td.value) <= 1e-4
    for mode in ('spectral', 'gradient'):
        assert _rel(r.jf[mode], r.tf[mode]) <= 1e-4
    assert _rel(r.jend.S, r.tend.S) <= 1e-4
    assert _rel(r.jend.V, r.tend.V) <= 1e-4


@pytest.mark.parametrize("mode", ['spectral', 'gradient'])
def test_force_matches_force_lattice(mode):
    """The catalog force at the lattice sites is the lattice force:
    the JAX package's identity (tests/test_fastpm_lattice.py), here in
    the port alone, with cells of 2 box units."""
    tpm = ParticleMesh(Nmesh=[16] * 3, BoxSize=32.0, dtype='f8',
                       device='cpu')
    solver = tfastpm.Solver(tpm)
    rng = np.random.RandomState(3)
    disp = tuple(torch.from_numpy(rng.uniform(-0.4, 0.6, (16,) * 3))
                 for _ in range(3))
    F_lat = solver.force_lattice(disp, bounds=(-0.5, 0.7), mode=mode,
                                 fft='xla')
    Q = tpm.generate_uniform_particle_grid(shift=0.0)
    X = Q + torch.stack([d.reshape(-1) for d in disp], dim=-1) * 2.0
    F = solver.force(X, mode=mode)
    for d in range(3):
        assert _rel(F_lat[d].reshape(-1), F[:, d]) <= 1e-10


def test_catalog_state_convert_round_trip(run_f8):
    r = run_f8
    arrays = tuple(np.asarray(getattr(r.jlpt, a)) for a in ('Q', 'S', 'V'))
    state = convert.catalog_state_from_numpy(*arrays, device='cpu')
    assert isinstance(state, tfastpm.State)
    for a, b in zip(arrays, convert.catalog_state_to_numpy(state)):
        assert np.array_equal(a, b)
    # the JAX package's state carried across runs the port's force
    assert _rel(r.jf['spectral'], r.ts.force(state.X)) <= 1e-8
