"""The port's applications and auxiliary modules against the JAX
package's (mirroring tests/test_apps.py and tests/test_aux.py): the
gravpm in its catalog and lattice modes (fft='xla' and 'mxu'),
its bigfile and npz snapshots and read_ic, Klein-Gordon, LIC, QPM,
snapshot_power, strain_tensor, check_grad, the timers and checkpoints,
and the bigfile reader on the in-repo fixture debug-32/IC.

Inputs are made from a seed; f8 unless stated.  Tolerances: gravpm
states and spectra within 1e-8 of max|ref| (f8), the f4 lattice run
with fft='mxu' within 1e-4; Klein-Gordon, LIC, QPM, snapshot_power and
strain_tensor within 1e-10; the bigfile reader bitwise.  The JAX runs
are shared between tests (module fixtures): each jitted configuration
costs seconds to compile.
"""
import glob
import os
import re

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pmesh_tpu import ParticleMesh as JaxPM
from pmesh_tpu.lic import lic as jlic
from pmesh_tpu.models import gravpm as jgravpm
from pmesh_tpu.models import kleingordon as jkg
from pmesh_tpu.models.cosmology import Planck15 as JPlanck15
from pmesh_tpu.models.qpm import QPM as JQPM
from pmesh_tpu.utils import bigfile as jbf
from pmesh_tpu.utils import measure as jmeasure
from pmesh_tpu_torch import ParticleMesh, convert
from pmesh_tpu_torch.gradcheck import check_grad
from pmesh_tpu_torch.lic import lic as tlic
from pmesh_tpu_torch.models import gravpm as tgravpm
from pmesh_tpu_torch.models import kleingordon as tkg
from pmesh_tpu_torch.models.fastpm import State
from pmesh_tpu_torch.models.qpm import QPM as TQPM
from pmesh_tpu_torch.utils import bigfile as tbf
from pmesh_tpu_torch.utils import checkpoint
from pmesh_tpu_torch.utils import measure as tmeasure
from pmesh_tpu_torch.utils.timers import Timer, Timers

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL_RUN = 1e-8
TOL_FIELD = 1e-10


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


def _spectra_gap(ref, got):
    assert len(ref) == len(got)
    gap = 0.0
    for (a0, k0, p0), (a1, k1, p1) in zip(ref, got):
        assert abs(a0 - a1) < 1e-12
        gap = max(gap, _rel(k0, k1), _rel(p0, p1))
    return gap


# --- gravpm ------------------------------------------------------------------

CATALOG = dict(nmesh=8, boxsize=64.0, boost=2, steps=4, compat='gadget',
               seed=42, resampler='cic', ainit=0.1, afinal=1.0,
               snapshot_times=[0.5], monitor_print=False)
LATTICE = dict(nmesh=16, boxsize=64.0, boost=1, steps=3, resampler='cic',
               lattice=True, ainit=0.1, afinal=0.2, seed=7,
               monitor_print=False)


@pytest.fixture(scope='module')
def catalog_runs(tmp_path_factory):
    """the catalog mode in both packages, bigfile snapshots written"""
    out = {}
    for name, mod, kw in (('jax', jgravpm, {}),
                          ('torch', tgravpm, dict(device='cpu'))):
        d = str(tmp_path_factory.mktemp('catalog_' + name))
        state, spectra = mod.run_sim(output=d, **CATALOG, **kw)
        out[name] = (state, spectra, d)
    return out


def test_gravpm_catalog_matches_jax(catalog_runs):
    js, jspec, _ = catalog_runs['jax']
    ts, tspec, _ = catalog_runs['torch']
    assert isinstance(ts, State)
    Q, S, V = convert.catalog_state_to_numpy(ts)
    assert _rel(js.Q, Q) == 0
    assert _rel(js.S, S) <= TOL_RUN and _rel(js.V, V) <= TOL_RUN
    # a = 0.5 is measured where the loop first passes it
    assert [a for a, _, _ in tspec] == [a for a, _, _ in jspec]
    assert len(tspec) == 2 and tspec[-1][0] == 1.0
    assert _spectra_gap(jspec, tspec) <= TOL_RUN


def test_gravpm_snapshots_and_read_ic(catalog_runs):
    ts, tspec, tdir = catalog_runs['torch']
    _, _, jdir = catalog_runs['jax']
    snaps = sorted(os.listdir(tdir))
    assert snaps == sorted(os.listdir(jdir)) and len(snaps) == 2
    last = os.path.join(tdir, snaps[-1])
    pos, vel, ids, attrs = tgravpm.read_ic(last)
    # the port's snapshot holds its final state bit for bit
    assert np.array_equal(pos, _np(ts.X)) and np.array_equal(vel, _np(ts.V))
    assert np.array_equal(ids, np.arange(8 ** 3))
    assert float(attrs['BoxSize']) == 64.0 and float(attrs['Time']) == 1.0
    assert list(attrs['TotNumPart']) == [0, 8 ** 3, 0, 0, 0, 0]
    # the same block layout as the JAX package's, the values within tol
    jlast = os.path.join(jdir, snaps[-1])
    assert tbf.BigFile(last).blocks == jbf.BigFile(jlast).blocks
    jpos, jvel, jids, _ = jgravpm.read_ic(jlast)
    assert _rel(jpos, pos) <= TOL_RUN and _rel(jvel, vel) <= TOL_RUN
    k = tbf.BigFile(last)['PowerSpectrum/k'].read()
    assert np.array_equal(k, tspec[-1][1])


def test_gravpm_npz_snapshot(tmp_path):
    out = str(tmp_path / 'run')
    state, _ = tgravpm.run_sim(nmesh=8, boxsize=64.0, boost=1, steps=3,
                               monitor_print=False, resampler='cic',
                               output=out, snapshot_format='npz',
                               device='cpu')
    files = glob.glob(out + "/snapshot_*.npz")
    assert len(files) == 1
    with np.load(files[0]) as d:
        assert np.array_equal(d['Position'], _np(state.X))
        assert d['Velocity'].shape == (512, 3)


def test_gravpm_gradient_mode_matches_jax(catalog_runs):
    kw = dict(CATALOG, force_mode='gradient')
    js, jspec = jgravpm.run_sim(**kw)
    ts, tspec = tgravpm.run_sim(device='cpu', **kw)
    assert _rel(js.S, ts.S) <= TOL_RUN and _rel(js.V, ts.V) <= TOL_RUN
    assert _spectra_gap(jspec, tspec) <= TOL_RUN
    with pytest.raises(ValueError):
        tgravpm.run_sim(force_mode='curl', device='cpu', **CATALOG)


def test_gravpm_lattice_matches_jax(tmp_path):
    """the lattice mode with fft='xla' in f8, and its bounds"""
    kw = dict(LATTICE, snapshot_times=[0.15])
    (jd, jv), jspec = jgravpm.run_sim(**kw)
    timers = Timers()
    (td, tv), tspec = tgravpm.run_sim(device='cpu', timers=timers,
                                      output=str(tmp_path), **kw)
    assert max(_rel(a, b) for a, b in zip(jd + jv, td + tv)) <= TOL_RUN
    assert _spectra_gap(jspec, tspec) <= TOL_RUN
    assert len(tspec) == 2
    assert timers['nbody'].count == 2 and timers['measure'].count == 2
    with np.load(str(tmp_path / 'snapshot_a0.2000.npz')) as d:
        assert np.array_equal(d['DispY'], _np(td[1]))
    with pytest.raises(ValueError, match='boost=1'):
        tgravpm.run_sim(**dict(LATTICE, boost=2), device='cpu')


def test_gravpm_lattice_mxu_matches_jax():
    """the lattice mode with fft='mxu' (f4; the port's plain DFT passes
    on the CPU, the JAX package's Pallas kernels in interpret mode)"""
    kw = dict(LATTICE, dtype='f4', fft='mxu')
    (jd, jv), jspec = jgravpm.run_sim(**kw)
    (td, tv), tspec = tgravpm.run_sim(device='cpu', **kw)
    assert td[0].dtype == torch.float32
    assert max(_rel(a, b) for a, b in zip(jd + jv, td + tv)) <= 1e-4
    assert _spectra_gap(jspec, tspec) <= 1e-4


def test_lattice_bounds_match_jax_rule():
    """lattice_bounds is the JAX package's gravpm rule (gravpm.py:124-127)"""
    pm = ParticleMesh(Nmesh=[8] * 3, BoxSize=32.0, device='cpu')
    rng = np.random.RandomState(0)
    disp = tuple(torch.from_numpy(rng.uniform(0.1, 0.4, (8,) * 3))
                 for _ in range(3))
    from pmesh_tpu_torch.models.fastpm import Solver
    lo, hi = tgravpm.lattice_bounds(Solver(pm), disp, 0.1, 0.3)
    grow = float(JPlanck15.D1(0.3)) / float(JPlanck15.D1(0.1))
    top = max(float(d.max()) for d in disp)
    assert abs(hi - top * 1.3 * grow) <= 1e-12 * hi
    assert abs(lo + top * 1.3 * grow) <= 1e-12 * hi


def test_gravpm_main_cli(tmp_path, capsys):
    state, spectra = tgravpm.main(
        ['--nmesh', '8', '--boost', '1', '--steps', '2', '--resampler',
         'cic', '--output', str(tmp_path), '--format', 'npz',
         '--device', 'cpu'])
    assert spectra[-1][0] == 1.0
    assert 'Timer nbody' in capsys.readouterr().out
    assert len(glob.glob(str(tmp_path / 'snapshot_*.npz'))) == 1


# --- Klein-Gordon and LIC ----------------------------------------------------

def test_kleingordon_matches_jax_and_monitor_loop():
    jpm = JaxPM(BoxSize=32.0, Nmesh=[32, 32])
    tpm = ParticleMesh(BoxSize=32.0, Nmesh=[32, 32], device='cpu')
    ju, jdu = jkg.ring_soliton_ic(jpm)
    tu, tdu = tkg.ring_soliton_ic(tpm)
    assert _rel(ju, tu) <= TOL_FIELD
    steps = np.linspace(0, 1.0, 21)
    jr = jkg.kgsolver(steps, ju, jdu, lambda u: jnp.sin(u))
    tr = tkg.kgsolver(steps, tu, tdu, torch.sin)
    assert _rel(jr, tr) <= TOL_FIELD
    seen = []
    tr2 = tkg.kgsolver(steps, tu, tdu, torch.sin,
                       monitor=lambda t, dt, uk, duk: seen.append(t))
    assert len(seen) == 21
    assert _rel(tr, tr2) <= 1e-12
    # a non-uniform grid takes the factors of each step
    steps = np.concatenate([np.linspace(0, 0.5, 6), [0.6, 0.75, 1.0]])
    jr = jkg.kgsolver(steps, ju, jdu, lambda u: jnp.sin(u))
    tr = tkg.kgsolver(steps, tu, tdu, torch.sin)
    assert _rel(jr, tr) <= TOL_FIELD


def test_kleingordon_small_amplitude_dispersion():
    """linear limit: a single k = 1 mode returns after one period
    2 pi / sqrt(2)"""
    pm = ParticleMesh(BoxSize=2 * np.pi * 4, Nmesh=[16, 16], device='cpu')
    kf = 2 * np.pi / float(pm.BoxSize[0])
    x = pm.create_coords('real')[0]
    A = 1e-3
    u = pm.create(type='real', value=A * torch.cos(kf * 4 * x))
    du = pm.create(type='real')
    period = 2 * np.pi / np.sqrt(2.0)
    r = tkg.kgsolver(np.linspace(0, period, 200), u, du, lambda u: 0 * u)
    np.testing.assert_allclose(r.numpy(), u.numpy(), atol=A * 0.05)


def test_kleingordon_main_writes_a_preview(tmp_path):
    out = str(tmp_path / 'kg.npz')
    u = tkg.main(['--nmesh', '16', '--steps', '5', '--tmax', '0.5',
                  '--output', out, '--device', 'cpu'])
    with np.load(out) as d:
        assert np.array_equal(d['u'], u.preview(axes=(0, 1)))


def test_lic_matches_jax():
    jpm = JaxPM(BoxSize=8.0, Nmesh=[16, 16])
    tpm = ParticleMesh(BoxSize=8.0, Nmesh=[16, 16], device='cpu')
    jx, tx = jpm.create_coords('real'), tpm.create_coords('real')
    jv = [jpm.create(type='real', value=jnp.broadcast_to(v, (16, 16)))
          for v in (-jx[1], jx[0])]
    tv = [tpm.create(type='real', value=torch.broadcast_to(v, (16, 16)))
          for v in (-tx[1], tx[0])]
    kw = dict(kernel=lambda s: 1.0 - abs(s), length=4.0, ds=1.0,
              resampler='linear')
    jr, tr = jlic(jv, **kw), tlic(tv, **kw)
    assert np.isfinite(tr.numpy()).all()
    assert _rel(jr, tr) <= TOL_FIELD


# --- QPM, measurements, gradcheck, timers, checkpoints, bigfile --------------

def test_qpm_run_events_match_jax():
    rng = np.random.RandomState(42)
    pos = rng.uniform(0, 64, size=(64, 3))
    Ps = {}
    events = {}
    for name, cls, conv, kw in (
            ('jax', JQPM, jnp.asarray, {}),
            ('torch', TQPM, torch.from_numpy, dict(device='cpu'))):
        qpm = cls(None, BoxSize=64.0, Nmesh=16, a0=0.5, dtype='f8', **kw)
        P = {'Position': conv(pos), 'Velocity': conv(np.zeros((64, 3))),
             'Accel': conv(np.zeros((64, 3))), 'Mass': 1.0}
        events[name] = [(e, round(float(a), 12)) for e, a in qpm.run(
            P, aout=[0.8])]
        Ps[name] = P
    assert events['torch'] == events['jax']
    assert TQPM.WRITE_SNAPSHOT in [e for e, _ in events['torch']]
    for key in ('Position', 'Velocity', 'Accel'):
        assert _rel(Ps['jax'][key], Ps['torch'][key]) <= TOL_FIELD


def test_snapshot_power_and_strain_match_jax():
    rng = np.random.RandomState(42)
    pos = rng.uniform(0, 64, size=(4096, 3))
    jk, jp, jn = jmeasure.snapshot_power(pos, BoxSize=64.0, Nmesh=16,
                                         resampler='cic', Nbins=4)
    tk, tp, tn = tmeasure.snapshot_power(pos, BoxSize=64.0, Nmesh=16,
                                         resampler='cic', Nbins=4,
                                         device='cpu')
    assert _rel(jk, tk) <= TOL_FIELD and _rel(jp, tp) <= TOL_FIELD
    assert np.array_equal(_np(jn), _np(tn))
    assert np.abs(_np(tp)[1:3]).max() < 64.0 ** 3 / 4096 * 1.5
    pos = rng.uniform(0, 16, size=(128, 3))
    js = jmeasure.strain_tensor(pos, BoxSize=16.0, Nmesh=16, smoothing=1.5)
    ts = tmeasure.strain_tensor(pos, BoxSize=16.0, Nmesh=16, smoothing=1.5,
                                device='cpu')
    assert ts.shape == (128, 6)
    assert _rel(js, ts) <= TOL_FIELD


def test_check_grad_harness():
    from pmesh_tpu.gradcheck import check_grad as jcheck_grad
    pm = ParticleMesh(BoxSize=8.0, Nmesh=[8, 8], device='cpu')
    jpm = JaxPM(BoxSize=8.0, Nmesh=[8, 8])
    pos = np.random.RandomState(42).uniform(1, 7, size=(4, 2))

    def obj(p):
        return pm.paint(p).r2c().cnorm() * 1e2
    ag, ng = check_grad(obj, pos, eps=1e-5, rtol=1e-4, atol=1e-7,
                        device='cpu')
    assert ag.shape == ng.shape == (8,)
    jag, jng = jcheck_grad(lambda p: jpm.paint(p).r2c().cnorm() * 1e2, pos,
                           eps=1e-5, rtol=1e-4, atol=1e-7)
    assert _rel(jag, ag) <= TOL_RUN and _rel(jng, ng) <= 1e-6
    check_grad(obj, torch.from_numpy(pos), eps=1e-5, rtol=1e-4, atol=1e-7,
               indices=[0, 5])


def test_check_grad_catches_wrong_gradient():
    class Wrong(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            ctx.save_for_backward(x)
            return torch.sin(x).sum()

        @staticmethod
        def backward(ctx, g):
            x, = ctx.saved_tensors
            return 2.0 * torch.cos(x) * g    # wrong factor

    with pytest.raises(AssertionError):
        check_grad(Wrong.apply, np.array([0.3, 0.7]), rtol=1e-4,
                   device='cpu')
    check_grad(lambda x: torch.sin(x).sum(), np.array([0.3, 0.7]),
               rtol=1e-4, device='cpu')


def test_central_difference_of_a_complex_input():
    """a complex x is stepped in both parts: the differences of
    Re(conj(c) z) + |z|^2 are c + 2 z"""
    from pmesh_tpu_torch.gradcheck import central_difference
    rng = np.random.RandomState(7)
    z = rng.normal(size=(3, 2)) + 1j * rng.normal(size=(3, 2))
    c = torch.from_numpy(rng.normal(size=(3, 2))
                         + 1j * rng.normal(size=(3, 2)))

    def obj(x):
        return (c.conj() * x).real.sum() + (x.abs() ** 2).sum()
    idx, g = central_difference(obj, z, eps=1e-6, indices=[0, 3, 5],
                                device='cpu')
    assert g.dtype == complex
    want = (c.numpy() + 2 * z).reshape(-1)[idx]
    np.testing.assert_allclose(g, want, rtol=1e-8, atol=1e-8)


def test_timers():
    t = Timers()
    with t['phase1']:
        _ = torch.zeros(16) + 1
    with t['phase1']:
        pass
    rep = t.report()
    assert rep['phase1'][1] == 2 and rep['phase1'][0] >= 0
    assert 'phase2' not in rep
    assert 'phase1' in repr(t) and isinstance(t['phase1'], Timer)


def test_checkpoint_npz(tmp_path):
    """the npz snapshot round trip, and the same file format as the JAX
    package's: each package reads the other's file"""
    from pmesh_tpu.models.fastpm import State as JState
    from pmesh_tpu.utils import checkpoint as jcheckpoint
    rng = np.random.RandomState(42)
    arrays = (rng.uniform(0, 8, (16, 3)), rng.normal(size=(16, 3)) * 0.1,
              rng.normal(size=(16, 3)))
    Q, S, V = (torch.from_numpy(a) for a in arrays)
    fn = str(tmp_path / "snap.npz")
    checkpoint.save_npz(fn, State(Q, S, V), a=0.5)
    state2, a = checkpoint.load_npz(fn, device='cpu')
    assert a == 0.5
    assert torch.equal(state2.V, V) and torch.equal(state2.Q, Q)
    np.testing.assert_allclose(state2.S.numpy(), S.numpy(), atol=1e-12)
    jstate, ja = jcheckpoint.load_npz(fn)
    assert ja == 0.5 and _rel(jstate.S, state2.S) == 0
    jfn = str(tmp_path / "jax.npz")
    jcheckpoint.save_npz(jfn, JState(*(jnp.asarray(x) for x in arrays)),
                         a=0.25)
    state3, a3 = checkpoint.load_npz(jfn, device='cpu')
    assert a3 == 0.25 and _rel(jstate.Q, state3.Q) == 0
    assert _rel(arrays[2], state3.V) == 0


def test_checkpoint_state(tmp_path):
    rng = np.random.RandomState(42)
    Q = torch.from_numpy(rng.uniform(0, 8, (16, 3)))
    path = str(tmp_path / "ckpt.pt")
    checkpoint.save_state(path, State(Q, Q * 0.1, Q * 0.2),
                          extra={'a': np.float64(0.5), 'step': 3})
    state2, extra = checkpoint.restore_state(path, device='cpu')
    assert torch.equal(state2.Q, Q) and torch.equal(state2.V, Q * 0.2)
    assert float(extra['a']) == 0.5 and int(extra['step']) == 3


def test_bigfile_reads_the_fixture_bitwise():
    """the port's reader on debug-32/IC, every block and the attributes,
    bitwise the JAX package's reader"""
    path = os.path.join(REPO, 'debug-32', 'IC')
    tf, jf = tbf.BigFile(path), jbf.BigFile(path)
    assert tf.blocks == jf.blocks and '1/Position' in tf
    for name in tf.blocks:
        a, b = tf[name].read(), jf[name].read()
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert tf['1/Position'].read(100, 50).tobytes() \
        == jf['1/Position'].read(100, 50).tobytes()
    ta, ja = tf.attrs, jf.attrs
    assert sorted(ta) == sorted(ja)
    assert all(np.array_equal(ta[k], ja[k]) for k in ta)
    pos, vel, ids, attrs = tgravpm.read_ic(path)
    assert pos.shape == (32 ** 3, 3) and float(attrs['BoxSize']) == 128.0


def test_bigfile_roundtrip_and_gadget_layout(tmp_path):
    rng = np.random.RandomState(0)
    pos = rng.uniform(0, 100, (1000, 3))
    ids = np.arange(1000, dtype='i8')
    root = str(tmp_path / 'snap')
    tbf.write_block(root, 'header', data=None,
                    attrs={'BoxSize': 100.0,
                           'TotNumPart': np.array([0, 1000], dtype='i8')})
    tbf.write_block(root, '1/Position', pos)
    tbf.write_block(root, '1/ID', ids)
    f = tbf.BigFile(root)
    assert set(f.blocks) == {'header', '1/Position', '1/ID'}
    assert np.array_equal(f['1/Position'].read(), pos)
    assert np.array_equal(jbf.read_block(root, '1/ID'), ids)
    assert float(f.attrs['BoxSize']) == 100.0
    hdr = open(os.path.join(root, '1/ID/header')).read()
    m = re.search(r"000000: (\d+) : (\d+) : (\d+)", hdr)
    s = int(m.group(2))
    assert int(m.group(3)) == s % 65536 + s // 65536
    with pytest.raises(ValueError):
        tbf.write_block(root, 'cube', np.zeros((2, 2, 2)))
