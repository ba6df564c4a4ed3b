"""The port's slab-sharded lattice path against the JAX package's
sharded answers: ProcessMesh over torch.distributed, the halo exchange,
the sharded paint and readout, the slab FFT, the sharded ct2 and dense
DFT pipelines (kernel-table row 9) and the Solver's sharded lattice
branches.

The port runs as 4 gloo ranks on the CPU (``parallel/launch.spawn``,
the plain versions of the kernels), each on its own x slab; the JAX
package runs ``ProcessMesh(jax.devices()[:4])`` on the virtual devices
of ``tests/conftest.py``, with its Pallas kernels in interpret mode
(``impl='pallas'``) as its own sharded tests run them.  Each rank's
block is held against the matching slice of JAX's global output:

- halo planes, including a halo deeper than one slab: exact;
- paint and readout at 16^3, CIC and TSC, and a window deeper than one
  slab at (8, 16, 16): 1e-6 of max;
- the sharded ct2 forward, force triple and Poisson potential at
  (256, 256, 16) on the same inputs: 3e-6 of max per pass; the forces
  from each side's own forward 2e-5;
- the sharded dense pipeline at 16^3 and (24, 20, 15): the same;
- force_lattice, spectral and gradient, fft='xla' and 'mxu' (dense and
  ct2): 2e-5 of max; a 3-step nbody_lattice from a sharded 2LPT
  lpt_lattice: 1e-4 of max;
- the bf16 forms of the sharded ct2 force against the JAX package's
  sharded forms, its bf16 products rounded as the MXU rounds them (the
  ``tpu_rounding`` patch of tests/test_torch_fft_bf16.py): 1e-2 of max
  and 0.15 of the rms of the rounding itself.

The ranks start once for the module, in a thread, while the JAX side
computes; JAX's interpret-mode kernels at the ct2 slab run in small
blocks (``slab_blocks``), which keeps their compile short.
"""
import concurrent.futures
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax import shard_map
from jax.sharding import NamedSharding, PartitionSpec as P

from pmesh_tpu import ParticleMesh as JaxPM
from pmesh_tpu.models.fastpm import Solver as JaxSolver
from pmesh_tpu.ops import fft_mxu as jfm
from pmesh_tpu.ops import gridpm as jgp
from pmesh_tpu.parallel import halo as jhalo
from pmesh_tpu.parallel.pmesh import ProcessMesh as JaxProcessMesh
from pmesh_tpu_torch import ParticleMesh
from pmesh_tpu_torch.models.fastpm import Solver
from pmesh_tpu_torch.ops import fft_mxu as fm
from pmesh_tpu_torch.parallel import launch
from pmesh_tpu_torch.parallel.pmesh import ProcessMesh
from torch_sharded_cases import CASES

torch.set_num_threads(1)

RANKS = 4
N = 16
CT2 = (256, 256, 16)
DENSE = [(16, 16, 16), (24, 20, 15)]
DEEP = (8, 16, 16)
HALOS = [(1, 2), (3, 3), (2, 9)]
TOL_PAINT = 1e-6
TOL_PASS = 3e-6
TOL_FORCE = 2e-5
TOL_NBODY = 1e-4
# the bf16 forms' chained criterion and the least rms effect of their
# rounding, as tests/test_torch_fft_bf16.py's
TOL_BF16_MAX, TOL_BF16_RMS, TOL_BF16_ROUNDS = 1e-2, 0.15, 1e-4
DEFAULT = jax.lax.Precision('default')
# (window, bounds): CIC at 8 offsets, TSC at 27, a deep CIC window at
# 5^3 whose x reach (3 planes) passes the 2-plane slabs of DEEP
CIC, TSC, DEEPWIN = ('cic', (0.0, 1.0)), ('tsc', (-0.5, 0.5)), \
    ('cic', (-2.5, 0.5))
FORCE_BOUNDS = (-0.5, 1.5)
FORCE_BOUNDS_CT2 = (0.0, 1.0)
NBODY_STEPS = np.linspace(0.1, 0.2, 4)      # 3 KDK steps
NBODY_BOUNDS = (-1.0, 2.0)


def _rel(ref, got):
    ref, got = np.asarray(ref, np.float64), np.asarray(got, np.float64)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _rel_spectrum(ref, got):
    """a complex spectrum held as (re, im) pairs: the gap over both
    parts, of the largest modulus of either"""
    err = max(np.abs(np.asarray(g, np.float64) - np.asarray(r)).max()
              for r, g in zip(ref, got))
    return float(err / max(np.abs(np.asarray(r)).max() for r in ref))


def _port_tables(shape):
    """(kvecs, poisson_k2) of the port's Solver at ``shape`` (box =
    shape, unit cells): the tables the JAX Solver builds too"""
    s = Solver(ParticleMesh(list(shape), np.asarray(shape, float),
                            dtype='f4', device='cpu'))
    _, pk2, kd, _ = s._mxu_setup()
    return kd, pk2


def _linear_spectrum(n, seed):
    """a real field's half spectrum with P(k) ~ k^-1, scaled to an rms
    displacement of a few hundredths of a cell (numpy)"""
    rng = np.random.RandomState(seed)
    noise = rng.normal(size=(n,) * 3)
    k = np.sqrt(sum(np.meshgrid(*(np.fft.fftfreq(n) ** 2,) * 2
                                + (np.fft.rfftfreq(n) ** 2,),
                                indexing='ij')))
    amp = np.where(k > 0, np.where(k > 0, k, 1.0) ** -0.25, 0.0)
    return (np.fft.rfftn(noise) / n ** 3 * amp * 3.0).astype(np.complex64)


@functools.lru_cache(maxsize=None)
def _inputs():
    rng = np.random.RandomState(7)

    def uni(b, shape=(N,) * 3):
        return tuple(rng.uniform(b[0], b[1], shape).astype('f4')
                     for _ in range(3))

    inp = dict(
        halo=np.arange(N * 3 * 2, dtype='f4').reshape(N, 3, 2),
        disp_cic=uni(CIC[1]), disp_tsc=uni(TSC[1]),
        mass=(1 + 0.2 * rng.normal(size=(N,) * 3)).astype('f4'),
        meshes=tuple(rng.normal(size=(N,) * 3).astype('f4')
                     for _ in range(3)),
        disp_deep=uni(DEEPWIN[1], DEEP),
        mesh_deep=rng.normal(size=DEEP).astype('f4'),
        x=rng.normal(size=(N,) * 3).astype('f4'),
        x_ct2=(1 + 0.3 * rng.normal(size=CT2)).astype('f4'),
        disp_force=uni(FORCE_BOUNDS),
        disp_force_ct2=uni(FORCE_BOUNDS_CT2, CT2),
        dlinear=_linear_spectrum(N, 3))
    for shape in DENSE:
        inp['x_dense', shape] = (1 + 0.3 * rng.normal(size=shape)) \
            .astype('f4')
    # the inverse passes take one spectrum on both sides: the port's
    # single-device forward of the same mesh (the dense one filtered by
    # 1/k^2, as the JAX package's dense inverse expects)
    inp['kd_ct2'], inp['pk2_ct2'] = _port_tables(CT2)
    inp['spec_ct2'] = tuple(t.numpy() for t in fm.fft3_real_forward_half_ct2(
        torch.from_numpy(inp['x_ct2'])))
    for shape in DENSE:
        kd, pk2 = _port_tables(shape)
        r, i = fm.fft3_real_forward_half(torch.from_numpy(
            inp['x_dense', shape]))
        k2 = (np.asarray(pk2[0])[:, None, None]
              + np.asarray(pk2[1])[None, :, None]
              + np.asarray(pk2[2])[None, None, :]).astype('f4')
        invk2 = np.where(k2 > 0, 1 / np.where(k2 > 0, k2, 1), 0) \
            .astype('f4')
        inp['tables', shape] = (kd, pk2)
        inp['spec', shape] = (r.numpy() * invk2, i.numpy() * invk2)
    return inp


def _cases(inp):
    c = [('extend', (inp['halo'], lo, hi)) for lo, hi in HALOS]
    c += [('paint', (inp['disp_cic'], None) + CIC[::-1]),
          ('readout', (inp['meshes'], inp['disp_cic']) + CIC[::-1]),
          ('readout', (inp['meshes'][0], inp['disp_cic']) + CIC[::-1]
           + ('all',)),
          ('paint', (inp['disp_tsc'], inp['mass']) + TSC[::-1]),
          ('readout', (inp['meshes'][0], inp['disp_tsc']) + TSC[::-1]
           + ('all',)),
          ('paint', (inp['disp_deep'], None) + DEEPWIN[::-1]),
          ('readout', (inp['mesh_deep'], inp['disp_deep']) + DEEPWIN[::-1]),
          ('pfft', ([N] * 3, 1.0, inp['x'])),
          ('ct2', (inp['x_ct2'], inp['spec_ct2'], inp['kd_ct2'],
                   inp['pk2_ct2']))]
    for shape in DENSE:
        kd, pk2 = inp['tables', shape]
        c.append(('dense', (inp['x_dense', shape], inp['spec', shape], kd,
                            pk2)))
    for mode, fft in FORCES_16:
        c.append(('force', ([N] * 3, float(N), inp['disp_force'],
                            FORCE_BOUNDS, mode, fft)))
    for mode, fft in FORCES_CT2:
        c.append(('force', (list(CT2), np.asarray(CT2, float),
                            inp['disp_force_ct2'], FORCE_BOUNDS_CT2, mode,
                            fft)))
    c.append(('nbody', ([N] * 3, 64.0, inp['dlinear'], 0.1, NBODY_STEPS,
                        NBODY_BOUNDS)))
    c.append(('comm', ()))
    return c


FORCES_16 = [('spectral', 'xla'), ('gradient', 'xla'), ('spectral', 'mxu')]
FORCES_CT2 = [('spectral', 'mxu'), ('gradient', 'mxu'),
              ('spectral', 'mxu_bf16'), ('spectral', 'mxu_bf16s')]


@pytest.fixture(scope='module', autouse=True)
def slab_blocks():
    """2-plane blocks for the JAX zy kernels at the ct2 slab's shapes and
    1-row blocks for its x-CT kernel, whose planes and rows interpret
    mode unrolls into one kernel body (blocking, not math: as
    tests/test_torch_fft_bf16.py sets them; it cuts JAX's compile of
    the sharded ct2 programs about tenfold)"""
    n0, Zm = CT2[0] // RANKS, CT2[2] // 2
    keys = ['bx:%s:%dx%dx%d' % (t, n0, CT2[1], Zm)
            for t in ('zyf', 'zyi', 'zyid')]
    for k in keys:
        jfm.TUNE[k] = 2
    jfm.TUNE['xct_by'] = 1
    yield
    for k in keys + ['xct_by']:
        jfm.TUNE.pop(k, None)


@pytest.fixture(scope='module')
def port():
    """{case index: [rank results]}, from one 4-rank gloo job started in
    a thread; the fixture returns a function that waits for it"""
    inp = _inputs()
    cases = _cases(inp)
    pool = concurrent.futures.ThreadPoolExecutor(1)
    fut = pool.submit(launch.spawn, CASES + ':run_cases', RANKS, 'gloo', 'cpu',
                      cases)
    pool.shutdown(wait=False)
    names = [name for name, _ in cases]

    def result(k):
        return [r[k] for r in fut.result()]
    result.names = names
    yield result
    fut.result()


def _index(port, name, n=0):
    """the index of the n-th case called ``name``"""
    return [k for k, c in enumerate(port.names) if c == name][n]


def _rows(blocks, axis=0):
    return np.concatenate(blocks, axis)


@pytest.fixture(scope='module')
def jpm():
    return JaxProcessMesh(jax.devices()[:RANKS])


def _sharded(jpm, a, spec=None):
    if isinstance(a, (tuple, list)):
        return tuple(_sharded(jpm, x, spec) for x in a)
    a = jnp.asarray(a)
    return jax.device_put(a, NamedSharding(
        jpm.mesh, spec or P('x', *([None] * (a.ndim - 1)))))


def _np(x):
    if isinstance(x, (tuple, list)):
        return tuple(_np(y) for y in x)
    return np.asarray(x)


# --- ProcessMesh, comm, launch -----------------------------------------------

def test_process_mesh_rules():
    pm = ProcessMesh(device='cpu')
    assert (pm.size, pm.rank, pm.grid, pm.backend) == (1, 0, (1,), None)
    assert pm == ProcessMesh(device='cpu') and not pm.staged
    # a 2-d grid needs npx * npy ranks; one rank makes only the (1, 1)
    with pytest.raises(ValueError, match=r"npx\*npy"):
        ProcessMesh(shape=(2, 2), device='cpu')
    one = ProcessMesh(shape=(1, 1), device='cpu')
    assert (one.grid, one.coords, one.is2d) == ((1, 1), (0, 0), True)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ProcessMesh()
        # the launcher too: its ranks go to the GPU unless told otherwise
        with pytest.raises(RuntimeError, match="device='cpu'"):
            launch.spawn(CASES + ':modules_loaded', 2)
    with pytest.raises(ValueError, match="module:function"):
        launch.spawn('modules_loaded', 2, 'gloo', 'cpu')
    # one rank: the sharded mesh is the single-device mesh
    one = ParticleMesh([8] * 3, 1.0, dtype='f4', procmesh=pm)
    assert not one.sharded and one.device == torch.device('cpu')


def test_collectives(port):
    """the tiled all_to_all, all_gather and all_reduce against numpy;
    gloo on CPU tensors stages nothing"""
    out = port(_index(port, 'comm'))
    full = np.arange(RANKS * 4 * RANKS * 2 * 3, dtype='f4').reshape(
        RANKS * 4, RANKS * 2, 3)
    for r, got in enumerate(out):
        # rank r held x rows r; after the all_to_all the y-chunk r
        np.testing.assert_array_equal(got['a2a'], full[:, 2 * r:2 * r + 2])
        np.testing.assert_array_equal(got['back'], full[4 * r:4 * r + 4])
        np.testing.assert_array_equal(got['gather'], full)
        np.testing.assert_array_equal(got['a2a_bf16'],
                                      got['a2a_bf16_ref'])
        np.testing.assert_array_equal(got['a2a_complex'],
                                      (full + 1j * full)[:, 2 * r:2 * r + 2])
        assert got['sum'] == sum(range(RANKS)) and got['max'] == RANKS - 1 \
            and got['min'] == 0
        assert got['staged'] == {"to_host": 0, "to_device": 0}


def test_spawn_has_no_jax():
    """a spawned rank imports neither jax nor the JAX package"""
    out = launch.spawn(CASES + ':modules_loaded', 2, 'gloo', 'cpu')
    for mods in out:
        assert not [m for m in mods if m == 'jax' or m.startswith('jax.')
                    or m == 'pmesh_tpu' or m.startswith('pmesh_tpu.')]


# --- halo --------------------------------------------------------------------

@pytest.mark.parametrize("lo,hi", HALOS)
def test_halo_extend_matches_jax(port, jpm, lo, hi):
    inp = _inputs()
    fn = shard_map(lambda x: jhalo.extend_x(x, lo, hi, 'x', RANKS)[None],
                   mesh=jpm.mesh, in_specs=P('x', None, None),
                   out_specs=P('x', None, None, None))
    ref = np.asarray(fn(_sharded(jpm, inp['halo'])))
    got = port(HALOS.index((lo, hi)))
    for r in range(RANKS):
        np.testing.assert_array_equal(got[r]['ext'], ref[r])


def test_halo_planes_match_jax(port, jpm):
    inp = _inputs()
    lo, hi = HALOS[0]
    fn = shard_map(lambda x: tuple(a[None] for a in jhalo.halo_planes(
        x, lo, hi, 'x', RANKS)), mesh=jpm.mesh, in_specs=P('x', None, None),
        out_specs=(P('x', None, None, None),) * 2)
    ref = _np(fn(_sharded(jpm, inp['halo'])))
    got = port(0)
    for r in range(RANKS):
        for side in (0, 1):
            np.testing.assert_array_equal(got[r]['planes'][side],
                                          ref[side][r])


# --- paint and readout -------------------------------------------------------

def _jax_paint_readout(jpm, name):
    inp = _inputs()
    kw = dict(impl='pallas', procmesh=jpm)
    if name == 'cic paint':
        return jgp.paint_grid(_sharded(jpm, inp['disp_cic']), bounds=CIC[1],
                              window=CIC[0], **kw)
    if name == 'cic readout 3 meshes':
        return jgp.readout_grid(_sharded(jpm, inp['meshes']),
                                _sharded(jpm, inp['disp_cic']),
                                bounds=CIC[1], window=CIC[0], **kw)
    if name == 'cic readout diffdir=all':
        return jgp.readout_grid(_sharded(jpm, inp['meshes'][0]),
                                _sharded(jpm, inp['disp_cic']),
                                bounds=CIC[1], window=CIC[0], diffdir='all',
                                **kw)
    if name == 'tsc paint, mesh mass':
        return jgp.paint_grid(_sharded(jpm, inp['disp_tsc']),
                              _sharded(jpm, inp['mass']), bounds=TSC[1],
                              window=TSC[0], **kw)
    if name == 'tsc readout diffdir=all':
        return jgp.readout_grid(_sharded(jpm, inp['meshes'][0]),
                                _sharded(jpm, inp['disp_tsc']),
                                bounds=TSC[1], window=TSC[0], diffdir='all',
                                **kw)
    if name == 'deep paint':
        return jgp.paint_grid(_sharded(jpm, inp['disp_deep']),
                              bounds=DEEPWIN[1], window=DEEPWIN[0], **kw)
    return jgp.readout_grid(_sharded(jpm, inp['mesh_deep']),
                            _sharded(jpm, inp['disp_deep']),
                            bounds=DEEPWIN[1], window=DEEPWIN[0], **kw)


PAINT_READOUT = ['cic paint', 'cic readout 3 meshes',
                 'cic readout diffdir=all', 'tsc paint, mesh mass',
                 'tsc readout diffdir=all', 'deep paint', 'deep readout']


@pytest.mark.parametrize("name", PAINT_READOUT)
def test_paint_readout_match_jax(port, jpm, name):
    ref = _jax_paint_readout(jpm, name)
    got = port(len(HALOS) + PAINT_READOUT.index(name))
    if isinstance(ref, (tuple, list)):
        assert len(got[0]) == len(ref)
        for j, rj in enumerate(ref):
            assert _rel(rj, _rows([g[j] for g in got])) <= TOL_PAINT, j
    else:
        assert _rel(ref, _rows(got)) <= TOL_PAINT


# --- FFTs --------------------------------------------------------------------

def test_slab_fft_matches_jax(port, jpm):
    """the ParticleMesh's r2c (y-chunks of the transposed spectrum) and
    c2r on slabs against the JAX package's sharded field transforms"""
    inp = _inputs()
    jp = JaxPM([N] * 3, 1.0, dtype='f4', procmesh=jpm)
    k = jp.create(type='real', value=_sharded(jpm, inp['x'])).r2c()
    ref_k = np.asarray(k.value)
    ref_x = np.asarray(k.c2r().value)
    got = port(_index(port, 'pfft'))
    gk = _rows([g[0] for g in got], axis=1)
    assert np.abs(gk - ref_k).max() <= 1e-6 * np.abs(ref_k).max()
    assert _rel(ref_x, _rows([g[1] for g in got])) <= 1e-6


def _jax_solver(jpm, shape, box, dtype='f4'):
    return JaxSolver(JaxPM(list(shape), box, dtype=dtype, procmesh=jpm))


@functools.lru_cache(maxsize=None)
def _jax_ct2(jpm):
    """JAX's sharded ct2 passes on the same inputs; the calls spell the
    static arguments as its Solver does, so the force tests reuse the
    compiled programs"""
    inp = _inputs()
    s = _jax_solver(jpm, CT2, np.asarray(CT2, float))
    shape, k2np, kd, pmh, ct = s._mxu_setup()
    assert ct and pmh is jpm
    pk2 = tuple(tuple(float(v) for v in k) for k in k2np)
    # replicated, as the Solver's paint hands its density over
    fwd = jfm.fft3_real_forward_half_ct2_sharded(
        jpm, _sharded(jpm, inp['x_ct2'], P()), precision=None,
        spectrum_dtype=None)
    sp = inp['spec_ct2']
    # laid out as JAX's forward lays out its output, so that both
    # inverse calls run one compiled program
    spec = (_sharded(jpm, sp[0], P(None, 'x', None)),
            _sharded(jpm, sp[1], P(None, 'x', None)),
            _sharded(jpm, sp[2], P()), _sharded(jpm, sp[3], P()))
    kw = dict(n2=CT2[2], kvecs=kd, precision=None, poisson_k2=pk2)
    inv = jfm.fft3_real_inverse_grad3_half_ct2_sharded(jpm, *spec, **kw,
                                                       only=None)
    forces = jfm.fft3_real_inverse_grad3_half_ct2_sharded(jpm, *fwd, **kw,
                                                          only=None)
    pot = jfm.fft3_poisson_half_ct2_sharded(jpm, *spec, n2=CT2[2],
                                            poisson_k2=pk2, precision=None)
    return _np(fwd), _np(inv), _np(pot), _np(forces)


@pytest.mark.parametrize("part", ['forward', 'force triple', 'potential'])
def test_ct2_passes_match_jax(port, jpm, part):
    fwd, inv, pot, _ = _jax_ct2(jpm)
    got = port(_index(port, 'ct2'))
    if part == 'forward':
        # the spectrum's y-chunks: chunk r of the permuted y axis
        assert _rel_spectrum(fwd[:2], [_rows([g['fwd'][j] for g in got], 1)
                                       for j in (0, 1)]) <= TOL_PASS
        for g in got:   # the Nyquist plane, replicated
            assert _rel_spectrum(fwd[2:], g['fwd'][2:]) <= TOL_PASS
    elif part == 'force triple':
        for j in range(3):
            assert _rel(inv[j], _rows([g['inv'][j] for g in got])) \
                <= TOL_PASS, j
    else:
        assert _rel(pot, _rows([g['pot'] for g in got])) <= TOL_PASS


def test_ct2_forces_match_jax(port, jpm):
    """each side's forward, then its force triple"""
    forces = _jax_ct2(jpm)[3]
    got = port(_index(port, 'ct2'))
    for j in range(3):
        assert _rel(forces[j], _rows([g['forces'][j] for g in got])) \
            <= TOL_FORCE, j


@functools.lru_cache(maxsize=None)
def _jax_dense(jpm, shape):
    inp = _inputs()
    kd, pk2 = inp['tables', shape]
    fwd = jfm.fft3_real_forward_half_sharded(
        jpm, _sharded(jpm, inp['x_dense', shape]), precision=None)
    spec = tuple(_sharded(jpm, a, P(None, 'x', None))
                 for a in inp['spec', shape])
    inv = jfm.fft3_real_inverse_grad3_half_sharded(
        jpm, *spec, n2=shape[2], kvecs=kd, precision=None)
    # the forces from JAX's own forward, filtered as its Solver does
    k2 = (np.asarray(pk2[0])[:, None, None]
          + np.asarray(pk2[1])[None, :, None]
          + np.asarray(pk2[2])[None, None, :]).astype('f4')
    invk2 = np.where(k2 > 0, 1 / np.where(k2 > 0, k2, 1), 0).astype('f4')
    forces = jfm.fft3_real_inverse_grad3_half_sharded(
        jpm, fwd[0] * invk2, fwd[1] * invk2, n2=shape[2], kvecs=kd,
        precision=None)
    return _np(fwd), _np(inv), _np(forces)


@pytest.mark.parametrize("shape", DENSE)
@pytest.mark.parametrize("part", ['forward', 'force triple'])
def test_dense_passes_match_jax(port, jpm, shape, part):
    """kernel-table row 9: the per-slab zy passes and the x pass on the
    y-chunk, on the same inputs"""
    fwd, inv, _ = _jax_dense(jpm, shape)
    got = port(_index(port, 'dense', DENSE.index(shape)))
    if part == 'forward':
        assert _rel_spectrum(fwd, [_rows([g['fwd'][j] for g in got], 1)
                                   for j in (0, 1)]) <= TOL_PASS
    else:
        for j in range(3):
            assert _rel(inv[j], _rows([g['inv'][j] for g in got])) \
                <= TOL_PASS, j


@pytest.mark.parametrize("shape", DENSE)
def test_dense_forces_match_jax(port, jpm, shape):
    forces = _jax_dense(jpm, shape)[2]
    got = port(_index(port, 'dense', DENSE.index(shape)))
    for j in range(3):
        assert _rel(forces[j], _rows([g['forces'][j] for g in got])) \
            <= TOL_FORCE, j


# --- the Solver --------------------------------------------------------------

@pytest.mark.parametrize("shape,mode,fft",
                         [((N,) * 3,) + f for f in FORCES_16]
                         + [(CT2,) + f for f in FORCES_CT2[:2]])
def test_force_lattice_matches_jax(port, jpm, shape, mode, fft):
    inp = _inputs()
    if shape == CT2:
        _jax_ct2(jpm)   # compiles the passes once for every ct2 case
        k = _index(port, 'force', len(FORCES_16) + FORCES_CT2.index(
            (mode, fft)))
        box, disp = np.asarray(CT2, float), inp['disp_force_ct2']
        bounds = FORCE_BOUNDS_CT2
    else:
        k = _index(port, 'force', FORCES_16.index((mode, fft)))
        box, disp, bounds = float(N), inp['disp_force'], FORCE_BOUNDS
    s = _jax_solver(jpm, shape, box)
    ref = s.force_lattice(_sharded(jpm, disp), bounds, mode=mode, fft=fft)
    got = port(k)
    for j in range(3):
        assert _rel(ref[j], _rows([g[j] for g in got])) <= TOL_FORCE, j


def test_nbody_lattice_matches_jax(port, jpm):
    """a sharded 2LPT lpt_lattice and 3 KDK steps of nbody_lattice"""
    inp = _inputs()
    s = _jax_solver(jpm, (N,) * 3, 64.0)
    dk = s.pm.create(type='complex', value=_sharded(
        jpm, inp['dlinear'], P(None, 'x', None)))
    disp, vel = s.lpt_lattice(dk, 0.1, order=2)
    S, V = s.nbody_lattice(disp, vel, NBODY_STEPS, NBODY_BOUNDS)
    got = port(_index(port, 'nbody'))
    for part, ref in enumerate((disp, vel, S, V)):
        for j in range(3):
            g = _rows([gr[part][j] for gr in got])
            assert np.isfinite(g).all()
            assert _rel(ref[j], g) <= TOL_NBODY, (part, j)


def test_nbody_lattice_poisons_every_rank():
    """a displacement outside the bounds on one rank's slab poisons the
    state on all of them"""
    disp = tuple(np.zeros((8,) * 3, 'f4') for _ in range(3))
    disp[0][7, 3, 3] = 1.5      # the last rank's slab
    out = launch.spawn(CASES + ':nbody_flat', 2, 'gloo', 'cpu', disp,
                       (0.0, 1.0))
    assert all(np.isnan(o).all() for o in out)


def test_sharded_meshes_refuse_what_is_not_ported():
    """the lattice path on an uneven mesh raises (ROADMAP item 8e) on
    every rank; reverse mode through the sharded paint (item 8c) gives a
    finite gradient on every rank"""
    out = launch.spawn(CASES + ':refusals', 2, 'gloo', 'cpu')
    assert out[0] == out[1] == ['uneven', 'grad']


# --- the bf16 forms ----------------------------------------------------------
#
# Last in the module: the patch below clears JAX's compiled programs.

@pytest.fixture(scope='module')
def tpu_rounding():
    """the JAX package's products at Precision('default') rounded as the
    MXU's single pass rounds them (bf16 operands, f32 sums), as
    tests/test_torch_fft_bf16.py does, for the rest of this module; JAX's
    caches are cleared before and after, because its entry points are
    jitted on their static arguments"""
    orig = jfm._mm

    def mm(a, b, prec=None):
        if prec == DEFAULT:
            return jnp.dot(a.astype(jnp.bfloat16), b.astype(jnp.bfloat16),
                           preferred_element_type=jnp.float32)
        return orig(a, b, prec)
    jax.clear_caches()
    jfm._mm = mm
    try:
        yield
    finally:
        jfm._mm = orig
        jax.clear_caches()


@pytest.mark.parametrize("fft", ['mxu_bf16', 'mxu_bf16s'])
def test_bf16_forms_pass_through(port, jpm, tpu_rounding, fft):
    """the sharded ct2 force in each bf16 form against the JAX package's
    sharded force in that form (its fft3_*_ct2_sharded at
    precision='bf16', or with bf16 spectrum storage) on the same slabs,
    to the chained criterion of tests/test_torch_fft_bf16.py: the max
    gap within TOL_BF16_MAX of max, the rms gap within TOL_BF16_RMS of
    the rms of the bf16 rounding itself (JAX's force against the port's
    sharded f32 force); and the port's form does round"""
    inp = _inputs()
    s = _jax_solver(jpm, CT2, np.asarray(CT2, float))
    want = _np(s.force_lattice(_sharded(jpm, inp['disp_force_ct2']),
                               FORCE_BOUNDS_CT2, fft=fft))
    got = [_rows([g[j] for g in port(_index(
        port, 'force', len(FORCES_16) + FORCES_CT2.index(('spectral', f))))])
        for f in (fft, 'mxu') for j in range(3)]
    got, f32 = got[:3], got[3:]
    scale = max(np.abs(w).max() for w in want)
    gap = max(np.abs(w - g).max() for w, g in zip(want, got)) / scale
    rms = max(np.sqrt(((w - g) ** 2).mean() / ((w - f) ** 2).mean())
              for w, g, f in zip(want, got, f32))
    assert gap <= TOL_BF16_MAX and rms <= TOL_BF16_RMS, (gap, rms)
    for g, f in zip(got, f32):
        assert np.sqrt(((g - f) ** 2).mean() / (f ** 2).mean()) \
            >= TOL_BF16_ROUNDS
