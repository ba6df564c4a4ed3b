"""Which implementation the lattice paint and readout and the binned
rebase take (``ops/gridpm.route``, ``ops/binned.route``), and the f64
kernels' launch plans, on the CPU (the kernels themselves run only on
the card: tests/test_torch_cuda.py).

The route is the JAX package's gate (``pmesh_tpu/ops/gridpm.py:172``,
``pmesh_tpu/ops/binned.py:289-291``) with the device in place of the
backend: the test asks that gate itself, with ``jax.default_backend``
reading 'tpu' where the port's tensor lies on a CUDA device.  Its
answer is the port's for every device, mesh rank, dtype and ``impl``
but one, by design: ``impl='cuda'`` on a 2-d mesh raises, where the JAX
package's ``impl='pallas'`` runs XLA instead.  A 2-d f8 ``nbody_lattice``
(the plain route on either device) is held against the JAX package's,
1e-10.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pmesh_tpu import ParticleMesh as JaxPM
from pmesh_tpu.models import fastpm as jfastpm
from pmesh_tpu.ops import gridpm as jgp
from pmesh_tpu_torch import convert
from pmesh_tpu_torch.models import fastpm as tfastpm
from pmesh_tpu_torch.ops import binned as bn
from pmesh_tpu_torch.ops import binned_cuda as bc
from pmesh_tpu_torch.ops import fft_mxu as fm
from pmesh_tpu_torch.ops import gridpm as gp
from pmesh_tpu_torch.ops import gridpm_cuda as gc

torch.set_num_threads(1)

DEVICES = [torch.device('cpu'), torch.device('cuda', 0)]
DTYPES = [torch.float32, torch.bfloat16, torch.float64]
IMPLS = [None, 'torch', 'cuda']
# the port's impl as the JAX package's
JAX_IMPL = {None: None, 'torch': 'xla', 'cuda': 'pallas'}


def _reference(monkeypatch, device, ndim, impl):
    """the JAX package's gate: 'cuda' where it takes its Pallas kernels"""
    backend = 'tpu' if device.type == 'cuda' else 'cpu'
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    monkeypatch.setattr(jgp, "IMPL", 'auto')
    pallas = jgp._use_pallas(JAX_IMPL[impl]) and ndim == 3
    return 'cuda' if pallas else 'torch'


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("ndim", [2, 3])
@pytest.mark.parametrize("device", DEVICES, ids=['cpu', 'cuda'])
def test_route_is_the_reference_gate(monkeypatch, device, ndim, dtype,
                                     impl):
    """the lattice and rebase routes give the JAX package's answer; the
    dtype never changes it (the kernels take f32, bf16 and f64 and
    refuse the others, so no dtype reaches the plain version on the card
    unless impl='torch' asks); impl='cuda' raises on a CPU tensor (the
    JAX package's 'pallas' would run in interpret mode there) and on a
    2-d mesh"""
    want = _reference(monkeypatch, device, ndim, impl)
    for route in (gp.route, bn.route):
        if impl == 'cuda' and device.type != 'cuda':
            with pytest.raises(ValueError, match="needs CUDA tensors"):
                route(impl, device, ndim)
        elif impl == 'cuda' and ndim != 3:
            assert want == 'torch'
            with pytest.raises(NotImplementedError, match="3-d meshes"):
                route(impl, device, ndim)
        else:
            assert route(impl, device, ndim) == want
    # the dtype is not an argument: the answer for every dtype is one
    assert dtype in gc.FORMS


def test_route_names_the_reference():
    """impl='cuda' on a 2-d mesh names the JAX package's gate; an unknown
    impl is refused"""
    cuda = torch.device('cuda', 0)
    with pytest.raises(NotImplementedError,
                       match="pmesh_tpu/ops/gridpm.py:172"):
        gp.route('cuda', cuda, 2)
    with pytest.raises(NotImplementedError,
                       match="pmesh_tpu/ops/binned.py:289-291"):
        bn.route('cuda', cuda, 2)
    with pytest.raises(ValueError, match="impl must be"):
        gp.route('pallas', cuda, 3)
    assert gp.route(None, 'cuda', 3) == 'cuda'
    assert gp.route(None, 'cpu', 3) == 'torch'


def test_two_d_cuda_dispatch_takes_plain(monkeypatch):
    """on a 2-d mesh the dispatch never reaches the CUDA wrappers: a
    stand-in for a CUDA tensor's device routes _shift_loop to the plain
    loop, whose answer is the CPU's"""
    calls = []
    monkeypatch.setattr(gc, "paint_lattice",
                        lambda *a, **k: calls.append('paint'))
    real_route = gp.route
    monkeypatch.setattr(gp, "route", lambda impl, device, ndim: real_route(
        impl, torch.device('cuda', 0), ndim))
    rng = np.random.RandomState(0)
    disp = tuple(torch.from_numpy(rng.uniform(-1, 1, (8, 6))) for _ in
                 range(2))
    got = gp._shift_loop(None, disp, None, (-1.0, 1.0), 'cic', None,
                         'paint')
    ref = gp._shift_loop(None, disp, None, (-1.0, 1.0), 'cic', None,
                         'paint', impl='torch')
    assert calls == [] and torch.equal(got, ref)
    disp3 = tuple(torch.from_numpy(rng.uniform(-1, 1, (4, 4, 4)))
                  for _ in range(3))
    gp._shift_loop(None, disp3, None, (-1.0, 1.0), 'cic', None, 'paint')
    assert calls == ['paint']


def _gridpm_layout(op, nv, nmesh=1, mass=False, nbuf=1):
    """the f64 kernels' dynamic shared bytes: the readout's ring (nv + 1
    slots of nmesh staged regions), the paint's tables ((3 nv + mass)
    rows of the region), in 8-byte values over a region of the f64 tile
    (16 RY x 16 RZ, RY rows and RZ z cells a thread by width, RZ = 1 but
    in the paint, csrc/gridpm64.cu) plus its nv - 1 halo, its rows
    rounded up to whole RZ"""
    rz = gc.ZCELLS64[nv - 1] if op == 'paint' else 1
    ty, tz = 16 * gc.ROWS64[op][nv - 1], 16 * rz
    area = (ty + nv - 1) * (-(-(tz + nv - 1) // rz) * rz)
    if op == 'readout':
        return (nv + 1) * nmesh * area * 8
    return nbuf * (3 * nv + int(mass)) * area * 8


@pytest.mark.parametrize("nv", range(1, gc.NV_MAX + 1))
def test_gridpm_f64_plan_fits(nv):
    """every width 1..NV_MAX launches in f64: the plan fits SMEM_LIMIT
    for 1 to 3 meshes and both paint masses, one paint table (the f64
    kernels' launch bounds count one), for the wrapped form and the x-halo form
    (planned on its output rows); the tile is 16 threads wide of RZ z
    cells each and RY rows a thread deep"""
    for shape in ((512, 512, 512), (128 + 2, 512, 512), (3, 5, 7)):
        for nm in (1, 2, 3):
            p = gc.plan('readout', shape, nv, nmesh=nm, dtype=torch.float64)
            assert p['tile'] == (16 * gc.ROWS64['readout'][nv - 1], 16) \
                == gc.tile('readout', torch.float64, nv)
            assert p['smem'] == _gridpm_layout('readout', nv, nm)
            assert p['smem'] <= gc.SMEM_LIMIT
        for mass in (False, True):
            p = gc.plan('paint', shape, nv, mass=mass, dtype=torch.float64)
            assert p['tile'] == (16 * gc.ROWS64['paint'][nv - 1],
                                 16 * gc.ZCELLS64[nv - 1])
            assert p['nbuf'] == 1
            assert p['smem'] == _gridpm_layout('paint', nv, mass=mass)
            assert p['smem'] <= gc.SMEM_LIMIT
    # the f32 and bf16 plans are unchanged by the f64 forms
    for dtype in (torch.float32, torch.bfloat16):
        assert gc.plan('paint', (64,) * 3, nv, mass=True, dtype=dtype) == \
            gc.plan('paint', (64,) * 3, nv, mass=True)


@pytest.mark.parametrize("xhalo", [False, True])
def test_binned_f64_plan_fits(xhalo):
    """the f64 rebase assign fits SMEM_LIMIT for every slot count and
    offset range the wrapper takes: 8-byte values in the ring and the raw
    plane, the slot group and the staged displacements counted alike"""
    for K, Kout in ((1, 1), (2, 2), (2, 3), (4, 4), (8, 8), (16, 16)):
        for olo, ohi in ((0, 1), (-1, 1), (-1, 2), (-2, 2), (-3, 3),
                         (-6, 5)):
            nr = ohi - olo + 1
            if K * nr ** 3 > bc.ROUTE_MAX:
                continue
            p = bc.plan((64, 64, 64), K, Kout, olo, ohi, xhalo=xhalo,
                        dtype=torch.float64)
            p32 = bc.plan((64, 64, 64), K, Kout, olo, ohi, xhalo=xhalo)
            area = (bc.TILE_Y + nr - 1) * (bc.TILE_Z + nr - 1)
            G = p['group']
            raw = G * 4 * area * 8
            disp = G * (nr + 1) * 3 * area * 8 if p['stage_d'] else 0
            codes = G * (nr + 1) * area * p['code_bytes']
            assert p['smem'] == disp + raw + 2 * Kout * bc.THREADS + codes
            assert p['smem'] <= gc.SMEM_LIMIT
            assert 1 <= G <= p32['group']


def test_launch_counters_have_f64_forms():
    assert {"paint_lattice_f64", "readout_lattice_f64",
            "paint_lattice_xhalo_f64",
            "readout_lattice_xhalo_f64"} <= set(gc.LAUNCHES)
    assert {"rebase_assign_f64", "rebase_apply_f64",
            "rebase_assign_xhalo_f64",
            "rebase_apply_xhalo_f64"} <= set(bc.LAUNCHES)


def test_mxu_pass_boundary_casts_f64():
    """an f64 input reaches a DFT pass as f32, as the JAX package casts
    it (pmesh_tpu/ops/fft_mxu.py:1112): the plain pass gives the f32
    input's answer bitwise, in f32"""
    x = torch.from_numpy(np.random.RandomState(1).normal(size=(4, 6, 8)))
    y, none, b = fm._f32_pass(x, None, x.to(torch.bfloat16))
    assert y.dtype == torch.float32 and none is None
    assert b.dtype == torch.bfloat16
    wz = fm._cached(fm._dft_half_np, 8, 5)
    wy = fm._cached(fm._dft_np, 6, -1)
    got = fm.zy_fwd_half_plain(x, wz, wy)
    ref = fm.zy_fwd_half_plain(x.float(), wz, wy)
    assert all(g.dtype == torch.float32 and torch.equal(g, r)
               for g, r in zip(got, ref))


def _solvers2d(n):
    jpm = JaxPM(Nmesh=[n, n], BoxSize=float(n), dtype='f8')
    tpm = convert.particlemesh_from(jpm.Nmesh, jpm.BoxSize, jpm.dtype,
                                    jpm.resampler, device='cpu')
    return jfastpm.Solver(jpm), tfastpm.Solver(tpm)


@pytest.mark.parametrize("force_mode", ['spectral', 'gradient'])
def test_nbody_lattice_2d_f8_matches_jax(force_mode):
    """a 2-d f8 lattice run (the plain route, as the JAX package's XLA
    path) against the JAX package's, 1e-10 of max"""
    n = 24
    js, ts = _solvers2d(n)
    rng = np.random.RandomState(7)
    disp = [rng.uniform(-0.3, 0.3, (n, n)) for _ in range(2)]
    vel = [0.05 * rng.normal(size=(n, n)) for _ in range(2)]
    steps = np.linspace(0.2, 0.5, 4)     # 3 KDK steps
    S1, V1 = js.nbody_lattice(tuple(map(jnp.asarray, disp)),
                              tuple(map(jnp.asarray, vel)), steps,
                              bounds=(-1.0, 1.0), force_mode=force_mode)
    tS, tV = convert.lattice_state_from_numpy(disp, vel, device='cpu')
    S2, V2 = ts.nbody_lattice(tS, tV, steps, bounds=(-1.0, 1.0),
                              force_mode=force_mode)
    for a, b in zip(S1 + V1, S2 + V2):
        a = np.asarray(a)
        assert b.dtype == torch.float64
        assert np.abs(a - b.numpy()).max() <= 1e-10 * np.abs(a).max()
    F1 = js.force_lattice(tuple(map(jnp.asarray, disp)), (-1.0, 1.0),
                          mode=force_mode)
    F2 = ts.force_lattice(tS, (-1.0, 1.0), mode=force_mode)
    for a, b in zip(F1, F2):
        a = np.asarray(a)
        assert np.abs(a - b.numpy()).max() <= 1e-10 * np.abs(a).max()
