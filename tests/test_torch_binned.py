"""The port's binned slot-lattice path (pmesh_tpu_torch.ops.binned and
Solver.force_binned / nbody_binned) against the JAX package's, on the
same seeded numpy inputs.

Tolerances: the state bookkeeping (folds, counts, slot growth) is exact,
and the plain rebase is BITWISE equal to the JAX package's
``rebase(impl='xla')`` (same image order, one f32 subtraction per moved
displacement).  paint/readout agree to 1e-6 of max|ref| (as in
test_torch_gridpm), the binned force to 2e-5 (the force tolerance of
test_torch_fastpm) and the f8 binned N-body density to 1e-8.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pmesh_tpu import ParticleMesh as JaxPM
from pmesh_tpu.models import fastpm as jfastpm
from pmesh_tpu.ops import binned as jbn
from pmesh_tpu_torch import convert
from pmesh_tpu_torch.models import fastpm as tfastpm
from pmesh_tpu_torch.ops import binned as tbn
from pmesh_tpu_torch.ops import gridpm as tgp

torch.set_num_threads(1)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _bits_equal(ref, got):
    """equal bit for bit, NaNs at the same places"""
    ref, got = np.asarray(ref), _np(got)
    assert ref.shape == got.shape and ref.dtype == got.dtype
    nan = np.isnan(ref)
    np.testing.assert_array_equal(nan, np.isnan(got))
    np.testing.assert_array_equal(ref[~nan].view('u%d' % ref.itemsize),
                                  got[~nan].view('u%d' % got.itemsize))


def _tree_bits_equal(ref, got):
    if isinstance(ref, (tuple, list)):
        assert len(ref) == len(got)
        for r, g in zip(ref, got):
            _tree_bits_equal(r, g)
    else:
        _bits_equal(ref, got)


def _both(arrays):
    """the same numpy arrays as jax and as torch nested tuples"""
    return (jax.tree_util.tree_map(jnp.asarray, arrays),
            convert.binned_state_from_numpy(arrays, device='cpu'))


def _slot_state(seed, shape, lo, hi, fill=(0.35, 0.15), dtype='f4'):
    """K = len(fill) slots: displacements uniform in [lo, hi), validity
    with the given fill fractions, velocities N(0, 1)"""
    rng = np.random.RandomState(seed)
    K = len(fill)
    ds = tuple(tuple(rng.uniform(lo, hi, shape).astype(dtype)
                     for _ in range(3)) for _ in range(K))
    va = tuple((rng.uniform(size=shape) < f).astype(dtype) for f in fill)
    vel = tuple(tuple(rng.normal(size=shape).astype(dtype)
                      for _ in range(3)) for _ in range(K))
    return ds, va, vel


# --- state bookkeeping -------------------------------------------------------

@pytest.mark.parametrize("with_vel", [False, True])
def test_from_lattice_matches_jax(with_vel):
    rng = np.random.RandomState(0)
    disp = tuple(rng.uniform(0, 1, (4, 5, 6)).astype('f4') for _ in range(3))
    vel = tuple(rng.normal(size=(4, 5, 6)).astype('f4') for _ in range(3))
    args = (disp, vel) if with_vel else (disp,)
    ref = jbn.from_lattice(*[tuple(map(jnp.asarray, a)) for a in args],
                           nslots=3)
    got = tbn.from_lattice(*[tuple(map(torch.from_numpy, a)) for a in args],
                           nslots=3)
    _tree_bits_equal(ref, got)
    # every empty slot owns its own buffers
    leaves = [t for t in jax.tree_util.tree_leaves(got)]
    empty = [t.data_ptr() for t in leaves if not t.any()]
    assert len(set(empty)) == len(empty)


@pytest.mark.parametrize("shape,lo,hi,dtype", [
    ((12, 12, 12), -2.4, 3.1, 'f8'),
    ((12, 12, 12), -2.4, 3.1, 'f4'),
    ((5, 7, 3), -1.6, 2.6, 'f4'),
])
def test_fold_matches_jax(shape, lo, hi, dtype):
    rng = np.random.RandomState(5)
    disp = tuple(rng.uniform(lo, hi, shape).astype(dtype) for _ in range(3))
    vel = tuple(rng.normal(size=shape).astype(dtype) for _ in range(3))
    jd, td = _both(disp)
    jv, tv = _both(vel)
    need = int(jbn.fold_needed(jd))
    assert int(tbn.fold_needed(td)) == need > 1
    for nslots in (need, need - 1):
        ref = jbn.fold_lattice(jd, jv, nslots=nslots)
        got = tbn.fold_lattice(td, tv, nslots=nslots)
        assert int(got[3]) == int(ref[3])
        assert (int(got[3]) > 0) == (nslots < need)
        _tree_bits_equal(ref[:3], got[:3])
    ref = jbn.fold_lattice(jd, nslots=need)
    got = tbn.fold_lattice(td, nslots=need)
    _tree_bits_equal(ref[:2], got[:2])


@pytest.mark.parametrize("nslots", [1, 2])
def test_fold_wraps_a_position_that_rounds_to_n(nslots):
    """x = -1e-7 wraps to 16 - 1e-7, which is 16.0 in f32: that particle
    lives in cell 0.  The port wraps the cell index, so it is counted
    there (and overflows a one-slot state, poisoned, never dropped);
    the JAX package homes it past the mesh and drops it when K = 1."""
    n = 16
    disp = [np.full((n,) * 3, 0.5, 'f4') for _ in range(3)]
    disp[0][0, 3, 4] = -1e-7
    disp[0][1, 3, 4] = -1.0        # a second particle in cell (0, 3, 4)
    ds, va, ov = tbn.fold_lattice(tuple(map(torch.from_numpy, disp)),
                                  nslots=nslots)
    tot, occ = tbn.occupancy(va)
    assert int(tot) + int(ov) == n ** 3
    assert int(ov) == (1 if nslots == 1 else 0)
    if nslots == 2:
        assert float(va[1][0, 3, 4]) == 1.0 and float(occ) == 2.0
        assert float(ds[1][0][0, 3, 4]) == 0.0
    else:
        assert torch.isnan(ds[0][0]).all()


@pytest.mark.parametrize("n,nslots,scale", [(2000, 8, 1.0), (600, 1, 0.25)])
def test_from_positions_matches_jax(n, nslots, scale):
    rng = np.random.RandomState(2)
    pos = rng.uniform(0, 16, (n, 3))
    shape = (16, 16, 16) if scale == 1.0 else (4, 4, 4)
    ref = jbn.from_positions(jnp.asarray(pos), shape, nslots, scale=scale)
    got = tbn.from_positions(torch.from_numpy(pos), shape, nslots,
                             scale=scale)
    assert int(got[2]) == int(ref[2])
    assert (int(got[2]) > 0) == (nslots == 1)
    _tree_bits_equal(ref[:2], got[:2])


def test_occupancy_needed_and_grow_match_jax():
    ds, va, vel = _slot_state(3, (8, 8, 8), -0.9, 1.9)
    (jds, jva, jvel), (tds, tva, tvel) = _both((ds, va, vel))
    rt, ro = jbn.occupancy(jva)
    gt, go = tbn.occupancy(tva)
    assert int(gt) == int(rt) and float(go) == float(ro)
    assert gt.dtype == torch.int64
    for bounds in ((-0.9, 1.9), (-1.6, 2.6)):
        assert int(tbn.needed_slots(tds, tva, bounds)) \
            == int(jbn.needed_slots(jds, jva, bounds))
    ref = jbn.grow_slots(jva, jds, jvel, nslots_new=4)
    got = tbn.grow_slots(tva, tds, tvel, nslots_new=4)
    _tree_bits_equal(ref, got)
    with pytest.raises(ValueError, match='shrink'):
        tbn.grow_slots(tva, nslots_new=1)


def test_exact_counts_past_f32():
    """2^24 + 3 ones: an f32 sum would drift, the count must not"""
    v = torch.ones(2 ** 24 + 3)
    assert int(tbn._icount(v)) == 2 ** 24 + 3
    tot, occ = tbn.occupancy((v, v))
    assert int(tot) == 2 * (2 ** 24 + 3) and float(occ) == 2.0


# --- rebase: bitwise against impl='xla' ------------------------------------

def _escape_state():
    """one particle pushed 2.7 cells while the bounds say <= 1.5"""
    rng = np.random.RandomState(9)
    shape = (8, 8, 8)
    ds = tuple(tuple(rng.uniform(0, 1, shape).astype('f4') for _ in range(3))
               for _ in range(2))
    ds[0][0][2, 3, 4] = 2.7
    va = (np.ones(shape, 'f4'), np.zeros(shape, 'f4'))
    vel = tuple(tuple(rng.normal(size=shape).astype('f4') for _ in range(3))
                for _ in range(2))
    return ds, va, vel


REBASE_CASES = {
    # name: (state, bounds, nslots_out, expect overflow)
    'k2_kout4_vel': (lambda: _slot_state(7, (8, 8, 8), -0.9, 1.9),
                     (-0.9, 1.9), 4, False),
    'overflow': (lambda: _slot_state(8, (8, 8, 8), -0.9, 1.9, (0.6, 0.4)),
                 (-0.9, 1.9), 1, True),
    'escape': (_escape_state, (-0.5, 1.5), 2, True),
    'shape_2_3_4': (lambda: _slot_state(10, (2, 3, 4), -0.9, 1.9),
                    (-0.9, 1.9), 3, None),
    # 125 offsets: one slot keeps the JAX side's eager loop short
    'wide': (lambda: _slot_state(11, (6, 8, 10), -1.6, 2.6, (0.45,)),
             (-1.6, 2.6), 4, None),
    # the shape of 'wide': the JAX side reuses its compiled rolls
    'odd_kout_lt_k': (lambda: _slot_state(12, (6, 8, 10), -0.5, 1.5,
                                          (0.3, 0.2, 0.1)),
                      (-0.5, 1.5), 2, None),
}


@pytest.mark.parametrize("case", sorted(REBASE_CASES))
@pytest.mark.parametrize("with_vel", [True, False])
def test_rebase_bitwise_matches_jax(case, with_vel):
    make, bounds, kout, expect = REBASE_CASES[case]
    ds, va, vel = make()
    (jds, jva, jvel), (tds, tva, tvel) = _both((ds, va, vel))
    extras_j = (jvel,) if with_vel else ()
    extras_t = (tvel,) if with_vel else ()
    ref = jbn.rebase(jds, jva, bounds, extras=extras_j, nslots_out=kout,
                     impl='xla')
    got = tbn.rebase(tds, tva, bounds, extras=extras_t, nslots_out=kout)
    assert int(got[3]) == int(ref[3])
    if expect is not None:
        assert (int(got[3]) > 0) == expect
    if int(got[3]) > 0:
        assert torch.isnan(got[0][0][0]).all()
    _tree_bits_equal(ref[:3], got[:3])
    # the inputs are not modified
    _bits_equal(ds[0][0], tds[0][0])


def test_rebase_routes_replay_the_assign():
    """the apply half gathers each slot's payload from the image its
    route names: replaying the displacements themselves through the
    routes gives back what the assign re-centred, d - floor(d)"""
    ds, va, _ = _slot_state(13, (6, 6, 6), -0.9, 1.9)
    tds, tva = convert.binned_state_from_numpy((ds, va), device='cpu')
    offsets = tbn._drift_offsets((-0.9, 1.9), 3)
    nd, nv, rt, ov = tbn.rebase_assign_plain(tds, tva, offsets, 4)
    assert int(ov) == 0 and rt[0].dtype == tbn.ROUTE_DTYPE
    (moved,) = tbn.rebase_apply_plain((tds,), rt, offsets)
    for j in range(4):
        filled = nv[j] > 0
        assert bool(((rt[j] >= 0) == filled).all())
        for a in range(3):
            m = moved[j][a][filled]
            assert bool((m - torch.floor(m) == nd[j][a][filled]).all())
            assert bool((moved[j][a][~filled] == 0).all())


def test_rebase_dispatch_refuses_cpu_for_cuda():
    from pmesh_tpu_torch.ops import binned_cuda
    ds, va, vel = _slot_state(14, (4, 4, 4), 0.0, 1.0)
    tds, tva, tvel = convert.binned_state_from_numpy((ds, va, vel),
                                                       device='cpu')
    before = dict(binned_cuda.LAUNCHES)
    with pytest.raises(ValueError, match='CUDA tensors'):
        tbn.rebase(tds, tva, (0.0, 1.0), impl='cuda')
    with pytest.raises(ValueError, match='CUDA tensors'):
        binned_cuda.rebase_assign(tds, tva, 2, 0, 0)
    rt = tuple(torch.zeros((4, 4, 4), dtype=torch.int16) for _ in range(2))
    with pytest.raises(ValueError, match='CUDA tensors'):
        binned_cuda.rebase_apply((tvel,), rt, 0, 0)
    with pytest.raises(ValueError):
        tbn.rebase(tds, tva, (0.0, 1.0), impl='xla')
    assert binned_cuda.LAUNCHES == before
    binned_cuda.reset_launches()
    assert set(binned_cuda.LAUNCHES.values()) == {0}


# --- paint / readout / force ------------------------------------------------

def _rel(ref, got):
    ref = np.asarray(ref)
    return np.abs(ref - _np(got)).max() / np.abs(ref).max()


@pytest.mark.parametrize("window", ['cic', 'tsc'])
def test_paint_readout_binned_match_jax(window):
    ds, va, _ = _slot_state(15, (8, 10, 12), -0.5, 1.5)
    (jds, jva), (tds, tva) = _both((ds, va))
    bounds = (-0.5, 1.5)
    ref = jbn.paint_binned(jds, jva, bounds=bounds, window=window)
    got = tbn.paint_binned(tds, tva, bounds=bounds, window=window)
    assert _rel(ref, got) <= 1e-6
    rng = np.random.RandomState(16)
    meshes = tuple(rng.normal(size=(8, 10, 12)).astype('f4')
                   for _ in range(3))
    jm, tm = _both(meshes)
    for ms in ((jm[0], tm[0]), (jm, tm)):
        ref = jbn.readout_binned(ms[0], jds, jva, bounds=bounds,
                                 window=window)
        got = tbn.readout_binned(ms[1], tds, tva, bounds=bounds,
                                 window=window)
        for r, g in zip(jax.tree_util.tree_leaves(ref),
                        jax.tree_util.tree_leaves(got)):
            assert _rel(r, g) <= 1e-6
    ref = jbn.readout_binned(jm[0], jds, jva, bounds=bounds, window=window,
                             diffdir='all')
    got = tbn.readout_binned(tm[0], tds, tva, bounds=bounds, window=window,
                             diffdir='all')
    assert len(got) == 2 and all(len(s) == 3 for s in got)
    for r, g in zip(jax.tree_util.tree_leaves(ref),
                    jax.tree_util.tree_leaves(got)):
        assert _rel(r, g) <= 1e-6


def _solvers(n, dtype='f4', box=None):
    jpm = JaxPM(Nmesh=[n] * 3, BoxSize=float(box or n), dtype=dtype)
    tpm = convert.particlemesh_from(jpm.Nmesh, jpm.BoxSize, jpm.dtype,
                                    jpm.resampler, device='cpu')
    return jfastpm.Solver(jpm), tfastpm.Solver(tpm)


@pytest.mark.parametrize("mode", ['spectral', 'gradient'])
def test_force_binned_matches_jax(mode):
    js, ts = _solvers(16, box=64.0)
    ds, va, _ = _slot_state(17, (16,) * 3, -0.5, 1.5, (0.9, 0.3))
    (jds, jva), (tds, tva) = _both((ds, va))
    ref = js.force_binned(jds, jva, (-0.5, 1.5), fft='xla', mode=mode)
    got = ts.force_binned(tds, tva, (-0.5, 1.5), fft='xla', mode=mode)
    assert len(got) == 2
    for rk, gk, v in zip(ref, got, va):
        for r, g in zip(rk, gk):
            assert g.dtype == torch.float32
            # invalid slots read garbage: compare where a particle sits
            m = v > 0
            assert np.abs(np.asarray(r)[m] - g.numpy()[m]).max() \
                <= 2e-5 * np.abs(np.asarray(r)[m]).max()


def test_force_binned_equals_force_lattice_on_a_lattice_state():
    """a fresh from_lattice state (slot 0 = the lattice) gives the
    lattice force exactly, in both modes"""
    _, ts = _solvers(12)
    rng = np.random.RandomState(18)
    disp = tuple(torch.from_numpy(rng.uniform(0.05, 0.95, (12,) * 3)
                                  .astype('f4')) for _ in range(3))
    dsl, valid = tbn.from_lattice(disp, nslots=2)
    for mode in ('spectral', 'gradient'):
        Fb = ts.force_binned(dsl, valid, (-0.5, 1.5), mode=mode)
        Fl = ts.force_lattice(disp, (-0.5, 1.5), mode=mode)
        for d in range(3):
            _bits_equal(Fl[d].numpy(), Fb[0][d])


def test_binned_refuses_mxu():
    _, ts = _solvers(8)
    disp = tuple(torch.full((8,) * 3, 0.5) for _ in range(3))
    dsl, valid = tbn.from_lattice(disp, nslots=1)
    # fft='mxu' and its bf16 modes run at 8^3, which is not ct2 (the
    # dense DFT passes): a uniform state feels no force, its meshes are
    # f32, and it keeps every particle
    F = ts.force_binned(dsl, valid, (0.0, 1.0), fft='mxu')
    assert all(float(f.abs().max()) < 1e-6 for f in F[0])
    for fft in ('mxu', 'mxu_bf16', 'mxu_bf16s'):
        F = ts.force_binned(dsl, valid, (0.0, 1.0), fft=fft)
        assert all(f.dtype == torch.float32 and float(f.abs().max()) < 1e-5
                   for f in F[0])
        _, _, va, ov = ts.nbody_binned(disp, disp, [0.5, 0.6], fft=fft)
        assert int(ov) == 0 and int(tbn.occupancy(va)[0]) == 8 ** 3
    with pytest.raises(ValueError, match='unknown fft'):
        ts.force_binned(dsl, valid, (0.0, 1.0), fft='bf16')
    with pytest.raises(ValueError):
        ts.force_binned(dsl, valid, (0.0, 1.0), mode='direct')


# --- the N-body loop ---------------------------------------------------------

def _nbody_inputs():
    """the f8 8^3 configuration of test_binned's lattice-parity test:
    the initial state is made on the JAX side and carried across"""
    js, ts = _solvers(8, dtype='f8')
    dlin = js.linear_field(lambda k: 0.5 * jnp.ones_like(k), seed=42,
                           compat='native')
    disp, vel = js.lpt_lattice(dlin, a0=0.3, shift=0.3, order=1)
    tdisp, tvel = convert.lattice_state_from_numpy(
        [np.asarray(d) for d in disp], [np.asarray(v) for v in vel],
        device='cpu')
    kw = dict(nslots=2, rebase_every=2, step_drift=0.5)
    return js, ts, (disp, vel), (tdisp, tvel), np.linspace(0.3, 0.5, 3), kw


def test_nbody_binned_matches_jax():
    """the same overflow and particle count as the JAX package, and the
    same density to 1e-8"""
    js, ts, jstate, tstate, steps, kw = _nbody_inputs()
    # op by op: the same JAX function, without a 20 s compile of the loop
    with jax.disable_jit():
        jd, jv, jva, jov = js.nbody_binned(*jstate, steps, **kw)
    td, tv, tva, tov = ts.nbody_binned(*tstate, steps, **kw)
    assert int(tov) == int(jov) == 0
    rt, ro = jbn.occupancy(jva)
    gt, go = tbn.occupancy(tva)
    assert int(gt) == int(rt) == 8 ** 3 and float(go) == float(ro)
    ref = np.asarray(jbn.paint_binned(jd, jva, bounds=(-1.0, 2.0)))
    got = tbn.paint_binned(td, tva, bounds=(-1.0, 2.0)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-8)


@pytest.mark.parametrize("force_mode", ['spectral', 'gradient'])
def test_nbody_binned_matches_own_lattice(force_mode):
    """with the displacements inside the lattice bounds, the binned run
    (with a mid-run rebase) gives the port's lattice run's density"""
    _, ts, _, tstate, steps, kw = _nbody_inputs()
    td, tv, tva, tov = ts.nbody_binned(*tstate, steps,
                                       force_mode=force_mode, **kw)
    assert int(tov) == 0 and int(tbn.occupancy(tva)[0]) == 8 ** 3
    got = tbn.paint_binned(td, tva, bounds=(-1.0, 2.0)).numpy()
    S, _ = ts.nbody_lattice(*tstate, steps, bounds=(-1.0, 2.0),
                            force_mode=force_mode)
    rho_l = tgp.paint_grid(S, bounds=(-1.0, 2.0)).numpy()
    np.testing.assert_allclose(got, rho_l, atol=1e-8)


def test_nbody_binned_deep_drift_stays_exact():
    """coherent drift across several cells, far outside any static
    lattice bounds: every rebase folds it, the density stays uniform"""
    _, ts = _solvers(8, dtype='f8')
    disp = tuple(torch.full((8,) * 3, 0.5, dtype=torch.float64)
                 for _ in range(3))
    vel = tuple(torch.full((8,) * 3, 0.1 * (d + 1), dtype=torch.float64)
                for d in range(3))
    ds, vs, va, ov = ts.nbody_binned(disp, vel, np.linspace(0.3, 0.9, 7),
                                     nslots=2, rebase_every=1,
                                     step_drift=1.0, factors='naive')
    assert int(ov) == 0
    tot, occ = tbn.occupancy(va)
    assert int(tot) == 8 ** 3 and float(occ) == 1.0
    rho = tbn.paint_binned(ds, va, bounds=(-1.0, 2.0)).numpy()
    np.testing.assert_allclose(rho, 1.0, atol=1e-9)


def test_nbody_binned_adaptive_grows():
    """a cell exceeding the slot budget mid-run grows the state instead
    of poisoning it (the configuration of test_binned's adaptive test):
    no overflow, an exact count, and the density of a roomy fixed run"""
    _, ts = _solvers(8, dtype='f8')
    n = 8
    disp = tuple(torch.full((n,) * 3, 0.5, dtype=torch.float64)
                 for _ in range(3))
    # even x-columns drift right while odd ones stand still
    x = torch.arange(n)
    vx = torch.where(x % 2 == 0, 0.5, 0.0)[:, None, None] \
        * torch.ones((n,) * 3, dtype=torch.float64)
    vel = (vx, torch.zeros_like(vx), torch.zeros_like(vx))
    steps = np.linspace(0.3, 0.8, 6)
    kw = dict(rebase_every=1, step_drift=1.0, factors='naive')

    _, _, _, ov1 = ts.nbody_binned(disp, vel, steps, nslots=1, **kw)
    assert int(ov1) > 0

    da, vsa, vaa, ova = ts.nbody_binned(disp, vel, steps, nslots=1,
                                        adaptive=True, **kw)
    assert int(ova) == 0
    assert len(da) > 1 and len(vsa) == len(vaa) == len(da)
    stats = ts.last_binned_stats
    assert stats['growth_events'] >= 1 and stats['overflow'] == 0
    assert stats['final_nslots'] == len(da)
    tot, occ = tbn.occupancy(vaa)
    assert int(tot) == n ** 3 and float(occ) <= len(da)

    d4, _, va4, ov4 = ts.nbody_binned(disp, vel, steps, nslots=4, **kw)
    assert int(ov4) == 0
    rho_a = tbn.paint_binned(da, vaa, bounds=(-1.0, 2.0)).numpy()
    rho_4 = tbn.paint_binned(d4, va4, bounds=(-1.0, 2.0)).numpy()
    np.testing.assert_allclose(rho_a, rho_4, atol=1e-9)


def test_binned_state_round_trip_is_exact():
    js, _ = _solvers(6)
    rng = np.random.RandomState(19)
    disp = tuple(jnp.asarray(rng.uniform(-1.2, 2.2, (6,) * 3)
                             .astype('f4')) for _ in range(3))
    vel = tuple(jnp.asarray(rng.normal(size=(6,) * 3).astype('f4'))
                for _ in range(3))
    dsl, vsl, valid, _ = jbn.fold_lattice(disp, vel, nslots=4)
    host = jax.tree_util.tree_map(np.asarray, (dsl, vsl, valid))
    state = convert.binned_state_from_numpy(host, device='cpu')
    assert len(state) == 3 and len(state[0]) == 4 and len(state[0][0]) == 3
    assert state[2][0].dtype == torch.float32
    back = convert.binned_state_to_numpy(state)
    _tree_bits_equal(host, back)
