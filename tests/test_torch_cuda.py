"""The port's CUDA kernels on the card, against their plain PyTorch
versions on the same tensors.  Every test here needs an NVIDIA GPU and
nvcc and skips without them.  This file imports no JAX, so it runs
where JAX is absent:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerance: 1e-5 of max|plain|: f32 sums in another order, with FMA
contraction in the kernel.
"""
import numpy as np
import pytest
import torch

from pmesh_tpu_torch.ops import gridpm as tgp

pytestmark = pytest.mark.cuda

TOL = 1e-5


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device('cuda')


def _rel(got, ref):
    return float((got - ref).abs().max()
                 / ref.abs().max().clamp_min(1e-30))


def _inputs(seed, shape, bounds, dev):
    rng = np.random.RandomState(seed)
    disp = tuple(torch.from_numpy(rng.uniform(bounds[0], bounds[1], shape)
                                  .astype('f4')).to(dev) for _ in range(3))
    mass = torch.from_numpy(
        (1 + 0.2 * rng.normal(size=shape)).astype('f4')).to(dev)
    meshes = tuple(torch.from_numpy(rng.normal(size=shape).astype('f4'))
                   .to(dev) for _ in range(3))
    return disp, mass, meshes


@pytest.mark.parametrize("window", ['cic', 'tsc', 'pcs', 'nearest',
                                    'lanczos2', 'db6'])
def test_kernels_match_plain(dev, window):
    from pmesh_tpu_torch.ops import gridpm_cuda
    bounds = (-1.0, 1.5)
    disp, mass, meshes = _inputs(1, (24, 20, 36), bounds, dev)
    vmin, vmax = tgp.offset_range(*bounds, window)
    for diffdir in (None, 0, 1, 2):
        for m in (None, mass, 0.5):
            ref = tgp.paint_grid(disp, m, bounds, window, diffdir,
                                 impl='torch')
            got = tgp.paint_grid(disp, m, bounds, window, diffdir,
                                 impl='cuda')
            assert _rel(got, ref) <= TOL, (diffdir, type(m))
    for diffdir in (None, 0, 1, 2, 'all'):
        for ms in ((meshes[0],), meshes[:2], meshes):
            if diffdir == 'all' and len(ms) > 1:
                continue
            refs = tgp.readout_grid(ms, disp, bounds, window, diffdir,
                                    impl='torch')
            # all meshes in one launch (readout_grid issues one per mesh)
            gots = gridpm_cuda.readout_lattice(ms, disp, vmin, vmax,
                                               window, diffdir=diffdir)
            assert len(gots) == len(refs)
            for got, ref in zip(gots, refs):
                assert _rel(got, ref) <= TOL, (diffdir, len(ms))


def test_offsets_wider_than_mesh(dev):
    """nv = 5 offsets on a 2 x 3 x 4 mesh: the wrap must be right for
    any offset."""
    bounds = (-2.0, 2.0)
    disp, mass, meshes = _inputs(2, (2, 3, 4), bounds, dev)
    ref = tgp.paint_grid(disp, mass, bounds, impl='torch')
    got = tgp.paint_grid(disp, mass, bounds, impl='cuda')
    assert _rel(got, ref) <= TOL
    ref = tgp.readout_grid(meshes[0], disp, bounds, diffdir=2,
                           impl='torch')
    got = tgp.readout_grid(meshes[0], disp, bounds, diffdir=2, impl='cuda')
    assert _rel(got, ref) <= TOL


def test_dispatch_and_counters(dev):
    from pmesh_tpu_torch.ops import gridpm_cuda
    disp, _, meshes = _inputs(3, (8, 8, 8), (0.0, 1.0), dev)
    gridpm_cuda.reset_launches()
    tgp.paint_grid(disp)
    tgp.readout_grid(meshes, disp)
    tgp.readout_grid(meshes[0], disp, diffdir='all')
    tgp.paint_grid(disp, impl='torch')
    assert gridpm_cuda.LAUNCHES == {"paint_lattice": 1,
                                    "readout_lattice": 4}


def test_kernels_refuse_what_they_cannot_run(dev):
    disp, _, meshes = _inputs(4, (8, 8, 8), (0.0, 1.0), dev)
    with pytest.raises(NotImplementedError, match='f32'):
        tgp.paint_grid(tuple(d.double() for d in disp))
    with pytest.raises(NotImplementedError, match='3-d'):
        tgp.paint_grid(tuple(d[0] for d in disp[:2]))
    with pytest.raises(ValueError, match='contiguous'):
        tgp.readout_grid(meshes[0].transpose(0, 2), disp)
    grad = tuple(d.clone().requires_grad_() for d in disp)
    with pytest.raises(NotImplementedError, match='gradients'):
        tgp.paint_grid(grad)


# gradient mode takes TSC, whose derivative window is continuous: with
# CIC's step-function derivative a last-bit difference in s can switch
# a weight, and the two devices then differ by more than rounding
@pytest.mark.parametrize("force_mode,window", [('spectral', 'cic'),
                                               ('gradient', 'tsc')])
def test_nbody_lattice_card_matches_cpu(dev, force_mode, window):
    from pmesh_tpu_torch import ParticleMesh, RealField
    from pmesh_tpu_torch.models.fastpm import Solver
    n = 32
    noise = np.random.RandomState(5).normal(size=(n,) * 3).astype('f4')
    out = []
    for device in ('cpu', dev):
        pm = ParticleMesh([n] * 3, BoxSize=64.0, dtype='f4', device=device)
        dk = pm.create(type=RealField,
                       value=torch.from_numpy(noise).to(device)).r2c()
        dk = dk.apply(lambda k, v: 0.3 * v * torch.where(
            k.normp(2) > 0, k.normp(2, zeromode=1.0) ** -0.25, 0.0))
        solver = Solver(pm, force_resampler=window)
        disp, vel = solver.lpt_lattice(dk, 0.1, order=2)
        S, V = solver.nbody_lattice(disp, vel, np.linspace(0.1, 0.2, 4),
                                    (-1.0, 1.0), force_mode=force_mode)
        out.append([x.cpu() for x in S + V])
    for ref, got in zip(*out):
        assert _rel(got, ref) <= 1e-4


# --- the binned rebase kernels (csrc/binned.cu): bitwise, not 1e-5 --------

def _bits(x):
    """NaN places and the bits elsewhere, for an exact comparison"""
    nan = torch.isnan(x) if x.is_floating_point() else None
    if nan is None:
        return None, x
    return nan, torch.where(nan, 0.0, x).view(torch.int32)


def _assert_same(got, ref):
    if isinstance(ref, (tuple, list)):
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            _assert_same(g, r)
        return
    assert got.dtype == ref.dtype and got.shape == ref.shape
    (gn, gb), (rn, rb) = _bits(got), _bits(ref)
    if rn is not None:
        assert torch.equal(gn, rn)
    assert torch.equal(gb, rb)


def _slot_state(seed, shape, lo, hi, fill, dev):
    rng = np.random.RandomState(seed)

    def t(a):
        return torch.from_numpy(a.astype('f4')).to(dev)
    ds = tuple(tuple(t(rng.uniform(lo, hi, shape)) for _ in range(3))
               for _ in fill)
    va = tuple(t(rng.uniform(size=shape) < f) for f in fill)
    vel = tuple(tuple(t(rng.normal(size=shape)) for _ in range(3))
                for _ in fill)
    return ds, va, vel


# name: (drift bounds, fill per input slot, nslots_out)
REBASE_CASES = {
    'kout_gt_k': ((-0.9, 1.9), (0.35, 0.15), 4),
    'overflow': ((-0.9, 1.9), (0.6, 0.4), 1),   # Kout < occupancy
    'escape': ((-0.5, 1.5), (0.5, 0.2), 3),
    'offsets_-2_2': ((-1.6, 2.6), (0.3, 0.2), 4),
}


@pytest.mark.parametrize("shape", [(2, 3, 4), (5, 8, 130), (64, 64, 64)])
@pytest.mark.parametrize("case", sorted(REBASE_CASES))
def test_rebase_kernels_bitwise(dev, shape, case):
    from pmesh_tpu_torch.ops import binned as tbn
    from pmesh_tpu_torch.ops import binned_cuda
    bounds, fill, kout = REBASE_CASES[case]
    ds, va, vel = _slot_state(6, shape, bounds[0], bounds[1], fill, dev)
    if case == 'escape':
        # one particle past the bounds and one NaN: both are lost
        ds[0][0].view(-1)[0] = 2.7
        va[0].view(-1)[0] = 1.0
        ds[1][2].view(-1)[-1] = float('nan')
        va[1].view(-1)[-1] = 1.0
    offsets = tbn._drift_offsets(bounds, 3)
    lo, hi = offsets[0][0], offsets[-1][0]
    ref = tbn.rebase_assign_plain(ds, va, offsets, kout)
    got = binned_cuda.rebase_assign(ds, va, kout, lo, hi)
    _assert_same(got, ref)
    _assert_same(binned_cuda.rebase_apply((vel,), got[2], lo, hi),
                 tbn.rebase_apply_plain((vel,), ref[2], offsets))
    # the whole rebase, count re-validation and poison included
    r = tbn.rebase(ds, va, bounds, extras=(vel,), nslots_out=kout,
                   impl='torch')
    g = tbn.rebase(ds, va, bounds, extras=(vel,), nslots_out=kout,
                   impl='cuda')
    _assert_same(g, r)
    poisoned = int(r[3]) > 0
    if case in ('overflow', 'escape'):
        assert poisoned
    assert bool(torch.isnan(g[0][0][0]).all()) == poisoned


def test_rebase_dispatch_counters_and_refusals(dev):
    from pmesh_tpu_torch.ops import binned as tbn
    from pmesh_tpu_torch.ops import binned_cuda
    ds, va, vel = _slot_state(7, (8, 8, 8), -0.5, 1.5, (0.5, 0.2), dev)
    binned_cuda.reset_launches()
    tbn.rebase(ds, va, (-0.5, 1.5), extras=(vel,))
    tbn.rebase(ds, va, (-0.5, 1.5))
    tbn.rebase(ds, va, (-0.5, 1.5), impl='torch')
    assert binned_cuda.LAUNCHES == {"rebase_assign": 2, "rebase_apply": 1}
    with pytest.raises(NotImplementedError, match='f32'):
        tbn.rebase(tuple(tuple(x.double() for x in dk) for dk in ds),
                   tuple(v.double() for v in va), (-0.5, 1.5))
    with pytest.raises(NotImplementedError, match='slots'):
        tbn.rebase(ds, va, (-0.5, 1.5), nslots_out=17)


@pytest.mark.parametrize("adaptive", [False, True])
def test_nbody_binned_card_matches_cpu(dev, adaptive):
    """the same run on the card (kernels, cuFFT) and on the CPU (plain
    versions): equal counts and overflow, densities to 1e-4"""
    from pmesh_tpu_torch import ParticleMesh
    from pmesh_tpu_torch.models.fastpm import Solver
    from pmesh_tpu_torch.ops import binned as tbn
    n = 16
    rng = np.random.RandomState(8)
    disp = rng.uniform(-0.6, 1.6, (3,) + (n,) * 3).astype('f4')
    vel = (0.02 * rng.normal(size=(3,) + (n,) * 3)).astype('f4')
    need = int(tbn.fold_needed(tuple(torch.from_numpy(x) for x in disp)))
    out = []
    for device in ('cpu', dev):
        pm = ParticleMesh([n] * 3, BoxSize=float(n), dtype='f4',
                          device=device)
        d = tuple(torch.from_numpy(x).to(device) for x in disp)
        v = tuple(torch.from_numpy(x).to(device) for x in vel)
        ds, vs, va, ov = Solver(pm).nbody_binned(
            d, v, np.linspace(0.5, 0.6, 5), rebase_every=2,
            nslots=1 if adaptive else need + 1, adaptive=adaptive)
        tot, _ = tbn.occupancy(va)
        out.append((tbn.paint_binned(ds, va).cpu(), int(tot), int(ov)))
    (ref, rtot, rov), (got, gtot, gov) = out
    assert rtot == gtot == n ** 3 and rov == gov == 0
    assert _rel(got, ref) <= 1e-4
