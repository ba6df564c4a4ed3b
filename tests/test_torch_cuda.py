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
            # all meshes in one launch, as readout_grid launches them
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
    """readout_grid reads its three meshes in one launch"""
    from pmesh_tpu_torch.ops import gridpm_cuda
    disp, _, meshes = _inputs(3, (8, 8, 8), (0.0, 1.0), dev)
    gridpm_cuda.reset_launches()
    tgp.paint_grid(disp)
    tgp.readout_grid(meshes, disp)
    tgp.readout_grid(meshes[0], disp, diffdir='all')
    tgp.paint_grid(disp, impl='torch')
    assert _launched(gridpm_cuda) == {"paint_lattice": 1,
                                      "readout_lattice": 2}


# the staged kernels at every compiled width and one read at run time
# (nv = 7), on meshes of several x chunks (plan's xc) with y and z not
# whole tiles, and one smaller than a tile
STAGED_BOUNDS = {3: (-1.0, 1.0), 4: (-0.5, 1.5), 5: (-2.0, 2.0),
                 7: (-3.0, 3.0)}


@pytest.mark.parametrize("nv", sorted(STAGED_BOUNDS))
@pytest.mark.parametrize("dtype", ['f32', 'bf16'])
@pytest.mark.parametrize("shape", [(70, 20, 36), (3, 5, 7)])
def test_staged_kernels_match_plain(dev, nv, dtype, shape):
    from pmesh_tpu_torch.ops import gridpm_cuda
    bounds = STAGED_BOUNDS[nv]
    vmin, vmax = tgp.offset_range(*bounds, 'cic')
    assert vmax - vmin + 1 == nv
    disp, mass, meshes = _inputs(40 + nv, shape, bounds, dev)
    bf = dtype == 'bf16'
    if bf:
        disp, mass = tuple(d.bfloat16() for d in disp), mass.bfloat16()
        meshes = tuple(m.bfloat16() for m in meshes)

    def same(got, ref, got32=None, ref32=None):
        if bf:
            _bf16_storage_ok(got, ref, got32, ref32)
        else:
            for g, r in zip(got, ref):
                assert _rel(g, r) <= TOL

    def up(ts):
        return tuple(t.float() for t in ts)
    for diffdir in (None, 0):
        for m in (None, mass):
            args = (bounds, 'cic', diffdir)
            got = (tgp.paint_grid(disp, m, *args, impl='cuda'),)
            ref = (tgp.paint_grid(disp, m, *args, impl='torch'),)
            m32 = None if m is None else m.float()
            same(got, ref, (tgp.paint_grid(up(disp), m32, *args,
                                           impl='cuda'),),
                 (tgp.paint_grid(up(disp), m32, *args, impl='torch'),))
    for diffdir in (None, 0, 'all'):
        for ms in ((meshes[0],), meshes):
            if diffdir == 'all' and len(ms) > 1:
                continue
            got = gridpm_cuda.readout_lattice(ms, disp, vmin, vmax, 'cic',
                                              diffdir=diffdir)
            ref = tgp.readout_grid(ms, disp, bounds, diffdir=diffdir,
                                   impl='torch')
            got32 = gridpm_cuda.readout_lattice(up(ms), up(disp), vmin, vmax,
                                                'cic', diffdir=diffdir)
            ref32 = tgp.readout_grid(up(ms), up(disp), bounds,
                                     diffdir=diffdir, impl='torch')
            same(got, ref, got32, ref32)


@pytest.mark.parametrize("nv", sorted(STAGED_BOUNDS))
def test_staged_xhalo_matches_plain(dev, nv):
    """the x-halo slab form: a 21-row slab with its halos, bitwise the
    wrapped kernels' rows where the slab holds the whole mesh"""
    from pmesh_tpu_torch.ops import gridpm_cuda
    bounds = STAGED_BOUNDS[nv]
    vmin, vmax = tgp.offset_range(*bounds, 'cic')
    rows, lo, hi = 21, max(0, vmax), max(0, -vmin)
    disp, mass, meshes = _inputs(50 + nv, (lo + rows + hi, 20, 36), bounds,
                                 dev)
    for m in (None, mass):
        got = gridpm_cuda.paint_lattice(disp, m, vmin, vmax, 'cic',
                                        rows=rows, xbase=lo)
        ref = tgp.paint_slab_plain(disp, m, lo, rows, bounds, 'cic')
        assert _rel(got, ref) <= TOL
    lo = max(0, -vmin)
    rdisp = tuple(d[lo:lo + rows].contiguous() for d in disp)
    for ms in ((meshes[0],), meshes):
        got = gridpm_cuda.readout_lattice(ms, rdisp, vmin, vmax, 'cic',
                                          xbase=lo)
        ref = tgp.readout_slab_plain(ms, rdisp, lo, bounds, 'cic')
        for g, r in zip(got, ref):
            assert _rel(g, r) <= TOL
    # a slab of every plane, its halo wrapped in: the wrapped kernels
    n0 = rows
    full = tuple(d[lo:lo + rows].contiguous() for d in disp)
    ext = tuple(torch.cat([m[-lo:] if lo else m[:0], m, m[:vmax]], 0)
                for m in (x[lo:lo + rows].contiguous() for x in meshes))
    got = gridpm_cuda.readout_lattice(ext, full, vmin, vmax, 'cic', xbase=lo)
    ref = gridpm_cuda.readout_lattice(tuple(m[lo:lo + n0].contiguous()
                                            for m in meshes), full, vmin,
                                      vmax, 'cic')
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


def test_kernels_refuse_what_they_cannot_run(dev):
    """an f64 mesh runs on the f64 kernels and a 2-d mesh on the plain
    version (the JAX package's gate, pmesh_tpu/ops/gridpm.py:172), with
    no launch; impl='cuda' on a 2-d mesh and an f16 mesh raise"""
    from pmesh_tpu_torch.ops import gridpm_cuda
    disp, _, meshes = _inputs(4, (8, 8, 8), (0.0, 1.0), dev)
    gridpm_cuda.reset_launches()
    d64 = tuple(d.double() for d in disp)
    got = tgp.paint_grid(d64)
    assert _launched(gridpm_cuda) == {"paint_lattice_f64": 1}
    assert _rel(got, tgp.paint_grid(d64, impl='torch')) <= 1e-12
    gridpm_cuda.reset_launches()
    d2 = tuple(d[0].contiguous() for d in disp[:2])
    got = tgp.paint_grid(d2)
    assert _launched(gridpm_cuda) == {} and got.is_cuda
    assert torch.equal(got.cpu(), tgp.paint_grid(tuple(d.cpu() for d in d2)))
    with pytest.raises(NotImplementedError, match='gridpm.py:172'):
        tgp.paint_grid(d2, impl='cuda')
    with pytest.raises(NotImplementedError, match='f32, bf16 or f64'):
        tgp.paint_grid(tuple(d.half() for d in disp))
    with pytest.raises(ValueError, match='contiguous'):
        tgp.readout_grid(meshes[0].transpose(0, 2), disp)
    # the wrappers refuse tensors that require grad; paint_grid and
    # readout_grid take them through their autograd Functions, except a
    # diffdir readout, which has no rule on the kernels
    from pmesh_tpu_torch.ops import gridpm_cuda
    grad = tuple(d.clone().requires_grad_() for d in disp)
    with pytest.raises(NotImplementedError, match='gradients'):
        gridpm_cuda.paint_lattice(grad, None, 0, 1, 'cic')
    with pytest.raises(NotImplementedError, match='gridpm.py:482'):
        tgp.readout_grid(meshes[0], grad, diffdir=0)
    with pytest.raises(NotImplementedError, match='gridpm.py:482'):
        tgp.readout_grid(meshes[0], grad, diffdir='all')


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
    # the clustered path's K = 4 -> 4
    'k4': ((-0.5, 1.5), (1.0, 0.5, 0.3, 0.1), 4),
    # the most slots the kernel takes
    'k16': ((-0.5, 1.5), (0.6,) + (0.15,) * 15, 16),
    'k1_offsets_-2_2': ((-1.6, 2.6), (0.8,), 2),
}


# (7, 37, 45): n1 and n2 not multiples of the assign's 8 x 32 tile
@pytest.mark.parametrize("shape", [(2, 3, 4), (5, 8, 130), (64, 64, 64),
                                   (7, 37, 45)])
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
    assert _launched(binned_cuda) == {"rebase_assign": 2, "rebase_apply": 1}
    # f64 runs on the f64 kernels, bitwise its plain version
    binned_cuda.reset_launches()
    d64 = tuple(tuple(x.double() for x in dk) for dk in ds)
    v64 = tuple(v.double() for v in va)
    e64 = tuple(tuple(x.double() for x in dk) for dk in vel)
    got = tbn.rebase(d64, v64, (-0.5, 1.5), extras=(e64,))
    assert _launched(binned_cuda) == {"rebase_assign_f64": 1,
                                      "rebase_apply_f64": 1}
    _assert_same(got, tbn.rebase(d64, v64, (-0.5, 1.5), extras=(e64,),
                                 impl='torch'))
    # a 2-d state takes the plain version; impl='cuda' there raises
    with pytest.raises(NotImplementedError, match='binned.py:289'):
        tbn.rebase(tuple(tuple(x[0] for x in dk[:2]) for dk in ds),
                   tuple(v[0] for v in va), (-0.5, 1.5), impl='cuda')
    with pytest.raises(NotImplementedError, match='slots'):
        tbn.rebase(ds, va, (-0.5, 1.5), nslots_out=17)
    # the kernels read and write f32 only
    with pytest.raises(NotImplementedError, match='f32'):
        binned_cuda.rebase_assign(
            tuple(tuple(x.bfloat16() for x in dk) for dk in ds),
            tuple(v.bfloat16() for v in va), 2, -1, 1)


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


# --- the f64 forms and the f8 paths (csrc/gridpm64.cu, csrc/binned.cu) ------

def _inputs64(seed, shape, bounds, dev):
    rng = np.random.RandomState(seed)

    def t(a):
        return torch.from_numpy(a).to(dev)
    disp = tuple(t(rng.uniform(bounds[0], bounds[1], shape))
                 for _ in range(3))
    mass = t(1 + 0.2 * rng.normal(size=shape))
    meshes = tuple(t(rng.normal(size=shape)) for _ in range(3))
    return disp, mass, meshes


F64_SHAPE, F64_RAGGED = (32, 30, 34), (37, 45, 51)


@pytest.mark.parametrize("window,bounds,shape", [
    ('cic', (-1.0, 1.0), F64_SHAPE), ('cic', (-0.5, 1.5), F64_SHAPE),
    ('cic', (-2.0, 2.0), F64_SHAPE), ('cic', (-2.0, 2.5), F64_SHAPE),
    ('cic', (-3.0, 3.0), F64_SHAPE), ('cic', (-4.5, 5.5), F64_SHAPE),
    ('tsc', (-1.0, 1.5), F64_SHAPE), ('lanczos2', (-1.0, 1.0), F64_SHAPE),
    ('db6', (0.0, 1.0), F64_SHAPE), ('cic', (-1.0, 1.0), F64_RAGGED),
    ('cic', (-2.0, 2.0), F64_RAGGED), ('cic', (-2.0, 2.5), F64_RAGGED),
    ('cic', (-3.0, 3.0), F64_RAGGED), ('cic', (-4.0, 4.0), F64_RAGGED)])
def test_f64_kernels_match_plain(dev, window, bounds, shape):
    """the f64 paint and readout (1 to 3 meshes, derivatives, 'all', a
    mass mesh or a scalar) and their x-halo forms against the plain f64
    versions, 1e-12 of max: they compute in f64 (an f32 computation
    misses by 1e-7); nv 3, 4, 5, 6, 7, 9 (the paint's widest z blocks)
    and 12 (the widest), on a mesh of whole z tiles and a ragged one, (37,
    45, 51), that no tile divides"""
    from pmesh_tpu_torch.ops import gridpm_cuda
    disp, mass, meshes = _inputs64(40, shape, bounds, dev)
    vmin, vmax = tgp.offset_range(*bounds, window)
    gridpm_cuda.reset_launches()
    for diffdir in (None, 1):
        for m in (None, mass, 0.5):
            ref = tgp.paint_grid(disp, m, bounds, window, diffdir,
                                 impl='torch')
            got = tgp.paint_grid(disp, m, bounds, window, diffdir,
                                 impl='cuda')
            assert got.dtype == torch.float64
            assert _rel(got, ref) <= 1e-12, (diffdir, type(m))
    for diffdir, nm in ((None, 1), (None, 3), (2, 2), ('all', 1)):
        refs = tgp.readout_grid(meshes[:nm], disp, bounds, window, diffdir,
                                impl='torch')
        gots = gridpm_cuda.readout_lattice(meshes[:nm], disp, vmin, vmax,
                                           window, diffdir=diffdir)
        for got, ref in zip(gots, refs):
            assert _rel(got, ref) <= 1e-12, (diffdir, nm)
    rows = 9
    lo, hi = max(0, vmax), max(0, -vmin)
    dext = tuple(d[:lo + rows + hi].contiguous() for d in disp)
    mext = mass[:lo + rows + hi].contiguous()
    got = gridpm_cuda.paint_lattice(dext, mext, vmin, vmax, window,
                                    rows=rows, xbase=lo)
    assert _rel(got, tgp.paint_slab_plain(dext, mext, lo, rows, bounds,
                                          window)) <= 1e-12
    lo, hi = max(0, -vmin), max(0, vmax)
    mx = tuple(m[:lo + rows + hi].contiguous() for m in meshes)
    rd = tuple(d[:rows].contiguous() for d in disp)
    gots = gridpm_cuda.readout_lattice(mx, rd, vmin, vmax, window, xbase=lo)
    for g, r in zip(gots, tgp.readout_slab_plain(mx, rd, lo, bounds,
                                                 window)):
        assert _rel(g, r) <= 1e-12
    launched = _launched(gridpm_cuda)
    assert set(launched) == {"paint_lattice_f64", "readout_lattice_f64",
                             "paint_lattice_xhalo_f64",
                             "readout_lattice_xhalo_f64"}


@pytest.mark.parametrize("case", ["k2to3", "wide", "x-halo"])
def test_f64_rebase_bitwise(dev, case):
    """the f64 rebase assign and apply, bitwise their plain versions:
    K = 2 -> 3 in (-0.5, 1.5), K = 2 -> 2 with 64 offsets, and the x-halo
    form of a slab"""
    from pmesh_tpu_torch.ops import binned as tbn
    from pmesh_tpu_torch.ops import binned_cuda
    bounds, fill, kout = {"k2to3": ((-0.5, 1.5), (1.0, 0.25), 3),
                          "wide": ((-2.0, 2.0), (1.0, 0.1), 2),
                          "x-halo": ((-0.5, 1.5), (1.0, 0.25), 2)}[case]
    ds, va, vel = _slot_state(41, (24, 20, 34), bounds[0] + 0.01,
                              bounds[1] - 0.01, fill, dev)
    ds, vel = (tuple(tuple(x.double() for x in dk) for dk in s)
               for s in (ds, vel))
    va = tuple(v.double() for v in va)
    offsets = tbn._drift_offsets(bounds, 3)
    lo, hi = offsets[0][0], offsets[-1][0]
    if case == "x-halo":
        xb, rows = max(0, hi), 10
        got = binned_cuda.rebase_assign(ds, va, kout, lo, hi, rows=rows,
                                        xbase=xb)
        ref = tbn.rebase_assign_plain(ds, va, offsets, kout, rows=rows,
                                      xbase=xb)
        _assert_same(got[:3], ref[:3])
        _assert_same(binned_cuda.rebase_apply((vel,), got[2], lo, hi,
                                              xbase=xb),
                     tbn.rebase_apply_plain((vel,), ref[2], offsets,
                                            xbase=xb))
        return
    ref = tbn.rebase_assign_plain(ds, va, offsets, kout)
    got = binned_cuda.rebase_assign(ds, va, kout, lo, hi)
    _assert_same(got, ref)
    assert got[0][0][0].dtype == torch.float64
    _assert_same(binned_cuda.rebase_apply((vel,), got[2], lo, hi),
                 tbn.rebase_apply_plain((vel,), ref[2], offsets))


def _f8_runs(device, n=32):
    """force_lattice, nbody_lattice (lpt + 3 KDK steps) and an adaptive
    4-step nbody_binned (phase 7's binned run) at n^3 in f8 on
    ``device``, and the launch counters of each run"""
    from pmesh_tpu_torch import ParticleMesh
    from pmesh_tpu_torch.models.fastpm import Solver
    from pmesh_tpu_torch.ops import binned_cuda, gridpm_cuda
    rng = np.random.RandomState(42)
    pm = ParticleMesh([n] * 3, BoxSize=2.0 * n, dtype='f8', device=device)
    noise = pm.create(type='real', value=torch.from_numpy(
        rng.normal(size=(n,) * 3)).to(pm.device))
    dlin = noise.r2c().apply(lambda k, v: 0.5 * v * torch.where(
        k.normp(2) > 0, k.normp(2, zeromode=1.0) ** -0.75, 0.0))
    s = Solver(pm)
    out = {}
    for mod in (gridpm_cuda, binned_cuda):
        mod.reset_launches()
    S, V = s.lpt_lattice(dlin, 0.1, order=2)
    out['force'] = s.force_lattice(S, (-1.0, 1.0))
    S, V = s.nbody_lattice(S, V, np.linspace(0.1, 0.2, 4),
                           bounds=(-1.0, 1.0))
    out['lattice'] = S + V
    out['lattice_launches'] = _launched(gridpm_cuda)
    gridpm_cuda.reset_launches()
    disp = rng.uniform(-0.6, 1.6, (3,) + (n,) * 3)
    vel = 0.3 * rng.normal(size=(3,) + (n,) * 3)
    ds, vs, va, ov = s.nbody_binned(
        tuple(torch.from_numpy(x).to(pm.device) for x in disp),
        tuple(torch.from_numpy(x).to(pm.device) for x in vel),
        np.linspace(0.5, 0.6, 5), nslots=1, rebase_every=2,
        step_drift=0.5, adaptive=True)
    out['binned'] = tuple(x for d in ds for x in d) + tuple(va)
    out['overflow'] = int(ov)
    out['binned_launches'] = dict(_launched(gridpm_cuda),
                                  **_launched(binned_cuda))
    return out


def test_f8_paths_card_match_cpu(dev):
    """force_lattice, nbody_lattice and nbody_binned in f8 at 32^3 on the
    f64 kernels (the launch counters show only f64 forms) against the
    CPU, 1e-10 of max"""
    got, ref = _f8_runs(dev), _f8_runs('cpu')
    assert len(got['binned']) == len(ref['binned'])
    assert set(got['lattice_launches']) == {"paint_lattice_f64",
                                            "readout_lattice_f64"}
    assert {"paint_lattice_f64", "readout_lattice_f64", "rebase_assign_f64",
            "rebase_apply_f64"} == set(got['binned_launches'])
    assert ref['lattice_launches'] == {} == ref['binned_launches']
    assert got['overflow'] == ref['overflow'] == 0
    for key in ('force', 'lattice', 'binned'):
        for g, r in zip(got[key], ref[key]):
            assert g.dtype == torch.float64
            assert _rel(g.cpu(), r) <= 1e-10, key


def test_2d_lattice_plain_on_card(dev):
    """a 2-d lattice run on the card takes the plain version, as the JAX
    package takes XLA: no kernel launch, the CPU's answer"""
    from pmesh_tpu_torch import ParticleMesh
    from pmesh_tpu_torch.models.fastpm import Solver
    from pmesh_tpu_torch.ops import gridpm_cuda
    n = 64
    rng = np.random.RandomState(3)
    disp = rng.uniform(-0.3, 0.3, (2, n, n))
    vel = 0.05 * rng.normal(size=(2, n, n))
    out = []
    for device in ('cpu', dev):
        pm = ParticleMesh([n] * 2, BoxSize=float(n), dtype='f8',
                          device=device)
        gridpm_cuda.reset_launches()
        S, V = Solver(pm).nbody_lattice(
            tuple(torch.from_numpy(x).to(pm.device) for x in disp),
            tuple(torch.from_numpy(x).to(pm.device) for x in vel),
            np.linspace(0.2, 0.5, 4), bounds=(-1.0, 1.0))
        assert _launched(gridpm_cuda) == {}
        out.append(S + V)
    for g, r in zip(out[1], out[0]):
        assert bool(torch.isfinite(g).all()) and _rel(g.cpu(), r) <= 1e-10


def test_mxu_f64_input_cast_on_card(dev):
    """an f64 mesh enters the fft='mxu' kernels cast to f32 at the pass
    boundary, as the JAX package casts it: the f32 input's answer,
    bitwise, in f32"""
    from pmesh_tpu_torch.ops import fft_mxu as fm
    x = _fft_inputs(12, (256, 256, 16), dev)[0].double()
    got = fm.fft3_real_forward_half_ct2(x)
    ref = fm.fft3_real_forward_half_ct2(x.float())
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and torch.equal(g, r)


# --- the split-Nyquist CT DFT kernels (csrc/fft_mxu.cu) ----------------------

def _fft_inputs(seed, shape, dev):
    rng = np.random.RandomState(seed)
    return tuple(torch.from_numpy(rng.normal(size=shape).astype('f4')).to(dev)
                 for _ in range(3))


def _sl(n, half=False):
    """a SuperLanczos-shaped wavenumber table, zero at Nyquist"""
    w = (np.fft.rfftfreq(n) if half else np.fft.fftfreq(n)) * 2 * np.pi
    return tuple(((8 * np.sin(w) - np.sin(2 * w)) / 6.0).tolist())


@pytest.mark.parametrize("n", [256, 512, 1024])
@pytest.mark.parametrize("n2", [16, 512, 1024])
def test_fft_mxu_kernels_match_plain(dev, n, n2):
    from pmesh_tpu_torch.ops import fft_mxu as fm
    Zm = n2 // 2
    x, _, _ = _fft_inputs(9, (4, n, n2), dev)
    wz, wy = fm._z_fwd_tabs(n2, Zm), fm._ct_fwd_mats_np(n)
    for g, r in zip(fm._zy_fwd_ct2_call(x, n2, Zm, wz, wy, impl='cuda'),
                    fm._zy_fwd_ct2_call(x, n2, Zm, wz, wy, impl='torch')):
        assert _rel(g, r) <= TOL
    # the x pass on an (n, 4, Zm) block: forward x scale, inverse, dual
    # inverse with the 1/k^2 fold
    pr, pi, _ = _fft_inputs(10, (n, 4, Zm), dev)
    rng = np.random.RandomState(11)
    k2 = [rng.uniform(0.0, 2.0, m).astype('f4') for m in (n, 4, Zm)]
    for t in k2:
        t[0] = 0.0
    wi = fm._ct_inv_mats_np(n)
    wg = fm._ct_inv_mats_np(n, fold_kvec=_sl(n))
    for kw in (dict(wx=fm._ct_fwd_mats_np(n), scale=1.0 / n ** 3),
               dict(wx=wi, scale=1.0, inverse=True),
               dict(wx=wi, scale=1.0, inverse=True, wx2=wg, k2=k2)):
        got = fm._xct_call_multi(pr, pi, impl='cuda', **kw)
        ref = fm._xct_call_multi(pr, pi, impl='torch', **kw)
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            assert _rel(g, r) <= TOL
    # the inverse passes, with and without the Nyquist plane
    rr, ii, _ = _fft_inputs(12, (4, n, Zm), dev)
    plane = _fft_inputs(13, (4, n), dev)[0]
    Wy, Wyg = fm._ct_inv_mats_np(n), fm._ct_inv_mats_np(n, fold_kvec=_sl(n))
    AB = fm._z_inv_tabs(n2, Zm)
    ABg = fm._z_inv_tabs(n2, Zm, grad_kvec=_sl(n2, half=True))
    for pl in (None, plane):
        for tabs in ((Wy, AB), (Wyg, ABg)):
            g = fm._zy_inv_ct2_call(rr, ii, *tabs, n2, plane=pl, impl='cuda')
            r = fm._zy_inv_ct2_call(rr, ii, *tabs, n2, plane=pl,
                                    impl='torch')
            assert _rel(g, r) <= TOL
        got = fm._zy_inv_ct2_call_dual(rr, ii, Wyg, AB, Wy, ABg, n2,
                                       planeA=pl, impl='cuda')
        ref = fm._zy_inv_ct2_call_dual(rr, ii, Wyg, AB, Wy, ABg, n2,
                                       planeA=pl, impl='torch')
        for g, r in zip(got, ref):
            assert _rel(g, r) <= TOL


@pytest.mark.parametrize("shape", [(256, 256, 16), (512, 256, 1024)])
def test_fft_mxu_public_operators_match_plain(dev, shape):
    """the forward, the force triple with the 1/k^2 fold and each
    only=d direction, and the Poisson potential, card against plain"""
    from pmesh_tpu_torch.ops import fft_mxu as fm
    N0, N1, n2 = shape
    x = (1.0 + 0.3 * _fft_inputs(14, shape, dev)[0]).contiguous()
    kd = (_sl(N0), _sl(N1), _sl(n2, half=True))
    k2 = tuple(tuple(float(v) ** 2 for v in t) for t in kd)
    out = {}
    for impl in ('cuda', 'torch'):
        spec = fm.fft3_real_forward_half_ct2(x, impl=impl)
        tri = fm.fft3_real_inverse_grad3_half_ct2(*spec, n2=n2, kvecs=kd,
                                                  poisson_k2=k2, impl=impl)
        one = [fm.fft3_real_inverse_grad3_half_ct2(
            *spec, n2=n2, kvecs=kd, poisson_k2=k2, only=d, impl=impl)
            for d in range(3)]
        phi = fm.fft3_poisson_half_ct2(*spec, n2=n2, poisson_k2=k2,
                                       impl=impl)
        out[impl] = list(spec) + list(tri) + one + [phi]
    for g, r in zip(out['cuda'], out['torch']):
        assert _rel(g, r) <= TOL
    for d in range(3):
        assert _rel(out['cuda'][7 + d], out['cuda'][4 + d]) <= TOL


def test_fft_mxu_kernels_refuse_what_they_cannot_run(dev):
    """an f16 input, a strided one, one that requires grad and shapes or
    tables off the ct2 rule raise; an f64 input is cast to f32 at the
    pass boundary, as the JAX package casts it (its f32 answer)"""
    from pmesh_tpu_torch.ops import fft_mxu as fm
    n2, Zm = 16, 8
    x, _, _ = _fft_inputs(15, (2, 256, n2), dev)
    wz, wy = fm._z_fwd_tabs(n2, Zm), fm._ct_fwd_mats_np(256)
    with pytest.raises(NotImplementedError, match='f32'):
        fm._zy_fwd_ct2_call(x.half(), n2, Zm, wz, wy)
    assert all(torch.equal(a, b) for a, b in zip(
        fm._zy_fwd_ct2_call(x.double(), n2, Zm, wz, wy),
        fm._zy_fwd_ct2_call(x, n2, Zm, wz, wy)))
    with pytest.raises(ValueError, match='contiguous'):
        fm._zy_fwd_ct2_call(x.transpose(0, 1).contiguous().transpose(0, 1),
                            n2, Zm, wz, wy)
    with pytest.raises(NotImplementedError, match='gradients'):
        fm._zy_fwd_ct2_call(x.clone().requires_grad_(), n2, Zm, wz, wy)
    with pytest.raises(ValueError, match='ct2'):
        fm._zy_fwd_ct2_call(x[:, :192].contiguous(), n2, Zm, wz, wy)
    pr, pi, _ = _fft_inputs(16, (384, 2, Zm), dev)
    with pytest.raises(ValueError, match='ct2'):
        fm._xct_call_multi(pr, pi, fm._ct_inv_mats_np(384), 1.0,
                           inverse=True)
    with pytest.raises(ValueError, match='ct2'):
        fm.fft3_real_forward_half_ct2(torch.zeros((16,) * 3, device=dev))
    # a table of the wrong shape raises before any launch: the
    # split-precision routine does not fall back to another product
    from pmesh_tpu_torch.ops import fft_mxu_cuda
    fft_mxu_cuda.reset_launches()
    bad = tuple(np.ascontiguousarray(w[:, :64]) for w in wy)
    with pytest.raises(ValueError, match='table of shape'):
        fm._zy_fwd_ct2_call(x, n2, Zm, wz, bad)
    pr, pi, _ = _fft_inputs(16, (256, 2, Zm), dev)
    wi = fm._ct_inv_mats_np(256)
    with pytest.raises(ValueError, match='table of shape'):
        fm._xct_call_multi(pr, pi, tuple(w[:1] for w in wi), 1.0,
                           inverse=True)
    with pytest.raises(ValueError, match='table of shape'):
        fm._xct_call_multi(pr, pi, wi, 1.0, inverse=True,
                           wx2=tuple(w[:, :, :64] for w in wi))
    assert _launched(fft_mxu_cuda) == {}


def _launched(module):
    """the nonzero launch counters of a wrapper module"""
    return {k: v for k, v in module.LAUNCHES.items() if v}


# --- the split-precision tensor-core routine of zy_fwd_ct2 and xct_multi ---

def test_tc_zy_fwd_slab_matches_plain(dev):
    """the slab of chip_smoke.py (z = 1024: the Rz = 8 z-CT; y = 512),
    a mesh with a mean, as a density has"""
    from pmesh_tpu_torch.ops import fft_mxu as fm
    shape = (16, 512, 1024)
    x = (1.0 + 0.3 * _fft_inputs(30, shape, dev)[0]).contiguous()
    wz, wy = fm._z_fwd_tabs(1024, 512), fm._ct_fwd_mats_np(512)
    got = fm._zy_fwd_ct2_call(x, 1024, 512, wz, wy, impl='cuda')
    ref = fm._zy_fwd_ct2_call(x, 1024, 512, wz, wy, impl='torch')
    for g, r in zip(got, ref):
        assert _rel(g, r) <= TOL


@pytest.mark.parametrize("shape", [(256, 4, 257), (1024, 4, 16),
                                   (512, 3, 5)])
def test_tc_xct_multi_matches_plain(dev, shape):
    """row 13's half-CT width W = 257 (zero-filled tiles at the ragged
    edge), R = 8 (the 1024^3 chain's x pass), rows that are not 16-byte
    aligned (3 x 5); forward on data with a mean, the dual inverse with
    the 1/k^2 fold"""
    from pmesh_tpu_torch.ops import fft_mxu as fm
    N0, n1, W = shape
    pr, pi, _ = _fft_inputs(31, shape, dev)
    pr = (pr + 4.0).contiguous()
    rng = np.random.RandomState(32)
    k2 = [rng.uniform(0.0, 2.0, m).astype('f4') for m in shape]
    for t in k2:
        t[0] = 0.0
    wi = fm._ct_inv_mats_np(N0)
    for kw in (dict(wx=fm._ct_fwd_mats_np(N0), scale=1.0 / N0),
               dict(wx=wi, scale=1.0, inverse=True,
                    wx2=fm._ct_inv_mats_np(N0, fold_kvec=_sl(N0)), k2=k2)):
        got = fm._xct_call_multi(pr, pi, impl='cuda', **kw)
        ref = fm._xct_call_multi(pr, pi, impl='torch', **kw)
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            assert _rel(g, r) <= TOL


def _bf16_storage_ok(got, ref, got32, ref32, share=1e-3):
    """chip_smoke.py's bf16 storage criterion: bitwise equal but for at
    most ``share`` of the entries, none more than one bf16 ulp beyond
    the gap of the two f32 sums it rounds"""
    for g, r, g32, r32 in zip(got, ref, got32, ref32):
        assert g.dtype == r.dtype == torch.bfloat16
        gf, rf = g.float(), r.float()
        m = torch.maximum(gf.abs(), rf.abs())
        ulp = torch.exp2(torch.floor(torch.log2(
            torch.where(m > 0, m, torch.ones_like(m)))) - 7)
        assert float((gf != rf).float().mean()) <= share
        assert int(((gf - rf).abs() > ulp + (g32 - r32).abs()).sum()) == 0


def test_tc_bf16_storage_matches_plain(dev):
    """the bf16s form (bf16 loads upcast, f32 products, each store
    rounded once) of both entry points: bitwise the f32 form's output on
    the same values rounded to bf16, and the f32 form within TOL of the
    plain version"""
    from pmesh_tpu_torch.ops import fft_mxu as fm
    bf = torch.bfloat16
    x = _fft_inputs(33, (4, 512, 512), dev)[0]
    wz, wy = fm._z_fwd_tabs(512, 256), fm._ct_fwd_mats_np(512)

    def zy(impl, dt):
        return fm._zy_fwd_ct2_call(x, 512, 256, wz, wy, out_dtype=dt,
                                   impl=impl)[:2]

    def check(got16, got32, ref32):
        for g16, g32, r32 in zip(got16, got32, ref32):
            assert g16.dtype == bf
            assert torch.equal(g16, g32.to(bf))
            assert _rel(g32, r32) <= TOL
    check(zy('cuda', bf), zy('cuda', None), zy('torch', None))
    pr, pi = zy('cuda', bf)
    pr, pi = pr.transpose(0, 1).contiguous(), pi.transpose(0, 1).contiguous()
    wi = fm._ct_inv_mats_np(512)
    for kw in (dict(wx=wy, scale=1.0 / 512),
               dict(wx=wi, scale=1.0, inverse=True, wx2=wi)):
        def xp(impl, a, b, dt):
            return fm._xct_call_multi(a, b, out_dtype=dt, impl=impl, **kw)
        check(xp('cuda', pr, pi, bf), xp('cuda', pr.float(), pi.float(), None),
              xp('torch', pr.float(), pi.float(), None))


def test_tc_force_transposes_card_match_cpu(dev):
    """the reverse-mode transposes of the mxu force (_MxuForce.backward:
    one only=d force per direction on a cotangent), card against CPU"""
    from pmesh_tpu_torch import ParticleMesh
    from pmesh_tpu_torch.models.fastpm import Solver
    shape = (256, 256, 16)
    ct = _fft_inputs(34, shape, dev)
    out = {}
    for d in (dev, torch.device('cpu')):
        pm = ParticleMesh(shape, BoxSize=np.asarray(shape, float),
                          dtype='f4', device=d)
        solver = Solver(pm)
        out[d.type] = [solver._mxu_force_raw(c.to(d).contiguous(),
                                             (None, None), only=k)
                       for k, c in enumerate(ct)]
    for g, r in zip(out['cuda'], out['cpu']):
        assert _rel(g.cpu(), r) <= TOL


def test_bf16_lattice_kernels_match_plain(dev):
    """the bf16 storage form of the lattice paint and readout: f32
    weights and sums, each output rounded once, kernel against plain"""
    from pmesh_tpu_torch.ops import gridpm_cuda
    bounds = (-1.0, 1.5)
    disp, mass, meshes = _inputs(35, (24, 20, 36), bounds, dev)
    bf = torch.bfloat16
    d16, m16 = tuple(d.to(bf) for d in disp), tuple(m.to(bf) for m in meshes)
    vmin, vmax = tgp.offset_range(*bounds, 'cic')
    gridpm_cuda.reset_launches()
    for mass_ in (None, mass.to(bf)):
        got = tgp.paint_grid(d16, mass_, bounds, impl='cuda')
        ref = tgp.paint_grid(d16, mass_, bounds, impl='torch')
        up = None if mass_ is None else mass_.float()
        _bf16_storage_ok((got,), (ref,),
                         (tgp.paint_grid(tuple(d.float() for d in d16), up,
                                         bounds, impl='cuda'),),
                         (tgp.paint_grid(tuple(d.float() for d in d16), up,
                                         bounds, impl='torch'),))
    got = gridpm_cuda.readout_lattice(m16, d16, vmin, vmax, 'cic')
    ref = tgp.readout_grid(m16, d16, bounds, impl='torch')
    f32 = tuple(d.float() for d in d16), tuple(m.float() for m in m16)
    _bf16_storage_ok(got, ref,
                     gridpm_cuda.readout_lattice(f32[1], f32[0], vmin, vmax,
                                                 'cic'),
                     tgp.readout_grid(f32[1], f32[0], bounds, impl='torch'))
    assert _launched(gridpm_cuda) == {
        "paint_lattice_bf16": 2, "readout_lattice_bf16": 1,
        "paint_lattice": 2, "readout_lattice": 1}


@pytest.mark.parametrize("mode,counts", [
    ('spectral', {"zy_fwd_ct2": 1, "xct_multi": 2, "zy_inv_ct2": 1,
                  "zy_inv_ct2_dual": 1}),
    ('gradient', {"zy_fwd_ct2": 1, "xct_multi": 2, "zy_inv_ct2": 1,
                  "zy_inv_ct2_dual": 0})])
def test_fft_mxu_launches_count_one_force(dev, mode, counts):
    from pmesh_tpu_torch import ParticleMesh
    from pmesh_tpu_torch.models.fastpm import Solver
    from pmesh_tpu_torch.ops import fft_mxu_cuda
    shape = (256, 256, 16)
    pm = ParticleMesh(shape, BoxSize=np.asarray(shape, float), dtype='f4',
                      device=dev)
    disp, _, _ = _inputs(17, shape, (0.0, 1.0), dev)
    fft_mxu_cuda.reset_launches()
    Solver(pm).force_lattice(disp, (0.0, 1.0), mode=mode, fft='mxu')
    assert _launched(fft_mxu_cuda) == {k: v for k, v in counts.items() if v}


@pytest.mark.parametrize("force_mode,window", [('spectral', 'cic'),
                                               ('gradient', 'tsc')])
def test_nbody_lattice_mxu_card_matches_cpu(dev, force_mode, window):
    from pmesh_tpu_torch import ParticleMesh, RealField
    from pmesh_tpu_torch.models.fastpm import Solver
    shape = (256, 256, 16)
    noise = np.random.RandomState(5).normal(size=shape).astype('f4')
    out = []
    for device in ('cpu', dev):
        pm = ParticleMesh(shape, BoxSize=np.asarray(shape, float),
                          dtype='f4', device=device)
        dk = pm.create(type=RealField,
                       value=torch.from_numpy(noise).to(device)).r2c()
        dk = dk.apply(lambda k, v: 0.3 * v * torch.where(
            k.normp(2) > 0, k.normp(2, zeromode=1.0) ** -0.375, 0.0))
        solver = Solver(pm, force_resampler=window)
        disp, vel = solver.lpt_lattice(dk, 0.1, order=2)
        S, V = solver.nbody_lattice(disp, vel, np.linspace(0.1, 0.4, 4),
                                    (-1.0, 1.0), force_mode=force_mode,
                                    fft='mxu')
        out.append([x.cpu() for x in S + V])
    smax = max(float(s.abs().max()) for s in out[0][:3])
    assert 0.01 < smax < 1.0
    for ref, got in zip(*out):
        assert _rel(got, ref) <= 1e-4


# --- the dense DFT kernels (csrc/fft_mxu.cu, rows 3 and 4) -------------------

@pytest.mark.parametrize("shape", [(96, 96, 96), (45, 38, 75)])
def test_fft_dense_kernels_match_plain(dev, shape):
    from pmesh_tpu_torch.ops import fft_mxu as fm
    N0, N1, n2 = shape
    Zh = n2 // 2 + 1
    x, _, _ = _fft_inputs(20, shape, dev)
    wz, wy = fm._dft_half_np(n2, Zh), fm._dft_np(N1, -1)
    for g, r in zip(fm._zy_fwd_dense_call(x, wz, wy, impl='cuda'),
                    fm._zy_fwd_dense_call(x, wz, wy, impl='torch')):
        assert _rel(g, r) <= TOL
    # the x pass: forward x scale, inverse, dual inverse with 1/k^2
    pr, pi, _ = _fft_inputs(21, (N0, N1, Zh), dev)
    rng = np.random.RandomState(22)
    k2 = [rng.uniform(0.0, 2.0, m).astype('f4') for m in (N0, N1, Zh)]
    for t in k2:
        t[0] = 0.0
    wi, wg = fm._dft_np(N0, +1), fm._dft_fold_np(N0, _sl(N0))
    for kw in (dict(wx=fm._dft_np(N0, -1), scale=1.0 / x.numel()),
               dict(wx=wi, scale=1.0),
               dict(wx=wi, scale=1.0, wx2=wg, k2=k2)):
        got = fm._x_dense_call(pr, pi, impl='cuda', **kw)
        ref = fm._x_dense_call(pr, pi, impl='torch', **kw)
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            assert _rel(g, r) <= TOL
    # the zy inverse with the fx, fy and fz tables
    wyi, wyg = fm._dft_np(N1, +1), fm._dft_fold_np(N1, _sl(N1))
    AB = fm._irfft_mats_np(n2, Zh)
    ABg = fm._irfft_mats_np(n2, Zh, grad_kvec=_sl(n2, half=True))
    for tabs in ((wyi, AB), (wyg, AB), (wyi, ABg)):
        g = fm._zy_inv_dense_call(pr, pi, *tabs, impl='cuda')
        r = fm._zy_inv_dense_call(pr, pi, *tabs, impl='torch')
        assert g.shape == (N0, N1, n2) and _rel(g, r) <= TOL


@pytest.mark.parametrize("shape", [(96, 96, 96), (45, 38, 75)])
def test_fft_dense_public_operators_match_plain(dev, shape):
    """the forward, and the force triple plain and with the 1/k^2
    fold, card against plain"""
    from pmesh_tpu_torch.ops import fft_mxu as fm
    N0, N1, n2 = shape
    x = (1.0 + 0.3 * _fft_inputs(23, shape, dev)[0]).contiguous()
    kd = (_sl(N0), _sl(N1), _sl(n2, half=True))
    k2 = tuple(tuple(float(v) ** 2 for v in t) for t in kd)
    out = {}
    for impl in ('cuda', 'torch'):
        spec = fm.fft3_real_forward_half(x, impl=impl)
        tri = fm.fft3_real_inverse_grad3_half(*spec, n2, kd, impl=impl)
        folded = fm.fft3_real_inverse_grad3_half(*spec, n2, kd,
                                                 poisson_k2=k2, impl=impl)
        out[impl] = list(spec) + list(tri) + list(folded)
    for g, r in zip(out['cuda'], out['torch']):
        assert _rel(g, r) <= TOL


def test_fft_dense_kernels_refuse_what_they_cannot_run(dev):
    """as the ct2 passes: f16 refused, f64 cast to f32 at the pass"""
    from pmesh_tpu_torch.ops import fft_mxu as fm
    x, _, _ = _fft_inputs(24, (6, 10, 9), dev)
    wz, wy = fm._dft_half_np(9, 5), fm._dft_np(10, -1)
    with pytest.raises(NotImplementedError, match='f32'):
        fm._zy_fwd_dense_call(x.half(), wz, wy)
    assert all(torch.equal(a, b) for a, b in zip(
        fm._zy_fwd_dense_call(x.double(), wz, wy),
        fm._zy_fwd_dense_call(x, wz, wy)))
    with pytest.raises(ValueError, match='contiguous'):
        fm._zy_fwd_dense_call(x.transpose(0, 1).contiguous().transpose(0, 1),
                              wz, wy)
    with pytest.raises(NotImplementedError, match='gradients'):
        fm._zy_fwd_dense_call(x.clone().requires_grad_(), wz, wy)
    with pytest.raises(ValueError, match='table'):
        fm._zy_fwd_dense_call(x, wz, fm._dft_np(12, -1))
    r, i, _ = _fft_inputs(25, (6, 10, 5), dev)
    with pytest.raises(ValueError, match='table'):
        fm._x_dense_call(r, i, fm._dft_np(5, +1), 1.0)
    with pytest.raises(ValueError, match='Zh'):
        fm._zy_inv_dense_call(r, i, fm._dft_np(10, +1),
                              fm._irfft_mats_np(12, 7))


@pytest.mark.parametrize("mode,counts", [
    ('spectral', {"zy_fwd_half": 1, "x_dense": 2, "zy_inv_half": 3}),
    ('gradient', {"zy_fwd_half": 0, "x_dense": 0, "zy_inv_half": 0})])
def test_fft_dense_launches_count_one_force(dev, mode, counts):
    """one spectral force at a shape that is not ct2 runs the dense
    kernels and no ct2 kernel; the gradient mode there takes the field
    path (cuFFT), as the JAX package does"""
    from pmesh_tpu_torch import ParticleMesh
    from pmesh_tpu_torch.models.fastpm import Solver
    from pmesh_tpu_torch.ops import fft_mxu_cuda
    shape = (48, 40, 33)
    pm = ParticleMesh(shape, BoxSize=np.asarray(shape, float), dtype='f4',
                      device=dev)
    disp, _, _ = _inputs(26, shape, (0.0, 1.0), dev)
    fft_mxu_cuda.reset_launches()
    Solver(pm).force_lattice(disp, (0.0, 1.0), mode=mode, fft='mxu')
    assert _launched(fft_mxu_cuda) == {k: v for k, v in counts.items() if v}


@pytest.mark.parametrize("shape", [(48, 40, 33), (32, 32, 32)])
def test_nbody_lattice_dense_mxu_card_matches_cpu(dev, shape):
    from pmesh_tpu_torch import ParticleMesh, RealField
    from pmesh_tpu_torch.models.fastpm import Solver
    noise = np.random.RandomState(27).normal(size=shape).astype('f4')
    out = []
    for device in ('cpu', dev):
        pm = ParticleMesh(shape, BoxSize=np.asarray(shape, float),
                          dtype='f4', device=device)
        dk = pm.create(type=RealField,
                       value=torch.from_numpy(noise).to(device)).r2c()
        dk = dk.apply(lambda k, v: 0.3 * v * torch.where(
            k.normp(2) > 0, k.normp(2, zeromode=1.0) ** -0.375, 0.0))
        solver = Solver(pm)
        disp, vel = solver.lpt_lattice(dk, 0.1, order=2)
        S, V = solver.nbody_lattice(disp, vel, np.linspace(0.1, 0.4, 4),
                                    (-1.0, 1.0), fft='mxu')
        out.append([x.cpu() for x in S + V])
    smax = max(float(s.abs().max()) for s in out[0][:3])
    assert 0.01 < smax < 1.0
    for ref, got in zip(*out):
        assert _rel(got, ref) <= 1e-4


# --- the dense forward passes on the tensor cores (tc_gemm) -----------------

@pytest.mark.parametrize("shape", [(33, 75, 130), (75, 40, 33)])
def test_tc_dense_matches_plain(dev, shape):
    """x_dense and zy_fwd_half on tc_gemm at ragged shapes (x and y
    lengths 33 and 75: tables padded to whole tiles and slices, column 0
    chained by the guarded ct_fwd_col0; Zh = 66: the z stage's two tail
    modes chained; Zh = 17 and 66: z rows not 16-byte aligned) on a mesh
    with a mean, in both forms: f32 within TOL of plain, bf16 products
    by the bf16 criteria (x pass 5e-4 of max, zy pass ZY); the x pass
    forward, dual with the 1/k^2 fold, and dual on a spectrum filtered
    beforehand"""
    from pmesh_tpu_torch.ops import fft_mxu as fm
    N0, N1, n2 = shape
    Zh = n2 // 2 + 1
    x = (1.0 + 0.3 * _fft_inputs(60, shape, dev)[0]).contiguous()
    wz, wy = fm._dft_half_np(n2, Zh), fm._dft_np(N1, -1)
    for g, r in zip(fm._zy_fwd_dense_call(x, wz, wy, impl='cuda'),
                    fm._zy_fwd_dense_call(x, wz, wy, impl='torch')):
        assert _rel(g, r) <= TOL
    _assert_bf16_close(_products(
        lambda impl, **k: fm._zy_fwd_dense_call(x, wz, wy, impl=impl, **k)),
        ZY)
    pr, pi = fm._zy_fwd_dense_call(x, wz, wy, impl='torch')
    rng = np.random.RandomState(61)
    k2 = [rng.uniform(0.0, 2.0, m).astype('f4') for m in (N0, N1, Zh)]
    for t in k2:
        t[0] = 0.0
    wi, wg = fm._dft_np(N0, +1), fm._dft_fold_np(N0, _sl(N0))
    # and the dual on a spectrum filtered by 1/k^2 beforehand (row 13's
    # force triple): its kx = 0 row far above the rest
    kk = sum(torch.as_tensor(t, device=dev).reshape(
        [-1 if e == d else 1 for e in range(3)]) for d, t in enumerate(k2))
    invk2 = torch.where(kk > 0, 1.0 / torch.where(kk > 0, kk, 1.0), 0.0)
    fr, fi = (pr * invk2).contiguous(), (pi * invk2).contiguous()
    for a, b, kw in ((pr, pi, dict(wx=fm._dft_np(N0, -1),
                                   scale=1.0 / x.numel())),
                     (pr, pi, dict(wx=wi, scale=1.0, wx2=wg, k2=k2)),
                     (fr, fi, dict(wx=wi, scale=1.0, wx2=wg))):
        got = fm._x_dense_call(a, b, impl='cuda', **kw)
        ref = fm._x_dense_call(a, b, impl='torch', **kw)
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            assert _rel(g, r) <= TOL
        _assert_bf16_close(_products(
            lambda impl, **k: fm._x_dense_call(a, b, impl=impl, **k,
                                               **kw)))


def test_tc_dense_launches_no_cgemm(dev):
    """the three entry points in every form (f32 and bf16 products;
    forward, dual inverse with 1/k^2, row 13's full width, the zy
    inverse) launch the split passes and tc_gemm (the C entry points'
    counts by kind, among which the FP32 cgemm is no more); one dense
    spectral force launches exactly its passes' tc_gemm, split and chain
    kernels"""
    from pmesh_tpu_torch import ParticleMesh
    from pmesh_tpu_torch.models.fastpm import Solver
    from pmesh_tpu_torch.ops import fft_mxu as fm
    from pmesh_tpu_torch.ops import fft_mxu_cuda as fk
    shape = (48, 40, 33)
    N0, N1, n2 = shape
    Zh = n2 // 2 + 1
    x = (1.0 + 0.3 * _fft_inputs(62, shape, dev)[0]).contiguous()
    pr, pi, _ = _fft_inputs(63, (N0, N1, Zh), dev)
    k2 = [np.linspace(0.0, 1.0, m).astype('f4') for m in (N0, N1, Zh)]
    wx, wg = fm._dft_np(N0, +1), fm._dft_fold_np(N0, _sl(N0))
    calls = {
        'zy_fwd_half': lambda b: fk.zy_fwd_half(
            x, fm._dft_half_np(n2, Zh), fm._dft_np(N1, -1), bf16=b),
        'zy_fwd_full': lambda b: fk.zy_fwd_full(
            x, fm._dft_np(n2, -1), fm._dft_np(N1, -1), bf16=b),
        'x_dense': lambda b: fk.x_dense(pr, pi, fm._dft_np(N0, -1),
                                        1.0 / N0, bf16=b),
        'x_dense dual': lambda b: fk.x_dense(pr, pi, wx, 1.0, wx2=wg,
                                             k2=k2, bf16=b),
        'zy_inv_half': lambda b: fk.zy_inv_half(
            pr, pi, fm._dft_np(N1, +1), fm._irfft_mats_np(n2, Zh), bf16=b)}
    for name, call in calls.items():
        for b in (False, True):
            fk.kernel_launches(reset=True)
            call(b)
            ks = fk.kernel_launches(reset=True)
            stages = 2 if name.startswith('zy') else 1
            assert ks['tc_gemm'] == stages and ks['split'] == stages, (
                name, b, ks)
            assert 'cgemm' not in ks and 'cgemm_bf16' not in ks, ks
    pm = ParticleMesh(shape, BoxSize=np.asarray(shape, float), dtype='f4',
                      device=dev)
    disp, _, _ = _inputs(64, shape, (0.0, 1.0), dev)
    fk.kernel_launches(reset=True)
    Solver(pm).force_lattice(disp, (0.0, 1.0), mode='spectral', fft='mxu')
    ks = fk.kernel_launches(reset=True)
    # zy_fwd_half: z and y stages; x_dense forward and dual; the three
    # zy_inv_half's y and z stages; the forward y stage and the forward x
    # pass chain column 0
    assert ks == dict(tc_ct=0, tc_z=0, tc_gemm=10, split=10,
                      ct_fwd_col0=2), ks


def test_tc_ct2_bf16_launches_no_cgemm(dev):
    """the bf16-product forms of xct_multi (forward, inverse, dual
    inverse with 1/k^2), zy_fwd_ct2 (z-CT and dense z stages) and the zy
    inverses (single and dual, dense and z-CT z stages), on f32 and bf16
    spectra, launch split passes and tc_gemm alone (the C entry points'
    counts by kind, among which cgemm_bf16 is no more); so does one
    mxu_bf16 ct2 force"""
    from pmesh_tpu_torch import ParticleMesh
    from pmesh_tpu_torch.models.fastpm import Solver
    from pmesh_tpu_torch.ops import fft_mxu as fm
    from pmesh_tpu_torch.ops import fft_mxu_cuda as fk
    n = 512
    pr, pi, _ = _fft_inputs(65, (n, 3, 8), dev)
    k2 = [np.linspace(0.0, 1.0, m).astype('f4') for m in (n, 3, 8)]
    wi = fm._ct_inv_mats_np(n)
    wg = fm._ct_inv_mats_np(n, fold_kvec=_sl(n))
    xs = {n2: (1.0 + 0.3 * _fft_inputs(66, (2, n, n2), dev)[0]).contiguous()
          for n2 in (512, 10)}
    calls = {
        'xct_multi forward': (1, lambda p, q, st: fm._xct_call_multi(
            p, q, fm._ct_fwd_mats_np(n), 1.0 / n, precision='bf16',
            out_dtype=st)),
        'xct_multi inverse': (1, lambda p, q, st: fm._xct_call_multi(
            p, q, wi, 1.0, inverse=True, precision='bf16', out_dtype=st)),
        'xct_multi dual': (1, lambda p, q, st: fm._xct_call_multi(
            p, q, wi, 1.0, inverse=True, wx2=wg, k2=k2, precision='bf16',
            out_dtype=st))}
    for n2, x in xs.items():
        calls['zy_fwd_ct2 n2=%d' % n2] = (2, lambda p, q, st, x=x, n2=n2:
                                          fm._zy_fwd_ct2_call(
            x, n2, n2 // 2, fm._z_fwd_tabs(n2, n2 // 2),
            fm._ct_fwd_mats_np(n), precision='bf16', out_dtype=st))
    rr, ii, _ = _fft_inputs(68, (2, n, 8), dev)
    for n2 in (16, 1024):
        AB, Wy = fm._z_inv_tabs(n2, n2 // 2), fm._ct_inv_mats_np(n)
        rz, iz = (t.repeat(1, 1, n2 // 16) for t in (rr, ii))
        # the y stage's split and tc_gemm (both sets of the dual), each
        # set's z split and tc_gemm
        calls['zy_inv_ct2 n2=%d' % n2] = (2, lambda p, q, st, AB=AB, Wy=Wy,
                                          n2=n2, rz=rz, iz=iz:
                                          fm._zy_inv_ct2_call(
            rz.to(st), iz.to(st), Wy, AB, n2, precision='bf16'))
        calls['zy_inv_ct2_dual n2=%d' % n2] = (3, lambda p, q, st, AB=AB,
                                               Wy=Wy, n2=n2, rz=rz, iz=iz:
                                               fm._zy_inv_ct2_call_dual(
            rz.to(st), iz.to(st), Wy, AB, Wy, AB, n2, precision='bf16'))
    for name, (stages, call) in calls.items():
        for st in (torch.float32, torch.bfloat16):
            fk.kernel_launches(reset=True)
            call(pr.to(st), pi.to(st), st)
            ks = fk.kernel_launches(reset=True)
            assert ks == dict(tc_ct=0, tc_z=0, tc_gemm=stages,
                              split=stages, ct_fwd_col0=0), (name, st, ks)
    shape = (256, 256, 16)
    pm = ParticleMesh(shape, BoxSize=np.asarray(shape, float), dtype='f4',
                      device=dev)
    disp, _, _ = _inputs(67, shape, (0.0, 1.0), dev)
    fk.kernel_launches(reset=True)
    Solver(pm).force_lattice(disp, (0.0, 1.0), mode='spectral',
                             fft='mxu_bf16')
    ks = fk.kernel_launches(reset=True)
    # each after its split pass: zy_fwd_ct2's z and y stages, the forward
    # and dual x passes, zy_inv_ct2's y and z stages, its dual's y stage
    # and two z stages
    assert ks == dict(tc_ct=0, tc_z=0, tc_gemm=9, split=9,
                      ct_fwd_col0=0), ks


# --- the zy inverses on tc_gemm: split y stage, real-output z stage ----------

def _filtered(seed, shape, dev, ct2=True):
    """the x-inverted, 1/k^2-filtered half spectrum of a density 1 + 0.3
    N(0, 1) of ``shape``, a force's zy-inverse input: ct2, (re, im) in
    stored y and z order without the z-Nyquist column and that column's
    real part as the Nyquist plane; dense, (re, im) in natural order
    with the Nyquist column, and None"""
    from pmesh_tpu_torch.ops import fft_mxu as fm
    x = 1.0 + 0.3 * _fft_inputs(seed, shape, dev)[0]
    k = torch.fft.rfftn(x, norm='forward')
    kk = sum(torch.as_tensor(
        (2 * np.pi * (np.fft.rfftfreq(n) if d == 2 else np.fft.fftfreq(n)))
        ** 2, dtype=torch.float32, device=dev).reshape(
            [-1 if e == d else 1 for e in range(3)])
        for d, n in enumerate(shape))
    k = torch.where(kk > 0, k / torch.where(kk > 0, kk, 1.0), 0.0)
    s = torch.fft.ifft(k, dim=0) * shape[0]
    if not ct2:
        return s.real.contiguous(), s.imag.contiguous(), None
    N1, n2 = shape[1:]
    Zm = n2 // 2
    sp = torch.empty_like(s[:, :, :Zm])
    sp[:, torch.as_tensor(fm._ct_permute(N1), device=dev)] = s[:, :, :Zm]
    if fm._use_zct_fwd(n2, Zm):
        sp = torch.empty_like(sp).index_copy_(
            2, torch.as_tensor(fm._zct_perm(n2), device=dev), sp)
    return (sp.real.contiguous(), sp.imag.contiguous(),
            s[:, :, Zm].real.contiguous())


@pytest.mark.parametrize("n,n2", [(256, 10), (512, 16), (1024, 1024)])
def test_tc_zy_inverse_forms_match_plain(dev, n, n2):
    """zy_inv_ct2 and its dual on a 1/k^2-filtered spectrum with its
    Nyquist plane, at y radices 2, 4 and 8 (n = 256, 512, 1024), a ragged
    dense z stage (n2 = 10: 5 complex k, 10 output columns) and the z-CT
    stage (n2 = 1024), with and without the plane, the SuperLanczos i k_y
    and i k_z folded: f32 products on the f32 and on the bf16 spectrum
    within TOL, bf16 products by the zy pass's bf16 criterion"""
    from pmesh_tpu_torch.ops import fft_mxu as fm
    Zm = n2 // 2
    rr, ii, plane = _filtered(70, (2, n, n2), dev)
    Wy, Wyg = fm._ct_inv_mats_np(n), fm._ct_inv_mats_np(n, fold_kvec=_sl(n))
    AB = fm._z_inv_tabs(n2, Zm)
    ABg = fm._z_inv_tabs(n2, Zm, grad_kvec=_sl(n2, half=True))
    assert (np.ndim(AB[0]) == 3) == (n2 == 1024)
    hr, hi = rr.to(torch.bfloat16), ii.to(torch.bfloat16)
    for pl in (None, plane):
        def single(p, q, impl, **k):
            return (fm._zy_inv_ct2_call(p, q, Wyg, ABg, n2, plane=pl,
                                        impl=impl, **k),)

        def dual(p, q, impl, **k):
            return fm._zy_inv_ct2_call_dual(p, q, Wyg, AB, Wy, ABg, n2,
                                            planeA=pl, impl=impl, **k)
        for call in (single, dual):
            for p, q in ((rr, ii), (hr, hi)):
                got, ref = (call(p, q, impl) for impl in ('cuda', 'torch'))
                assert all(g.dtype == torch.float32 and _rel(g, r) <= TOL
                           for g, r in zip(got, ref))
            _assert_bf16_close(_products(
                lambda impl, **k: call(rr, ii, impl, **k)), ZY)


@pytest.mark.parametrize("shape", [(6, 40, 75), (20, 12, 10), (4, 96, 384)])
def test_tc_zy_inv_half_forms_match_plain(dev, shape):
    """zy_inv_half on a 1/k^2-filtered spectrum (its Nyquist column in
    place) at the ragged z widths 75 (Zh = 38) and 10 and at 384 (Zh =
    193), plain and folded tables: f32 products within TOL, bf16 by the
    zy pass's bf16 criterion"""
    from pmesh_tpu_torch.ops import fft_mxu as fm
    N1, n2 = shape[1:]
    Zh = n2 // 2 + 1
    pr, pi, _ = _filtered(71, shape, dev, ct2=False)
    wy, wyg = fm._dft_np(N1, +1), fm._dft_fold_np(N1, _sl(N1))
    AB = fm._irfft_mats_np(n2, Zh)
    ABg = fm._irfft_mats_np(n2, Zh, grad_kvec=_sl(n2, half=True))
    for tabs in ((wy, AB), (wyg, AB), (wy, ABg)):
        g, r = (fm._zy_inv_dense_call(pr, pi, *tabs, impl=impl)
                for impl in ('cuda', 'torch'))
        assert _rel(g, r) <= TOL
        _assert_bf16_close(_products(
            lambda impl, **k: (fm._zy_inv_dense_call(pr, pi, *tabs,
                                                     impl=impl, **k),)), ZY)


_CT2_F32_KINDS = dict(tc_ct=3, tc_z=1, tc_gemm=5, split=5, ct_fwd_col0=2)


@pytest.mark.parametrize("fft,shape,kinds", [
    ('mxu', (256, 256, 16), _CT2_F32_KINDS),
    ('mxu_bf16s', (256, 256, 16), _CT2_F32_KINDS),
    ('mxu_bf16', (256, 256, 16), dict(tc_gemm=9, split=9)),
    ('mxu', (48, 40, 33), dict(tc_gemm=10, split=10, ct_fwd_col0=2)),
    ('mxu_bf16', (48, 40, 33), dict(tc_gemm=10, split=10))])
def test_tc_forces_launch_no_cgemm(dev, fft, shape, kinds):
    """one spectral force in each fft='mxu' mode, ct2 and dense, launches
    exactly its passes' device kernels (the C entry points' counts by
    kind, among which cgemm and cgemm_bf16 are no more): ct2 f32
    products, tc_z and tc_ct
    for the forward z, y and x stages and the dual inverse x pass, column
    0 chained after the forward y and x stages, the zy inverses' y stage
    (one for both sets of the dual) and each set's z stage on tc_gemm
    after their split passes; the bf16 products and the dense passes on
    tc_gemm throughout"""
    from pmesh_tpu_torch import ParticleMesh
    from pmesh_tpu_torch.models.fastpm import Solver
    from pmesh_tpu_torch.ops import fft_mxu_cuda as fk
    pm = ParticleMesh(shape, BoxSize=np.asarray(shape, float), dtype='f4',
                      device=dev)
    disp, _, _ = _inputs(72, shape, (0.0, 1.0), dev)
    solver = Solver(pm)
    solver.force_lattice(disp, (0.0, 1.0), mode='spectral', fft=fft)
    fk.kernel_launches(reset=True)
    solver.force_lattice(disp, (0.0, 1.0), mode='spectral', fft=fft)
    ks = fk.kernel_launches(reset=True)
    want = dict(tc_ct=0, tc_z=0, tc_gemm=0, split=0, ct_fwd_col0=0)
    want.update(kinds)
    assert ks == want, ks


# --- row 13's zy passes on tc_gemm -------------------------------------------

def _zy_full_input(seed, shape, dev):
    """(re, im) of a density 1 + 0.3 N(0, 1) of ``shape`` transformed
    over y and z (norm='forward'): a full-spectrum zy inverse's input,
    its mean in the DC column"""
    x = 1.0 + 0.3 * _fft_inputs(seed, shape, dev)[0]
    k = torch.fft.fftn(x, dim=(1, 2), norm='forward')
    return k.real.contiguous(), k.imag.contiguous()


@pytest.mark.parametrize("shape", [(6, 33, 75), (4, 75, 130),
                                   (3, 130, 33), (16, 256, 16)])
def test_tc_zy_inv_full_forms_match_plain(dev, shape):
    """row 13's full-spectrum zy inverse at ragged y and z (N2 = 75: a
    table tile's column pair straddles zr and zi; N1 = 130: a second,
    nearly empty tile of output rows) and the slab's zy extents, plain
    and folded tables, on a spectrum with its mean: f32 products within
    TOL, bf16 by the zy pass's bf16 criterion"""
    from pmesh_tpu_torch.ops import fft_mxu as fm
    from pmesh_tpu_torch.ops import fft_mxu_ref as ref
    _, N1, n2 = shape
    rr, ii = _zy_full_input(80, shape, dev)
    wy, wyg = fm._dft_np(N1, +1), fm._dft_fold_np(N1, _sl(N1))
    AB = ref._z_inv_full_np(n2)
    ABg = ref._z_inv_full_np(n2, _sl(n2))
    for tabs in ((wy, AB), (wyg, AB), (wy, ABg)):
        g, r = (ref._zy_inv_full_call(rr, ii, *tabs, impl=impl)
                for impl in ('cuda', 'torch'))
        assert _rel(g, r) <= TOL
        _assert_bf16_close(_products(
            lambda impl, **k: (ref._zy_inv_full_call(rr, ii, *tabs,
                                                     impl=impl, **k),)), ZY)


@pytest.mark.parametrize("shape", [(4, 256, 30), (2, 512, 75),
                                   (2, 1024, 33), (16, 256, 16)])
def test_tc_zy_fwd_half_ct_forms_match_plain(dev, shape):
    """row 13's half-CT pass 1 on a mesh with a mean at y radices 2, 4
    and 8, ragged z (Zh = 16, 38, 17: scratch rows padded to 16 bytes)
    and the slab's zy extents: f32 products (three-part split_ct, column
    0 chained) within TOL, bf16 by the zy pass's bf16 criterion"""
    from pmesh_tpu_torch.ops import fft_mxu as fm
    from pmesh_tpu_torch.ops import fft_mxu_ref as ref
    _, N1, n2 = shape
    x = (1.0 + 0.3 * _fft_inputs(81, shape, dev)[0]).contiguous()
    wz = fm._dft_half_np(n2, n2 // 2 + 1)
    wy = fm._ct_fwd_mats_np(N1)
    got, want = (ref._zy_fwd_half_ct_call(x, wz, wy, impl=impl)
                 for impl in ('cuda', 'torch'))
    for g, r in zip(got, want):
        assert _rel(g, r) <= TOL
    _assert_bf16_close(_products(
        lambda impl, **k: ref._zy_fwd_half_ct_call(x, wz, wy, impl=impl,
                                                   **k)), ZY)


def test_tc_row13_zy_launch_kinds(dev):
    """zy_inv_full and zy_fwd_half_ct in both forms launch a split pass
    and tc_gemm per stage and nothing else but, for the f32 half-CT
    forward, the y stage's column-0 chain (the C entry points' counts by
    kind)"""
    from pmesh_tpu_torch.ops import fft_mxu as fm
    from pmesh_tpu_torch.ops import fft_mxu_cuda as fk
    from pmesh_tpu_torch.ops import fft_mxu_ref as ref
    shape = (4, 256, 30)
    _, N1, n2 = shape
    x = (1.0 + 0.3 * _fft_inputs(82, shape, dev)[0]).contiguous()
    rr, ii = _zy_full_input(83, shape, dev)
    for b in (False, True):
        fk.kernel_launches(reset=True)
        fk.zy_inv_full(rr, ii, fm._dft_np(N1, +1), ref._z_inv_full_np(n2),
                       bf16=b)
        assert fk.kernel_launches(reset=True) == dict(
            tc_ct=0, tc_z=0, tc_gemm=2, split=2, ct_fwd_col0=0), b
        fk.zy_fwd_half_ct(x, fm._dft_half_np(n2, n2 // 2 + 1),
                          fm._ct_fwd_mats_np(N1), bf16=b)
        assert fk.kernel_launches(reset=True) == dict(
            tc_ct=0, tc_z=0, tc_gemm=2, split=2,
            ct_fwd_col0=0 if b else 1), b


# --- the row-13 pipelines (ops/fft_mxu_ref.py) on the kernels ----------------

@pytest.mark.parametrize("shape", [(64, 64, 64), (45, 38, 75)])
def test_fft_ref_full_kernels_match_plain(dev, shape):
    """the full-spectrum forward, each inverse (grad None/0/1/2) and the
    force triple, card against plain"""
    from pmesh_tpu_torch.ops import fft_mxu_ref as ref
    x = _fft_inputs(30, shape, dev)[0]
    kv = [tuple((np.fft.fftfreq(n) * 2 * np.pi).tolist()) for n in shape]
    out = {}
    for impl in ('cuda', 'torch'):
        r, i = ref.fft3_real_forward(x, impl=impl)
        inv = [ref.fft3_real_inverse(r, i, impl=impl)]
        inv += [ref.fft3_real_inverse(r, i, grad=d, kvec=kv[d], impl=impl)
                for d in range(3)]
        tri = ref.fft3_real_inverse_grad3(r, i, kvecs=kv, impl=impl)
        out[impl] = [r, i] + inv + list(tri)
    for g, r in zip(out['cuda'], out['torch']):
        assert _rel(g, r) <= TOL
    assert _rel(out['cuda'][2], x) <= 2e-5      # the round trip
    for d in range(3):
        assert _rel(out['cuda'][6 + d], out['cuda'][3 + d]) <= TOL


@pytest.mark.parametrize("shape", [(256, 256, 16), (512, 256, 30)])
def test_fft_ref_half_ct_kernels_match_plain(dev, shape):
    from pmesh_tpu_torch.ops import fft_mxu_ref as ref
    x = _fft_inputs(31, shape, dev)[0]
    kd = (_sl(shape[0]), _sl(shape[1]), _sl(shape[2], half=True))
    out = {}
    for impl in ('cuda', 'torch'):
        r, i = ref.fft3_real_forward_half_ct(x, impl=impl)
        tri = ref.fft3_real_inverse_grad3_half_ct(r, i, shape[2], kd,
                                                  impl=impl)
        out[impl] = [r, i] + list(tri)
    for g, r in zip(out['cuda'], out['torch']):
        assert _rel(g, r) <= TOL


def test_fft_ref_launch_counts(dev):
    from pmesh_tpu_torch.ops import fft_mxu_cuda
    from pmesh_tpu_torch.ops import fft_mxu_ref as ref
    x = _fft_inputs(32, (256, 256, 16), dev)[0]
    kd = (_sl(256), _sl(256), _sl(16, half=True))
    fft_mxu_cuda.reset_launches()
    ref.fft3_real_inverse_grad3(*ref.fft3_real_forward(x),
                                kvecs=(kd[0], kd[1], _sl(16)))
    ref.fft3_real_inverse_grad3_half_ct(*ref.fft3_real_forward_half_ct(x),
                                        n2=16, kvecs=kd)
    assert _launched(fft_mxu_cuda) == dict(
        xct_multi=2, x_dense=2, zy_fwd_full=1, zy_inv_full=3,
        zy_fwd_half_ct=1, zy_inv_half_ct=3)


# --- reverse mode on the kernels ---------------------------------------------

def _grads(fn, leaves_np, device):
    """the gradients of fn(leaves) on ``device``, as CPU tensors"""
    leaves = [torch.from_numpy(a).to(device).requires_grad_()
              for a in leaves_np]
    fn(leaves).backward()
    return [t.grad.cpu() for t in leaves]


@pytest.mark.parametrize("window", ['cic', 'tsc'])
def test_lattice_backward_matches_plain(dev, window):
    """the paint and readout backwards (mesh mass; three meshes) on the
    kernels against the plain backward on the CPU, and the launches of
    each backward"""
    from pmesh_tpu_torch.ops import gridpm_cuda
    rng = np.random.RandomState(33)
    shape, bounds = (24, 20, 36), (-0.5, 1.0)
    disp = [rng.uniform(*bounds, shape).astype('f4') for _ in range(3)]
    mass = (1 + 0.2 * rng.normal(size=shape)).astype('f4')
    meshes = [rng.normal(size=shape).astype('f4') for _ in range(3)]
    w = [rng.uniform(0.5, 1.5, shape).astype('f4') for _ in range(3)]

    def paint_loss(t):
        return (tgp.paint_grid(t[:3], mass=t[3], bounds=bounds,
                               window=window)
                * torch.from_numpy(w[0]).to(t[0].device)).sum()

    def readout_loss(t):
        out = tgp.readout_grid(t[:3], t[3:], bounds=bounds, window=window)
        return sum((o * torch.from_numpy(ww).to(o.device)).sum()
                   for o, ww in zip(out, w))
    for fn, leaves, launches in (
            (paint_loss, disp + [mass], {"paint_lattice": 1,
                                         "readout_lattice": 2}),
            (readout_loss, meshes + disp, {"paint_lattice": 3,
                                           "readout_lattice": 4})):
        ref = _grads(fn, leaves, 'cpu')
        gridpm_cuda.reset_launches()
        got = _grads(fn, leaves, dev)
        # forward and backward: paint 1 + (1 mass readout, 1 'all');
        # readout 1 (the three meshes in one launch) + (3 paints, one
        # 3-mesh readout per direction)
        assert _launched(gridpm_cuda) == launches
        for g, r in zip(got, ref):
            assert _rel(g, r) <= TOL


@pytest.mark.parametrize("shape,fft", [((32, 32, 32), 'xla'),
                                       ((256, 256, 16), 'mxu'),
                                       ((48, 40, 33), 'mxu')])
def test_force_backward_card_matches_cpu(dev, shape, fft):
    """the gradient of a force_lattice loss on the card against the
    CPU's, and the DFT launches of the mxu backward: at ct2 one forward
    and one only=d inverse per direction, at dense shapes the whole
    triple per direction, as the JAX package does"""
    from pmesh_tpu_torch import ParticleMesh
    from pmesh_tpu_torch.models.fastpm import Solver
    from pmesh_tpu_torch.ops import fft_mxu_cuda
    rng = np.random.RandomState(34)
    disp = [rng.uniform(0, 1, shape).astype('f4') for _ in range(3)]
    out = {}
    for device in ('cpu', dev):
        pm = ParticleMesh(shape, BoxSize=np.asarray(shape, float),
                          dtype='f4', device=device)
        solver = Solver(pm)

        def loss(t):
            F = solver.force_lattice(t, (0.0, 1.0), fft=fft)
            return (F[0] ** 2 + 2 * F[1] ** 2 + 3 * F[2] ** 2).sum()
        fft_mxu_cuda.reset_launches()
        out[str(device)] = _grads(loss, disp, device)
    for g, r in zip(out[str(dev)], out['cpu']):
        assert _rel(g, r) <= 1e-4
    if fft == 'mxu' and shape == (256, 256, 16):
        assert _launched(fft_mxu_cuda) == dict(
            zy_fwd_ct2=1 + 3, xct_multi=2 + 6, zy_inv_ct2=1 + 3,
            zy_inv_ct2_dual=1)
    elif fft == 'mxu':
        assert _launched(fft_mxu_cuda) == dict(
            zy_fwd_half=4, x_dense=8, zy_inv_half=12)


def test_nbody_backward_card_matches_cpu(dev):
    from pmesh_tpu_torch import ParticleMesh, RealField
    from pmesh_tpu_torch.models.fastpm import Solver
    shape = (32, 32, 32)
    noise = np.random.RandomState(35).normal(size=shape).astype('f4')
    state, out = None, {}
    for device in ('cpu', dev):
        pm = ParticleMesh(shape, BoxSize=float(shape[0]), dtype='f4',
                          device=device)
        solver = Solver(pm)
        if state is None:
            dk = pm.create(type=RealField, value=torch.from_numpy(noise))
            dk = dk.r2c().apply(lambda k, v: 0.3 * v * torch.where(
                k.normp(2) > 0, k.normp(2, zeromode=1.0) ** -0.375, 0.0))
            disp, vel = solver.lpt_lattice(dk, 0.1, order=2)
            state = [x.numpy() for x in disp + vel]

        def loss(t):
            S, V = solver.nbody_lattice(t[:3], t[3:], [0.1, 0.2, 0.3],
                                        (-1.0, 1.0))
            return sum((s ** 2).sum() + 2 * (v ** 2).sum()
                       for s, v in zip(S, V))
        out[str(device)] = _grads(loss, state, device)
    for g, r in zip(out[str(dev)], out['cpu']):
        assert torch.isfinite(g).all()
        assert _rel(g, r) <= 1e-4


def test_mxu_potential_backward_card_matches_cpu(dev):
    """the ct2 potential's transpose (the potential itself) on the
    kernels against the CPU's, and the launches of one forward and one
    backward"""
    from pmesh_tpu_torch import ParticleMesh
    from pmesh_tpu_torch.models.fastpm import Solver
    from pmesh_tpu_torch.ops import fft_mxu_cuda
    shape = (256, 256, 16)
    rng = np.random.RandomState(36)
    rho = rng.normal(size=shape).astype('f4')
    w = torch.from_numpy(rng.normal(size=shape).astype('f4'))
    out = {}
    for device in ('cpu', dev):
        pm = ParticleMesh(shape, BoxSize=np.asarray(shape, float),
                          dtype='f4', device=device)
        solver = Solver(pm)
        fft_mxu_cuda.reset_launches()
        out[str(device)] = _grads(
            lambda t: (solver._mxu_potential(t[0]) * w.to(t[0].device)).sum(),
            [rho], device)
    assert _launched(fft_mxu_cuda) == dict(
        zy_fwd_ct2=2, xct_multi=4, zy_inv_ct2=2)
    assert _rel(out[str(dev)][0], out['cpu'][0]) <= 1e-4


# --- the bf16 forms of the DFT kernels ---------------------------------------
#
# bf16 products (fft='mxu_bf16'): kernel and plain version round the same
# operands, and a product of two bf16 values is exact in f32, so they
# differ only in their f32 sums; but the tensor cores sum a block of
# products with their own alignment and rounding, further from a
# sequence of FP32 FMAs than two such sequences are from each other, so
# where a pass rounds an intermediate again (a zy pass: the z output
# before the y product, the y output before the z product) more of those
# roundings flip, each by one bf16 ulp that reaches its whole row.  Held
# to an rms gap <= 0.15 of the bf16 rounding itself (p against the pass
# with f32 products) and max|k - p| <= 5e-4 of max|p| for an x pass (one
# product), 1e-2 for a zy pass or an entry point that chains passes.  bf16 storage (fft='mxu_bf16s'): each stored spectrum is
# bf16, at least 99.9 % of it bitwise equal to the plain version's and
# no entry more than one bf16 ulp away beyond the gap of the f32 sums it
# rounds; an f32 output within TOL.

def _bf16_gaps(got, ref, ref32):
    """(max|k - p| / max|p|, rms|k - p| / rms|p - f32|) of each output;
    an output without products (the Nyquist row sum) equals its f32
    twin: (its f32 gap, 0)"""
    out = []
    for g, r, f in zip(got, ref, ref32):
        effect = float(((r - f).double() ** 2).mean() ** 0.5)
        d = (g.float() - r.float()).abs()
        rms = 0.0 if effect == 0 else float(
            (d.double() ** 2).mean() ** 0.5) / effect
        out.append((float(d.max() / r.float().abs().max()), rms))
    return out


ZY = 1e-2      # the max gap of a zy pass or a chain of passes


def _assert_bf16_close(outs, tol=5e-4):
    """outs = (kernel, plain, plain f32) tuples of outputs"""
    gaps = _bf16_gaps(*outs)
    assert all(m <= tol and r <= 0.15 for m, r in gaps), gaps


def _bf16_same(got, ref, got32, ref32):
    if got.dtype != torch.bfloat16 or ref.dtype != torch.bfloat16:
        return False
    g, r = got.float(), ref.float()
    m = torch.maximum(g.abs(), r.abs()).clamp_min(1e-30)
    ulp = torch.exp2(torch.floor(torch.log2(m)) - 7)
    return (float((g != r).float().mean()) <= 1e-3
            and bool(((g - r).abs() <= ulp + (got32 - ref32).abs()).all()))


def _bf16_once(got, got32, ref, ref32):
    """bf16 products stored in bf16: the kernel's output is its f32-stored
    twin rounded once (bitwise), and no entry is more than one bf16 ulp
    from the plain version's beyond the gap of the two f32 outputs"""
    if got.dtype != torch.bfloat16 or ref.dtype != torch.bfloat16:
        return False
    g, r = got.float(), ref.float()
    m = torch.maximum(g.abs(), r.abs()).clamp_min(1e-30)
    ulp = torch.exp2(torch.floor(torch.log2(m)) - 7)
    return (torch.equal(got, got32.to(torch.bfloat16))
            and bool(((g - r).abs() <= ulp + (got32 - ref32).abs()).all()))


def _products(call):
    """call(impl, **form) in the bf16 product form, kernel, plain and
    the plain f32 twin, as tuples"""
    def tup(x):
        return (x,) if isinstance(x, torch.Tensor) else tuple(x)
    return (tup(call('cuda', precision='bf16')),
            tup(call('torch', precision='bf16')), tup(call('torch')))


@pytest.mark.parametrize("n,n2", [(256, 10), (512, 1024), (1024, 256),
                                  (256, 512)])
def test_fft_mxu_bf16_kernels_match_plain(dev, n, n2):
    """the four ct2 passes in both bf16 forms and their combination
    (bf16 products on bf16 spectra), at x and y radices 2, 4 and 8 (n =
    256, 512, 1024), at a ragged z (n2 = 10: the dense z stage,
    contractions of 10 and 5, five modes) and at the z-CT radices 8, 2
    and 4 (n2 = 1024, 256, 512)"""
    from pmesh_tpu_torch.ops import fft_mxu as fm
    Zm = n2 // 2
    bf16 = torch.bfloat16
    x = (1.0 + 0.3 * _fft_inputs(40, (3, n, n2), dev)[0]).contiguous()
    wz, wy = fm._z_fwd_tabs(n2, Zm), fm._ct_fwd_mats_np(n)
    got, ref, f32 = _products(lambda impl, **k: fm._zy_fwd_ct2_call(
        x, n2, Zm, wz, wy, impl=impl, **k))
    _assert_bf16_close((got, ref, f32), ZY)
    # the combination: bf16 products stored once in bf16
    gb, rb = (fm._zy_fwd_ct2_call(x, n2, Zm, wz, wy, impl=impl,
                                  precision='bf16', out_dtype=bf16)
              for impl in ('cuda', 'torch'))
    assert all(_bf16_once(*t) for t in zip(gb[:2], got, rb[:2], ref))
    got, ref = (fm._zy_fwd_ct2_call(x, n2, Zm, wz, wy, impl=impl,
                                    out_dtype=bf16)
                for impl in ('cuda', 'torch'))
    got32, ref32 = (fm._zy_fwd_ct2_call(x, n2, Zm, wz, wy, impl=impl)
                    for impl in ('cuda', 'torch'))
    assert all(_bf16_same(*t) for t in zip(got[:2], ref[:2], got32, ref32))
    assert _rel(got[2], ref[2]) <= TOL
    pr, pi, _ = _fft_inputs(41, (n, 3, Zm), dev)
    rng = np.random.RandomState(42)
    k2 = [rng.uniform(0.0, 2.0, m).astype('f4') for m in (n, 3, Zm)]
    for t in k2:
        t[0] = 0.0
    wi = fm._ct_inv_mats_np(n)
    wg = fm._ct_inv_mats_np(n, fold_kvec=_sl(n))
    hr, hi = pr.to(bf16), pi.to(bf16)
    for kw in (dict(wx=fm._ct_fwd_mats_np(n), scale=1.0 / n ** 3),
               dict(wx=wi, scale=1.0, inverse=True),
               dict(wx=wi, scale=1.0, inverse=True, wx2=wg, k2=k2)):
        got, ref, f32 = _products(lambda impl, **k: fm._xct_call_multi(
            pr, pi, impl=impl, **k, **kw))
        assert len(got) == len(ref)
        _assert_bf16_close((got, ref, f32))
        got, ref = (fm._xct_call_multi(hr, hi, impl=impl, out_dtype=bf16,
                                       **kw) for impl in ('cuda', 'torch'))
        got32, ref32 = (fm._xct_call_multi(hr.float(), hi.float(),
                                           impl=impl, **kw)
                        for impl in ('cuda', 'torch'))
        assert all(_bf16_same(*t) for t in zip(got, ref, got32, ref32))
        gb, rb = (fm._xct_call_multi(hr, hi, impl=impl, out_dtype=bf16,
                                     precision='bf16', **kw)
                  for impl in ('cuda', 'torch'))
        got32, ref32 = (fm._xct_call_multi(hr.float(), hi.float(),
                                           impl=impl, precision='bf16', **kw)
                        for impl in ('cuda', 'torch'))
        assert all(_bf16_once(*t) for t in zip(gb, got32, rb, ref32))
    rr, ii, _ = _fft_inputs(43, (3, n, Zm), dev)
    plane = _fft_inputs(44, (3, n), dev)[0]
    Wy, Wyg = fm._ct_inv_mats_np(n), fm._ct_inv_mats_np(n, fold_kvec=_sl(n))
    AB = fm._z_inv_tabs(n2, Zm)
    ABg = fm._z_inv_tabs(n2, Zm, grad_kvec=_sl(n2, half=True))
    hr, hi = rr.to(bf16), ii.to(bf16)
    for pl in (None, plane):
        got, ref, f32 = _products(lambda impl, **k: fm._zy_inv_ct2_call(
            rr, ii, Wyg, ABg, n2, plane=pl, impl=impl, **k))
        _assert_bf16_close((got, ref, f32), ZY)
        got, ref, f32 = _products(lambda impl, **k: fm._zy_inv_ct2_call_dual(
            rr, ii, Wyg, AB, Wy, ABg, n2, planeA=pl, impl=impl, **k))
        _assert_bf16_close((got, ref, f32), ZY)
        # bf16 storage: the same f32 products on the bf16 spectrum
        g, r = (fm._zy_inv_ct2_call(hr, hi, Wyg, ABg, n2, plane=pl,
                                    impl=impl) for impl in ('cuda', 'torch'))
        assert g.dtype == torch.float32 and _rel(g, r) <= TOL
        got, ref = (fm._zy_inv_ct2_call_dual(hr, hi, Wyg, AB, Wy, ABg, n2,
                                             planeA=pl, impl=impl)
                    for impl in ('cuda', 'torch'))
        assert all(_rel(g, r) <= TOL for g, r in zip(got, ref))


@pytest.mark.parametrize("shape", [(45, 38, 75), (7, 9, 11)])
def test_fft_dense_bf16_kernels_match_plain(dev, shape):
    from pmesh_tpu_torch.ops import fft_mxu as fm
    N0, N1, n2 = shape
    Zh = n2 // 2 + 1
    x = _fft_inputs(45, shape, dev)[0]
    wz, wy = fm._dft_half_np(n2, Zh), fm._dft_np(N1, -1)
    _assert_bf16_close(_products(
        lambda impl, **k: fm._zy_fwd_dense_call(x, wz, wy, impl=impl, **k)),
        ZY)
    pr, pi, _ = _fft_inputs(46, (N0, N1, Zh), dev)
    k2 = [np.random.RandomState(47).uniform(0.0, 2.0, m).astype('f4')
          for m in (N0, N1, Zh)]
    for t in k2:
        t[0] = 0.0
    wi, wg = fm._dft_np(N0, +1), fm._dft_fold_np(N0, _sl(N0))
    for kw in (dict(wx=fm._dft_np(N0, -1), scale=1.0 / x.numel()),
               dict(wx=wi, scale=1.0, wx2=wg, k2=k2)):
        _assert_bf16_close(_products(
            lambda impl, **k: fm._x_dense_call(pr, pi, impl=impl, **k,
                                               **kw)))
    wyi, wyg = fm._dft_np(N1, +1), fm._dft_fold_np(N1, _sl(N1))
    ABg = fm._irfft_mats_np(n2, Zh, grad_kvec=_sl(n2, half=True))
    for tabs in ((wyg, fm._irfft_mats_np(n2, Zh)), (wyi, ABg)):
        _assert_bf16_close(_products(
            lambda impl, **k: fm._zy_inv_dense_call(pr, pi, *tabs,
                                                    impl=impl, **k)), ZY)


@pytest.mark.parametrize("full,half", [((45, 38, 75), (256, 256, 16)),
                                       ((16, 12, 10), (512, 256, 30))])
def test_fft_ref_bf16_kernels_match_plain(dev, full, half):
    """the row-13 entry points with precision='bf16', card against
    plain on the same inputs, each a chain of two passes: the
    full-spectrum forward, inverse and triple, the half-CT forward and
    triple"""
    from pmesh_tpu_torch.ops import fft_mxu_ref as ref
    x = _fft_inputs(48, full, dev)[0]
    xh = _fft_inputs(49, half, dev)[0]
    kv = [tuple((np.fft.fftfreq(n) * 2 * np.pi).tolist()) for n in full]
    kd = (_sl(half[0]), _sl(half[1]), _sl(half[2], half=True))

    # the inverses all read the plain bf16 forward's spectra
    r, i = ref.fft3_real_forward(x, precision='bf16', impl='torch')
    hr, hi = ref.fft3_real_forward_half_ct(xh, precision='bf16',
                                           impl='torch')

    def chain(impl, **k):
        out = list(ref.fft3_real_forward(x, impl=impl, **k))
        out.append(ref.fft3_real_inverse(r, i, grad=2, kvec=kv[2],
                                         impl=impl, **k))
        out += ref.fft3_real_inverse_grad3(r, i, kvecs=kv, impl=impl, **k)
        out += ref.fft3_real_forward_half_ct(xh, impl=impl, **k)
        out += ref.fft3_real_inverse_grad3_half_ct(hr, hi, half[2], kd,
                                                   impl=impl, **k)
        return out
    _assert_bf16_close(_products(chain), ZY)


def test_fft_bf16_kernels_refuse_and_do_not_fall_back(dev):
    """a bf16 request with a tensor the kernel does not take raises,
    launches nothing and runs nothing else"""
    from pmesh_tpu_torch.ops import fft_mxu as fm
    from pmesh_tpu_torch.ops import fft_mxu_cuda
    n2, Zm = 16, 8
    x = _fft_inputs(50, (2, 256, n2), dev)[0]
    wz, wy = fm._z_fwd_tabs(n2, Zm), fm._ct_fwd_mats_np(256)
    pr, pi, _ = _fft_inputs(51, (256, 2, Zm), dev)
    hr, hi = pr.to(torch.bfloat16), pi.to(torch.bfloat16)
    wi = fm._ct_inv_mats_np(256)
    fft_mxu_cuda.reset_launches()
    with pytest.raises(NotImplementedError, match='f32'):
        # the real mesh is f32 in both forms
        fm._zy_fwd_ct2_call(x.to(torch.bfloat16), n2, Zm, wz, wy,
                            precision='bf16')
    with pytest.raises(NotImplementedError, match='f32 or bf16'):
        fm._xct_call_multi(hr, pi, wi, 1.0, inverse=True,
                           out_dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match='f32 or bf16'):
        fft_mxu_cuda.xct_multi(pr.half(), pi.half(), wi, 1.0, inverse=True)
    with pytest.raises(NotImplementedError, match='stores its output'):
        fm._xct_call_multi(pr, pi, wi, 1.0, inverse=True,
                           out_dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match='f32'):
        # the dense passes have no bf16 storage form
        fm._x_dense_call(hr, hi, fm._dft_np(256, +1), 1.0, precision='bf16')
    with pytest.raises(ValueError, match='precision'):
        fm._xct_call_multi(pr, pi, wi, 1.0, inverse=True, precision='tf32')
    with pytest.raises(NotImplementedError, match='gradients'):
        fm._zy_inv_ct2_call(hr.reshape(2, 256, Zm).requires_grad_(),
                            hi.reshape(2, 256, Zm), wi, fm._z_inv_tabs(n2, Zm),
                            n2, precision='bf16')
    assert not _launched(fft_mxu_cuda)


@pytest.mark.parametrize("fft,shape,mode", [
    ('mxu_bf16', (256, 256, 16), 'spectral'),
    ('mxu_bf16s', (256, 256, 16), 'spectral'),
    ('mxu_bf16s', (256, 256, 16), 'gradient'),
    ('mxu_bf16', (48, 40, 33), 'spectral'),
    ('mxu_bf16s', (48, 40, 33), 'spectral')])
def test_fft_bf16_launches_count_one_force(dev, fft, shape, mode):
    """one force in each bf16 mode runs only that form of the kernels;
    the dense pipeline has no storage form and runs f32 products under
    mxu_bf16s, as the JAX package does"""
    from pmesh_tpu_torch import ParticleMesh
    from pmesh_tpu_torch.models.fastpm import Solver
    from pmesh_tpu_torch.ops import fft_mxu_cuda
    pm = ParticleMesh(shape, BoxSize=np.asarray(shape, float), dtype='f4',
                      device=dev)
    disp, _, _ = _inputs(52, shape, (0.0, 1.0), dev)
    fft_mxu_cuda.reset_launches()
    F = Solver(pm).force_lattice(disp, (0.0, 1.0), mode=mode, fft=fft)
    assert all(f.dtype == torch.float32 and torch.isfinite(f).all()
               for f in F)
    if shape == (48, 40, 33):
        sfx = '_bf16' if fft == 'mxu_bf16' else ''
        want = {"zy_fwd_half" + sfx: 1, "x_dense" + sfx: 2,
                "zy_inv_half" + sfx: 3}
    else:
        sfx = '_bf16' if fft == 'mxu_bf16' else '_bf16s'
        want = {"zy_fwd_ct2" + sfx: 1, "xct_multi" + sfx: 2,
                "zy_inv_ct2" + sfx: 1}
        if mode == 'spectral':
            want["zy_inv_ct2_dual" + sfx] = 1
    assert _launched(fft_mxu_cuda) == want


# --- the slab-sharded path ---------------------------------------------------

def _wrap_rows(t, start, rows, lo, hi):
    """rows [start, start + rows) of ``t`` with lo planes below and hi
    above, wrapped: the extended slab a rank's halo exchange builds"""
    n0 = t.shape[0]
    idx = torch.arange(start - lo, start + rows + hi, device=t.device) % n0
    return t[idx].contiguous()


@pytest.mark.parametrize("window,bounds", [('cic', (-1.0, 1.5)),
                                           ('tsc', (-0.5, 0.5)),
                                           ('cic', (-2.5, 0.5))])
def test_xhalo_lattice_kernels_match_plain(dev, window, bounds):
    """the x-halo slab forms against the plain roll loop on the extended
    slab (TOL) and against the wrapped kernels' rows of the whole mesh
    (bitwise: the same sums in the same order); the last case reaches
    past a 4-row slab"""
    from pmesh_tpu_torch.ops import gridpm_cuda
    shape = (24, 20, 36)
    disp, mass, meshes = _inputs(61, shape, bounds, dev)
    vmin, vmax = tgp.offset_range(*bounds, window)
    start, rows = 8, 4
    lo, hi = max(0, vmax), max(0, -vmin)
    dext = tuple(_wrap_rows(d, start, rows, lo, hi) for d in disp)
    mext = _wrap_rows(mass, start, rows, lo, hi)
    for diffdir in (None, 1):
        for m, mx in ((None, None), (mass, mext)):
            got = gridpm_cuda.paint_lattice(dext, mx, vmin, vmax, window,
                                            diffdir, rows=rows, xbase=lo)
            ref = tgp.paint_slab_plain(dext, 1.0 if mx is None else mx, lo,
                                       rows, bounds, window, diffdir)
            assert _rel(got, ref) <= TOL, (diffdir, m is None)
            whole = gridpm_cuda.paint_lattice(disp, m, vmin, vmax, window,
                                              diffdir)
            assert torch.equal(got, whole[start:start + rows])
    lo, hi = max(0, -vmin), max(0, vmax)
    dslab = tuple(d[start:start + rows].contiguous() for d in disp)
    mx = tuple(_wrap_rows(m, start, rows, lo, hi) for m in meshes)
    for diffdir in (None, 0, 'all'):
        got = gridpm_cuda.readout_lattice(mx[:1], dslab, vmin, vmax, window,
                                          diffdir, xbase=lo)
        ref = tgp.readout_slab_plain(mx[:1], dslab, lo, bounds, window,
                                     diffdir)
        whole = gridpm_cuda.readout_lattice(meshes[:1], disp, vmin, vmax,
                                            window, diffdir)
        for g, r, w in zip(got, ref, whole):
            assert _rel(g, r) <= TOL, diffdir
            assert torch.equal(g, w[start:start + rows])


# (drift bounds, fill per input slot, nslots_out, shape): K = 2 at the
# main path's and a 64-offset range, K = 4 (the clustered path's), 16
# slots, one slot with 125 offsets, and a shape whose n1 and n2 are not
# multiples of the assign's 8 x 32 tile
XHALO_REBASE_CASES = {
    'k2': ((-0.5, 1.5), (0.7, 0.7), 2, (24, 20, 36)),
    'k2_offsets_-1_2': ((-1.0, 2.0), (0.7, 0.7), 3, (24, 20, 36)),
    'k4': REBASE_CASES['k4'] + ((24, 20, 36),),
    'k16': REBASE_CASES['k16'] + ((24, 20, 36),),
    'k1_offsets_-2_2': REBASE_CASES['k1_offsets_-2_2'] + ((24, 20, 36),),
    'ragged': ((-0.5, 1.5), (0.7, 0.7), 2, (24, 37, 45)),
}


@pytest.mark.parametrize("case", sorted(XHALO_REBASE_CASES))
def test_xhalo_rebase_bitwise(dev, case):
    """the x-halo rebase against the plain slab form and the wrapped
    kernels' rows of the whole mesh, bitwise"""
    from pmesh_tpu_torch.ops import binned as tbn
    from pmesh_tpu_torch.ops import binned_cuda
    bounds, fill, kout, shape = XHALO_REBASE_CASES[case]
    rng = np.random.RandomState(62)

    def t(a):
        return torch.from_numpy(a.astype('f4')).to(dev)
    dslots = tuple(tuple(t(rng.uniform(bounds[0], bounds[1], shape))
                         for _ in range(3)) for _ in fill)
    valid = tuple(t((rng.uniform(size=shape) < f) * 1.0) for f in fill)
    vel = tuple(tuple(t(rng.normal(size=shape)) for _ in range(3))
                for _ in fill)
    offsets = tbn._drift_offsets(bounds, 3)
    olo, ohi = offsets[0][0], offsets[-1][0]
    lo, hi = tbn._halo_depth(offsets)
    start, rows = 12, 6

    def ext(x):
        if isinstance(x, tuple):
            return tuple(ext(y) for y in x)
        return _wrap_rows(x, start, rows, lo, hi)
    got = binned_cuda.rebase_assign(ext(dslots), ext(valid), kout, olo, ohi,
                                    rows=rows, xbase=lo)
    ref = tbn.rebase_assign_plain(ext(dslots), ext(valid), offsets, kout,
                                  rows=rows, xbase=lo)
    whole = binned_cuda.rebase_assign(dslots, valid, kout, olo, ohi)
    for g, r, w in zip(_flat(got[:3]), _flat(ref[:3]), _flat(whole[:3])):
        assert torch.equal(g, r) and torch.equal(g, w[start:start + rows])
    assert int(got[3]) == int(ref[3])
    ge = binned_cuda.rebase_apply((ext(vel),), got[2], olo, ohi, xbase=lo)
    re = tbn.rebase_apply_plain((ext(vel),), ref[2], offsets, xbase=lo)
    we = binned_cuda.rebase_apply((vel,), whole[2], olo, ohi)
    for g, r, w in zip(_flat(ge), _flat(re), _flat(we)):
        assert torch.equal(g, r) and torch.equal(g, w[start:start + rows])
    with pytest.raises(ValueError, match="x halo"):
        binned_cuda.rebase_assign(dslots, valid, kout, olo, ohi, rows=rows,
                                  xbase=0)


def _flat(x):
    if isinstance(x, (tuple, list)):
        return [y for z in x for y in _flat(z)]
    return [x]


def test_sharded_on_the_card_matches_one_device(dev):
    """four ranks on the card over gloo (staged through the host): the
    sharded paint, forces and rebase against the single-device kernels,
    and the row-9 passes at the slab and y-chunk shapes of (24, 20, 15)
    (slabs of 6 rows, y-chunks of 5)"""
    from pmesh_tpu_torch import ParticleMesh
    from pmesh_tpu_torch.models.fastpm import Solver
    from pmesh_tpu_torch.ops import binned as tbn
    from pmesh_tpu_torch.ops import fft_mxu as fm
    from pmesh_tpu_torch.parallel import launch
    n = 16
    rng = np.random.RandomState(63)
    disp = tuple(rng.uniform(-0.5, 1.5, (n,) * 3).astype('f4')
                 for _ in range(3))
    dsl = tuple(tuple(rng.uniform(-0.5, 1.5, (n,) * 3).astype('f4')
                      for _ in range(3)) for _ in range(2))
    val = tuple((rng.uniform(size=(n,) * 3) < 0.7).astype('f4')
                for _ in range(2))
    dshape = (24, 20, 15)
    xd = (1 + 0.3 * rng.normal(size=dshape)).astype('f4')
    _, pk2, kd, _ = Solver(ParticleMesh(list(dshape), np.asarray(
        dshape, float), dtype='f4', device='cpu'))._mxu_setup()
    spec = tuple(t.numpy() for t in fm.fft3_real_forward_half(
        torch.from_numpy(xd)))
    cases = [('paint', (disp, None, (-0.5, 1.5), 'cic')),
             ('force', ([n] * 3, float(n), disp, (-0.5, 1.5), 'spectral',
                        'xla')),
             ('force', ([n] * 3, float(n), disp, (-0.5, 1.5), 'spectral',
                        'mxu')),
             ('rebase', (dsl, val, (-0.5, 1.5), (), 2)),
             ('comm', ()),
             ('dense', (xd, spec, kd, pk2))]
    # build the kernels once here, not in every rank
    from pmesh_tpu_torch.native import cuda
    for name in ("gridpm", "binned", "fft_mxu"):
        cuda.load(name)
    from torch_sharded_cases import CASES
    out = launch.spawn(CASES + ':run_cases', 4, 'gloo', 'cuda', cases)

    def rows(k, j=None):
        return np.concatenate([o[k] if j is None else o[k][j] for o in out])
    D = tuple(torch.from_numpy(d).to(dev) for d in disp)
    ref = tgp.paint_grid(D, bounds=(-0.5, 1.5)).cpu().numpy()
    assert np.abs(rows(0) - ref).max() <= TOL * np.abs(ref).max()
    s = Solver(ParticleMesh([n] * 3, float(n), dtype='f4', device=dev))
    for k, fft in ((1, 'xla'), (2, 'mxu')):
        F = s.force_lattice(D, (-0.5, 1.5), fft=fft)
        for j in range(3):
            r = F[j].cpu().numpy()
            assert np.abs(rows(k, j) - r).max() <= TOL * np.abs(r).max()
    whole = tbn.rebase(tuple(tuple(torch.from_numpy(x).to(dev) for x in dk)
                             for dk in dsl),
                       tuple(torch.from_numpy(v).to(dev) for v in val),
                       (-0.5, 1.5), nslots_out=2)
    fields = [np.concatenate([_flat(o[3][:2])[f] for o in out])
              for f in range(len(_flat(whole[:2])))]
    for g, w in zip(fields, _flat(whole[:2])):
        assert np.array_equal(g.view(np.uint32),
                              w.cpu().numpy().view(np.uint32))
    assert [o[3][3] for o in out] == [int(whole[3])] * 4
    assert all(o[4]['staged']['to_host'] > 0 for o in out)
    # row 9: the forward's y-chunks, the inverse and the forces' slabs
    X = torch.from_numpy(xd).to(dev)
    fwd = fm.fft3_real_forward_half(X)
    S = tuple(torch.from_numpy(a).to(dev) for a in spec)
    ref = {'fwd': fwd,
           'inv': fm.fft3_real_inverse_grad3_half(*S, dshape[2], kd),
           'forces': fm.fft3_real_inverse_grad3_half(
               *fwd, dshape[2], kd, poisson_k2=pk2)}
    for part, axis in (('fwd', 1), ('inv', 0), ('forces', 0)):
        for j, r in enumerate(ref[part]):
            g = np.concatenate([o[5][part][j] for o in out], axis)
            r = r.cpu().numpy()
            assert np.abs(g - r).max() <= TOL * np.abs(r).max(), (part, j)


# --- the catalog path: torch calls on CUDA tensors, no hand kernel --------

@pytest.mark.parametrize("window, hsml", [('cic', False), ('tsc', True),
                                          ('lanczos3', False)])
def test_catalog_paint_readout_card_vs_cpu(dev, window, hsml):
    from pmesh_tpu_torch.ops import paint as gpaint
    rng = np.random.RandomState(5)
    n = 32
    pos = torch.from_numpy(rng.uniform(-1, n + 1, (20000, 3)).astype('f4'))
    mass = torch.from_numpy(rng.uniform(0.5, 1.5, 20000).astype('f4'))
    mesh = torch.from_numpy(rng.normal(size=(n,) * 3).astype('f4'))
    h = torch.from_numpy(rng.uniform(0.6, 1.3, 20000).astype('f4')) \
        if hsml else None
    kw = dict(window=window, scale=0.95, translate=0.5, period=n)
    ref = gpaint.paint(torch.zeros_like(mesh), pos, mass, hsml=h, **kw)
    got = gpaint.paint(torch.zeros_like(mesh).to(dev), pos.to(dev),
                       mass.to(dev), hsml=None if h is None else h.to(dev),
                       **kw)
    assert got.device.type == dev.type and _rel(got.cpu(), ref) <= TOL
    if window == 'cic':
        # CIC weights sum to 1: the atomics keep the mass to rounding
        total = float(mass.double().sum())
        assert abs(float(got.double().sum()) - total) <= 1e-5 * total
    meshes = (mesh, 2 * mesh, -mesh)
    ref = gpaint.readout(meshes, pos, hsml=h, **kw)
    got = gpaint.readout(tuple(m.to(dev) for m in meshes), pos.to(dev),
                         hsml=None if h is None else h.to(dev), **kw)
    for r, g in zip(ref, got):
        assert g.device.type == dev.type and _rel(g.cpu(), r) <= TOL


def test_catalog_native_whitenoise_card_bitwise(dev):
    from pmesh_tpu_torch import whitenoise
    shape = (32, 32, 17)
    cpu = whitenoise.native_uniforms((32,) * 3, shape, 42, 'cpu')
    card = whitenoise.native_uniforms((32,) * 3, shape, 42, dev)
    for a, b in zip(cpu, card):
        assert b.device.type == dev.type and torch.equal(a, b.cpu())


def test_catalog_force_card_vs_cpu(dev):
    from pmesh_tpu_torch import ParticleMesh
    from pmesh_tpu_torch.models.fastpm import Solver
    from pmesh_tpu_torch.models.powerspectrum import EHPower
    from pmesh_tpu_torch.models.cosmology import Planck15
    out = {}
    for device in ('cpu', dev):
        pm = ParticleMesh([16] * 3, BoxSize=32.0, dtype='f4', device=device)
        solver = Solver(pm, B=2)
        state = solver.lpt(solver.linear_field(EHPower(Planck15), 7), 0.5)
        out[str(device)] = [solver.force(state.X, mode=m).cpu()
                            for m in ('spectral', 'gradient')]
        assert state.S.device.type == torch.device(device).type
    for r, g in zip(out['cpu'], out[str(dev)]):
        assert _rel(g, r) <= 1e-4


@pytest.mark.parametrize("n", [64, 256])
def test_slab_c2r_keeps_numpy_convention_on_card(dev, n):
    """the slab inverse FFT of parallel/pfft.py on one rank, on a
    spectrum whose x-Nyquist modes are not hermitian (i k_x, the Nyquist
    index -N/2, as the 1LPT transfer leaves them): numpy's irfftn on the
    host within 1e-6 of max, as the 3-d irfftn on the card is (cuFFT's
    C2R at 256 reads the imaginary parts of the z-DC column)"""
    from pmesh_tpu_torch.parallel import pfft
    from pmesh_tpu_torch.parallel.pmesh import ProcessMesh
    x = np.random.RandomState(0).normal(size=(n,) * 3)
    k = np.fft.fftfreq(n, 1.0 / n)
    k[n // 2] = -(n // 2)
    spec = np.fft.rfftn(x) * (1j * k[:, None, None])
    ref = torch.from_numpy(np.fft.irfftn(spec, s=(n,) * 3, axes=(0, 1, 2),
                                         norm='forward'))
    s = torch.from_numpy(spec.astype(np.complex64)).to(dev)
    got = pfft.c2r(ProcessMesh(device=dev), s, (n,) * 3, torch.float32)
    assert got.device.type == dev.type
    assert _rel(got.double().cpu(), ref) <= 1e-6
    whole = torch.fft.irfftn(s, s=(n,) * 3, norm='forward')
    assert _rel(whole.double().cpu(), ref) <= 1e-6


# --- the field core: forward mode and resample, card against CPU ----------

@pytest.mark.parametrize("window", ['cic', 'tsc'])
def test_field_jvp_functions_card_vs_cpu(dev, window):
    """torch.func.jvp through the generic paint and readout (their
    custom_jvp rules as Function.jvp), and forward over reverse, at 32^3
    in f8: the card against the CPU"""
    from pmesh_tpu_torch.ops import paint as gpaint
    rng = np.random.RandomState(9)
    n = 32
    kw = dict(window=window, scale=1.0, period=n)
    arrays = dict(pos=rng.uniform(0, n, (5000, 3)),
                  mass=rng.uniform(0.5, 1.5, 5000),
                  v_pos=rng.normal(size=(5000, 3)),
                  v_mass=rng.normal(size=5000),
                  mesh=rng.normal(size=(n,) * 3),
                  v_mesh=rng.normal(size=(n,) * 3))
    out = {}
    for device in ('cpu', dev):
        t = {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}

        def paint(p, m):
            return gpaint.paint(torch.zeros((n,) * 3, dtype=p.dtype,
                                            device=p.device), p, m, **kw)

        def readout(mesh, p):
            return gpaint.readout(mesh, p, **kw)

        def loss(p):
            return (paint(p, t['mass']) ** 2).sum()
        _, tp = torch.func.jvp(paint, (t['pos'], t['mass']),
                               (t['v_pos'], t['v_mass']))
        _, tr = torch.func.jvp(readout, (t['mesh'], t['pos']),
                               (t['v_mesh'], t['v_pos']))
        _, hvp = torch.func.jvp(torch.func.grad(loss), (t['pos'],),
                                (t['v_pos'],))
        out[str(device)] = [x.cpu() for x in (tp, tr, hvp)]
        assert tp.device.type == torch.device(device).type
    for r, g in zip(out['cpu'], out[str(dev)]):
        # f8 atomics sum in another order
        assert _rel(g, r) <= 1e-10


def test_field_resample_card_vs_cpu(dev):
    """resample, upsample/downsample and preview at 32^3 f8, and a c2c
    round trip: the card against the CPU"""
    from pmesh_tpu_torch import ParticleMesh
    rng = np.random.RandomState(10)
    x = rng.normal(size=(32,) * 3)
    out = {}
    for device in ('cpu', dev):
        pm = ParticleMesh([32] * 3, BoxSize=64.0, device=device)
        real = pm.create(type='real', value=torch.from_numpy(x).to(device))
        got = []
        for n in (16, 48):
            o = pm.reshape(Nmesh=n).create(type='complex')
            real.r2c().resample(o)
            got.append(o.value)
        pm2 = pm.reshape(Nmesh=16)
        got.append(pm2.downsample(real, keep_mean=True).value)
        got.append(pm.reshape(Nmesh=64).upsample(real, resampler='tsc').value)
        got.append(torch.from_numpy(real.preview(Nmesh=16, axes=(0, 2))))
        c2c = ParticleMesh([32] * 3, BoxSize=64.0, dtype='c16',
                           device=device)
        z = c2c.create(type='real',
                       value=torch.from_numpy(x + 1j * x[::-1]).to(device))
        got.append(z.r2c().c2r().value - z.value)
        out[str(device)] = [g.cpu() for g in got]
        assert got[0].device.type == torch.device(device).type
    for r, g in zip(out['cpu'][:-1], out[str(dev)][:-1]):
        assert _rel(g, r) <= 1e-10
    assert float(out[str(dev)][-1].abs().max()) <= 1e-12 * np.abs(x).max()


# --- reverse mode through the binned path on the card ------------------------

def _binned_leaves(dev, n=32, K=2):
    """phase 6's state at n^3 as K slots whose displacements require grad"""
    from pmesh_tpu_torch.ops import binned as tbn
    rng = np.random.RandomState(13)
    disp = tuple(torch.from_numpy(
        (0.05 + 0.9 * rng.uniform(size=(n,) * 3)).astype('f4')).to(dev)
        for _ in range(3))
    dslots, valid = tbn.from_lattice(disp, nslots=K)
    return ([[d.clone().requires_grad_() for d in dk] for dk in dslots],
            valid)


def test_force_binned_backward_launches_the_lattice_kernels(dev):
    """per slot, as per lattice force: 1 paint + 1 three-mesh readout
    forward; 3 paints (the meshes' cotangents) + 3 three-mesh readouts
    (the derivative axes) + 1 'all' readout (the paint's) backward; no
    other kernel; the gradient within 1e-4 of max|g| of the CPU's"""
    from pmesh_tpu_torch import ParticleMesh
    from pmesh_tpu_torch.models.fastpm import Solver
    from pmesh_tpu_torch.ops import binned_cuda, fft_mxu_cuda, gridpm_cuda
    grads = {}
    for device in (dev, torch.device('cpu')):
        pm = ParticleMesh([32] * 3, BoxSize=32.0, dtype='f4',
                          resampler='cic', device=device)
        leaves, valid = _binned_leaves(device)
        for mod in (gridpm_cuda, binned_cuda, fft_mxu_cuda):
            mod.reset_launches()
        F = Solver(pm).force_binned(leaves, valid, (-0.5, 1.5))
        loss = sum((f * f * v).sum() for fk, v in zip(F, valid) for f in fk)
        grads[device.type] = torch.autograd.grad(
            loss, [d for dk in leaves for d in dk])
        if device.type == 'cuda':
            assert _launched(gridpm_cuda) == {"paint_lattice": 2 * 4,
                                              "readout_lattice": 2 * 5}
            assert not _launched(binned_cuda)
            assert not _launched(fft_mxu_cuda)
    scale = max(float(g.abs().max()) for g in grads['cpu'])
    for g, r in zip(grads['cuda'], grads['cpu']):
        assert torch.isfinite(g).all()
        assert float((g.cpu() - r).abs().max()) <= 1e-4 * scale


def test_binned_grads_refuse_on_the_card(dev):
    """the CUDA rebase and a diffdir lattice readout have no gradient
    rule (as the JAX package's Pallas kernels have none): nbody_binned
    and the gradient-mode force_binned raise under autograd on the card"""
    from pmesh_tpu_torch import ParticleMesh
    from pmesh_tpu_torch.models.fastpm import Solver
    pm = ParticleMesh([32] * 3, BoxSize=32.0, dtype='f4', resampler='cic',
                      device=dev)
    leaves, valid = _binned_leaves(dev)
    with pytest.raises(NotImplementedError, match='gridpm.py:482'):
        Solver(pm).force_binned(leaves, valid, (-0.5, 1.5), mode='gradient')
    disp = tuple(leaves[0])
    vel = tuple(torch.zeros_like(d) for d in disp)
    with pytest.raises(NotImplementedError, match='no gradient rule'):
        Solver(pm).nbody_binned(disp, vel, [0.5, 0.55, 0.6], nslots=2,
                                rebase_every=2)


def test_sharded_lattice_backward_on_the_card(dev):
    """four ranks on the card over gloo: the 64^3 slab lattice paint's
    (a mesh mass) and readout's (three meshes) gradients on the x-halo
    kernels against the plain slab forms (impl='torch') on the same
    tensors, gathered; every launch is an x-halo kernel's, summed over
    the ranks: per rank the paint 1 + (1 mass readout, 1 'all'
    readout), the readout 1 + (3 paints, 3 three-mesh derivative
    readouts); the plain runs launch none"""
    from pmesh_tpu_torch.parallel import launch
    from pmesh_tpu_torch.native import cuda
    cuda.load("gridpm")
    rng = np.random.RandomState(64)
    n, bounds = 64, (-0.5, 1.0)
    disp = [rng.uniform(*bounds, (n,) * 3).astype('f4') for _ in range(3)]
    mass = (1 + 0.2 * rng.normal(size=(n,) * 3)).astype('f4')
    meshes = [rng.normal(size=(n,) * 3).astype('f4') for _ in range(3)]
    w = [rng.uniform(0.5, 1.5, (n,) * 3).astype('f4') for _ in range(3)]
    from torch_sharded_grad_cases import CASES
    out = launch.spawn(CASES + ':card_lattice_backward', 4, 'gloo', 'cuda',
                       disp, mass, meshes, w, bounds, timeout=300)
    need = {'paint': {"paint_lattice_xhalo": 4, "readout_lattice_xhalo": 8},
            'readout': {"paint_lattice_xhalo": 12,
                        "readout_lattice_xhalo": 16}}
    for name in ('paint', 'readout'):
        total = {}
        for o in out:
            for k, v in o[name, None]['launches'].items():
                total[k] = total.get(k, 0) + v
            assert o[name, 'torch']['launches'] == {}
        assert total == need[name], (name, total)
        for j in range(len(out[0][name, None]['grads'])):
            got = np.concatenate([o[name, None]['grads'][j] for o in out])
            ref = np.concatenate([o[name, 'torch']['grads'][j] for o in out])
            assert np.abs(got - ref).max() <= TOL * np.abs(ref).max(), \
                (name, j)
