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
    from pmesh_tpu_torch.ops import fft_mxu as fm
    n2, Zm = 16, 8
    x, _, _ = _fft_inputs(15, (2, 256, n2), dev)
    wz, wy = fm._z_fwd_tabs(n2, Zm), fm._ct_fwd_mats_np(256)
    with pytest.raises(NotImplementedError, match='f32'):
        fm._zy_fwd_ct2_call(x.double(), n2, Zm, wz, wy)
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


ROW13_ZERO = dict(zy_fwd_full=0, zy_inv_full=0, zy_fwd_half_ct=0,
                  zy_inv_half_ct=0)


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
    assert fft_mxu_cuda.LAUNCHES == dict(counts, zy_fwd_half=0, x_dense=0,
                                         zy_inv_half=0, **ROW13_ZERO)


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
    from pmesh_tpu_torch.ops import fft_mxu as fm
    x, _, _ = _fft_inputs(24, (6, 10, 9), dev)
    wz, wy = fm._dft_half_np(9, 5), fm._dft_np(10, -1)
    with pytest.raises(NotImplementedError, match='f32'):
        fm._zy_fwd_dense_call(x.double(), wz, wy)
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
    assert fft_mxu_cuda.LAUNCHES == dict(
        counts, zy_fwd_ct2=0, xct_multi=0, zy_inv_ct2=0, zy_inv_ct2_dual=0,
        **ROW13_ZERO)


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
    assert fft_mxu_cuda.LAUNCHES == dict(
        zy_fwd_ct2=0, xct_multi=2, zy_inv_ct2=0, zy_inv_ct2_dual=0,
        zy_fwd_half=0, x_dense=2, zy_inv_half=0, zy_fwd_full=1,
        zy_inv_full=3, zy_fwd_half_ct=1, zy_inv_half_ct=3)


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
                                           "readout_lattice": 6})):
        ref = _grads(fn, leaves, 'cpu')
        gridpm_cuda.reset_launches()
        got = _grads(fn, leaves, dev)
        # forward and backward: paint 1 + (1 mass readout, 1 'all');
        # readouts 3 (one per mesh) + (3 paints, one 3-mesh readout per
        # direction)
        assert gridpm_cuda.LAUNCHES == launches
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
        assert fft_mxu_cuda.LAUNCHES == dict(
            zy_fwd_ct2=1 + 3, xct_multi=2 + 6, zy_inv_ct2=1 + 3,
            zy_inv_ct2_dual=1, zy_fwd_half=0, x_dense=0, zy_inv_half=0,
            **ROW13_ZERO)
    elif fft == 'mxu':
        assert fft_mxu_cuda.LAUNCHES == dict(
            zy_fwd_ct2=0, xct_multi=0, zy_inv_ct2=0, zy_inv_ct2_dual=0,
            zy_fwd_half=4, x_dense=8, zy_inv_half=12, **ROW13_ZERO)


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
    assert fft_mxu_cuda.LAUNCHES == dict(
        zy_fwd_ct2=2, xct_multi=4, zy_inv_ct2=2, zy_inv_ct2_dual=0,
        zy_fwd_half=0, x_dense=0, zy_inv_half=0, **ROW13_ZERO)
    assert _rel(out[str(dev)][0], out['cpu'][0]) <= 1e-4
