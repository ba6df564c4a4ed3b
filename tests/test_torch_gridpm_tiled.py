"""The staged lattice kernels' design on the CPU (csrc/gridpm.cu runs only
on the card): the launch planner of ops/gridpm_cuda.py against the
kernels' constants and shared-memory layouts, the arguments the wrappers
pass, and a plain-torch emulation of the kernels' index maps (the
wrapped tile plus halo, the readout's ring of mesh planes, the paint's
per-source weight table walked from high x to low with a ring of
accumulators, the taps read from them) held bitwise to the plain roll
loop (``ops/gridpm._shift_loop``): same f32 terms, same order.
"""
import itertools
import re
import os

import numpy as np
import pytest
import torch

from pmesh_tpu_torch.ops import gridpm as tgp
from pmesh_tpu_torch.ops import gridpm_cuda as gc
from pmesh_tpu_torch.ops.kernels import find_window

torch.set_num_threads(1)

TZ = gc.TILE_Z
SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "pmesh_tpu_torch", "csrc", "gridpm.cu")
WINDOWS = ['nearest', 'cic', 'tsc', 'pcs', 'lanczos2', 'db6']
SHAPES = [(512, 512, 512), (131, 512, 512), (384, 384, 384), (3, 5, 7),
          (70, 20, 36), (1, 1, 1)]
# CIC bounds by offsets per axis
CIC_BOUNDS = {2: (0.0, 1.0), 3: (-1.0, 1.0), 4: (-0.5, 1.5),
              5: (-2.0, 2.0)}


def _source():
    with open(SRC) as f:
        return f.read()


def test_planner_constants_are_the_kernels():
    """the tile, the widest window and the compiled widths of the C
    source are the planner's"""
    src = _source()
    m = re.search(r"constexpr int TZ = (\d+), kThreads = (\d+), TROWS = "
                  r"kThreads / TZ, RY = (\d+);", src)
    tz, threads, ry = (int(x) for x in m.groups())
    assert (tz, threads, ry) == (TZ, gc.THREADS, gc.ROWS_PER_THREAD)
    assert re.search(r"TY_READOUT = TROWS, TY_PAINT = TROWS \* RY;", src)
    assert gc.TILE_Y == {'readout': threads // tz,
                         'paint': threads // tz * ry}
    assert re.search(r"constexpr int NV_MAX = %d," % gc.NV_MAX, src)
    for name in ("PAINT_NV", "READOUT_NV"):
        widths = tuple(int(x) for x in re.findall(r"\b%s\((\d+)\)" % name,
                                                  src))
        assert widths == gc.NV_COMPILED, name
    assert round(gc.NV_MAX ** 3) == tgp.GRID_LIMIT


def _grid(p, shape):
    """the launch grid the entry points form from the plan: (z tiles,
    y tiles, x chunks)"""
    n0, n1, n2 = shape
    ty, tz = p['tile']
    return (-(-n2 // tz), -(-n1 // ty), -(-n0 // p['xc']))


def _layout_bytes(op, nv, nmesh=1, mass=False, nbuf=1):
    """the dynamic shared bytes the kernels index: the readout's ring
    (ring[slot * NM * area + m * area + cell], nv + 1 slots), the paint's
    tables (table[buf * (3 nv + mass) * area + row * area + cell]), area
    the f32 cells of the tile plus its nv - 1 halo"""
    area = (gc.TILE_Y[op] + nv - 1) * (TZ + nv - 1)
    if op == 'readout':
        return (nv + 1) * nmesh * area * 4
    return nbuf * (3 * nv + int(mass)) * area * 4


@pytest.mark.parametrize("shape", SHAPES)
def test_plan_fits_covers_and_matches_the_kernels_count(shape):
    n0, n1, n2 = shape
    for nv in range(1, gc.NV_MAX + 1):
        plans = [('readout', gc.plan('readout', shape, nv, nmesh=nm))
                 for nm in (1, 2, 3)]
        plans += [('paint', gc.plan('paint', shape, nv, mass=m))
                  for m in (False, True)]
        for op, p in plans:
            assert 0 < p['smem'] <= gc.SMEM_LIMIT, p
            assert p['tile'] == (gc.TILE_Y[op], TZ)
            TY = p['tile'][0]
            gz, gy, gx = _grid(p, shape)
            # every output cell has exactly one block: no block is empty
            assert gz * TZ >= n2 > (gz - 1) * TZ
            assert gy * TY >= n1 > (gy - 1) * TY
            assert gx * p['xc'] >= n0 > (gx - 1) * p['xc']
            assert 1 <= p['xc'] <= min(n0, gc.XC_MAX)
            assert gx <= 65535 and gy <= 65535
            assert p['width'] == (nv if nv in gc.NV_COMPILED else None)
        for nm, (_, p) in zip((1, 2, 3), plans[:3]):
            assert p['depth'] == nv + 1 and p['nbuf'] is None
            assert p['smem'] == _layout_bytes('readout', nv, nmesh=nm)
        for m, (_, p) in zip((False, True), plans[3:]):
            assert p['nbuf'] in (1, 2) and p['depth'] is None
            assert p['smem'] == _layout_bytes('paint', nv, mass=m,
                                              nbuf=p['nbuf'])
            # two tables wherever two fit
            assert (p['nbuf'] == 2) == (
                _layout_bytes('paint', nv, mass=m, nbuf=2) <= gc.SMEM_LIMIT)
    # the hot shapes leave room for three blocks per SM
    for p in (gc.plan('readout', shape, 4, nmesh=3),
              gc.plan('paint', shape, 4, mass=True)):
        assert 3 * p['smem'] <= gc.SMEM_LIMIT
    with pytest.raises(ValueError):
        gc.plan('paint', shape, gc.NV_MAX + 1)


def test_plan_fills_the_card():
    """at the main paths' shapes the launch has at least four blocks per
    SM, and x chunks long against the window's halo"""
    for shape in ((512,) * 3, (384,) * 3, (128 + 3, 1024, 1024)):
        p = gc.plan('readout', shape, 3, nmesh=3)
        assert np.prod(_grid(p, shape)) >= gc.MIN_BLOCKS
        assert p['xc'] >= 8 * 3


class _FakeLib:
    """stands in for the built library: records each entry point's
    arguments and returns success"""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def call(*args):
            self.calls.append((name, args))
            return 0
        return call


class _Tensor:
    """what the wrappers read of a CUDA tensor"""

    def __init__(self, shape, dtype):
        self.shape, self.dtype = torch.Size(shape), dtype
        self.device = torch.device('cuda', 0)

    def data_ptr(self):
        return 4096


@pytest.fixture
def fake_launch(monkeypatch):
    lib = _FakeLib()
    monkeypatch.setattr(gc, "_load", lambda name="gridpm": lib)
    monkeypatch.setattr(gc, "_check", lambda arrays, what: (
        tuple(arrays[0].shape), arrays[0].device))
    monkeypatch.setattr(gc, "_window_args", lambda window, device, dtype: (
        0, None, 0, 0.0, 0.0))

    class Stream:
        cuda_stream = 0
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: Stream())
    monkeypatch.setattr(torch, "empty", lambda shape, dtype, device:
                        _Tensor(shape, dtype))
    before = dict(gc.LAUNCHES)
    yield lib
    gc.LAUNCHES.update(before)


@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float64])
def test_wrappers_launch_the_plan(fake_launch, window, dtype):
    """the wrappers pass the planner's xc, nbuf and shared bytes for every
    window kind and storage (f64 planned with its own tile and 8-byte
    values), meshes 1 to 3 and 'all', mass or none, and the x-halo form
    (planned on its output rows)"""
    code = {torch.float32: 0, torch.bfloat16: 1, torch.float64: 2}[dtype]
    shape = (12, 10, 40)
    vmin, vmax = tgp.offset_range(-1.0, 1.5, window)
    nv = vmax - vmin + 1
    d = tuple(_Tensor(shape, dtype) for _ in range(3))
    for mass in (None, torch.zeros(shape, dtype=dtype), 0.5):
        mesh_mass = isinstance(mass, torch.Tensor)
        gc.paint_lattice(d, mass, vmin, vmax, window)
        gc.paint_lattice(d, mass, vmin, vmax, window, rows=4, xbase=vmax)
        for out_rows in (shape[0], 4):
            p = gc.plan('paint', (out_rows,) + shape[1:], nv,
                        mass=mesh_mass, dtype=dtype)
            name, args = fake_launch.calls.pop(0)
            assert name == "pmesh_paint_lattice"
            # ..., dtype, xc, nbuf, smem, device, stream
            assert args[-6:-2] == (code, p['xc'], p['nbuf'], p['smem'])
    for diffdir, nm in ((None, 1), (None, 2), (None, 3), (0, 3),
                        ('all', 1)):
        gc.readout_lattice(d[:nm], d, vmin, vmax, window, diffdir=diffdir)
        p = gc.plan('readout', shape, nv, nmesh=nm, dtype=dtype)
        name, args = fake_launch.calls.pop(0)
        assert name == "pmesh_readout_lattice"
        assert args[-5:-2] == (code, p['xc'], p['smem'])
        assert args[3] == nm
    rows = 5
    gc.readout_lattice(d, tuple(_Tensor((rows,) + shape[1:], dtype)
                                for _ in range(3)), vmin, vmax, window,
                       xbase=-vmin)
    p = gc.plan('readout', (rows,) + shape[1:], nv, nmesh=3, dtype=dtype)
    assert fake_launch.calls.pop(0)[1][-4:-2] == (p['xc'], p['smem'])


# --- the kernels' index maps, emulated in plain torch ----------------------

def _plane(p, n0, xbase):
    """the input plane of x coordinate p (output coordinates)"""
    return p % n0 if xbase is None else p + xbase


def _blocks(p, shape):
    gz, gy, gx = _grid(p, shape)
    return itertools.product(range(gx), range(gy), range(gz))


def _thread_cells(j0, k0, n1, n2, TY):
    ty = torch.arange(TY)[:, None]
    tz = torch.arange(TZ)[None, :]
    j, k = (j0 + ty).expand(TY, TZ), (k0 + tz).expand(TY, TZ)
    live = (j < n1) & (k < n2)
    return ty, tz, j.clamp(max=n1 - 1), k.clamp(max=n2 - 1), live


def emulate_readout(meshes, disp, vmin, vmax, window, diffdir=None,
                    xbase=None):
    """readout_staged: per block, mesh planes of the region (TY + nv - 1)
    x (TZ + nv - 1) from (j0 + vmin, k0 + vmin), wrapped by the loader,
    in a ring of nv + 1 slots; per particle its axis weights once; the
    taps v_x, v_y, v_z read from the ring"""
    win = find_window(window)
    nv = vmax - vmin + 1
    n0, n1, n2 = disp[0].shape
    n_mesh = meshes[0].shape[0]
    p = gc.plan('readout', disp[0].shape, nv, nmesh=len(meshes))
    depth, xc, TY = p['depth'], p['xc'], p['tile'][0]
    nout = 3 if diffdir == 'all' else len(meshes)
    outs = [torch.full(disp[0].shape, float('nan')) for _ in range(nout)]
    for bz, by, bx in _blocks(p, disp[0].shape):
        j0, k0, x0 = by * TY, bx * TZ, bz * xc
        x1 = min(x0 + xc, n0)
        ys = (j0 + vmin + torch.arange(TY + nv - 1)) % n1
        zs = (k0 + vmin + torch.arange(TZ + nv - 1)) % n2
        ring = [None] * depth

        def stage(pl, slot):
            x = _plane(pl, n_mesh, xbase)
            ring[slot] = [m[x][ys][:, zs] for m in meshes]
        for t in range(nv - 1):
            stage(x0 + vmin + t, t)
        head, tail = 0, nv - 1
        ty, tz, j, k, live = _thread_cells(j0, k0, n1, n2, TY)
        for i in range(x0, x1):
            stage(i + vmax, tail)
            tail = (tail + 1) % depth
            s = [d[i][j, k] for d in disp]

            def weights(d, diff):
                return [tgp._axis_weight(win, diff, vmin + a, s[d])
                        for a in range(nv)]
            kx, ky, kz = (weights(d, diffdir == d) for d in range(3))
            if diffdir == 'all':
                kxd, kyd, kzd = (weights(d, True) for d in range(3))
            acc = [torch.zeros(TY, TZ) for _ in range(nout)]
            for a in range(nv):
                slot = ring[(head + a) % depth]
                for b, c in itertools.product(range(nv), range(nv)):
                    v = [m[ty + b, tz + c] for m in slot]
                    if diffdir == 'all':
                        acc[0] = acc[0] + ((kxd[a] * ky[b]) * kz[c]) * v[0]
                        acc[1] = acc[1] + ((kx[a] * kyd[b]) * kz[c]) * v[0]
                        acc[2] = acc[2] + ((kx[a] * ky[b]) * kzd[c]) * v[0]
                    else:
                        w = (kx[a] * ky[b]) * kz[c]
                        acc = [o + w * x for o, x in zip(acc, v)]
            for out, a in zip(outs, acc):
                out[i][j[live], k[live]] = a[live]
            head = (head + 1) % depth
    return tuple(outs)


def emulate_paint(disp, mass, vmin, vmax, window, diffdir=None, rows=None,
                  xbase=None):
    """paint_staged: per block, source planes from x1 - 1 - vmin down to
    x0 - vmax; for each, the table of 3 nv axis weights (and the mass) of
    every cell of the region (TY + nv - 1) x (TZ + nv - 1) from
    (j0 - vmax, k0 - vmax), wrapped by the loader; each thread adds the
    plane's taps to its nv accumulators (output planes s + vmin + a) and
    stores the one that is complete (s + vmax)"""
    win = find_window(window)
    nv = vmax - vmin + 1
    n_in, n1, n2 = disp[0].shape
    n0 = n_in if xbase is None else rows
    mesh_mass = isinstance(mass, torch.Tensor)
    scalar = 1.0 if mass is None or mesh_mass else float(mass)
    p = gc.plan('paint', (n0, n1, n2), nv, mass=mesh_mass)
    xc, TY = p['xc'], p['tile'][0]
    out = torch.full((n0, n1, n2), float('nan'))
    for bz, by, bx in _blocks(p, (n0, n1, n2)):
        j0, k0, x0 = by * TY, bx * TZ, bz * xc
        x1 = min(x0 + xc, n0)
        ys = (j0 - vmax + torch.arange(TY + nv - 1)) % n1
        zs = (k0 - vmax + torch.arange(TZ + nv - 1)) % n2
        ty, tz, j, k, live = _thread_cells(j0, k0, n1, n2, TY)
        acc = [torch.zeros(TY, TZ) for _ in range(nv)]
        for s in range(x1 - 1 - vmin, x0 - vmax - 1, -1):
            x = _plane(s, n_in, xbase)
            src = [d[x][ys][:, zs] for d in disp]
            tab = [[tgp._axis_weight(win, diffdir == d, vmin + a, src[d])
                    for a in range(nv)] for d in range(3)]
            m = mass[x][ys][:, zs] if mesh_mass else None
            for b, c in itertools.product(range(nv), range(nv)):
                cy, cz = ty + nv - 1 - b, tz + nv - 1 - c
                wy, wz = tab[1][b][cy, cz], tab[2][c][cy, cz]
                for a in range(nv):
                    w = tab[0][a][cy, cz] * wy
                    w = w * wz
                    if mesh_mass:
                        w = w * m[cy, cz]
                    acc[a] = acc[a] + w
            o = s + vmax
            if x0 <= o < x1:
                out[o][j[live], k[live]] = (acc[nv - 1] * scalar)[live]
            acc = [torch.zeros(TY, TZ)] + acc[:-1]
    return out


def _inputs(seed, shape, bounds):
    rng = np.random.RandomState(seed)
    disp = tuple(torch.from_numpy(rng.uniform(bounds[0], bounds[1], shape)
                                  .astype('f4')) for _ in range(3))
    mass = torch.from_numpy((1 + 0.2 * rng.normal(size=shape)).astype('f4'))
    meshes = tuple(torch.from_numpy(rng.normal(size=shape).astype('f4'))
                   for _ in range(3))
    return disp, mass, meshes


# a mesh smaller than a tile and than the window; z not a whole tile;
# several x chunks
EMU_SHAPES = [(3, 5, 7), (9, 10, 36), (20, 9, 33)]


@pytest.mark.parametrize("nv", sorted(CIC_BOUNDS))
@pytest.mark.parametrize("shape", EMU_SHAPES)
def test_emulated_staged_gather_is_the_roll_loop(nv, shape):
    bounds = CIC_BOUNDS[nv]
    vmin, vmax = tgp.offset_range(*bounds, 'cic')
    assert vmax - vmin + 1 == nv
    disp, mass, meshes = _inputs(nv, shape, bounds)
    for diffdir, m in ((None, None), (None, mass), (0, None)):
        ref = tgp._shift_loop(None, disp, m, bounds, 'cic', diffdir,
                              'paint', impl='torch')
        got = emulate_paint(disp, m, vmin, vmax, 'cic', diffdir)
        assert torch.equal(got, ref), (diffdir, m is None)
    for diffdir, nm in ((None, 1), (None, 3), (0, 3), ('all', 1)):
        ref = tgp._shift_loop(meshes[:nm], disp, None, bounds, 'cic',
                              diffdir, 'readout', impl='torch')
        got = emulate_readout(meshes[:nm], disp, vmin, vmax, 'cic', diffdir)
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            assert torch.equal(g, r), (diffdir, nm)


def test_emulated_staged_gather_tsc():
    """a window whose weights are not piecewise linear (nv = 5)"""
    bounds, shape = (-1.0, 1.0), (6, 10, 34)
    vmin, vmax = tgp.offset_range(*bounds, 'tsc')
    disp, mass, meshes = _inputs(11, shape, bounds)
    ref = tgp._shift_loop(None, disp, mass, bounds, 'tsc', 2, 'paint',
                          impl='torch')
    assert torch.equal(emulate_paint(disp, mass, vmin, vmax, 'tsc', 2), ref)
    ref = tgp._shift_loop(meshes, disp, None, bounds, 'tsc', 1, 'readout',
                          impl='torch')
    got = emulate_readout(meshes, disp, vmin, vmax, 'tsc', 1)
    assert all(torch.equal(g, r) for g, r in zip(got, ref))


@pytest.mark.parametrize("nv", [3, 4])
def test_emulated_staged_gather_xhalo(nv):
    """the x-halo slab form: input plane p + xbase, no wrap on x"""
    bounds, rows = CIC_BOUNDS[nv], 11
    vmin, vmax = tgp.offset_range(*bounds, 'cic')
    lo, hi = max(0, vmax), max(0, -vmin)
    disp, mass, meshes = _inputs(20 + nv, (lo + rows + hi, 9, 33), bounds)
    for m in (None, mass):
        ref = tgp.paint_slab_plain(disp, m, lo, rows, bounds, 'cic')
        got = emulate_paint(disp, m, vmin, vmax, 'cic', rows=rows, xbase=lo)
        assert torch.equal(got, ref)
    lo = max(0, -vmin)
    rdisp = tuple(d[lo:lo + rows].contiguous() for d in disp)
    for diffdir, nm in ((None, 3), ('all', 1)):
        ref = tgp.readout_slab_plain(meshes[:nm], rdisp, lo, bounds, 'cic',
                                     diffdir)
        got = emulate_readout(meshes[:nm], rdisp, vmin, vmax, 'cic',
                              diffdir, xbase=lo)
        assert all(torch.equal(g, r) for g, r in zip(got, ref))


def test_readout_grid_reads_three_meshes_in_one_launch(monkeypatch):
    """on CUDA tensors _shift_loop and the sharded path hand all three
    meshes to one kernel launch (more than three in groups of three)"""
    calls = []

    def fake(meshes, disp, vmin, vmax, win, diffdir=None, xbase=None):
        calls.append((len(meshes), diffdir, xbase))
        n = 3 if diffdir == 'all' else len(meshes)
        return tuple(meshes[0] for _ in range(n))
    monkeypatch.setattr(gc, "readout_lattice", fake)
    disp, _, meshes = _inputs(1, (4, 4, 4), (0.0, 1.0))
    k = gc
    assert len(tgp._readout_launches(k, meshes, disp, 0, 1, 'cic',
                                     None)) == 3
    assert len(tgp._readout_launches(k, meshes + meshes[:2], disp, 0, 1,
                                     'cic', 0, xbase=1)) == 5
    assert len(tgp._readout_launches(k, meshes[:1], disp, 0, 1, 'cic',
                                     'all')) == 3
    assert calls == [(3, None, None), (3, 0, 1), (2, 0, 1), (1, 'all', None)]
