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
    values, 'all' with its own rows a thread), meshes 1 to 3 and 'all',
    mass or none, and the x-halo form (planned on its output rows)"""
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
        p = gc.plan('readout', shape, nv, nmesh=nm, dtype=dtype,
                    diff_all=diffdir == 'all')
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


# --- the f64 kernels (csrc/gridpm64.cu): RY-row register blocks -----------

SRC64 = os.path.join(os.path.dirname(SRC), "gridpm64.cu")
F64 = torch.float64


def test_planner_f64_constants_are_the_kernels():
    """the f64 tile, the rows per thread of each kernel and width, and the
    compiled widths of csrc/gridpm64.cu are the planner's"""
    with open(SRC64) as f:
        src = f.read()
    m = re.search(r"constexpr int TZ64 = (\d+), TROWS64 = kThreads / TZ64;",
                  src)
    assert int(m.group(1)) == gc.TILE_Z64
    for macro, kind in (("ROWS64_READOUT", 'readout'),
                        ("ROWS64_READOUT_ALL", 'readout_all'),
                        ("ROWS64_PAINT", 'paint')):
        m = re.search(r"#define %s \{([\d, ]+)\}" % macro, src)
        rows = tuple(int(x) for x in m.group(1).split(","))
        assert rows == gc.ROWS64[kind] and len(rows) == gc.NV_MAX, macro
    m = re.search(r"#define ZCELLS64_PAINT \{([\d, ]+)\}", src)
    cells = tuple(int(x) for x in m.group(1).split(","))
    assert cells == gc.ZCELLS64 and set(cells) <= {1, 2}
    # widths 1 .. NV_WIDE64 - 1 in gridpm64.cu's library, the rest in
    # gridpm64w.cu's (GRIDPM64_WIDE), every width in one of them
    sets = re.findall(r"#define GRIDPM64_WIDTHS\(X\) ((?:X\(\d+\) ?)+)", src)
    wide, narrow = (tuple(int(x) for x in re.findall(r"X\((\d+)\)", w))
                    for w in sets)
    assert re.search(r"#ifdef GRIDPM64_WIDE\n#define GRIDPM64_WIDTHS", src)
    assert narrow == tuple(range(1, gc.NV_WIDE64))
    assert wide == tuple(range(gc.NV_WIDE64, gc.NV_MAX + 1))
    assert gc.NV_COMPILED64 == narrow + wide
    for name in ("PAINT64_NV", "READOUT64_NV"):
        assert "GRIDPM64_WIDTHS(%s)" % name in src
    with open(os.path.join(os.path.dirname(SRC), "gridpm64w.cu")) as f:
        assert re.search(r'#define GRIDPM64_WIDE 1\n#include "gridpm64.cu"',
                         f.read())
    # the region, ring and table the kernels index and bound their blocks
    # by: (TY + nv - 1) rows of TZ64 rz + nv - 1 cells rounded up to whole
    # rz, TY = THREADS / TZ64 rows of RY (rz = 1 but in the paint)
    assert re.search(r"return \(TZ64 \* rz \+ nv - 1 \+ rz - 1\) / rz \* rz;",
                     src)
    assert re.search(r"return \(ty \+ nv - 1\) \* width64\(nv, rz\);", src)
    assert re.search(r"area64\(TROWS64 \* rows64\(R64_PAINT, nv\), nv, "
                     r"zcells64\(nv\)\);", src)
    assert re.search(r"SLOT = NM \* AREA, DEPTH = NV \+ 1;", src)
    assert re.search(r"return \(nv \+ 1\) \* \(mode == MODE_ALL \? 1 : mode\) "
                     r"\* 8 \*", src)
    assert re.search(r"return \(3 \* nv \+ \(mass \? 1 : 0\)\) \* 8 \*", src)


def _layout64(op, nv, nmesh=1, mass=False, diff_all=False):
    """the f64 kernels' dynamic shared bytes: the readout's ring (nv + 1
    slots of nmesh regions), the paint's one table ((3 nv + mass) rows of
    the region), 8-byte values over the region of the RY-row tile"""
    kind = 'readout_all' if diff_all else op
    ty = gc.THREADS // gc.TILE_Z64 * gc.ROWS64[kind][nv - 1]
    rz = gc.ZCELLS64[nv - 1] if op == 'paint' else 1
    area = (ty + nv - 1) * (-(-(gc.TILE_Z64 * rz + nv - 1) // rz) * rz)
    if op == 'readout':
        return (nv + 1) * nmesh * area * 8
    return (3 * nv + int(mass)) * area * 8


@pytest.mark.parametrize("nv", range(1, gc.NV_MAX + 1))
def test_plan_f64_fits_and_covers(nv):
    """every width 1..NV_MAX: the f64 plan of both ops (1 to 3 meshes and
    'all'; a mass mesh or none) fits SMEM_LIMIT, is the kernels' layout,
    compiles the width in, and gives every output cell one block"""
    for shape in SHAPES + [(37, 45, 51), (130, 512, 512)]:
        n0, n1, n2 = shape
        plans = [('readout', dict(nmesh=nm)) for nm in (1, 2, 3)]
        plans += [('readout', dict(diff_all=True))]
        plans += [('paint', dict(mass=m)) for m in (False, True)]
        for op, kw in plans:
            p = gc.plan(op, shape, nv, dtype=F64, **kw)
            assert 0 < p['smem'] <= gc.SMEM_LIMIT, (op, kw, p)
            assert p['width'] == nv
            ty, tz = p['tile']
            rz = gc.ZCELLS64[nv - 1] if op == 'paint' else 1
            assert tz == gc.TILE_Z64 * rz
            assert ty % (gc.THREADS // gc.TILE_Z64) == 0
            assert p['tile'] == gc.tile(op, F64, nv, kw.get('diff_all',
                                                            False))
            if op == 'readout':
                assert p['depth'] == nv + 1
                assert p['smem'] == _layout64(op, nv, kw.get('nmesh', 1),
                                              diff_all=kw.get('diff_all',
                                                              False))
            else:
                # one table: csrc/gridpm64.cu's launch bounds count one
                assert p['nbuf'] == 1
                assert p['smem'] == _layout64(op, nv, mass=kw['mass'])
            gz, gy, gx = _grid(p, shape)
            assert gz * tz >= n2 > (gz - 1) * tz
            assert gy * ty >= n1 > (gy - 1) * ty
            assert gx * p['xc'] >= n0 > (gx - 1) * p['xc']
            assert gx <= 65535 and gy <= 65535


def _block_region(g, t, lo, n, length):
    """the wrapped indices of each of g blocks' staged region: (g, length)"""
    return (torch.arange(g)[:, None] * t + lo
            + torch.arange(length)[None, :]) % n


def _tile_threads(p, shape):
    """per block (by, bz) and thread (ly, lz) of TILE_Z64 threads along z:
    RY, RZ, the thread rows, the thread's first row j, first column k, and
    the grid"""
    n0, n1, n2 = shape
    ty, tz = p['tile']
    rz = tz // gc.TILE_Z64
    trows = gc.THREADS // gc.TILE_Z64
    ry = ty // trows
    gz, gy, gx = _grid(p, shape)
    j, k = torch.broadcast_tensors(
        torch.arange(gy)[:, None, None, None] * ty
        + torch.arange(trows)[None, None, :, None] * ry,
        torch.arange(gz)[None, :, None, None] * tz
        + torch.arange(gc.TILE_Z64)[None, None, None, :] * rz)
    return ry, rz, trows, j, k, (gz, gy, gx)


def _window_cells(region, rows, cols):
    """region (..., gy, gz, R, C) at the threads' cells: rows (trows, 1)
    and cols (1, tz) of the region -> (..., gy, gz, trows, tz)"""
    return region[..., rows, cols]


def emulate_readout64(meshes, disp, vmin, vmax, window, diffdir=None,
                      xbase=None):
    """readout64: per block the ring of nv + 1 mesh planes of the region
    (TY + nv - 1) x (TZ64 + nv - 1) from (j0 + vmin, k0 + vmin), wrapped
    by the loader; per thread RY rows j .. j + RY - 1 of column k, their y
    and z weights once a plane, the x weight once per v_x; for each v_x,
    staged row t of the thread's window and cell c read once and applied
    to every row r with v_y = vmin + t - r in the window"""
    win = find_window(window)
    nv = vmax - vmin + 1
    shape = tuple(disp[0].shape)
    n0, n1, n2 = shape
    n_mesh = meshes[0].shape[0]
    nm, all_ = len(meshes), diffdir == 'all'
    p = gc.plan('readout', shape, nv, nmesh=nm, dtype=F64,
                diff_all=all_)
    ry, _, trows, j, k, (gz, gy, gx) = _tile_threads(p, shape)
    ty, tz = p['tile']
    depth, xc = p['depth'], p['xc']
    ys = _block_region(gy, ty, vmin, n1, ty + nv - 1)
    zs = _block_region(gz, tz, vmin, n2, tz + nv - 1)
    lrow = torch.arange(trows)[:, None] * ry
    lcol = torch.arange(tz)[None, :]
    rows = [j + r for r in range(ry)]
    live = [(jr < n1) & (k < n2) for jr in rows]
    rows = [jr.clamp(max=n1 - 1) for jr in rows]
    kk = k.clamp(max=n2 - 1)
    nout = 3 if all_ else nm
    outs = [torch.full(shape, float('nan'), dtype=F64) for _ in range(nout)]

    def stage(pl):
        x = _plane(pl, n_mesh, xbase)
        return [m[x][ys[:, None, :, None], zs[None, :, None, :]]
                for m in meshes]

    def weights(d, s, diff):
        return [tgp._axis_weight(win, diff, vmin + a, s[d])
                for a in range(nv)]
    for bx in range(gx):
        x0 = bx * xc
        x1 = min(x0 + xc, n0)
        ring = [None] * depth
        for q in range(nv):
            ring[q] = stage(x0 + vmin + q)
        for i in range(x0, x1):
            h = i - x0
            if i + 1 < x1:
                ring[(h + nv) % depth] = stage(i + 1 + vmax)
            s = [[d[i][rows[r], kk] for d in disp] for r in range(ry)]
            ky = [weights(1, s[r], diffdir == 1) for r in range(ry)]
            kz = [weights(2, s[r], diffdir == 2) for r in range(ry)]
            if all_:
                kyd = [weights(1, s[r], True) for r in range(ry)]
                kzd = [weights(2, s[r], True) for r in range(ry)]
            acc = [[torch.zeros_like(s[0][0]) for _ in range(nout)]
                   for _ in range(ry)]
            for a in range(nv):
                slot = ring[(h + a) % depth]
                wx = [tgp._axis_weight(win, diffdir == 0, vmin + a, s[r][0])
                      for r in range(ry)]
                wxd = [tgp._axis_weight(win, True, vmin + a, s[r][0])
                       for r in range(ry)] if all_ else None
                for t in range(ry + nv - 1):
                    rr = [r for r in range(ry) if 0 <= t - r < nv]
                    wxy = {r: wx[r] * ky[r][t - r] for r in rr}
                    if all_:
                        wdy = {r: wxd[r] * ky[r][t - r] for r in rr}
                        wyd = {r: wx[r] * kyd[r][t - r] for r in rr}
                    for c in range(nv):
                        v = [_window_cells(m, lrow + t, lcol + c)
                             for m in slot]
                        for r in rr:
                            if all_:
                                acc[r][0] = acc[r][0] + (wdy[r] * kz[r][c]) * v[0]
                                acc[r][1] = acc[r][1] + (wyd[r] * kz[r][c]) * v[0]
                                acc[r][2] = acc[r][2] + (wxy[r] * kzd[r][c]) * v[0]
                            else:
                                w = wxy[r] * kz[r][c]
                                acc[r] = [o + w * x for o, x in zip(acc[r], v)]
            for r in range(ry):
                for out, a_ in zip(outs, acc[r]):
                    out[i][rows[r][live[r]], kk[live[r]]] = a_[live[r]]
    return tuple(outs)


def emulate_paint64(disp, mass, vmin, vmax, window, diffdir=None,
                    rows=None, xbase=None):
    """paint64: per block, source planes from x1 - 1 - vmin down to x0 -
    vmax; for each, the table of 3 nv axis weights (and the mass) of the
    region (TY + nv - 1) x width64 from (j0 - vmax, k0 - vmax); per thread
    RY rows of RZ consecutive z cells from (j, k) and nv accumulator
    planes each; the window's rows t from nv + RY - 2 down, its cells e
    (z = k - vmax + e) from RZ + nv - 2 down, each cell's x weights, z
    weights and mass read once for every row r it feeds (v_y = vmin + nv
    - 1 + r - t), its (x, y) products once for every output q it feeds
    (v_z = vmin + nv - 1 + q - e)"""
    win = find_window(window)
    nv = vmax - vmin + 1
    n_in, n1, n2 = disp[0].shape
    n0 = n_in if xbase is None else rows
    shape = (n0, n1, n2)
    mesh_mass = isinstance(mass, torch.Tensor)
    scalar = 1.0 if mass is None or mesh_mass else float(mass)
    p = gc.plan('paint', shape, nv, mass=mesh_mass, dtype=F64)
    ry, rz, trows, j, k, (gz, gy, gx) = _tile_threads(p, shape)
    ty, tz = p['tile']
    xc = p['xc']
    ys = _block_region(gy, ty, -vmax, n1, ty + nv - 1)
    zs = _block_region(gz, tz, -vmax, n2, -(-(tz + nv - 1) // rz) * rz)
    lrow = torch.arange(trows)[:, None] * ry
    lcol = torch.arange(gc.TILE_Z64)[None, :] * rz
    orows = [j + r for r in range(ry)]
    ocols = [k + q for q in range(rz)]
    live = [[(jr < n1) & (kq < n2) for kq in ocols] for jr in orows]
    out = torch.full(shape, float('nan'), dtype=F64)
    zero = torch.zeros(j.shape, dtype=F64)
    for bx in range(gx):
        x0 = bx * xc
        x1 = min(x0 + xc, n0)
        acc = [[[zero] * nv for _ in range(rz)] for _ in range(ry)]
        for s in range(x1 - 1 - vmin, x0 - vmax - 1, -1):
            x = _plane(s, n_in, xbase)
            idx = (ys[:, None, :, None], zs[None, :, None, :])
            src = [d[x][idx] for d in disp]
            tab = [[tgp._axis_weight(win, diffdir == d, vmin + a, src[d])
                    for a in range(nv)] for d in range(3)]
            m = mass[x][idx] if mesh_mass else None
            for t in range(nv + ry - 2, -1, -1):
                for e in range(rz + nv - 2, -1, -1):
                    cell = (lrow + t, lcol + e)
                    mc = _window_cells(m, *cell) if mesh_mass else None
                    wx = [_window_cells(tab[0][a], *cell) for a in range(nv)]
                    for r in range(ry):
                        b = nv - 1 + r - t
                        if not 0 <= b < nv:
                            continue
                        wy = _window_cells(tab[1][b], *cell)
                        wxy = [w * wy for w in wx]
                        for q in range(rz):
                            c = nv - 1 + q - e
                            if not 0 <= c < nv:
                                continue
                            wz = _window_cells(tab[2][c], *cell)
                            for a in range(nv):
                                w = wxy[a] * wz
                                if mesh_mass:
                                    w = w * mc
                                acc[r][q][a] = acc[r][q][a] + w
            o = s + vmax
            for r in range(ry):
                for q in range(rz):
                    lv = live[r][q]
                    if x0 <= o < x1:
                        out[o][orows[r][lv], ocols[q][lv]] = \
                            (acc[r][q][nv - 1] * scalar)[lv]
                    acc[r][q] = [zero] + acc[r][q][:-1]
    return out


def _inputs64(seed, shape, bounds):
    rng = np.random.RandomState(seed)
    disp = tuple(torch.from_numpy(rng.uniform(bounds[0], bounds[1], shape))
                 for _ in range(3))
    mass = torch.from_numpy(1 + 0.2 * rng.normal(size=shape))
    meshes = tuple(torch.from_numpy(rng.normal(size=shape)) for _ in range(3))
    return disp, mass, meshes


# CIC bounds of nv 2, 3, 5, 6 (an even width of the paint's z blocks:
# their rows end in a rounding cell) and 7 (the last two of the f32
# kernels' run-time widths); a shape no f64 tile divides
BOUNDS64 = {2: (0.0, 1.0), 3: (-1.0, 1.0), 5: (-2.0, 2.0), 6: (-1.5, 2.5),
            7: (-3.0, 3.0)}
RAGGED = (37, 45, 51)


@pytest.mark.parametrize("nv", sorted(BOUNDS64))
@pytest.mark.parametrize("op", ['paint', 'readout'])
def test_emulated_f64_blocks_are_the_roll_loop(nv, op):
    """the f64 kernels' index maps, emulated in plain torch on f64 inputs,
    bitwise the plain roll loop: the same f64 terms in the same order"""
    bounds = BOUNDS64[nv]
    vmin, vmax = tgp.offset_range(*bounds, 'cic')
    assert vmax - vmin + 1 == nv
    disp, mass, meshes = _inputs64(30 + nv, RAGGED, bounds)
    if op == 'paint':
        for diffdir, m in ((None, None), (None, mass), (1, None)):
            ref = tgp._shift_loop(None, disp, m, bounds, 'cic', diffdir,
                                  'paint', impl='torch')
            got = emulate_paint64(disp, m, vmin, vmax, 'cic', diffdir)
            assert torch.equal(got, ref), (diffdir, m is None)
        return
    cases = ((None, 3), ('all', 1), (2, 1)) if nv <= 5 else ((None, 3),)
    for diffdir, nm in cases:
        ref = tgp._shift_loop(meshes[:nm], disp, None, bounds, 'cic',
                              diffdir, 'readout', impl='torch')
        got = emulate_readout64(meshes[:nm], disp, vmin, vmax, 'cic',
                                diffdir)
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            assert torch.equal(g, r), (diffdir, nm)


@pytest.mark.parametrize("nv", [3, 5])
def test_emulated_f64_blocks_xhalo(nv):
    """the x-halo slab form of the f64 kernels: input plane p + xbase, no
    wrap on x, on a ragged slab"""
    bounds, rows = BOUNDS64[nv], 11
    vmin, vmax = tgp.offset_range(*bounds, 'cic')
    lo, hi = max(0, vmax), max(0, -vmin)
    disp, mass, meshes = _inputs64(50 + nv, (lo + rows + hi,) + RAGGED[1:],
                                   bounds)
    for m in (None, mass):
        ref = tgp.paint_slab_plain(disp, m, lo, rows, bounds, 'cic')
        got = emulate_paint64(disp, m, vmin, vmax, 'cic', rows=rows,
                              xbase=lo)
        assert torch.equal(got, ref)
    lo = max(0, -vmin)
    rdisp = tuple(d[lo:lo + rows].contiguous() for d in disp)
    for diffdir, nm in ((None, 3), ('all', 1)):
        ref = tgp.readout_slab_plain(meshes[:nm], rdisp, lo, bounds, 'cic',
                                     diffdir)
        got = emulate_readout64(meshes[:nm], rdisp, vmin, vmax, 'cic',
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
