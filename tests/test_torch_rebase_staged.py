"""The staged rebase assign's design on the CPU (csrc/binned.cu runs only
on the card): the launch planner of ops/binned_cuda.py against the
kernel's constants and shared-memory layout, for every slot count,
output slot count and offset range the wrapper accepts, and a
plain-torch emulation of the kernel (each source slot-cell classified
once into a code, a ring of nr + 1 classified planes of the tile plus
its halo walked plane by plane, every target's images tested on the
ring in the plain order, the hits' route codes ranked per thread and
each output slot written once) held ``torch.equal`` to the plain
version (``ops/binned.rebase_assign_plain``), and once to the JAX
package's ``rebase(impl='xla')``.
"""
import os
import re

import numpy as np
import pytest
import torch

from pmesh_tpu_torch.ops import binned as tbn
from pmesh_tpu_torch.ops import binned_cuda as bc
from pmesh_tpu_torch.ops import gridpm_cuda as gc

torch.set_num_threads(1)

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "pmesh_tpu_torch", "csrc", "binned.cu")
SHAPES = [(512, 512, 512), (384, 384, 384), (64, 512, 512), (7, 37, 45),
          (2, 3, 4), (1, 1, 1)]


def _source():
    with open(SRC) as f:
        return f.read()


def test_planner_constants_are_the_kernels():
    """the tile, the widest offset range and the compiled widths of the C
    source are the planner's"""
    src = _source()
    m = re.search(r"constexpr int TZ = (\d+), kAssignThreads = (\d+), TY = "
                  r"kAssignThreads / TZ;", src)
    tz, threads = (int(x) for x in m.groups())
    assert (tz, threads) == (bc.TILE_Z, bc.THREADS)
    assert bc.TILE_Y == threads // tz
    assert re.search(r"NR_MAX = %d;" % bc.NR_MAX, src)
    widths = tuple(int(x) for x in re.findall(r"\bASSIGN_NR\((\d+)\)", src))
    assert widths == bc.NR_COMPILED
    assert re.search(r"constexpr int kMaxSlots = %d;" % bc.MAX_SLOTS, src)
    # the widest range: one slot of nr^3 offsets in the int16 codes
    assert bc.NR_MAX ** 3 <= bc.ROUTE_MAX < (bc.NR_MAX + 1) ** 3
    assert re.search(r"smem > %d\)" % bc.SMEM_LIMIT, src)
    assert bc.SMEM_LIMIT == gc.SMEM_LIMIT


def _layout_bytes(nr, group, Kout, stage_d):
    """the dynamic shared bytes the kernel indexes: [dring[group][nr +
    1][3][area] f32 (stage_d)][raw[group][4][area] f32][hits[Kout]
    [THREADS] int16][ring[group][nr + 1][area] codes], area the cells of
    the tile plus its nr - 1 halo, a code a byte where nr^3 < 255"""
    area = (bc.TILE_Y + nr - 1) * (bc.TILE_Z + nr - 1)
    code = 1 if nr ** 3 < 255 else 2
    return ((group * (nr + 1) * 3 * area * 4 if stage_d else 0)
            + group * 4 * area * 4 + Kout * bc.THREADS * 2
            + group * (nr + 1) * area * code)


def _accepted():
    """every (K, nr) the wrapper accepts: K nr^3 route codes in int16"""
    return [(K, nr) for K in range(1, bc.MAX_SLOTS + 1)
            for nr in range(1, bc.NR_MAX + 1)
            if K * nr ** 3 <= bc.ROUTE_MAX]


@pytest.mark.parametrize("shape", SHAPES)
def test_plan_fits_covers_and_matches_the_kernels_layout(shape):
    n0, n1, n2 = shape
    TY, TZ = bc.TILE_Y, bc.TILE_Z
    for K, nr in _accepted():
        for Kout in (1, K, bc.MAX_SLOTS):
            for olo in (-(nr // 2), 0):
                for xhalo in (False, True):
                    p = bc.plan(shape, K, Kout, olo, olo + nr - 1, xhalo)
                    assert 0 < p['smem'] <= bc.SMEM_LIMIT, (K, nr, p)
                    assert p['smem'] == _layout_bytes(
                        nr, p['group'], Kout, p['stage_d'])
                    assert p['tile'] == (TY, TZ) and p['depth'] == nr + 1
                    assert p['width'] == (nr if nr in bc.NR_COMPILED
                                          else None)
                    # every slot's ring wherever it fits; the displacements
                    # staged only then
                    assert 1 <= p['group'] <= K
                    fits = _layout_bytes(nr, K, Kout, False) <= bc.SMEM_LIMIT
                    assert (p['group'] == K) == fits
                    if p['group'] < K:
                        assert _layout_bytes(nr, p['group'] + 1, Kout,
                                             False) > bc.SMEM_LIMIT
                    assert not p['stage_d'] or p['group'] == K
                    # every target has exactly one block: none is empty
                    gz, gy, gx = p['grid']
                    assert gz * TZ >= n2 > (gz - 1) * TZ
                    assert gy * TY >= n1 > (gy - 1) * TY
                    assert gx * p['xc'] >= n0 > (gx - 1) * p['xc']
                    assert 1 <= p['xc'] <= min(n0, gc.XC_MAX)
                    assert max(gx, gy) <= 65535 and p['xhalo'] == xhalo
    with pytest.raises(ValueError):
        bc.plan(shape, 2, 2, -16, 16)
    with pytest.raises(ValueError):
        bc.plan(shape, bc.MAX_SLOTS + 1, 2, -1, 1)


def test_plan_fills_the_card_and_stages_the_main_paths():
    """the main paths' launches have four blocks per SM, x chunks long
    against the halo, and every slot's ring with its staged
    displacements, two blocks to an SM or more"""
    for shape, K, Kout in (((512,) * 3, 2, 2), ((384,) * 3, 4, 4),
                           ((64, 512, 512), 2, 2), ((512,) * 3, 2, 3)):
        nr = 3 if Kout != 3 else 4
        p = bc.plan(shape, K, Kout, -1, nr - 2)
        assert np.prod(p['grid']) >= gc.MIN_BLOCKS
        assert p['xc'] >= 8 * nr and p['group'] == K
        assert p['width'] == nr and p['code_bytes'] == 1
        assert p['stage_d']
        assert 2 * p['smem'] <= bc.SMEM_LIMIT


# --- a plain-torch emulation of the kernel ---------------------------------


def _wrap(a, n):
    return a % n


def _emulate(dslots, valid, Kout, olo, ohi, rows=None, xbase=None,
             stage_d=None):
    """csrc/binned.cu's assign_staged, block by block, on CPU tensors.
    Returns the plain version's (new_dslots, new_valid, routes,
    overflow)."""
    K = len(dslots)
    n_in, n1, n2 = dslots[0][0].shape
    n0 = n_in if xbase is None else rows
    p = bc.plan((n0, n1, n2), K, Kout, olo, ohi, xbase is not None)
    if stage_d is not None:
        p['stage_d'] = stage_d and p['group'] == K
    nr, depth, G, xc = ohi - olo + 1, p['depth'], p['group'], p['xc']
    TY, TZ = p['tile']
    szw, ah = TZ + nr - 1, TY + nr - 1
    none = (1 << (8 * p['code_bytes'])) - 1
    noff = nr ** 3

    def src_x(x, ox):
        return (x - ox) % n0 if xbase is None else x + xbase - ox

    # each source slot-cell classified once: its offset index, or none
    codes = []
    for k in range(K):
        f = [torch.floor(d) for d in dslots[k]]
        inside = valid[k] > 0
        for d in f:
            inside = inside & (d >= olo) & (d <= ohi)
        idx = torch.zeros(f[0].shape, dtype=torch.int64)
        for d in f:
            idx = idx * nr + (torch.where(inside, d, float(olo)).long()
                              - olo)
        codes.append(torch.where(inside, idx, torch.full_like(idx, none)))
    shape = (n0, n1, n2)
    nd = [[torch.full(shape, float('nan')) for _ in range(3)]
          for _ in range(Kout)]
    nv = [torch.full(shape, float('nan')) for _ in range(Kout)]
    rt = [torch.full(shape, -7, dtype=tbn.ROUTE_DTYPE) for _ in range(Kout)]
    writes = torch.zeros(shape, dtype=torch.int32)
    over = 0
    ty = torch.arange(TY)[:, None].expand(TY, TZ)
    tz = torch.arange(TZ)[None, :].expand(TY, TZ)
    gz, gy, gx = p['grid']
    for bz in range(gx):
        for by in range(gy):
            for bx in range(gz):
                y0, z0 = by * TY, bx * TZ
                x0, x1 = bz * xc, min(bz * xc + xc, n0)
                y, z = y0 + ty, z0 + tz
                live = (y < n1) & (z < n2)
                e = torch.arange(ah * szw)
                off = (_wrap(y0 - ohi + e // szw, n1) * n2
                       + _wrap(z0 - ohi + e % szw, n2))
                ring = torch.full((G, depth, ah * szw), -1,
                                  dtype=torch.int64)
                dring = torch.zeros((G, depth, 3, ah * szw))

                def stage(i, pl, k0, nk):
                    plane = src_x(i, ohi - pl)
                    slot = (i - x0 + pl) % depth
                    for kk in range(nk):
                        k = k0 + kk
                        ring[kk, slot] = codes[k][plane].reshape(-1)[off]
                        if p['stage_d']:
                            for c in range(3):
                                dring[kk, slot, c] = \
                                    dslots[k][c][plane].reshape(-1)[off]

                ngroups = -(-K // G)
                if ngroups == 1:
                    for pl in range(nr - 1):
                        stage(x0, pl, 0, K)
                for i in range(x0, x1):
                    hits = []      # route codes of this plane's images
                    found = []
                    for g in range(ngroups):
                        k0, nk = g * G, min(G, K - g * G)
                        for pl in range(nr - 1 if ngroups == 1 else 0, nr):
                            stage(i, pl, k0, nk)
                        for kk in range(nk):
                            oi = 0
                            for ia in range(nr):
                                slot = (i - x0 + nr - 1 - ia) % depth
                                for ib in range(nr):
                                    for ic in range(nr):
                                        cell = ((ty + nr - 1 - ib) * szw
                                                + tz + nr - 1 - ic)
                                        found.append(
                                            ring[kk, slot][cell] == oi)
                                        hits.append((k0 + kk) * noff + oi)
                                        oi += 1
                    found = torch.stack(found) & live
                    rank = torch.cumsum(found.long(), 0) - 1
                    running = found.sum(0)
                    over += int((running - Kout).clamp_min(0).sum())
                    codes_t = torch.tensor(hits)
                    ys, zs = y[live], z[live]
                    writes[i, ys, zs] += 1
                    for j in range(Kout):
                        sel = found & (rank == j)
                        has = sel.any(0)
                        code = codes_t[sel.long().argmax(0)]
                        k, oi = code // noff, code % noff
                        ia, ib, ic = oi // (nr * nr), oi // nr % nr, oi % nr
                        o = (olo + ia, olo + ib, olo + ic)
                        if p['stage_d']:
                            slot = (i - x0 + nr - 1 - ia) % depth
                            cell = ((ty + nr - 1 - ib) * szw + tz + nr - 1
                                    - ic)
                            s = [dring[k, slot, c, cell] for c in range(3)]
                        else:
                            sx = src_x(i, o[0])
                            sy, sz = _wrap(y - o[1], n1), _wrap(z - o[2], n2)
                            s = [torch.stack([dslots[kk][c] for kk in
                                              range(K)])[k, sx, sy, sz]
                                 for c in range(3)]
                        for c in range(3):
                            val = torch.where(has, s[c] - o[c].float(),
                                              torch.zeros(()))
                            nd[j][c][i, ys, zs] = val[live]
                        nv[j][i, ys, zs] = has.float()[live]
                        rt[j][i, ys, zs] = torch.where(
                            has, code, -1)[live].to(tbn.ROUTE_DTYPE)
    # every output of every slot written exactly once
    assert bool((writes == 1).all())
    return (tuple(tuple(d) for d in nd), tuple(nv), tuple(rt),
            torch.tensor(over, dtype=torch.int64))


def _state(seed, shape, lo, hi, fill):
    rng = np.random.RandomState(seed)

    def t(a):
        return torch.from_numpy(a.astype('f4'))
    ds = tuple(tuple(t(rng.uniform(lo, hi, shape)) for _ in range(3))
               for _ in fill)
    va = tuple(t((rng.uniform(size=shape) < f) * 1.0) for f in fill)
    return ds, va


def _escape(ds, va, hi):
    """past the bounds, a NaN, a huge value and -inf, all valid: none
    arrives anywhere"""
    for (k, c, i), v in (((0, 0, 0), hi + 1.7), ((-1, 2, -1), float('nan')),
                         ((0, 1, 5), 3e38), ((0, 2, 7), -float('inf'))):
        ds[k][c].view(-1)[i] = v
        va[k].view(-1)[i] = 1.0


def _assert_equal(got, ref):
    if isinstance(ref, (tuple, list)):
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            _assert_equal(g, r)
        return
    assert got.dtype == ref.dtype and got.shape == ref.shape
    nan = torch.isnan(ref) if ref.is_floating_point() else None
    if nan is not None:
        assert torch.equal(torch.isnan(got), nan)
        assert torch.equal(got[~nan].view(torch.int32),
                           ref[~nan].view(torch.int32))
    else:
        assert torch.equal(got, ref)


# name: (shape, drift bounds, fill per input slot, Kout, escapes, x-halo)
EMULATED = {
    'K1_offsets_-1_1': ((16,) * 3, (-0.5, 1.5), (0.9,), 1, False, False),
    'K2_main': ((16,) * 3, (-0.5, 1.5), (1.0, 0.25), 2, False, False),
    'K4_clustered': ((16,) * 3, (-0.5, 1.5), (1.0, 0.5, 0.3, 0.1), 4,
                     False, False),
    'K1_offsets_-2_2': ((16,) * 3, (-1.6, 2.6), (0.8,), 2, False, False),
    'K2_offsets_-2_2': ((16,) * 3, (-1.6, 2.6), (0.5, 0.3), 3, False,
                        False),
    'overflow': ((16,) * 3, (-0.9, 1.9), (0.6, 0.4), 1, False, False),
    'escapes': ((16,) * 3, (-0.5, 1.5), (0.5, 0.2), 3, True, False),
    'tiny_2_3_4': ((2, 3, 4), (-1.6, 2.6), (0.5, 0.3), 4, False, False),
    'xhalo': ((16 + 2, 16, 16), (-0.9, 1.9), (0.7, 0.4), 2, False, True),
}


@pytest.mark.parametrize("case", sorted(EMULATED))
def test_emulated_kernel_is_plain_bitwise(case):
    shape, bounds, fill, kout, escape, xhalo = EMULATED[case]
    ds, va = _state(sorted(EMULATED).index(case), shape, bounds[0],
                    bounds[1], fill)
    offsets = tbn._drift_offsets(bounds, 3)
    olo, ohi = offsets[0][0], offsets[-1][0]
    if escape:
        _escape(ds, va, ohi + 1)
    kw = {}
    if xhalo:
        lo, hi = tbn._halo_depth(offsets)
        kw = dict(rows=shape[0] - lo - hi, xbase=lo)
    ref = tbn.rebase_assign_plain(ds, va, offsets, kout, **kw)
    # the plan's choice, and the other source of a hit's displacement
    for stage_d in (None, not bc.plan(ref[1][0].shape, len(fill), kout, olo,
                                      ohi)['stage_d']):
        got = _emulate(ds, va, kout, olo, ohi, stage_d=stage_d, **kw)
        _assert_equal(got, ref)
    if case == 'overflow':
        assert int(ref[3]) > 0


def test_emulated_slot_groups_are_plain_bitwise(monkeypatch):
    """where every slot's ring does not fit, groups of slots take turns
    on each target plane in the same image order"""
    ds, va = _state(20, (3, 9, 10), -1.6, 2.6, (0.6, 0.5, 0.4, 0.3))
    offsets = tbn._drift_offsets((-1.6, 2.6), 3)
    ref = tbn.rebase_assign_plain(ds, va, offsets, 3)
    # a smaller card: two slots a group
    p = bc.plan((3, 9, 10), 4, 3, -2, 2)
    monkeypatch.setattr(bc, 'SMEM_LIMIT',
                        _layout_bytes(5, 2, 3, False) + 1)
    assert bc.plan((3, 9, 10), 4, 3, -2, 2)['group'] == 2 != p['group']
    _assert_equal(_emulate(ds, va, 3, -2, 2), ref)


def test_emulated_kernel_matches_jax_rebase():
    """the main path's case against the JAX package's rebase(impl='xla')
    on the same numpy inputs, bitwise (no overflow, so no poison)"""
    import jax
    import jax.numpy as jnp
    from pmesh_tpu.ops import binned as jbn
    shape, bounds = (8, 12, 40), (-0.5, 1.5)
    ds, va = _state(30, shape, bounds[0], bounds[1], (1.0, 0.25))
    offsets = tbn._drift_offsets(bounds, 3)
    got = _emulate(ds, va, 7, offsets[0][0], offsets[-1][0])
    ref = jbn.rebase(jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()),
                                            ds),
                     tuple(jnp.asarray(v.numpy()) for v in va), bounds,
                     nslots_out=7, impl='xla')
    assert int(ref[3]) == 0 == int(got[3])
    _assert_equal(got[:2], jax.tree_util.tree_map(
        lambda a: torch.from_numpy(np.array(a)), ref[:2]))
