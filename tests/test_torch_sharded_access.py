"""The field API's global item access, reshaping and untransposed layout
(ROADMAP item 8d) on every sharded route, against the JAX package's
sharded answers.

The port runs as gloo ranks on the CPU (``parallel/launch.spawn``, the
cases of ``tests/torch_sharded_access_cases.py``): a 4-rank job on the
slab and on the (2, 2) pencil grid built over its ranks (16^3), a 5-rank
job on padded uneven slabs (18^3: 4, 4, 4, 4, 2 rows) and a 3-rank job
on the replicated route (16^3, whose slabs cannot reach across the dead
seam), all in f8, started in threads while the JAX package computes on
``ProcessMesh(jax.devices()[:P])`` (``shape=(2, 2)`` for the pencils) on
the virtual devices of ``tests/conftest.py``.  The ranks' blocks,
assembled, are held against the JAX package's global arrays:

- bitwise: ``start``/``slices`` (each rank's value is the global
  field's ``[slices]``), ``ravel`` (the blocks in rank order) and
  ``unravel``, ``mesh_coordinates``, ``ctranspose``, the real field's
  ``csetitem``, and ``cgetitem`` of the spectrum against the port's own
  assembled spectrum; ``csetitem`` returns JAX's values and writes a
  whole value at the index and its dual as JAX does, bitwise;
- 1e-12 of max: the spectrum and its ravel, ``cgetitem`` and the field
  after ``csetitem`` against JAX's, ``resample`` up and down (into real
  and complex fields, from the real field's spectrum: the JAX package's
  real-field resample reads the wrong modes, ROADMAP queue 3),
  ``preview`` (with and without resampling) and the untransposed
  layout's ``r2c(out=U)``, ``c2r``, casts and coordinates.

Also the port's counterparts of ``tests/test_parallel.py:153-180`` and
``:233-267``, and gradients through ``resample`` and ``ravel`` against
the port's one-device gradients (1e-12), with a ``grad_fn`` from every
differentiable method of the item.
"""
import concurrent.futures
import functools

import jax
import numpy as np
import pytest
import torch

from pmesh_tpu import ParticleMesh as JaxPM
from pmesh_tpu.parallel.pmesh import ProcessMesh as JaxProcessMesh
from pmesh_tpu_torch.parallel import launch
from pmesh_tpu_torch.parallel.pmesh import ProcessMesh
from torch_sharded_access_cases import CASES, run_cases

torch.set_num_threads(1)

TOL = 1e-12
UP, DOWN = 24, 8
# geometry: (ranks, grid shape, Nmesh, route)
GEOMETRIES = {'slab': (4, None, 16, 'slab'),
              'pencil': (4, (2, 2), 16, 'pencil'),
              'uneven': (5, None, 18, 'slab'),
              'replicated': (3, None, 16, 'replicated')}


@functools.lru_cache(maxsize=None)
def _inputs(n):
    r = np.random.RandomState(n)
    x = r.normal(size=(n,) * 3)
    index = [(1, 2, 3), (0, 0, 0), (3, n - 1, n // 2), (5, 4, n - 2),
             (n // 2, 0, n // 2), (2, 3, 1, 0), (2, 3, 1, 1), (-1, -2, 3),
             (n // 2, n // 2, 0), (7, 1, n // 2 + 2)]
    index += [tuple(int(i) for i in r.randint(0, n, 3)) for _ in range(6)]
    sets = [((1, 2, 3), 0.5 + 0.25j), ((n - 1, n - 2, n - 3), 1.5 - 2j),
            ((0, 0, 0), 3.0), ((2, 5, 4, 1), 0.75), ((3, 1, 2, 0), -0.5),
            ((n // 2, 0, n // 2), 1 + 1j), ((0, n // 2, 0, 1), 2.0)]
    return x, index, sets


def _grad_inputs(n):
    r = np.random.RandomState(n + 1)
    return r.normal(size=(DOWN,) * 3), r.normal(size=n ** 3)


def _cases(geo):
    _, shape, n, _ = GEOMETRIES[geo]
    x, index, sets = _inputs(n)
    return [('access', shape, (n, x, index, sets, UP, DOWN)),
            ('grads', shape, (n, x) + _grad_inputs(n) + (DOWN,))]


@pytest.fixture(scope='module')
def port():
    """{geometry: [per-case list of rank results]} from three gloo jobs
    started in threads"""
    pool = concurrent.futures.ThreadPoolExecutor(3)
    jobs = {4: ['slab', 'pencil'], 5: ['uneven'], 3: ['replicated']}
    futs = {world: pool.submit(launch.spawn, CASES + ':run_cases', world,
                               'gloo', 'cpu',
                               sum((_cases(g) for g in geos), []))
            for world, geos in jobs.items()}
    pool.shutdown(wait=False)
    out = {}
    for world, geos in jobs.items():
        ranks = futs[world].result()
        for i, geo in enumerate(geos):
            out[geo] = [[r[2 * i + j] for r in ranks] for j in range(2)]
    return out


@functools.lru_cache(maxsize=None)
def one(n):
    """the port's one-device answers (a one-rank ProcessMesh)"""
    x, index, sets = _inputs(n)
    return run_cases(ProcessMesh(device='cpu'),
                     [('access', None, (n, x, index, sets, UP, DOWN)),
                      ('grads', None, (n, x) + _grad_inputs(n)
                       + (DOWN,))])


@functools.lru_cache(maxsize=None)
def jax_side(geo):
    """the JAX package's sharded answers on ``geo``"""
    world, shape, n, _ = GEOMETRIES[geo]
    mesh = JaxProcessMesh(jax.devices()[:world], shape=shape)

    def jpm(m):
        return JaxPM(Nmesh=[m] * 3, BoxSize=float(m), dtype='f8',
                     procmesh=mesh)
    x, index, sets = _inputs(n)
    pm = jpm(n)
    r = pm.create(type='real', value=x)
    c = r.r2c()
    out = dict(real=np.asarray(r.value), complex=np.asarray(c.value),
               ravel=np.asarray(r.ravel()), cravel=np.asarray(c.ravel()),
               coords=np.asarray(pm.mesh_coordinates()),
               cget=[c.cgetitem(i) for i in index])
    s = c.copy()
    out['cset_ret'] = [s.csetitem(i, y) for i, y in sets]
    out['cset'] = np.asarray(s.value)
    rs = r.copy()
    out['rset_ret'] = rs.csetitem([1, 2, 3], 7.5)
    out['rset'] = np.asarray(rs.value)
    out['ctranspose'] = np.asarray(r.ctranspose((2, 0, 1)).value)
    for name, m in (('up', UP), ('down', DOWN)):
        o = jpm(m).create(type='real')
        c.resample(o)
        out['resample_' + name] = np.asarray(o.value)
        oc = jpm(m).create(type='complex')
        c.resample(oc)
        out['resample_c_' + name] = np.asarray(oc.value)
    out['preview'] = np.asarray(r.preview(axes=(0, 1)))
    out['preview_c'] = np.asarray(c.preview(axes=(2,)))
    out['preview_down'] = np.asarray(r.preview(Nmesh=DOWN, axes=(1, 0)))
    out['preview_up'] = np.asarray(r.preview(Nmesh=UP, axes=(0,)))
    u = r.r2c(out=pm.create(type='untransposedcomplex'))
    out['U'] = np.asarray(u.value)
    out['U_c2r'] = np.asarray(u.c2r().value)
    out['U_k2'] = np.asarray(u.apply(lambda k, v: v * k.normp(2)).value)
    out['U_cnorm'] = float(u.cnorm())
    return out


def _assemble(blocks, key):
    """the global array from the ranks' blocks of ``key``"""
    at = blocks[0][key]['at']
    shape = tuple(hi for _, hi in at)
    for b in blocks:
        shape = tuple(max(s, hi) for s, (_, hi) in zip(shape, b[key]['at']))
    out = np.full(shape, np.nan, dtype=blocks[0][key]['value'].dtype)
    for b in blocks:
        out[tuple(slice(lo, hi) for lo, hi in b[key]['at'])] = \
            b[key]['value']
    return out


def _flat(blocks, key):
    """the ranks' blocks of a flat array in rank order (one rank's whole
    array where every rank holds it)"""
    if not blocks[0]['blocked']:
        return blocks[0][key]
    return np.concatenate([b[key] for b in blocks])


def _rel(ref, got):
    ref, got = np.asarray(ref), np.asarray(got)
    assert ref.shape == got.shape, (ref.shape, got.shape)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


GEOS = list(GEOMETRIES)


@pytest.mark.parametrize("geo", GEOS)
def test_routes_and_blocks(port, geo):
    """each rank's start and slices are its block in global indices, and
    its value the global field's [slices], bitwise"""
    world, _, n, route = GEOMETRIES[geo]
    blocks = port[geo][0]
    x = _inputs(n)[0]
    assert len(blocks) == world
    for b in blocks:
        assert b['route'] == route
        sl = tuple(slice(lo, hi) for lo, hi in b['slices'])
        assert tuple(b['start']) == tuple(lo for lo, _ in b['slices'])
        assert tuple(b['real']['at']) == tuple(b['slices'])
        assert np.array_equal(b['real']['value'], x[sl])
    np.testing.assert_array_equal(_assemble(blocks, 'real'), x)
    np.testing.assert_array_equal(_assemble(blocks, 'real'),
                                  jax_side(geo)['real'])
    assert _rel(jax_side(geo)['complex'],
                _assemble(blocks, 'complex')) <= TOL


@pytest.mark.parametrize("geo", GEOS)
def test_ravel_unravel_and_mesh_coordinates(port, geo):
    """the ravel blocks in rank order are JAX's ravel bitwise; unravel
    inverts it on every rank; the rows of mesh_coordinates pair with
    ravel's; ravel's out contract (test_parallel.py:258-267)"""
    blocks = port[geo][0]
    j = jax_side(geo)
    np.testing.assert_array_equal(_flat(blocks, 'ravel'), j['ravel'])
    np.testing.assert_array_equal(
        _flat(blocks, 'cravel'), _assemble(blocks, 'complex').ravel())
    assert _rel(j['cravel'], _flat(blocks, 'cravel')) <= TOL
    coords = np.concatenate([b['coords'] for b in blocks])
    np.testing.assert_array_equal(coords, j['coords'])
    np.testing.assert_array_equal(
        np.concatenate([b['coords_i4'] for b in blocks]),
        j['coords'].astype('i4'))
    for b in blocks:
        assert b['unravel_equal'] and b['cunravel_equal']
        assert b['ravel_inplace_equal'] and b['ravel_out_refused']
        if b['blocked']:
            assert len(b['coords']) == len(b['ravel'])


@pytest.mark.parametrize("geo", GEOS)
def test_item_access(port, geo):
    """cgetitem returns the same value on every rank: the port's own
    spectrum at the index bitwise (its dual's conjugate where only that
    is stored), JAX's within 1e-12; csetitem returns JAX's values and
    writes the index and its dual as JAX does"""
    blocks = port[geo][0]
    j = jax_side(geo)
    n = GEOMETRIES[geo][2]
    spec = _assemble(blocks, 'complex')
    scale = np.abs(j['complex']).max()
    for b in blocks:
        np.testing.assert_array_equal(np.array(b['cget']),
                                      np.array(blocks[0]['cget']))
        np.testing.assert_array_equal(np.array(b['cset_ret']),
                                      np.array(j['cset_ret']))
        np.testing.assert_array_equal(np.array(b['cset_get']),
                                      np.array(blocks[0]['cset_get']))
        assert b['rset_ret'] == j['rset_ret']
    assert np.abs(np.array(blocks[0]['cget'])
                  - np.array(j['cget'])).max() <= TOL * scale
    for (i, want) in zip(_inputs(n)[1], blocks[0]['cget']):
        ind = [k % n for k in i[:3]]
        if ind[2] >= spec.shape[2]:
            v = np.conj(spec[tuple((n - k) % n for k in ind)])
        else:
            v = spec[tuple(ind)]
        if len(i) == 4:
            v = v.imag if i[3] == 1 else v.real
        assert v == want, (i, v, want)
    got = _assemble(blocks, 'cset')
    assert _rel(j['cset'], got) <= TOL
    # a whole value set is written as JAX writes it, at the index and
    # its dual, bitwise
    for i, _ in _inputs(n)[2]:
        if len(i) == 3:
            for at in (tuple(i), tuple((n - k) % n for k in i)):
                if at[2] < got.shape[2]:
                    assert got[at] == j['cset'][at], (i, at)
    np.testing.assert_array_equal(_assemble(blocks, 'rset'), j['rset'])


@pytest.mark.parametrize("geo", GEOS)
def test_ctranspose(port, geo):
    blocks = port[geo][0]
    np.testing.assert_array_equal(_assemble(blocks, 'ctranspose'),
                                  jax_side(geo)['ctranspose'])


@pytest.mark.parametrize("geo", GEOS)
@pytest.mark.parametrize("key", ['resample_up', 'resample_down',
                                 'resample_c_up', 'resample_c_down'])
def test_resample(port, geo, key):
    """resample of the spectrum into real and complex fields of 24^3 and
    8^3 meshes on the same process mesh (which may take another route)"""
    got = _assemble(port[geo][0], key)
    assert _rel(jax_side(geo)[key], got) <= TOL


@pytest.mark.parametrize("geo", GEOS)
def test_preview(port, geo):
    """the same array on every rank, JAX's within 1e-12"""
    blocks = port[geo][0]
    j = jax_side(geo)
    for key in ('preview', 'preview_c', 'preview_down', 'preview_up'):
        for b in blocks:
            np.testing.assert_array_equal(b[key], blocks[0][key])
        assert _rel(j[key], blocks[0][key]) <= TOL, key


@pytest.mark.parametrize("geo", GEOS)
def test_untransposed_layout(port, geo):
    """r2c(out=U) fills the given field in the real field's blocks; c2r,
    the casts both ways and the U coordinates agree with JAX; out= of
    another type takes that type's layout (test_parallel.py:233-256)"""
    blocks = port[geo][0]
    j = jax_side(geo)
    for b in blocks:
        assert b['U_is_out']
        at = b['U']['at']
        if b['blocked']:
            assert tuple(at[0]) == tuple(b['real']['at'][0])
            assert tuple(b['T_out']['at']) == tuple(b['complex']['at'])
        assert tuple(b['R_out']['at']) == tuple(b['real']['at'])
        assert tuple(b['U_from_T']['at']) == tuple(at)
        assert abs(float(b['U_cnorm']) - j['U_cnorm']) <= TOL * j['U_cnorm']
    for key in ('U', 'U_from_T', 'U_from_real'):
        assert _rel(j['U'], _assemble(blocks, key)) <= TOL, key
    np.testing.assert_array_equal(_assemble(blocks, 'T_from_U'),
                                  _assemble(blocks, 'complex'))
    np.testing.assert_array_equal(_assemble(blocks, 'U_from_T'),
                                  _assemble(blocks, 'U'))
    assert _rel(j['complex'], _assemble(blocks, 'T_out')) <= TOL
    assert _rel(j['U_c2r'], _assemble(blocks, 'U_c2r')) <= TOL
    assert _rel(j['U_c2r'], _assemble(blocks, 'R_out')) <= TOL
    assert _rel(j['U_k2'], _assemble(blocks, 'U_k2')) <= TOL


@pytest.mark.parametrize("geo", GEOS)
def test_sharded_matches_one_device(port, geo):
    """the counterpart of test_parallel.py:153-180: resample, ravel and
    preview on the sharded field against the port's one device"""
    blocks = port[geo][0]
    ref = one(GEOMETRIES[geo][2])[0]
    np.testing.assert_array_equal(_flat(blocks, 'ravel'), ref['ravel'])
    for key in ('resample_down', 'resample_up'):
        assert _rel(ref[key]['value'], _assemble(blocks, key)) <= TOL
    assert _rel(ref['preview'], blocks[0]['preview']) <= TOL


@pytest.mark.parametrize("geo", GEOS)
def test_gradients(port, geo):
    """d/dx of a loss through resample and through ravel, assembled,
    against the one-device port's gradient; every differentiable method
    carries a grad_fn"""
    got = port[geo][1]
    ref = one(GEOMETRIES[geo][2])[1]
    for key in ('resample', 'ravel'):
        if got[0]['blocked']:
            g = np.full(ref[key].shape, np.nan)
            for b in got:
                g[tuple(slice(lo, hi) for lo, hi in b['at'])] = b[key]
        else:
            g = got[0][key]
            for b in got:
                np.testing.assert_array_equal(b[key], g)
        assert _rel(ref[key], g) <= TOL, key
    assert all(list(b['bad']) == [] for b in got), [b['bad'] for b in got]
    assert list(ref['bad']) == []
