"""The port's host-built domain API (``pmesh_tpu_torch/parallel/domain.py``:
FakeComm, Layout, GridND) against the JAX package's, one process, f8.

Each test of tests/test_domain.py has its counterpart here, on the same
numpy inputs for both packages: the routing (``indices``, ``ranks``,
``sendcounts``), ``exchange`` and every ``gather`` mode exactly, the
loads, the load balance, the primary regions and ``which_rank``
exactly, and the gradient of exchange -> gather('sum') (torch.autograd
against jax.grad).  A few larger seeded cases hold decompose's routing
and each gather mode on random particles over 2-d and 3-d grids.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pmesh_tpu.parallel import domain as jdomain
from pmesh_tpu_torch.parallel.domain import FakeComm, GridND, Layout

MODES = ['sum', 'mean', 'any', 'all', 'local']


def _comm(size, cls=FakeComm):
    c = cls()
    c.size = size
    return c


def _both(edges, size, **kw):
    return (GridND(edges, comm=_comm(size), **kw),
            jdomain.GridND(edges, comm=_comm(size, jdomain.FakeComm), **kw))


def _same_plan(t, j):
    np.testing.assert_array_equal(t.sendcounts, j.sendcounts)
    np.testing.assert_array_equal(t.indices, j.indices)
    np.testing.assert_array_equal(t.ranks, j.ranks)
    assert (t.sendlength, t.recvlength) == (j.sendlength, j.recvlength)
    np.testing.assert_array_equal(t.get_exchange_cost(),
                                  j.get_exchange_cost())


def _gathers_match(t, j, data):
    """every gather mode and two ufuncs of ``data`` (numpy), exactly"""
    td, jd = torch.from_numpy(data), jnp.asarray(data)
    for mode in MODES + [np.add, np.maximum]:
        np.testing.assert_array_equal(np.asarray(t.gather(td, mode)),
                                      np.asarray(j.gather(jd, mode)),
                                      err_msg=str(mode))


# --- the trivial single-domain plan ------------------------------------------

def test_layout_trivial_exchange():
    layout = Layout(npart=5, smoothing=1.0)
    x = torch.arange(5.0)
    assert layout.exchange(x) is x
    a, b = layout.exchange(x, 2 * x)
    assert a is x and b is not None
    assert layout.exchange() is None
    assert layout.exchange_scalar(3.0) == 3.0
    assert layout.sendlength == 5 and layout.recvlength == 5
    assert layout.trivial and layout.smoothing == 1.0


@pytest.mark.parametrize("mode", MODES)
def test_layout_trivial_gather_modes(mode):
    layout = Layout(npart=4)
    x = torch.tensor([1.0, 2.0, 3.0, 4.0])
    assert layout.gather(x, mode=mode) is x


def test_layout_trivial_ufunc_and_invalid():
    layout = Layout(npart=3)
    x = torch.ones(3)
    assert layout.gather(x, mode=np.add) is x
    with pytest.raises(NotImplementedError):
        layout.gather(x, mode='frobnicate')


def test_fake_comm():
    c, j = FakeComm(), jdomain.FakeComm()
    assert (c.rank, c.size) == (j.rank, j.size) == (0, 1)
    assert c.allreduce(3) == 3 and c.allgather(4) == [4]
    assert c.bcast(5) == 5 and c.Allreduce(6) == 6
    c.barrier()
    c.Barrier()


# --- the exact decomposition -------------------------------------------------

def test_exchange_placement():
    """2x1 domains, 4 particles, smoothing 0: each domain receives its
    own particles, in source order"""
    t, j = _both([[0, 1, 2], [0, 2]], 2, periodic=True)
    pos = np.array(list(np.ndindex((2, 2))), dtype='f8')
    mass = np.array([0.0, 1, 2, 3])
    lt, lj = t.decompose(pos, smoothing=0), j.decompose(pos, smoothing=0)
    _same_plan(lt, lj)
    np.testing.assert_array_equal(lt.sendcounts, [2, 2])
    npos = lt.exchange(torch.from_numpy(pos)).numpy()
    np.testing.assert_array_equal(npos, np.asarray(lj.exchange(pos)))
    np.testing.assert_array_equal(npos[:2], [[0, 0], [0, 1]])
    np.testing.assert_array_equal(npos[2:], [[1, 0], [1, 1]])
    nmass = lt.exchange(torch.from_numpy(mass))
    np.testing.assert_array_equal(nmass.numpy(), [0, 1, 2, 3])
    np.testing.assert_array_equal(lt.gather(nmass, 'sum').numpy(), mass)


def test_exchange_smoothing_ghosts():
    """boundary particles ghost into every intersecting domain;
    gather('sum') counts each image, mean/any recover the value"""
    t, j = _both([[0, 1, 2], [0, 2]], 2, periodic=True)
    pos = np.array(list(np.ndindex((2, 2))), dtype='f8')
    mass = np.array([1.0, 2, 3, 4])
    lt, lj = t.decompose(pos, smoothing=0.6), j.decompose(pos,
                                                          smoothing=0.6)
    _same_plan(lt, lj)
    assert lt.recvlength == 8
    nmass = lt.exchange(torch.from_numpy(mass))
    np.testing.assert_array_equal(lt.gather(nmass, 'sum').numpy(), 2 * mass)
    np.testing.assert_array_equal(lt.gather(nmass, 'mean').numpy(), mass)
    np.testing.assert_array_equal(lt.gather(nmass, 'any').numpy(), mass)
    assert lt.gather(nmass, 'all').shape == (8,)
    _gathers_match(lt, lj, np.arange(8.0) + 1)


def test_exchange_periodic_wrap_ghost():
    """a particle near the box edge ghosts into the wrapped domain"""
    t, j = _both([[0, 4, 8], [0, 8]], 2, periodic=True)
    pos = np.array([[7.9, 1.0]])
    lt = t.decompose(pos, smoothing=0.5)
    _same_plan(lt, j.decompose(pos, smoothing=0.5))
    np.testing.assert_array_equal(lt.sendcounts, [1, 1])


def test_exchange_rank_dedup():
    """two domains of one rank receive one copy"""
    t, j = _both([[0, 1, 2], [0, 2]], 1, periodic=True)
    pos = np.array([[0.95, 1.0]])
    lt = t.decompose(pos, smoothing=0.2)
    _same_plan(lt, j.decompose(pos, smoothing=0.2))
    np.testing.assert_array_equal(lt.sendcounts, [1])
    assert lt.recvlength == 1


def test_degenerate_domain_receives_nothing():
    edges = [np.array([0.0, 4.0, 4.0, 8.0]), np.array([0.0, 8.0])]
    t, j = _both(edges, 3, periodic=True)
    np.testing.assert_array_equal(t.DomainDegenerate, j.DomainDegenerate)
    assert t.DomainDegenerate[1]
    pos = np.array([[3.9, 1.0], [4.1, 2.0]])
    lt = t.decompose(pos, smoothing=0.5)
    _same_plan(lt, j.decompose(pos, smoothing=0.5))
    assert lt.sendcounts[1] == 0


def test_domain_assign_consumed():
    """loadbalance rewrites DomainAssign and decompose routes by it"""
    t, j = _both([np.linspace(0, 8, 5)], 2)
    load = np.array([8.0, 1.0, 7.0, 2.0])
    t.loadbalance(load)
    j.loadbalance(load)
    np.testing.assert_array_equal(t.DomainAssign, j.DomainAssign)
    assert set(t.DomainAssign.tolist()) == {0, 1}
    pos = np.array([[0.5], [2.5], [4.5], [6.5]])
    lt = t.decompose(pos, smoothing=0)
    _same_plan(lt, j.decompose(pos, smoothing=0))
    expect = np.bincount(t.DomainAssign, minlength=2)
    np.testing.assert_array_equal(lt.sendcounts, expect)
    vals = lt.exchange(torch.arange(4.0)).numpy()
    by_rank = [sorted(vals[:expect[0]]), sorted(vals[expect[0]:])]
    want = [sorted(np.nonzero(t.DomainAssign == r)[0].astype('f8'))
            for r in range(2)]
    assert by_rank == [list(w) for w in want]


def test_isprimary_partitions():
    t, j = _both([[0, 4, 8], [0, 8]], 2, periodic=True)
    pos = np.random.RandomState(0).uniform(0, 8, (20, 2))
    p0, p1 = t.isprimary(pos, rank=0), t.isprimary(pos, rank=1)
    np.testing.assert_array_equal(p0, j.isprimary(pos, rank=0))
    np.testing.assert_array_equal(p1, j.isprimary(pos, rank=1))
    np.testing.assert_array_equal(p0 ^ p1, np.ones(20, dtype='?'))
    np.testing.assert_array_equal(t.which_rank(pos), (~p0).astype(int))
    np.testing.assert_array_equal(t.which_rank(torch.from_numpy(pos)),
                                  j.which_rank(pos))


def test_gridnd_load_counts():
    """per-domain cost N^gamma"""
    edges = [np.array([0.0, 4.0, 8.0]), np.array([0.0, 8.0])]
    t, j = GridND(edges, periodic=True), jdomain.GridND(edges,
                                                        periodic=True)
    pos = np.array([[1.0, 2.0], [2.0, 3.0], [3.5, 1.0], [6.0, 5.0]])
    for gamma in (1, 2):
        np.testing.assert_array_equal(t.load(pos, gamma=gamma),
                                      j.load(pos, gamma=gamma))
    np.testing.assert_allclose(t.load(pos, gamma=2), [9.0, 1.0])
    np.testing.assert_allclose(t.load(np.array([[9.0, 1.0]]), gamma=1),
                               [1.0, 0.0])
    assert not t.load(np.zeros((0, 2))).any()


def test_gridnd_loadbalance_greedy():
    t, j = _both([np.linspace(0, 8, 5)], 2)
    load = np.array([8.0, 1.0, 7.0, 2.0])
    t.loadbalance(load)
    j.loadbalance(load)
    np.testing.assert_array_equal(t.DomainAssign, j.DomainAssign)
    loads = [load[t.DomainAssign == r].sum() for r in range(2)]
    assert abs(loads[0] - loads[1]) <= 2.0, loads
    for a, b in zip(t.primary_regions, j.primary_regions):
        np.testing.assert_array_equal(a['start'], b['start'])
        np.testing.assert_array_equal(a['end'], b['end'])


def test_gridnd_uniform_and_gather_grad():
    """the uniform grid; exchange -> gather('sum') differentiates:
    torch.autograd's gradient is each particle's image count, and
    jax.grad's"""
    t = GridND.uniform([8.0, 8.0, 8.0], comm=_comm(4))
    j = jdomain.GridND.uniform([8.0, 8.0, 8.0],
                               comm=_comm(4, jdomain.FakeComm))
    for a, b in zip(t.edges, j.edges):
        np.testing.assert_array_equal(a, b)
    pos = np.random.RandomState(0).uniform(0, 8, (16, 3))
    lt, lj = t.decompose(pos, smoothing=1.0), j.decompose(pos, smoothing=1.0)
    _same_plan(lt, lj)
    assert lt.sendlength == 16 and lt.recvlength >= 16
    mass = torch.linspace(1.0, 2.0, 16, dtype=torch.float64,
                          requires_grad=True)
    lt.gather(lt.exchange(mass), 'sum').sum().backward()
    nim = np.bincount(lt.indices, minlength=16)
    np.testing.assert_allclose(mass.grad.numpy(), nim, rtol=1e-12)
    g = jax.grad(lambda m: jnp.sum(lj.gather(lj.exchange(m), 'sum')))(
        jnp.linspace(1.0, 2.0, 16))
    np.testing.assert_array_equal(mass.grad.numpy(), np.asarray(g))


# --- random particles over 2-d and 3-d grids ---------------------------------

@pytest.mark.parametrize("edges,size,smoothing,periodic", [
    ([np.linspace(0, 8, 4), np.linspace(0, 8, 3)], 6, 0.7, True),
    ([np.linspace(0, 8, 4), np.linspace(0, 8, 3)], 4, 1.3, True),
    ([np.linspace(0, 8, 3)] * 3, 8, 0.9, True),
    ([np.linspace(0, 8, 3)] * 3, 5, 0.9, False),
])
def test_decompose_random_matches_jax(edges, size, smoothing, periodic):
    """decompose's routing of seeded random particles, and every gather
    mode of distinct per-image values, exactly the JAX package's"""
    t, j = _both(edges, size, periodic=periodic)
    ndim = len(edges)
    pos = np.random.RandomState(size).uniform(-1, 9, (200, ndim))
    lt, lj = t.decompose(pos, smoothing=smoothing), j.decompose(
        pos, smoothing=smoothing)
    _same_plan(lt, lj)
    np.testing.assert_array_equal(
        lt.exchange(torch.from_numpy(pos)).numpy(),
        np.asarray(lj.exchange(pos)))
    data = np.random.RandomState(1).uniform(0.5, 1.5, (lt.recvlength, 2))
    _gathers_match(lt, lj, data)
    for rank in range(size):
        np.testing.assert_array_equal(t.isprimary(pos, rank=rank),
                                      j.isprimary(pos, rank=rank))
