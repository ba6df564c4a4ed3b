"""The port's lattice paint/readout (pmesh_tpu_torch.ops.gridpm) against
the JAX package's (pmesh_tpu.ops.gridpm), on the same numpy inputs.

Tolerance: 1e-6 of max|reference| (BASELINE.md's paint/readout bound);
both sides sum the same f32 terms, in orders that may differ.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pmesh_tpu.ops import gridpm as jgp
from pmesh_tpu_torch.ops import gridpm as tgp

torch.set_num_threads(1)

TOL = 1e-6
BF16_SHARE = 1e-3


def _rel(ref, got):
    ref = np.asarray(ref)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert ref.shape == got.shape
    return np.abs(ref - got).max() / max(np.abs(ref).max(), 1e-30)


def _inputs(seed, n, bounds, ndim=3):
    rng = np.random.RandomState(seed)
    disp = [rng.uniform(bounds[0], bounds[1], (n,) * ndim).astype('f4')
            for _ in range(ndim)]
    mass = (1 + 0.2 * rng.normal(size=(n,) * ndim)).astype('f4')
    meshes = [rng.normal(size=(n,) * ndim).astype('f4') for _ in range(3)]
    return disp, mass, meshes


def _j(arrays):
    return tuple(jnp.asarray(a) for a in arrays)


def _t(arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


@pytest.mark.parametrize("bounds", [(0.0, 1.0), (-1.0, 1.5)])
@pytest.mark.parametrize("window", ['cic', 'tsc', 'pcs'])
def test_paint_matches_jax(window, bounds):
    disp, mass, _ = _inputs(1, 16, bounds)
    jd, td = _j(disp), _t(disp)
    for diffdir in (None, 0, 1, 2):
        for m in (None, mass):
            ref = jgp._shift_loop(
                None, jd, None if m is None else jnp.asarray(m), bounds,
                window, diffdir, 'paint', impl='xla')
            got = tgp.paint_grid(
                td, mass=None if m is None else torch.from_numpy(m),
                bounds=bounds, window=window, diffdir=diffdir)
            assert _rel(ref, got) <= TOL, (diffdir, m is None)


@pytest.mark.parametrize("bounds", [(0.0, 1.0), (-1.0, 1.5)])
@pytest.mark.parametrize("window", ['cic', 'tsc', 'pcs'])
def test_readout_matches_jax(window, bounds):
    disp, _, meshes = _inputs(2, 16, bounds)
    jd, td = _j(disp), _t(disp)
    for diffdir in (None, 0, 1, 2):
        ref = jgp.readout_grid(jnp.asarray(meshes[0]), jd, bounds=bounds,
                               window=window, diffdir=diffdir, impl='xla')
        got = tgp.readout_grid(torch.from_numpy(meshes[0]), td,
                               bounds=bounds, window=window,
                               diffdir=diffdir)
        assert _rel(ref, got) <= TOL, diffdir
    refs = jgp.readout_grid(jnp.asarray(meshes[0]), jd, bounds=bounds,
                            window=window, diffdir='all', impl='xla')
    gots = tgp.readout_grid(torch.from_numpy(meshes[0]), td,
                            bounds=bounds, window=window, diffdir='all')
    assert len(gots) == 3
    for ref, got in zip(refs, gots):
        assert _rel(ref, got) <= TOL


def test_readout_three_meshes_matches_jax():
    disp, _, meshes = _inputs(3, 16, (0.0, 1.0))
    refs = jgp.readout_grid(_j(meshes), _j(disp), bounds=(0.0, 1.0),
                            impl='xla')
    gots = tgp.readout_grid(_t(meshes), _t(disp), bounds=(0.0, 1.0))
    assert isinstance(gots, tuple) and len(gots) == 3
    for ref, got in zip(refs, gots):
        assert _rel(ref, got) <= TOL


@pytest.mark.parametrize("window", ['nearest', 'lanczos2', 'acg2', 'db6'])
def test_other_windows_match_jax(window):
    bounds = (-0.5, 0.5)
    disp, mass, meshes = _inputs(4, 8, bounds)
    jd, td = _j(disp), _t(disp)
    ref = jgp.paint_grid(jd, mass=jnp.asarray(mass), bounds=bounds,
                         window=window, impl='xla')
    got = tgp.paint_grid(td, mass=torch.from_numpy(mass), bounds=bounds,
                         window=window)
    assert _rel(ref, got) <= TOL
    for diffdir in (None, 1):
        ref = jgp.readout_grid(jnp.asarray(meshes[0]), jd, bounds=bounds,
                               window=window, diffdir=diffdir, impl='xla')
        got = tgp.readout_grid(torch.from_numpy(meshes[0]), td,
                               bounds=bounds, window=window,
                               diffdir=diffdir)
        assert _rel(ref, got) <= TOL


def test_matches_jax_pallas_interpret():
    """The JAX package's Pallas kernels (interpret mode on the CPU)
    against the port's plain version, as test_gridpm runs them."""
    bounds = (-1.0, 2.0)
    disp, mass, meshes = _inputs(5, 8, bounds)
    jd, td = _j(disp), _t(disp)
    ref = jgp.paint_grid(jd, mass=jnp.asarray(mass), bounds=bounds,
                         impl='pallas')
    got = tgp.paint_grid(td, mass=torch.from_numpy(mass), bounds=bounds)
    assert _rel(ref, got) <= TOL
    ref = jgp.readout_grid(jnp.asarray(meshes[0]), jd, bounds=bounds,
                           impl='pallas')
    got = tgp.readout_grid(torch.from_numpy(meshes[0]), td, bounds=bounds)
    assert _rel(ref, got) <= TOL


def test_bf16_matches_jax_pallas_interpret():
    """bf16 state and meshes (the TPU kernels' _cdtype form) at 16^3:
    the JAX package's Pallas kernels (interpret mode) against the port's
    plain version.  Both compute in f32 and round each output once to
    bf16, so they differ only where their f32 sums, taken in other
    orders, round to neighbouring bf16 values: at most one bf16 ulp of
    the entry, in at most BF16_SHARE of the entries."""
    bounds = (-1.0, 2.0)
    disp, mass, meshes = _inputs(5, 16, bounds)
    bf = jnp.bfloat16
    jd = tuple(jnp.asarray(d, bf) for d in disp)
    td = tuple(torch.from_numpy(d).to(torch.bfloat16) for d in disp)
    cases = (
        (jgp.paint_grid(jd, mass=jnp.asarray(mass, bf), bounds=bounds,
                        impl='pallas'),
         tgp.paint_grid(td, mass=torch.from_numpy(mass).to(torch.bfloat16),
                        bounds=bounds)),
        (jgp.readout_grid(jnp.asarray(meshes[0], bf), jd, bounds=bounds,
                          impl='pallas'),
         tgp.readout_grid(torch.from_numpy(meshes[0]).to(torch.bfloat16), td,
                          bounds=bounds)))
    for ref, got in cases:
        assert got.dtype == torch.bfloat16
        ref = np.asarray(jnp.asarray(ref, jnp.float32))
        got = got.float().numpy()
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(ref), 1e-30))) - 7)
        assert np.all(np.abs(got - ref) <= ulp)
        assert np.mean(got != ref) <= BF16_SHARE


def test_2d_matches_jax():
    disp, mass, meshes = _inputs(6, 16, (0.0, 1.0), ndim=2)
    ref = jgp.paint_grid(_j(disp), mass=jnp.asarray(mass), impl='xla')
    got = tgp.paint_grid(_t(disp), mass=torch.from_numpy(mass))
    assert _rel(ref, got) <= TOL
    ref = jgp.readout_grid(jnp.asarray(meshes[0]), _j(disp), diffdir=1,
                           impl='xla')
    got = tgp.readout_grid(torch.from_numpy(meshes[0]), _t(disp),
                           diffdir=1)
    assert _rel(ref, got) <= TOL


def test_paint_conserves_mass_f64():
    disp, _, _ = _inputs(7, 8, (-1.0, 1.0))
    td = tuple(torch.from_numpy(d.astype('f8')) for d in disp)
    rho = tgp.paint_grid(td, bounds=(-1.0, 1.0), window='tsc')
    assert rho.dtype == torch.float64
    np.testing.assert_allclose(float(rho.sum()), 8 ** 3, rtol=1e-12)


@pytest.mark.parametrize("window", ['nearest', 'cic', 'tsc', 'pcs',
                                    'lanczos3', 'db12'])
def test_offset_range_matches_jax(window):
    for bounds in ((0.0, 1.0), (-1.0, 1.0), (-0.3, 2.7), (0.5, 0.5)):
        assert tgp.offset_range(*bounds, window) \
            == jgp.offset_range(*bounds, window)


def test_grid_limit_raises():
    disp = tuple(torch.zeros((4, 4, 4)) for _ in range(3))
    with pytest.raises(ValueError):
        tgp.paint_grid(disp, bounds=(-200.0, 200.0))
    assert tgp.GRID_LIMIT == jgp.GRID_LIMIT


def test_displacement_bounds():
    disp = (torch.tensor([-0.5, 2.0]), torch.tensor([0.1, 0.3]))
    lo, hi = tgp.displacement_bounds(disp)
    assert lo.dim() == 0 and float(lo) == -0.5 and float(hi) == 2.0
