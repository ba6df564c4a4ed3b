"""The port package as a whole: it imports without JAX, triton or nvcc;
its windows, transforms, coordinates and transfer functions match the
JAX package's; the CUDA dispatch and the kernel build refuse what they
cannot run instead of falling back."""
import os
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pmesh_tpu import ParticleMesh as JaxPM
from pmesh_tpu.ops import kernels as jkernels
from pmesh_tpu.ops import transfer as jtf
from pmesh_tpu_torch import ParticleMesh, convert
from pmesh_tpu_torch.native import cuda as tcuda
from pmesh_tpu_torch.ops import gridpm as tgp
from pmesh_tpu_torch.ops import kernels as tkernels
from pmesh_tpu_torch.ops import transfer as ttf

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

ALL_WINDOWS = (['nearest', 'linear', 'quadratic', 'cubic', 'nnb', 'cic',
                'tsc', 'pcs', 'tunedcic']
               + ['lanczos%d' % n for n in range(2, 7)]
               + ['acg%d' % n for n in range(2, 7)]
               + ['db6', 'db12', 'db20', 'sym6', 'sym12', 'sym20'])


def _run_python(code, env=None):
    return subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120,
                          env=env)


def test_imports_without_jax():
    proc = _run_python(
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import pmesh_tpu_torch, pmesh_tpu_torch.convert\n"
        "import pmesh_tpu_torch.models.fastpm\n"
        "import pmesh_tpu_torch.ops.gridpm_cuda\n"
        "import pmesh_tpu_torch.ops.binned_cuda\n"
        "import pmesh_tpu_torch.ops.fft_mxu_cuda\n"
        "import pmesh_tpu_torch.ops.fft_mxu_ref\n"
        "import pmesh_tpu_torch.parallel.pmesh\n"
        "import pmesh_tpu_torch.parallel.comm\n"
        "import pmesh_tpu_torch.parallel.halo\n"
        "import pmesh_tpu_torch.parallel.pfft\n"
        "import pmesh_tpu_torch.parallel.launch\n"
        "import pmesh_tpu_torch.parallel.domain\n"
        "import pmesh_tpu_torch.parallel.exchange\n"
        "import pmesh_tpu_torch.parallel.exchange2d\n"
        "import pmesh_tpu_torch.parallel.coarray\n"
        "import pmesh_tpu_torch.ops.paint, pmesh_tpu_torch.ops.power\n"
        "import pmesh_tpu_torch.whitenoise, pmesh_tpu_torch.invariant\n"
        "import pmesh_tpu_torch.native.runtime\n"
        "import pmesh_tpu_torch.models.genic\n"
        "import pmesh_tpu_torch.models.powerspectrum\n"
        "import pmesh_tpu_torch.models.gravpm, pmesh_tpu_torch.models.qpm\n"
        "import pmesh_tpu_torch.models.kleingordon\n"
        "import pmesh_tpu_torch.lic, pmesh_tpu_torch.gradcheck\n"
        "import pmesh_tpu_torch.utils.bigfile, pmesh_tpu_torch.utils.timers\n"
        "import pmesh_tpu_torch.utils.checkpoint\n"
        "import pmesh_tpu_torch.utils.measure\n"
        "import pmesh_tpu_torch.legacy.tools, pmesh_tpu_torch.legacy.cic\n"
        "import pmesh_tpu_torch.legacy.tsc, pmesh_tpu_torch.legacy.lanczos\n"
        "import pmesh_tpu_torch.legacy.transfer\n"
        "import pmesh_tpu_torch.legacy.particlemesh\n"
        "sys.path.insert(0, 'tests')\n"
        "import torch_sharded_cases, torch_geometry_cases\n"
        "assert not [m for m in sys.modules if m.startswith('jax') and\n"
        "            sys.modules[m] is not None]\n"
        "assert 'pmesh_tpu' not in sys.modules\n")
    assert proc.returncode == 0, proc.stderr


def test_imports_without_triton_or_nvcc(tmp_path):
    env = dict(os.environ, PATH=str(tmp_path), CUDA_HOME=str(tmp_path))
    proc = _run_python(
        "import sys\n"
        "sys.modules['triton'] = None\n"
        "import pmesh_tpu_torch\n"
        "from pmesh_tpu_torch.ops import gridpm, gridpm_cuda\n"
        "from pmesh_tpu_torch.ops import binned, binned_cuda\n"
        "from pmesh_tpu_torch.ops import fft_mxu, fft_mxu_cuda\n"
        "from pmesh_tpu_torch.models import fastpm\n"
        "assert 'triton' not in [m for m in sys.modules\n"
        "                        if sys.modules[m] is not None]\n", env=env)
    assert proc.returncode == 0, proc.stderr


def test_build_raises_without_nvcc(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        tcuda.find_nvcc()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        tcuda.build("gridpm")


def test_build_flags_and_sources():
    assert "arch=compute_90a,code=sm_90a" in tcuda.NVCC_FLAGS
    for name in ("gridpm", "binned", "fft_mxu"):
        assert os.path.isfile(os.path.join(tcuda.CSRC, name + ".cu"))
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert "pmesh_tpu_torch/_build/" in f.read().split()


def test_impl_cuda_on_cpu_tensor_raises():
    disp = tuple(torch.zeros((4, 4, 4)) for _ in range(3))
    mesh = torch.zeros((4, 4, 4))
    with pytest.raises(ValueError, match="CUDA tensors"):
        tgp.paint_grid(disp, impl='cuda')
    with pytest.raises(ValueError, match="CUDA tensors"):
        tgp.readout_grid(mesh, disp, impl='cuda')
    with pytest.raises(ValueError, match="CUDA tensors"):
        tgp.readout_grid(mesh, disp, diffdir='all', impl='cuda')
    with pytest.raises(ValueError):
        tgp.paint_grid(disp, impl='xla')


def test_cuda_wrappers_refuse_cpu_tensors():
    from pmesh_tpu_torch.ops import gridpm_cuda
    disp = tuple(torch.zeros((4, 4, 4)) for _ in range(3))
    before = dict(gridpm_cuda.LAUNCHES)
    with pytest.raises(ValueError):
        gridpm_cuda.paint_lattice(disp, None, 0, 1, 'cic')
    with pytest.raises(ValueError):
        gridpm_cuda.readout_lattice((disp[0],), disp, 0, 1, 'cic')
    assert gridpm_cuda.LAUNCHES == before
    gridpm_cuda.reset_launches()
    assert set(gridpm_cuda.LAUNCHES.values()) == {0}


@pytest.mark.parametrize("name", ALL_WINDOWS)
def test_window_matches_jax(name):
    x = np.linspace(-7.3, 7.3, 2921)
    jw, tw = jkernels.find_window(name), tkernels.find_window(name)
    assert (tw.kind, tw.support) == (jw.kind, jw.support)
    for fn in ('kernel', 'diff'):
        ref = np.asarray(getattr(jw, fn)(jnp.asarray(x)))
        got = getattr(tw, fn)(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-12)
    w = np.linspace(-np.pi, np.pi, 101)
    np.testing.assert_allclose(
        tw.get_fwindow(torch.from_numpy(w)).numpy(),
        np.asarray(jw.get_fwindow(jnp.asarray(w))), rtol=1e-12)


def test_resampler_registry():
    from pmesh_tpu import window as jwin
    from pmesh_tpu_torch import window as twin
    for name in ('cic', 'CIC', 'tsc', 'nearest', 'lanczos3', 'db6'):
        assert twin.FindResampler(name).kind \
            == jwin.FindResampler(name).kind
        assert twin.FindResampler(name).support \
            == jwin.FindResampler(name).support
    # the generic paint and readout agree with the JAX package's at 8^3
    rng = np.random.RandomState(1)
    pos = rng.uniform(0, 8, size=(50, 3))
    mesh = rng.normal(size=(8, 8, 8))
    jr, tr = jwin.FindResampler('tsc'), twin.FindResampler('tsc')
    jt, tt = jwin.Affine(3, period=8), twin.Affine(3, period=8)
    ref = np.asarray(jr.paint(jnp.zeros((8, 8, 8)), jnp.asarray(pos),
                              transform=jt))
    got = tr.paint(torch.zeros((8, 8, 8), dtype=torch.float64),
                   torch.from_numpy(pos), transform=tt).numpy()
    assert np.abs(got - ref).max() <= 1e-10 * np.abs(ref).max()
    ref = np.asarray(jr.readout(jnp.asarray(mesh), jnp.asarray(pos),
                                transform=jt))
    got = tr.readout(torch.from_numpy(mesh), torch.from_numpy(pos),
                     transform=tt).numpy()
    assert np.abs(got - ref).max() <= 1e-10 * np.abs(ref).max()


@pytest.mark.parametrize("dtype", ['f4', 'f8'])
def test_fft_and_coords_match_jax(dtype):
    shape = (8, 6, 10)
    jpm = JaxPM(Nmesh=list(shape), BoxSize=[4.0, 3.0, 7.0], dtype=dtype)
    tpm = convert.particlemesh_from(jpm.Nmesh, jpm.BoxSize, jpm.dtype,
                                    'cic', device='cpu')
    rng = np.random.RandomState(20)
    x = rng.normal(size=shape).astype(dtype)
    jr = jpm.create(type='real', value=jnp.asarray(x))
    tr = convert.field_from_numpy(tpm, x)
    jk, tk = jr.r2c(), tr.r2c()
    tol = 1e-6 if dtype == 'f4' else 1e-14
    assert tk.value.dtype == (torch.complex64 if dtype == 'f4'
                              else torch.complex128)
    np.testing.assert_allclose(tk.value.numpy(), np.asarray(jk.value),
                               atol=tol * np.abs(np.asarray(jk.value)).max())
    back = tk.c2r()
    assert back.value.dtype == tr.value.dtype
    np.testing.assert_allclose(back.value.numpy(), x, atol=10 * tol)
    for kind in ('real', 'complex'):
        for idx in (False, True):
            ref = jpm.create_coords(kind, return_indices=idx)
            got = tpm.create_coords(kind, return_indices=idx)
            for r, g in zip(ref, got):
                np.testing.assert_array_equal(g.numpy(), np.asarray(r))


@pytest.mark.parametrize("filt", ['poisson', 'force0', 'force2', 'force1_k',
                                  'gradient1', 'dx1_2'])
def test_transfer_matches_jax(filt):
    def make(mod):
        return {'poisson': mod.poisson(),
                'force1_k': mod.force_transfer(1, order=0),
                'force0': mod.force_transfer(0),
                'force2': mod.force_transfer(2),
                'gradient1': mod.gradient(1),
                'dx1_2': mod.dx1_transfer(2)}[filt]
    jpm = JaxPM(Nmesh=[8, 8, 8], BoxSize=16.0, dtype='f4')
    tpm = convert.particlemesh_from(jpm.Nmesh, jpm.BoxSize, jpm.dtype,
                                    'cic', device='cpu')
    rng = np.random.RandomState(21)
    x = rng.normal(size=(8, 8, 8)).astype('f4')
    ref = jpm.create(type='real', value=jnp.asarray(x)).r2c() \
        .apply(make(jtf)).c2r().value
    got = convert.field_from_numpy(tpm, x).r2c().apply(make(ttf)) \
        .c2r().value
    ref = np.asarray(ref)
    assert np.abs(got.numpy() - ref).max() <= 2e-6 * np.abs(ref).max()


def test_entry_points_default_to_the_card(monkeypatch):
    """without device=, ParticleMesh and the convert helpers take the
    current CUDA device, and raise when there is none: nothing falls
    back to the CPU unasked"""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    arrays = [np.zeros((2, 2, 2), 'f4')] * 3
    for make in (lambda: ParticleMesh([4, 4, 4]),
                 lambda: convert.particlemesh_from([4, 4, 4], 1.0, 'f4',
                                                   'cic'),
                 lambda: convert.lattice_state_from_numpy(arrays, arrays),
                 lambda: convert.binned_state_from_numpy((arrays,))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert ParticleMesh([4, 4, 4]).device == torch.device('cuda', 0)
    assert ParticleMesh([4, 4, 4], device='cuda').device \
        == torch.device('cuda', 0)
    assert ParticleMesh([4, 4, 4], device='cpu').device \
        == torch.device('cpu')


def test_convert_and_device_checks():
    pm = convert.particlemesh_from([4, 4, 8], [1.0, 1.0, 2.0], 'f8',
                                   'tsc', device='cpu')
    assert pm.device == torch.device('cpu')
    assert pm.resampler.kind == 'tunedtsc'
    assert tuple(pm.Nmesh) == (4, 4, 8)
    assert pm.create(type='complex').value.shape == (4, 4, 5)
    with pytest.raises(ValueError):
        convert.field_from_numpy(pm, np.zeros((4, 4, 4)))
    with pytest.raises(ValueError, match='lies on'):
        pm.create(type='real', value=torch.zeros((4, 4, 8), device='meta'))
    with pytest.raises(TypeError, match='ProcessMesh'):
        ParticleMesh([4, 4, 4], procmesh=object(), device='cpu')
    with pytest.raises(ValueError, match='c16 or c8'):
        ParticleMesh([4, 4, 4], dtype='i4', device='cpu')
    # complex meshes are c2c: their real fields are complex too
    c2c = ParticleMesh([4, 4, 4], dtype='c8', device='cpu')
    assert c2c.create(type='real').value.dtype == torch.complex64
    assert c2c.create(type='complex').value.shape == (4, 4, 4)
    d, v = convert.lattice_state_from_numpy(
        [np.ones((2, 2, 2), 'f4')] * 3, [np.zeros((2, 2, 2), 'f8')] * 3,
        device='cpu')
    assert d[0].dtype == torch.float32 and v[2].dtype == torch.float64
