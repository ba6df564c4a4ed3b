"""The port's generic paint and readout (pmesh_tpu_torch.ops.paint)
against the JAX package's (pmesh_tpu.ops.paint), on the same numpy
inputs made from a seed: a few hundred particles on 8^3 meshes, f8.

Tolerances: every window's paint and readout within 1e-10 of max|ref|
(periodic, with hsml, with a diffdir, and through a non-periodic affine
with particles outside the mesh); the batched three-mesh readout the
same; torch.autograd of paint and readout (mesh, positions, mass)
within 1e-8 of max|jax.grad| for CIC and TSC; f4 paint and readout
within 1e-5 and f4 mass conservation to 1e-5 relative.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pmesh_tpu.ops import paint as jpaint
from pmesh_tpu_torch.ops import paint as tpaint

torch.set_num_threads(1)

WINDOWS = (['nearest', 'linear', 'nnb', 'cic', 'tsc', 'pcs', 'quadratic',
            'cubic'] + ['lanczos%d' % n for n in range(2, 7)]
           + ['acg%d' % n for n in range(2, 7)]
           + ['db6', 'db12', 'db20', 'sym6', 'sym12', 'sym20'])
N = 8
NPART = 200


def _rel(ref, got):
    ref = np.asarray(ref)
    got = got.detach().numpy()
    assert ref.shape == got.shape and ref.dtype == got.dtype
    scale = np.abs(ref).max()
    return np.abs(ref - got).max() / (scale if scale > 0 else 1.0)


def _inputs(seed, lo=0.0, hi=float(N)):
    rng = np.random.RandomState(seed)
    pos = rng.uniform(lo, hi, size=(NPART, 3))
    mass = rng.uniform(0.5, 1.5, size=NPART)
    mesh = rng.normal(size=(N,) * 3)
    hsml = rng.uniform(0.6, 1.3, size=NPART)
    return pos, mass, mesh, hsml


def _variant(name, variant):
    """(positions, the affine and extra keywords) of a test variant"""
    i = WINDOWS.index(name)
    pos, mass, mesh, hsml = _inputs(i)
    kw = dict(scale=1.0, translate=0.0, period=N)
    if variant == 'hsml':
        kw['hsml'] = hsml
    elif variant == 'diffdir':
        kw['diffdir'] = i % 3
    elif variant == 'affine':
        # not periodic, scaled and shifted: a tenth of the particles and
        # many stencils fall outside the mesh
        pos = _inputs(i, -3.0, 12.0)[0]
        kw = dict(scale=0.8, translate=1.5, period=0)
    return pos, mass, mesh, kw


def _jax_kw(kw):
    return {k: (jnp.asarray(v) if k == 'hsml' else v) for k, v in kw.items()}


def _torch_kw(kw):
    return {k: (torch.from_numpy(v) if k == 'hsml' else v)
            for k, v in kw.items()}


@pytest.mark.parametrize("variant", ['periodic', 'hsml', 'diffdir',
                                     'affine'])
@pytest.mark.parametrize("name", WINDOWS)
def test_paint_readout_match_jax(name, variant):
    pos, mass, mesh, kw = _variant(name, variant)
    base = np.random.RandomState(99).normal(size=(N,) * 3)
    ref = jpaint.paint(jnp.asarray(base), jnp.asarray(pos), jnp.asarray(mass),
                       window=name, **_jax_kw(kw))
    got = tpaint.paint(torch.from_numpy(base), torch.from_numpy(pos),
                       torch.from_numpy(mass), window=name, **_torch_kw(kw))
    assert _rel(ref, got) <= 1e-10
    ref = jpaint.readout(jnp.asarray(mesh), jnp.asarray(pos), window=name,
                         **_jax_kw(kw))
    got = tpaint.readout(torch.from_numpy(mesh), torch.from_numpy(pos),
                         window=name, **_torch_kw(kw))
    assert _rel(ref, got) <= 1e-10


@pytest.mark.parametrize("name", ['cic', 'tsc', 'lanczos2'])
def test_batched_readout_matches_jax(name):
    pos, _, _, _ = _inputs(7)
    meshes = np.random.RandomState(8).normal(size=(3, N, N, N))
    kw = dict(scale=0.9, translate=0.5, period=N)
    ref = jpaint.readout(tuple(jnp.asarray(m) for m in meshes),
                         jnp.asarray(pos), window=name, **kw)
    got = tpaint.readout(tuple(torch.from_numpy(m) for m in meshes),
                         torch.from_numpy(pos), window=name, **kw)
    assert isinstance(got, tuple) and len(got) == 3
    for r, g in zip(ref, got):
        assert _rel(r, g) <= 1e-10
    refb = jpaint.readout(jnp.asarray(meshes), jnp.asarray(pos),
                          window=name, **kw)
    gotb = tpaint.readout(torch.from_numpy(meshes), torch.from_numpy(pos),
                          window=name, **kw)
    assert tuple(gotb.shape) == (3, NPART)
    assert _rel(refb, gotb) <= 1e-10
    # one shared stencil: the batch is each mesh read alone
    for m, g in zip(meshes, gotb):
        one = tpaint.readout(torch.from_numpy(m), torch.from_numpy(pos),
                             window=name, **kw)
        assert torch.equal(one, g)


@pytest.mark.parametrize("name", ['cic', 'tsc'])
def test_paint_grad_matches_jax(name):
    pos, mass, _, _ = _inputs(11, 0.5, N - 0.5)
    wmesh = np.random.RandomState(12).normal(size=(N,) * 3)
    base = np.random.RandomState(13).normal(size=(N,) * 3)
    kw = dict(window=name, scale=1.1, translate=0.25, period=N)

    def jloss(b, p, m):
        return jnp.sum(jpaint.paint(b, p, m, **kw) ** 2 * wmesh)
    ref = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(base), jnp.asarray(pos), jnp.asarray(mass))
    ts = [torch.from_numpy(a).requires_grad_() for a in (base, pos, mass)]
    loss = (tpaint.paint(ts[0], ts[1], ts[2], **kw) ** 2
            * torch.from_numpy(wmesh)).sum()
    got = torch.autograd.grad(loss, ts)
    for r, g in zip(ref, got):
        assert _rel(r, g) <= 1e-8

    # a scalar mass takes the sum of the particles' cotangents
    def jloss_s(p, m):
        return jnp.sum(jpaint.paint(jnp.zeros((N,) * 3), p, m, **kw) * wmesh)
    ref = jax.grad(jloss_s, argnums=(0, 1))(jnp.asarray(pos), 1.5)
    tp = torch.from_numpy(pos).requires_grad_()
    tm = torch.tensor(1.5, dtype=torch.float64, requires_grad=True)
    loss = (tpaint.paint(torch.zeros((N,) * 3, dtype=torch.float64), tp, tm,
                         **kw) * torch.from_numpy(wmesh)).sum()
    got = torch.autograd.grad(loss, (tp, tm))
    assert _rel(ref[0], got[0]) <= 1e-8
    assert abs(float(ref[1]) - float(got[1])) <= 1e-8 * abs(float(ref[1]))


@pytest.mark.parametrize("name", ['cic', 'tsc'])
def test_readout_grad_matches_jax(name):
    pos, _, _, _ = _inputs(21, 0.5, N - 0.5)
    meshes = np.random.RandomState(22).normal(size=(3, N, N, N))
    wts = np.random.RandomState(23).normal(size=(3, NPART))
    kw = dict(window=name, scale=0.9, translate=0.5, period=N)

    def jloss(ms, p):
        out = jpaint.readout(ms, p, **kw)
        return sum(jnp.sum(o ** 2 * w) for o, w in zip(out, wts))
    ref = jax.grad(jloss, argnums=(0, 1))(
        tuple(jnp.asarray(m) for m in meshes), jnp.asarray(pos))
    tm = [torch.from_numpy(m).requires_grad_() for m in meshes]
    tp = torch.from_numpy(pos).requires_grad_()
    out = tpaint.readout(tuple(tm), tp, **kw)
    loss = sum((o ** 2 * torch.from_numpy(w)).sum()
               for o, w in zip(out, wts))
    got = torch.autograd.grad(loss, tm + [tp])
    for r, g in zip(list(ref[0]) + [ref[1]], got):
        assert _rel(r, g) <= 1e-8

    # the mesh cotangent of a derivative readout is a derivative paint:
    # the adjoint identity <readout_d(m), w> = <m, grad>, on a second mesh
    # (the JAX package's rule instantiates the positions' zero tangent
    # and raises here)
    m2 = torch.from_numpy(np.random.RandomState(24).normal(size=(N,) * 3))
    w = torch.from_numpy(wts[0])
    grad, = torch.autograd.grad(
        (tpaint.readout(tm[0], torch.from_numpy(pos), diffdir=1, **kw)
         * w).sum(), tm[0])
    lhs = float((tpaint.readout(m2, torch.from_numpy(pos), diffdir=1, **kw)
                 * w).sum())
    assert abs(lhs - float((m2 * grad).sum())) <= 1e-12 * abs(lhs)
    # its positions take no derivative, as in the JAX package
    with pytest.raises(ValueError, match="gradient of gradient"):
        torch.autograd.grad(tpaint.readout(tm[0], tp, diffdir=1,
                                           **kw).sum(), tp)


def test_f4_matches_jax_and_conserves_mass():
    pos, mass, mesh, _ = _inputs(31)
    pos, mass, mesh = (a.astype('f4') for a in (pos, mass, mesh))
    kw = dict(window='cic', scale=1.0, translate=0.0, period=N)
    ref = jpaint.paint(jnp.zeros((N,) * 3, jnp.float32), jnp.asarray(pos),
                       jnp.asarray(mass), **kw)
    got = tpaint.paint(torch.zeros((N,) * 3), torch.from_numpy(pos),
                       torch.from_numpy(mass), **kw)
    assert got.dtype == torch.float32
    assert _rel(ref, got) <= 1e-5
    total = float(got.double().sum())
    assert abs(total - float(mass.astype('f8').sum())) <= 1e-5 * total
    ref = jpaint.readout(jnp.asarray(mesh), jnp.asarray(pos), **kw)
    got = tpaint.readout(torch.from_numpy(mesh), torch.from_numpy(pos), **kw)
    assert _rel(ref, got) <= 1e-5


def test_out_of_mesh_particles_are_dropped():
    """Particles whose whole stencil lies outside a non-periodic mesh
    paint nothing and read 0, and the sentinel never shows."""
    pos = torch.tensor([[-5.0, 1.0, 1.0], [1.0, 20.0, 1.0], [3.2, 3.7, 4.1]],
                       dtype=torch.float64)
    mesh = tpaint.paint(torch.zeros((N,) * 3, dtype=torch.float64), pos,
                        window='tsc', period=0)
    assert abs(float(mesh.sum()) - 1.0) <= 1e-14
    vals = tpaint.readout(torch.ones((N,) * 3, dtype=torch.float64), pos,
                          window='tsc', period=0)
    assert vals[:2].abs().max() == 0
    assert abs(float(vals[2]) - 1.0) <= 1e-14
