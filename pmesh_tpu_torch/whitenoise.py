"""Resolution-invariant hermitian white noise.

Counterpart of ``pmesh_tpu/whitenoise.py``.  Two generators:

``compat='gadget'`` is bit-compatible with N-GenIC: the ranlxd1
seed-table scheme of the port's C++ host runtime (``native/``), filled
on the host and moved to the device.  This is host work by design, as
in the JAX package and the reference: the seed table is a serial walk
of one random stream, so there is no device version to fall back from.
1-d and 2-d meshes take a numpy fallback that is partition invariant
but not resolution invariant, as in the reference.

``compat='native'`` is the counter-based generator, computed on the
device: every mode's sample is a function of (seed, signed mode
vector) through threefry2x32, so a larger mesh reproduces a smaller
mesh's low-k modes.  It is bitwise the JAX package's generator under
x64 (``jax.random.fold_in`` of each signed component, as a
two's-complement word, into ``fold_in(key(0), seed)``, then
``jax.random.uniform(key, (2,), float64)`` with the partitionable
threefry bit layout).  torch has no full uint32 arithmetic, so the
words are held in int64 and masked to 32 bits.  The samples are drawn
in f8 whatever the mesh's dtype, then cast.

Both give hermitian fields with per-component std 1/sqrt(2), in the
compressed half spectrum or the full cube.  ``device`` defaults to the
current CUDA device and raises without CUDA; CPU use is asked for with
``device='cpu'``.
"""
import functools

import numpy as np
import torch

from .pm import resolve_device

__all__ = ["generate", "generate_native", "generate_gadget",
           "native_uniforms"]

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 (20 rounds) of the words (x0, x1) under the key
    (k0, k1): int64 tensors (or ints) holding uint32 values; returns the
    two output words."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def _fold_in(key, data):
    """jax.random.fold_in of the uint32 word ``data``: the threefry of
    the counter (0, data) under ``key``."""
    return threefry2x32(key[0], key[1], data * 0, data)


def _uniform_f8(key, i):
    """Element i of jax.random.uniform(key, (n,), float64): the 64 bits
    of the threefry of the counter (0, i), top word first; their top 52
    bits are the mantissa, so the value is mantissa * 2^-52 exactly."""
    b1, b2 = threefry2x32(key[0], key[1], key[0] * 0, key[0] * 0 + i)
    return ((b1 << 20) | (b2 >> 12)).to(torch.float64) * 2.0 ** -52


def _modes(Nmesh, shape, device, start=None):
    """The signed integer mode vector of each element of a (shape)
    block at offset ``start`` (default the origin) of the mode cube, its
    lexicographic representative of {m, -m}, and whether the element is
    the representative, self-conjugate, and the DC mode."""
    ndim = len(Nmesh)
    start = (0,) * ndim if start is None else start
    m = []
    for d in range(ndim):
        t = [1] * ndim
        t[d] = shape[d]
        i = torch.arange(shape[d], dtype=torch.int64, device=device) \
            + int(start[d])
        m.append(torch.where(i >= Nmesh[d] // 2, i - Nmesh[d], i).reshape(t))
    # the Nyquist -N/2 is its own negative
    mneg = [torch.where(m[d] == -(Nmesh[d] // 2), m[d], -m[d])
            for d in range(ndim)]
    gt = torch.zeros(shape, dtype=torch.bool, device=device)
    eq = torch.ones(shape, dtype=torch.bool, device=device)
    for d in range(ndim):
        gt = gt | (eq & (m[d] > mneg[d]))
        eq = eq & (m[d] == mneg[d])
    isrep = gt | eq
    rep = [torch.where(isrep, m[d], mneg[d]) for d in range(ndim)]
    dc = functools.reduce(torch.logical_and, [md == 0 for md in m])
    return rep, isrep, eq, dc


def native_uniforms(Nmesh, shape, seed, device=None, start=None):
    """The two uniforms (u1, u2) of every mode of a (shape) block at
    ``start`` (default the origin) of the mode cube, f8 tensors of
    ``shape``: those of the mode's representative of {m, -m}."""
    device = resolve_device(device)
    rep = _modes(Nmesh, shape, device, start)[0]
    base = _fold_in((0, 0), int(seed) & _M32)
    key = (torch.full(shape, base[0], dtype=torch.int64, device=device),
           torch.full(shape, base[1], dtype=torch.int64, device=device))
    for r in rep:
        # the signed component as a two's-complement uint32 word
        key = _fold_in(key, torch.broadcast_to(r & _M32, shape))
    return _uniform_f8(key, 0), _uniform_f8(key, 1)


def generate_native(Nmesh, shape, seed, unitary=False, dtype=None,
                    device=None, start=None):
    """The counter-based generator on ``device`` (module docstring),
    for the (shape) block at ``start`` of the mode cube: every mode is a
    function of (seed, mode) alone, so a block is bitwise the same
    block of the whole fill (the JAX package's sharded fill)."""
    device = resolve_device(device)
    Nmesh = tuple(int(n) for n in Nmesh)
    shape = tuple(int(n) for n in shape)
    _, isrep, selfconj, dc = _modes(Nmesh, shape, device, start)
    u1, u2 = native_uniforms(Nmesh, shape, seed, device, start)
    phase = 2 * np.pi * u2
    if unitary:
        ampl = torch.ones_like(u1)
    else:
        ampl = torch.sqrt(-torch.log(torch.where(u1 == 0, 1.0, u1)))
    re = ampl * torch.cos(phase)
    im = ampl * torch.sin(phase)
    # the conjugate for the other member of the pair; self-conjugate
    # modes are real, the DC mode 0
    im = torch.where(isrep, im, -im)
    im = torch.where(selfconj, 0.0, im)
    if unitary:
        re = torch.where(selfconj, 1.0, re)
    re = torch.where(dc, 0.0, re)
    im = torch.where(dc, 0.0, im)
    value = torch.complex(re, im)
    return value if dtype is None else value.to(dtype)


def generate_gadget(Nmesh, shape, seed, unitary=False, dtype=None,
                    start=None, device=None):
    """The N-GenIC-compatible generator: a host fill by the C++ runtime
    (3-d) or the numpy fallback (1-d, 2-d), moved to ``device``."""
    device = resolve_device(device)
    Nmesh = tuple(int(n) for n in Nmesh)
    shape = tuple(int(n) for n in shape)
    if start is None:
        start = (0,) * len(Nmesh)
    if len(Nmesh) == 3:
        if Nmesh[1] > Nmesh[0]:
            # the fill seeds an N0 x N0 table and reads it at (i, j) for
            # every j < N1: past its end when N1 > N0, with no defined
            # answer (two fills of one seed differ)
            raise ValueError(
                "compat='gadget' needs Nmesh[1] <= Nmesh[0] on a 3-d mesh, "
                "got %s: the fill would read past its N0 x N0 seed table"
                % (Nmesh,))
        from .native import runtime
        npdtype = ('complex64' if dtype == torch.complex64
                   else 'complex128')
        value = runtime.whitenoise_fill(Nmesh, shape, start, int(seed),
                                        bool(unitary), dtype=npdtype)
    elif len(Nmesh) <= 2:
        rng = np.random.RandomState(seed)
        full = np.fft.fftn(rng.normal(size=Nmesh))
        full *= np.prod(Nmesh) ** -0.5
        value = full[tuple(slice(a, a + b) for a, b in zip(start, shape))]
        if unitary:
            value = np.exp(1j * np.angle(value))
    else:
        raise ValueError("only up to 3-d whitenoise is supported")
    value = torch.from_numpy(np.ascontiguousarray(value)).to(device)
    return value if dtype is None else value.to(dtype)


def generate(Nmesh, shape, seed, unitary=False, dtype=None,
             compat='gadget', start=None, device=None):
    """Hermitian white-noise modes of a mesh of ``Nmesh``, as a complex
    tensor of ``shape`` on ``device``: the compressed half spectrum when
    the last axis is Nmesh[-1]//2+1, the full cube when it is
    Nmesh[-1].  ``start`` offsets the block in the mode cube: a rank of a
    sharded mesh fills only its own block, bitwise that block of the
    whole fill (the JAX package's ``generate_native_sharded`` and
    ``generate_gadget_sharded``)."""
    if compat == 'native':
        return generate_native(Nmesh, shape, seed, unitary, dtype, device,
                               start=start)
    if compat == 'gadget':
        return generate_gadget(Nmesh, shape, seed, unitary, dtype,
                               start=start, device=device)
    raise ValueError("compat must be 'gadget' or 'native'")
