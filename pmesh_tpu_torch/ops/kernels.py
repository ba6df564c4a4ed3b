"""Resampling window kernels, on torch tensors.

Counterpart of ``pmesh_tpu/ops/kernels.py``: each window is a
:class:`Window` carrying elementwise torch functions ``kernel(x)`` and
``diff(x)`` (and, for the analytic ones, ``fwindow(w)``).

Tabulated kernels (lanczos*, acg*, db*, sym*) regenerate their lookup
tables with numpy from the defining math on first use; lookups are
linear interpolation and ``diff`` is the table forward-difference.  A
tabulated window also keeps its table (``table``, ``table_step`` and
``table_offset``) so a CUDA kernel can read the same numbers.
"""
import functools
from math import comb

import numpy as np
import torch

__all__ = ["Window", "windows", "find_window", "ANALYTIC_BASE"]


def _sinc_unnormed(x):
    """sin(x)/x with the |x|<1e-5 series, so fwindow agrees at w=0."""
    x2 = x * x
    small = 1.0 - x2 / 6.0 + x2 * x2 / 120.0
    near0 = x.abs() < 1e-5
    safe = torch.where(near0, torch.ones_like(x), x)
    return torch.where(near0, small, torch.sin(safe) / safe)


class Window(object):
    """A resampling window: kernel, derivative and Fourier transform.

    Attributes
    ----------
    kind : str
        canonical name, e.g. 'cic'.
    support : int
        support in grid cells (the native support, or the ceiling of
        the support given to :meth:`resize`).
    nativesupport : int
        the support the kernel functions are written for.
    table, table_step, table_offset :
        the lookup table of a tabulated window (numpy f8), its spacing,
        and None for a table addressed by |x| or the half support for a
        one-sided table addressed from -support/2; table is None for
        the analytic windows.
    """

    def __init__(self, kind, support, kernel, diff, fwindow=None,
                 table=None, table_step=None, table_offset=None):
        self.kind = kind
        self.support = int(support)
        self.nativesupport = int(support)
        self.kernel = kernel
        self.diff = diff
        self._fwindow = fwindow
        self.table = table
        self.table_step = table_step
        self.table_offset = table_offset

    def __repr__(self):
        return "Window(%s, support=%d)" % (self.kind, self.support)

    def resize(self, support):
        """A copy of this window stretched to cover ``support`` cells."""
        w = Window(self.kind, self.nativesupport, self.kernel, self.diff,
                   self._fwindow, self.table, self.table_step,
                   self.table_offset)
        w.support = int(np.ceil(support))
        w._support_float = float(support)
        return w

    @property
    def support_float(self):
        return getattr(self, '_support_float', float(self.support))

    def get_fwindow(self, w):
        """1-d Fourier window T(w) at circular frequency w (1 where the
        window has no closed form), for the resized support too."""
        w = torch.as_tensor(w)
        if self._fwindow is None:
            return torch.ones_like(w, dtype=torch.float64)
        return self._fwindow(w / (self.nativesupport / self.support_float))

    def get_compensation(self):
        """The deconvolution filter of this window, for
        ``ComplexField.apply(kind='circular')``."""
        def function(w, v):
            tf = 1.0
            for wi in w:
                tf = tf * self.get_fwindow(wi)
            return v / tf
        return function


# ---------------------------------------------------------------------------
# Analytic kernels
# ---------------------------------------------------------------------------

def _nearest_kernel(x):
    return ((x < 0.5) & (x >= -0.5)).to(x.dtype)


def _nearest_diff(x):
    return torch.zeros_like(x)


def _nearest_fwindow(w):
    return _sinc_unnormed(0.5 * w)


def _linear_kernel(x):
    x = x.abs()
    return torch.where(x < 1.0, 1.0 - x, 0.0)


def _linear_diff(x):
    return torch.where(x.abs() < 1.0, torch.sign(-x), 0.0)


def _linear_fwindow(w):
    t = _sinc_unnormed(0.5 * w)
    return t * t


def _quadratic_kernel(x):
    x = x.abs()
    inner = 0.75 - x * x
    t = 1.5 - x
    outer = 0.5 * t * t
    return torch.where(x <= 0.5, inner, torch.where(x < 1.5, outer, 0.0))


def _quadratic_diff(x):
    factor = torch.where(x < 0, -1.0, 1.0).to(x.dtype)
    x = x.abs()
    inner = -2.0 * x
    outer = -(1.5 - x)
    return factor * torch.where(x <= 0.5, inner,
                                torch.where(x < 1.5, outer, 0.0))


def _quadratic_fwindow(w):
    t = _sinc_unnormed(0.5 * w)
    return t * t * t


def _cubic_kernel(x):
    x = x.abs()
    xx = x * x
    inner = (4.0 - 6.0 * xx + 3.0 * xx * x) / 6.0
    t = 2.0 - x
    outer = t * t * t / 6.0
    return torch.where(x < 1.0, inner, torch.where(x < 2.0, outer, 0.0))


def _cubic_diff(x):
    factor = torch.where(x < 0, -1.0, 1.0).to(x.dtype)
    x = x.abs()
    xx = x * x
    inner = (-12.0 * x + 9.0 * xx) / 6.0
    t = 2.0 - x
    outer = -0.5 * t * t
    return factor * torch.where(x < 1.0, inner,
                                torch.where(x < 2.0, outer, 0.0))


def _cubic_fwindow(w):
    t = _sinc_unnormed(0.5 * w)
    return t * t * t * t


# ---------------------------------------------------------------------------
# Tabulated kernels: tables built with numpy, torch linear interpolation
# with the edge conventions of the JAX package's tables.
# ---------------------------------------------------------------------------

def _lookup(table, x, i, frac, valid):
    t = torch.as_tensor(table, device=x.device)
    i_safe = i.clamp(0, len(table) - 2)
    v = t[i_safe] * (1 - frac) + t[i_safe + 1] * frac
    return torch.where(valid, v, 0.0)


def _table_diff(table, i, valid, factor, step, device):
    t = torch.as_tensor(table, device=device)
    i_safe = i.clamp(0, len(table) - 2)
    d = t[i_safe + 1] - t[i_safe]
    return torch.where(valid, factor * d / step, 0.0)


def _table_kernel(table, step):
    n = len(table)

    def kernel(x):
        f = x.abs() / step
        i = torch.floor(f).to(torch.int32)
        frac = f - i
        return _lookup(table, x, i, frac, (i >= 0) & (i < n - 1))

    def diff(x):
        factor = torch.where(x >= 0, 1.0, -1.0)
        i = (x.abs() / step).to(torch.int32)
        return _table_diff(table, i, (i >= 0) & (i < n - 1), factor,
                           step, x.device)

    return kernel, diff


def _offset_table_kernel(table, step, hsupport):
    """One-sided table addressed from -hsupport (the wavelets)."""
    n = len(table)

    def kernel(x):
        f = (x + hsupport) / step
        i = torch.floor(f).to(torch.int32)
        frac = f - i
        return _lookup(table, x, i, frac, (f >= 0) & (i < n - 1))

    def diff(x):
        i = ((x + hsupport) / step).to(torch.int32)
        return _table_diff(table, i, (i >= 0) & (i < n - 1), 1.0, step,
                           x.device)

    return kernel, diff


def _lanczos_table(n):
    x = np.linspace(0, n, 8192, endpoint=False)
    phi = np.sinc(x) * np.sinc(x / n)
    phi /= 2 * np.trapezoid(phi, x)
    step = np.diff(x).mean()
    return phi, step


def _acg_table(n):
    """approximate confined gaussian"""
    s = 1.0
    A = (n - 1) / 2.0
    x = np.linspace(0, n * 0.5, 8192, endpoint=True)
    y = x + A

    def G(y):
        return np.exp(-0.25 * ((y - A) / s) ** 2)

    phi = G(y) - G(-0.5) * (G(y + n) + G(y - n)) / (G(-0.5 + n) + G(-0.5 - n))
    phi /= 2 * np.trapezoid(phi, x)
    step = np.diff(x).mean()
    return phi, step


def _daubechies_filters(p, symlet=False):
    """The length-2p orthonormal scaling filter with p vanishing
    moments by spectral factorization; symlet=True picks the roots of
    flattest phase instead of the minimum-phase set."""
    Pcoef = np.array([comb(p - 1 + k, k) for k in range(p - 1, -1, -1)],
                     dtype=float)
    yroots = np.roots(Pcoef)
    # each y root maps to a pair of z roots via y = (2 - z - 1/z)/4
    zroots = np.array([np.roots([1.0, 4.0 * y - 2.0, 1.0])
                       for y in yroots])

    def build(selection):
        sel = []
        for i, pair in enumerate(zroots):
            inside = pair[np.argmin(np.abs(pair))]
            outside = pair[np.argmax(np.abs(pair))]
            sel.append(inside if selection[i] else outside)
        poly = np.poly(np.array(sel))
        binom = np.array([comb(p, k) for k in range(p + 1)], dtype=float)
        h = np.convolve(binom, poly.real)
        return h / h.sum() * np.sqrt(2.0)

    nz = len(zroots)
    if not symlet:
        return build([True] * nz)

    # symlet: flip complex-conjugate groups together
    used = np.zeros(nz, dtype=bool)
    groups = []
    for i in range(nz):
        if used[i]:
            continue
        grp = [i]
        used[i] = True
        for j in range(i + 1, nz):
            if not used[j] and abs(yroots[j] - np.conj(yroots[i])) < 1e-8 \
                    and abs(yroots[i].imag) > 1e-12:
                grp.append(j)
                used[j] = True
                break
        groups.append(grp)

    best, best_score = None, np.inf
    for mask in range(1 << len(groups)):
        selection = [True] * nz
        for gi, grp in enumerate(groups):
            for idx in grp:
                selection[idx] = bool((mask >> gi) & 1)
        h = build(selection)
        if (np.abs(h.imag).max() if np.iscomplexobj(h) else 0) > 1e-8:
            continue
        h = np.real(h)
        wgrid = np.linspace(0.01, np.pi - 0.01, 128)
        H = np.polyval(h[::-1], np.exp(-1j * wgrid))
        phase = np.unwrap(np.angle(H * np.exp(1j * wgrid * (len(h) - 1) / 2)))
        score = np.abs(phase).max()
        if score < best_score:
            best_score, best = score, h
    return best


@functools.lru_cache(None)
def _wavelet_table(family, length):
    """Cascade-algorithm scaling function table for dbN / symN:
    level-8 cascade, midpoint average, trimmed where |phi| < 2e-3."""
    p = length // 2
    h = _daubechies_filters(p, symlet=(family == 'sym'))
    level = 8
    phi = np.array([1.0])
    for _ in range(level):
        up = np.zeros(2 * len(phi) - 1)
        up[::2] = phi
        phi = np.sqrt(2.0) * np.convolve(h, up)
    step = 2.0 ** -level
    x = np.arange(len(phi)) * step
    phi = phi / (phi.sum() * step)
    phi = (phi[1:] + phi[:-1]) * 0.5
    i = 0
    while abs(phi[i]) < 2e-3:
        i += 1
    phi = phi[i:]
    j = len(phi)
    while abs(phi[j - 1]) < 2e-3:
        j -= 1
    support = int(np.ceil(x[j]))
    i = (x < support).sum()
    phi = phi[:i // 4 * 4 + 4]
    return phi, step, support


def _make_tabulated(name):
    if name.startswith('lanczos') or name.startswith('acg'):
        lanczos = name.startswith('lanczos')
        n = int(name[len('lanczos' if lanczos else 'acg'):])
        phi, step = _lanczos_table(n) if lanczos else _acg_table(n)
        kernel, diff = _table_kernel(phi, step)
        return Window(name, 2 * n if lanczos else n, kernel, diff,
                      table=phi, table_step=float(step))
    family = 'db' if name.startswith('db') else 'sym'
    phi, step, support = _wavelet_table(family, int(name[len(family):]))
    kernel, diff = _offset_table_kernel(phi, step, support * 0.5)
    return Window(name, support, kernel, diff, table=phi,
                  table_step=float(step), table_offset=support * 0.5)


# the analytic base window of every analytic name and alias
ANALYTIC_BASE = {
    'nearest': 'nearest', 'tunednnb': 'nearest', 'nnb': 'nearest',
    'linear': 'linear', 'tunedcic': 'linear', 'cic': 'linear',
    'quadratic': 'quadratic', 'tunedtsc': 'quadratic', 'tsc': 'quadratic',
    'cubic': 'cubic', 'tunedpcs': 'cubic', 'pcs': 'cubic',
}

_ANALYTIC = {
    'nearest': (1, _nearest_kernel, _nearest_diff, _nearest_fwindow),
    'linear': (2, _linear_kernel, _linear_diff, _linear_fwindow),
    'quadratic': (3, _quadratic_kernel, _quadratic_diff,
                  _quadratic_fwindow),
    'cubic': (4, _cubic_kernel, _cubic_diff, _cubic_fwindow),
}

_TABULATED = (['lanczos%d' % n for n in range(2, 7)]
              + ['acg%d' % n for n in range(2, 7)]
              + ['db6', 'db12', 'db20', 'sym6', 'sym12', 'sym20'])


class _LazyWindows(dict):
    """The registry of 24 windows; tabulated entries are built on
    first access."""

    def __missing__(self, key):
        key = key.lower()
        if key in ANALYTIC_BASE:
            w = Window(key, *_ANALYTIC[ANALYTIC_BASE[key]])
        elif key in _TABULATED:
            w = _make_tabulated(key)
        else:
            raise KeyError(key)
        self[key] = w
        return w

    def __contains__(self, key):
        k = str(key).lower()
        return k in ANALYTIC_BASE or k in _TABULATED


windows = _LazyWindows()


def find_window(window):
    """Resolve a window name or Window object."""
    if isinstance(window, Window):
        return window
    if isinstance(window, str) and window in windows:
        return windows[window]
    raise TypeError(
        "argument is not a window name or a Window object: %r" % (window,))
