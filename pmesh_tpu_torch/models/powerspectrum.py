"""Linear matter power spectra for initial conditions.

Counterpart of ``pmesh_tpu/models/powerspectrum.py``:

- :class:`EHPower`: the Eisenstein & Hu (1998) no-wiggle transfer
  function, normalized to the cosmology's sigma8;
- :class:`PowerSpectrum`: a (k, P) table, log-log interpolated, with an
  optional sigma8 renormalization;
- :func:`sigma_r` and :func:`normalize_sigma8`.

Each P(k) is called on a torch tensor of k (on any device) and returns
a tensor there: EHPower in k's dtype, the table in f8.
"""
import numpy as np
import torch

__all__ = ["EHPower", "PowerSpectrum", "normalize_sigma8", "sigma_r"]


def _tophat_w(x):
    x = torch.where(x == 0, 1e-8, x)
    return 3.0 / x ** 3 * (torch.sin(x) - x * torch.cos(x))


def sigma_r(power, r=8.0, kmin=1e-5, kmax=1e2, n=1024):
    """sigma(R) of a P(k) callable by log-trapezoid quadrature on the
    host, in f8."""
    lnk = torch.from_numpy(np.linspace(np.log(kmin), np.log(kmax), n))
    k = torch.exp(lnk)
    integrand = power(k) * k ** 3 * _tophat_w(k * r) ** 2 \
        / (2 * np.pi ** 2)
    return torch.sqrt(torch.trapezoid(integrand, lnk))


def normalize_sigma8(power, sigma8):
    """A rescaled P(k) with the requested sigma8."""
    amp = (sigma8 / float(sigma_r(power, 8.0))) ** 2

    def scaled(k):
        return power(k) * amp
    return scaled


def _interp(x, xp, fp):
    """jnp.interp: linear interpolation of (xp, fp) at x, clamped to
    the end values outside xp."""
    i = torch.clamp(torch.searchsorted(xp, x, right=True), 1, len(xp) - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    dx0 = dx.abs() <= np.spacing(np.finfo(np.float64).eps)
    f = torch.where(dx0, fp[i - 1],
                    fp[i - 1] + (delta / torch.where(dx0, 1.0, dx)) * df)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


class EHPower(object):
    """Eisenstein & Hu (1998) zero-baryon transfer-function power
    spectrum at a redshift:  P(k) = A k^ns T(k)^2 D1(z)^2, normalized to
    cosmology.sigma8 at z=0.  k in h/Mpc, P in (Mpc/h)^3."""

    def __init__(self, cosmology, redshift=0.0):
        self.c = cosmology
        self.redshift = float(redshift)
        om, ob, h = cosmology.Om0, cosmology.Ob0, cosmology.h
        theta = 2.728 / 2.7  # CMB temperature in 2.7K units
        # Eisenstein & Hu 1998 eq 26, 28, 29-31 (shape parameters)
        self._s = 44.5 * np.log(9.83 / (om * h * h)) / \
            np.sqrt(1 + 10 * (ob * h * h) ** 0.75)
        self._alpha = (1 - 0.328 * np.log(431 * om * h * h) * ob / om
                       + 0.38 * np.log(22.3 * om * h * h) * (ob / om) ** 2)
        self._omhh = om * h * h
        self._theta2 = theta * theta
        self._h = h
        # normalize at z=0 to sigma8
        self._amp = 1.0
        self._amp = (cosmology.sigma8 / float(sigma_r(self._raw))) ** 2
        self._growth = float(cosmology.D1(1.0 / (1 + self.redshift)))

    def _transfer(self, k):
        # k in h/Mpc; EH98 eqs 28-31 (no-wiggle)
        ks = k * self._h * self._s / self._h  # s is in Mpc/h already
        gamma_eff = self._omhh / self._h * (
            self._alpha + (1 - self._alpha) / (1 + (0.43 * ks) ** 4))
        q = k * self._theta2 / gamma_eff
        L0 = torch.log(2 * np.e + 1.8 * q)
        C0 = 14.2 + 731.0 / (1 + 62.5 * q)
        return L0 / (L0 + C0 * q * q)

    def _raw(self, k):
        k = torch.as_tensor(k)
        kk = torch.where(k == 0, 1e-8, k)
        p = self._amp * kk ** self.c.ns * self._transfer(kk) ** 2
        return torch.where(k == 0, 0.0, p)

    def __call__(self, k):
        return self._raw(k) * self._growth ** 2


class PowerSpectrum(object):
    """Tabulated P(k), log-log interpolated; ``sigma8`` renormalizes."""

    def __init__(self, k, p, sigma8=None):
        k = np.asarray(k, dtype='f8')
        p = np.asarray(p, dtype='f8')
        mask = (k > 0) & (p > 0)
        self._lnk = torch.from_numpy(np.log(k[mask]))
        self._lnp = torch.from_numpy(np.log(p[mask]))
        self.amp = 1.0
        if sigma8 is not None:
            self.amp = (sigma8 / float(sigma_r(self))) ** 2

    @classmethod
    def from_file(cls, filename, sigma8=None):
        data = np.loadtxt(filename)
        return cls(data[:, 0], data[:, 1], sigma8=sigma8)

    def __call__(self, k):
        k = torch.as_tensor(k)
        lnx = torch.log(torch.where(k <= 0, 1e-8, k)).to(torch.float64)
        lnk, lnp = self._lnk.to(k.device), self._lnp.to(k.device)
        p = torch.exp(_interp(lnx, lnk, lnp))
        return torch.where(k <= 0, 0.0, self.amp * p)

    def PofK(self, k):
        return self(k)
