"""Cosmology background functions for the N-body solver.

Counterpart of ``pmesh_tpu/models/cosmology.py``: a flat-ish LCDM
background whose linear and second-order growth ODE is solved once at
construction with host-side RK4 on a dense log-a grid.  Everything
here is numpy on the host: the growth factors are host floats (or
numpy arrays for array input), computed before any device work.

Conventions (FastPM / nbodykit PerturbationGrowth):
  E(a)    = H(a)/H0 = sqrt(Om0 a^-3 + Ok0 a^-2 + Ol0)
  D1(a)   linear growth, normalized D1(1) = 1
  f1(a)   = dlnD1/dlna
  D2(a)   second-order growth (D2 ~ -3/7 D1^2 at early times)
  Gp = D1, gp = dD1/da, Gf = D1' a^3 E, gf = dGf/da
"""
import numpy as np

__all__ = ["Cosmology", "Planck15"]


def _out(x):
    return float(x) if np.ndim(x) == 0 else x


class Cosmology(object):
    def __init__(self, Om0=0.3089, Ol0=None, h=0.6774, sigma8=0.8159,
                 ns=0.9667, Ob0=0.0486):
        self.Om0 = float(Om0)
        self.Ol0 = float(1.0 - Om0) if Ol0 is None else float(Ol0)
        self.Ok0 = 1.0 - self.Om0 - self.Ol0
        self.h = float(h)
        self.sigma8 = float(sigma8)
        self.ns = float(ns)
        self.Ob0 = float(Ob0)
        self._solve_growth()

    # --- background ---
    def efunc(self, a):
        """E(a) = H(a) / H0."""
        a = np.asarray(a, dtype='f8')
        return _out(np.sqrt(self.Om0 * a ** -3 + self.Ok0 * a ** -2
                            + self.Ol0))

    E = efunc

    def Ea(self, z):
        """E as a function of redshift."""
        return self.efunc(1.0 / (1.0 + np.asarray(z, dtype='f8')))

    def Om(self, a):
        """The matter density parameter at a."""
        a = np.asarray(a, dtype='f8')
        return _out(self.Om0 * a ** -3 / np.asarray(self.efunc(a)) ** 2)

    # --- growth ODE ---
    def _solve_growth(self):
        # in x = lna:  D,xx + (2 + dlnE/dlna) D,x = 3/2 Om(a) D, and
        # D2,xx + (2 + dlnE/dlna) D2,x = 3/2 Om(a) (D2 - D1^2)
        lna = np.linspace(np.log(1e-4), np.log(2.0), 2048)
        dx = lna[1] - lna[0]

        def rhs(x, y):
            a = np.exp(x)
            D1, dD1, D2, dD2 = y
            E2 = self.Om0 * a ** -3 + self.Ok0 * a ** -2 + self.Ol0
            om = self.Om0 * a ** -3 / E2
            fric = 2.0 + 0.5 * (-3 * self.Om0 * a ** -3
                                - 2 * self.Ok0 * a ** -2) / E2
            return np.array([
                dD1,
                -fric * dD1 + 1.5 * om * D1,
                dD2,
                -fric * dD2 + 1.5 * om * (D2 - D1 ** 2),
            ])

        # matter-dominated initial conditions: D1 ~ a, D2 ~ -3/7 a^2
        a0 = np.exp(lna[0])
        y = np.array([a0, a0, -3.0 / 7.0 * a0 ** 2, -6.0 / 7.0 * a0 ** 2])
        table = np.zeros((len(lna), 4))
        table[0] = y
        for i in range(1, len(lna)):
            x = lna[i - 1]
            k1 = rhs(x, y)
            k2 = rhs(x + dx / 2, y + dx / 2 * k1)
            k3 = rhs(x + dx / 2, y + dx / 2 * k2)
            k4 = rhs(x + dx, y + dx * k3)
            y = y + dx / 6 * (k1 + 2 * k2 + 2 * k3 + k4)
            table[i] = y
        D1, dD1, D2, dD2 = table.T

        # normalize D1(a=1) = 1, D2 consistently (D2/D1^2 invariant)
        norm = np.interp(0.0, lna, D1)
        D1, dD1 = D1 / norm, dD1 / norm
        D2, dD2 = D2 / norm ** 2, dD2 / norm ** 2
        self._lna = lna
        self._D1 = D1
        self._f1 = dD1 / D1
        self._D2 = D2
        self._f2 = dD2 / D2

    def _interp(self, table, a):
        return _out(np.interp(np.log(np.asarray(a, dtype='f8')),
                              self._lna, table))

    def D1(self, a):
        """Linear growth factor, D1(1) = 1."""
        return self._interp(self._D1, a)

    def f1(self, a):
        """Linear growth rate dlnD1/dlna."""
        return self._interp(self._f1, a)

    def D2(self, a):
        """Second-order growth factor (negative, ~ -3/7 D1^2)."""
        return self._interp(self._D2, a)

    def f2(self, a):
        return self._interp(self._f2, a)

    # --- FastPM / nbodykit PerturbationGrowth interface ---
    def Gp(self, a):
        return self.D1(a)

    def gp(self, a):
        # dD1/da = D1 f1 / a
        a = np.asarray(a, dtype='f8')
        return _out(np.asarray(self.D1(a)) * self.f1(a) / a)

    def Gf(self, a):
        # D1'(a) a^3 E(a)
        a = np.asarray(a, dtype='f8')
        return _out(np.asarray(self.gp(a)) * a ** 3 * self.E(a))

    def gf(self, a):
        # dGf/da by central difference of Gf
        a = np.asarray(a, dtype='f8')
        eps = 1e-4
        return _out((np.asarray(self.Gf(a * (1 + eps)))
                     - self.Gf(a * (1 - eps))) / (2 * eps * a))

    # the same for the second-order growth
    def Gp2(self, a):
        return self.D2(a)

    def gp2(self, a):
        a = np.asarray(a, dtype='f8')
        return _out(np.asarray(self.D2(a)) * self.f2(a) / a)

    def Gf2(self, a):
        a = np.asarray(a, dtype='f8')
        return _out(np.asarray(self.gp2(a)) * a ** 3 * self.E(a))

    def gf2(self, a):
        a = np.asarray(a, dtype='f8')
        eps = 1e-4
        return _out((np.asarray(self.Gf2(a * (1 + eps)))
                     - self.Gf2(a * (1 - eps))) / (2 * eps * a))


Planck15 = Cosmology(Om0=0.3089, h=0.6774, sigma8=0.8159, ns=0.9667,
                     Ob0=0.0486)
