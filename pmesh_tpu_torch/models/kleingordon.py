"""Semi-implicit spectral Klein-Gordon solver.

Counterpart of ``pmesh_tpu/models/kleingordon.py`` (the Ding 2006
ring-soliton setup with the semi-implicit scheme).  The state lives in
k-space with one c2r + r2c per step for the nonlinear term:

    u_n = [ r2c(F(c2r(u_{n-1}))) - T1 u_{n-1} ] / T  - u_{n-2}
    T1(k) = (-1/dt^2 + k^2/4 + 1/4),  T(k) = (1/dt^2 + k^2/4 + 1/4)

A Python loop over the steps replaces the JAX package's ``lax.scan``;
with a uniform step, k^2, T1 and T are formed once as whole k-space
tensors, as the JAX package precomputes them (a monitor does not change
them).
"""
import numpy as np
import torch

from ..pm import ParticleMesh, RealField

__all__ = ["kgsolver", "ring_soliton_ic"]


def kgsolver(steps, u_0, du_0, F=lambda u: -u ** 3, monitor=None):
    """Integrate u_tt = Nabla^2 u - u + F(u).

    ``steps`` is the time grid (steps[0] = initial time), ``u_0`` /
    ``du_0`` the initial field and time derivative (RealFields);
    ``F`` takes and returns a tensor of the real mesh (or a RealField),
    ``monitor(t, dt, u_k, du_k)`` sees the complex fields of each step.
    Returns the final RealField.
    """
    pm = u_0.pm
    steps = np.asarray(steps, dtype='f8')
    dsteps = np.diff(steps)

    k2 = pm._apply_coords(type(u_0.r2c()), 'wavenumber').normp(2)

    u_k_n_2 = u_0.r2c().value
    u_k_n_1 = (u_0 + du_0 * float(dsteps[0])).r2c().value

    if monitor:
        monitor(steps[0], dsteps[0],
                pm.create(type='complex', value=u_k_n_2), du_0.r2c())

    def make_factors(dt):
        T1 = (-1.0 / dt ** 2 + k2 / 4.0 + 0.25)
        T = (1.0 / dt ** 2 + k2 / 4.0 + 0.25)
        return T1, T

    def one_step(u1, u2, T1, T):
        # u1 = u_{n-1} (k-space), u2 = u_{n-2}
        fr = F(pm._c2r_value(u1))
        fk = pm._r2c_value(fr.value if isinstance(fr, RealField) else fr)
        return (fk - T1 * u1) / T - u2

    uniform = np.allclose(dsteps[1:], dsteps[1]) if len(dsteps) > 2 \
        else True
    fixed = make_factors(float(dsteps[1])) if uniform and len(dsteps) > 1 \
        else None

    u_k_n = u_k_n_1
    for t, dt in zip(steps[1:], dsteps[1:]):
        T1, T = fixed or make_factors(float(dt))
        u_k_n = one_step(u_k_n_1, u_k_n_2, T1, T)
        if monitor:
            monitor(t, dt, pm.create(type='complex', value=u_k_n_1),
                    pm.create(type='complex',
                              value=(u_k_n - u_k_n_1) / float(dt)))
        u_k_n_2 = u_k_n_1
        u_k_n_1 = u_k_n

    if monitor:
        dt = float(dsteps[-1])
        monitor(steps[-1], 0,
                pm.create(type='complex', value=u_k_n_1),
                pm.create(type='complex', value=(u_k_n - u_k_n_2) / dt))

    return pm.create(type='complex', value=u_k_n).c2r()


def ring_soliton_ic(pm):
    """The Ding 2006 ring solitary initial condition: u = 4 arctan(exp(3
    - r^2)), r from the box centre; du = 0.  Returns (u, du)."""
    def transfer(i, v):
        r = [(ii.to(torch.float64) - 0.5 * int(ni)) * float(Li / ni)
             for ii, ni, Li in zip(i, pm.Nmesh, pm.BoxSize)]
        r2 = sum(ri ** 2 for ri in r)
        return 4.0 * torch.arctan(torch.exp(3 - r2))
    u = pm.create(type='real').apply(transfer, kind='index')
    du = pm.create(type='real')
    return u, du


def main(argv=None):
    from argparse import ArgumentParser
    ap = ArgumentParser(description="Klein-Gordon spectral solver demo")
    ap.add_argument("--ndim", type=int, choices=[2, 3], default=2)
    ap.add_argument("--nmesh", type=int, default=256)
    ap.add_argument("--steps", type=int, default=321)
    ap.add_argument("--tmax", type=float, default=16.0)
    ap.add_argument("--output", type=str, default=None,
                    help="npz file for final-state previews")
    ap.add_argument("--device", type=str, default=None,
                    help="torch device (default the current CUDA device)")
    ns = ap.parse_args(argv)

    pm = ParticleMesh(BoxSize=32.0, Nmesh=[ns.nmesh] * ns.ndim,
                      device=ns.device)
    u, du = ring_soliton_ic(pm)
    steps = np.linspace(0, ns.tmax, ns.steps, endpoint=True)

    def monitor(t, dt, u_k, dv_k):
        norm = float(u_k.cnorm())
        print("---- timestep %5.3f, step size %5.4f; |u_k| = %g"
              % (t, dt, norm))

    u_final = kgsolver(steps, u, du, torch.sin, monitor=monitor)
    if ns.output:
        preview = u_final.preview(axes=(0, 1))
        np.savez(ns.output, u=preview)
        print("saved preview to", ns.output)
    return u_final


if __name__ == '__main__':
    main()
