"""QPM-style KDK particle-mesh N-body with snapshot events.

Counterpart of ``pmesh_tpu/models/qpm.py``: the kick-drift-kick
leapfrog over log a with trapezoid time integrals, the PM force chain
of k-space transfers (RemoveDC, CIC decompensation, Gaussian smoothing,
Poisson, SuperLanczos differentiation) through the generic paint and
readout, and the generator ``run`` yielding PM_STEP_DONE /
WRITE_SNAPSHOT / FINISHED events.  The particle dict ``P`` holds
(N, 3) tensors on the mesh's device (default the current CUDA device).

Units: time 98000 Myear/h, distance Mpc/h, speed km/s, mass 1e10
Msun/h; G = 43007.1, H0 = 100.
"""
import numpy as np
import torch

from ..pm import ParticleMesh
from ..ops import transfer as tf
from ..ops import paint as _paint_ops
from .cosmology import Planck15

__all__ = ["QPM"]


class QPM(object):
    G = 43007.1
    H0 = 100.
    PM_STEP_DONE = 1
    WRITE_SNAPSHOT = 2
    FINISHED = 3

    def __init__(self, CPARAM, BoxSize, Nmesh, a0, comm=None,
                 resampler='cic', dtype='f4', device=None):
        self.CPARAM = CPARAM if CPARAM is not None else Planck15
        self.a0 = a0
        self.Nmesh = Nmesh
        self.BoxSize = BoxSize
        self.pm = ParticleMesh(BoxSize=BoxSize, Nmesh=[Nmesh] * 3,
                               resampler=resampler, dtype=dtype,
                               device=device)

    # --- time integrals: trapezoids over log a
    def _dt_kick(self, loga0, loga1):
        g = np.linspace(loga0, loga1, 1025, endpoint=True)
        a = np.exp(g)
        E = np.asarray(self.CPARAM.Ea(1.0 / a - 1)) * self.H0
        return float(np.trapezoid(1.0 / (a * E), g))

    def _dt_drift(self, loga0, loga1):
        g = np.linspace(loga0, loga1, 1025, endpoint=True)
        a = np.exp(g)
        E = np.asarray(self.CPARAM.Ea(1.0 / a - 1)) * self.H0
        return float(np.trapezoid(1.0 / (a * a * E), g))

    def Kick(self, P, loga0, loga1):
        P['Velocity'] = P['Velocity'] + P['Accel'] * self._dt_kick(
            loga0, loga1)

    def Drift(self, P, loga0, loga1):
        pos = P['Position'] + P['Velocity'] * self._dt_drift(loga0, loga1)
        P['Position'] = torch.remainder(pos, self.BoxSize)

    def Accel(self, P):
        """The PM force: paint -> [CIC decompensation, RemoveDC,
        Gaussian, Poisson, 4 pi G] -> each direction's SuperLanczos
        gradient -> one readout of the three meshes; the acceleration is
        minus that gradient."""
        pm = self.pm
        smoothing_cells = 1.25
        pos = P['Position']
        layout = pm.decompose(pos)
        rho = pm.paint(pos, mass=P.get('Mass', 1.0), layout=layout)
        rhok = rho.r2c()

        cellsize = float(pm.BoxSize[0] / pm.Nmesh[0])

        def chain(k, v):
            v = tf.remove_dc()(k, v)
            v = tf.gaussian(smoothing_cells * cellsize)(k, v)
            v = tf.poisson()(k, v)
            return v * (4 * np.pi * self.G)

        rhok = rhok.apply(tf.cic_decompensate(2), kind='circular')
        rhok = rhok.apply(chain)

        meshes = tuple(
            rhok.apply(tf.gradient(d, order=1)).c2r().value
            for d in range(3))
        a = pm.affine
        vals = _paint_ops.readout(meshes, pos,
                                  window=pm.resampler.window,
                                  scale=a.scale, translate=a.translate,
                                  period=a.period)
        P['Accel'] = -torch.stack(vals, dim=-1)

    def run(self, P, aout=[]):
        """The run loop; yields (PM_STEP_DONE, a) after each full step,
        (WRITE_SNAPSHOT, a) with the positions drifted to each output
        time, and (FINISHED, a) at the end."""
        logaout = np.sort(np.log(np.asarray(aout))) if len(aout) \
            else np.array([])

        dloga = 0.1
        timesteps = list(np.arange(np.log(self.a0), 0.0, dloga))
        if len(timesteps) == 0:
            timesteps.append(np.log(self.a0))
        if timesteps[-1] < 0.0:
            # land the final step exactly on a = 1 (log a = 0)
            timesteps.append(0.0)

        loga1 = timesteps[0]
        loga2 = timesteps[0]
        for istep in range(len(timesteps)):
            self.Accel(P)

            if istep > 0:
                # KickB: vel from n+1/2 to n+1
                self.Kick(P, 0.5 * (loga1 + loga2), loga2)

            loga1 = timesteps[istep]

            if istep == len(timesteps) - 1:
                break
            if len(logaout) and loga1 > logaout.max():
                break

            yield self.PM_STEP_DONE, np.exp(loga1)

            loga2 = timesteps[istep + 1]

            # KickA: vel n -> n+1/2
            self.Kick(P, loga1, 0.5 * (loga1 + loga2))

            # drift with snapshot interruptions
            if len(logaout):
                left = logaout.searchsorted(loga1, side='left')
                right = logaout.searchsorted(loga2, side='right')
            else:
                left = right = 0

            if left != right:
                self.Drift(P, loga1, logaout[left])
                yield self.WRITE_SNAPSHOT, np.exp(logaout[left])
                for i in range(left + 1, right):
                    self.Drift(P, logaout[i - 1], logaout[i])
                    yield self.WRITE_SNAPSHOT, np.exp(logaout[i])
                self.Drift(P, logaout[right - 1], loga2)
            else:
                self.Drift(P, loga1, loga2)

        yield self.FINISHED, np.exp(loga1)
