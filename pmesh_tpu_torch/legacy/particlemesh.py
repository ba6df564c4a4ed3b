"""Deprecated stateful ParticleMesh (the v0 API).

Counterpart of ``pmesh_tpu/legacy/particlemesh.py``: a state machine
with internal ``real`` and ``complex`` tensors and the canonical
sequence

    pm.clear(); pm.paint(pos); pm.r2c();
    pm.transfer([...]); pm.c2r([...]); pm.readout(pos)

as a thin stateful wrapper over ``pm.ParticleMesh``, with the push/pop
stack of complex fields and the phase timers.  It takes ``device=`` as
every entry point of the port does: the current CUDA device by default
(raises without CUDA: pass ``device='cpu'``).  Positions given as numpy
arrays go to that device.
"""
import warnings

import numpy
import torch

from ..pm import ParticleMesh as _ModernPM, RealField
from ..utils.timers import Timers

warnings.warn("legacy.particlemesh.ParticleMesh is deprecated; "
              "switch to pmesh_tpu_torch.pm.ParticleMesh",
              DeprecationWarning)

__all__ = ["ParticleMesh"]


class ParticleMesh(object):

    def __init__(self, BoxSize, Nmesh, paintbrush='cic', comm=None,
                 np=None, verbose=False, dtype='f8', device=None):
        self.Nmesh = Nmesh
        self.BoxSize_scalar = BoxSize
        self._pm = _ModernPM(BoxSize=BoxSize, Nmesh=[Nmesh] * 3,
                             dtype=dtype, resampler=paintbrush,
                             device=device)
        self.comm = comm
        self.device = self._pm.device
        self.BoxSize = self._pm.BoxSize
        self.verbose = verbose
        self.T = Timers()
        self.real = torch.zeros((Nmesh,) * 3, dtype=self._pm.torch_dtype,
                                device=self.device)
        self.complex = None
        self._stack = []
        # the coordinate lists: wavenumbers k, circular frequencies w,
        # positions x and mesh units r
        self.k = self._pm.create_coords('complex')
        self.w = [ki * float(L / n) for ki, L, n in
                  zip(self.k, self.BoxSize, self._pm.Nmesh)]
        self.x = self._pm.create_coords('real')
        self.r = [xi * float(n / L) for xi, L, n in
                  zip(self.x, self.BoxSize, self._pm.Nmesh)]

    def _pos(self, pos):
        return torch.as_tensor(pos, device=self.device)

    def transform(self, x):
        """Simulation units -> local grid units."""
        a = self._pm.affine
        if isinstance(x, torch.Tensor):
            return (x * torch.as_tensor(a.scale, dtype=x.dtype,
                                        device=x.device)
                    + torch.as_tensor(a.translate, dtype=x.dtype,
                                      device=x.device))
        return a.scale * numpy.asarray(x) + a.translate

    def transform0(self, x):
        """Simulation units -> global grid units."""
        a = self._pm.affine
        if isinstance(x, torch.Tensor):
            return x * torch.as_tensor(a.scale, dtype=x.dtype,
                                       device=x.device)
        return a.scale * numpy.asarray(x)

    def decompose(self, pos):
        return self._pm.decompose(pos)

    def clear(self):
        with self.T['Clear']:
            self.real = torch.zeros_like(self.real)

    def paint(self, pos, mass=1.0):
        with self.T['Paint']:
            out = self._pm.create(type=RealField, value=self.real)
            out = self._pm.paint(self._pos(pos), mass=mass, hold=True,
                                 out=out)
            self.real = out.value

    def r2c(self, pos=None, mass=1.0):
        """Forward transform of the painted canvas; with ``pos`` given,
        clear + paint + transform in one call."""
        if pos is not None:
            self.clear()
            self.paint(pos, mass)
        with self.T['R2C']:
            field = self._pm.create(type=RealField, value=self.real)
            self.complex = field.r2c().value

    def push(self):
        """Save the current complex field on a stack."""
        self._stack.append(self.complex)

    def pop(self):
        self.complex = self._stack.pop()

    def transfer(self, transfer_functions):
        """Apply a chain of legacy TransferFunction callables, each
        f(pm, complex) -> complex."""
        with self.T['Transfer']:
            c = self.complex
            for tfunc in transfer_functions:
                c = tfunc(self, c)
            self.complex = c

    def c2r(self, transfer_functions=[]):
        """Apply transfers to a copy of complex, then inverse transform
        into real; complex is preserved."""
        c = self.complex
        for tfunc in transfer_functions:
            c = tfunc(self, c)
        with self.T['C2R']:
            field = self._pm.create(type='complex', value=c)
            self.real = field.c2r().value

    def readout(self, pos):
        with self.T['Readout']:
            field = self._pm.create(type=RealField, value=self.real)
            return field.readout(self._pos(pos))
