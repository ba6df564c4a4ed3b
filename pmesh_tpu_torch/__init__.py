"""pmesh_tpu_torch: the PyTorch and CUDA port of pmesh_tpu.

The JAX package ``pmesh_tpu`` is the reference; this package keeps its
module names.  It holds the mesh and field API (real and c2c meshes,
the analytic vjp/jvp operators), the windows, the generic and lattice
paint and readout (the lattice ones, the binned rebase and the DFT
passes with hand-written CUDA kernels for an NVIDIA Hopper GPU), the
torch.fft transforms and transfer functions, the white noise, the
cosmology, the FastPM solver (``models/fastpm.py``), the applications
(``models/gravpm.py``, ``qpm.py``, ``kleingordon.py``, ``lic.py``) and
their utilities (``gradcheck.py``, ``utils/``).  Importing it needs
neither a GPU nor nvcc: the kernels are built at their first launch.
"""

__version__ = "0.1.0"

from .pm import (ParticleMesh, RealField, ComplexField, Field,  # noqa: F401
                 TransposedComplexField, UntransposedComplexField)
from .window import Affine, FindResampler  # noqa: F401
