"""pmesh_tpu_torch: the PyTorch and CUDA port of pmesh_tpu.

The JAX package ``pmesh_tpu`` is the reference; this package keeps its
module names.  It holds the FastPM lattice N-body path: the mesh and
field API that path uses, the windows, the lattice paint and readout
(with hand-written CUDA kernels for an NVIDIA Hopper GPU), the
torch.fft transforms and transfer functions, the cosmology and the
solver (``models/fastpm.py``).  Importing it needs neither a GPU nor
nvcc: the kernels are built at their first launch.
"""

__version__ = "0.1.0"

from .pm import ParticleMesh, RealField, ComplexField, Field  # noqa: F401
from .window import Affine, FindResampler  # noqa: F401
