"""Deprecated compatibility APIs.

Counterpart of ``pmesh_tpu/legacy/``: the stateful v0 ``ParticleMesh``
(``particlemesh.py``), the ``TransferFunction`` chain library
(``transfer.py``), the standalone CIC and TSC painters (``cic.py``,
``tsc.py``), the prototype callable-window painter (``lanczos.py``) and
the MPI-era tools (``tools.py``).  Each module emits a
``DeprecationWarning`` when imported and delegates to the modern API of
this package.
"""
