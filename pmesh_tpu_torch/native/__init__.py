from . import cuda  # noqa: F401
