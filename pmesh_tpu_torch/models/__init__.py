from .cosmology import Cosmology, Planck15  # noqa: F401
from .fastpm import Solver  # noqa: F401
