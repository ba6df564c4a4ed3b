"""The slab decomposition over torch.distributed: ProcessMesh, the
collectives, the halo exchange, the slab FFT and the rank launcher;
and the single-domain Layout of ``domain.py``."""
