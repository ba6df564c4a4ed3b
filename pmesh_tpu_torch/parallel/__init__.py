"""The decompositions over torch.distributed: ProcessMesh (the 1-d slab
grid and the 2-d pencil grid), the collectives, the halo exchange, the
slab and pencil FFTs, the particle ghost exchanges (1-d and 2-d) and the
rank launcher; and the single-domain Layout of ``domain.py``."""
