"""The Layout routing plan of a domain decomposition: the single-domain
plan.

Counterpart of the single-device part of ``pmesh_tpu/parallel/
domain.py`` (``Layout``, l.69-140): on one device every particle already
sees the whole mesh, so the plan is trivial and its ``exchange``,
``exchange_scalar`` and ``gather`` are identities.  The multi-domain
plans (``GridND`` and the sharded ghost exchange) are not ported
(ROADMAP queue 1, item 8); ``ParticleMesh.decompose`` raises on a
sharded mesh.
"""

__all__ = ["Layout"]


class Layout(object):
    """The trivial routing plan of ``npart`` particles on one domain."""

    def __init__(self, npart, smoothing=0):
        self.npart = int(npart)
        self.smoothing = smoothing

    def exchange(self, *args):
        """Deliver data to the domains: the data itself (one argument),
        or the tuple of the arguments."""
        if not args:
            return None
        return args[0] if len(args) == 1 else tuple(args)

    def exchange_scalar(self, value):
        return value

    def gather(self, data, mode='sum'):
        """Reduce images back to their particles: one image each, so the
        data itself for every mode ('sum', 'mean', 'any', 'all',
        'local')."""
        if mode not in ('sum', 'mean', 'any', 'all', 'local'):
            raise NotImplementedError(mode)
        return data
