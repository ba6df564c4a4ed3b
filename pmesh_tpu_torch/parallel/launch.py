"""Start P ranks of a function: the port's counterpart of the JAX
tests' virtual 8-device mesh.

    results = spawn('module:function', world, 'gloo', None, *args)

runs ``function(pm, *args)`` in ``world`` fresh processes
(``torch.multiprocessing``, spawn start method), each with its
``ProcessMesh`` ``pm`` over an initialized process group (the 1-d grid,
or with ``shape=(npx, npy)`` the 2-d pencil grid), and returns
the ranks' return values in rank order.  A child imports the named
module and what it imports, nothing of its caller's but the main
module (which the spawn start method re-imports: a script that spawns
needs an ``if __name__ == '__main__':`` guard).

The rendezvous is a ``file://`` store in a fresh temporary directory,
so jobs never contend for a TCP port.  The ranks run on the GPU unless
``device='cpu'`` is given, as ``ProcessMesh`` does: rank r on the card
r % device count (with one card, every rank on it; NCCL refuses that,
so such jobs run over gloo); without CUDA and with no device named,
``spawn`` raises before it starts a process.  Return values travel
back through ``torch.save`` files in the same directory.  A rank that raises makes ``spawn`` raise with its
traceback; the other ranks are terminated.
"""
import datetime
import importlib
import os
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from .pmesh import ProcessMesh, _default_device

__all__ = ["spawn", "resolve"]

# seconds any collective may wait before the job fails
TIMEOUT = 900


def resolve(fn_name):
    """the function named 'module:function'"""
    mod, sep, name = fn_name.rpartition(":")
    if not (mod and sep and name):
        raise ValueError("name the rank function as 'module:function' "
                         "(got %r)" % fn_name)
    return getattr(importlib.import_module(mod), name)


def _entry(rank, fn_name, world, backend, device, tmp, args, shape,
           timeout):
    dev = torch.device(device)
    if dev.type == 'cuda':
        dev = torch.device('cuda', rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    else:
        # the host's cores shared among the ranks
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    dist.init_process_group(
        backend, init_method="file://" + os.path.join(tmp, "rendezvous"),
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=timeout))
    try:
        pm = ProcessMesh(device=dev, shape=shape)
        out = resolve(fn_name)(pm, *args)
        torch.save(out, os.path.join(tmp, "rank%d.pt" % rank))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def spawn(fn_name, world, backend='gloo', device=None, *args, shape=None,
          timeout=TIMEOUT):
    """Run ``fn_name(pm, *args)`` on ``world`` ranks; returns the list
    of their return values (see the module docstring).  ``device`` is
    None (the GPU; raises without CUDA), 'cuda' or 'cpu'; ``shape``
    (npx, npy) gives every rank the 2-d grid of ``ProcessMesh``.  A
    collective that waits longer than ``timeout`` seconds (default
    ``TIMEOUT``) fails the job: a rank that issues collectives in
    another order than the others hangs until then."""
    resolve(fn_name)
    if device is None:
        device = _default_device(0).type
    with tempfile.TemporaryDirectory(prefix="pmesh_spawn_") as tmp:
        mp.start_processes(
            _entry, args=(fn_name, world, backend, str(device), tmp, args,
                          shape, int(timeout)),
            nprocs=world, join=True, start_method='spawn')
        return [torch.load(os.path.join(tmp, "rank%d.pt" % r),
                           weights_only=False) for r in range(world)]
