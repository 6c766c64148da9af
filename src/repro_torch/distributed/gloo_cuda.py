"""DTensor's collectives on CUDA tensors under gloo.

NCCL refuses two ranks on one card, so ranks that share a card run gloo.
Gloo runs its plain collectives on CUDA tensors by staging them through
host memory (``all_reduce``, ``broadcast``, ``all_gather_into_tensor``,
``reduce_scatter_tensor`` and ``barrier`` do so under torch 2.11 on an
H100), but the functional collectives that DTensor calls reach gloo's
coalesced all-gather, which reads a CUDA tensor's device pointer as host
memory: four ranks on one card end in SIGSEGV at the first all-gather
over a mesh dim.  Gloo has no all-to-all either, which DTensor works
around only on a CPU mesh.

``stage_through_host()`` wraps DTensor's functional collectives so that
a CUDA input goes to the host, through gloo's CPU path, and back, and
routes DTensor's shard-to-shard all-to-all through an all-gather and a
chunk, as DTensor does on a CPU mesh.  ``launch.mesh.make_mesh`` calls
it for a CUDA mesh whose process group is gloo; a CUDA mesh under NCCL
never reaches it, and a CPU tensor passes through unchanged.
"""
from __future__ import annotations

import functools

import torch

# the functional collectives DTensor calls (their names in torch 2.11 and
# in later releases)
_WRAPPED = ('all_gather_tensor', 'all_gather_single',
            'reduce_scatter_tensor', 'reduce_scatter_single', 'all_reduce')
_installed = False


def _via_host(fn):
    @functools.wraps(fn)
    def wrapped(self, *args, **kwargs):
        if not (torch.is_tensor(self) and self.is_cuda):
            return fn(self, *args, **kwargs)
        out = fn(self.cpu(), *args, **kwargs)
        if hasattr(out, 'wait'):           # an AsyncCollectiveTensor
            out = out.wait()
        return out.to(self.device)
    return wrapped


def _gather(input, gather_dim, group):
    import torch.distributed._functional_collectives as funcol
    name = ('all_gather_tensor' if hasattr(funcol, 'all_gather_tensor')
            else 'all_gather_single')
    out = getattr(funcol, name)(input, gather_dim, group)
    return out.wait() if hasattr(out, 'wait') else out


def _alltoall_via_gather(input, gather_dim, shard_dim, mesh, mesh_dim):
    """DTensor's ``shard_dim_alltoall`` as it runs on a CPU mesh."""
    out = _gather(input.contiguous(), gather_dim, (mesh, mesh_dim))
    out = torch.chunk(out, mesh.size(mesh_dim), dim=shard_dim)[
        mesh.get_local_rank(mesh_dim)]
    return out.contiguous()


def stage_through_host() -> None:
    """Install the wrappers, once per process."""
    global _installed
    if _installed:
        return
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import _collective_utils, placement_types
    for name in _WRAPPED:
        if hasattr(funcol, name):
            setattr(funcol, name, _via_host(getattr(funcol, name)))
    for mod in (_collective_utils, placement_types):
        if hasattr(mod, 'shard_dim_alltoall'):
            mod.shard_dim_alltoall = _alltoall_via_gather
    _installed = True
