"""The serving mesh, port of ``repro/launch/mesh.py``'s ``serving_mesh``.

The slot-sharded ``ContinuousBatchingEngine`` spans an ordered 1-D mesh
on the ``'data'`` axis: shard i holds slot rows ``i*spd ... (i+1)*spd -
1`` of every slot buffer on ``mesh.devices[i]``.  A device may appear
more than once, so one card can carry several logical shards (the
counterpart of XLA's forced host device count); on the CPU every shard
is the CPU, which is how the tests run a mesh.

The training meshes (``make_production_mesh``, ``make_mesh``,
``dp_axes``, ``mesh_dp_size``, ``mesh_model_size``) belong to the
sharded trainer and are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple, Union

import torch

DeviceLike = Union[str, torch.device]


@dataclasses.dataclass(frozen=True)
class ServingMesh:
    """An ordered 1-D mesh on the ``'data'`` axis: one slot shard per
    entry of ``devices``."""
    devices: Tuple[torch.device, ...]

    @property
    def size(self) -> int:
        return len(self.devices)


def _indexed(device: DeviceLike) -> torch.device:
    """``device`` with its index: a bare ``'cuda'`` is the current card,
    so equal devices compare equal (one parameter replica each)."""
    dev = torch.device(device)
    if dev.type == 'cuda' and dev.index is None:
        dev = torch.device('cuda', torch.cuda.current_device())
    return dev


def serving_mesh(n_devices: Optional[int] = None,
                 devices: Optional[Sequence[DeviceLike]] = None,
                 device: DeviceLike = 'cuda') -> ServingMesh:
    """1-D ``('data',)`` mesh for the slot-sharded serving engine.

    ``devices``: the mesh's devices in order (a device may repeat: two
    logical shards on one card).  Otherwise ``device='cuda'`` takes the
    visible cards, ``cuda:0 ... cuda:k-1``, and ``device='cpu'`` gives
    ``n_devices`` logical shards on the CPU (default one).
    ``n_devices`` takes the first N of the list, and raises ``need
    1..k devices`` outside that range, as the reference does."""
    if devices is not None:
        devs = [_indexed(d) for d in devices]
    elif torch.device(device).type == 'cpu':
        n = 1 if n_devices is None else n_devices
        if n < 1:
            raise ValueError(f'need at least 1 device, got {n}')
        devs = [torch.device('cpu')] * n
    else:
        if torch.device(device).type != 'cuda':
            raise ValueError(f'no serving mesh on {device!r}')
        devs = [torch.device('cuda', i)
                for i in range(torch.cuda.device_count())]
    if n_devices is not None:
        if not 1 <= n_devices <= len(devs):
            raise ValueError(f'need 1..{len(devs)} devices, '
                             f'got {n_devices}')
        devs = devs[:n_devices]
    if not devs:
        raise RuntimeError('CUDA is not available; pass device="cpu" for '
                           'a mesh of logical CPU shards')
    return ServingMesh(tuple(devs))
