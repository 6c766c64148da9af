"""Meshes, port of ``repro/launch/mesh.py``.

Training.  ``make_mesh`` builds a ``torch.distributed`` ``DeviceMesh``
over the ranks of the default process group, one rank per device
(``torchrun --nproc-per-node N``), its dims named as the reference's:
``('data', 'model')`` or ``('pod', 'data', 'model')``.  On a CUDA mesh
under gloo (ranks that share a card, which NCCL refuses) DTensor's
collectives are staged through host memory
(``distributed/gloo_cuda.py``).  ``make_production_mesh`` is the
reference's production layout, single pod ``(data=16, model=16)`` = 256
devices, multi-pod ``(pod=2, data=16, model=16)`` = 512; it is a
function, so importing this module touches no device state.
``dp_axes``, ``mesh_dp_size`` and ``mesh_model_size`` read a
``DeviceMesh`` or a ``sharding.MeshDesc`` alike.

Serving.  The slot-sharded ``ContinuousBatchingEngine`` spans an
ordered 1-D mesh on the ``'data'`` axis: shard i holds slot rows
``i*spd ... (i+1)*spd - 1`` of every slot buffer on
``mesh.devices[i]``.  A device may appear more than once, so one card
can carry several logical shards (the counterpart of XLA's forced host
device count); on the CPU every shard is the CPU, which is how the tests
run a mesh.
"""
from __future__ import annotations

import dataclasses
import math
import os
from typing import Optional, Sequence, Tuple, Union

import torch

from repro_torch.distributed import sharding as SH

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


def world_size() -> int:
    """The ranks of the default process group, or of the launcher's
    environment (``WORLD_SIZE``) before it is initialised."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get('WORLD_SIZE', '1'))


def launch_hint(n: int) -> str:
    return (f'python -m torch.distributed.run --nproc-per-node {n} '
            f'-m repro_torch.launch.train ...')


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...],
              device: str = 'cuda'):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over every rank, one
    per device (tests / elastic restarts / smoke runs).  Raises when the
    world size is not ``prod(shape)``, naming the ``--nproc-per-node``
    count it needs."""
    from torch.distributed.device_mesh import init_device_mesh
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f'mesh shape {shape} and axes {axes} differ in '
                         f'length')
    n, world = math.prod(shape), world_size()
    if n != world:
        raise ValueError(f'a {shape} mesh needs {n} ranks and this run has '
                         f'{world}: launch it with --nproc-per-node {n} '
                         f'({launch_hint(n)})')
    mesh = init_device_mesh(torch.device(device).type, shape,
                            mesh_dim_names=axes)
    import torch.distributed as dist
    if mesh.device_type == 'cuda' and dist.get_backend() == 'gloo':
        from repro_torch.distributed import gloo_cuda
        gloo_cuda.stage_through_host()      # ranks sharing a card
    return mesh


def make_production_mesh(*, multi_pod: bool = False, device: str = 'cuda'):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ('pod', 'data', 'model') if multi_pod else ('data', 'model')
    return make_mesh(shape, axes, device)


def dp_axes(mesh) -> Tuple[str, ...]:
    """The data-parallel axes of a mesh: ('pod','data') when a pod axis
    exists, else ('data',)."""
    return SH.dp_axes(mesh)


def mesh_dp_size(mesh) -> int:
    sizes = SH.axis_sizes(mesh)
    return math.prod(sizes[a] for a in dp_axes(mesh))


def mesh_model_size(mesh) -> int:
    return SH.axis_sizes(mesh).get('model', 1)
