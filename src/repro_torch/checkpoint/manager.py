"""Fault-tolerant checkpointing: port of ``repro/checkpoint/manager.py``
(async writer, atomic commit, auto-resume, elastic resharding).

Layout (one directory per step), the reference's:
    <dir>/step_000123/
        arrays.npz          the tree's tensors, a0 .. a{n-1}
        meta.json           step, the tensors' names and dtypes in that
                            order, extra metadata
        COMMITTED           empty marker written last (atomic commit)

A tree is nested dicts, lists and tuples (a ``NamedTuple`` by its field
names) of tensors.  Its leaves are stored in one fixed order, dicts in
their insertion order (a model's parameters in registration order), and
``meta.json`` names each one by its key path (``params.embed.table``,
``opt.m.embed.table``, ``opt.step``); ``restore`` refuses a tree whose
names differ.  bfloat16 tensors, which numpy lacks, are stored as their
int16 bits.

A step is written into ``step_XXXXXXXX.tmp`` and renamed into place, so
``latest_step`` only ever sees committed steps; ``keep`` bounds how many
stay.  The device-to-host copy is synchronous, so the snapshot is the
state at the call, whatever the training thread updates in place next;
with ``blocking=False`` the file IO runs on a writer thread, at most one
at a time, whose error is raised at the next ``wait()``.

Sharded trees.  A ``DTensor`` leaf is stored with its logical (full)
shape: ``save`` gathers it with ``full_tensor()``, a collective that
every rank runs on the calling thread before any writer starts; only
rank 0 writes and commits, and every rank then passes a barrier (for an
asynchronous save, at the next ``wait()``), so ``latest_step`` agrees
across ranks.  ``meta.json`` records the mesh's shape and axis names.
``restore`` places each full array onto the ``like`` leaf's *current*
mesh with its placements, each rank keeping its own chunk: a checkpoint
saved on a ``(2, 4)`` mesh restores onto ``(4, 2)`` or ``(1, 1)``.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.distributed import sharding as SH


def _flatten(tree: Any, prefix: str = '') -> List[Tuple[str, torch.Tensor]]:
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, tuple) and hasattr(tree, '_fields'):
        items = zip(tree._fields, tree)
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return [(prefix[:-1], tree)]
    return [leaf for k, v in items for leaf in _flatten(v, f'{prefix}{k}.')]


def _unflatten(like: Any, leaves) -> Any:
    """``like``'s structure with its leaves taken in order from the
    iterator ``leaves``."""
    if isinstance(like, dict):
        return type(like)((k, _unflatten(v, leaves)) for k, v in like.items())
    if isinstance(like, tuple) and hasattr(like, '_fields'):
        return type(like)(*(_unflatten(v, leaves) for v in like))
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(v, leaves) for v in like)
    return next(leaves)


def _to_host(x: torch.Tensor) -> np.ndarray:
    """A copy on the host, never a view of ``x``; a DTensor gathered whole
    first (a collective)."""
    if SH.is_dtensor(x):
        x = x.full_tensor()
    x = x.detach().to('cpu', copy=True)
    if x.dtype == torch.bfloat16:
        x = x.view(torch.int16)
    return x.numpy()


def _distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def _mesh_meta(leaves) -> Optional[dict]:
    for _, x in leaves:
        if SH.is_dtensor(x):
            return {'shape': list(x.device_mesh.shape),
                    'axes': list(SH.axis_names(x.device_mesh))}
    return None


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        self.rank = dist.get_rank() if _distributed() else 0
        if self.rank == 0:
            os.makedirs(directory, exist_ok=True)
        if _distributed():
            dist.barrier()
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._pending = False       # a save whose barrier is still due

    # -- paths ---------------------------------------------------------------
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f'step_{step:08d}')

    def _committed(self) -> List[int]:
        return sorted(
            int(m.group(1)) for name in os.listdir(self.dir)
            if (m := re.fullmatch(r'step_(\d+)', name))
            and os.path.exists(os.path.join(self.dir, name, 'COMMITTED')))

    def latest_step(self) -> Optional[int]:
        steps = self._committed()
        return steps[-1] if steps else None

    # -- save ----------------------------------------------------------------
    def save(self, step: int, tree: Any, blocking: bool = True,
             extra_meta: Optional[dict] = None):
        """Snapshot ``tree`` at ``step``.  With blocking=False the
        device-to-host copy happens here (consistency) and the file IO on
        the writer thread."""
        self.wait()
        leaves = _flatten(tree)
        host = [_to_host(x) for _, x in leaves]
        meta = {'step': step, 'names': [n for n, _ in leaves],
                'dtypes': [str(x.dtype).removeprefix('torch.')
                           for _, x in leaves],
                'n_leaves': len(leaves), 'mesh': _mesh_meta(leaves),
                'extra': extra_meta or {}}

        def _write():
            sd = self._step_dir(step)
            tmp = sd + '.tmp'
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
            np.savez(os.path.join(tmp, 'arrays.npz'),
                     **{f'a{i}': a for i, a in enumerate(host)})
            with open(os.path.join(tmp, 'meta.json'), 'w') as f:
                json.dump(meta, f)
            with open(os.path.join(tmp, 'COMMITTED'), 'w'):
                pass
            if os.path.exists(sd):
                shutil.rmtree(sd)
            os.replace(tmp, sd)
            self._gc()

        if self.rank == 0 and blocking:
            _write()
        elif self.rank == 0:
            def _guarded():
                try:
                    _write()
                except BaseException as e:   # surfaced at the next wait()
                    self._error = e
            self._thread = threading.Thread(target=_guarded, daemon=True)
            self._thread.start()
        self._pending = True
        if blocking:
            self.wait()

    def wait(self):
        """Join the writer; on a mesh every rank calls it (a barrier)."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._pending and _distributed():
            dist.barrier()
        self._pending = False
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError('async checkpoint write failed') from err

    def _gc(self):
        for s in self._committed()[:-self.keep]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    # -- restore -------------------------------------------------------------
    def restore(self, step: int, like: Any) -> Any:
        """The tree saved at ``step``, in the structure of ``like``, each
        tensor on its ``like`` leaf's device (a DTensor leaf: on its mesh,
        with its placements); raises when the names of the leaves differ
        from the saved ones."""
        self.wait()
        sd = self._step_dir(step)
        with open(os.path.join(sd, 'meta.json')) as f:
            meta = json.load(f)
        leaves = _flatten(like)
        names = [n for n, _ in leaves]
        if names != meta['names']:
            missing = sorted(set(meta['names']) ^ set(names))
            raise ValueError(f'checkpoint step {step} holds other tensors '
                             f'than the tree to restore (differing: '
                             f'{missing[:8]}) or another order')
        with np.load(os.path.join(sd, 'arrays.npz')) as data:
            arrays = [data[f'a{i}'] for i in range(len(leaves))]
        out = []
        for (_, x), a, dt in zip(leaves, arrays, meta['dtypes']):
            t = torch.from_numpy(a)
            if dt == 'bfloat16':
                t = t.view(torch.bfloat16)
            if SH.is_dtensor(x):
                out.append(SH.distribute(t.to(x.device), x.device_mesh,
                                         x.placements))
            else:
                out.append(t.to(x.device))
        return _unflatten(like, iter(out))

    def restore_latest(self, like: Any) -> Tuple[Optional[int], Any]:
        step = self.latest_step()
        if step is None:
            return None, like
        return step, self.restore(step, like)
