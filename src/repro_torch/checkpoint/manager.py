"""Fault-tolerant checkpointing: port of ``repro/checkpoint/manager.py``
(async writer, atomic commit, auto-resume), for one device.

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
    """A copy on the host, never a view of ``x``."""
    x = x.detach().to('cpu', copy=True)
    if x.dtype == torch.bfloat16:
        x = x.view(torch.int16)
    return x.numpy()


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

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
                'n_leaves': len(leaves), 'extra': extra_meta or {}}

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

        if blocking:
            _write()
        else:
            def _guarded():
                try:
                    _write()
                except BaseException as e:   # surfaced at the next wait()
                    self._error = e
            self._thread = threading.Thread(target=_guarded, daemon=True)
            self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError('async checkpoint write failed') from err

    def _gc(self):
        for s in self._committed()[:-self.keep]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    # -- restore -------------------------------------------------------------
    def restore(self, step: int, like: Any) -> Any:
        """The tree saved at ``step``, in the structure of ``like``, each
        tensor on its ``like`` leaf's device; raises when the names of
        the leaves differ from the saved ones."""
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
            out.append(t.to(x.device))
        return _unflatten(like, iter(out))

    def restore_latest(self, like: Any) -> Tuple[Optional[int], Any]:
        step = self.latest_step()
        if step is None:
            return None, like
        return step, self.restore(step, like)
