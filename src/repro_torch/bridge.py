"""Load a reference parameter tree into a port module.

The reference keeps parameters as nested dicts and lists of arrays whose
key paths (``down.1.blocks.0.attn.wq.w``) are the port modules'
``state_dict`` keys.  Two leaves differ in form:

* conv kernels are HWIO ``(kh, kw, in, out)`` in the reference and OIHW
  in the port: every 4-D array is transposed by ``(3, 2, 0, 1)``;
* a pre-quantized weight is a ``QTensor`` (an object with ``q`` and
  ``scale``); the matching ``Linear`` is switched to its quantized form
  first, and the two arrays load as ``<path>.q`` / ``<path>.scale``.

Leaves may be numpy arrays or anything ``numpy.asarray`` accepts.  The
load is strict: a missing or unexpected key raises.
"""
from __future__ import annotations

import types
from typing import Any, Dict

import numpy as np
import torch
import torch.nn as nn

from repro_torch.models import layers as L


def _flatten(tree: Any, prefix: str, out: Dict[str, Any]) -> None:
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flatten(v, f'{prefix}{k}.', out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flatten(v, f'{prefix}{i}.', out)
    else:                                  # an array or a QTensor
        out[prefix[:-1]] = tree


def _is_qtensor(leaf: Any) -> bool:
    return hasattr(leaf, 'q') and hasattr(leaf, 'scale')


def load_jax_params(module: nn.Module, tree: Any) -> nn.Module:
    """Copy the reference tree ``tree`` into ``module`` (in place, on the
    module's device); returns the module."""
    flat: Dict[str, Any] = {}
    _flatten(tree, '', flat)
    return _load_flat(module, flat)


def load_jax_lm_params(module: nn.Module, tree: Any) -> nn.Module:
    """Copy the reference LM tree into an LM module.  The reference stacks
    the params of its scanned units on a leading axis of ``n_scan_steps``
    (``blocks.sub0.attn.wq.w`` of shape ``(steps, d, d)``; a hybrid's unit
    holds several sub-layers, so Jamba's 72 layers are 9 units); every
    leaf under ``blocks`` is unstacked into ``blocks.{i}.sub{j}...``, so
    the expert weights ``(steps, E, d, ff)`` reach ``_load_flat`` 3-D and
    load as they are (only a 4-D leaf is a conv kernel).  Strict, as
    ``load_jax_params``; a leaf whose leading axis is not the module's
    unit count raises."""
    return _load_stacked(module, tree, {'blocks': len(module.blocks)})


def load_jax_encdec_params(module: nn.Module, tree: Any) -> nn.Module:
    """Copy the reference encoder-decoder tree into an ``EncDec`` module:
    ``enc_blocks`` (leading axis ``n_enc_layers``) and ``dec_blocks``
    (``n_layers``) are unstacked into ``enc_blocks.{i}...`` and
    ``dec_blocks.{i}...``.  Strict, as ``load_jax_lm_params``."""
    return _load_stacked(module, tree,
                         {'enc_blocks': len(module.enc_blocks),
                          'dec_blocks': len(module.dec_blocks)})


def _load_stacked(module: nn.Module, tree: Any,
                  stacks: Dict[str, int]) -> nn.Module:
    """Load ``tree`` whose leaves under each key of ``stacks`` carry a
    leading axis of that key's unit count, unstacked into
    ``{key}.{i}.{rest}``; a leading axis of another size raises."""
    flat: Dict[str, Any] = {}
    _flatten(tree, '', flat)
    out: Dict[str, Any] = {}
    for key, leaf in flat.items():
        head, _, rest = key.partition('.')
        if head not in stacks:
            out[key] = leaf
            continue
        n = stacks[head]
        parts = ((np.asarray(leaf.q), np.asarray(leaf.scale))
                 if _is_qtensor(leaf) else (np.asarray(leaf),))
        if any(a.shape[:1] != (n,) for a in parts):
            raise ValueError(f'{key}: leading axis {parts[0].shape[:1]} is '
                             f'not the {n} scanned units of the module\'s '
                             f'{head} (its layers; in a hybrid, layers / '
                             'sub-layers per unit)')
        for i in range(n):
            out[f'{head}.{i}.{rest}'] = (
                types.SimpleNamespace(q=parts[0][i], scale=parts[1][i])
                if _is_qtensor(leaf) else parts[0][i])
    return _load_flat(module, out)


def _load_flat(module: nn.Module, flat: Dict[str, Any]) -> nn.Module:
    state: Dict[str, torch.Tensor] = {}
    for key, leaf in flat.items():
        if _is_qtensor(leaf):
            owner = module.get_submodule(key.rsplit('.', 1)[0])
            if not isinstance(owner, L.Linear):
                raise ValueError(f'{key}: a QTensor leaf must be a Linear '
                                 'weight')
            if not isinstance(owner.w, L.QWeight):
                owner.quantize_()
            state[f'{key}.q'] = torch.from_numpy(np.array(leaf.q))
            state[f'{key}.scale'] = torch.from_numpy(np.array(leaf.scale))
            continue
        arr = np.array(leaf)
        if arr.ndim == 4:
            arr = arr.transpose(3, 2, 0, 1)
        state[key] = torch.from_numpy(np.ascontiguousarray(arr))
    module.load_state_dict(state, strict=True)
    return module
