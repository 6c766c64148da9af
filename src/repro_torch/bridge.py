"""Load a reference parameter tree into a port module.

The reference keeps parameters as nested dicts and lists of arrays whose
key paths (``down.1.blocks.0.attn.wq.w``) are the port modules'
``state_dict`` keys.  Two leaves differ in form:

* conv kernels are HWIO ``(kh, kw, in, out)`` in the reference and OIHW
  in the port: every 4-D array is transposed by ``(3, 2, 0, 1)``;
* a pre-quantized weight is a ``QTensor`` (an object with ``q`` and
  ``scale``); the matching parameter (a ``Linear``'s ``w``, the MoE
  experts' ``w_gate`` / ``w_up`` / ``w_down``, any weight
  ``quantization.quantize_params`` quantizes) is switched to its
  ``QWeight`` first, and the two arrays load as ``<path>.q`` /
  ``<path>.scale`` (a 4-D pair transposed as a conv kernel).

Leaves may be numpy arrays or anything ``numpy.asarray`` accepts.  The
load is strict: a missing or unexpected key raises.

``load_jax_adamw_state`` carries a reference ``AdamWState`` (its ``m``
and ``v`` trees mirror the parameters) into the port's, whose moments
are lists in the module's parameter order.
"""
from __future__ import annotations

import types
from typing import Any, Dict

import numpy as np
import torch
import torch.nn as nn

from repro_torch.launch.steps import train_params
from repro_torch.models import encdec as ED
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.optim.adamw import AdamWState


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
    return _load_flat(module, _unstacked(tree, _stacks(module)))


def load_jax_encdec_params(module: nn.Module, tree: Any) -> nn.Module:
    """Copy the reference encoder-decoder tree into an ``EncDec`` module:
    ``enc_blocks`` (leading axis ``n_enc_layers``) and ``dec_blocks``
    (``n_layers``) are unstacked into ``enc_blocks.{i}...`` and
    ``dec_blocks.{i}...``.  Strict, as ``load_jax_lm_params``."""
    return _load_flat(module, _unstacked(tree, _stacks(module)))


def _stacks(module: nn.Module) -> Dict[str, int]:
    """The module's stacked keys and their unit counts: ``blocks`` of an
    LM, ``enc_blocks`` and ``dec_blocks`` of an encoder-decoder."""
    if isinstance(module, T.LM):
        return {'blocks': len(module.blocks)}
    if isinstance(module, ED.EncDec):
        return {'enc_blocks': len(module.enc_blocks),
                'dec_blocks': len(module.dec_blocks)}
    return {}


def _unstacked(tree: Any, stacks: Dict[str, int]) -> Dict[str, Any]:
    """``tree`` flattened, its leaves under each key of ``stacks``
    (carrying a leading axis of that key's unit count) unstacked into
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
    return out


def _tensor(leaf: Any) -> torch.Tensor:
    """A float leaf as a tensor in the port's layout (a 4-D conv kernel
    transposed HWIO -> OIHW); numpy's bfloat16 (``ml_dtypes``) by its
    bits."""
    arr = np.array(leaf)
    if arr.ndim == 4:
        arr = arr.transpose(3, 2, 0, 1)
    arr = np.ascontiguousarray(arr)
    if arr.dtype.name == 'bfloat16':
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def load_jax_adamw_state(module: nn.Module, state: Any) -> AdamWState:
    """The reference ``AdamWState`` ``state`` (``step``, and ``m`` and
    ``v`` trees of numpy arrays shaped as the parameters) as the port's,
    for ``module``'s ``train_params`` order, on its device: ``m`` and
    ``v`` map to parameter names as ``load_jax_lm_params`` and
    ``load_jax_encdec_params`` map the parameters, stacked units
    included.  Strict: a moment for a name the module lacks, or a missing
    one, raises."""
    params = train_params(module)
    device = next(iter(params.values())).device
    moments = []
    for name, tree in (('m', state.m), ('v', state.v)):
        flat = _unstacked(tree, _stacks(module))
        if set(flat) != set(params):
            raise ValueError(f'{name}: the moments\' names differ from the '
                             'module\'s parameters: '
                             f'{sorted(set(flat) ^ set(params))[:8]}')
        moments.append([_tensor(flat[n]).to(device) for n in params])
    step = torch.tensor(int(np.asarray(state.step)), dtype=torch.int32,
                        device=device)
    return AdamWState(step, *moments)


def _load_flat(module: nn.Module, flat: Dict[str, Any]) -> nn.Module:
    state: Dict[str, torch.Tensor] = {}
    for key, leaf in flat.items():
        if _is_qtensor(leaf):
            owner_name, _, attr = key.rpartition('.')
            owner = module.get_submodule(owner_name)
            if not isinstance(getattr(owner, attr, None),
                              (nn.Parameter, L.QWeight)):
                raise ValueError(f'{key}: a QTensor leaf must be a weight '
                                 'parameter of the module')
            if not isinstance(getattr(owner, attr), L.QWeight):
                L.quantize_weight_(owner, attr)
            state[f'{key}.q'] = _tensor(leaf.q)
            state[f'{key}.scale'] = _tensor(leaf.scale)
            continue
        state[key] = _tensor(leaf)
    module.load_state_dict(state, strict=True)
    return module
