"""Foundational layers, port of ``repro/models/layers.py``.

Functions on tensors: ``linear`` per precision policy, ``conv2d``,
``groupnorm``, ``swish`` and ``conv_transpose2d``; for the LMs
``embedding``, ``embedding_logits``, ``layernorm``, ``rmsnorm``, ``gelu``
(the tanh approximation, as the reference's) and ``mlp``; for training
``token_xent`` (the LM losses' cross-entropy) and ``remat`` (the
reference's ``jax.checkpoint`` policies on a block).  Layouts
follow the reference at these functions: NHWC / BSD activations and
``(in, out)`` linear weights.  Conv kernels are OIHW ``(out, in, kh,
kw)``, the reference's HWIO kernel transposed, as ``F.conv2d`` reads
them on the CPU (the CUDA kernel keeps its own copy, ``kernels/conv2d``).

The small modules at the end (``Linear``, ``Conv``, ``GroupNorm``,
``Embedding``, ``RMSNorm``, ``LayerNorm``, ``MLP``) only hold
parameters, under the names of the reference's param dicts (``w``,
``b``, ``scale``, ``bias``, ``table``, ``up``/``gate``/``down``), so a
model's ``state_dict`` keys are the reference pytree's key paths.
"""
from __future__ import annotations

import functools
import math
from typing import Optional, Union

import torch
import torch.nn as nn
from torch.utils import checkpoint as ckpt

from repro_torch.core import prng
from repro_torch.core.precision import PrecisionPolicy, resolve
from repro_torch.core.quantization import (QTensor, quantize,
                                           quantize_per_channel)
from repro_torch.core.sparse_dataflow import (conv_transpose_dense,
                                              conv_transpose_sparse)
from repro_torch.distributed import sharding as SH
from repro_torch.kernels import ops


def linear(x: torch.Tensor, w: Union[torch.Tensor, QTensor],
           b: Optional[torch.Tensor] = None,
           policy: Union[PrecisionPolicy, str, None] = None,
           noise_key: Optional[prng.Key] = None,
           first_sample: int = 0) -> torch.Tensor:
    """y = x @ w + b under the precision policy: fp32, or W8A8 (DiffLight
    C1) when the policy is quantized or ``w`` is a pre-quantized QTensor,
    or W8A8 with analog noise drawn from ``noise_key`` (falling back to
    the policy's ``noise_seed`` anchor) when the policy is noisy, for
    samples from ``first_sample`` of a larger batch on
    (``noisy_w8a8_matmul``)."""
    pol = resolve(policy)
    if pol.quantized or isinstance(w, QTensor):
        if pol.noisy:
            from repro_torch.core.photonic.noise import noisy_w8a8_matmul
            key = noise_key if noise_key is not None else \
                prng.PRNGKey(pol.noise_seed)
            y = noisy_w8a8_matmul(key, x, w, model=pol.noise,
                                  n_channels=pol.n_channels,
                                  first_sample=first_sample).to(x.dtype)
        else:
            y = ops.w8a8_matmul(x, w).to(x.dtype)
    else:
        y = x @ w.to(x.dtype)
    if b is not None:
        y = y + b.to(y.dtype)
    return y


def _same_pads(size: int, k: int, s: int):
    """(lo, hi) padding of XLA's SAME for one spatial dim."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def conv2d(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
           stride: int = 1, *, row: Optional[torch.Tensor] = None,
           residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """SAME-padded convolution: x (N, H, W, Cin), w (Cout, Cin, kh, kw),
    then ``+ b``, ``+ row[:, None, None, :]`` (row (N, Cout)) and
    ``residual +`` (N, Ho, Wo, Cout), each optional, in that order; on
    CUDA all in the convolution kernel's epilogue (``ops.conv2d``)."""
    _, H, W, _ = x.shape
    _, _, kh, kw = w.shape
    return ops.conv2d(x, w, _same_pads(H, kh, stride),
                      _same_pads(W, kw, stride), stride, bias=b, row=row,
                      residual=residual)


def conv_transpose2d(x: torch.Tensor, w: torch.Tensor,
                     b: Optional[torch.Tensor] = None, stride: int = 2, *,
                     sparse_dataflow: bool = True) -> torch.Tensor:
    """Transposed conv with ``jax.lax.conv_transpose`` semantics; the
    sparse dataflow (paper §IV-C) skips the inserted zeros."""
    if sparse_dataflow:
        return conv_transpose_sparse(x, w, stride, b)
    y = conv_transpose_dense(x, w, stride)
    if b is not None:
        y = y + b
    return y


def groupnorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              groups: int = 32, eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm over NHWC with the largest ``g <= groups`` dividing C and
    the population variance (``jnp.var``; ``torch.var`` would be
    unbiased)."""
    N, H, W, C = x.shape
    g = min(groups, C)
    while C % g:
        g -= 1
    xf = x.float().reshape(N, H, W, g, C // g)
    mu = xf.mean(dim=(1, 2, 4), keepdim=True)
    var = (xf - mu).square().mean(dim=(1, 2, 4), keepdim=True)
    y = ((xf - mu) * torch.rsqrt(var + eps)).reshape(N, H, W, C)
    return (y * scale + bias).to(x.dtype)


def swish(x: torch.Tensor) -> torch.Tensor:
    """f(x) = x * sigmoid(x), paper Eq. 5."""
    return x * torch.sigmoid(x)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """The tanh approximation, as ``jax.nn.gelu(approximate=True)``."""
    return torch.nn.functional.gelu(x, approximate='tanh')


ACTIVATIONS = {'swish': swish, 'silu': swish, 'gelu': gelu,
               'relu': torch.relu}


def embedding(p: 'Embedding', ids: torch.Tensor,
              dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The rows of ``p.table`` at ``ids``.  A sharded table (the
    reference's ``('model', 'data')``: vocabulary over 'model') is
    gathered whole for the lookup (``sharding.lookup``)."""
    if SH.is_dtensor(p.table):
        return SH.lookup(p.table, ids).to(dtype)
    return p.table[ids].to(dtype)


def embedding_logits(p: 'Embedding', x: torch.Tensor) -> torch.Tensor:
    """Tied readout: x @ table^T, float32 out.  On a mesh the table is
    laid out with its vocabulary over 'model' and d_model whole, and its
    gradient from here comes back in the table's own layout, as the
    lookup's does (DTensor under torch 2.11 cannot add a partial and a
    sharded gradient)."""
    table = SH.shard_hint(p.table, 'model', None)
    return (x @ table.to(x.dtype).T).float()


def layernorm(p: 'LayerNorm', x: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * p.scale + p.bias).to(x.dtype)


def rmsnorm(p: 'RMSNorm', x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    ms = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * p.scale).to(x.dtype)


def mlp(p: 'MLP', x: torch.Tensor, act: str = 'swish',
        quant: bool = False, tp_axis: Optional[str] = 'model'
        ) -> torch.Tensor:
    """Gated (``act(gate(x)) * up(x)``) when ``p`` has a gate, else
    ``act(up(x))``; then ``down``.  ``quant`` runs all three on W8A8.
    On a mesh the hidden units shard over ``tp_axis``."""
    f = ACTIVATIONS[act]
    pol = 'w8a8' if quant else None
    up = p.up(x, pol)
    up = SH.shard_hint(up, *(('dp',) + (None,) * (up.dim() - 2)
                             + (tp_axis,)))
    h = f(p.gate(x, pol)) * up if p.gate is not None else f(up)
    return p.down(h, pol)


def pad_vocab(vocab: int, multiple: int) -> int:
    return -(-vocab // multiple) * multiple


def token_xent(logits: torch.Tensor, labels: torch.Tensor,
               real_vocab: Optional[int] = None) -> torch.Tensor:
    """The LM losses' causal cross-entropy: logits (B, S, vocab) in
    float32, the padded vocabulary rows (``real_vocab`` and up) set to
    -1e30, the gold logit taken at ``max(labels, 0)``; the mean over the
    labels that are not -1, its denominator at least 1.  On a mesh the
    per-token terms are vocabulary-parallel (``sharding.vocab_xent``)."""
    logits = logits.float()
    if SH.is_dtensor(logits):
        nll = SH.vocab_xent(logits, labels, real_vocab)
        labels = SH.shard_hint(labels, 'dp')
    else:
        nll = SH.token_nll(logits, labels, real_vocab)
    mask = (labels >= 0).float()
    return (nll * mask).sum() / mask.sum().clamp_min(1.0)


def _save_dots(ctx, op, *args, **kwargs):
    """The ``'dots'`` policy: keep what a matrix product computed (as
    ``jax.checkpoint_policies.checkpoint_dots``), recompute the rest."""
    aten = torch.ops.aten
    return (ckpt.CheckpointPolicy.MUST_SAVE
            if op in (aten.mm.default, aten.bmm.default, aten.addmm.default)
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def remat(policy: str, fn, *args):
    """``fn(*args)``, its activations recomputed in the backward pass
    (the reference's ``jax.checkpoint`` of a scanned block) when grad is
    enabled: ``'full'`` keeps only the inputs, ``'dots'`` also the
    outputs of ``mm``/``bmm``/``addmm``, ``'none'`` keeps everything.
    The values are the same under every policy."""
    if policy not in ('none', 'full', 'dots'):
        raise ValueError(f"remat must be 'none', 'full' or 'dots', got "
                         f'{policy!r}')
    if policy == 'none' or not torch.is_grad_enabled():
        return fn(*args)
    kw = {}
    if policy == 'dots':
        kw['context_fn'] = functools.partial(
            ckpt.create_selective_checkpoint_contexts, _save_dots)
    return ckpt.checkpoint(fn, *args, use_reentrant=False, **kw)


# ---------------------------------------------------------------------------
# parameter holders
# ---------------------------------------------------------------------------

def empty_param(shape, device, dtype=torch.float32) -> nn.Parameter:
    """An uninitialised float32 parameter (no gradient: serving never
    needs one, and a trainer turns it on with
    ``launch.steps.train_params``): ``init_params`` or a checkpoint load
    fills it."""
    return nn.Parameter(torch.empty(shape, device=device, dtype=dtype),
                        requires_grad=False)


class QWeight(nn.Module):
    """A pre-quantized weight: int8 ``q`` and its float32 ``scale``, the
    ``QTensor`` leaf of the reference's param tree."""

    def __init__(self, qt: QTensor):
        super().__init__()
        self.register_buffer('q', qt.q)
        self.register_buffer('scale', qt.scale)
        self._kmajor = None     # (q it was built from, q's version, copy)

    def qtensor(self) -> QTensor:
        """On CUDA with the K-major copy the kernel reads, built once per
        weight: at the first call after ``q`` was set, moved or loaded
        (the bridge loads ``q`` after ``quantize_()``, so the copy cannot
        be made there)."""
        if not self.q.is_cuda:
            return QTensor(self.q, self.scale)
        c = self._kmajor
        if c is None or c[0] is not self.q or c[1] != self.q._version:
            from repro_torch.kernels.w8a8_matmul import kmajor_weight
            c = self._kmajor = (self.q, self.q._version,
                                kmajor_weight(self.q))
        return QTensor(self.q, self.scale, c[2])


def quantize_weight_(module: nn.Module, name: str) -> None:
    """Replace the float parameter ``name`` of ``module`` by its
    per-output-channel ``QWeight``: the reference's
    ``quantize_per_channel``, whose scale reduces the input axis (axis 1
    of a 4-D OIHW conv kernel, the reference's HWIO axis 2)."""
    w = getattr(module, name).detach()
    qt = quantize(w, axis=(1,)) if w.dim() == 4 else quantize_per_channel(w)
    delattr(module, name)
    setattr(module, name, QWeight(qt))


class Linear(nn.Module):
    """``stddev`` set: the weight initialises normal with that stddev
    (the LM head), else fan-in uniform."""

    def __init__(self, d_in: int, d_out: int, bias: bool = True, device=None,
                 stddev: Optional[float] = None):
        super().__init__()
        self.w = empty_param((d_in, d_out), device)
        self.b = empty_param((d_out,), device) if bias else None
        self.stddev = stddev

    @property
    def weight(self) -> Union[torch.Tensor, QTensor]:
        return self.w.qtensor() if isinstance(self.w, QWeight) else self.w

    def quantize_(self) -> None:
        """Replace the float weight by its per-output-channel QTensor."""
        quantize_weight_(self, 'w')

    def forward(self, x, policy=None, noise_key=None, first_sample=0):
        return linear(x, self.weight, self.b, policy, noise_key,
                      first_sample)


class Conv(nn.Module):
    def __init__(self, kh: int, kw: int, c_in: int, c_out: int,
                 bias: bool = True, device=None):
        super().__init__()
        self.w = empty_param((c_out, c_in, kh, kw), device)
        self.b = empty_param((c_out,), device) if bias else None

    def forward(self, x, stride: int = 1, *, row=None, residual=None):
        return conv2d(x, self.w, self.b, stride, row=row, residual=residual)


class GroupNorm(nn.Module):
    def __init__(self, channels: int, device=None):
        super().__init__()
        self.scale = empty_param((channels,), device)
        self.bias = empty_param((channels,), device)

    def forward(self, x, groups: int):
        return groupnorm(x, self.scale, self.bias, groups)


class Embedding(nn.Module):
    def __init__(self, vocab: int, d: int, device=None):
        super().__init__()
        self.table = empty_param((vocab, d), device)


class RMSNorm(nn.Module):
    def __init__(self, d: int, device=None):
        super().__init__()
        self.scale = empty_param((d,), device)


class LayerNorm(nn.Module):
    def __init__(self, d: int, device=None):
        super().__init__()
        self.scale = empty_param((d,), device)
        self.bias = empty_param((d,), device)


class MLP(nn.Module):
    def __init__(self, d: int, d_ff: int, gated: bool = True,
                 bias: bool = False, device=None):
        super().__init__()
        self.up = Linear(d, d_ff, bias, device)
        self.down = Linear(d_ff, d, bias, device)
        self.gate = Linear(d, d_ff, bias, device) if gated else None


@torch.no_grad()
def init_params(module: nn.Module, generator: torch.Generator) -> None:
    """The reference's initialisation, drawn from ``generator``: fan-in
    uniform weights (normal with stddev 0.02 for embedding tables and
    ``Linear``s given a ``stddev``), zero biases, unit norm scales.  A
    module that holds parameters of its own beside its sub-modules (the
    MoE experts, the Mamba mixer's convolution and SSM constants) sets
    them in its ``init_own_(generator)``.  Modules are visited in
    registration order, so a seed fixes every value."""
    for m in module.modules():
        if hasattr(m, 'init_own_'):
            m.init_own_(generator)
        if isinstance(m, (GroupNorm, LayerNorm, RMSNorm)):
            m.scale.fill_(1.0)
            if not isinstance(m, RMSNorm):
                m.bias.zero_()
        elif isinstance(m, Embedding):
            m.table.normal_(0.0, 0.02, generator=generator)
        elif isinstance(m, Linear) and m.stddev is not None:
            m.w.normal_(0.0, m.stddev, generator=generator)
            if m.b is not None:
                m.b.zero_()
        elif isinstance(m, (Linear, Conv)):
            w = m.w
            fan_in = w.shape[0] if isinstance(m, Linear) else \
                w.shape[1] * w.shape[2] * w.shape[3]
            bound = 1.0 / math.sqrt(max(fan_in, 1))
            w.uniform_(-bound, bound, generator=generator)
            if m.b is not None:
                m.b.zero_()
