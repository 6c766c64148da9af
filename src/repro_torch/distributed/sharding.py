"""Sharding rules: parameter / batch / cache specs, port of
``repro/distributed/sharding.py``.

2-D weight sharding ("fsdp x tensor"), the reference's: matmul weights
shard their contracting (d_model-ish) dim over ``data`` (FSDP) and their
output dim over ``model`` (tensor parallelism); expert dims shard over
``model`` (expert parallelism); the ``pod`` axis is pure data
parallelism.  Rules match a parameter's path with a regex and fall back
on divisibility: an axis that does not divide its dim is dropped
(replicated), and ``verbose`` prints what was dropped.

A spec is a tuple with one entry per tensor dim: ``None``, a mesh axis
name, or a tuple of axis names (the dim sharded over their product,
the first the major one), as a ``PartitionSpec``.  ``placements`` turns
one into the placements of a ``torch.distributed`` ``DTensor``, one per
mesh dim, and ``shard_hint`` redistributes a ``DTensor`` to the layout a
spec gives (the reference's ``with_sharding_constraint``).

The rules read only a mesh's axis names and sizes, so ``mesh`` may be a
``DeviceMesh`` or a plain ``MeshDesc(shape, axis_names)`` (or such a
pair): a test asks for the production ``(2, 16, 16)`` without 512
processes.  Names follow the port: ``param_pspecs`` takes a model and
matches ``blocks.{i}.sub{j}.attn.wq.w`` as the reference's path
``blocks/sub{j}/attn/wq/w``.  The reference stacks the units on a
leading scan axis, so its spec of a unit's leaf is the port's with one
leading ``None``; ``cache_pspecs`` likewise drops that axis.
"""
from __future__ import annotations

import contextlib
import math
import re
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.nn as nn

Spec = Tuple[Any, ...]

# (path regex, spec for the TRAILING dims of the leaf)
PARAM_RULES: Tuple[Tuple[str, Tuple[Optional[str], ...]], ...] = (
    (r'embed/table$', ('model', 'data')),
    (r'lm_head/w(/q|/scale)?$', ('data', 'model')),
    # projections with output dim sharded over tensor axis
    (r'(wq|wk|wv|xq|xk|xv|up|gate|in_z|in_xbc|in_dt|w_dkv|w_kpe|w_uk|w_uv)'
     r'/w(/q|/scale)?$', ('data', 'model')),
    # projections back to d_model: input dim over tensor axis
    (r'(wo|xo|down|out_proj)/w(/q|/scale)?$', ('model', 'data')),
    (r'router/w$', ('data', None)),
    # MoE expert banks: expert-parallel over 'model', FSDP over 'data'
    (r'(w_gate|w_up)(/q|/scale)?$', ('model', 'data', None)),
    (r'w_down(/q|/scale)?$', ('model', None, 'data')),
    # mamba per-channel params
    (r'conv_w$', (None, 'model')),
    (r'conv_b$', ('model',)),
    (r'(A_log|D|dt_bias)$', ('model',)),
    # biases / norms: replicated
    (r'/b$', (None,)),
    (r'(scale|bias)$', (None,)),
)

# rules that keep 'model' when model_axis_tp=False (EP-only mode)
_KEEP_MODEL = (r'(w_gate|w_up)(/q|/scale)?$', r'w_down(/q|/scale)?$',
               r'embed/table$', r'lm_head/w(/q|/scale)?$')


class MeshDesc(NamedTuple):
    """A mesh's shape and axis names, all the rules read."""
    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]


def axis_names(mesh) -> Tuple[str, ...]:
    names = getattr(mesh, 'mesh_dim_names', None)
    if names is None:
        names = mesh[1] if isinstance(mesh, tuple) else mesh.axis_names
    return tuple(names)


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh``, a ``MeshDesc`` or a
    ``(shape, axis_names)`` pair."""
    shape = mesh.shape if hasattr(mesh, 'shape') else mesh[0]
    return dict(zip(axis_names(mesh), (int(s) for s in tuple(shape))))


def _axis_size(sizes: Dict[str, int], name: Optional[str]) -> int:
    return 1 if name is None else sizes.get(name, 1)


def param_path(name: str) -> str:
    """The reference's path of the port's parameter ``name``: dots to
    slashes, the unit index of an ``nn.ModuleList`` dropped."""
    return re.sub(r'/\d+(?=/|$)', '', name.replace('.', '/'))


def _fit_spec(spec, shape, sizes, dropped: list, path: str) -> Spec:
    """Left-pad with None to ndim; drop axes that don't divide."""
    full = (None,) * (len(shape) - len(spec)) + tuple(spec)
    full = full[:len(shape)]
    out = []
    for dim, ax in zip(shape, full):
        if ax is not None and ax in sizes and dim % sizes[ax] == 0:
            out.append(ax)
        else:
            if ax is not None:
                dropped.append((path, dim, ax))
            out.append(None)
    return tuple(out)


def param_spec(name: str, shape, mesh, dropped: Optional[list] = None,
               model_axis_tp: bool = True) -> Spec:
    """The spec of one parameter by its port name."""
    sizes = axis_sizes(mesh)
    dropped = [] if dropped is None else dropped
    ps = param_path(name)
    if len(shape) == 0:
        return ()
    for pat, spec in PARAM_RULES:
        if re.search(pat, ps):
            if not model_axis_tp and not any(re.search(k, ps)
                                             for k in _KEEP_MODEL):
                spec = tuple(None if a == 'model' else a for a in spec)
            return _fit_spec(spec, tuple(shape), sizes, dropped, ps)
    return (None,) * len(shape)


def param_pspecs(model: nn.Module, mesh, verbose: bool = False,
                 model_axis_tp: bool = True) -> Dict[str, Spec]:
    """{name: spec} for the float parameters of ``model`` (the names of
    ``launch.steps.train_params``, in that order).

    ``model_axis_tp=False`` (EP-only mode): non-expert weights drop the
    'model' axis and shard FSDP-only; expert banks, embedding and
    lm_head keep it."""
    dropped: list = []
    specs = {n: param_spec(n, p.shape, mesh, dropped, model_axis_tp)
             for n, p in model.named_parameters() if p.is_floating_point()}
    if verbose and dropped:
        for path, dim, ax in dropped[:20]:
            print(f'[sharding] dropped axis {ax!r} on {path} (dim {dim})')
    return specs


def dp_axes(mesh) -> Tuple[str, ...]:
    """The data-parallel axes of a mesh: ('pod','data') when a pod axis
    exists, else ('data',)."""
    return tuple(a for a in axis_names(mesh) if a in ('pod', 'data'))


def dp_spec(mesh, batch: int):
    """The data-parallel sharding of a batch dim (pod+data), or None when
    the batch is too small to shard (long-context decode)."""
    sizes = axis_sizes(mesh)
    axes = dp_axes(mesh)
    if not axes:
        return None
    size = math.prod(sizes[a] for a in axes)
    if batch % size == 0:
        return axes if len(axes) > 1 else axes[0]
    if 'data' in axes and batch % sizes['data'] == 0:
        return 'data'
    return None


def batch_pspecs(mesh, batch: int, ndim: int = 2) -> Spec:
    """Token/label arrays (B, S, ...)."""
    return (dp_spec(mesh, batch),) + (None,) * (ndim - 1)


def _map_tree(fn, tree, prefix: str = ''):
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v, f'{prefix}{k}/') for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tree(fn, v, f'{prefix}{i}/')
                          for i, v in enumerate(tree))
    return fn(prefix[:-1], tree)


def cache_pspecs(cache: Any, mesh, batch: int,
                 shard_seq_when_unbatched: bool = True,
                 mla_cache_seq: bool = False) -> Any:
    """KV / state caches, one spec per leaf in the cache's structure (a
    list of units, ``{'sub{j}': {...}}`` each).  The reference's layout
    with its leading scan dim dropped:
      attn k/v      (B, T, Hkv, hd) -> (dp, seq?, 'model', None)
      mla  c_kv     (B, T, rank)    -> (dp, seq?, None)
      mamba conv    (B, K-1, cd)    -> (dp, None, 'model')
      mamba state   (B, H, P, N)    -> (dp, 'model', None, None)
    When the batch doesn't shard (B=1 long-context), the cache sequence
    dim shards over 'data' instead (sequence parallelism for the cache);
    k/v whose heads do not divide 'model' shard their sequence over it.
    """
    sizes = axis_sizes(mesh)
    dp = dp_spec(mesh, batch)
    seq_ax = 'data' if (dp is None and shard_seq_when_unbatched) else None
    model = _axis_size(sizes, 'model')

    def fit(dims, shape):
        out = []
        for d, ax in zip(shape, dims):
            size = (math.prod(sizes[a] for a in ax)
                    if isinstance(ax, tuple) else _axis_size(sizes, ax))
            out.append(ax if ax is not None and d % size == 0 else None)
        return tuple(out)

    def spec_for(ps, leaf):
        shape = (1,) + tuple(leaf.shape)        # the reference's scan dim
        nd = len(shape)
        if re.search(r'(k|v|c_kv|k_pe)$', ps) and nd >= 4:
            dims = [None, dp, seq_ax]
            if re.search(r'(k|v)$', ps) and nd == 5:
                if shape[3] % model == 0:
                    dims += ['model', None]
                elif seq_ax is None and shape[2] % model == 0:
                    dims = [None, dp, 'model', None, None]
                else:
                    dims += [None, None]
            else:
                if mla_cache_seq and seq_ax is None:
                    dims = [None, dp, 'model']
                dims += [None] * (nd - len(dims))
            return fit(dims[:nd], shape)[1:]
        if re.search(r'conv$', ps):
            return fit([None, dp, None, 'model'][:nd], shape)[1:]
        if re.search(r'state$', ps):
            return fit([None, dp, 'model', None, None][:nd], shape)[1:]
        return (None,) * (nd - 1)

    return _map_tree(spec_for, cache)


# ---------------------------------------------------------------------------
# specs on a DeviceMesh
# ---------------------------------------------------------------------------

def placements(mesh, spec: Spec) -> list:
    """The ``DTensor`` placements of ``spec`` on ``mesh``: ``Shard(d)``
    on each mesh dim named at tensor dim ``d`` (a tuple of axes names
    several, in mesh order, the first the major one, as in JAX), and
    ``Replicate()`` on the others."""
    from torch.distributed.tensor import Replicate, Shard
    names = axis_names(mesh)
    out = [Replicate()] * len(names)
    for d, ax in enumerate(spec):
        axes = ax if isinstance(ax, tuple) else (ax,)
        idx = [names.index(a) for a in axes if a is not None]
        if idx != sorted(idx):
            raise ValueError(f'axes {ax} of dim {d} are not in the mesh '
                             f'order {names}')
        for i in idx:
            if out[i] != Replicate():
                raise ValueError(f'mesh axis {names[i]!r} shards two dims '
                                 f'in {spec}')
            out[i] = Shard(d)
    return out


def distribute(t: torch.Tensor, mesh, spec_or_placements) -> Any:
    """``t``, the same full value on every rank, as a DTensor on ``mesh``
    laid out by a spec (or by DTensor placements): each rank keeps a copy
    of its own chunk, with no communication, so ``t`` can be freed."""
    from torch.distributed.tensor import DTensor, Placement
    pls = list(spec_or_placements)
    if not all(isinstance(p, Placement) for p in pls) or not pls:
        pls = placements(mesh, tuple(spec_or_placements))
    local = t
    for i, pl in enumerate(pls):
        if pl.is_shard():
            n, r = mesh.size(i), mesh.get_local_rank(i)
            local = local.tensor_split(n, dim=pl.dim)[r]
    if local.numel() != t.numel():
        local = local.contiguous().clone()
    return DTensor.from_local(local, mesh, pls, shape=t.shape,
                              stride=t.stride())


def resolve_hint(shape, spec, mesh) -> Spec:
    """``shard_hint``'s spec for a tensor of ``shape``: the sentinel
    ``'dp'`` becomes ``dp_spec`` of its dim, and axes absent from the
    mesh or not dividing their dim are dropped; missing trailing dims
    are replicated."""
    sizes = axis_sizes(mesh)
    out: List[Any] = []
    for dim, ax in zip(shape, spec):
        if ax == 'dp':
            out.append(dp_spec(mesh, dim))
        elif isinstance(ax, str) and ax in sizes and dim % sizes[ax] == 0:
            out.append(ax)
        else:
            out.append(None)
    return tuple(out) + (None,) * (len(shape) - len(out))


def shard_hint(x, *spec):
    """``with_sharding_constraint`` for the port: a ``DTensor`` is
    redistributed to the layout ``spec`` gives on its own mesh
    (``resolve_hint``), and its gradient to the layout it had; a plain
    tensor comes back as it is, as the reference's outside a mesh.
    ``spec`` entries may be axis names, ``None`` or the sentinel ``'dp'``
    (all data-parallel axes)."""
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh
    # always a redistribute, even to the layout x has: its backward brings
    # the gradient to x's layout too, as JAX constrains the cotangent
    return x.redistribute(mesh, placements(mesh, resolve_hint(x.shape, spec,
                                                             mesh)))


def split_dim(x, dim: int, sizes) -> Any:
    """``x`` with dim ``dim`` split into ``sizes`` (a reshape).  On a
    DTensor whose dim is sharded over mesh dims that do not divide
    ``sizes[0]`` (InternLM2's 8 KV heads over a 'model' of 16, say),
    that dim is gathered first: DTensor refuses to split it unevenly."""
    dim = dim % x.dim()
    shape = tuple(x.shape[:dim]) + tuple(sizes) + tuple(x.shape[dim + 1:])
    if is_dtensor(x):
        mesh = x.device_mesh
        n = math.prod(mesh.size(i) for i, pl in enumerate(x.placements)
                      if pl.is_shard(dim))
        if sizes[0] % n:
            from torch.distributed.tensor import Replicate
            x = x.redistribute(mesh, [Replicate() if pl.is_shard(dim)
                                      else pl for pl in x.placements])
    return x.reshape(shape)


class _ContiguousGrad(torch.autograd.Function):
    """The identity, whose gradient comes back contiguous."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def on_shards(fn, n_out: int, *args):
    """``fn`` on each rank's local shards of the DTensor ``args``
    (``local_map``), its ``n_out`` outputs laid out as ``args[0]``: a
    function that needs no communication under that layout (rows of a
    batch, heads), and that DTensor's own rules cannot follow (sorts,
    scatters, reshapes inside einsums; torch 2.11 refuses some of them,
    and on a three-dim mesh the propagation takes minutes).  An argument
    replicated on a mesh dim that splits ``args[0]`` serves every shard,
    so its gradient there is partial.  Inputs' gradients and outputs are
    made contiguous: DTensor views a gradient's local shard as it is, and
    a strided one (an einsum's backward) fails its next reshape.  On
    plain tensors it is ``fn(*args)``."""
    if not is_dtensor(args[0]):
        return fn(*args)
    from torch.distributed.tensor import Partial
    from torch.distributed.tensor.experimental import local_map

    def local(*xs):
        ys = fn(*(_ContiguousGrad.apply(x) if torch.is_tensor(x) and
                  x.requires_grad else x for x in xs))
        if n_out == 1:
            return ys.contiguous()
        return tuple(y.contiguous() for y in ys)

    pl = list(args[0].placements)        # a tuple would name n outputs
    grads = tuple(
        [Partial() if a.is_replicate() and o.is_shard() else a
         for a, o in zip(x.placements, pl)] if is_dtensor(x) else None
        for x in args)
    out = (pl,) * n_out if n_out > 1 else pl
    return local_map(local, out_placements=out, in_grad_placements=grads,
                     device_mesh=args[0].device_mesh)(*args)


class _Lookup(torch.autograd.Function):
    """``table[ids]`` on a mesh; see ``lookup``."""

    @staticmethod
    def forward(ctx, table, ids):
        rows = table.full_tensor()[ids.to_local()]
        ctx.save_for_backward(ids.to_local())
        ctx.meta = (table.device_mesh, table.placements, ids.placements,
                    table.shape)
        from torch.distributed.tensor import DTensor
        return DTensor.from_local(rows, ctx.meta[0], ids.placements)

    @staticmethod
    def backward(ctx, grad):
        from torch.distributed.tensor import DTensor, Partial, Replicate
        (ids,) = ctx.saved_tensors
        mesh, table_pl, ids_pl, shape = ctx.meta
        g = grad.redistribute(mesh, ids_pl).to_local()
        gt = g.new_zeros(shape).index_put_((ids,), g, accumulate=True)
        part = [Partial() if pl.is_shard() else Replicate() for pl in ids_pl]
        return DTensor.from_local(gt, mesh, part).redistribute(
            mesh, table_pl), None


def lookup(table, ids):
    """``table[ids]`` for a DTensor ``table`` (an embedding): the table
    gathered whole, each rank looking up its own ids, the rows laid out
    as the ids.  A rank's gradient of the table is partial over the mesh
    dims that split the ids and reduce-scatters back onto the table's
    placements.  DTensor's own lookup fails: its vocabulary-sharded rule
    on a 2-D id array (a masked partial result), and under torch 2.11
    the backward of the replicated one."""
    from torch.distributed.tensor import DTensor, Replicate
    if not is_dtensor(ids):
        mesh = table.device_mesh
        ids = DTensor.from_local(ids, mesh, [Replicate()] * mesh.ndim)
    return _Lookup.apply(table, ids)


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def replicate(x):
    """A ``DTensor`` replicated on every mesh dim (an all-gather); a
    plain tensor as it is."""
    return shard_hint(x)


_CURRENT: List[Any] = []


def current_mesh():
    """The mesh of the running ``Trainer`` (``use_mesh``), or None."""
    return _CURRENT[-1] if _CURRENT else None


@contextlib.contextmanager
def use_mesh(mesh):
    """Make ``mesh`` the ``current_mesh`` inside the block (None: no
    change)."""
    if mesh is None:
        yield
        return
    _CURRENT.append(mesh)
    try:
        yield mesh
    finally:
        _CURRENT.pop()
