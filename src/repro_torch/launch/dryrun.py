"""Multi-pod dry run on a fake mesh, port of ``repro/launch/dryrun.py``:
for every (arch x shape x mesh) cell, does the step fit in a card's
memory, what does each card compute and move, and which bound wins.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh both --arch all

The reference lowers and compiles its jitted step on placeholder CPU
devices and reads XLA's analyses.  The port runs its own eager step
once, on fake tensors (``FakeTensorMode``, on the CPU, so nothing is
allocated), with DTensor parameters, optimizer moments, batch and caches
on a ``DeviceMesh`` over a fake process group of the mesh's size (256
ranks for the single-pod (16, 16), 512 for the multi-pod (2, 16, 16)),
and counts what rank 0 does (``trace_cell``):

- FLOPs: ``torch.utils.flop_counter``'s formulas (matmuls, convolutions,
  attention), applied only to ops on a rank's local tensors.  DTensor's
  own op on global shapes and the shadow op its sharding propagation
  runs to infer an output's shape are not counted.
- Bytes accessed: the input and output bytes of every local op that is
  not a view or a collective.  The step is eager, so this is its
  unfused traffic: an upper bound for a fused program.
- Collectives: the functional collectives DTensor issues
  (``_c10d_functional.all_gather_into_tensor``, ``reduce_scatter_tensor``,
  ``all_reduce``, ``all_to_all_single`` and their coalesced forms), each
  one's output bytes per rank under the reference's kind names.  On a
  CPU mesh DTensor does an all-to-all as an all-gather and a chunk, and
  a tensor partial over several mesh dims reduces with one all-reduce
  per dim; the record names both (``fallbacks``).
- Peak memory: the live storages of the rank's local tensors over the
  step, its arguments included.

The kernels' wrappers see CPU tensors and run their plain versions, as
the reference's dry run lowers its jnp oracle; ``kernels/ops.py`` raises
rather than launch on a fake CUDA tensor.

The roofline prices the card (H100 SXM, published data-sheet peaks):
``compute_s`` is FLOPs over the dense bf16 peak, ``memory_s`` bytes over
the HBM rate, and ``collective_s`` one term, the sum over collectives of
ring-weighted bytes (all-reduce 2x, the rest 1x) over NVLink's rate
when the collective's group lies within one host of ``HOST_CARDS``
consecutive ranks, else over the network rate of one card.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import logging
import math
import os
import time
import traceback
import weakref
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn as nn

from repro_torch.configs.base import SHAPES, ArchConfig, ShapeConfig, shape_cells
from repro_torch.configs.registry import ARCHS, REAL_VOCABS, get
from repro_torch.distributed import sharding as SH
from repro_torch.launch import steps as ST
from repro_torch.optim.adamw import AdamWConfig, AdamWState

RESULTS_DIR = os.path.join(os.path.dirname(__file__), '..', '..', '..',
                           'results', 'dryrun_torch')

# --- hardware constants: one H100 SXM5 (NVIDIA's data sheet, dense) --------
PEAK_FLOPS_BF16 = 989e12          # bf16 tensor cores, per card
HBM_BW = 3.35e12                  # B/s, HBM3, per card
NVLINK_BW = 450e9                 # B/s each way per card, to the host's cards
NET_BW = 50e9                     # B/s per card between hosts: one 400 Gb/s
                                  # NDR InfiniBand link per card
HBM_BYTES = 80e9                  # device memory per card
HOST_CARDS = 8                    # cards on one NVLink host

# ring-cost weights: an all-reduce moves ~2x its payload, the others ~1x
WEIGHTS = {'all-gather': 1.0, 'all-reduce': 2.0, 'reduce-scatter': 1.0,
           'all-to-all': 1.0, 'collective-permute': 1.0}

# functional collective -> the reference's kind name
_KINDS = (('all_gather', 'all-gather'), ('reduce_scatter', 'reduce-scatter'),
          ('all_reduce', 'all-reduce'), ('all_to_all', 'all-to-all'), ('alltoall', 'all-to-all'))
_COLLECTIVE_NS = ('_c10d_functional', '_c10d_functional_autograd',
                  '_dtensor')


def parse_collectives(collectives: List[Tuple[str, int, bool]]
                      ) -> Dict[str, Any]:
    """Sum the per-rank output bytes of every collective, ``(kind, bytes,
    within_host)`` as ``trace_cell`` records them, with ring-cost
    weighting (all-reduce ~2x, the others ~1x the payload).  Besides the
    reference's keys, ``weighted_bytes_host`` is the share whose group
    lies within one host (priced at NVLink's rate)."""
    per_kind: Dict[str, float] = {}
    count: Dict[str, int] = {}
    host = 0.0
    for kind, b, within in collectives:
        per_kind[kind] = per_kind.get(kind, 0.0) + b
        count[kind] = count.get(kind, 0) + 1
        if within:
            host += b * WEIGHTS[kind]
    weighted = sum(per_kind.get(k, 0.0) * w for k, w in WEIGHTS.items())
    return {'bytes_per_kind': per_kind, 'count_per_kind': count,
            'weighted_bytes': weighted, 'weighted_bytes_host': host}


def collective_seconds(weighted: float, weighted_host: float) -> float:
    return weighted_host / NVLINK_BW + (weighted - weighted_host) / NET_BW


# ---------------------------------------------------------------------------
# the fake mesh
# ---------------------------------------------------------------------------

def fake_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...]):
    """A CPU ``DeviceMesh`` of ``shape`` named ``axes`` over a fake process
    group of ``prod(shape)`` ranks, this process rank 0: collectives
    return at once and move nothing.  A fake group of another size is
    replaced; a real process group is refused."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed import fake_pg
    n = math.prod(shape)
    if dist.is_initialized():
        if dist.get_backend() != 'fake':
            raise RuntimeError(
                f'the dry run needs a fake process group of {n} ranks, and '
                f'this process already runs a real one '
                f'({dist.get_backend()}, {dist.get_world_size()} ranks): '
                'run it in a process of its own')
        if dist.get_world_size() != n:
            dist.destroy_process_group()
    if not dist.is_initialized():
        dist.init_process_group('fake', store=fake_pg.FakeStore(), rank=0,
                                world_size=n)
    return init_device_mesh('cpu', tuple(shape), mesh_dim_names=tuple(axes))


def release_mesh() -> None:
    """Destroy the fake process group, if one is up."""
    import torch.distributed as dist
    if dist.is_initialized() and dist.get_backend() == 'fake':
        dist.destroy_process_group()


def production_mesh(multi_pod: bool):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ('pod', 'data', 'model') if multi_pod else ('data', 'model')
    return fake_mesh(shape, axes)


# ---------------------------------------------------------------------------
# stand-ins and specs
# ---------------------------------------------------------------------------

def _meta_model(cfg: ArchConfig) -> nn.Module:
    from repro_torch.models import encdec as ED
    from repro_torch.models import transformer as T
    cls = ED.EncDec if cfg.family == 'encdec' else T.LM
    return cls(cfg, 'meta')


def model_specs(model: nn.Module, mesh, model_axis_tp: bool = True
                ) -> Dict[str, SH.Spec]:
    """``param_pspecs`` over the float parameters and the quantized
    weights' ``q`` and ``scale`` (the reference's ``QTensor`` leaves,
    whose rule the reference matches on the weight's own path)."""
    from repro_torch.models.layers import QWeight
    specs = SH.param_pspecs(model, mesh, model_axis_tp=model_axis_tp)
    for mname, mod in model.named_modules():
        if isinstance(mod, QWeight):
            for b in ('q', 'scale'):
                specs[f'{mname}.{b}'] = SH.param_spec(
                    mname, getattr(mod, b).shape, mesh,
                    model_axis_tp=model_axis_tp)
    return specs


def _big_arch(cfg: ArchConfig) -> bool:
    """>100B archs default to bf16 optimizer moments (the reference's)."""
    return cfg.name.split('-smoke')[0] in ('mistral-large-123b',
                                           'jamba-1.5-large-398b')


def input_specs(cfg: ArchConfig, shape: ShapeConfig, mesh,
                serve_params_bf16: bool = True,
                opt_cfg: Optional[AdamWConfig] = None,
                serve_quant: bool = False,
                mla_cache_seq: bool = False,
                dtype: Optional[torch.dtype] = None):
    """Stand-ins on the ``meta`` device and specs for one cell.  Returns
    (fn, args tuple, specs tuple, donate_argnums), as the reference's:
    train (model, AdamWState, batch), prefill (model, serve state,
    batch), decode (model, serve state, token (B, 1), pos ()).  A model's
    specs are ``{name: spec}`` over ``model_specs``; the optimizer's are
    an ``AdamWState`` of ``()`` and the moments' lists.  ``mesh`` may be
    a ``DeviceMesh`` (the train step then takes the global batch and lays
    it out on it) or a ``MeshDesc``.  ``dtype``: the steps' compute type
    and the serving cache's (default bfloat16, the reference's)."""
    dtype = dtype or torch.bfloat16
    model = _meta_model(cfg)
    B, S = shape.global_batch, shape.seq_len
    real_vocab = REAL_VOCABS.get(cfg.name.replace('-smoke', ''), None)
    tp = cfg.model_axis_tp

    if shape.kind == 'train':
        if opt_cfg is None:
            opt_cfg = AdamWConfig(moment_dtype='bfloat16' if _big_arch(cfg)
                                  else 'float32')
        p_specs = model_specs(model, mesh, tp)
        params = ST.train_params(model)
        mdt = getattr(torch, opt_cfg.moment_dtype)
        moments = lambda: [torch.empty(p.shape, dtype=mdt, device='meta')
                           for p in params.values()]
        opt = AdamWState(torch.empty((), dtype=torch.int32, device='meta'),
                         moments(), moments())
        m_specs = [p_specs[n] for n in params]
        o_specs = AdamWState((), m_specs, list(m_specs))
        batch = ST.make_batch_struct(cfg, shape)
        b_specs = {k: SH.batch_pspecs(mesh, B, v.dim())
                   for k, v in batch.items()}
        fn = ST.build_train_step(
            cfg, opt_cfg, real_vocab, dtype=dtype,
            mesh=mesh if hasattr(mesh, 'device_type') else None)
        return (fn, (model, opt, batch), (p_specs, o_specs, b_specs), (0, 1))

    if serve_quant:
        from repro_torch.core.quantization import quantize_params
        model = quantize_params(model)
    elif serve_params_bf16:
        model = model.to(torch.bfloat16)
    p_specs = model_specs(model, mesh, tp)
    state = ST.init_serve_state(cfg, B, S, cache_dtype=dtype,
                                device='meta')
    c_specs = SH.cache_pspecs(state, mesh, B, mla_cache_seq=mla_cache_seq)
    if cfg.family == 'encdec':
        c_specs['memory'] = (SH.dp_spec(mesh, B), None, None)
    if shape.kind == 'prefill':
        batch = ST.make_batch_struct(cfg, shape)
        batch.pop('labels')
        b_specs = {k: SH.batch_pspecs(mesh, B, v.dim())
                   for k, v in batch.items()}
        fn = ST.build_prefill_step(cfg, dtype=dtype, quant=serve_quant)
        return (fn, (model, state, batch), (p_specs, c_specs, b_specs), (1,))
    token = torch.empty((B, 1), dtype=torch.int32, device='meta')
    pos = torch.empty((), dtype=torch.int32, device='meta')
    fn = ST.build_decode_step(cfg, dtype=dtype, quant=serve_quant)
    return (fn, (model, state, token, pos),
            (p_specs, c_specs, SH.batch_pspecs(mesh, B, 2), ()), (1,))


def _leaves(tree, specs):
    """(tensor, spec) pairs of a stand-in and its specs."""
    if isinstance(tree, nn.Module):
        named = dict(tree.named_parameters())
        named.update(tree.named_buffers())
        for n, t in named.items():
            yield t, specs.get(n, (None,) * t.dim())
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, specs[k])
    elif isinstance(tree, (list, tuple)):
        for v, s in zip(tree, specs):
            yield from _leaves(v, s)
    elif isinstance(tree, torch.Tensor):
        yield tree, specs


def local_shape(shape, spec, mesh) -> Tuple[int, ...]:
    """A rank's shard of a tensor of ``shape`` laid out by ``spec``."""
    sizes = SH.axis_sizes(mesh)
    out = []
    for d, ax in zip(shape, tuple(spec) + (None,) * len(shape)):
        axes = ax if isinstance(ax, tuple) else (ax,)
        out.append(d // math.prod(sizes.get(a, 1) for a in axes
                                  if a is not None))
    return tuple(out)


def argument_bytes(args, specs, mesh) -> int:
    """Per-device bytes of a cell's arguments (shape arithmetic)."""
    return sum(math.prod(local_shape(t.shape, s, mesh)) * t.element_size()
               for a, sp in zip(args, specs) for t, s in _leaves(a, sp))


# ---------------------------------------------------------------------------
# the trace
# ---------------------------------------------------------------------------

class OpCounter:
    """FLOPs, bytes, collectives and live storage of a rank's local ops;
    see the module docstring.  ``shadow`` > 0 while DTensor's sharding
    propagation runs an op on global shapes (not counted)."""

    def __init__(self, record: bool = False):
        from torch.utils.flop_counter import flop_registry
        from torch.utils.weak import WeakIdKeyDictionary
        self.registry = flop_registry
        # with ``record``: every storage made, (op, shape, dtype, bytes),
        # and those live at the peak
        self.record = record
        self.made: List[Tuple[str, Tuple[int, ...], str, int]] = []
        self.at_peak: List[Tuple[str, Tuple[int, ...], str, int]] = []
        self._what = WeakIdKeyDictionary()
        self.flops = 0
        self.bytes = 0
        self.collectives: List[Tuple[str, int, bool]] = []
        self.live = self.peak = 0
        self.shadow = 0
        self.fallbacks: Dict[str, int] = {}
        self._storages = WeakIdKeyDictionary()
        self._groups: Dict[str, bool] = {}

    def _free(self, n: int) -> None:
        self.live -= n

    def track(self, t: torch.Tensor, op: str = 'argument') -> None:
        st = t.untyped_storage()
        if st in self._storages:
            return
        n = st.nbytes()
        self._storages[st] = n
        weakref.finalize(st, self._free, n)
        self.live += n
        if self.record:
            self._what[st] = (op, tuple(t.shape),
                              str(t.dtype).replace('torch.', ''), n)
            self.made.append(self._what[st])
        if self.live > self.peak:
            self.peak = self.live
            if self.record:
                self.at_peak = list(self._what.values())

    def _within_host(self, group_name: str) -> bool:
        if group_name not in self._groups:
            import torch.distributed as dist
            from torch.distributed.distributed_c10d import \
                _resolve_process_group
            ranks = dist.get_process_group_ranks(
                _resolve_process_group(group_name))
            self._groups[group_name] = len({r // HOST_CARDS
                                            for r in ranks}) == 1
        return self._groups[group_name]

    def collective(self, func, args, kwargs, out) -> None:
        name = func._schema.name.split('::')[1]
        kind = next(k for p, k in _KINDS if p in name)
        names = [a.name for a in func._schema.arguments]
        group = kwargs.get('group_name') or args[names.index('group_name')]
        n = sum(_nbytes(t) for t in _tensors(out))
        self.collectives.append((kind, n, self._within_host(group)))


def _tensors(tree):
    from torch.utils._pytree import tree_leaves
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _counting_mode(counter: OpCounter):
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode

    skip = {torch.ops.prim.device.default}

    class Mode(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if any(issubclass(t, DTensor) for t in types):
                return NotImplemented       # DTensor runs the local ops
            if counter.shadow or func in skip:
                return func(*args, **kwargs)
            out = func(*args, **kwargs)
            packet = func._overloadpacket
            if packet in counter.registry:
                counter.flops += counter.registry[packet](
                    *args, **kwargs, out_val=out)
            outs = _tensors(out)
            if func.namespace in _COLLECTIVE_NS:
                if func._schema.name.split('::')[1] != 'wait_tensor':
                    counter.collective(func, args, kwargs, out)
            elif not getattr(func, 'is_view', False) and outs:
                counter.bytes += sum(_nbytes(t) for t in
                                     _tensors((args, kwargs)) + outs)
            for t in outs:
                counter.track(t, func.__name__)
            return out

    return Mode()


@contextlib.contextmanager
def _shadow_guard(counter: OpCounter):
    """Raise ``counter.shadow`` while DTensor infers an output's metadata
    by running the op on global-shape stand-ins."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    name = next(n for n in ('_propagate_tensor_meta_non_cached',
                            '_propagate_tensor_meta')
                if n in ShardingPropagator.__dict__)
    orig = ShardingPropagator.__dict__[name]

    def shadowed(self, *a, **k):
        counter.shadow += 1
        try:
            return orig(self, *a, **k)
        finally:
            counter.shadow -= 1

    setattr(ShardingPropagator, name, shadowed)
    try:
        yield
    finally:
        setattr(ShardingPropagator, name, orig)


@contextlib.contextmanager
def _true_alltoall():
    """DTensor's resharding all-to-all as on a CUDA mesh, one
    ``_dtensor.shard_dim_alltoall`` (the fake group carries it), where a
    CPU mesh falls back on an all-gather of the whole group and a chunk."""
    from torch.distributed.tensor import placement_types as PT
    orig = PT.shard_dim_alltoall

    def alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
        return torch.ops._dtensor.shard_dim_alltoall(
            input, gather_dim, shard_dim, mesh.get_group(mesh_dim).group_name)

    PT.shard_dim_alltoall = alltoall
    try:
        yield
    finally:
        PT.shard_dim_alltoall = orig


class _FallbackLog(logging.Handler):
    """Counts DTensor's notes of the CPU mesh's fallbacks: an all-to-all
    done as an all-gather and a chunk, and sequential all-reduces over
    several mesh dims.  DTensor notes each kind once per process (per
    mesh and dims for the second), so these are lower bounds."""

    def __init__(self):
        super().__init__(logging.WARNING)
        self.counts = {'all-to-all as all-gather + chunk': 0,
                       'sequential all-reduces': 0}

    def emit(self, record):
        msg = record.getMessage()
        if 'alltoall' in msg:
            self.counts['all-to-all as all-gather + chunk'] += 1
        elif 'sequential' in msg:
            self.counts['sequential all-reduces'] += 1


@contextlib.contextmanager
def count_ops(record: bool = False):
    """Count what the block's local ops do (an ``OpCounter``, with the
    CPU mesh's ``fallbacks`` beside it): DTensor's shadow ops are left
    out and its resharding all-to-alls are real ones."""
    counter, log = OpCounter(record), _FallbackLog()
    loggers = [logging.getLogger(n) for n in (
        'torch.distributed.tensor._collective_utils',
        'torch.distributed.tensor._redistribute')]
    for lg in loggers:
        lg.addHandler(log)
    counter.fallbacks = log.counts
    try:
        with _shadow_guard(counter), _true_alltoall(), \
                _counting_mode(counter):
            yield counter
    finally:
        for lg in loggers:
            lg.removeHandler(log)


def _dtensor(t: torch.Tensor, spec, mesh):
    """A fake rank-0 shard of ``t``'s shape laid out by ``spec`` on
    ``mesh``, as a DTensor (a plain fake tensor for a 0-d one)."""
    from torch.distributed.tensor import DTensor
    local = torch.zeros(local_shape(t.shape, spec, mesh), dtype=t.dtype)
    if t.dim() == 0:
        return local
    return DTensor.from_local(local, mesh, SH.placements(mesh, spec),
                              shape=t.shape, stride=torch.empty(
                                  t.shape, device='meta').stride())


def _place_model(model: nn.Module, specs, mesh, grad: bool) -> None:
    for mname, mod in model.named_modules():
        for store in (mod._parameters, mod._buffers):
            for n, t in list(store.items()):
                if t is None:
                    continue
                full = f'{mname}.{n}' if mname else n
                d = _dtensor(t, specs.get(full, (None,) * t.dim()), mesh)
                store[n] = (nn.Parameter(d, requires_grad=grad and
                                         t.is_floating_point())
                            if store is mod._parameters else d)


def _place(tree, specs, mesh):
    if isinstance(tree, dict):
        return {k: _place(v, specs[k], mesh) for k, v in tree.items()}
    if isinstance(tree, AdamWState):
        return AdamWState(*(_place(v, s, mesh) for v, s in zip(tree, specs)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_place(v, s, mesh) for v, s in zip(tree, specs))
    return _dtensor(tree, specs, mesh)


def _locals(*trees):
    """The rank's local tensors of ``trees`` (modules, pytrees)."""
    from torch.distributed.tensor import DTensor
    out = []
    for tree in trees:
        if isinstance(tree, nn.Module):
            tree = list(tree.parameters()) + list(tree.buffers())
        out += [t._local_tensor if isinstance(t, DTensor) else t
                for t in _tensors(tree)]
    return out


def trace_cell(cfg: ArchConfig, shape: ShapeConfig, mesh,
               record: bool = False, **kw) -> Dict[str, Any]:
    """Run the cell's step once on fake tensors laid out on ``mesh`` (a
    fake ``DeviceMesh``) and count, for rank 0: ``flops``,
    ``bytes_accessed``, ``collectives`` (``parse_collectives``),
    ``argument_bytes``, ``output_bytes``, ``peak_bytes_per_device`` and
    the CPU mesh's ``fallbacks``.  ``record`` adds the storages the step
    made (``storages_made``) and those live at the peak
    (``storages_at_peak``), each as (op, shape, dtype, bytes)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor.experimental import implicit_replication
    fn, args, specs, _ = input_specs(cfg, shape, mesh, **kw)
    with FakeTensorMode(allow_non_fake_inputs=True):
        model = args[0]
        _place_model(model, specs[0], mesh, grad=shape.kind == 'train')
        if shape.kind == 'train':
            # the step lays the global batch out on the mesh itself
            placed = (model, _place(args[1], specs[1], mesh),
                      {k: torch.zeros(v.shape, dtype=v.dtype)
                       for k, v in args[2].items()})
            call = lambda: fn(*placed)
            arg_locals = _locals(*placed[:2])
        else:
            state = _place(args[1], specs[1], mesh)
            rest = [_place(a, s, mesh) for a, s in zip(args[2:], specs[2:])]
            if shape.kind == 'decode':
                rest[-1] = shape.seq_len - 1     # the last cache row
            placed = (model, state, *rest)

            def call():
                with SH.use_mesh(mesh), implicit_replication():
                    return fn(*placed)
            arg_locals = _locals(model, state, rest[0])
        with count_ops(record) as counter:
            for t in arg_locals:
                counter.track(t)
            out = call()
        out_bytes = sum({id(st): st.nbytes() for st in (
            t.untyped_storage() for t in _locals(*out))}.values())
    out = {'flops': float(counter.flops),
           'bytes_accessed': float(counter.bytes),
           'collectives': parse_collectives(counter.collectives),
           'argument_bytes': argument_bytes(args, specs, mesh),
           'output_bytes': int(out_bytes),
           'peak_bytes_per_device': int(counter.peak),
           'fallbacks': dict(counter.fallbacks)}
    if record:
        out['storages_made'] = counter.made
        out['storages_at_peak'] = counter.at_peak
    return out


# ---------------------------------------------------------------------------
# cells
# ---------------------------------------------------------------------------

def _scan_units(cfg: ArchConfig) -> int:
    if cfg.family == 'encdec':
        return 1
    from repro_torch.models.transformer import _block_kinds
    return len(_block_kinds(cfg))


def _cost(t: Dict[str, Any]) -> Tuple[float, float, float, float]:
    c = t['collectives']
    return (t['flops'], t['bytes_accessed'], c['weighted_bytes'],
            c['weighted_bytes_host'])


def cost_probe(cfg: ArchConfig, shape: ShapeConfig, mesh,
               **kw) -> Dict[str, Any]:
    """The reference's depth-U and depth-2U probe, extrapolated linearly
    to the full depth (every per-layer cost is affine in depth).  XLA
    counts a scanned body once, so the reference needs it; the port's
    eager trace runs every layer, so ``run_cell``'s full-depth count is
    exact, and the probe checks it (the tests hold them equal)."""
    U = _scan_units(cfg)
    vals = []
    for mult in (1, 2):
        if cfg.family == 'encdec':
            pc = dataclasses.replace(cfg, n_layers=mult, n_enc_layers=mult)
            steps_full = cfg.n_layers
        else:
            pc = dataclasses.replace(cfg, n_layers=U * mult)
            steps_full = cfg.n_layers // U
        vals.append(_cost(trace_cell(pc, shape, mesh, **kw)))
    k = steps_full - 1
    ext = [a + (b - a) * k for a, b in zip(*vals)]
    return {
        'scan_units': U, 'steps_full': steps_full,
        'flops_per_device': ext[0],
        'bytes_accessed_per_device': ext[1],
        'collective_bytes_per_device': ext[2],
        'collective_bytes_host_per_device': ext[3],
        'probe_raw': {'depth_1U': vals[0], 'depth_2U': vals[1]},
    }


def run_cell(arch_name: str, shape_name: str, multi_pod: bool,
             mesh=None, out_dir: Optional[str] = None,
             with_probe: bool = True,
             cfg: Optional[ArchConfig] = None, **kw) -> Dict[str, Any]:
    """Trace one cell at full depth on ``mesh`` (default: the fake
    production mesh) and price it.  ``cost`` holds the full-depth counts;
    with ``with_probe`` also the probe's ``scan_units``, ``steps_full``
    and ``probe_raw`` (with its extrapolation under ``extrapolated``).
    ``compile_s`` is the trace's seconds."""
    cfg = cfg or get(arch_name)
    shape = SHAPES[shape_name]
    mesh = mesh or production_mesh(multi_pod)
    sizes = SH.axis_sizes(mesh)
    t0 = time.time()
    tr = trace_cell(cfg, shape, mesh, **kw)
    t_trace = time.time() - t0
    flops, bytes_accessed, coll_bytes, coll_host = _cost(tr)
    cost = {'flops_per_device': flops,
            'bytes_accessed_per_device': bytes_accessed,
            'collective_bytes_per_device': coll_bytes,
            'collective_bytes_host_per_device': coll_host}
    if with_probe:
        probe = cost_probe(cfg, shape, mesh, **kw)
        cost.update(scan_units=probe['scan_units'],
                    steps_full=probe['steps_full'],
                    probe_raw=dict(probe['probe_raw'], extrapolated=[
                        probe[k] for k in (
                            'flops_per_device', 'bytes_accessed_per_device',
                            'collective_bytes_per_device',
                            'collective_bytes_host_per_device')]))
    result = {
        'arch': arch_name, 'shape': shape_name,
        'mesh': sizes, 'devices': math.prod(sizes.values()),
        'compile_s': round(t_trace, 1),
        'memory': {
            'argument_bytes': tr['argument_bytes'],
            'output_bytes': tr['output_bytes'],
            'peak_bytes_per_device': tr['peak_bytes_per_device'],
        },
        'cost': cost,
        'collectives_scanned_body': tr['collectives'],
        'fallbacks': tr['fallbacks'],
        'roofline': {
            'compute_s': flops / PEAK_FLOPS_BF16,
            'memory_s': bytes_accessed / HBM_BW,
            'collective_s': collective_seconds(coll_bytes, coll_host),
        },
    }
    r = result['roofline']
    r['dominant'] = max(('compute_s', 'memory_s', 'collective_s'),
                        key=lambda k: r[k])
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        tag = 'multipod' if multi_pod else 'singlepod'
        path = os.path.join(out_dir, f'{arch_name}__{shape_name}__{tag}.json')
        with open(path, 'w') as f:
            json.dump(result, f, indent=1)
    return result


def cells_for(arch_name: str):
    return [s.name for s in shape_cells(get(arch_name))]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--arch', default='all')
    ap.add_argument('--shape', default='all')
    ap.add_argument('--mesh', default='both',
                    choices=['single', 'multi', 'both'])
    ap.add_argument('--out', default=os.path.abspath(RESULTS_DIR))
    ap.add_argument('--skip-existing', action='store_true')
    args = ap.parse_args(argv)
    archs = sorted(ARCHS) if args.arch == 'all' else args.arch.split(',')
    meshes = {'single': [False], 'multi': [True],
              'both': [False, True]}[args.mesh]
    failures = []
    for multi in meshes:
        mesh = production_mesh(multi)
        tag = 'multipod' if multi else 'singlepod'
        for a in archs:
            shapes = (cells_for(a) if args.shape == 'all'
                      else args.shape.split(','))
            for s in shapes:
                if s not in cells_for(a):
                    print(f'SKIP {a} x {s} ({tag}): cell not live '
                          '(full-attention arch, see DESIGN.md)')
                    continue
                path = os.path.join(args.out, f'{a}__{s}__{tag}.json')
                if args.skip_existing and os.path.exists(path):
                    print(f'skip existing {a} x {s} ({tag})')
                    continue
                print(f'=== {a} x {s} ({tag}) ===', flush=True)
                try:
                    r = run_cell(a, s, multi, mesh=mesh, out_dir=args.out)
                    print(f'    ok: trace={r["compile_s"]}s '
                          f'peak/dev={r["memory"]["peak_bytes_per_device"]/2**30:.2f}GiB '
                          f'dominant={r["roofline"]["dominant"]}', flush=True)
                except Exception as e:
                    failures.append((a, s, tag, repr(e)))
                    traceback.print_exc()
    release_mesh()
    if failures:
        print('\nFAILURES:')
        for f in failures:
            print(' ', f)
        raise SystemExit(1)
    print('\nALL CELLS PASSED')


if __name__ == '__main__':
    main()
