"""Roofline report, port of ``repro/launch/roofline.py``: read the dry
run's JSONs and print the table (three terms per cell, the dominant
bound, MODEL_FLOPS over the traced FLOPs).  The CPU suffices.

    PYTHONPATH=src python -m repro_torch.launch.roofline [--dir results/dryrun_torch]
"""
from __future__ import annotations

import argparse
import glob
import json
import math
import os
from typing import Dict

from repro_torch.configs.base import SHAPES
from repro_torch.configs.registry import get
from repro_torch.distributed.sharding import param_path
from repro_torch.launch.dryrun import HBM_BYTES, RESULTS_DIR, _meta_model


def _shapes(arch_name: str):
    """(reference path, shape) of every parameter, on the ``meta``
    device."""
    return [(param_path(n), tuple(p.shape)) for n, p in
            _meta_model(get(arch_name)).named_parameters()]


def count_params(arch_name: str) -> int:
    return sum(math.prod(s) for _, s in _shapes(arch_name))


def active_params(arch_name: str, total: int) -> int:
    """MoE: 6*N_active*D — activated params per token."""
    cfg = get(arch_name)
    if cfg.moe is None and cfg.family != 'hybrid':
        return total
    act = 0
    for p, shape in _shapes(arch_name):
        n = math.prod(shape)
        if any(k in p for k in ('w_gate', 'w_up', 'w_down')):
            m = cfg.moe
            n = n * m.top_k // m.n_experts
        act += n
    return act


def model_flops(arch_name: str, shape_name: str, n_active: int) -> float:
    """MODEL_FLOPS: 6*N*D train, 2*N*D prefill, 2*N*B decode."""
    s = SHAPES[shape_name]
    tokens = s.global_batch * (s.seq_len if s.kind != 'decode' else 1)
    mult = 6.0 if s.kind == 'train' else 2.0
    return mult * n_active * tokens


def load_cells(result_dir: str, mesh_tag: str = 'singlepod'):
    cells = {}
    for path in sorted(glob.glob(os.path.join(result_dir,
                                              f'*__{mesh_tag}.json'))):
        with open(path) as f:
            r = json.load(f)
        cells[(r['arch'], r['shape'])] = r
    return cells


def report(result_dir: str, mesh_tag: str = 'singlepod',
           with_params: bool = True) -> str:
    cells = load_cells(result_dir, mesh_tag)
    lines = []
    lines.append(
        '| arch | shape | compute s | memory s | coll s | dominant | '
        'peak GiB/dev | MODEL_FLOPS/HLO | note |')
    lines.append('|---|---|---|---|---|---|---|---|---|')
    n_cache: Dict[str, int] = {}
    for (arch, shape), r in sorted(cells.items()):
        rf = r['roofline']
        dev = r['devices']
        ratio = ''
        note = ''
        if with_params:
            if arch not in n_cache:
                total = count_params(arch)
                n_cache[arch] = active_params(arch, total)
            mf = model_flops(arch, shape, n_cache[arch])
            hlo_global = r['cost']['flops_per_device'] * dev
            if hlo_global > 0:
                ratio = f'{mf / hlo_global:.2f}'
        dom = rf['dominant'].replace('_s', '')
        peak_bytes = r['memory']['peak_bytes_per_device']
        if peak_bytes > HBM_BYTES:
            note = 'OVER 80 GB H100'
        lines.append(
            f'| {arch} | {shape} | {rf["compute_s"]:.3g} | '
            f'{rf["memory_s"]:.3g} | {rf["collective_s"]:.3g} | {dom} | '
            f'{peak_bytes / 2 ** 30:.2f} | {ratio} | {note} |')
    return '\n'.join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--dir', default=RESULTS_DIR)
    ap.add_argument('--mesh', default='singlepod')
    ap.add_argument('--no-params', action='store_true')
    args = ap.parse_args(argv)
    print(report(os.path.abspath(args.dir), args.mesh,
                 with_params=not args.no_params))


if __name__ == '__main__':
    main()
