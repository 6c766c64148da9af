"""Hillclimb runs, port of ``repro/launch/hillclimb.py``: run named
variants of the three chosen cells on the fake single-pod mesh and
record their roofline terms under ``results/perf_torch/``.

    PYTHONPATH=src python -m repro_torch.launch.hillclimb --only <variant>

Variants are flag-gated (the framework defaults stay at the recorded
baseline), so every row is reproducible.  The list is the reference's.
"""
import argparse
import dataclasses
import json
import os

from repro_torch.configs.registry import get
from repro_torch.launch.dryrun import production_mesh, release_mesh, run_cell
from repro_torch.optim.adamw import AdamWConfig

OUT = os.path.abspath(os.path.join(os.path.dirname(__file__), '..', '..',
                                   '..', 'results', 'perf_torch'))

# (variant_name, arch, shape, cfg_mods, run_cell kwargs)
VARIANTS = [
    # H1: granite train_4k — worst roofline fraction (collective-bound MoE)
    ('h1_granite_train_moefix', 'granite-moe-1b-a400m', 'train_4k',
     {}, {}),
    ('h1_granite_train_eponly', 'granite-moe-1b-a400m', 'train_4k',
     {'model_axis_tp': False}, {}),
    # H2: mistral train_4k — most collective-bound (absolute)
    ('h2_mistral_train_dots', 'mistral-large-123b', 'train_4k',
     {'remat': 'dots'}, {}),
    ('h2_mistral_train_dots_bf16mom', 'mistral-large-123b', 'train_4k',
     {'remat': 'dots'},
     {'opt_cfg': AdamWConfig(moment_dtype='bfloat16')}),
    # H3: deepseek decode_32k — paper-representative (W8A8 + MLA serving)
    ('h3_deepseek_decode_moefix', 'deepseek-v2-lite-16b', 'decode_32k',
     {}, {}),
    ('h3_deepseek_decode_w8a8', 'deepseek-v2-lite-16b', 'decode_32k',
     {}, {'serve_quant': True}),
    ('h3_deepseek_decode_w8a8_eponly', 'deepseek-v2-lite-16b', 'decode_32k',
     {'model_axis_tp': False}, {'serve_quant': True}),
    ('h3_deepseek_decode_w8a8_eponly_seqcache', 'deepseek-v2-lite-16b',
     'decode_32k', {'model_axis_tp': False},
     {'serve_quant': True, 'mla_cache_seq': True}),
    # fixes promoted from the baseline table
    ('fix_jamba_train_bf16mom', 'jamba-1.5-large-398b', 'train_4k',
     {}, {'opt_cfg': AdamWConfig(moment_dtype='bfloat16')}),
    ('fix_deepseek_train_moefix', 'deepseek-v2-lite-16b', 'train_4k',
     {}, {}),
    ('fix_deepseek_train_eponly', 'deepseek-v2-lite-16b', 'train_4k',
     {'model_axis_tp': False}, {}),
]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--only', default=None)
    ap.add_argument('--skip-existing', action='store_true')
    args = ap.parse_args(argv)
    os.makedirs(OUT, exist_ok=True)
    mesh = production_mesh(multi_pod=False)
    for name, arch, shape, mods, kw in VARIANTS:
        if args.only and args.only not in name:
            continue
        path = os.path.join(OUT, f'{name}.json')
        if args.skip_existing and os.path.exists(path):
            print(f'skip {name}')
            continue
        cfg = dataclasses.replace(get(arch), **mods)
        print(f'=== {name} ===', flush=True)
        r = run_cell(arch, shape, multi_pod=False, mesh=mesh, cfg=cfg, **kw)
        r['variant'] = name
        with open(path, 'w') as f:
            json.dump(r, f, indent=1)
        rf = r['roofline']
        print(f"    compute={rf['compute_s']:.3g}s memory={rf['memory_s']:.3g}s "
              f"coll={rf['collective_s']:.3g}s dominant={rf['dominant']} "
              f"peak={r['memory']['peak_bytes_per_device']/2**30:.2f}GiB",
              flush=True)
    release_mesh()


if __name__ == '__main__':
    main()
