"""Run one benchmark cell of the PyTorch/CUDA port once, on this machine's
GPU, and print its result line.

    python h100bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is ``h100bench/workloads/<cell>.json``; its traffic mix names
the driver that runs the port (``harness/drivers/``).  With ``--trace
0`` the line's metrics are the cell's end-to-end ones and ``setup_s``;
with ``--trace 1`` its per-layer ones, read from a profiled slice of the
window by ``metrics/``, with the device's busy and window seconds and a
``breakdown``.  Either way the window's output is compared with the
plain reference, and each number compared is printed beside its limit,
last on standard error and under ``checks``, last in the line.  Without
a GPU (or with fewer than the cell asks for) it prints no result and
exits 2; with JAX or the JAX package loaded, it exits 3.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

from harness import common  # noqa: E402  (needs the path above)


def _num(x):
    return x if isinstance(x, (int, float)) and math.isfinite(x) else None


def result(cell: common.Cell, seed: int, seconds: float, trace: bool,
           device: str):
    """Run the cell once on ``device``; returns (the result line as a
    dict, the driver's ``Outcome``)."""
    import torch
    out = common.driver(cell.traffic['driver']).run(
        common.Run(cell, seed, seconds, trace, device))
    if trace:
        if out.layers is None:
            raise RuntimeError('the window closed before its traced slice '
                               'began')
        metrics = {}
        for name, unit in cell.workload['per_layer'].items():
            v = common.metric_reader(name).read(out.layers)
            if v is not None:
                metrics[name] = {'value': v, 'unit': unit}
    else:
        metrics = {name: {'value': _num(out.end_to_end[name]), 'unit': unit}
                   for name, unit in cell.workload['end_to_end'].items()}
        metrics['setup_s'] = {'value': out.setup_s, 'unit': 's'}
    cuda = torch.device(device).type == 'cuda'
    dev = {'platform': 'gpu' if cuda else 'cpu',
           'kind': torch.cuda.get_device_name(0) if cuda else 'cpu',
           'count': int(cell.workload['chips']),
           'memory_peak_bytes': out.memory_peak_bytes}
    line = {'correct': all(c.ok for c in out.checks) and out.failed == 0,
            'attempted': out.attempted, 'failed': out.failed,
            'metrics': metrics, 'device': dev}
    if trace:
        sl = out.layers.slice
        dev.update(busy_s=sl.busy_s, window_s=sl.window_s)
        line['breakdown'] = {'device_ops': sl.top_ops(),
                             'idle_gaps': sl.top_gaps()}
    line['checks'] = {c.name: {'value': _num(c.value), 'limit': c.limit}
                      for c in out.checks}
    return line, out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    common.cache_env()
    sys.path.insert(0, str(common.ROOT / 'src'))
    cell = common.Cell.load(args.workload)
    import torch
    chips = int(cell.workload['chips'])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f'{args.workload} needs {chips} CUDA device(s); this machine '
              f'has {torch.cuda.device_count() if torch.cuda.is_available() else 0}',
              file=sys.stderr)
        return 2
    line, out = result(cell, args.seed, args.seconds, bool(args.trace),
                       'cuda')
    bad = common.forbidden_loaded()
    if bad:
        print(f'loaded in this process: {", ".join(bad)}', file=sys.stderr)
        return 3
    for note in out.notes:
        print(note, file=sys.stderr)
    if args.trace:
        sl = out.layers.slice
        print(f'slice: {len(sl.ops)} device operations, '
              f'{sl.kernel_s("")!r} s summed, {sl.busy_s!r} s busy, '
              f'{sl.window_s!r} s wall, {sl.duplicates} reported twice, '
              f'{sl.streams} stream(s), {sl.overlap_s!r} s clipped to '
              f'stream order; the profiler stopped in {sl.exit_s!r} s',
              file=sys.stderr)
    for c in out.checks:
        print(f'check {c.name} {c.value!r} limit {c.limit!r} '
              f'{"ok" if c.ok else "FAILED"}', file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
