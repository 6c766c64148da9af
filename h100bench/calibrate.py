"""Readings the limits of ``correct`` are set from, on the GPU, in one
process: the program's comparison with the plain reference over many
seeds, and the controls' (the reference in a lower precision, put in the
program's place) over the first three.

    python h100bench/calibrate.py --workload <cell> --seeds 1,2,3 \\
        --seconds <s> [--controls tf32,int4] [--set key=json ...] \\
        [--fault half_rows]

Each seed runs the cell's driver once (set-up, a window of ``--seconds``,
the comparison) and prints one JSON line: the seed, its end-to-end
values and every reading (``image_rel_rms``, ``control_tf32_...``).
``--set`` overrides a key of the cell's traffic mix (a rate for a sweep,
a shorter list of prompt lengths), and the line says so; ``--fault``
plants a fault in the program first (a training cell's upper readings).
The same runs with ``--controls`` empty measure where the end-to-end
values sit at a mix's rate: the knee sweep of an open loop.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

from harness import common  # noqa: E402

CONTROLS = {'tf32': dict(float_mode='tf32'), 'bf16': dict(float_mode='bf16'),
            'int4': dict(qbits=4), 'noise_off': dict(analog=False),
            'tick_shift': dict(tick_shift=1)}
#: the seeds, from the first, that also read the controls
CONTROL_SEEDS = 3


def _half_rows() -> None:
    """A training fault: the loss over the first half of the batch's rows
    only, the mean taken over them."""
    from repro_torch.launch import steps as ST
    orig = ST.train_loss

    def loss(model, cfg, batch, *a, **k):
        half = {n: t[:t.shape[0] // 2] for n, t in batch.items()}
        return orig(model, cfg, half, *a, **k)
    ST.train_loss = loss


#: faults planted in the program for the run (training cells' upper
#: readings): name -> what plants it
FAULTS = {'half_rows': _half_rows}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seeds', required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--controls', default='')
    ap.add_argument('--set', action='append', default=[])
    ap.add_argument('--fault', choices=sorted(FAULTS))
    args = ap.parse_args(argv)
    common.cache_env()
    sys.path.insert(0, str(common.ROOT / 'src'))
    import torch
    from reference.numerics import Numerics
    if not torch.cuda.is_available():
        print('calibration runs on a GPU', file=sys.stderr)
        return 2
    cell = common.Cell.load(args.workload)
    overrides = {}
    for kv in args.set:
        k, v = kv.split('=', 1)
        overrides[k] = json.loads(v)
    cell.traffic.update(overrides)
    controls = {n: Numerics(**CONTROLS[n]) for n in args.controls.split(',')
                if n}
    drv = common.driver(cell.traffic['driver'])
    if args.fault:
        FAULTS[args.fault]()
    for i, seed in enumerate(int(s) for s in args.seeds.split(',')):
        out = drv.run(common.Run(cell, seed, args.seconds, False, 'cuda',
                                 controls if i < CONTROL_SEEDS else {}))
        print(json.dumps({'seed': seed, 'overrides': overrides,
                          'fault': args.fault,
                          'end_to_end': out.end_to_end,
                          'readings': out.readings,
                          'attempted': out.attempted, 'failed': out.failed,
                          'memory_peak_bytes': out.memory_peak_bytes,
                          'notes': out.notes}), flush=True)
        del out
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == '__main__':
    sys.exit(main())
