"""State-of-the-art comparison points (paper Figs. 9-10).

The paper reports only *ratios* against CPU / GPU / DeepCache / FPGA_Acc1 /
FPGA_Acc2 / PACE (the figures' absolute axes are not tabulated).  We
therefore anchor each baseline from the published average improvement
factors and DiffLight's simulated average — making the Fig. 9/10 benchmark a
consistency check of the claimed ratios, NOT an independent measurement of
the baselines.  The independently-reproduced results are the Fig. 8 ablation
(3x energy) and the DSE; this is recorded in EXPERIMENTS.md.

Published average factors (paper §V-B):
  GOPS:  CPU 59.5x, GPU 51.89x, DeepCache 192x, FPGA_Acc1 572x,
         FPGA_Acc2 94x, PACE 5.5x
  EPB (lower is better): CPU 32.9x, GPU 94.18x, DeepCache 376x,
         FPGA_Acc1 67x, FPGA_Acc2 3x, PACE 4.51x
"""
from __future__ import annotations

import dataclasses
from typing import Dict

GOPS_IMPROVEMENT = {
    'CPU (Xeon E5-2676v3)': 59.5,
    'GPU (RTX 4070)': 51.89,
    'DeepCache': 192.0,
    'FPGA_Acc1 (SDAcc)': 572.0,
    'FPGA_Acc2 (SDA)': 94.0,
    'PACE': 5.5,
}

EPB_IMPROVEMENT = {
    'CPU (Xeon E5-2676v3)': 32.9,
    'GPU (RTX 4070)': 94.18,
    'DeepCache': 376.0,
    'FPGA_Acc1 (SDAcc)': 67.0,
    'FPGA_Acc2 (SDA)': 3.0,
    'PACE': 4.51,
}


@dataclasses.dataclass
class BaselinePoint:
    name: str
    gops: float
    epb_pj: float


def derive_baselines(difflight_avg_gops: float,
                     difflight_avg_epb: float) -> Dict[str, BaselinePoint]:
    out = {}
    for name in GOPS_IMPROVEMENT:
        out[name] = BaselinePoint(
            name=name,
            gops=difflight_avg_gops / GOPS_IMPROVEMENT[name],
            epb_pj=difflight_avg_epb * EPB_IMPROVEMENT[name])
    return out
