"""Log-sum-exp softmax decomposition (paper Eq. 4), port of
``repro/core/lse_softmax.py::lse_softmax``."""
from __future__ import annotations

import torch


def lse_softmax(scores: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Softmax via the paper's four-op decomposition: running max,
    log of the shifted exp-sum, subtract, exponentiate."""
    gamma_max = scores.amax(dim=dim, keepdim=True)                  # op 1
    shifted = scores - gamma_max
    ln_sum = torch.log(torch.exp(shifted).sum(dim=dim, keepdim=True))  # op 2
    return torch.exp(shifted - ln_sum)                               # ops 3+4
