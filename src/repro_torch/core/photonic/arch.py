"""DiffLight architectural configuration (paper §IV, Figure 3).

[Y, N, K, H, L, M]:
  Y — conv/norm blocks in the Residual unit
  K x N — MR bank array dims of each conv block (K rows, N columns)
  H — attention head blocks in the MHA unit
  M x L — MR bank array dims in each attention head (and linear block)

Paper DSE optimum: [4, 12, 3, 6, 6, 3].
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Iterator, Tuple

from repro_torch.core.photonic import devices as dev


@dataclasses.dataclass(frozen=True)
class DiffLightConfig:
    Y: int = 4
    N: int = 12
    K: int = 3
    H: int = 6
    L: int = 6
    M: int = 3
    # scheduling / dataflow toggles (paper §IV-C)
    sparse_dataflow: bool = True
    pipelined: bool = True
    dac_sharing: bool = True
    # replication factor: how many DiffLight tiles operate in parallel
    tiles: int = 1

    # -- derived geometry ----------------------------------------------------
    @property
    def conv_macs_per_pass(self) -> int:
        """Residual unit: Y blocks, each K rows x N wavelengths."""
        return self.Y * self.K * self.N

    @property
    def head_score_macs_per_pass(self) -> int:
        """Attention head: upper path (4 MR banks, M x L)."""
        return self.M * self.L

    @property
    def head_v_macs_per_pass(self) -> int:
        """Attention head: V path (2 MR banks, M x N)."""
        return self.M * self.N

    @property
    def mha_macs_per_pass(self) -> int:
        return self.H * (self.head_score_macs_per_pass
                         + self.head_v_macs_per_pass)

    @property
    def linear_macs_per_pass(self) -> int:
        """Linear+add block: M x L array."""
        return self.M * self.L

    def mrs_per_waveguide(self) -> int:
        """Wavelengths per waveguide = columns (bounded by WDM limit)."""
        return max(self.N, self.L)

    def dacs_residual(self) -> int:
        """DACs in the Residual unit (2 banks per block, K*N MRs each)."""
        per_block = 2 * self.K * self.N
        return self.Y * per_block

    def dacs_mha(self) -> int:
        """7 MR banks per head (paper Fig. 6) + 2 in linear block."""
        per_head = 4 * self.M * self.L + 3 * self.M * self.N
        return self.H * per_head + 2 * self.M * self.L

    def validate(self):
        assert self.mrs_per_waveguide() <= dev.MAX_MRS_PER_WAVEGUIDE
        return self


PAPER_OPTIMUM = DiffLightConfig()          # [4,12,3,6,6,3]
BASELINE = DiffLightConfig(sparse_dataflow=False, pipelined=False,
                           dac_sharing=False)


def dse_space(max_mrs: int = dev.MAX_MRS_PER_WAVEGUIDE
              ) -> Iterator[DiffLightConfig]:
    """The design space swept in §V (component counts under the WDM limit)."""
    for Y, N, K, H, L, M in itertools.product(
            (2, 4, 6, 8), (8, 12, 16, 24, 36), (2, 3, 4, 6),
            (4, 6, 8, 12), (4, 6, 8, 12), (2, 3, 4, 6)):
        if max(N, L) <= max_mrs:
            yield DiffLightConfig(Y=Y, N=N, K=K, H=H, L=L, M=M)
