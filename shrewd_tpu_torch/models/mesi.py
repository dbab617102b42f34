"""The MESI protocol tier's config (the port's copy of
``shrewd_tpu/models/mesi.py MesiConfig``).

Only the config is ported, so that a plan's JSON round-trips.  The MESI
fault kernel comes with a later slice: the ``mesi:*`` structures raise
``NotImplementedError`` in ``Orchestrator`` before any trial runs.
"""

from __future__ import annotations

import numpy as np

from shrewd_tpu_torch.models.ruby import PROT_ECC, PROT_NONE, PROT_PARITY
from shrewd_tpu_torch.utils.config import ConfigObject, Param


class MesiConfig(ConfigObject):
    """N-core private-L1 / shared-L2 directory geometry + protection."""

    n_cores = Param(int, 2, "cores (private L1 each, 2..16)")
    n_sets = Param(int, 4, "L1 sets (power of two)")
    n_ways = Param(int, 2, "L1 associativity")
    words_per_line = Param(int, 2, "32-bit words per line (power of two)")
    tag_bits = Param(int, 16, "tag field width (fault-targetable)")
    state_protection = Param(str, PROT_NONE,
                             "none | parity | ecc on the protocol arrays")

    def validate(self) -> None:
        for f in ("n_sets", "words_per_line"):
            v = getattr(self, f)
            if v & (v - 1):
                raise ValueError(f"{f}={v} must be a power of two")
        if not 2 <= self.n_cores <= 16:
            raise ValueError("n_cores must be in [2, 16] (sharers bitmask)")
        if self.state_protection not in (PROT_NONE, PROT_PARITY, PROT_ECC):
            raise ValueError(
                f"unknown state_protection {self.state_protection!r}")

    @property
    def owner_bits(self) -> int:
        return max(int(np.ceil(np.log2(self.n_cores))), 1)

    def dir_bits(self) -> int:
        """Directory-entry fault-bit space: 2 state bits, then one sharer
        bit per core, then the owner-id bits."""
        return 2 + self.n_cores + self.owner_bits

    def tbe_bits(self) -> int:
        """TBE fault-bit space: line-address bits then requester-id bits."""
        return 16 + self.owner_bits
