"""The cache tier's config (the port's copy of
``shrewd_tpu/models/ruby.py CacheConfig``).

Only the config is ported, so that a plan's JSON round-trips.  The cache
fault kernel comes with a later slice: the ``cache:*`` structures raise
``NotImplementedError`` in ``Orchestrator`` before any trial runs.
"""

from __future__ import annotations

from shrewd_tpu_torch.utils.config import ConfigObject, Param

PROT_NONE = "none"
PROT_PARITY = "parity"
PROT_ECC = "ecc"
_PROTECTIONS = (PROT_NONE, PROT_PARITY, PROT_ECC)


class CacheConfig(ConfigObject):
    """One cache level's geometry + protection (CacheMemory params analog)."""

    n_sets = Param(int, 64, "sets (power of two)")
    n_ways = Param(int, 4, "associativity")
    words_per_line = Param(int, 8, "32-bit words per line (power of two)")
    tag_bits = Param(int, 20, "tag field width per line")
    state_bits = Param(int, 2, "coherence-state field width per line "
                       "(MESI encoding)")
    data_protection = Param(str, PROT_NONE, "none | parity | ecc")
    tag_protection = Param(str, PROT_NONE, "none | parity | ecc "
                           "(covers tag and state arrays)")

    def validate(self) -> None:
        for f in ("n_sets", "words_per_line"):
            v = getattr(self, f)
            if v & (v - 1) or v <= 0:
                raise ValueError(f"{f} must be a power of two, got {v}")
        for f in ("data_protection", "tag_protection"):
            if getattr(self, f) not in _PROTECTIONS:
                raise ValueError(f"{f} must be one of {_PROTECTIONS}")

    @property
    def n_slots(self) -> int:
        return self.n_sets * self.n_ways
