"""Design-space search over protection configurations (BASELINE configs[4];
port of ``shrewd_tpu/search``)."""

from shrewd_tpu_torch.search.protect import (DesignSpace, Scheme,
                                             SearchResult, StructureProfile,
                                             DEFAULT_SCHEMES, shadow_scheme)

__all__ = ["DesignSpace", "Scheme", "SearchResult", "StructureProfile",
           "DEFAULT_SCHEMES", "shadow_scheme"]
