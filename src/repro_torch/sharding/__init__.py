"""Logical-axis sharding rules and the ambient sharding context (torch);
counterpart of ``repro.sharding``."""
from .context import constrain, sharding_ctx
from .rules import (LogicalRules, DEFAULT_RULES, apply_rules, logical_sharding,
                    shardings_for)

__all__ = ["DEFAULT_RULES", "LogicalRules", "apply_rules", "constrain",
           "logical_sharding", "sharding_ctx", "shardings_for"]
