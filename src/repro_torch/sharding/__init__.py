"""Logical-axis sharding rules and the ambient sharding context (torch);
counterpart of ``repro.sharding``."""
from .context import constrain, sharding_ctx
from .rules import (CACHE_AXES, DEFAULT_RULES, INPUT_AXES, LogicalRules,
                    apply_rules, distribute_inputs, distribute_tree,
                    logical_sharding, shardings_for)

__all__ = ["CACHE_AXES", "DEFAULT_RULES", "INPUT_AXES", "LogicalRules",
           "apply_rules", "constrain", "distribute_inputs", "distribute_tree",
           "logical_sharding", "sharding_ctx", "shardings_for"]
