"""repro_torch.distributed — mirrors :mod:`repro.distributed`: the
logical-axis sharding rules on a torch ``DeviceMesh`` (:mod:`.sharding`)
and int8 gradient compression over process groups
(:mod:`.compression`)."""

from .compression import ErrorFeedbackState, compress_int8, decompress_int8
from .sharding import (DEFAULT_RULES, ShardingRules, batch_spec,
                       logical_to_spec, rules_for, spec_tree)

__all__ = ["ShardingRules", "DEFAULT_RULES", "rules_for", "spec_tree",
           "batch_spec", "logical_to_spec", "compress_int8",
           "decompress_int8", "ErrorFeedbackState"]
