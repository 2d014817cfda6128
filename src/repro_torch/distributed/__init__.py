from repro_torch.distributed.sharding import (
    RULES_MULTI_POD,
    RULES_SINGLE_POD,
    AxisRules,
    Mesh,
    logical_to_spec,
    rules_for_mesh,
)

__all__ = ["AxisRules", "Mesh", "RULES_SINGLE_POD", "RULES_MULTI_POD", "logical_to_spec",
           "rules_for_mesh"]
