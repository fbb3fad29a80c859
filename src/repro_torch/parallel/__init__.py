from repro_torch.parallel.sharding import (  # noqa: F401
    axis_rules,
    current_mesh,
    current_rules,
    shard_act,
    spec_for_axes,
    specs_for_tree,
    DEFAULT_RULES,
    MULTIPOD_RULES,
    TRAIN_PARAM_RULES,
    SERVE_PARAM_RULES,
)
