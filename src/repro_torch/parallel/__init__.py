"""Distribution on `torch.distributed`: sharding rules and placements,
the activation-sharding context and FSDP gather, expert-parallel MoE
dispatch, pipeline parallelism, compressed collectives; the port of
`repro.parallel`."""
from .sharding import (  # noqa: F401
    Layout, PartitionSpec, ShardingStrategy, batch_specs, cache_specs, default_strategy,
    distribute_tree, gather_tree, layouts, opt_specs, param_specs, placements, state_specs,
)
from .collectives import (  # noqa: F401
    compressed_psum_mean, init_error_feedback, pod_sync_grads,
)
from .pipeline import (  # noqa: F401
    bubble_fraction, pipeline_apply, split_layers_to_stages, stack_stages,
)
