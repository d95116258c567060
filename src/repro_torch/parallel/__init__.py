"""Distribution: mesh axes, logical-axis sharding rules, the sharded
training state (`fsdp`, over "data"), tensor parallelism (`tensor`, over
"model"), the compressed all-reduce."""

from repro_torch.parallel.sharding import (
    Mesh,
    PartitionSpec,
    Shard,
    ShardingRules,
    batch_pspecs,
    data_dim,
    leaf_shard,
    make_rules,
    model_dim,
    rank_rows,
    sanitize_pspec,
    template_to_pspec,
    tree_pspecs,
)

__all__ = [
    "Mesh",
    "PartitionSpec",
    "Shard",
    "ShardingRules",
    "batch_pspecs",
    "data_dim",
    "leaf_shard",
    "make_rules",
    "model_dim",
    "rank_rows",
    "sanitize_pspec",
    "template_to_pspec",
    "tree_pspecs",
]
