"""Distribution: mesh axes, logical-axis sharding rules, the compressed
all-reduce."""

from repro_torch.parallel.sharding import (
    Mesh,
    PartitionSpec,
    ShardingRules,
    batch_pspecs,
    make_rules,
    rank_rows,
    sanitize_pspec,
    template_to_pspec,
    tree_pspecs,
)

__all__ = [
    "Mesh",
    "PartitionSpec",
    "ShardingRules",
    "batch_pspecs",
    "make_rules",
    "rank_rows",
    "sanitize_pspec",
    "template_to_pspec",
    "tree_pspecs",
]
