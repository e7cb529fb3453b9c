"""The mesh layer: sharding rules on DTensor placements and the collective
census; port of `repro.distributed`. Importing it starts no process
group and needs no gloo or NCCL backend."""
from repro_torch.distributed.sharding import (  # noqa: F401
    Rules,
    current_rules,
    make_rules,
    shard,
    use_rules,
)
