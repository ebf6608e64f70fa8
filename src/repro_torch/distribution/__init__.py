"""Distribution: sharding rules, activation rules, and the fused RNN path
over a mesh of ranks (``fused_sharded.py``)."""
from repro_torch.distribution.sharding import (  # noqa: F401
    activation_rules,
    param_specs,
    shard_hint,
    use_rules,
)
