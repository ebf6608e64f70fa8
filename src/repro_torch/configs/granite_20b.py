"""granite-20b [dense] — MQA (kv=1), code model [arXiv:2405.04324].

The port's own copy of ``repro/configs/granite_20b.py``. The single KV head
serves all 48 query heads (a group of 48 in the decode attention); the MLP
is the tanh ``gelu`` form with two matrices, which with d_ff = 24576 gives
the advertised 20B."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="granite-20b",
    family="dense",
    n_layers=52,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    d_head=128,
    d_ff=24576,
    vocab=49152,
    mlp_type="gelu",
    rope_theta=10000.0,
    microbatches=8,
)
