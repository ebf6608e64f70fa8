"""zamba2-7b [hybrid] — Mamba-2 backbone + weight-shared attention block
applied every 6 layers [arXiv:2411.15242].

The port's own copy of ``repro/configs/zamba2_7b.py``. 81 Mamba-2 blocks;
after every 6th the one shared attention block runs again, with a KV cache
of its own per application (13 of them); the last 3 blocks have none after
them. Zamba2's concatenated residual input to the shared block and its
per-application LoRAs are simplified to plain weight sharing, as in the JAX
package."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_head=112,
    d_ff=14336,
    vocab=32000,
    mlp_type="swiglu",
    ssm=True,
    ssm_state=64,
    ssm_headdim=64,
    ssm_ngroups=1,
    attn_every=6,
    sub_quadratic=True,
    rope_theta=10000.0,
    microbatches=8,
    conv_impl="conv",  # one depthwise conv op at prefill
)
