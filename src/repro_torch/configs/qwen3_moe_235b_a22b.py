"""qwen3-moe-235b-a22b [moe] — 128 experts top-8, fine-grained
[hf:Qwen/Qwen3-30B-A3B family scaled per assignment].

The port's own copy of ``repro/configs/qwen3_moe_235b_a22b.py``. QK-norm
per Qwen3, bf16 Adam moments. ``moe_impl="shard_map"`` is the JAX
package's expert-parallel schedule; on one device it runs the ``sorted``
schedule, as JAX's does without a mesh (``models/moe.py``)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    d_head=128,
    d_ff=1536,
    vocab=151936,
    mlp_type="swiglu",
    moe=True,
    n_experts=128,
    top_k=8,
    moe_impl="shard_map",
    qk_norm=True,
    rope_theta=1000000.0,
    fsdp=True,
    microbatches=8,
    moment_dtype="bfloat16",
    loss_chunk=1024,
)
