"""smollm-360m [dense] — llama-arch small [hf:HuggingFaceTB/SmolLM; hf].

The port's own copy of ``repro/configs/smollm_360m.py``. On one device the
padded 16th head is computed and masked, as in the JAX package."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="smollm-360m",
    family="dense",
    n_layers=32,
    d_model=960,
    n_heads=15,          # 15 Q heads: not divisible by model=16 -> heads replicated,
    n_kv_heads=5,        # flattened projections still shard (960 % 16 == 0)
    d_head=64,
    d_ff=2560,
    vocab=49152,
    mlp_type="swiglu",
    tie_embeddings=True,
    rope_theta=10000.0,
    microbatches=1,
    pad_heads_to=16,   # 15 heads can't shard 16-way; padded head is masked
)
