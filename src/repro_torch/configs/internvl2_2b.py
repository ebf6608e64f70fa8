"""internvl2-2b [vlm] — InternViT + InternLM2 [arXiv:2404.16821].

The port's own copy of ``repro/configs/internvl2_2b.py``. Backbone =
InternLM2-1.8B decoder; the InternViT frontend is a stub: inputs are
precomputed patch embeddings interleaved with text embeddings, (B, S,
d_model), through one ``frontend.adapter`` matrix; the LM head covers the
92553-token vocabulary (padded to 92672)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-2b",
    family="vlm",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_head=128,
    d_ff=8192,
    vocab=92553,
    mlp_type="swiglu",
    frontend="vision_stub",
    rope_theta=10000.0,
    microbatches=4,
)
