"""mixtral-8x22b [moe] — 8 experts top-2, SWA [arXiv:2401.04088].

The port's own copy of ``repro/configs/mixtral_8x22b.py``. Every layer's
FFN is a mixture of 8 swiglu experts (``models/moe.py``), two per token,
dispatched by the ``sorted`` schedule; the attention keeps a 4096-slot
sliding-window ring cache. One layer's weights are 5.0 GB in bf16, so one
card serves it cut in depth (the multi-GPU layout waits for ROADMAP.md
§A7)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mixtral-8x22b",
    family="moe",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_head=128,
    d_ff=16384,
    vocab=32768,
    mlp_type="swiglu",
    moe=True,
    n_experts=8,
    top_k=2,
    moe_impl="sorted",
    sliding_window=4096,
    sub_quadratic=True,
    rope_theta=1000000.0,
    fsdp=True,
    microbatches=8,
)
