"""llama3-8b [dense] — GQA, 128k vocab [arXiv:2407.21783].

The port's own copy of ``repro/configs/llama3_8b.py``."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama3-8b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_head=128,
    d_ff=14336,
    vocab=128256,
    mlp_type="swiglu",
    rope_theta=500000.0,
    fsdp=True,
    microbatches=4,
)
