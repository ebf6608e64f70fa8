"""musicgen-large [audio] — decoder-only over EnCodec tokens [arXiv:2306.05284].

The port's own copy of ``repro/configs/musicgen_large.py``. Backbone only:
the EnCodec frontend is a stub — train/serve inputs are precomputed frame
embeddings (B, S, d_model) through one ``frontend.adapter`` matrix; the LM
head predicts codec tokens (vocab 2048)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-large",
    family="audio",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,      # MHA
    d_head=64,
    d_ff=8192,
    vocab=2048,
    mlp_type="gelu",
    frontend="audio_stub",
    rope_theta=10000.0,
    microbatches=8,
)
