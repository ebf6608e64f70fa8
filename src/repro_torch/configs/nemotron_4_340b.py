"""nemotron-4-340b [dense] — GQA, squared-ReLU [arXiv:2402.16819].

The port's own copy of ``repro/configs/nemotron_4_340b.py``: 96 query heads
on 8 KV heads of head dim 192 (B5's group of 12), a two-matrix squared-ReLU
MLP, a 256000-row vocabulary, bf16 Adam moments. One layer's weights are
6.9 GB in bf16 and the embedding and head 18.9 GB, so one card serves it
cut in depth."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="nemotron-4-340b",
    family="dense",
    n_layers=96,
    d_model=18432,
    n_heads=96,
    n_kv_heads=8,
    d_head=192,
    d_ff=73728,
    vocab=256000,
    mlp_type="squared_relu",
    rope_theta=10000.0,
    fsdp=True,
    microbatches=4,
    moment_dtype="bfloat16",
    sequence_parallel=True,
    loss_chunk=512,
)
