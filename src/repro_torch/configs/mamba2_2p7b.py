"""mamba2-2.7b [ssm] — attention-free SSD (state-space duality)
[arXiv:2405.21060]. The purest consumer of the paper's technique: the entire
sequence mixer is the chunked linear recurrence.

The port's own copy of ``repro/configs/mamba2_2p7b.py``."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-2.7b",
    family="ssm",
    n_layers=64,
    d_model=2560,
    vocab=50280,
    ssm=True,
    ssm_state=128,
    ssm_headdim=64,
    ssm_ngroups=1,
    sub_quadratic=True,
    microbatches=8,
    conv_impl="conv",  # one depthwise conv op at prefill
)
