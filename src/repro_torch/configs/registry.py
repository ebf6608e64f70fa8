"""Architecture registry of the port: ``get_config(name)`` for every arch it
serves: the paper's RNN configs (``configs/paper_rnn.py``), the dense
attention LMs (``llama3-8b``, ``smollm-360m``, the MQA ``granite-20b``), the
frontend-stub LMs (``internvl2-2b``, ``musicgen-large``), the Mamba-2 LM
(``mamba2-2.7b``), the hybrid ``zamba2-7b``, the MoE LMs ``mixtral-8x22b``
and ``qwen3-moe-235b-a22b`` and the dense ``nemotron-4-340b``. ``ASSIGNED``
and ``assigned_names()`` list the ten assigned archs, as in JAX."""
from __future__ import annotations

from typing import Dict, List

from repro_torch.configs import paper_rnn
from repro_torch.configs.base import ArchConfig
from repro_torch.configs.granite_20b import CONFIG as GRANITE_20B
from repro_torch.configs.internvl2_2b import CONFIG as INTERNVL2_2B
from repro_torch.configs.llama3_8b import CONFIG as LLAMA3_8B
from repro_torch.configs.mamba2_2p7b import CONFIG as MAMBA2_2P7B
from repro_torch.configs.mixtral_8x22b import CONFIG as MIXTRAL_8X22B
from repro_torch.configs.musicgen_large import CONFIG as MUSICGEN_LARGE
from repro_torch.configs.nemotron_4_340b import CONFIG as NEMOTRON_4_340B
from repro_torch.configs.qwen3_moe_235b_a22b import CONFIG as QWEN3_MOE
from repro_torch.configs.smollm_360m import CONFIG as SMOLLM_360M
from repro_torch.configs.zamba2_7b import CONFIG as ZAMBA2_7B

# In the JAX package's order (``configs/shapes.py`` crosses them with its
# four shapes).
ASSIGNED: List[ArchConfig] = [
    SMOLLM_360M,
    NEMOTRON_4_340B,
    LLAMA3_8B,
    GRANITE_20B,
    MIXTRAL_8X22B,
    QWEN3_MOE,
    MUSICGEN_LARGE,
    ZAMBA2_7B,
    MAMBA2_2P7B,
    INTERNVL2_2B,
]

REGISTRY: Dict[str, ArchConfig] = {c.name: c for c in ASSIGNED}
REGISTRY.update({c.name: c for c in paper_rnn.CONFIGS})


def get_config(name: str) -> ArchConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have: {sorted(REGISTRY)}")
    return REGISTRY[name]


def assigned_names() -> List[str]:
    return [c.name for c in ASSIGNED]
