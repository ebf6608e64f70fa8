"""Architecture registry of the port: ``get_config(name)`` for every arch it
serves: the paper's RNN configs (``configs/paper_rnn.py``), the dense
attention LMs (``llama3-8b``, ``smollm-360m``, the MQA ``granite-20b``), the
frontend-stub LMs (``internvl2-2b``, ``musicgen-large``), the Mamba-2 LM
(``mamba2-2.7b``), the hybrid ``zamba2-7b``, the MoE LMs ``mixtral-8x22b``
and ``qwen3-moe-235b-a22b`` and the dense ``nemotron-4-340b``."""
from __future__ import annotations

from typing import Dict

from repro_torch.configs import (granite_20b, internvl2_2b, llama3_8b, mamba2_2p7b,
                                 mixtral_8x22b, musicgen_large, nemotron_4_340b, paper_rnn,
                                 qwen3_moe_235b_a22b, smollm_360m, zamba2_7b)
from repro_torch.configs.base import ArchConfig

REGISTRY: Dict[str, ArchConfig] = {
    c.name: c for c in (*paper_rnn.CONFIGS, llama3_8b.CONFIG, smollm_360m.CONFIG,
                        mamba2_2p7b.CONFIG, granite_20b.CONFIG, internvl2_2b.CONFIG,
                        musicgen_large.CONFIG, zamba2_7b.CONFIG, mixtral_8x22b.CONFIG,
                        qwen3_moe_235b_a22b.CONFIG, nemotron_4_340b.CONFIG)
}


def get_config(name: str) -> ArchConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have: {sorted(REGISTRY)}")
    return REGISTRY[name]
