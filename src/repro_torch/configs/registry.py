"""Architecture registry of the port: ``get_config(name)`` for every arch it
serves: the paper's RNN configs (``configs/paper_rnn.py``), the dense
attention LMs (``llama3-8b``, ``smollm-360m``, the MQA ``granite-20b``), the
frontend-stub LMs (``internvl2-2b``, ``musicgen-large``), the Mamba-2 LM
(``mamba2-2.7b``) and the hybrid ``zamba2-7b``. The MoE archs and
``nemotron-4-340b`` wait for their slice (ROADMAP.md §A6.3)."""
from __future__ import annotations

from typing import Dict

from repro_torch.configs import (granite_20b, internvl2_2b, llama3_8b, mamba2_2p7b,
                                 musicgen_large, paper_rnn, smollm_360m, zamba2_7b)
from repro_torch.configs.base import ArchConfig

REGISTRY: Dict[str, ArchConfig] = {
    c.name: c for c in (*paper_rnn.CONFIGS, llama3_8b.CONFIG, smollm_360m.CONFIG,
                        mamba2_2p7b.CONFIG, granite_20b.CONFIG, internvl2_2b.CONFIG,
                        musicgen_large.CONFIG, zamba2_7b.CONFIG)
}


def get_config(name: str) -> ArchConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have: {sorted(REGISTRY)}")
    return REGISTRY[name]
