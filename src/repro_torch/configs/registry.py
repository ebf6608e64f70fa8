"""Architecture registry of the port: ``get_config(name)`` for every arch it
serves: the paper's RNN configs (``configs/paper_rnn.py``), the two GQA
attention LMs (``llama3-8b``, ``smollm-360m``) and the Mamba-2 LM
(``mamba2-2.7b``). The MoE, hybrid and frontend archs wait for their slices
(ROADMAP.md)."""
from __future__ import annotations

from typing import Dict

from repro_torch.configs import llama3_8b, mamba2_2p7b, paper_rnn, smollm_360m
from repro_torch.configs.base import ArchConfig

REGISTRY: Dict[str, ArchConfig] = {
    c.name: c for c in (*paper_rnn.CONFIGS, llama3_8b.CONFIG, smollm_360m.CONFIG,
                        mamba2_2p7b.CONFIG)
}


def get_config(name: str) -> ArchConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have: {sorted(REGISTRY)}")
    return REGISTRY[name]
