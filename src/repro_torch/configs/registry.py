"""Architecture registry of the port: ``get_config(name)`` for every arch it
can name. This slice registers the paper's RNN configs
(``configs/paper_rnn.py``); the ten assigned archs wait for later slices."""
from __future__ import annotations

from typing import Dict

from repro_torch.configs import paper_rnn
from repro_torch.configs.base import ArchConfig

REGISTRY: Dict[str, ArchConfig] = {c.name: c for c in paper_rnn.CONFIGS}


def get_config(name: str) -> ArchConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have: {sorted(REGISTRY)}")
    return REGISTRY[name]
