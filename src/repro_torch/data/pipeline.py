"""Token data pipelines with checkpointable iterator state: the port's copy of
``repro/data/pipeline.py`` (numpy, so the batches are the JAX package's bit
for bit; ``launch/train.py`` moves them to the device).

``SyntheticLM`` is *stateless-resumable*: batch(step) is a pure function of
(seed, step), so resume-after-restart is exact with no iterator state beyond
the step counter (the property checkpoint/restart tests rely on). It generates
a Zipf-ish token stream with enough autocorrelation that an LM's loss visibly
decreases (a Markov chain over the vocab).

``TextFileTokens`` streams byte-level tokens from a file with an explicit
offset that is saved/restored through the checkpoint.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np


@dataclasses.dataclass
class SyntheticLM:
    vocab: int
    batch: int
    seq_len: int
    seed: int = 0
    frontend_dim: Optional[int] = None  # emit embeds instead of tokens

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(np.random.PCG64(self.seed * 1_000_003 + step))
        B, S, V = self.batch, self.seq_len, self.vocab
        # order-1 Markov chain: next ~ (prev * 31 + noise) % V, biased to small ids
        noise = rng.integers(0, 7, size=(B, S + 1))
        toks = np.empty((B, S + 1), np.int64)
        toks[:, 0] = rng.zipf(1.5, size=B) % V
        for t in range(1, S + 1):
            toks[:, t] = (toks[:, t - 1] * 31 + noise[:, t]) % V
        inputs = toks[:, :-1].astype(np.int32)
        targets = toks[:, 1:].astype(np.int32)
        out: Dict[str, np.ndarray] = {
            "targets": targets,
            "mask": np.ones((B, S), np.float32),
        }
        if self.frontend_dim is not None:
            # burn one draw to keep the stream aligned with existing artifacts
            rng.standard_normal((self.frontend_dim, 8))
            # embed tokens through a fixed random codebook (stub frontend)
            code = rng.standard_normal((V, self.frontend_dim)).astype(np.float32)
            out["inputs_embeds"] = code[inputs] / np.sqrt(self.frontend_dim)
        else:
            out["inputs"] = inputs
        return out

    def state(self) -> Dict:
        return {"kind": "synthetic", "seed": self.seed}

    @staticmethod
    def restore(state: Dict, **kw) -> "SyntheticLM":
        return SyntheticLM(seed=state["seed"], **kw)


@dataclasses.dataclass
class TextFileTokens:
    path: str
    vocab: int
    batch: int
    seq_len: int
    offset: int = 0

    def __post_init__(self):
        self._data = np.fromfile(self.path, dtype=np.uint8)

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        B, S = self.batch, self.seq_len
        need = B * (S + 1)
        start = (self.offset + step * need) % max(len(self._data) - need, 1)
        chunk = self._data[start : start + need].astype(np.int32) % self.vocab
        toks = chunk.reshape(B, S + 1)
        return {
            "inputs": toks[:, :-1],
            "targets": toks[:, 1:],
            "mask": np.ones((B, S), np.float32),
        }

    def state(self) -> Dict:
        return {"kind": "textfile", "path": self.path, "offset": self.offset}


def make_pipeline(cfg, batch: int, seq_len: int, seed: int = 0):
    return SyntheticLM(
        vocab=cfg.vocab,
        batch=batch,
        seq_len=seq_len,
        seed=seed,
        frontend_dim=cfg.d_model if cfg.frontend else None,
    )
