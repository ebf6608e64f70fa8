"""Architecture configuration, the port's own copy of ``repro/configs/base.py``.

One ``ArchConfig`` fully determines a model. The port keeps its own copy
because it imports nothing of the JAX package; the fields, defaults,
``padded_vocab`` and ``reduced()`` are the same, so a config names the same
model on both sides. The port serves the RNN, the dense attention and the
SSM (Mamba-2) fields; the MoE, hybrid and frontend ones wait for the slices
that port their models.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                       # dense | moe | ssm | hybrid | audio | vlm | rnn
    n_layers: int
    d_model: int
    vocab: int
    # --- attention ---
    n_heads: int = 0
    n_kv_heads: int = 0
    d_head: int = 0
    rope_theta: float = 10000.0
    sliding_window: Optional[int] = None
    qk_norm: bool = False
    pad_heads_to: int = 0             # pad Q heads for mesh divisibility (outputs
                                      # of padded heads are masked -> exact math)
    # --- mlp ---
    d_ff: int = 0
    mlp_type: str = "swiglu"          # swiglu | squared_relu | gelu
    # --- moe ---
    moe: bool = False
    n_experts: int = 0
    top_k: int = 0
    moe_impl: str = "einsum"          # dense | einsum | ragged
    capacity_factor: float = 1.25
    renorm_topk: bool = True
    # --- ssm (mamba-2) ---
    ssm: bool = False
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_ngroups: int = 1
    ssm_expand: int = 2
    ssm_conv: int = 4
    # --- hybrid ---
    attn_every: int = 0               # 0: homogeneous; k: shared attn after every k blocks
    # --- rnn (the paper's own models) ---
    cell: Optional[str] = None        # sru | qrnn | lstm
    rnn_hidden: int = 0
    # --- frontend stubs ---
    frontend: Optional[str] = None    # audio_stub | vision_stub
    # --- embedding / head ---
    tie_embeddings: bool = False
    # --- paper technique knobs ---
    mts_block_size: int = 128
    scan_engine: str = "chunked"      # sequential | chunked | associative | pallas
                                      # | fused (whole-layer kernel, SRU/QRNN)
                                      # | fused_stack (depth-fused L-layer kernel)
    fuse_depth: bool = False          # route the whole RNN stack through the
                                      # stack-level API (models/rnn.py::rnn_stack_*)
                                      # instead of the per-layer scan; with
                                      # scan_engine="fused_stack" all L layers run
                                      # in ONE Pallas kernel per time chunk
    ring_overlap: bool = False        # sharded fused_stack only: overlap each
                                      # inter-layer gather with the next layer's
                                      # gate GEMM (core/overlap.py ring schedule
                                      # via distribution/fused_sharded.py);
                                      # False = blocking per-layer all-gather
                                      # (single-device-bitwise numerics)
    weight_quant: str = "none"        # none | int8: weight-only quantization of
                                      # the SRU/QRNN gate slabs (per-gate ×
                                      # per-lane-block symmetric scales, dequant
                                      # INSIDE the fused kernels after the gate
                                      # GEMM accumulate; LSTM and non-cell
                                      # params stay fp). Requires the fused
                                      # engines — core/mts.py rejects int8
                                      # params on the non-fused scan engines.
    pallas_interpret: Optional[bool] = None  # None = auto (REPRO_PALLAS_INTERPRET
                                      # env, else interpret off-TPU); pin True/False
                                      # to force interpret/compiled kernels
    ssd_chunk: int = 128
    ssd_intra_dtype: str = "float32"  # bfloat16 = §Perf C1 (intra-chunk operands)
    conv_impl: str = "shift"          # conv = single depthwise conv op (§Perf C5)
    # --- distribution / training knobs ---
    fsdp: bool = False
    sequence_parallel: bool = False   # shard activation seq dim over "model"
    remat: str = "block"              # none | block
    microbatches: int = 1
    attn_chunk: int = 1024            # flash-style KV block for train/prefill
    loss_chunk: int = 0               # tokens per logits chunk (0 = full); big-vocab
                                      # models never materialize (tokens, V) logits
    cast_params_once: bool = True     # cast layer stack to compute dtype before the
                                      # scan (bf16 FSDP/TP all-gathers); False = the
                                      # per-layer-cast baseline (§Perf B1)
    moment_dtype: str = "float32"     # AdamW m/v dtype (bf16 for 340B-class)
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    # --- shape applicability ---
    sub_quadratic: bool = False       # True => long_500k runnable
    skip_decode: bool = False         # encoder-only archs

    # ------------------------------------------------------------------
    def with_(self, **kw) -> "ArchConfig":
        return replace(self, **kw)

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to 256 so embedding/logits shard over any mesh axis.

        Padding rows are never valid targets; the loss one-hot never selects
        them (real vocab ids only), so training math is unchanged.
        """
        return -(-self.vocab // 256) * 256

    @property
    def d_inner(self) -> int:
        """Mamba-2 inner width."""
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim

    def num_params(self) -> int:
        """Analytic parameter count (matches init; asserted in tests)."""
        d, V = self.d_model, self.vocab
        n = V * d  # embed
        if not self.tie_embeddings:
            n += V * d
        n += d  # final norm
        per_layer = 0
        if self.cell is not None:  # paper RNN LMs
            h = self.rnn_hidden
            if self.cell == "sru":
                per_layer = d * 3 * h + 2 * h + (0 if d == h else d * h)
            elif self.cell == "qrnn":
                per_layer = 2 * d * 3 * h + 3 * h
            else:
                per_layer = d * 4 * h + h * 4 * h + 4 * h
            per_layer += d  # pre-norm
            return n + self.n_layers * per_layer
        if self.ssm:
            di, H, N, G = self.d_inner, self.ssm_heads, self.ssm_state, self.ssm_ngroups
            conv_ch = di + 2 * G * N
            mamba = (
                d * (2 * di + 2 * G * N + H)   # in_proj [z,x,B,C,dt]
                + conv_ch * self.ssm_conv      # conv1d
                + 2 * H                        # A_log, D
                + H                            # dt_bias
                + di                           # gated norm
                + di * d                       # out_proj
                + d                            # pre-norm
            )
            if self.attn_every:  # shared weights, applied many times
                attn = (
                    d * (self.n_heads + 2 * self.n_kv_heads) * self.d_head
                    + self.n_heads * self.d_head * d
                    + 2 * d                     # norms
                    + self._mlp_params()
                )
                return n + self.n_layers * mamba + attn
            return n + self.n_layers * mamba
        # attention family
        attn = (
            d * (self.n_heads + 2 * self.n_kv_heads) * self.d_head
            + self.n_heads * self.d_head * d
            + (2 * self.d_head if self.qk_norm else 0)
        )
        per_layer = attn + self._mlp_params() + 2 * d  # two norms
        return n + self.n_layers * per_layer

    def _mlp_params(self) -> int:
        d, f = self.d_model, self.d_ff
        if self.moe:
            router = d * self.n_experts
            if self.mlp_type == "swiglu":
                return router + self.n_experts * 3 * d * f
            return router + self.n_experts * 2 * d * f
        if self.mlp_type == "swiglu":
            return 3 * d * f
        return 2 * d * f

    def num_active_params(self) -> int:
        """Active params per token (= num_params for dense)."""
        if not self.moe:
            return self.num_params()
        full = self.num_params()
        per_expert = (3 if self.mlp_type == "swiglu" else 2) * self.d_model * self.d_ff
        inactive = (self.n_experts - self.top_k) * per_expert * self.n_layers
        return full - inactive

    def reduced(self) -> "ArchConfig":
        """Tiny same-family config for CPU smoke tests."""
        kw = dict(
            name=self.name + "-smoke",
            n_layers=min(self.n_layers, 2 if not self.attn_every else 4),
            d_model=64,
            vocab=256,
            param_dtype="float32",
            compute_dtype="float32",
            microbatches=1,
            attn_chunk=64,
            mts_block_size=16,
            ssd_chunk=16,
            fsdp=False,
            pad_heads_to=0,       # mesh-divisibility padding is a full-scale concern
            loss_chunk=0,
            sequence_parallel=False,
        )
        if self.n_heads:
            kw.update(n_heads=4, n_kv_heads=max(1, min(self.n_kv_heads, 2)), d_head=16)
        if self.d_ff:
            kw.update(d_ff=128)
        if self.moe:
            kw.update(n_experts=4, top_k=min(self.top_k, 2), moe_impl="dense")
        if self.ssm:
            kw.update(ssm_state=16, ssm_headdim=16, ssm_ngroups=1)
        if self.attn_every:
            kw.update(attn_every=2)
        if self.cell:
            kw.update(rnn_hidden=64)
        if self.sliding_window:
            kw.update(sliding_window=32)
        return replace(self, **kw)
