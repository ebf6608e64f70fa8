"""The paper's own models (Sec. 4): SRU/QRNN/LSTM, small and large.

The port's own copy of ``repro/configs/paper_rnn.py`` (the port imports
nothing of the JAX package). Small: LSTM width 350 / SRU|QRNN width 512.
Large: LSTM 700 / SRU|QRNN 1024. The comments below describe the JAX
package's engines; the port serves every config here but the ``*-int8``
ones, through its own CUDA kernels (``repro_torch/kernels``) where the
engine has one (``pallas``, ``fused``, ``fused_stack``).
"""
from repro_torch.configs.base import ArchConfig


def _rnn(name, cell, width, layers=1):
    return ArchConfig(
        name=name,
        family="rnn",
        n_layers=layers,
        d_model=width,
        rnn_hidden=width,
        vocab=8192,
        cell=cell,
        sub_quadratic=True,
        mts_block_size=32,
        scan_engine="chunked",
    )


SRU_SMALL = _rnn("sru-paper-small", "sru", 512)
SRU_LARGE = _rnn("sru-paper-large", "sru", 1024)
QRNN_SMALL = _rnn("qrnn-paper-small", "qrnn", 512)
QRNN_LARGE = _rnn("qrnn-paper-large", "qrnn", 1024)
LSTM_SMALL = _rnn("lstm-paper-small", "lstm", 350)
LSTM_LARGE = _rnn("lstm-paper-large", "lstm", 700)

# Whole-layer fused variants (kernels/fused_rnn): one kernel per layer — gate
# GEMM, nonlinearities, recurrence, and highway output without HBM round-trips.
SRU_LARGE_FUSED = SRU_LARGE.with_(name="sru-paper-large-fused", scan_engine="fused")
QRNN_LARGE_FUSED = QRNN_LARGE.with_(name="qrnn-paper-large-fused", scan_engine="fused")

# Depth-fused variants (kernels/fused_rnn/stacked.py): the paper's weight-reuse
# argument applied vertically — all L layers (pre-norm, gates, recurrence,
# highway, residual) per kernel invocation, carry pipeline resident in VMEM, so
# the activation stream crosses HBM once per chunk instead of once per layer.
# Streaming decode runs the whole stack in one kernel launch per token.
#
# REQUIREMENT: fused_stack needs d_model == rnn_hidden (the `_rnn` helper
# guarantees it by passing one `width` for both). The residual stream feeds
# each layer's highway skip at full width, so there is no skip projection to
# absorb a width change; models/rnn.py::_depth_fusible silently falls back to
# the per-layer scan for projected stacks (and LSTM). Under a mesh with a
# "model" axis the stack additionally wants rnn_hidden % shards == 0 — an
# indivisible width serves replicated instead (distribution/fused_sharded.py).
SRU_LARGE_STACKED = _rnn(
    "sru-paper-large-stacked", "sru", 1024, layers=4
).with_(scan_engine="fused_stack", fuse_depth=True)
QRNN_LARGE_STACKED = _rnn(
    "qrnn-paper-large-stacked", "qrnn", 1024, layers=4
).with_(scan_engine="fused_stack", fuse_depth=True)

# Ring-overlap variants for multi-device serving (--model-shards > 1): the
# sharded stack keeps the residual stream chunk-resident and folds each
# inter-layer gather into the next layer's gate GEMM ring
# (distribution/fused_sharded.py, schedule="ring"). Single-device runs are
# unaffected (the flag only routes inside the shard_map dispatch). All cell
# params are lane-major (d, 3, H) slabs — kernels/fused_rnn/layout.py — so
# the gate slabs live SHARDED AT REST under a "model" mesh axis.
SRU_LARGE_STACKED_RING = SRU_LARGE_STACKED.with_(
    name="sru-paper-large-stacked-ring", ring_overlap=True
)
QRNN_LARGE_STACKED_RING = QRNN_LARGE_STACKED.with_(
    name="qrnn-paper-large-stacked-ring", ring_overlap=True
)

# Int8 weight-quantized variants (kernels/fused_rnn/layout.py::quantize_slabs):
# the gate slabs are stored int8 with per-gate × per-lane-block symmetric
# scales and dequantize INSIDE the fused kernels, after the gate GEMM
# accumulate — HBM weight traffic drops ~2x vs bf16 (~4x vs fp32) while the
# fp32 carry and highway math are untouched. Quantization happens at the one
# entry point (models/lm.py::lm_init / tools/migrate_checkpoint.py), so these
# configs only flip the knob. The stacked variants keep ring_overlap=True:
# under a "model" mesh the int8 slabs AND their scales live sharded at rest
# (distribution/sharding.py rules), with zero decode-step weight collectives.
SRU_LARGE_INT8 = SRU_LARGE_FUSED.with_(
    name="sru-paper-large-int8", weight_quant="int8"
)
QRNN_LARGE_INT8 = QRNN_LARGE_FUSED.with_(
    name="qrnn-paper-large-int8", weight_quant="int8"
)
SRU_LARGE_STACKED_INT8 = SRU_LARGE_STACKED.with_(
    name="sru-paper-large-stacked-int8", weight_quant="int8", ring_overlap=True
)
QRNN_LARGE_STACKED_INT8 = QRNN_LARGE_STACKED.with_(
    name="qrnn-paper-large-stacked-int8", weight_quant="int8", ring_overlap=True
)

# Draft model for speculative decode (serving/engine.py ``draft_cfg``): a
# deliberately low-width SRU sharing the target vocab. Acceptance compares
# token ids, so any registered RNN arch with the same vocab works as a draft
# for any target; this one is the stock choice `serve.py --speculative`
# defaults to (its per-step cost is ~1/16 of the width-512 targets').
SRU_DRAFT = _rnn("sru-paper-draft", "sru", 128)

CONFIGS = [
    SRU_SMALL, SRU_LARGE, QRNN_SMALL, QRNN_LARGE, LSTM_SMALL, LSTM_LARGE,
    SRU_LARGE_FUSED, QRNN_LARGE_FUSED, SRU_LARGE_STACKED, QRNN_LARGE_STACKED,
    SRU_LARGE_STACKED_RING, QRNN_LARGE_STACKED_RING,
    SRU_LARGE_INT8, QRNN_LARGE_INT8,
    SRU_LARGE_STACKED_INT8, QRNN_LARGE_STACKED_INT8, SRU_DRAFT,
]
