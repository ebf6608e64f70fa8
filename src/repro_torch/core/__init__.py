"""Cells and the multi-time-step (MTS) executor."""
from repro_torch.core.mts import auto_block_size  # noqa: F401
