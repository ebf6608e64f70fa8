"""Cells and the multi-time-step (MTS) executor."""
