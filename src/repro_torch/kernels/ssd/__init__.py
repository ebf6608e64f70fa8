"""Chunked Mamba-2 SSD (B4)."""
