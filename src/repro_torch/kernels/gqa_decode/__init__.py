"""Decode-shape GQA attention over a KV cache (B5)."""
