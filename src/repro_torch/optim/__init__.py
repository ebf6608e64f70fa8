"""Optimizers of the port (``repro/optim/``): AdamW and gradient compression."""
