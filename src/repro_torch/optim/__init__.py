"""Optimizers of the port: AdamW with global-norm clipping (``adamw``)."""
