"""Optimizer of the port: AdamW and its learning-rate schedule."""
