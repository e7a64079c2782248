"""Runnable examples of the port: ``python -m
audiotools_tpu_torch.examples.train_dac`` (the canonical codec training
loop)."""
