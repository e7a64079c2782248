"""Runnable examples of the port: ``python -m
audiotools_tpu_torch.examples.train_dac`` (the canonical codec training
loop), ``.codec`` (compress and decompress files), and the listening-test
apps ``.abx`` and ``.mushra``."""
