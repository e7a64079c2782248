"""Full-fp32 products on the card.

On CUDA a float32 convolution goes through cuDNN in TF32 by default
(about three decimal digits), and a float32 matmul does too when
``torch.backends.cuda.matmul.allow_tf32`` is set. Every level- or
phase-critical product of this package (analysis and synthesis DFTs, mel
projection, resample, blocked IIR) runs inside :func:`strict_fp32`, which
turns TF32 off for both and restores the caller's settings afterwards.
"""
from contextlib import contextmanager

import torch


@contextmanager
def strict_fp32():
    """Disable TF32 in cuBLAS and cuDNN for the enclosed calls."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
