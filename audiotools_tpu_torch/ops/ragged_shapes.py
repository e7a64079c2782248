"""Shapes that do not fill the tiles of the Hopper kernels, and kernel
F's tolerances.

``tests/test_torch_cuda.py`` holds each kernel against its plain version at
these shapes and tolerances.
"""
import numpy as np
import torch

from .stretch import _pv_indices

# Kernels A (taps per row) and C (taps shared by every row): (rows, T,
# taps). The FIR's tiling is 16 outputs a thread, 16-tap chunks and 4096
# outputs a block: rows shorter than a tile or not a multiple of it, taps
# not a multiple of the chunk, one row, and each kernel's tap limit.
FIR_BATCH = [(1, 100, 1), (1, 3, 5), (3, 4097, 17), (2, 8193, 15), (2, 8193, 16),
             (1, 4095, 2048), (5, 777, 2048), (4, 4096, 33),
             # the multitrack path's EQs: 64 clips of 5 s time-stretched by
             # 1.25 and 0.8 (176,400 and 275,625 samples), 6 bands
             (64, 176_400 + 640, 641), (64, 275_625 + 640, 641)]
FIR_SHARED = [(1, 100, 1), (1, 3, 5), (3, 4097, 17), (2, 8193, 15), (5, 4099, 31),
              (4, 4096, 33), (130, 2048, 33), (1, 12345, 8191), (2, 9000, 8192)]

# Kernel E: (B, nt, n_fft, hop), each with 0 and 2 edge frames. The
# synthesis's tiling is 256 hop-rows over the items laid end to end, 128
# columns and 16-value chunks, one kernel for each r = n_fft / hop: r = 1,
# 2, 3, 4 and 8, odd bins (n_fft 510), an odd hop, an odd number of chunks
# (n_fft 256 and 2048), fewer frames than a tile, one item, one frame.
SYNTHESIS = [(1, 3, 2048, 2048), (2, 50, 1024, 512), (3, 41, 1536, 512), (3, 41, 1024, 256),
             (4, 9, 510, 255), (1, 5, 256, 32), (5, 300, 512, 64), (1, 1, 2048, 512),
             (2, 37, 2048, 512)]

# Kernel B: (spectrum shape (..., F, T), rate), made by ``pv_case``; rate
# None is a step table that is not monotone. Its launch
# (``hopper_kernels.pv_plan``) takes 512 rows a block and fetches the frames
# 16 steps ahead: bins not a multiple of the block (F = 1025 = 2 x 512 + 1,
# F = 1), fewer rows than a block, rows that fill blocks but the last, T and
# step counts shorter than, and not a multiple of, the prefetch depth, and
# rates below and above 1.
PV = [((2, 1025, 20), 2 ** (-2 / 12)), ((1, 1, 7), 0.77), ((3, 1, 3), 1.31), ((2, 1, 65, 37), 2.0),
      ((1, 300, 19), 1.31), ((4, 33, 50), 0.77), ((1, 1025, 3), 2 ** (-2 / 12)),
      ((33, 1025, 10), 1.31), ((33, 1025, 30), 0.77), ((2, 7, 40), None), ((1, 129, 5), None)]

# Kernel B at the multitrack path's time stretches: 64 clips
# of 5 s at 44.1 kHz, 431 frames of 1025 bins (65,600 rows, 128 blocks and a
# ragged one), stretched by 1.25 and 0.8 to 345 and 539 steps, neither a
# multiple of the prefetch depth: (spectrum shape, rate).
STRETCH = [((64, 1, 1025, 431), 1.25), ((64, 1, 1025, 431), 0.8)]

# Kernel D: (..., n) planes. Its launch (``hopper_kernels.rotation_plan``)
# takes 128 rows a block and 32-step tiles, copied 16 bytes at a time when
# n % 4 == 0, else 4: rows not a multiple of the block, one row, one step,
# steps not a multiple of the tile, both copy widths, and more blocks than
# the card holds at once, with a ragged last one.
ROTATION = [(1, 1), (1, 432), (200, 1), (3, 43, 33), (129, 40), (1000, 33), (300, 432),
            (20_001, 40), (33_793, 33), (65_601, 40)]


def pv_case(shape, rate, seed):
    """A spectrum and step tables for a ``PV`` case: ``(z, i0, i1, frac)``.

    ``z`` is complex64 ``shape`` from ``seed`` with transient zero frames in
    bin 0 and, with more than one bin, a silent bin (bin 3 or the last);
    the tables are ``stretch._pv_indices(T, rate)``, or for ``rate`` None a
    table that is not monotone (frame 0 first, as every table)."""
    rng = np.random.RandomState(seed)
    z = (rng.randn(*shape) + 1j * rng.randn(*shape)).astype(np.complex64)
    F_bins, T = shape[-2:]
    z[..., 0, 1::4] = 0  # transient zero frames
    if F_bins > 1:
        z[..., min(3, F_bins - 1), :] = 0  # a silent bin: identity rotations throughout
    if rate is not None:
        return (z, *_pv_indices(T, rate))
    n = T + 3
    i0 = rng.randint(0, T, n).astype(np.int32)
    i0[0] = 0
    i1 = rng.randint(0, T, n).astype(np.int32)
    return z, i0, i1, rng.rand(n).astype(np.float32)


# Kernel F: (rows, n_blk, ns). One thread a row in blocks of 32 (its plan,
# ``hopper_kernels.scan_plan``), inputs fetched 32 steps ahead at 4 fp32
# states (4 to 32 by a step's bytes), in 16-, 8- or 4-byte words: one row,
# rows not a multiple of the block, one block, fewer blocks than, and not a
# multiple of, the prefetch depth, state counts across 1 to the limit (odd
# ones move 4-byte words in fp32), and the meter's stacked rows.
IIR_SCAN = [(1, 1, 4), (1, 2, 4), (33, 17, 4), (5, 431, 2), (3, 40, 1), (7, 33, 3), (2, 50, 6),
            (65, 19, 8), (4, 31, 12), (3, 9, 15), (2, 25, 16), (128, 431, 4)]

# Kernel F against its plain version, relative to the largest state. The
# plain version's addmm rounds the product s @ (A^L)^T and the add of u
# apart, through cuBLAS's split-K sums in its own order; the kernel fuses
# each term into one FMA chain from u. Both carry their rounding forward
# through the (contracting) recurrence: a few ulps of the state with a
# well-conditioned transition (the scaled rotations at IIR_SCAN's shapes).
SCAN_RTOL = {torch.float32: 1e-5, torch.float64: 1e-12}
# The meter's transition is ill-conditioned: the block of (A^L)^T that
# maps its last two states is nearly rank one, with entries near +-31.7,
# so each step cancels ~100x and the two versions' fp32 states part by
# ~1e-4 of the largest (each ~6e-5 from the float64 recurrence; the
# filtered audio each ~5e-6, under the cascade's 1e-4 pin). There the
# kernel is held to the float64 recurrence of the same fp32 inputs: within
# this many times the plain version's own error.
SCAN_VS_PLAIN_ERROR = 2.0
