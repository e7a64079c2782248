"""Shapes that do not fill the tiles of the Hopper kernels.

``tests/test_torch_cuda.py`` and ``chip_smoke.py`` hold each kernel against
its plain version at these shapes; both read these lists.
"""
import numpy as np

from .stretch import _pv_indices

# Kernels A (taps per row) and C (taps shared by every row): (rows, T,
# taps). The FIR's tiling is 16 outputs a thread, 16-tap chunks and 4096
# outputs a block: rows shorter than a tile or not a multiple of it, taps
# not a multiple of the chunk, one row, and each kernel's tap limit.
FIR_BATCH = [(1, 100, 1), (1, 3, 5), (3, 4097, 17), (2, 8193, 15), (2, 8193, 16),
             (1, 4095, 2048), (5, 777, 2048), (4, 4096, 33)]
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
