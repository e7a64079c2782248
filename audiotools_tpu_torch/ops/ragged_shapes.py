"""Shapes that do not fill the tiles of the Hopper kernels.

``tests/test_torch_cuda.py`` and ``chip_smoke.py`` hold each kernel against
its plain version at these shapes; both read this one list.
"""

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
