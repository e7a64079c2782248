"""The benchmark's own counts of the hand-written kernels' work, from the
shapes of each call, and the published peaks of one NVIDIA H100 SXM.

Each input is read once and each output written once; the operations are
those the algorithm needs. These are frozen copies of the port's
``ops/hopper_kernels.py`` work functions at the time the benchmark was
defined, so a later change to the program cannot move the yardstick. A
call is given as the recorded shapes of its arguments
(``harness.spans.wrap_entry_points``): a tensor as ``(shape, dtype)``.
"""
PEAK_FP32_FLOPS = 67e12  # H100 SXM, fp32 outside the tensor cores
PEAK_BF16_FLOPS = 989e12  # H100 SXM, dense bf16 on the tensor cores
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, HBM3

# kernel E's weight layout: contraction rows padded to KC, each column
# block (one hop) padded to TN
SYN_K_CHUNK = 16
SYN_COLS = 128


def _numel(shape):
    n = 1
    for s in shape:
        n *= s
    return n


def fir_causal_batch(x, h):
    """A: per-row causal FIR of ``x (rows, T)`` with ``h (rows, L)``."""
    (rows, T), L = x, h[-1]
    return {"flops": 2.0 * rows * T * L, "bytes": 4.0 * rows * (2 * T + L),
            "peak": PEAK_FP32_FLOPS}


def phase_vocoder_fused(stft_data, i0, i1=None, frac=None, with_phasor=False):
    """B: the phasor vocoder over ``(..., F, T)`` complex64 frames to
    ``len(i0)`` steps: ~31 fp32 operations a bin and step; the frames read
    once, the output (and the track) written once, the step tables read
    once."""
    T = stft_data[-1]
    rows, n = _numel(stft_data) // T, i0[0]
    return {"flops": 31.0 * rows * n,
            "bytes": 8.0 * rows * (T + n * (1 + bool(with_phasor))) + 12.0 * n,
            "peak": PEAK_FP32_FLOPS}


def fir_causal(x, h):
    """C: causal FIR of ``x (..., T)`` with one shared ``h (L,)``."""
    T, L = x[-1], h[0]
    rows = _numel(x) // T
    return {"flops": 2.0 * rows * T * L, "bytes": 4.0 * (2 * rows * T + L),
            "peak": PEAK_FP32_FLOPS}


def istft_synthesis_fused(spec, w, hop, inv_env, edge=0):
    """E: window-fused inverse DFT of ``spec (B, nt, n_freq)`` complex64 with
    bf16 operands, overlap-add and envelope: 2 operations a product of the
    frames' re and im parts with the iDFT rows; the spectrum, the laid-out
    weights and the envelope read once, the output written once."""
    B, nt, n_freq = spec
    hop_p = -(-hop // SYN_COLS) * SYN_COLS
    n_fft = (w[-1] // hop_p) * hop
    return {"flops": 2.0 * B * nt * 2 * n_freq * n_fft,
            "bytes": 8.0 * B * nt * n_freq + 2.0 * _numel(w) + 4.0 * (1 + B) * inv_env[0],
            "peak": PEAK_BF16_FLOPS}


COUNTS = {f.__name__: f for f in (fir_causal_batch, phase_vocoder_fused, fir_causal,
                                  istft_synthesis_fused)}


def of_call(name, args, kwargs):
    """The work of one recorded call of entry point ``name``: tensors as
    their shapes, other values as they were."""
    def plain(v):
        return v[0] if isinstance(v, tuple) and len(v) == 2 and isinstance(v[0], tuple) else (
            (v[1],) if isinstance(v, tuple) and len(v) == 2 and v[0] == "len" else v)

    return COUNTS[name](*[plain(a) for a in args], **{k: plain(v) for k, v in kwargs.items()})


def bound_s(work) -> float:
    """The least time the chip could take: operations over their type's
    peak, or bytes over the memory rate, whichever is longer."""
    return max(work["flops"] / work["peak"], work["bytes"] / HBM_BYTES_PER_S)
