"""The benchmark's own work counts: equal to hand counts at small shapes,
to the program's registered kernel work at the chain's shapes, and the DAC
step's model FLOPs at the published widths."""
import math

import pytest
import torch

torch.set_num_threads(1)

from perfbench.harness.spans import _shape  # noqa: E402
from perfbench.work import dac as W  # noqa: E402
from perfbench.work import kernels as K  # noqa: E402


def call(*args, **kwargs):
    return [_shape(a) for a in args], {k: _shape(v) for k, v in kwargs.items()}


def test_kernel_counts_by_hand():
    w = K.of_call("fir_causal_batch", *call(torch.zeros(3, 10), torch.zeros(3, 4)))
    assert w["flops"] == 2 * 3 * 10 * 4 and w["bytes"] == 4 * 3 * (2 * 10 + 4)
    w = K.of_call("fir_causal", *call(torch.zeros(2, 3, 10), torch.zeros(5)))
    assert w["flops"] == 2 * 6 * 10 * 5 and w["bytes"] == 4 * (2 * 6 * 10 + 5)
    spec = torch.zeros(2, 1, 7, 5, dtype=torch.complex64)
    import numpy as np

    i0 = np.zeros(6, np.int32)
    w = K.of_call("phase_vocoder_fused", *call(spec, i0, i0, i0.astype(np.float32)))
    assert w["flops"] == 31 * 14 * 6 and w["bytes"] == 8 * 14 * (5 + 6) + 12 * 6
    w = K.of_call("phase_vocoder_fused", *call(spec, i0, i0, i0, with_phasor=True))
    assert w["bytes"] == 8 * 14 * (5 + 12) + 12 * 6
    # E at n_fft 16, hop 4: 9 bins, weights (32, 4 x 128) bf16
    w = K.of_call("istft_synthesis_fused", *call(torch.zeros(2, 3, 9, dtype=torch.complex64),
                                                 torch.zeros(32, 512, dtype=torch.bfloat16), 4,
                                                 torch.zeros(16 + 4 * 2), 0))
    assert w["flops"] == 2 * 2 * 3 * 2 * 9 * 16
    assert w["bytes"] == 8 * 2 * 3 * 9 + 2 * 32 * 512 + 4 * 3 * 24
    assert K.bound_s({"flops": 67e12, "bytes": 0, "peak": K.PEAK_FP32_FLOPS}) == 1.0
    assert K.bound_s({"flops": 0, "bytes": 3.35e12, "peak": K.PEAK_FP32_FLOPS}) == 1.0


def _chain_shapes():
    """The kernels' arguments at the chain's shapes: 64 x 5 s at 44.1 kHz,
    641 EQ taps, the +2 st vocoder (1025 bins, 384 frames, 432 steps), the
    1023-tap FIR meter and the 2048 / 512 synthesis."""
    from audiotools_tpu_torch.ops import fft as PF
    from audiotools_tpu_torch.ops import hopper_kernels as HK
    from audiotools_tpu_torch.ops.stretch import _pv_indices

    T, L = 220500, 641
    yield "fir_causal_batch", (torch.zeros(64, T + L - 1), torch.zeros(64, L)), {}
    i0, i1, frac = _pv_indices(384, 2 ** (-2 / 12))
    spec = torch.zeros(64, 1, 384, 1025, dtype=torch.complex64).transpose(-1, -2)
    yield "phase_vocoder_fused", (spec, i0, i1, frac), {}
    yield "fir_causal", (torch.zeros(64, 1, T), torch.zeros(1023)), {}
    (w,) = PF._synthesis_design("hann", 2048, 512)
    (env,) = PF._inverse_envelope("hann", 2048, 512, 432)
    yield "istft_synthesis_fused", (torch.zeros(64, 432, 1025, dtype=torch.complex64), w, 512,
                                    torch.from_numpy(env), 0), {}
    del HK


@pytest.mark.parametrize("name,args,kwargs", list(_chain_shapes()),
                         ids=lambda v: v if isinstance(v, str) else "")
def test_kernel_counts_equal_the_programs_at_the_chains_shapes(name, args, kwargs):
    from audiotools_tpu_torch.ops import hopper_kernels as HK

    mine = K.of_call(name, *call(*args, **kwargs))
    theirs = getattr(HK, name).work(*args, **kwargs)
    assert mine["flops"] == theirs["flops"] and mine["bytes"] == theirs["bytes"]


PUBLISHED = dict(encoder_dim=64, encoder_rates=(2, 4, 8, 8), latent_dim=1024, decoder_dim=1536,
                 n_codebooks=9, codebook_size=1024, codebook_dim=8)


def test_generator_macs_equal_the_programs_at_default_widths():
    from audiotools_tpu_torch.ops import perf

    assert W.generator_macs(16896) == perf.dac_generator_macs(16896)
    assert W.mpd_macs(16896) == perf.mpd_macs(16896)
    assert W.mrd_macs(16896) == perf.mrd_macs(16896)


def test_adversarial_step_counts_the_published_widths():
    """At the published widths the step is 8.11 TFLOP; the program's
    ``adversarial_train_step_flops`` counts the default widths (5.78 TFLOP
    at 16 clips) whatever model is trained."""
    from audiotools_tpu_torch.ops import perf

    flops = W.adversarial_step_flops(18, 16896, PUBLISHED)
    assert flops == pytest.approx(8.11e12, rel=2e-3)
    assert perf.adversarial_train_step_flops(16, 16896) == pytest.approx(5.78e12, rel=2e-3)
    assert flops > perf.adversarial_train_step_flops(18, 16896) * 1.2
    # the published decoder's first transposed conv: 1536 -> 768, 16 taps
    t = 16896 // 512
    assert W.generator_macs(16896, **PUBLISHED)["decoder"] >= t * 1536 * 768 * 16


def test_codec_round_trip_flops_are_encode_and_decode():
    s = W.generator_macs(30 * 512, **PUBLISHED)
    lookup = 9 * 30 * 8 * 1024
    assert W.codec_roundtrip_flops(30 * 512 - 100, PUBLISHED) == 2 * (
        s["encoder"] + s["rvq"] + lookup + s["decoder"])
    assert math.isclose(W.codec_roundtrip_flops(30 * 44100 // 512 * 512, PUBLISHED) / 1e12,
                        6.0, rel_tol=0.05)
