"""A call that leaves an argument at its default gets the JAX package's
numerics: the FFT method of the STFT, iSTFT and mel spectrogram, and the
phase-vocoder formulation of the vocoder, the time stretch and the pitch
shift. Each formulation of the vocoder matches the JAX package's own, on a
spectrum with a transient zero frame, where the formulations differ.

Tolerances are the JAX package's pins: 1e-5 relative for the STFT and the
mel spectrogram, 1e-4 absolute for the iSTFT (tests/parity/test_parity.py),
2.5e-5 of the largest output for the vocoder (its stated accuracy,
``audiotools_tpu/ops/stretch.py``), tightened to 1e-5 where it holds (the
formulations measure 2e-6 to 5e-6 against the JAX package's here).
"""
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # the workers of a parallel test run share the host's cores

from audiotools_tpu import AudioSignal as JAudioSignal
from audiotools_tpu.ops import fft as JF
from audiotools_tpu.ops import stretch as JS
from audiotools_tpu_torch import AudioSignal
from audiotools_tpu_torch.ops import fft as PF
from audiotools_tpu_torch.ops import stretch as PS

SR = 44100


def _noise(shape, seed, scale=0.3):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.abs(got - want).max() / np.abs(want).max()


def _defaults(fn):
    return {k: p.default for k, p in inspect.signature(fn).parameters.items()
            if p.default is not inspect.Parameter.empty}


@pytest.mark.parametrize("name,module,param", [
    ("stft", "fft", "method"),
    ("istft", "fft", "method"),
    ("mel_spectrogram", "fft", "method"),
    ("phase_vocoder", "stretch", "formulation"),
    ("time_stretch", "stretch", "pv_formulation"),
    ("pitch_shift", "stretch", "pv_formulation"),
])
def test_defaults_are_the_jax_defaults(name, module, param):
    port = getattr({"fft": PF, "stretch": PS}[module], name)
    ref = getattr({"fft": JF, "stretch": JS}[module], name)
    want = _defaults(ref)
    got = _defaults(port)
    assert got[param] == want[param] == ("fft" if module == "fft" else "angle")
    # every parameter the two share defaults alike
    for key in set(got) & set(want):
        assert got[key] == want[key], key


@pytest.mark.parametrize("win,hop", [(2048, 512), (512, 128)])
def test_default_stft_and_mel_match_jax(win, hop):
    x = _noise((2, 1, 22050), 30)
    want = np.asarray(JF.stft(jnp.asarray(x), win, hop))
    got = PF.stft(torch.from_numpy(x), win, hop).numpy()
    assert got.shape == want.shape and got.dtype == np.complex64
    assert _rel(got, want) < 1e-5
    # the FFT and the matmul DFT are two evaluations of one transform
    assert _rel(got, PF.stft(torch.from_numpy(x), win, hop, method="matmul").numpy()) < 1e-5
    want = np.asarray(JF.mel_spectrogram(jnp.asarray(x), SR, 80, window_length=win,
                                         hop_length=hop))
    got = PF.mel_spectrogram(torch.from_numpy(x), SR, 80, window_length=win,
                             hop_length=hop).numpy()
    assert got.shape == want.shape
    assert _rel(got, want) < 1e-5


@pytest.mark.parametrize("match_stride", [False, True])
@pytest.mark.parametrize("win,hop", [(2048, 512), (512, 128)])
def test_default_istft_matches_jax(win, hop, match_stride):
    T = 22050
    x = _noise((2, 1, T), 31)
    spec = np.asarray(JF.stft(jnp.asarray(x), win, hop, match_stride=match_stride))
    # an inconsistent (modified) spectrum, where the OLA normalization matters
    mod = spec * np.random.RandomState(32).uniform(0, 1.5, spec.shape[-2:]).astype(np.float32)
    want = np.asarray(JF.istft(jnp.asarray(mod), win, hop, match_stride=match_stride,
                               original_length=T))
    got = PF.istft(torch.from_numpy(mod), win, hop, match_stride=match_stride,
                   original_length=T).numpy()
    assert got.shape == want.shape == x.shape
    assert np.abs(got - want).max() < 1e-4


def _spectrum(seed, shape):
    """A spectrum with a silent bin and transient zero frames."""
    rng = np.random.RandomState(seed)
    z = (rng.randn(*shape) + 1j * rng.randn(*shape)).astype(np.complex64)
    z[..., 3, :] = 0
    z[..., 5, 1::4] = 0
    z[..., 9, 7] = 0
    return z


@pytest.mark.parametrize("rate", [2.0 ** (-2.0 / 12.0), 1.31, 0.77])
@pytest.mark.parametrize("formulation", ["angle", "phasor"])
def test_formulation_matches_jax(formulation, rate):
    z = _spectrum(33, (2, 129, 61))
    want = np.asarray(JS.phase_vocoder(jnp.asarray(z), rate, 64, 256, formulation=formulation))
    got = PS.phase_vocoder(torch.from_numpy(z), rate, 64, 256, formulation=formulation).numpy()
    assert got.shape == want.shape and got.dtype == np.complex64
    assert _rel(got, want) < 1e-5


def test_formulations_differ_after_a_transient_zero():
    """The spectrum above does tell the formulations apart: after bin 5's
    zero frames the phasor forms carry an identity rotation and ``angle``
    a phase of 0, so the default had to be restored, not just matched."""
    z = torch.from_numpy(_spectrum(33, (2, 129, 61)))
    rate = 2.0 ** (-2.0 / 12.0)
    angle = PS.phase_vocoder(z, rate, 64, 256)
    phasor = PS.phase_vocoder(z, rate, 64, 256, formulation="phasor")
    fused = PS.phase_vocoder(z, rate, 64, 256, formulation="phasor_fused")
    assert _rel(phasor.numpy(), fused.numpy()) < 2.5e-5
    assert _rel(angle[..., 5, :].numpy(), phasor[..., 5, :].numpy()) > 0.1
    # the bins whose frames are all nonzero agree across formulations
    keep = [f for f in range(129) if f not in (3, 5, 9)]
    assert _rel(angle[..., keep, :].numpy(), phasor[..., keep, :].numpy()) < 2.5e-5


def test_phasor_scan_is_log_depth_and_matches_a_step_loop():
    """The scan of ``"phasor"`` against the plain step loop of kernel D."""
    from audiotools_tpu_torch.ops import hopper_kernels as HK

    rng = np.random.RandomState(34)
    for n in (1, 2, 7, 64, 333):
        ang = rng.uniform(-np.pi, np.pi, (3, n))
        sr, si = (torch.from_numpy(a.astype(np.float32)) for a in (np.cos(ang), np.sin(ang)))
        pr, pi = PS._associative_scan(PS._rot, (sr, si))
        # the inclusive scan of s is the exclusive scan of s[1:] seeded with s[0]
        ur = torch.cat([sr[:, 1:], torch.ones(3, 1)], dim=1)
        ui = torch.cat([si[:, 1:], torch.zeros(3, 1)], dim=1)
        wr, wi = HK.rotation_cumprod_plain(ur, ui, sr[:, 0].contiguous(), si[:, 0].contiguous())
        assert torch.allclose(pr, wr, atol=1e-5) and torch.allclose(pi, wi, atol=1e-5)


def test_default_pitch_shift_matches_jax():
    x = _noise((2, 1, 11025), 35, 0.1)
    x[..., 4000:4600] = 0  # silence: zero frames inside the signal
    want = np.asarray(JS.pitch_shift(jnp.asarray(x), 2.0, SR))
    got = PS.pitch_shift(torch.from_numpy(x), 2.0, SR).numpy()
    assert got.shape == want.shape == x.shape
    assert np.abs(got - want).max() < 1e-4
    want = np.asarray(JS.time_stretch(jnp.asarray(x), 1.2))
    got = PS.time_stretch(torch.from_numpy(x), 1.2).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() < 1e-4


def test_signal_pitch_shift_default_matches_jax():
    x = _noise((1, 1, 11025), 36, 0.1)
    want = np.asarray(JAudioSignal(jnp.asarray(x), SR).pitch_shift(-3).audio_data)
    got = AudioSignal(torch.from_numpy(x), SR).pitch_shift(-3).audio_data.numpy()
    assert np.abs(got - want).max() < 1e-4
