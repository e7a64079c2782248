"""The STFT surface of the port's AudioSignal and the port's losses
(``metrics/distance.py``, ``metrics/spectral.py``) against the JAX package
on the CPU, on the same seeded inputs.

Tolerances: the STFTs sum in fp32 in other orders than XLA's CPU dot and
FFT (1e-5 of the largest value); the log-magnitude losses are means, held
at 1e-5 relative.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # the workers of a parallel test run share the host's cores

from audiotools_tpu import AudioSignal as JSignal
from audiotools_tpu import STFTParams as JSTFTParams
from audiotools_tpu.metrics import distance as JD
from audiotools_tpu.metrics import spectral as JSP
from audiotools_tpu_torch import AudioSignal
from audiotools_tpu_torch.core.signal import STFTParams
from audiotools_tpu_torch.metrics import distance as PD
from audiotools_tpu_torch.metrics import spectral as PSP

SR = 44100
STFT_RTOL = 1e-5
LOSS_RTOL = 1e-5


def _pair(seed, shape=(2, 1, 8000), scale=0.1):
    x = (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)
    return AudioSignal(torch.from_numpy(x.copy()), SR), JSignal(jnp.asarray(x), SR)


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_stft_params_defaults_match_jax():
    p, j = _pair(0)
    assert tuple(p.stft_params) == tuple(j.stft_params)
    assert STFTParams._fields == JSTFTParams._fields
    given = AudioSignal(torch.zeros(1, 1, 100), 16000, stft_params=STFTParams(256, None, "hann"))
    want = JSignal(np.zeros((1, 1, 100), np.float32), 16000,
                   stft_params=JSTFTParams(256, None, "hann"))
    assert tuple(given.stft_params) == tuple(want.stft_params)


@pytest.mark.parametrize("method", ["fft", "matmul"])
@pytest.mark.parametrize("kwargs", [{}, dict(window_length=512, hop_length=128),
                                    dict(window_length=512, hop_length=128, match_stride=True)])
def test_signal_stft_magnitude_phase_and_mel_match_jax(method, kwargs):
    p, j = _pair(1)
    got, want = p.stft(method=method, **kwargs), j.stft(method=method, **kwargs)
    assert tuple(got.shape) == tuple(want.shape) and p.stft_data is got
    assert _rel(got.numpy(), want) < STFT_RTOL
    assert _rel(p.magnitude.numpy(), j.magnitude) < STFT_RTOL
    # phase where the bin is not tiny (the angle of a near-zero bin is noise)
    mag = np.asarray(j.magnitude)
    big = mag > 1e-3 * mag.max()
    dphase = np.angle(np.exp(1j * (p.phase.numpy() - np.asarray(j.phase))))
    assert np.abs(dphase[big]).max() < 1e-3
    mel_p = p.mel_spectrogram(40, method=method, **kwargs)
    mel_j = j.mel_spectrogram(40, method=method, **kwargs)
    assert tuple(mel_p.shape) == tuple(mel_j.shape)
    assert _rel(mel_p.numpy(), mel_j) < STFT_RTOL
    assert _rel(AudioSignal.get_mel_filters(SR, 512, 40).numpy(),
                JSignal.get_mel_filters(SR, 512, 40)) == 0.0


def test_istft_round_trip_and_clone_carry_the_stft():
    p, j = _pair(2)
    p.stft(512, 128)
    j.stft(512, 128)
    clone = p.clone()
    assert clone.stft_data is p.stft_data and clone.stft_params == p.stft_params
    p.istft(512, 128)
    j.istft(512, 128)
    assert tuple(p.audio_data.shape) == (2, 1, 8000)
    assert _rel(p.audio_data.numpy(), j.audio_data) < STFT_RTOL
    with pytest.raises(RuntimeError, match="stft_data"):
        AudioSignal(torch.zeros(1, 1, 64), SR).istft()


def test_signal_keeps_the_graph():
    """A signal built from a tensor that requires grad holds that tensor, and
    its STFT, mel and clone stay on the graph."""
    x = torch.randn(1, 1, 4000, generator=torch.Generator().manual_seed(0), requires_grad=True)
    sig = AudioSignal(x * 2.0, SR)
    assert sig.audio_data.grad_fn is not None
    sig.clone().mel_spectrogram(40, window_length=512, method="matmul").sum().backward()
    assert x.grad is not None and float(x.grad.abs().max()) > 0


def test_distance_losses_match_jax():
    p, j = _pair(3)
    q, k = _pair(4)
    assert abs(float(PD.L1Loss()(p, q)) - float(JD.L1Loss()(j, k))) < 1e-7
    assert abs(float(PD.l1_loss(p.audio_data, q.audio_data))
               - float(JD.l1_loss(j.audio_data, k.audio_data))) < 1e-7
    mixed = AudioSignal(p.audio_data + 0.3 * q.audio_data, SR)
    jmixed = JSignal(j.audio_data + 0.3 * k.audio_data, SR)
    for kwargs in ({}, dict(scaling=False), dict(zero_mean=False), dict(clip_min=-20.0),
                   dict(reduction="sum"), dict(reduction="none")):
        got = PD.SISDRLoss(**kwargs)(p, mixed).numpy()
        want = np.asarray(JD.SISDRLoss(**kwargs)(j, jmixed))
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= 1e-4 * max(1.0, np.abs(want).max()), kwargs
    assert PD.SISDRLoss()(p.audio_data, mixed.audio_data).item() == pytest.approx(
        float(JD.sisdr_loss(j.audio_data, jmixed.audio_data)), rel=1e-5)


@pytest.mark.parametrize("loss", ["MultiScaleSTFTLoss", "MelSpectrogramLoss"])
def test_spectral_losses_match_jax(loss):
    p, j = _pair(5)
    q, k = _pair(6)
    got = getattr(PSP, loss)()(p, q)
    want = getattr(JSP, loss)()(j, k)
    assert got.shape == () and abs(float(got) - float(want)) / abs(float(want)) < LOSS_RTOL


def _led_by_silence(x, n=1024):
    """``x`` with its first ``n`` samples zeroed. The STFT's first frame is
    reflect-padded around sample 0, so it is symmetric and its spectrum is
    real up to rounding: its phases are 0 or +-pi by the sign of that
    rounding, in either package. Half a window of silence makes the frame
    zero, whose phase is 0 in both; every later frame is generic."""
    x = x.copy()
    x[..., :n] = 0.0
    return x


def test_phase_loss_matches_jax():
    rng = np.random.RandomState(10)
    x = _led_by_silence((rng.randn(2, 1, 8000) * 0.1).astype(np.float32))
    y = _led_by_silence((rng.randn(2, 1, 8000) * 0.1).astype(np.float32))
    got = PSP.PhaseLoss()(AudioSignal(torch.from_numpy(x), SR), AudioSignal(torch.from_numpy(y), SR))
    want = JSP.PhaseLoss()(JSignal(x, SR), JSignal(y, SR))
    assert got.shape == () and abs(float(got) - float(want)) / float(want) < LOSS_RTOL


def test_phase_loss_keeps_the_reference_wrap():
    """A phase difference above pi is moved by +2 pi, as the original
    library's in-place masked add does (the JAX package keeps it too):
    a sine against itself shifted by 3 rad scores as the JAX package's."""
    n = 4096
    t = np.arange(n) / SR
    x = _led_by_silence(np.sin(2 * np.pi * 1000 * t)[None, None].astype(np.float32), 256)
    y = _led_by_silence(np.sin(2 * np.pi * 1000 * t + 3.0)[None, None].astype(np.float32), 256)
    got = PSP.PhaseLoss(512, 128)(AudioSignal(torch.from_numpy(x), SR),
                                  AudioSignal(torch.from_numpy(y), SR))
    want = JSP.PhaseLoss(512, 128)(JSignal(x, SR), JSignal(y, SR))
    assert abs(float(got) - float(want)) / float(want) < LOSS_RTOL


def _loss_grad_jax(x, y, method):
    import jax

    def jloss(a):
        est, ref = JSignal(a, SR), JSignal(jnp.asarray(y), SR)
        return (JSP.MelSpectrogramLoss(stft_method=method)(est.clone(), ref.clone())
                + JSP.MultiScaleSTFTLoss(stft_method=method)(est.clone(), ref.clone()))

    return np.asarray(jax.jit(jax.grad(jloss))(jnp.asarray(x)))


def _loss_grad_port(x, y, method):
    xt = torch.from_numpy(x).requires_grad_(True)
    est, ref = AudioSignal(xt, SR), AudioSignal(torch.from_numpy(y), SR)
    (PSP.MelSpectrogramLoss(stft_method=method)(est.clone(), ref.clone())
     + PSP.MultiScaleSTFTLoss(stft_method=method)(est.clone(), ref.clone())).backward()
    return xt.grad.numpy()


def test_spectral_loss_gradients_match_jax():
    """d (mel + multi-scale STFT loss) / d estimate, both packages (matmul
    STFT). Past the first frame of the shortest window (256 samples), 1e-4
    of the largest gradient (measured 9.6e-6). Within it the symmetric,
    reflect-padded first frame has a real spectrum with near-zero bins,
    where the log-magnitude gradient ``1 / |X|`` magnifies rounding; there
    the packages must differ by no more than each moves on its own when its
    STFT is evaluated by FFT instead of matmul, summed (measured 2.2e-3
    against 2.5e-3 + 1.0e-3)."""
    x = (np.random.RandomState(8).randn(2, 1, 6000) * 0.1).astype(np.float32)
    y = (np.random.RandomState(9).randn(2, 1, 6000) * 0.1).astype(np.float32)
    want, want_fft = _loss_grad_jax(x, y, "matmul"), _loss_grad_jax(x, y, "fft")
    got, got_fft = _loss_grad_port(x, y, "matmul"), _loss_grad_port(x, y, "fft")
    scale = np.abs(want).max()
    assert np.abs(got - want)[..., 256:].max() / scale < 1e-4
    spread = np.abs(got_fft - got).max() + np.abs(want_fft - want).max()
    assert np.abs(got - want).max() <= spread
