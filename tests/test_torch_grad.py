"""Gradients of the port against the JAX package on the CPU.

- The differentiable fused vocoder (``phase_vocoder(formulation=
  "phasor_fused")``, ``ops.stretch._FusedPhaseVocoder``): its custom
  backward against the JAX package's custom VJP (``phasor_fused_interpret``)
  and against autograd of the port's ``phasor`` formulation, at the JAX
  package's pin of 4.4e-5 of the largest gradient.
- The resample: autograd through the port's strided ``conv1d`` against
  ``jax.grad`` through ``polyphase_conv_diff`` (the JAX package's exact
  adjoint), at its pin of 7e-7 of the largest gradient, at the pitch
  shift's 49/55 ratio.
- The chain into a loss: ``MelSpectrogramLoss(pitch_shift(x, +2,
  "phasor_fused"), y)`` differentiated in both packages.
- On a device other than the CPU, a kernel wrapper given an input that
  requires grad raises before it launches (the card tests repeat it with
  the kernels themselves).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # the workers of a parallel test run share the host's cores

from audiotools_tpu import AudioSignal as JSignal
from audiotools_tpu.metrics.spectral import MelSpectrogramLoss as JMelLoss
from audiotools_tpu.ops import resample as JR
from audiotools_tpu.ops import stretch as JS
from audiotools_tpu_torch import AudioSignal
from audiotools_tpu_torch.metrics.spectral import MelSpectrogramLoss
from audiotools_tpu_torch.ops import hopper_kernels as HK
from audiotools_tpu_torch.ops import resample as PR
from audiotools_tpu_torch.ops import stretch as PS

SR = 44100
# the fused vocoder's gradient against the phasor formulation's
# (docs/perf.md, "Differentiating through the vocoder"): both sum in f32,
# the scan and the reversed cumsum in other orders
PV_GRAD_RTOL = 4.4e-5
# the resample's exact adjoint against autograd of the strided conv
RESAMPLE_GRAD_RTOL = 7e-7


def _spectrum(seed, shape, silent=True):
    """Random complex spectrum ``(B, F, T)``; with ``silent``, one silent
    bin and one transient zero frame, which reach the vocoder's identity
    branches."""
    rng = np.random.RandomState(seed)
    re = rng.randn(*shape).astype(np.float32)
    im = rng.randn(*shape).astype(np.float32)
    if silent:
        re[:, 3, :] = im[:, 3, :] = 0.0
        re[0, 5, 7] = im[0, 5, 7] = 0.0
    return re, im


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


def _port_pv_grad(re, im, rate, formulation):
    z = torch.complex(torch.from_numpy(re), torch.from_numpy(im)).requires_grad_(True)
    out = PS.phase_vocoder(z, rate, 8, 32, formulation=formulation)
    loss = (out.abs() ** 2).sum() + 0.5 * out.real.sum()
    loss.backward()
    return z.grad.real.numpy(), z.grad.imag.numpy()


def _jax_pv_grad(re, im, rate, formulation):
    def loss(r, i):
        out = JS.phase_vocoder(jax.lax.complex(r, i), rate, 8, 32, formulation=formulation)
        return jnp.sum(jnp.abs(out) ** 2) + 0.5 * jnp.sum(jnp.real(out))

    return tuple(np.asarray(g) for g in jax.grad(loss, argnums=(0, 1))(
        jnp.asarray(re), jnp.asarray(im)))


@pytest.mark.parametrize("rate", [1.3, 0.77, 2.0 ** (-2.0 / 12.0)])
def test_fused_vocoder_gradient_matches_jax_and_phasor(rate):
    re, im = _spectrum(3, (2, 17, 25))
    got = _port_pv_grad(re, im, rate, "phasor_fused")
    phasor = _port_pv_grad(re, im, rate, "phasor")
    want = _jax_pv_grad(re, im, rate, "phasor_fused_interpret")
    scale = max(np.abs(w).max() for w in want)
    for g, p, w in zip(got, phasor, want):
        assert np.all(np.isfinite(g))
        assert np.abs(g - w).max() / scale < PV_GRAD_RTOL
        assert np.abs(g - p).max() / scale < PV_GRAD_RTOL


@pytest.mark.parametrize("rate", [1.3, 0.77, 2.0 ** (-2.0 / 12.0)])
def test_interpret_vocoder_gradient_matches_jax_and_phasor(rate):
    """``"phasor_fused_interpret"`` differentiates as ``"phasor_fused"``
    does, with the backward reading B's plain version's phasor track:
    against the JAX package's interpret-mode custom VJP and against
    autograd of ``"phasor"``, at 4.4e-5 of the largest gradient."""
    re, im = _spectrum(5, (2, 17, 25))
    got = _port_pv_grad(re, im, rate, "phasor_fused_interpret")
    phasor = _port_pv_grad(re, im, rate, "phasor")
    want = _jax_pv_grad(re, im, rate, "phasor_fused_interpret")
    scale = max(np.abs(w).max() for w in want)
    for g, p, w in zip(got, phasor, want):
        assert np.all(np.isfinite(g))
        assert np.abs(g - w).max() / scale < PV_GRAD_RTOL
        assert np.abs(g - p).max() / scale < PV_GRAD_RTOL


def test_fused_vocoder_keeps_the_trackless_forward_without_grad():
    """Without grad the path's forward is kernel B's launch without the
    phasor track, as before; with grad the output carries the custom
    backward and equals the same forward."""
    re, im = _spectrum(4, (2, 9, 20), silent=False)
    z = torch.complex(torch.from_numpy(re), torch.from_numpy(im))
    i0, i1, frac = PS._pv_indices(20, 0.8)
    plain = HK.phase_vocoder_fused_plain(z, i0, i1, frac)
    with torch.no_grad():
        out = PS.phase_vocoder(z.clone().requires_grad_(True), 0.8, 8, 32, "phasor_fused")
    assert out.grad_fn is None and torch.equal(out, plain)
    out = PS.phase_vocoder(z.clone().requires_grad_(True), 0.8, 8, 32, "phasor_fused")
    assert type(out.grad_fn).__name__ == "_FusedPhaseVocoderBackward"
    assert torch.equal(out.detach(), plain)


@pytest.mark.parametrize("old,new", [(55, 49), (49, 55)])
def test_resample_gradient_matches_jax_adjoint(old, new):
    T = 2003
    x = (np.random.RandomState(0).randn(2, T) * 0.3).astype(np.float32)
    out_len = int(T * new / old)
    w = np.sin(np.arange(out_len) * 0.13).astype(np.float32)

    def jloss(a):
        out = JR.resample(a, old, new)
        return jnp.sum(out * w) + 0.1 * jnp.sum(out ** 2)

    want = np.asarray(jax.jit(jax.grad(jloss))(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    out = PR.resample(xt, old, new)
    ((out * torch.from_numpy(w)).sum() + 0.1 * (out ** 2).sum()).backward()
    assert _rel(xt.grad.numpy(), want) < RESAMPLE_GRAD_RTOL


def test_gradient_through_pitch_shift_into_mel_loss():
    """d MelSpectrogramLoss(pitch_shift(x, +2 st, phasor_fused), y) / dx:
    the port's autograd (resample, matmul STFT, the fused vocoder's custom
    backward, fp32 iSTFT, the loss) against ``jax.grad`` through the JAX
    package's custom VJPs.

    Tolerances. Past the first analysis window (2048 samples), 2e-4 of the
    largest gradient (measured 4.2e-5). Within it the gradient is
    ill-conditioned: the seed phasor's cotangent sums the whole output's
    over ``1 / |z|`` of frame 0, so fp32 rounding of the analysis moves it
    by ~1e-2; there the port must agree with the JAX package no worse than
    the JAX package agrees with itself when its STFT is evaluated by FFT
    instead of matmul (measured 1.3e-2 against 2.4e-2)."""
    rng = np.random.RandomState(7)
    n = 8192
    x = (rng.randn(2, 1, n) * 0.1).astype(np.float32)
    y = (rng.randn(2, 1, n) * 0.1).astype(np.float32)

    def jgrad(method):
        def jloss(a):
            shifted = JS.pitch_shift(a, 2.0, SR, pv_formulation="phasor_fused_interpret",
                                     method=method)
            return JMelLoss()(JSignal(shifted, SR), JSignal(jnp.asarray(y), SR))

        value, grad = jax.jit(jax.value_and_grad(jloss))(jnp.asarray(x))
        return float(value), np.asarray(grad)

    jval, want = jgrad("matmul")
    _, want_fft = jgrad("fft")
    xt = torch.from_numpy(x).requires_grad_(True)
    shifted = PS.pitch_shift(xt, 2.0, SR, pv_formulation="phasor_fused", method="matmul")
    loss = MelSpectrogramLoss()(AudioSignal(shifted, SR), AudioSignal(torch.from_numpy(y), SR))
    loss.backward()
    got = xt.grad.numpy()
    assert np.all(np.isfinite(got)) and np.abs(got).max() > 0
    assert abs(loss.item() - jval) / abs(jval) < 1e-5
    scale = np.abs(want).max()
    assert np.abs(got - want)[..., 2048:].max() / scale < 2e-4
    assert np.abs(got - want).max() <= np.abs(want_fft - want).max()


@pytest.mark.parametrize("name", ["fir_causal_batch", "phase_vocoder_fused", "fir_causal",
                                  "rotation_cumprod", "istft_synthesis_fused"])
def test_kernel_wrappers_refuse_grad_off_the_cpu(name):
    """Meta tensors take the wrappers' card route without a card: an input
    that requires grad is refused before any build or launch, and under
    ``no_grad`` the same call goes on to the launch (which raises for lack
    of a CUDA tensor)."""
    meta = dict(device="meta")
    calls = {
        "fir_causal_batch": lambda g: HK.fir_causal_batch(
            torch.zeros(2, 64, requires_grad=g, **meta), torch.zeros(2, 5, **meta)),
        "phase_vocoder_fused": lambda g: HK.phase_vocoder_fused(
            torch.zeros(1, 5, 8, dtype=torch.complex64, requires_grad=g, **meta),
            *PS._pv_indices(8, 0.8)),
        "fir_causal": lambda g: HK.fir_causal(
            torch.zeros(2, 64, **meta), torch.zeros(5, requires_grad=g, **meta)),
        "rotation_cumprod": lambda g: HK.rotation_cumprod(
            *(torch.zeros(3, 8, requires_grad=g, **meta), torch.zeros(3, 8, **meta),
              torch.ones(3, **meta), torch.zeros(3, **meta))),
        "istft_synthesis_fused": lambda g: HK.istft_synthesis_fused(
            torch.zeros(1, 3, 33, dtype=torch.complex64, requires_grad=g, **meta),
            torch.zeros(80, 512, dtype=torch.bfloat16, **meta), 16,
            torch.zeros(64 + 16 * 2, **meta)),
    }
    with pytest.raises(RuntimeError, match="no backward"):
        calls[name](True)
    with torch.no_grad(), pytest.raises(RuntimeError) as info:
        calls[name](True)
    assert "no backward" not in str(info.value)
