"""The single-pass bf16 analysis STFT (``stft(method="matmul_bf16")``) of
the port against the JAX package on the CPU, and every route that reaches
it: ``AudioSignal.stft``/``mel_spectrogram``, ``time_stretch`` and
``pitch_shift``, the two spectral losses and the MRD of the discriminator.

Two references:

- The JAX package's own ``stft(method="matmul_bf16")``. On the CPU its
  single-pass dot sums the unrounded fp32 operands, so the port must lie
  off it by more than fp32 rounding (1e-6 of the spectrum's scale) and by
  less than 2^-8 of the scale: the bf16 roundings of frames and matrices
  move each operand by at most one unit roundoff (2^-8), and their errors,
  independent across the n_fft products of a cell, partly cancel in its
  sum (measured 1.9e-3 and 2.4e-3 of the scale at 512 and 2048).
- The same JAX function with its operands rounded to bf16 as the
  single-pass dot rounds them on the JAX package's hardware (its frames and
  its host DFT design, cast by XLA; ``jax_bf16_operands``). Then both sides
  sum the same bf16 values in fp32, in other orders: 1e-5 of the scale,
  the STFT pin of ``tests/test_torch_losses.py``.

The JAX side runs eagerly in these tests, so that no program traced before
the operands were patched is reused.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # the workers of a parallel test run share the host's cores

from audiotools_tpu import AudioSignal as JSignal
from audiotools_tpu.metrics import spectral as JSP
from audiotools_tpu.models.discriminators import Discriminator as JDisc
from audiotools_tpu.ops import fft as JF
from audiotools_tpu.ops import stretch as JS
from audiotools_tpu_torch import AudioSignal
from audiotools_tpu_torch.metrics import spectral as PSP
from audiotools_tpu_torch.models import Discriminator, convert
from audiotools_tpu_torch.ops import fft as PF
from audiotools_tpu_torch.ops import stretch as PS

SR = 44100
BF16_REL = 2.0 ** -8  # bf16's unit roundoff (module docstring)
FP32_REL = 1e-6  # fp32 sums in other orders, at most
STFT_RTOL = 1e-5  # the same operands summed in other orders


def _noise(shape, seed, scale=0.3):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _bf16(a):
    return jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32)


@pytest.fixture
def jax_bf16_operands(monkeypatch):
    """The JAX package's ``stft(method="matmul")`` with its frames and its
    host DFT design (``_dft_matrices``, bit-equal to the port's) rounded to
    bf16."""
    frame = JF._frame
    monkeypatch.setattr(JF, "_frame", lambda *a: _bf16(frame(*a)))
    monkeypatch.setattr(JF, "_dft_matrices_device",
                        lambda window_type, n_fft: tuple(
                            _bf16(m) for m in JF._dft_matrices(window_type, n_fft)))


CASES = [(win, hop, match_stride, padding)
         for win, hop in ((512, 128), (2048, 512))
         for match_stride in (False, True)
         for padding in ("reflect", "constant")]


@pytest.mark.parametrize("win,hop,match_stride,padding", CASES)
def test_bf16_stft_lies_within_its_rounding_of_jax(win, hop, match_stride, padding):
    x = _noise((2, 1, 9000), 0)
    kwargs = dict(match_stride=match_stride, padding_type=padding, method="matmul_bf16")
    want = np.asarray(JF.stft(jnp.asarray(x), win, hop, **kwargs))
    got = PF.stft(torch.from_numpy(x), win, hop, **kwargs).numpy()
    assert got.shape == want.shape and got.dtype == np.complex64
    assert FP32_REL < _rel(got, want) < BF16_REL


@pytest.mark.parametrize("win,hop,match_stride,padding", CASES)
def test_bf16_stft_matches_jax_with_rounded_operands(win, hop, match_stride, padding,
                                                     jax_bf16_operands):
    x = _noise((2, 1, 9000), 1)
    kwargs = dict(match_stride=match_stride, padding_type=padding)
    want = np.asarray(JF.stft(jnp.asarray(x), win, hop, method="matmul", **kwargs))
    got = PF.stft(torch.from_numpy(x), win, hop, method="matmul_bf16", **kwargs).numpy()
    assert _rel(got, want) < STFT_RTOL


def test_bf16_stft_is_fp32_stft_of_rounded_operands():
    """The port's own identity: rounding the audio rounds every frame, so
    the bf16 analysis is the fp32 ``matmul`` analysis of bf16 audio against
    bf16 matrices; only the matrices' rounding is left, and it moves the
    spectrum by more than fp32 rounding."""
    x = torch.from_numpy(_noise((3, 5000), 2))
    xr = x.to(torch.bfloat16).float()
    got = PF.stft(x, 512, 128, method="matmul_bf16")
    assert torch.equal(got, PF.stft(xr, 512, 128, method="matmul_bf16"))
    assert FP32_REL < _rel(got.numpy(), PF.stft(xr, 512, 128, method="matmul").numpy()) < BF16_REL


def test_signal_routes_take_the_bf16_analysis(jax_bf16_operands):
    """``AudioSignal.stft``, ``magnitude`` and ``mel_spectrogram`` with
    ``method="matmul_bf16"``: the op's spectrum, and the JAX signal's with
    rounded operands."""
    x = _noise((2, 1, 8000), 3, 0.1)
    sig, jsig = AudioSignal(torch.from_numpy(x.copy()), SR, device="cpu"), JSignal(x, SR)
    spec = sig.stft(512, 128, method="matmul_bf16")
    assert torch.equal(spec, PF.stft(torch.from_numpy(x), 512, 128, method="matmul_bf16"))
    assert _rel(spec.numpy(), jsig.stft(512, 128, method="matmul")) < STFT_RTOL
    assert _rel(sig.magnitude.numpy(), jsig.magnitude) < STFT_RTOL
    got = sig.mel_spectrogram(40, window_length=512, hop_length=128, method="matmul_bf16")
    want = jsig.mel_spectrogram(40, window_length=512, hop_length=128, method="matmul")
    assert _rel(got.numpy(), want) < STFT_RTOL


@pytest.mark.parametrize("op,args", [("time_stretch", (1.25,)), ("time_stretch", (0.8,)),
                                     ("pitch_shift", (2.0, SR)), ("pitch_shift", (-3.0, SR))])
def test_stretch_routes_take_the_bf16_analysis(op, args, jax_bf16_operands):
    """The analysis in bf16 and the synthesis in fp32 against the JAX
    package's with the analysis operands rounded: the vocoder (``angle``)
    and the resample sum in fp32 on both sides, on noise, where the vocoder
    is well conditioned (1e-4 of the largest sample, as ``CHAIN_TOL``'s fp32
    audio bound)."""
    x = _noise((2, 1, 22050), 4)
    want = np.asarray(getattr(JS, op)(jnp.asarray(x), *args, method="matmul",
                                      synthesis_method="matmul"))
    got = getattr(PS, op)(torch.from_numpy(x), *args, method="matmul_bf16",
                          synthesis_method="matmul").numpy()
    assert got.shape == want.shape
    assert _rel(got, want) < 1e-4
    # the signal methods pass the method through
    sig = AudioSignal(torch.from_numpy(x.copy()), SR, device="cpu")
    if op == "time_stretch":
        sig.time_stretch(args[0], method="matmul_bf16", synthesis_method="matmul")
    else:
        sig.pitch_shift(args[0], method="matmul_bf16", synthesis_method="matmul")
    assert torch.equal(sig.audio_data, torch.from_numpy(got))


def _pair(seed, shape=(2, 1, 8000)):
    x = _noise(shape, seed, 0.1)
    return AudioSignal(torch.from_numpy(x.copy()), SR, device="cpu"), JSignal(jnp.asarray(x), SR)


@pytest.mark.parametrize("loss", ["MultiScaleSTFTLoss", "MelSpectrogramLoss"])
def test_bf16_losses_match_jax(loss):
    """Against the JAX losses with ``stft_method="matmul_bf16"`` (fp32 sums
    on the CPU): within 2^-8 relative."""
    p, j = _pair(5)
    q, k = _pair(6)
    got = getattr(PSP, loss)(stft_method="matmul_bf16")(p, q)
    want = getattr(JSP, loss)(stft_method="matmul_bf16")(j, k)
    assert got.shape == ()
    assert abs(float(got) - float(want)) / abs(float(want)) < BF16_REL


@pytest.mark.parametrize("loss", ["MultiScaleSTFTLoss", "MelSpectrogramLoss"])
def test_bf16_losses_match_jax_with_rounded_operands(loss, jax_bf16_operands):
    """The losses' log-magnitude terms read the quietest cells, so they are
    held to 1e-5 relative, the fp32 losses' pin, only against the JAX
    losses fed the same rounded operands."""
    p, j = _pair(7)
    q, k = _pair(8)
    got = getattr(PSP, loss)(stft_method="matmul_bf16")(p, q)
    want = getattr(JSP, loss)(stft_method="matmul")(j, k)
    assert abs(float(got) - float(want)) / abs(float(want)) < 1e-5


def _loss_grad(x, y, method, **kwargs):
    xt = torch.from_numpy(x).requires_grad_(True)
    est, ref = AudioSignal(xt, SR, device="cpu"), AudioSignal(torch.from_numpy(y), SR, device="cpu")
    (PSP.MelSpectrogramLoss(stft_method=method, **kwargs)(est.clone(), ref.clone())
     + PSP.MultiScaleSTFTLoss(stft_method=method, **kwargs)(est.clone(), ref.clone())).backward()
    return xt.grad.numpy()


def _loss_grad_jax(x, y, method, **kwargs):
    def jloss(a):
        est, ref = JSignal(a, SR), JSignal(jnp.asarray(y), SR)
        return (JSP.MelSpectrogramLoss(stft_method=method, **kwargs)(est.clone(), ref.clone())
                + JSP.MultiScaleSTFTLoss(stft_method=method, **kwargs)(est.clone(), ref.clone()))

    with jax.disable_jit():
        return np.asarray(jax.grad(jloss)(jnp.asarray(x)))


@pytest.fixture
def frame_cotangents(monkeypatch):
    """Records, for each bf16 analysis that gradients reach, its window
    length and the largest element of the cotangent of its frames: the
    gradient after the frames' cast to bf16 rounded it, as it leaves the
    analysis towards the overlap-add."""
    seen = []
    analysis = PF._analysis

    def recording(frames, window_type, method):
        if frames.requires_grad:
            n = frames.shape[-1]
            frames.register_hook(lambda g: seen.append((n, float(g.abs().max()))))
        return analysis(frames, window_type, method)

    monkeypatch.setattr(PF, "_analysis", recording)
    return seen


def _rounding_bound(seen, hop_div=4):
    """How far two gradients may lie apart when the two sides compute the
    frames' cotangent in fp32 to within less than a bf16 ulp of each other
    and each rounds it to bf16 (the port by its cast's backward, the JAX
    side by ``astype``'s transpose): the two roundings land on the same
    value or on neighbours, one ulp, at most 2^-7 of the element, apart.
    Every sample is summed from ``hop_div`` frames of each analysis (hop a
    quarter of the window in the losses and the MRD), so at most that many
    neighbours add up, at the largest cotangent of each analysis."""
    assert seen
    return sum(hop_div * 2.0 ** -7 * peak for _, peak in seen)


def _neighbour_bound(x, y, **kwargs):
    """The same bound sample by sample, where the two sides' fp32
    cotangents lie within one ulp of each element (not only of the
    largest): the port's gradient with every frame's cotangent ``g``
    replaced by ``2^-7 |g|``. The overlap-add and the padding's transpose
    only add and copy, so they carry each element's neighbour bound to the
    samples as they carry the cotangent."""
    analysis = PF._analysis

    def bounding(frames, window_type, method):
        if frames.requires_grad:
            frames.register_hook(lambda g: g.abs() * 2.0 ** -7)
        return analysis(frames, window_type, method)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(PF, "_analysis", bounding)
        return _loss_grad(x, y, "matmul_bf16", **kwargs)


@pytest.mark.parametrize("kwargs", [{}, {"log_weight": 0.0}], ids=["log", "linear"])
def test_bf16_loss_gradient_matches_jax_with_rounded_operands(kwargs, frame_cotangents,
                                                              jax_bf16_operands):
    """d (mel + multi-scale STFT loss) / d estimate through the bf16
    analysis, with and without the log-magnitude terms, element by element
    against ``jax.grad`` of the JAX losses fed the same rounded operands.
    Both sides then sum the same bf16 products in fp32 and round the frames'
    cotangent to bf16 at the same place, so they may differ by the
    neighbours of that rounding, ``_rounding_bound`` (3.3e-2 and 2.4e-2 of
    the largest gradient here; measured 2.7e-3 and 4.3e-4 of it).

    Without the log terms the fp32 cotangents of the two sides agree to
    within an ulp of every element, and the gradients are held sample by
    sample to ``_neighbour_bound`` (at most 7.9e-3 of the largest gradient;
    measured at most 0.22 of it, sample by sample). The log terms weigh the
    cells by 1 / |X|, which magnifies the fp32 sums' disagreement in the
    quietest cells past a small element's ulp, so with them only the bound
    at the largest element holds.

    On a TPU the JAX package's DEFAULT-precision backward rounds the
    backward dot's operands instead of its result. Without the log terms,
    the port's gradient computed either way, or with no rounding in the
    backward at all, moves off the fp32 one by the same 4.5e-2 of its
    largest element at these seeds: the forward's rounding sets that, not
    the place of the backward's."""
    x = _noise((2, 1, 6000), 8, 0.1)
    y = _noise((2, 1, 6000), 9, 0.1)
    got = _loss_grad(x, y, "matmul_bf16", **kwargs)
    assert sorted(n for n, _ in frame_cotangents) == [512, 512, 2048, 2048]
    want = _loss_grad_jax(x, y, "matmul", **kwargs)
    assert np.all(np.isfinite(got))
    err = np.abs(got - want)
    assert err.max() <= _rounding_bound(frame_cotangents)
    if kwargs:
        assert np.all(err <= _neighbour_bound(x, y, **kwargs))


def test_backward_through_the_bf16_losses():
    """The gradient passes through the roundings (as through the JAX
    package's single-pass dot) and is finite. Where the losses are linear
    in the magnitudes (``log_weight=0``), it is held element by element
    against ``jax.grad`` of the JAX losses' own ``"matmul_bf16"``, which on
    the CPU sums unrounded fp32:

    - above 1e-6 of the largest gradient and 100 times the fp32 packages'
      own disagreement (the rounding is really there);
    - below twice the distance the JAX gradient moves when only the audio,
      and so every frame, is rounded to bf16. The bf16 analysis adds to
      that rounding the matrices' own, an operand perturbation of the same
      unit roundoff. (Measured 4.5e-2 of the largest gradient, against
      5.5e-2 for the audio's rounding alone. The gradient moves so much
      more than the spectrum's 2^-8 because each cell's L1 cotangent keeps
      its size but turns with the cell's phase, or flips its sign where the
      two magnitudes meet.)

    Its norm lies within 2^-8 of the port's ``"matmul"`` gradient's
    (measured 3e-4 to 7e-4 over four seeds): the element errors are
    independent of the gradient and add to its norm only in quadrature.

    With the log-magnitude terms the cells' weights go as 1 / |X|, and the
    bf16 analysis moves the quietest cells by as much as their size, so
    there it is held only against the JAX losses fed the same rounded
    operands (``test_bf16_loss_gradient_matches_jax_with_rounded_operands``)."""
    x = _noise((2, 1, 6000), 8, 0.1)
    y = _noise((2, 1, 6000), 9, 0.1)
    assert np.all(np.isfinite(_loss_grad(x, y, "matmul_bf16")))
    linear = dict(log_weight=0.0)
    got = _loss_grad(x, y, "matmul_bf16", **linear)
    want = _loss_grad_jax(x, y, "matmul_bf16", **linear)
    port32 = _loss_grad(x, y, "matmul", **linear)
    fp32 = np.abs(port32 - want).max()
    audio_rounded = np.abs(_loss_grad_jax(np.asarray(_bf16(x)), y, "matmul_bf16", **linear)
                           - want).max()
    assert np.all(np.isfinite(got))
    err = np.abs(got - want).max()
    assert max(1e-6 * np.abs(want).max(), 100 * fp32) < err < 2 * audio_rounded
    norm = np.linalg.norm
    assert 0.0 < abs(norm(got) - norm(port32)) / norm(port32) < BF16_REL


DISC = dict(periods=(2, 3), fft_sizes=(256, 128), mpd_channels=(4, 8), mrd_channels=4)


@pytest.fixture(scope="module")
def disc():
    """The JAX discriminator's tiny test config with its weights, and the
    port's with the same weights, one with each analysis."""
    model = JDisc(**DISC)
    params = jax.jit(model.init)(jax.random.PRNGKey(1), jnp.zeros((1, 1, 2048)))
    state = convert.discriminator_state_dict(jax.tree.map(np.asarray, params))
    ports = {}
    for method in ("matmul", "matmul_bf16"):
        ports[method] = Discriminator(**DISC, stft_method=method)
        ports[method].load_state_dict(state)
    return model, params, ports


def test_mrd_with_the_bf16_analysis_matches_jax(disc, jax_bf16_operands):
    """``Discriminator(stft_method="matmul_bf16")``'s MRD columns against the
    JAX MRD with converted weights. Fed the same rounded operands, the two
    sum the same bf16 values in fp32 and then run the same fp32 convs:
    1e-5 of each feature map's largest value, the forward pin of
    ``tests/test_torch_models.py``. The port's fp32 MRD, which that file
    holds to the JAX package's at the same pin, lies off it by more."""
    model, params, ports = disc
    audio = _noise((2, 1, 2048), 2, 0.1)
    with torch.no_grad():
        got = ports["matmul_bf16"](torch.from_numpy(audio))
        fp32 = ports["matmul"](torch.from_numpy(audio))
    with jax.disable_jit():
        want = model.apply(params, jnp.asarray(audio))
    n_mpd = len(DISC["periods"])
    assert len(got) == len(want) == n_mpd + len(DISC["fft_sizes"])
    for feats_p, feats_j, feats_32 in zip(got[n_mpd:], want[n_mpd:], fp32[n_mpd:]):
        assert len(feats_p) == len(feats_j)
        for fp, fj, f32 in zip(feats_p, feats_j, feats_32):
            fj = np.asarray(fj).transpose(0, 3, 1, 2)
            assert tuple(fp.shape) == fj.shape
            assert _rel(fp, fj) < STFT_RTOL
            assert _rel(f32, fj) > STFT_RTOL


def test_mrd_gradient_with_the_bf16_analysis_matches_jax(disc, frame_cotangents,
                                                         jax_bf16_operands):
    """The input gradient of ``Discriminator(stft_method="matmul_bf16")``'s
    MRD, the gradient that the adversarial step sends into the generator,
    element by element against ``jax.grad`` of the JAX MRD with converted
    weights, fed the same rounded operands: within the neighbours of the
    frames' cotangent rounding, ``_rounding_bound`` (measured 4.7e-4 of the
    largest gradient, against a bound of 2.2e-2)."""
    model, params, ports = disc
    audio = _noise((2, 1, 2048), 2, 0.1)
    n_mpd = len(DISC["periods"])

    def mrd_loss(outs):
        return sum((f ** 2).mean() for col in outs[n_mpd:] for f in col)

    a = torch.from_numpy(audio).requires_grad_(True)
    mrd_loss(ports["matmul_bf16"](a)).backward()
    got = a.grad.numpy()
    assert sorted(n for n, _ in frame_cotangents) == sorted(DISC["fft_sizes"])
    with jax.disable_jit():
        want = np.asarray(jax.grad(lambda b: mrd_loss(model.apply(params, b)))(jnp.asarray(audio)))
    assert np.all(np.isfinite(got)) and np.abs(want).max() > 0
    assert np.abs(got - want).max() <= _rounding_bound(frame_cotangents)
