"""The fused bf16 iSTFT synthesis (kernel E) and the rotation scan (kernel
D) of the port on the CPU: their plain versions against the JAX package's
Pallas kernels in interpret mode, the weight layout the CUDA kernel reads,
the shape rule of ``istft(method="matmul_bf16_fused")``, and the dispatch
of the wrappers (a tensor off the CPU goes to the kernel or the call
raises).

Tolerances: E 1e-5 of the largest output (both sides round the same fp32
operands to bf16 and sum the exact products in fp32, in other orders); D
1e-5 absolute (the JAX package's pin, tests/core/test_stretch.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # the workers of a parallel test run share the host's cores

from audiotools_tpu.ops import fft as JF
from audiotools_tpu.ops import pallas_kernels as JPK
from audiotools_tpu.ops import stretch as JS
from audiotools_tpu_torch import _build
from audiotools_tpu_torch.ops import fft as PF
from audiotools_tpu_torch.ops import hopper_kernels as HK
from audiotools_tpu_torch.ops import stretch as PS

SR = 44100


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.abs(got - want).max() / np.abs(want).max()


def _spectrum(win, hop, match_stride, seed=3, T=9000):
    """The JAX package's test input: an STFT of seeded noise, here made
    inconsistent so that the synthesis has work to do."""
    rng = np.random.RandomState(seed)
    x = jnp.asarray(rng.randn(2, 1, T).astype(np.float32) * 0.3)
    spec = np.asarray(JF.stft(x, win, hop, match_stride=match_stride, method="matmul"))
    return spec * rng.uniform(0, 1.5, spec.shape[-2:]).astype(np.float32)


# -- E: the fused bf16 synthesis ---------------------------------------------


@pytest.mark.parametrize("match_stride", [False, True])
@pytest.mark.parametrize("win,hop", [(2048, 512), (512, 128)])
def test_fused_synthesis_matches_jax_interpret(win, hop, match_stride):
    spec = _spectrum(win, hop, match_stride)
    want = np.asarray(JF.istft(jnp.asarray(spec), win, hop, match_stride=match_stride,
                               original_length=9000, method="matmul_bf16_fused_interpret"))
    got = PF.istft(torch.from_numpy(spec), win, hop, match_stride=match_stride,
                   original_length=9000, method="matmul_bf16_fused").numpy()
    assert got.shape == want.shape == (2, 1, 9000)
    assert _rel(got, want) < 1e-5


@pytest.mark.parametrize("match_stride", [False, True])
@pytest.mark.parametrize("win,hop", [(2048, 512), (512, 128)])
def test_fused_interpret_synthesis_matches_jax_interpret(win, hop, match_stride):
    """Both packages' interpreter-mode name: E's plain version against the
    Pallas kernel interpreted, at E's pin."""
    spec = _spectrum(win, hop, match_stride, seed=5)
    kwargs = dict(match_stride=match_stride, original_length=9000,
                  method="matmul_bf16_fused_interpret")
    want = np.asarray(JF.istft(jnp.asarray(spec), win, hop, **kwargs))
    got = PF.istft(torch.from_numpy(spec), win, hop, **kwargs).numpy()
    assert got.shape == want.shape == (2, 1, 9000)
    assert _rel(got, want) < 1e-5


@pytest.mark.parametrize("win,hop", [(2048, 512), (512, 100), (2048, 128)])
def test_fused_interpret_synthesis_runs_es_plain_version(win, hop, monkeypatch):
    """``"matmul_bf16_fused_interpret"`` never calls kernel E's wrapper: it
    runs E's plain version under E's shape rule (bit-equal to
    ``"matmul_bf16"``, which sums in the same order) and ``"matmul_bf16"``
    outside it."""
    calls = []
    real_plain = HK.istft_synthesis_fused_plain
    monkeypatch.setattr(HK, "istft_synthesis_fused", lambda *a: pytest.fail("kernel E called"))
    monkeypatch.setattr(HK, "istft_synthesis_fused_plain",
                        lambda *a: calls.append(a[2]) or real_plain(*a))
    rng = np.random.RandomState(win + hop)
    n_freq = win // 2 + 1
    spec = torch.from_numpy(
        ((rng.randn(2, n_freq, 20) + 1j * rng.randn(2, n_freq, 20)) * 0.1).astype(np.complex64))
    got = PF.istft(spec, win, hop, length=3000, method="matmul_bf16_fused_interpret")
    assert torch.equal(got, PF.istft(spec, win, hop, length=3000, method="matmul_bf16"))
    in_rule = win % hop == 0 and win // hop <= HK.MAX_SYNTHESIS_OVERLAP
    assert calls == ([hop] if in_rule else [])


@pytest.mark.parametrize("win,hop", [(2048, 512), (512, 128), (256, 32)])
def test_fused_synthesis_is_the_bf16_synthesis(win, hop):
    """On the CPU the fused method runs E's plain version: the numerics of
    ``matmul_bf16``, summed in the same order."""
    spec = torch.from_numpy(_spectrum(win, hop, False, seed=4))
    fused = PF.istft(spec, win, hop, length=9000, method="matmul_bf16_fused")
    bf16 = PF.istft(spec, win, hop, length=9000, method="matmul_bf16")
    assert torch.equal(fused, bf16)


@pytest.mark.parametrize("win,hop", [(512, 100), (2048, 128), (1024, 96)])
def test_fused_synthesis_shape_rule(win, hop, monkeypatch):
    """A hop that does not divide the window, or more than 8 overlapping
    frames, runs ``matmul_bf16`` (the JAX package's rule); E is not called.
    (The JAX package's ``matmul_bf16`` sums in fp32 on the CPU, so it is no
    reference for the bf16 numerics here.)"""
    monkeypatch.setattr(HK, "istft_synthesis_fused", lambda *a: pytest.fail("kernel E called"))
    rng = np.random.RandomState(win + hop)
    n_freq = win // 2 + 1
    spec = ((rng.randn(2, n_freq, 20) + 1j * rng.randn(2, n_freq, 20)) * 0.1).astype(np.complex64)
    got = PF.istft(torch.from_numpy(spec), win, hop, length=3000, method="matmul_bf16_fused")
    want = PF.istft(torch.from_numpy(spec), win, hop, length=3000, method="matmul_bf16")
    assert torch.equal(got, want)


def test_fused_synthesis_reaches_the_kernel_wrapper(monkeypatch):
    calls = []
    real = HK.istft_synthesis_fused

    def spy(spec, w, hop, env, edge):
        calls.append((tuple(spec.shape), spec.is_contiguous(), tuple(w.shape), hop,
                      tuple(env.shape), edge))
        return real(spec, w, hop, env, edge)

    monkeypatch.setattr(HK, "istft_synthesis_fused", spy)
    spec = torch.from_numpy(_spectrum(512, 128, True))
    PF.istft(spec, 512, 128, match_stride=True, original_length=9000, method="matmul_bf16_fused")
    nt = spec.shape[-1]
    # match_stride's zero frames are read as zeros, not padded into a copy
    # (2 x 257 = 514 rows padded to 528; 4 column blocks of 128)
    assert calls == [((2, nt, 257), False, (528, 512), 128, (512 + 128 * (nt + 3),), 2)]
    # a time-major spectrum (as the phase vocoder writes it) reaches E in place
    calls.clear()
    tm = spec.transpose(-1, -2).contiguous().transpose(-1, -2)
    PF.istft(tm, 512, 128, original_length=9000, method="matmul_bf16_fused")
    assert calls[0][:2] == ((2, nt, 257), True) and calls[0][-1] == 0


@pytest.mark.parametrize("n_fft,hop,nt", [(256, 64, 9), (128, 128, 5), (64, 8, 12)])
def test_kernel_weight_layout_evaluates_to_the_plain_version(n_fft, hop, nt):
    """The weights the CUDA kernel reads (rows interleaved re/im as a
    complex64 row, column blocks padded to the block width, rows padded to
    the contraction chunk), evaluated in float64 the way the kernel walks
    them, give the plain version's output."""
    rng = np.random.RandomState(n_fft + nt)
    n_freq = n_fft // 2 + 1
    spec = torch.from_numpy(((rng.randn(2, nt, n_freq) + 1j * rng.randn(2, nt, n_freq)) * 0.1)
                            .astype(np.complex64))
    Ci, Si = PF._on_device(PF._idft_matrices, ("hann", n_fft), torch.device("cpu"))
    (env,) = PF._on_device(PF._inverse_envelope, ("hann", n_fft, hop, nt), torch.device("cpu"))
    w = HK.synthesis_weights(Ci, Si, hop)
    hop_p, k2 = HK._syn_layout(n_freq, hop)
    r = n_fft // hop
    assert w.dtype == torch.bfloat16 and w.shape == (k2, r * hop_p)
    assert k2 % HK._SYN_K_CHUNK == 0 and k2 >= 2 * n_freq and hop_p % HK._SYN_COLS == 0
    assert torch.equal(w, PF._on_device(PF._synthesis_design, ("hann", n_fft, hop),
                                        torch.device("cpu"))[0])
    w = w.double().numpy()
    # the spectrum as the kernel reads it: (B, nt, n_freq) complex64 is
    # (B, nt, 2 n_freq) floats, re and im interleaved; rounded to bf16
    a = torch.view_as_real(spec).reshape(2, nt, 2 * n_freq).to(torch.bfloat16).double().numpy()
    a = np.pad(a, ((0, 0), (0, 0), (0, k2 - 2 * n_freq)))
    m_total = nt + r - 1
    out = np.zeros((2, m_total, hop))
    for m in range(m_total):
        for j in range(r):
            if 0 <= m - j < nt:
                out[:, m] += a[:, m - j] @ w[:, j * hop_p : j * hop_p + hop]
    out = out.reshape(2, -1) * env.double().numpy()
    # the bf16 synthesis from the matrices themselves, in float64
    re, im = (PF._bf16(t).double().numpy() for t in (spec.real, spec.imag))
    frames = re @ PF._bf16(Ci).double().numpy() + im @ PF._bf16(Si).double().numpy()
    want = np.zeros((2, m_total * hop))
    for i in range(nt):
        want[:, i * hop : i * hop + n_fft] += frames[:, i]
    want *= env.double().numpy()
    assert _rel(out, want) < 1e-12
    plain = HK.istft_synthesis_fused_plain(spec, HK.synthesis_weights(Ci, Si, hop), hop, env)
    assert _rel(plain.numpy(), want) < 1e-5


@pytest.mark.parametrize("edge", [1, 2])
def test_edge_frames_are_zero_frames(edge):
    """``edge`` zero frames at each end give what a spectrum padded with
    them gives."""
    rng = np.random.RandomState(edge)
    spec = torch.from_numpy(((rng.randn(2, 7, 65) + 1j * rng.randn(2, 7, 65)) * 0.1)
                            .astype(np.complex64))
    (w,) = PF._on_device(PF._synthesis_design, ("hann", 128, 32), torch.device("cpu"))
    (env,) = PF._on_device(PF._inverse_envelope, ("hann", 128, 32, 7 + 2 * edge),
                           torch.device("cpu"))
    padded = torch.nn.functional.pad(spec, (0, 0, edge, edge))
    got = HK.istft_synthesis_fused(spec, w, 32, env, edge)
    assert torch.equal(got, HK.istft_synthesis_fused(padded, w, 32, env))
    with pytest.raises(ValueError, match="envelope"):
        HK.istft_synthesis_fused(spec, w, 32, env)


def test_fused_synthesis_checks_its_inputs():
    Ci, Si = torch.zeros(33, 64), torch.zeros(33, 64)
    w = HK.synthesis_weights(Ci, Si, 16)
    spec = torch.zeros(1, 3, 33, dtype=torch.complex64)
    with pytest.raises(TypeError, match="complex64"):
        HK.istft_synthesis_fused(spec.to(torch.complex128), w, 16, torch.ones(96))
    with pytest.raises(ValueError, match="n_fft / hop <= 8"):
        HK.synthesis_weights(Ci, Si, 6)
    with pytest.raises(ValueError, match="n_fft / hop <= 8"):
        HK.synthesis_weights(Ci, Si, 4)
    with pytest.raises(ValueError, match="envelope"):
        HK.istft_synthesis_fused(spec, w, 16, torch.ones(95))
    with pytest.raises(ValueError, match="synthesis weights"):
        HK.istft_synthesis_fused(spec[..., :5], w, 16, torch.ones(96))
    with pytest.raises(ValueError, match="synthesis weights"):
        HK.istft_synthesis_fused(spec, w.float(), 16, torch.ones(96))
    with pytest.raises(ValueError, match="edge"):
        HK.istft_synthesis_fused(spec, w, 16, torch.ones(96), -1)


# -- the unfused bf16 synthesis: two fp32 products here, one GEMM on the card --


@pytest.mark.parametrize("win,hop,match_stride", [(2048, 512, False), (2048, 512, True),
                                                  (512, 128, True), (512, 100, False)])
def test_bf16_synthesis_on_the_cpu_is_the_two_fp32_products(win, hop, match_stride):
    """On the CPU ``istft(method="matmul_bf16")`` keeps its two fp32
    products of the bf16-rounded operands, bit for bit, and never takes the
    card's tensor-core product (its counter stays)."""
    from tests.test_torch_cuda import two_product_bf16_istft

    spec = torch.from_numpy(_spectrum(win, hop, match_stride, seed=6))
    before = PF.BF16_SYNTHESIS_GEMMS
    got = PF.istft(spec, win, hop, match_stride=match_stride, original_length=9000,
                   method="matmul_bf16")
    assert PF.BF16_SYNTHESIS_GEMMS == before
    assert torch.equal(got, two_product_bf16_istft(spec, win, hop, match_stride, 9000))


@pytest.mark.parametrize("n_fft,edge", [(2048, 2), (512, 0), (100, 2), (64, 1)])
def test_bf16_synthesis_gemm_operands_interleave_the_bins(n_fft, edge):
    """The card's product reads the spectrum as ``view_as_real`` lays it
    out (re and im of each bin side by side) against weights interleaved
    the same way, both padded with zeros to rows of 16 bytes, and the
    ``edge`` zero frames as zero rows: in float64 the two give the two-product
    frames (the bf16 values' products are exact there too)."""
    rng = np.random.RandomState(n_fft + edge)
    n_freq, nt = n_fft // 2 + 1, 7
    spec = torch.from_numpy(((rng.randn(2, n_freq, nt) + 1j * rng.randn(2, n_freq, nt)) * 0.1)
                            .astype(np.complex64)).transpose(-1, -2)  # (B, nt, n_freq) view
    (w,) = PF._on_device(PF._bf16_synthesis_design, ("hann", n_fft), torch.device("cpu"))
    a = PF._bf16_synthesis_operand(spec, edge, w.shape[0])
    rows = w.shape[0]
    assert w.dtype == a.dtype == torch.bfloat16
    assert rows % 8 == 0 and 2 * n_freq <= rows < 2 * n_freq + 8
    assert w.shape == (rows, n_fft) and a.shape == (2 * (nt + 2 * edge), rows)
    assert not w[2 * n_freq :].any() and not a[:, 2 * n_freq :].any()
    got = (a.double() @ w.double()).view(2, nt + 2 * edge, n_fft)
    assert not got[:, :edge].any() and not got[:, nt + edge :].any()
    Ci, Si = PF._on_device(PF._idft_matrices, ("hann", n_fft), torch.device("cpu"))
    want = (PF._bf16(spec.real).double() @ PF._bf16(Ci).double()
            + PF._bf16(spec.imag).double() @ PF._bf16(Si).double())
    assert _rel(got[:, edge : nt + edge].numpy(), want.numpy()) < 1e-12


# -- D: the rotation scan ----------------------------------------------------


def _unit_planes(rng, shape):
    theta = rng.uniform(-np.pi, np.pi, shape).astype(np.float32)
    phi = rng.uniform(-np.pi, np.pi, shape[:-1]).astype(np.float32)
    return np.cos(theta), np.sin(theta), np.cos(phi), np.sin(phi)


@pytest.mark.parametrize("shape", [(3, 5, 33), (2, 64), (4, 1)])
def test_rotation_plain_matches_jax_interpret(shape):
    planes = _unit_planes(np.random.RandomState(7), shape)
    wpr, wpi = JPK.rotation_cumprod(*map(jnp.asarray, planes), interpret=True)
    pr, pi = HK.rotation_cumprod(*map(torch.from_numpy, planes))
    assert pr.shape == pi.shape == shape
    assert np.abs(pr.numpy() - np.asarray(wpr)).max() < 1e-5
    assert np.abs(pi.numpy() - np.asarray(wpi)).max() < 1e-5
    # the exclusive complex cumprod, in complex128
    ur, ui, cr, ci = planes
    s = np.concatenate([(cr + 1j * ci)[..., None], (ur + 1j * ui)[..., :-1]], axis=-1)
    want = np.cumprod(s.astype(np.complex128), axis=-1)
    assert np.abs(pr.numpy() + 1j * pi.numpy() - want).max() < 1e-5


def test_rotation_is_the_vocoders_phasor_track():
    """P of kernel B (the phasor vocoder's unit track) is D's scan of B's
    unit cross-spectra, seeded with frame 0's unit phasor."""
    rng = np.random.RandomState(8)
    z = (rng.randn(2, 17, 30) + 1j * rng.randn(2, 17, 30)).astype(np.complex64)
    i0, i1, frac = PS._pv_indices(30, 0.8)
    _, track = HK.phase_vocoder_fused(torch.from_numpy(z), i0, i1, frac, with_phasor=True)
    z0, z1 = z[..., i0], z[..., i1]
    u = z1 * np.conj(z0) / (np.abs(z0) * np.abs(z1))
    seed = z[..., 0] / np.abs(z[..., 0])
    pr, pi = HK.rotation_cumprod(*(torch.from_numpy(np.ascontiguousarray(a, np.float32)) for a in (
        u.real, u.imag, seed.real, seed.imag)))
    assert np.abs(pr.numpy() - track.real.numpy()).max() < 1e-5
    assert np.abs(pi.numpy() - track.imag.numpy()).max() < 1e-5


def test_rotation_checks_its_inputs():
    ur = torch.zeros(2, 5)
    with pytest.raises(ValueError, match="seeds"):
        HK.rotation_cumprod(ur, ur, torch.zeros(3), torch.zeros(3))
    with pytest.raises(TypeError, match="float32"):
        HK.rotation_cumprod(ur.double(), ur.double(), torch.zeros(2), torch.zeros(2))


# -- dispatch: CPU -> plain version; any other device -> kernel or raise -----


def _calls(device):
    """One call of D and one of E on ``device``, each expected to raise."""
    z = torch.zeros(2, 5, device=device)
    c = torch.zeros(2, device=device)
    spec = torch.zeros(1, 3, 33, dtype=torch.complex64, device=device)
    # 33 bins, n_fft 64, hop 16: 66 rows padded to 80, 4 column blocks of 128
    w = torch.zeros(80, 512, dtype=torch.bfloat16, device=device)
    env = torch.ones(96, device=device)
    msgs = []
    for call in (lambda: HK.rotation_cumprod(z, z, c, c),
                 lambda: HK.istft_synthesis_fused(spec, w, 16, env)):
        with pytest.raises(RuntimeError) as err:
            call()
        msgs.append(str(err.value))
    return msgs


def test_rotation_and_synthesis_off_the_cpu_reach_the_kernel_or_raise(monkeypatch):
    for name in ("rotation_cumprod_plain", "istft_synthesis_fused_plain"):
        monkeypatch.setattr(HK, name, lambda *a: pytest.fail("plain version ran"))

    def missing(name):
        raise RuntimeError(f"cannot load the {name} kernel library")

    monkeypatch.setattr(_build, "library", missing)
    assert [("rotation_cumprod" in a, "istft_synthesis" in b) for a, b in [_calls("meta")]] == [
        (True, True)]

    class _Lib:
        def __getattr__(self, name):
            return lambda *a: 0

    monkeypatch.setattr(_build, "library", lambda name: _Lib())
    assert all("expected CUDA tensors" in msg for msg in _calls("meta"))


def test_every_kernel_source_is_built():
    assert set(_build.SOURCES) == {src for src, _ in HK._SIGNATURES.values()}
    for src in _build.SOURCES:
        assert (_build.CSRC / f"{src}.cu").exists()
    assert _build.EXTRA_FLAGS["rotation_cumprod"] == ["--fmad=false"]


# -- the pitch shift through E -----------------------------------------------


@pytest.mark.parametrize("n_semitones", [2.0, -3.0])
def test_fused_pitch_shift_matches_jax(n_semitones):
    x = (np.random.RandomState(12).randn(2, 1, 11025) * 0.1).astype(np.float32)
    kw = dict(synthesis_method="matmul_bf16_fused")
    want = np.asarray(JS.pitch_shift(jnp.asarray(x), n_semitones, SR,
                                     synthesis_method="matmul_bf16_fused_interpret",
                                     pv_formulation="phasor_fused_interpret"))
    got = PS.pitch_shift(torch.from_numpy(x), n_semitones, SR, pv_formulation="phasor_fused",
                         **kw).numpy()
    assert got.shape == want.shape == x.shape
    assert np.abs(got - want).max() < 1e-4
    # the default formulation ("angle") into E
    want = np.asarray(JS.time_stretch(jnp.asarray(x), 0.9,
                                      synthesis_method="matmul_bf16_fused_interpret"))
    got = PS.time_stretch(torch.from_numpy(x), 0.9, **kw).numpy()
    assert np.abs(got - want).max() < 1e-4
