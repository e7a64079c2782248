"""The port's host-side numpy designs are bit-equal to the JAX package's.

The port re-implements these designs (it cannot import ``audiotools_tpu``,
whose package import pulls in JAX); every one must produce exactly the
same arrays (``np.array_equal``), so both packages filter, transform and
resample with identical coefficients.
"""
import numpy as np
import pytest

from audiotools_tpu.ops import fft as JF
from audiotools_tpu.ops import filters as JFL
from audiotools_tpu.ops import loudness as JL
from audiotools_tpu.ops import nsim as JN
from audiotools_tpu.ops import pesq as JP
from audiotools_tpu.ops import resample as JR
from audiotools_tpu.ops import stoi as JSTOI
from audiotools_tpu.ops import stretch as JS
from audiotools_tpu_torch.ops import fft as PF
from audiotools_tpu_torch.ops import filters as PFL
from audiotools_tpu_torch.ops import loudness as PL
from audiotools_tpu_torch.ops import nsim as PN
from audiotools_tpu_torch.ops import pesq as PP
from audiotools_tpu_torch.ops import resample as PR
from audiotools_tpu_torch.ops import stoi as PSTOI
from audiotools_tpu_torch.ops import stretch as PS


def _equal(a, b):
    if isinstance(a, (tuple, list)):
        assert isinstance(b, (tuple, list)) and len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == np.asarray(b).dtype and np.array_equal(a, b)
    else:
        assert a == b


@pytest.mark.parametrize("old,new", [(55, 49), (49, 55), (160, 441), (147, 160), (3, 2)])
def test_resample_kernels(old, new):
    _equal(PR.resample_kernels(old, new), JR.resample_kernels(old, new))


def test_resample_host_path():
    x = np.random.RandomState(0).randn(2, 1, 3001).astype(np.float32)
    kernels, width = PR.resample_kernels(160, 441)
    _equal(PR._resample_host_impl(x, 160, 441, kernels, width),
           JR._resample_host_impl(x, 160, 441, kernels, width))


@pytest.mark.parametrize("sr,n_bands", [(44100, 6), (44100, 3), (16000, 10), (48000, 2)])
def test_split_band_kernels_and_cutoffs(sr, n_bands):
    _equal(PFL.mel_band_cutoffs(sr, n_bands), JFL.mel_band_cutoffs(sr, n_bands))
    _equal(PFL._split_band_kernels(sr, n_bands), JFL._split_band_kernels(sr, n_bands))


@pytest.mark.parametrize("rate,block", [(44100, 512), (48000, 512), (16000, 128)])
@pytest.mark.parametrize("filter_class", ["K-weighting", "Fenton/Lee 1", "Dash et al."])
def test_blocked_iir_operators(rate, block, filter_class):
    stages = tuple(
        (tuple(float(v) for v in b), tuple(float(v) for v in a), float(g))
        for (b, a), g in JL.design_filters(rate, filter_class)
    )
    _equal(PFL._blocked_iir_operators(stages, block), JFL._blocked_iir_operators(stages, block))


@pytest.mark.parametrize("rate", [44100, 48000, 16000])
@pytest.mark.parametrize("filter_class", ["K-weighting", "Fenton/Lee 1", "Fenton/Lee 2", "Dash et al."])
def test_design_filters(rate, filter_class):
    _equal(PL.design_filters(rate, filter_class), JL.design_filters(rate, filter_class))


@pytest.mark.parametrize("kind", ["high_shelf", "high_pass", "peaking", "low_shelf"])
def test_rbj(kind):
    _equal(PL._rbj(kind, 3.5, 0.7, 1234.5, 44100), JL._rbj(kind, 3.5, 0.7, 1234.5, 44100))


@pytest.mark.parametrize("window_type", ["hann", "sqrt_hann", "average", "hamming"])
@pytest.mark.parametrize("n_fft", [2048, 512])
def test_windows_and_dft_matrices(window_type, n_fft):
    _equal(PF.get_window(window_type, n_fft), JF.get_window(window_type, n_fft))
    _equal(PF._dft_matrices(window_type, n_fft), JF._dft_matrices(window_type, n_fft))
    # the synthesis matrices as the JAX package's matmul iSTFTs assemble them
    _equal(PF._idft_matrices(window_type, n_fft),
           tuple(np.asarray(m) for m in JF._idft_matrices_device(window_type, n_fft)))


@pytest.mark.parametrize("args", [(44100, 2048, 80), (16000, 512, 40, 50.0, 7000.0),
                                  (22050, 1024, 128)])
def test_mel_filters(args):
    _equal(PF.mel_filters(*args), JF.mel_filters(*args))


@pytest.mark.parametrize("n_mfcc,n_mels,norm", [(40, 80, "ortho"), (13, 40, "ortho"),
                                                (20, 128, None), (1, 1, "ortho")])
def test_dct_matrix(n_mfcc, n_mels, norm):
    _equal(PF.dct_matrix(n_mfcc, n_mels, norm), JF.dct_matrix(n_mfcc, n_mels, norm))


@pytest.mark.parametrize("T,rate", [(384, 2 ** (-2 / 12)), (61, 1.31), (100, 0.77), (5, 1.0)])
def test_pv_indices(T, rate):
    _equal(PS._pv_indices(T, rate), JS._pv_indices(T, rate))


@pytest.mark.parametrize("n_taps", [1, 512, 2048])
@pytest.mark.parametrize("rate", [44100, 16000])
def test_fir_from_biquad(rate, n_taps):
    for (b, a), _ in JL.design_filters(rate, "K-weighting"):
        _equal(PFL.fir_from_biquad(b, a, n_taps), JFL.fir_from_biquad(b, a, n_taps))


@pytest.mark.parametrize("zeros", [512, 2048, 64])
@pytest.mark.parametrize("rate,filter_class", [(44100, "K-weighting"), (48000, "K-weighting"),
                                               (16000, "Fenton/Lee 1"), (44100, "Dash et al.")])
def test_composed_fir(rate, filter_class, zeros):
    _equal(PL._composed_fir(rate, filter_class, zeros), JL._composed_fir(rate, filter_class, zeros))


@pytest.mark.parametrize("rate,filter_class", [(44100, "K-weighting"), (48000, "Fenton/Lee 2"),
                                               (16000, "Dash et al.")])
def test_exact_fir(rate, filter_class):
    _equal(PL._exact_fir(rate, filter_class), JL._exact_fir(rate, filter_class))


@pytest.mark.parametrize("args", [(), (10000, 512, 15, 150), (16000, 1024, 20, 100)])
def test_stoi_thirdoct_and_window(args):
    _equal(PSTOI.thirdoct(*args), JSTOI.thirdoct(*args))
    _equal(PSTOI._window(), JSTOI._window())


@pytest.mark.parametrize("mode", ["nb", "wb"])
@pytest.mark.parametrize("n_fft", [2, 4096, 524288])
def test_pesq_mode_tables(mode, n_fft):
    got, want = PP._mode_tables(mode, n_fft), JP._mode_tables(mode, n_fft)
    assert got.keys() == want.keys()
    for key in want:
        _equal(got[key], want[key])


@pytest.mark.parametrize("mode", ["speech", "audio"])
def test_nsim_gammatone_weights(mode):
    assert PN.MODES[mode] == JN.MODES[mode]
    _equal(PN.gammatone_weights(mode), JN.gammatone_weights(mode))
