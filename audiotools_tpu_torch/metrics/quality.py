"""Quality metrics: STOI, PESQ and ViSQOL over batches of signals.

Counterpart of ``audiotools_tpu/metrics/quality.py``. STOI runs natively in
two forms: the float64 host loop (``stoi``, one item at a time) and the
batched device program (``stoi_device``, ``ops/stoi.py``). PESQ uses the
ITU ``pesq`` C extension where it is installed and otherwise the native
P.862-architecture implementation (``metrics/_pesq.py`` on the host,
``ops/pesq.py`` batched on the device). ViSQOL uses Google's C++ library
where it is installed and otherwise the in-package NSIM backend
(``ops/nsim.py``). Scores are tensors: the device programs' on the device
of the signals, the host loops' (float64) moved there.

Calibration of the in-package backends
--------------------------------------
They reproduce the architectures, not the certified absolute scales, and
warn once per process when they are used:

- **STOI** (host and device): pinned against an independent float64
  implementation of Taal et al.; treat as exact. No warning.
- **PESQ native** (``backend="native"``, ``pesq_device``): output range
  [1.0, 5.0], monotone on noise, clipping and quantization ladders; its
  absolute offset from the ITU tool is not certified.
- **ViSQOL NSIM** (``backend="nsim"``): raw NSIM is the stable metric
  (identical -> 1.0); the NSIM -> MOS-LQO map is an uncertified estimate
  anchored to ViSQOL's published ceiling (~4.73).
"""
import os
import warnings

import numpy as np
import torch

from ..core import AudioSignal
from ..ops.stoi import BETA as _BETA
from ..ops.stoi import DYN_RANGE as _DYN_RANGE
from ..ops.stoi import FS as _FS
from ..ops.stoi import MINFREQ as _MINFREQ
from ..ops.stoi import N as _N
from ..ops.stoi import N_FRAME as _N_FRAME
from ..ops.stoi import NFFT as _NFFT
from ..ops.stoi import NUMBAND as _NUMBAND
from ..ops.stoi import thirdoct

__all__ = ["stoi", "stoi_device", "pesq", "pesq_device", "visqol"]

# once-per-process flags for the uncertified-scale warnings: the in-package
# backends reproduce the architecture but not the certified absolute scale,
# and users must see that at call time, not only in the docs
_warned_uncertified = set()


def _warn_uncertified(key: str, message: str):
    if key in _warned_uncertified:
        return
    _warned_uncertified.add(key)
    warnings.warn(message, UserWarning, stacklevel=3)


_PESQ_NATIVE_WARNING = (
    "pesq() is using the in-package P.862-architecture backend, not the "
    "certified ITU `pesq` C extension. Scores are on the right range "
    "(1.0-5.0 MOS-LQO) and track degradation ladders monotonically, but the "
    "absolute calibration is NOT certified (re-derived tables). Install the "
    "`pesq` package or pass backend='itu' on a host that has it for "
    "certified numbers."
)

_VISQOL_NSIM_WARNING = (
    "visqol() is using the in-package NSIM backend, not Google's ViSQOL C++ "
    "library. The NSIM similarity core ranks degradations like ViSQOL, but "
    "the NSIM->MOS-LQO map is an uncertified monotone fit (the trained "
    "SVR/lattice models are unavailable offline). Install google/visqol or "
    "pass backend='google' on a host that has it for certified MOS-LQO."
)


def _scores(values, like: AudioSignal) -> torch.Tensor:
    """Host scores as a float64 tensor on the signal's device."""
    return torch.tensor(np.array(values, dtype=np.float64), device=like.device)


def _mono_at(signal: AudioSignal, sample_rate: int) -> AudioSignal:
    return signal.clone().to_mono().resample(sample_rate)


def _host_item(signal: AudioSignal, i: int) -> np.ndarray:
    return signal.audio_data[i, 0].detach().cpu().numpy().astype(np.float64)


# --- native STOI (Taal et al. 2010/2011), the float64 host loop -------------


def _frames(x):
    w = np.hanning(_N_FRAME + 2)[1:-1]
    hop = _N_FRAME // 2
    n = 1 + (len(x) - _N_FRAME) // hop
    return np.stack([x[i * hop: i * hop + _N_FRAME] * w for i in range(n)])


def _remove_silent(x, y):
    """Drop the frames more than DYN_RANGE dB below the reference's loudest
    and overlap-add the rest back into signals."""
    hop = _N_FRAME // 2
    xf, yf = _frames(x), _frames(y)
    energies = 20 * np.log10(np.linalg.norm(xf, axis=1) + 1e-12)
    mask = energies > energies.max() - _DYN_RANGE
    xf, yf = xf[mask], yf[mask]
    out_len = (len(xf) - 1) * hop + _N_FRAME if len(xf) else 0
    xs, ys = np.zeros(out_len), np.zeros(out_len)
    for i in range(len(xf)):
        xs[i * hop: i * hop + _N_FRAME] += xf[i]
        ys[i * hop: i * hop + _N_FRAME] += yf[i]
    return xs, ys


def _row_col_normalize(Z):
    """eSTOI's double normalization of a (J, N) segment (Jensen & Taal 2016
    eq. 3-4): each band's row across the N frames, then each frame's column
    across the J bands."""
    Z = Z - Z.mean(axis=1, keepdims=True)
    Z = Z / (np.linalg.norm(Z, axis=1, keepdims=True) + 1e-12)
    Z = Z - Z.mean(axis=0, keepdims=True)
    return Z / (np.linalg.norm(Z, axis=0, keepdims=True) + 1e-12)


def _stoi_single(x, y, extended=False):
    # the 0/1 band matrix is exact in float64
    obm = thirdoct(_FS, _NFFT, _NUMBAND, _MINFREQ)[0].astype(np.float64)
    x, y = _remove_silent(x, y)
    if len(x) < _N_FRAME * _N:
        return np.nan
    X = np.sqrt(np.maximum(obm @ (np.abs(np.fft.rfft(_frames(x), n=_NFFT).T) ** 2), 1e-15))
    Y = np.sqrt(np.maximum(obm @ (np.abs(np.fft.rfft(_frames(y), n=_NFFT).T) ** 2), 1e-15))

    corrs = []
    for m in range(_N, X.shape[1] + 1):
        Xs, Ys = X[:, m - _N: m], Y[:, m - _N: m]
        if extended:
            corrs.append((_row_col_normalize(Xs) * _row_col_normalize(Ys)).sum() / _N)
        else:
            alpha = np.linalg.norm(Xs, axis=1, keepdims=True) / (
                np.linalg.norm(Ys, axis=1, keepdims=True) + 1e-12)
            aY = np.minimum(Ys * alpha, Xs * (1 + 10 ** (-_BETA / 20)))
            xm = Xs - Xs.mean(axis=1, keepdims=True)
            ym = aY - aY.mean(axis=1, keepdims=True)
            den = np.linalg.norm(xm, axis=1) * np.linalg.norm(ym, axis=1) + 1e-12
            corrs.append(((xm * ym).sum(axis=1) / den).mean())
    return float(np.mean(corrs))


def stoi(estimates: AudioSignal, references: AudioSignal, extended: bool = False):
    """Short-term objective intelligibility, one score per item: the
    float64 host loop, Taal et al.'s STOI (``extended``: Jensen & Taal's
    eSTOI, deterministic epsilons in place of pystoi's random dither)."""
    estimates = _mono_at(estimates, _FS)
    references = _mono_at(references, _FS)
    return _scores([
        _stoi_single(_host_item(references, i), _host_item(estimates, i), extended=extended)
        for i in range(estimates.batch_size)], estimates)


def stoi_device(estimates: AudioSignal, references: AudioSignal, extended: bool = False):
    """Batched STOI as one device program on the signals' device (no
    per-item host loop); matches ``stoi`` to float32 precision. One score
    per item."""
    from ..ops import stoi as _ops_stoi

    estimates = _mono_at(estimates, _ops_stoi.FS)
    references = _mono_at(references, _ops_stoi.FS)
    return _ops_stoi.stoi_batch(references.audio_data[:, 0, :], estimates.audio_data[:, 0, :],
                                extended=extended)


def pesq(estimates: AudioSignal, references: AudioSignal, mode: str = "wb",
         target_sr: float = 16000, backend: str = "auto"):
    """PESQ MOS-LQO, one score per item, from a host loop.

    ``backend``:

    - ``"auto"`` (default): the ITU ``pesq`` C extension when installed,
      else the in-package P.862-architecture implementation.
    - ``"itu"``: require the C extension (certified P.862 numbers).
    - ``"native"``: force the in-package implementation
      (:mod:`audiotools_tpu_torch.metrics._pesq`): the P.862 pipeline and
      output range with re-derived tables.

    ``target_sr`` is honored by the ITU backend (it accepts 8 or 16 kHz for
    nb); the native backend resamples to each mode's rate (nb: 8 kHz, wb:
    16 kHz).
    """
    pesq_fn = None
    if backend in ("auto", "itu"):
        try:
            from pesq import pesq as pesq_fn
        except ImportError as e:
            if backend == "itu":
                raise RuntimeError(
                    "backend='itu' requires the `pesq` C extension, which is not installed "
                    "in this environment.") from e
    elif backend != "native":
        raise ValueError(f"backend must be auto/itu/native, got {backend!r}")
    if mode not in ("nb", "wb"):
        raise ValueError(f"mode must be 'nb' or 'wb', got {mode!r}")

    if pesq_fn is None:
        from ._pesq import _MODES, pesq_native

        _warn_uncertified("pesq_native", _PESQ_NATIVE_WARNING)
        target_sr = _MODES[mode].fs

    estimates = _mono_at(estimates, target_sr)
    references = _mono_at(references, target_sr)
    scores = []
    for i in range(estimates.batch_size):
        ref_i, est_i = _host_item(references, i), _host_item(estimates, i)
        if pesq_fn is not None:
            scores.append(pesq_fn(estimates.sample_rate, ref_i, est_i, mode))
        else:
            scores.append(pesq_native(ref_i, est_i, int(estimates.sample_rate), mode))
    return _scores(scores, estimates)


def pesq_device(estimates: AudioSignal, references: AudioSignal, mode: str = "wb"):
    """Batched PESQ as one device program on the signals' device: the
    P.862-architecture pipeline of :mod:`audiotools_tpu_torch.metrics._pesq`
    (see :mod:`audiotools_tpu_torch.ops.pesq`), matching
    ``pesq(..., backend="native")`` to float32 precision for pairs whose
    delay is not negative. One MOS-LQO estimate per item."""
    from ..ops import pesq as _ops_pesq
    from ._pesq import _MODES

    _warn_uncertified("pesq_native", _PESQ_NATIVE_WARNING)
    if mode not in _MODES:
        raise ValueError(f"mode must be 'nb' or 'wb', got {mode!r}")
    target_sr = _MODES[mode].fs
    estimates = _mono_at(estimates, target_sr)
    references = _mono_at(references, target_sr)
    return _ops_pesq.pesq_batch(references.audio_data[:, 0, :], estimates.audio_data[:, 0, :],
                                mode=mode)


def visqol(estimates: AudioSignal, references: AudioSignal, mode: str = "audio",
           backend: str = "auto"):
    """ViSQOL MOS-LQO, one score per item.

    ``backend``:

    - ``"auto"`` (default): Google's C++ ViSQOL library when installed,
      else the in-package NSIM backend.
    - ``"google"``: require the C++ library (certified ViSQOL numbers).
    - ``"nsim"``: force the in-package backend
      (:mod:`audiotools_tpu_torch.ops.nsim`): ViSQOL's NSIM similarity core
      over gammatone spectrograms as one batched device program, mapped to
      ViSQOL's output range by a monotone curve instead of the (offline
      unavailable) trained models. Scores rank degradations like ViSQOL but
      are not certified MOS-LQO.
    """
    if backend not in ("auto", "google", "nsim"):
        raise ValueError(f"backend must be auto/google/nsim, got {backend!r}")
    if backend in ("auto", "google"):
        try:
            from visqol import visqol_lib_py
            from visqol.pb2 import visqol_config_pb2
        except ImportError as e:
            if backend == "google":
                raise RuntimeError(
                    "backend='google' requires google/visqol, which is not installed in this "
                    "environment.") from e
            backend = "nsim"
        else:
            backend = "google"

    if backend == "nsim":
        from ..ops import nsim as _nsim

        _warn_uncertified("visqol_nsim", _VISQOL_NSIM_WARNING)
        if mode not in _nsim.MODES:
            raise ValueError(f"Unrecognized mode: {mode}")
        target_sr = _nsim.MODES[mode]["fs"]
        estimates = _mono_at(estimates, target_sr)
        references = _mono_at(references, target_sr)
        scores = _nsim.nsim_batch(references.audio_data[:, 0, :], estimates.audio_data[:, 0, :],
                                  mode=mode)
        return _nsim.nsim_to_moslqo(scores)

    # (sample rate, speech scoring flag, bundled SVR model) per mode, as the
    # ViSQOL library configures them
    mode_settings = {
        "audio": (48000, False, "libsvm_nu_svr_model.txt"),
        "speech": (16000, True, "lattice_tcditugenmeetpackhref_ls2_nl60_lr12_bs2048_"
                                "learn.005_ep2400_train1_7_raw.tflite"),
    }
    if mode not in mode_settings:
        raise ValueError(f"Unrecognized mode: {mode}")
    target_sr, speech_scoring, svr_model = mode_settings[mode]

    config = visqol_config_pb2.VisqolConfig()
    config.audio.sample_rate = target_sr
    config.options.use_speech_scoring = speech_scoring
    config.options.svr_model_path = os.path.join(
        os.path.dirname(visqol_lib_py.__file__), "model", svr_model)
    api = visqol_lib_py.VisqolApi()
    api.Create(config)

    estimates = _mono_at(estimates, target_sr)
    references = _mono_at(references, target_sr)
    return _scores([api.Measure(_host_item(references, i), _host_item(estimates, i)).moslqo
                    for i in range(estimates.batch_size)], estimates)
