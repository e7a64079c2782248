"""Compact codec artifacts: compress a signal to stored integer codes and
back (the user-facing counterpart of ``DAC.encode`` and
``decode_from_codes``).

Counterpart of ``audiotools_tpu/models/artifacts.py``. The artifact is the
same numpy dict (``uint16`` codes and the metadata needed to invert them)
written by ``np.savez_compressed``, so a file written by either package
loads in the other. The codec runs on the model's device, under
``torch.no_grad`` in full fp32 (``strict_fp32``).

>>> art = compress(model, signal)
>>> save_artifact("clip.dacz", art)
>>> recon = decompress(model, load_artifact("clip.dacz"))
"""
import numpy as np
import torch

from ..core import AudioSignal
from ..ops._fp32 import strict_fp32

__all__ = ["compress", "decompress", "save_artifact", "load_artifact"]


def compress(model, signal, n_quantizers: int = None, streaming: bool = False,
             chunk_frames: int = 128) -> dict:
    """Encode an :class:`AudioSignal` (or a ``(B, 1, T)`` tensor or array)
    into a compact artifact dict: uint16 codes and the metadata needed to
    invert them.

    A signal is resampled to the model's rate if needed and mixed down to
    mono. Codes are ``(B, n_q, T_codes)`` with ``T_codes = ceil(T /
    hop_length)``. ``streaming=True`` encodes through fixed-length
    overlap-save windows (``models/streaming.py``): the same codes with
    O(``chunk_frames``) device memory, for inputs too long to encode in one
    pass.
    """
    if isinstance(signal, AudioSignal):
        sig = signal.clone()
        if sig.sample_rate != model.sample_rate:
            sig = sig.resample(model.sample_rate)
        audio = sig.audio_data
        if audio.shape[1] > 1:
            audio = audio.mean(dim=1, keepdim=True)
    else:
        audio = signal if isinstance(signal, torch.Tensor) else torch.from_numpy(np.asarray(signal))
    audio = audio.to(device=model.device, dtype=torch.float32)

    if model.codebook_size > 65536:
        raise ValueError(
            f"codebook_size {model.codebook_size} does not fit in the uint16 artifact format")
    n_samples = int(audio.shape[-1])
    if streaming:
        from .streaming import stream_encode

        codes = stream_encode(model, audio, chunk_frames=chunk_frames, n_quantizers=n_quantizers)
    else:
        with torch.no_grad(), strict_fp32():
            _, codes = model.encode(audio, n_quantizers)
    return {
        "codes": codes.cpu().numpy().astype(np.uint16),
        "sample_rate": int(model.sample_rate),
        "n_samples": n_samples,
        "n_codebooks": int(codes.shape[1]),
        "codebook_size": int(model.codebook_size),
    }


def decompress(model, artifact: dict, streaming: bool = False,
               chunk_frames: int = 128) -> AudioSignal:
    """Invert :func:`compress`: artifact codes -> :class:`AudioSignal` on
    the model's device, trimmed to the original sample count.
    ``streaming=True`` decodes through fixed-length windows (the same
    audio, bounded memory)."""
    if int(model.sample_rate) != int(artifact["sample_rate"]):
        raise ValueError(
            f"artifact was produced at {artifact['sample_rate']} Hz, "
            f"model runs at {model.sample_rate} Hz")
    # Model-mismatch and range guards, on the host before any decode: on the
    # card an out-of-range index is a device-side assert, not a clean error,
    # and decode_from_codes drops extra cascade stages, which would decode to
    # silently wrong audio.
    if int(artifact.get("codebook_size", model.codebook_size)) != int(model.codebook_size):
        raise ValueError(
            f"artifact codebook_size {artifact['codebook_size']} != model "
            f"codebook_size {model.codebook_size}")
    n_q = int(np.asarray(artifact["codes"]).shape[1])
    if n_q > int(model.n_codebooks):
        raise ValueError(
            f"artifact has {n_q} codebook stages, model has only {model.n_codebooks}")
    codes = np.asarray(artifact["codes"]).astype(np.int64)
    if codes.size and (codes.min() < 0 or codes.max() >= int(model.codebook_size)):
        raise ValueError(
            f"artifact codes span [{codes.min()}, {codes.max()}], outside the model's "
            f"{model.codebook_size} codewords")
    codes = torch.from_numpy(codes).to(model.device)
    if streaming:
        from .streaming import stream_decode

        wav = stream_decode(model, codes, chunk_frames=chunk_frames)
    else:
        with torch.no_grad(), strict_fp32():
            wav = model.decode_from_codes(codes)
    wav = wav[..., : int(artifact["n_samples"])]
    return AudioSignal(wav, int(artifact["sample_rate"]))


def save_artifact(path: str, artifact: dict) -> str:
    """Persist an artifact with ``np.savez_compressed``."""
    np.savez_compressed(path, **artifact)
    return path


def load_artifact(path: str) -> dict:
    """Load an artifact saved by :func:`save_artifact` (by either package)."""
    with np.load(path) as z:
        return {k: (z[k] if z[k].ndim else z[k].item()) for k in z.files}
