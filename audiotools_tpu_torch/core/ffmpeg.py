"""FFMPEG mixin: r128 loudness, resampling and container decoding.

Counterpart of ``audiotools_tpu/core/ffmpeg.py``. Where the ``ffmpeg``
binary is on PATH it is used as in the original library; where it is
not, each entry point takes the package's own route on the signal's
device: the BS.1770 meter for r128 loudness, the polyphase resampler, and
the host decoders of ``io.load_audio``.
"""
import json
import shlex
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Tuple

import numpy as np
import torch

from . import util


def ffmpeg_available() -> bool:
    return shutil.which("ffmpeg") is not None


def r128stats(filepath: str, quiet: bool = True, device=None):
    """EBU R128 stats of a file.

    Uses the ffmpeg ``ebur128`` filter when available, otherwise the
    BS.1770 meter on ``device`` (the card by default): integrated loudness,
    with LRA and the thresholds set to the integrated-derived defaults.
    """
    if ffmpeg_available():
        ffargs = ["ffmpeg", "-nostats", "-i", str(filepath), "-filter_complex", "ebur128",
                  "-f", "null", "-"]
        proc = subprocess.Popen(ffargs, stderr=subprocess.PIPE, universal_newlines=True)
        # the filter prints its Summary block on stderr; fields follow
        # their tags ("I:" is trailed by value, unit, "Threshold:", value)
        summary = proc.communicate()[1]
        tokens = summary[summary.rfind("Summary:"):].split()

        def field(tag, skip=1):
            return float(tokens[tokens.index(tag) + skip])

        return {
            "I": field("I:"),
            "I Threshold": field("I:", skip=4),
            "LRA": field("LRA:"),
            "LRA Threshold": field("LRA:", skip=4),
            "LRA Low": field("low:"),
            "LRA High": field("high:"),
        }

    from ..io import load_audio
    from ..ops.loudness import integrated_loudness

    data, sr = load_audio(filepath)
    x = torch.from_numpy(np.ascontiguousarray(data.T)[None]).to(device or util.default_device())
    lufs = float(integrated_loudness(x, sr)[0])
    return {
        "I": lufs,
        "I Threshold": lufs - 10.0,
        "LRA": 0.0,
        "LRA Threshold": lufs - 20.0,
        "LRA Low": lufs,
        "LRA High": lufs,
    }


def ffprobe_offset_and_codec(path: str) -> Tuple[float, str]:
    """Start offset and codec of the first audio stream; ``(0.0,
    "pcm_s16le")`` where ``ffprobe`` is absent."""
    if shutil.which("ffprobe") is None:
        return 0.0, "pcm_s16le"
    ff = subprocess.run(["ffprobe", "-show_streams", "-select_streams", "a", "-of", "json",
                         str(path)], capture_output=True, text=True)
    streams = json.loads(ff.stdout)["streams"]
    seconds_offset = 0.0
    codec = None
    for stream in streams:
        seconds_offset = stream.get("start_time", 0.0)
        codec = stream.get("codec_name")
    return float(seconds_offset), codec


class FFMPEGMixin:
    _loudness = None

    def ffmpeg_loudness(self, quiet: bool = True):
        """Integrated loudness of each item through the r128 path (the item
        written as a 16-bit WAV and metered on the signal's device), cached
        as the signal's loudness."""
        with tempfile.NamedTemporaryFile(suffix=".wav") as f:

            def integrated(i):
                self[i].write(f.name)
                return r128stats(f.name, quiet=quiet, device=self.device)["I"]

            per_item = [integrated(i) for i in range(self.batch_size)]

        self._loudness = torch.tensor(per_item, dtype=torch.float32, device=self.device)
        return self.loudness()

    def ffmpeg_resample(self, sample_rate: int, quiet: bool = True):
        """Resample through ffmpeg when present, else the polyphase
        resampler on the signal's device."""
        if sample_rate == self.sample_rate:
            return self

        if ffmpeg_available():
            from .signal import AudioSignal

            with tempfile.NamedTemporaryFile(suffix=".wav") as f:
                self.write(f.name)
                f_out = f.name.replace("wav", "rs.wav")
                command = f"ffmpeg -i {f.name} -ar {sample_rate} {f_out} -hide_banner"
                if quiet:
                    command += " -loglevel error"
                subprocess.check_call(shlex.split(command))
                resampled = AudioSignal(f_out, device=self.device)
                Path.unlink(Path(f_out))
            self.audio_data = resampled.audio_data
            self.sample_rate = resampled.sample_rate
            return self

        return self.resample(sample_rate)

    @classmethod
    def load_from_file_with_ffmpeg(cls, audio_path: str, quiet: bool = True, **kwargs):
        """Decode any container through ffmpeg when present (padding a
        stream that starts late by its offset), else through the host
        decoders of ``io.load_audio``; ``kwargs`` (``device``, ...) go to
        the constructor."""
        if not ffmpeg_available():
            return cls(audio_path, **kwargs)

        audio_path = str(audio_path)
        with tempfile.TemporaryDirectory() as d:
            wav_file = str(Path(d) / "extracted.wav")
            padded_wav = str(Path(d) / "padded.wav")

            global_options = "-y"
            if quiet:
                global_options += " -loglevel error"

            subprocess.check_call(["ffmpeg"] + shlex.split(global_options)
                                  + ["-i", audio_path, wav_file])

            # provide compatibility with streams that start at non-zero
            seconds_offset, codec = ffprobe_offset_and_codec(audio_path)

            # Don't pad files with discrepancies less than 0.027 s: it is
            # likely due to codec latency
            if seconds_offset < 0.027:
                seconds_offset = 0.0

            pad = seconds_offset
            subprocess.check_call(
                ["ffmpeg"] + shlex.split(global_options)
                + ["-i", wav_file, "-af", f"adelay={int(pad * 1000)}|{int(pad * 1000)}",
                   padded_wav]
            )
            signal = cls(padded_wav, **kwargs)

        return signal
