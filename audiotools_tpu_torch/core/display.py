"""Display mixin: spectrogram and waveform plots, and tensorboard logging.

Counterpart of ``audiotools_tpu/core/display.py``. The spectrogram is
computed on the signal's device; only the array drawn comes to the host.
Axis handling (time/linear/log/mel) is drawn directly with matplotlib,
which is imported where a plot is made, not with the module.
"""
import inspect
import typing
from functools import wraps

import torch

from . import util


def format_figure(func):
    """Forward figure-formatting kwargs to ``util.format_figure``."""

    @wraps(func)
    def wrapper(*args, **kwargs):
        accepted = inspect.signature(util.format_figure).parameters
        fig_kwargs = {k: kwargs.pop(k) for k in list(kwargs) if k in accepted}
        func(*args, **kwargs)
        util.format_figure(**fig_kwargs)

    return wrapper


def _specshow(data, sr, hop_length, x_axis="time", y_axis="linear", n_mels=None):
    """A minimal ``librosa.display.specshow`` on matplotlib."""
    import matplotlib.pyplot as plt

    nf, nt = data.shape
    dur = nt * hop_length / sr
    if y_axis == "mel":
        extent = [0, dur, 0, nf]
        ylabel = "Mel bin"
    else:
        extent = [0, dur, 0, sr / 2]
        ylabel = "Hz"
    ax = plt.gca()
    ax.imshow(data, origin="lower", aspect="auto", extent=extent, cmap="magma",
              interpolation="nearest")
    if y_axis == "log":
        ax.set_yscale("symlog", base=2, linthresh=64)
    ax.set_xlabel("Time (s)" if x_axis == "time" else x_axis)
    ax.set_ylabel(ylabel)


def _host(x: torch.Tensor):
    return x.detach().cpu().numpy()


class DisplayMixin:
    @format_figure
    def specshow(self, preemphasis: bool = False, x_axis: str = "time",
                 y_axis: str = "linear", n_mels: int = 128, **kwargs):
        """Display the first item's spectrogram (channels averaged), in dB
        below its peak; ``y_axis="mel"`` shows the mel spectrogram."""
        # Always re-compute the STFT data before showing it.
        signal = self.clone()
        signal.stft_data = None

        if preemphasis:
            signal.preemphasis()

        ref = signal.magnitude.max()
        log_mag = signal.log_magnitude(ref_value=float(ref))

        if y_axis == "mel":
            log_mag = 20 * torch.log10(torch.clamp(signal.mel_spectrogram(n_mels), min=1e-5))
            log_mag -= log_mag.max()

        _specshow(_host(log_mag)[0].mean(axis=0), sr=signal.sample_rate,
                  hop_length=signal.stft_params.hop_length, x_axis=x_axis, y_axis=y_axis,
                  n_mels=n_mels)

    @format_figure
    def waveplot(self, x_axis: str = "time", **kwargs):
        """Display the first item's waveform (channels averaged)."""
        import matplotlib.pyplot as plt
        import numpy as np

        audio_data = _host(self.audio_data[0]).mean(axis=0)
        t = np.arange(len(audio_data)) / self.sample_rate
        ax = plt.gca()
        ax.fill_between(t, audio_data, -audio_data, alpha=0.75)
        ax.set_xlim(0, t[-1] if len(t) else 1.0)
        ax.set_xlabel("Time (s)" if x_axis == "time" else x_axis)

    @format_figure
    def wavespec(self, x_axis: str = "time", **kwargs):
        """Waveform stacked over spectrogram, a 1:5 vertical split."""
        import matplotlib.pyplot as plt

        plt.subplot2grid((6, 1), (0, 0))
        self.waveplot(x_axis=x_axis)
        plt.subplot2grid((6, 1), (1, 0), rowspan=5)
        self.specshow(x_axis=x_axis, **kwargs)

    def _plot_to_current_figure(self, plot_fn, **kwargs):
        """Resolve ``plot_fn`` (name or callable) and draw onto a cleared
        current figure; returns the figure."""
        import matplotlib.pyplot as plt

        fig = plt.gcf()
        plt.clf()
        if isinstance(plot_fn, str):
            plot_fn = getattr(self, plot_fn)
        plot_fn(**kwargs)
        return fig

    def write_audio_to_tb(self, tag: str, writer, step: int = None,
                          plot_fn: typing.Union[typing.Callable, str] = "specshow", **kwargs):
        """Write the first item's first channel, and a plot of it, to a
        tensorboard ``SummaryWriter``."""
        writer.add_audio(tag, self.audio_data[0, 0].detach().cpu(), step, self.sample_rate)
        if plot_fn is not None:
            fig = self._plot_to_current_figure(plot_fn, **kwargs)
            writer.add_figure(tag.replace("wav", "png"), fig, step)

    def save_image(self, image_path: str,
                   plot_fn: typing.Union[typing.Callable, str] = "specshow", **kwargs):
        """Save a plot of the signal to a file."""
        import matplotlib.pyplot as plt

        self._plot_to_current_figure(plot_fn, **kwargs)
        plt.savefig(image_path, bbox_inches="tight", pad_inches=0)
        plt.close()
