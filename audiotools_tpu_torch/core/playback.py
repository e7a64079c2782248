"""Playback mixin: notebook embeds, an HTML/JS player widget, and local
playback.

Counterpart of ``audiotools_tpu/core/playback.py``, with its own copy of
``templates/`` (headers.html + widget.html): play/pause,
spectrogram-synced cursor + played-region shading, click/drag-to-seek,
animated levels bars, download; see the feature checklist in
widget.html. IPython and matplotlib are imported where they are used; a
signal on the card comes to the host only to be written and drawn.
"""
import base64
import io
import secrets
import shutil
import subprocess
from pathlib import Path
from tempfile import NamedTemporaryFile

from .util import _close_temp_files

_TEMPLATES = Path(__file__).parent / "templates"

DEFAULT_EXTENSION = ".wav"


def _require_ipython():
    try:
        import IPython.display as ipython_display
    except ImportError:
        raise ImportError("embed/play requires IPython, which is not installed")
    return ipython_display


def _fill_template(name: str, **slots) -> str:
    """Load ``templates/<name>`` and substitute its ALL-CAPS placeholders."""
    html = (_TEMPLATES / name).read_text()
    for placeholder, value in slots.items():
        html = html.replace(placeholder, str(value))
    return html


def _current_figure_png_uri() -> str:
    """Serialize (and close) the current matplotlib figure as a data URI."""
    import matplotlib.pyplot as plt

    buf = io.BytesIO()
    plt.savefig(buf, bbox_inches="tight", pad_inches=0)
    plt.close()
    payload = base64.b64encode(buf.getvalue()).decode("ascii")
    return f"data:image/png;base64,{payload}"


class PlayMixin:
    def _ipython_audio_element(self, ipython_display):
        """Write self to a temporary wav and wrap it in an IPython Audio
        element (which inlines the data as a base64 URI)."""
        tmpfiles = []
        with _close_temp_files(tmpfiles):
            handle = NamedTemporaryFile(mode="w+", suffix=".wav", delete=False)
            tmpfiles.append(handle)
            self.write(handle.name)
            return ipython_display.Audio(data=handle.name, rate=self.sample_rate)

    def embed(self, ext: str = None, display: bool = True, return_html: bool = False):
        """Embed audio as a playable element in a notebook. ``ext`` is kept
        for the original library's signature; the embedded payload is
        always wav."""
        ipython_display = _require_ipython()
        element = self._ipython_audio_element(ipython_display)
        if display:
            ipython_display.display(element)
        if return_html:
            return f"<audio controls src='{element.src_attr()}'></audio>"
        return element

    def widget(
        self, title: str = None, ext: str = ".wav", add_headers: bool = True,
        player_width: str = "100%", margin: str = "10px",
        plot_fn: str = "specshow", return_html: bool = False, **kwargs,
    ):
        """Playable widget: spectrogram stage with synced cursor and
        click/drag seeking, play/pause + animated levels bars + download.

        ``add_headers`` emits the shared CSS/JS once; later widgets on the
        same page reuse it."""
        import matplotlib.pyplot as plt

        ipython_display = _require_ipython()

        if isinstance(plot_fn, str):
            kwargs["title"] = title
            plot_fn = getattr(self, plot_fn)

        # stage image; its pixel size fixes the widget box
        plot_fn(**kwargs)
        fig = plt.gcf()
        width_px, height_px = (fig.get_size_inches() * fig.dpi).astype(int)
        stage_uri = _current_figure_png_uri()

        # wide short spectrogram whose columns the header JS samples into
        # the animated levels bars
        from . import util as _util

        self.specshow()
        _util.format_figure((12, 1.5))
        levels_uri = _current_figure_png_uri()

        parts = []
        if add_headers:
            parts.append(
                _fill_template(
                    "headers.html", PLAYER_WIDTH=player_width, MARGIN=margin
                )
            )
        audio_element = self.embed(ext=ext, display=False)
        parts.append(
            _fill_template(
                "widget.html",
                PLAYER_ID=f"at{secrets.token_hex(6)}",
                AUDIO_SRC=audio_element.src_attr(),
                IMAGE_SRC=stage_uri,
                LEVELS_SRC=levels_uri,
                PADDING_AMOUNT=f"{height_px}px",
                MAX_WIDTH=f"{width_px}px",
            )
        )
        for part in parts:
            ipython_display.display(ipython_display.HTML(part))

        if return_html:
            return "".join(parts)

    def play(self):
        """Play audio locally via ffplay or aplay, whichever is on PATH."""
        tmpfiles = []
        with _close_temp_files(tmpfiles):
            tmp_wav = NamedTemporaryFile(suffix=".wav", delete=False)
            tmpfiles.append(tmp_wav)
            self.write(tmp_wav.name)
            print(self)
            player = None
            for cand, args in (
                ("ffplay", ["-nodisp", "-autoexit", "-hide_banner", "-loglevel", "error"]),
                ("aplay", []),
            ):
                if shutil.which(cand):
                    player = [cand] + args
                    break
            if player is None:
                raise RuntimeError(
                    "No audio player found (need ffplay or aplay on PATH)."
                )
            subprocess.call(player + [tmp_wav.name])
        return self
