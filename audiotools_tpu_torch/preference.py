"""Preference-test harness: MUSHRA / ABX listening tests.

Counterpart of ``audiotools_tpu/preference.py``. The session-state
machinery (``Samples``: shuffling, per-user completed filtering,
progress), result CSVs (``save_result``), and the slider/progress HTML
are framework-free and testable. The interactive app surface uses gradio,
imported where it is used (``_require_gradio``); the UI player is an
HTML5-audio implementation with region looping.
"""
import copy
import csv
import random
import traceback
from collections import defaultdict
from pathlib import Path
from typing import List

from .core.util import find_audio


def _require_gradio():
    try:
        import gradio as gr

        return gr
    except ImportError as e:  # pragma: no cover
        raise RuntimeError(
            "preference-test apps require `gradio`, which is not installed. "
            "The Samples/save_result state machinery works without it."
        ) from e


# ---------------------------------------------------------------------------
# Player CSS / JS (original implementation on HTML5 audio)
# ---------------------------------------------------------------------------

CUSTOM_CSS = """
.gradio-container {
    max-width: 840px !important;
}
#at-progress .progress { background-color: #00AAFF; }
block { min-width: 0 !important; }
"""

PLAYER_HTML = """<div id="at-player">
  <canvas id="at-wave" width="800" height="96" style="width:100%;height:96px;background:#0a2a3a;border-radius:4px;"></canvas>
  <div id="at-region-label" style="font-family:sans-serif;font-size:12px;color:#888;">
    drag on the waveform to select a loop region
  </div>
</div>"""

player_js = """
function at_setup_player() {
  const canvas = document.getElementById("at-wave");
  if (!canvas || canvas.dataset.ready) return;
  canvas.dataset.ready = "1";
  window.at_region = null;
  let dragging = false, start = 0;

  function draw(frac0, frac1) {
    const ctx = canvas.getContext("2d");
    ctx.clearRect(0, 0, canvas.width, canvas.height);
    ctx.fillStyle = "#0a2a3a";
    ctx.fillRect(0, 0, canvas.width, canvas.height);
    if (frac0 != null) {
      ctx.fillStyle = "rgba(0,170,255,0.45)";
      const x0 = Math.min(frac0, frac1) * canvas.width;
      const w = Math.abs(frac1 - frac0) * canvas.width;
      ctx.fillRect(x0, 0, w, canvas.height);
    }
  }
  draw(null, null);

  canvas.addEventListener("mousedown", (e) => {
    const rect = canvas.getBoundingClientRect();
    start = (e.clientX - rect.left) / rect.width;
    dragging = true;
  });
  canvas.addEventListener("mousemove", (e) => {
    if (!dragging) return;
    const rect = canvas.getBoundingClientRect();
    const cur = (e.clientX - rect.left) / rect.width;
    draw(start, cur);
  });
  window.addEventListener("mouseup", (e) => {
    if (!dragging) return;
    dragging = false;
    const rect = canvas.getBoundingClientRect();
    const end = (e.clientX - rect.left) / rect.width;
    window.at_region = [Math.min(start, end), Math.max(start, end)];
    draw(window.at_region[0], window.at_region[1]);
  });
  window.at_clear_region = function () {
    window.at_region = null;
    draw(null, null);
  };
  // loop-region playback
  setInterval(function () {
    const loopBtn = document.getElementById("loop-button");
    const looping = loopBtn && loopBtn.textContent.includes("ON");
    const audios = document.getElementsByTagName("audio");
    for (const a of audios) {
      if (!a.paused && window.at_region) {
        const t0 = window.at_region[0] * a.duration;
        const t1 = window.at_region[1] * a.duration;
        if (a.currentTime > t1) {
          if (looping) a.currentTime = t0;
          else a.pause();
        }
      }
    }
  }, 60);
}
"""

play = (
    lambda i: """
function at_play() {
  const audios = Array.from(document.getElementsByTagName("audio"));
  const me = audios[%d];
  for (let j = 0; j < audios.length; j++) {
    if (j != %d) { audios[j].pause(); audios[j].currentTime = 0; }
  }
  if (me.paused) {
    if (window.at_region && me.duration) {
      me.currentTime = window.at_region[0] * me.duration;
    }
    me.play();
  } else {
    me.pause();
  }
}
"""
    % (i, i)
)

clear_regions = """
function at_clear() { if (window.at_clear_region) window.at_clear_region(); }
"""

reset_player = """
function at_reset() {
  const audios = Array.from(document.getElementsByTagName("audio"));
  for (const a of audios) { a.pause(); a.currentTime = 0; }
  if (window.at_clear_region) window.at_clear_region();
}
"""

loop_region = """
function at_loop() {
  const el = document.getElementById("loop-button");
  if (el.textContent.includes("OFF")) {
    el.textContent = "Looping ON";
  } else {
    el.textContent = "Looping OFF";
  }
}
"""


class Player:
    """Audio player panel for preference apps. Requires gradio."""

    def __init__(self, app):
        self.app = app
        gr = _require_gradio()

        self.app.load(_js=player_js + "\nat_setup_player")
        self.app.css = CUSTOM_CSS

        self.wavs = []
        self.position = 0

    def create(self):
        gr = _require_gradio()

        gr.HTML(PLAYER_HTML)
        gr.Markdown(
            "Drag on the waveform above to select a region to loop. "
            "Clear it with the button below. Hit play on one of the "
            "buttons below to start!"
        )
        with gr.Row():
            clear = gr.Button("Clear region")
            loop = gr.Button("Looping OFF", elem_id="loop-button")

            loop.click(None, _js=loop_region)
            clear.click(None, _js=clear_regions)

    def add(self, name: str = "Play"):
        gr = _require_gradio()
        i = self.position
        self.position += 1
        with gr.Column():
            button = gr.Button(name, elem_classes="playpause")
            wav = gr.Audio(visible=False, elem_id=f"audio-{i}")
            button.click(None, _js=play(i))
        self.wavs.append({"audio": wav, "button": button})
        return wav, button

    def to_list(self):
        return [x["audio"] for x in self.wavs]


# ---------------------------------------------------------------------------
# user tracking + progress bar
# ---------------------------------------------------------------------------

def load_tracker(cookie):
    """JS snippet returning a stable per-browser id stored under
    ``cookie`` (created on first visit, 30-day expiry)."""
    return (
        """
function load_name() {
    var store = document.cookie;
    var match = store.match(new RegExp("(?:^|; )__COOKIE__=([^;]*)"));
    if (match) { return match[1]; }
    var fresh = Math.random().toString(36).slice(2);
    var expiry = new Date(Date.now() + 30 * 864e5).toGMTString();
    document.cookie =
        "__COOKIE__=" + fresh + ";expires=" + expiry + ";path=/";
    return fresh;
}
"""
    ).replace("__COOKIE__", cookie)


progress_template = """
<!DOCTYPE html>
<html>
  <head>
    <style>
      .at-meter { background: #ddd; border-radius: 4px;
                  height: 30px; width: 100%; position: relative; }
      .at-meter-fill { background: #00AAFF; border-radius: 4px;
                       height: 100%; width: {PROGRESS}%; }
      .at-meter-label { position: absolute; top: 50%; left: 50%;
                        transform: translate(-50%, -50%);
                        font: bold 18px Arial, sans-serif;
                        color: #333 !important; text-shadow: 1px 1px #fff; }
    </style>
  </head>
  <body>
    <div class="at-meter">
      <div class="at-meter-fill"></div>
      <span class="at-meter-label">{TEXT}</span>
    </div>
  </body>
</html>
"""


def create_tracker(app, cookie_name="name"):
    """Hidden text field holding the per-user cookie id."""
    gr = _require_gradio()
    user = gr.Text(label="user", interactive=True, visible=False, elem_id="user")
    app.load(_js=load_tracker(cookie_name), outputs=user)
    return user


# ---------------------------------------------------------------------------
# slider labels
# ---------------------------------------------------------------------------


def _labels_html(labels_and_colors, height=40, font=16):
    cells = "\n".join(
        f'      <div class="label" style="background-color: {color};">{text}</div>'
        for text, color in labels_and_colors
    )
    width = 100 // len(labels_and_colors)
    return f"""
<!DOCTYPE html>
<html>
  <head>
    <meta charset="UTF-8">
    <style>
      body {{ margin: 0; padding: 0; }}
      .labels-container {{
        display: flex; justify-content: space-between; align-items: center;
        width: 100%; height: {height}px; padding: 0px 12px 0px;
      }}
      .label {{
        display: flex; justify-content: center; align-items: center;
        width: {width}%; height: 100%;
        font: 700 {font}px Arial, sans-serif; text-transform: uppercase;
        letter-spacing: 1px; padding: 10px; color: #333 !important;
      }}
    </style>
  </head>
  <body>
    <div class="labels-container">
{cells}
    </div>
  </body>
</html>
"""


slider_abx = _labels_html(
    [("Prefer A", "#00AAFF"), ("Toss-up", "#f97316"), ("Prefer B", "#00AAFF")]
)

slider_mushra = _labels_html(
    [
        ("bad", "#ff5555"),
        ("poor", "#ffa500"),
        ("fair", "#ffd700"),
        ("good", "#97d997"),
        ("excellent", "#04c822"),
    ],
    height=30,
    font=13,
)


# ---------------------------------------------------------------------------
# session state
# ---------------------------------------------------------------------------


def _ui_update(**kwargs):
    """``gr.update(...)`` when gradio is importable, a plain dict otherwise,
    so the session state machine stays testable without the UI library."""
    try:
        import gradio as gr

        return gr.update(**kwargs)
    except ImportError:
        return dict(kwargs)


class Samples:
    """Listening-test session state over a ``folder/<condition>/<name>.wav``
    tree.

    A "sample" is one file name appearing under several condition
    subfolders.  The object walks the test in a (optionally shuffled)
    name order, hands the UI per-condition file updates, renders an HTML
    progress bar, and can drop samples a given user has already rated.
    """

    def __init__(self, folder: str, shuffle: bool = True, n_samples: int = None):
        # Invert the on-disk layout: name -> {condition -> path}.
        by_name = defaultdict(dict)
        for path in find_audio(folder):
            by_name[path.name][path.parent.stem] = path
        self.samples = by_name

        self.names = list(by_name)
        if shuffle:
            random.shuffle(self.names)
        self.n_samples = n_samples if n_samples is not None else len(self.names)

        self.current = 0  # how many samples this session has served
        self.order = []  # condition presentation order of the last serve
        self.filtered = False

    def __len__(self):
        return self.n_samples

    def get_updates(self, idx, order):
        """UI updates pointing each player at sample ``idx``'s file for the
        corresponding condition in ``order``."""
        conditions = self.samples[self.names[idx]]
        return [_ui_update(value=str(conditions[c])) for c in order]

    def progress(self):
        """HTML progress bar reflecting ``current`` out of ``len(self)``."""
        total = len(self)
        pct = self.current / total * 100 if total else 100
        html = copy.copy(progress_template)
        html = html.replace("{PROGRESS}", str(pct))
        html = html.replace("{TEXT}", f"On {self.current} / {total} samples")
        return _ui_update(value=html)

    def filter_completed(self, user, save_path):
        """Drop samples ``user`` already rated in the results CSV, then cap
        at ``n_samples``. Runs at most once per session."""
        if self.filtered:
            return
        rated = set()
        if Path(save_path).exists():
            with open(save_path, "r") as f:
                for row in csv.DictReader(f):
                    if row["user"] == user:
                        rated.add(row["sample"])
        remaining = [name for name in self.names if name not in rated]
        self.names = remaining[: self.n_samples]
        self.filtered = True

    def get_next_sample(self, reference: str, conditions: List[str]):
        """Serve the next sample: shuffled condition order (reference pinned
        first), player updates, submit-button state, progress bar."""
        random.shuffle(conditions)
        self.order = conditions if reference is None else [reference] + conditions

        try:
            updates = self.get_updates(self.current, self.order)
        except Exception:
            # Out of samples (or a condition folder is missing a file):
            # freeze the submit button and park the session at the end.
            traceback.print_exc()
            self.current = len(self)
            return (
                [_ui_update() for _ in self.order],
                _ui_update(value="No more samples!", interactive=False),
                self.progress(),
            )

        self.current += 1
        return updates, _ui_update(interactive=True), self.progress()


def save_result(result: dict, save_path: str):
    """Append one test result to a CSV."""
    with open(save_path, mode="a", newline="") as file:
        writer = csv.DictWriter(file, fieldnames=sorted(list(result.keys())))
        if file.tell() == 0:
            writer.writeheader()
        writer.writerow(result)
