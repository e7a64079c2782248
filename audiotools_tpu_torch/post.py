"""Notebook/HTML output helpers: audio tables with embedded players,
notebook detection, generic display.

Counterpart of ``audiotools_tpu/post.py``. Markdown tables are rendered to
HTML with a small converter of their own (no ``markdown2``); IPython and
matplotlib are imported where they are used.
"""
import typing


def _markdown_table_to_html(table_md: str) -> str:
    """Minimal markdown-table -> HTML conversion (replaces markdown2)."""
    lines = [l for l in table_md.strip().split("\n") if l.strip()]
    if not lines:
        return ""
    rows = []
    for i, line in enumerate(lines):
        cells = [c.strip() for c in line.strip().strip("|").split(" | ")]
        if i == 1 and all(set(c) <= set(":- ") for c in cells):
            continue  # separator row
        tag = "th" if i == 0 else "td"
        rows.append(
            "<tr>" + "".join(f"<{tag}>{c}</{tag}>" for c in cells) + "</tr>"
        )
    return "<table>" + "".join(rows) + "</table>"


def _render_cell(label: str, value, signal_cls, **embed_kwargs) -> str:
    """Default cell renderer: players for signals, ``.`` for missing
    entries, plain ``str`` for everything else (a tensor or an array as
    its list, wherever it lies)."""
    import torch

    if value is None:
        return "."
    if isinstance(value, signal_cls):
        return value.embed(display=False, return_html=True, **embed_kwargs)
    if isinstance(value, torch.Tensor):
        value = value.detach().cpu()
    if hasattr(value, "dtype") and hasattr(value, "tolist"):
        value = value.tolist()
    return str(value)


def audio_table(
    audio_dict: dict,
    first_column: str = None,
    format_fn: typing.Callable = None,
    **kwargs,
):
    """Markdown table of embedded audio players: one row per key, columns fixed by the
    first row's sub-dict keys; bare (non-dict) values become a single
    ``Audio`` column.

    >>> audio_dict = {i: {"input": in_sig[i], "output": out_sig[i]}
    ...               for i in range(batch)}
    >>> post.audio_table(audio_dict)
    """
    from . import AudioSignal

    if format_fn is None:
        def format_fn(label, x, **kw):
            return _render_cell(label, x, AudioSignal, **kw)

    # normalize every row to a column->value mapping
    rows = {
        key: (val if isinstance(val, dict) else {"Audio": val})
        for key, val in audio_dict.items()
    }
    if not rows:
        return "\n"

    header = list(next(iter(rows.values())).keys())
    lines = [
        " | ".join([first_column if first_column is not None else "."] + header),
        "|---" + "|:-:" * len(header),
    ]
    for key, cells in rows.items():
        rendered = (format_fn(col, cells[col], **kwargs) for col in header)
        lines.append(f"| {key} | " + " | ".join(rendered))
    return "\n" + "\n".join(lines)


def in_notebook():
    """Whether code is running in a notebook."""
    try:
        from IPython import get_ipython
    except ImportError:
        return False
    shell = get_ipython()
    try:
        return shell is not None and "IPKernelApp" in shell.config
    except AttributeError:
        return False


def disp(obj, **kwargs):
    """Display an object appropriately for notebook/terminal: signals
    embed a player, dicts become an audio table, figures show."""
    import matplotlib.pyplot as plt

    from . import AudioSignal

    notebook = in_notebook()

    def _as_html(markup):
        if not notebook:
            print(markup)
            return None
        from IPython.display import HTML

        return HTML(markup)

    if isinstance(obj, AudioSignal):
        return _as_html(obj.embed(display=False, return_html=True))
    if isinstance(obj, dict):
        table = audio_table(obj, **kwargs)
        if notebook:
            return _as_html(_markdown_table_to_html(table))
        print(table)
        return None
    if isinstance(obj, plt.Figure):
        plt.show()
