"""Training-loop decorators: ``Tracker``, ``when``, ``timer`` and ``Mean``.

Counterpart of ``audiotools_tpu/ml/decorators.py``. The metrics of a step
are scalars of any kind (Python numbers, one-element numpy arrays, or
one-element tensors on any device); with more than one process in
``torch.distributed``'s group they are averaged over the processes with
``all_reduce``, as the original library's DDP tracker averages them.

The display is ``rich`` where it is installed (a live dashboard of tables
and progress bars) and plain text lines otherwise; ``rich`` is imported by
the display only, and the metrics, history and state are the same either
way.
"""
import contextlib
import math
import sys
import time
from collections import defaultdict
from functools import wraps

import numpy as np
import torch


def _to_scalar(v):
    """A Python float from a Python number, a one-element numpy array or a
    one-element tensor (any device); None otherwise."""
    if isinstance(v, (int, float)):
        return float(v)
    if isinstance(v, np.ndarray) and v.size == 1:
        return float(v.reshape(()))
    if isinstance(v, torch.Tensor) and v.numel() == 1:
        return float(v.detach().reshape(()).item())
    return None


def _has_rich() -> bool:
    try:
        import rich  # noqa: F401
    except ImportError:
        return False
    return True


def _world_size() -> int:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def _average_over_processes(scalars: dict) -> dict:
    """Each scalar averaged over ``torch.distributed``'s default group (the
    same keys on every process): one ``all_reduce`` of their sum, on the card
    under NCCL and on the host otherwise."""
    import torch.distributed as dist

    keys = sorted(scalars)
    device = torch.device("cuda", torch.cuda.current_device()) \
        if dist.get_backend() == "nccl" else torch.device("cpu")
    vals = torch.tensor([scalars[k] for k in keys], dtype=torch.float64, device=device)
    dist.all_reduce(vals, op=dist.ReduceOp.SUM)
    return dict(zip(keys, (vals / dist.get_world_size()).tolist()))


class Mean:
    """Streaming average over finite samples: non-finite updates are
    dropped, an empty accumulator reads 0."""

    __slots__ = ("total", "count")

    def __init__(self):
        self.total = 0.0
        self.count = 0

    def update(self, val):
        if not math.isfinite(val):
            return
        self.total += val
        self.count += 1

    def reset(self):
        self.total = 0.0
        self.count = 0

    def __call__(self):
        return self.total / self.count if self.count else 0.0


def when(condition):
    """Gate the decorated function on ``condition()``; when false, the call
    is a no-op returning None.

    >>> @when(lambda: step % 100 == 0 and rank == 0)
    >>> def checkpoint(): ...
    """

    def decorator(fn):
        @wraps(fn)
        def gated(*args, **kwargs):
            return fn(*args, **kwargs) if condition() else None

        return gated

    return decorator


def timer(prefix: str = "time"):
    """Stamp the decorated function's wall-clock duration into the dict it
    returns, keyed ``[prefix]/[fn_name]``."""

    def decorator(fn):
        key = f"{prefix}/{fn.__name__}"

        @wraps(fn)
        def timed(*args, **kwargs):
            start = time.perf_counter()
            output = fn(*args, **kwargs)
            if not isinstance(output, dict):
                raise TypeError(
                    f"@timer() needs {fn.__name__} to return a dict, "
                    f"got {type(output).__name__}"
                )
            output[key] = time.perf_counter() - start
            return output

        return timed

    return decorator


class Tracker:
    """Training progress and metric tracker: running means, a history of
    logged values, an optional log file and TensorBoard scalars, and a live
    display on rank 0 (``rich`` where installed, else plain text lines to the
    terminal and the log file)."""

    def __init__(
        self, writer=None, log_file: str = None, rank: int = 0,
        console_width: int = 100, step: int = 0,
    ):
        self.writer = writer
        self.rank = rank
        self.step = step
        self.metrics = {}
        self.history = {}
        self.tasks = {}
        self._log_handle = open(log_file, "a") if log_file is not None else None
        self.rich = _has_rich()
        if self.rich:
            from rich.console import Console
            from rich.live import Live

            self.pbar = self._build_progress_bar()
            self.consoles = [Console(width=console_width)]
            if self._log_handle is not None:
                self.consoles.append(Console(width=console_width, file=self._log_handle))
            self.live = Live(console=self.consoles[0], refresh_per_second=10)
        else:
            self.pbar = None
            self.consoles = []
            self.live = contextlib.nullcontext()

    @staticmethod
    def _build_progress_bar():
        from rich.progress import (
            BarColumn,
            Progress,
            SpinnerColumn,
            TimeElapsedColumn,
            TimeRemainingColumn,
        )

        columns = [
            SpinnerColumn(),
            "[progress.description]{task.description}",
            BarColumn(),
            "[progress.percentage]{task.percentage:>3.0f}%",
            "({task.completed} of {task.total})",
            TimeElapsedColumn(),
            TimeRemainingColumn(),
        ]
        return Progress(*columns)

    def close(self):
        """Flush and close the log file (idempotent). ``Tracker`` is also a
        context manager: ``with Tracker(log_file=...) as t: ...`` closes on
        exit."""
        if self._log_handle is not None and not self._log_handle.closed:
            self._log_handle.flush()
            self._log_handle.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _write_plain(self, text: str):
        """Plain-text display: ``text`` to the terminal and the log file."""
        stamp = time.strftime("[%H:%M:%S]")
        lines = [f"{stamp} {line}" for line in str(text).splitlines()] or [stamp]
        out = "\n".join(lines) + "\n"
        sys.stdout.write(out)
        sys.stdout.flush()
        if self._log_handle is not None and not self._log_handle.closed:
            self._log_handle.write(out)
            self._log_handle.flush()

    def print(self, msg):
        """Print to the terminal and the log file, on rank 0 only."""
        if self.rank != 0:
            return
        if not self.rich:
            self._write_plain(msg)
            return
        for console in self.consoles:
            console.log(msg)
        if self._log_handle is not None and not self._log_handle.closed:
            self._log_handle.flush()

    def _metrics_rows(self, label: str):
        """``(name, latest, running mean)`` of ``label``'s scalars."""
        scalars = self.metrics[label]
        return [(name, latest, scalars["mean"][name]())
                for name, latest in scalars["value"].items()]

    def _metrics_table(self, label: str):
        """Render one label's latest scalars and their running means."""
        from rich import box
        from rich.table import Table

        table = Table(title=f"[b]{label}[/b]", expand=True, box=box.SIMPLE_HEAD)
        table.add_column("metric", style="bold cyan", ratio=2)
        table.add_column("last", justify="right", style="magenta")
        table.add_column("running mean", justify="right", style="green")
        for name, latest, running in self._metrics_rows(label):
            table.add_row(name, f"{latest:10.6f}", f"{running:10.6f}")
        return table

    def _plain_metrics(self, label: str) -> str:
        return " | ".join(f"{name} {latest:.6f} (mean {running:.6f})"
                          for name, latest, running in self._metrics_rows(label))

    def _dashboard(self, heading=None):
        """All labels' tables stacked over the progress bars, framed."""
        from rich.console import Group
        from rich.panel import Panel

        tables = [task["table"] for task in self.tasks.values()]
        body = Panel(
            Group(*tables, self.pbar),
            padding=(0, 2),
            title="[b]audiotools_tpu_torch",
            subtitle=f"step {self.step}",
            border_style="bright_black",
        )
        parts = [] if heading is None else [heading]
        return Group(*parts, body)

    def update(self, label, fn_name):
        """Advance ``label``'s progress and redraw the display."""
        if self.rank != 0:
            return
        task = self.tasks[label]
        task["completed"] += 1
        if self.rich:
            from rich.rule import Rule

            self.pbar.advance(task["pbar"])
            task["table"] = self._metrics_table(label)
            heading = Rule(f"[italic]{fn_name}()", style="bright_black")
            self.live.update(self._dashboard(heading))
        else:
            latest = ", ".join(f"{name} {value:.6g}"
                               for name, value in self.metrics[label]["value"].items())
            self._write_plain(f"{fn_name}() {label} {task['completed']}/{task['total']} "
                              f"step {self.step}" + (f" | {latest}" if latest else ""))

    def done(self, label: str, title: str):
        """Close out an epoch: log the summary, then zero the running means
        and rewind ``label``'s progress for the next pass."""
        if self.rank == 0:
            if self.rich:
                from rich.console import Group
                from rich.markdown import Markdown

                summary = Group(
                    Markdown(f"# {title}"),
                    *[task["table"] for task in self.tasks.values()],
                    self.pbar,
                )
                self.print(summary)
                self.pbar.reset(self.tasks[label]["pbar"])
            else:
                self.print("\n".join([f"== {title} =="] + [
                    f"{name}: {self._plain_metrics(name)}" for name in self.tasks]))
            self.tasks[label]["completed"] = 0

        for scalars in self.metrics.values():
            for mean in scalars["mean"].values():
                mean.reset()

    def track(
        self,
        label: str,
        length: int,
        completed: int = 0,
        multihost_average: bool = None,
    ):
        """Decorator collecting the scalars of the dict the function returns
        into running means and the display.

        ``multihost_average=True`` averages the scalars over the processes
        of ``torch.distributed``'s group; it defaults to on when that group
        is initialised with more than one process.
        """
        if multihost_average is None:
            multihost_average = _world_size() > 1

        self._register_task(label, length, completed)

        def decorator(fn):
            @wraps(fn)
            def decorated(*args, **kwargs):
                output = fn(*args, **kwargs)
                if not isinstance(output, dict):
                    self.update(label, fn.__name__)
                    return output

                scalars = {
                    k: s for k, s in
                    ((k, _to_scalar(v)) for k, v in output.items())
                    if s is not None
                }

                if multihost_average and scalars:
                    scalars = _average_over_processes(scalars)

                for k, v in scalars.items():
                    output[k] = v
                    self.metrics[label]["value"][k] = v
                    self.metrics[label]["mean"][k].update(v)

                self.update(label, fn.__name__)
                return output

            return decorated

        return decorator

    def _register_task(self, label: str, length: int, completed: int):
        """Create the progress row and metric accumulators for a tracked
        label."""
        bar_id = table = None
        if self.rich:
            from rich.table import Table

            bar_id = self.pbar.add_task(
                f"[white]Iteration ({label})", total=length, completed=completed
            )
            table = Table()
        self.tasks[label] = {"pbar": bar_id, "table": table, "total": length,
                             "completed": completed}
        self.metrics[label] = {
            "value": defaultdict(),
            "mean": defaultdict(Mean),
        }

    def _publish(self, label: str, value_type: str):
        """Resolve ``label``'s current scalars (running means collapse to
        their value) and fan them out to TensorBoard and the history."""
        if self.rank != 0:
            return
        snapshot = {
            name: (entry() if isinstance(entry, Mean) else entry)
            for name, entry in self.metrics[label][value_type].items()
        }
        if self.writer is not None:
            for name, val in snapshot.items():
                self.writer.add_scalar(f"{name}/{label}", val, self.step)
        series = self.history.get(label)
        if series is None:
            return
        for name, val in snapshot.items():
            series[name].append(val)
        series["step"].append(self.step)

    def log(self, label: str, value_type: str = "value", history: bool = True):
        """Decorator publishing ``label``'s tracked metrics (TensorBoard and
        the history) each time the function returns."""
        if value_type not in ("mean", "value"):
            raise ValueError(f"value_type must be 'mean' or 'value', got {value_type!r}")
        if history:
            self.history.setdefault(label, defaultdict(list))

        def decorator(fn):
            @wraps(fn)
            def logged(*args, **kwargs):
                output = fn(*args, **kwargs)
                self._publish(label, value_type)
                return output

            return logged

        return decorator

    def is_best(self, label, key):
        """Whether ``key``'s latest logged value is its minimum so far."""
        series = self.history[label][key]
        return series[-1] <= min(series)

    def state_dict(self):
        """Checkpointable state: the history and the step."""
        return {"history": self.history, "step": self.step}

    def load_state_dict(self, state_dict):
        """Restore from ``state_dict``; returns self for chaining."""
        self.history = state_dict["history"]
        self.step = state_dict["step"]
        return self
