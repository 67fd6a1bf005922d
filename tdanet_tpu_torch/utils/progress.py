"""The eval CLI's progress display (counterpart of
``tdanet_tpu/utils/progress.py``): a rich progress bar with a
batches-processed column and a live metrics column, or, where rich is not
installed, plain prints of the metrics and no bar."""

from __future__ import annotations

try:
    from rich.progress import (
        BarColumn,
        Progress,
        ProgressColumn,
        TextColumn,
        TimeRemainingColumn,
    )
    from rich.text import Text
    _HAVE_RICH = True
except ImportError:
    _HAVE_RICH = False


THEME = {
    "description": "#FF4500",
    "progress_bar": "#f92672",
    "batch_progress": "#fc608a",
    "metrics": "#45ada2",
}


if _HAVE_RICH:

    class BatchesProcessedColumn(ProgressColumn):
        """'n/total' column."""

        def render(self, task):
            total = "--" if task.total is None else int(task.total)
            return Text(f"{int(task.completed)}/{total}",
                        style=THEME["batch_progress"])

    class MetricsTextColumn(ProgressColumn):
        """Live metrics dict column."""

        def __init__(self):
            super().__init__()
            self._metrics = {}

        def update(self, metrics):
            self._metrics = metrics

        def render(self, task):
            text = " ".join(f"{k}: {v:.3f}" if isinstance(v, float)
                            else f"{k}: {v}"
                            for k, v in self._metrics.items())
            return Text(text, style=THEME["metrics"])

    def eval_progress(description="Testing"):
        """(progress, metrics_column): ``progress`` is a context manager
        with ``track``; ``metrics_column.update(dict)`` shows metrics."""
        metrics_col = MetricsTextColumn()
        progress = Progress(
            TextColumn(f"[bold blue]{description}", justify="right"),
            BarColumn(bar_width=None, complete_style=THEME["progress_bar"]),
            "•", BatchesProcessedColumn(), "•", TimeRemainingColumn(),
            "•", metrics_col)
        return progress, metrics_col

else:

    class _NullColumn:
        def update(self, metrics):
            print(metrics)

    class _NullProgress:
        def __enter__(self):
            return self

        def __exit__(self, *a):
            return False

        def track(self, it, **kw):
            return it

        def add_task(self, *a, **kw):
            return 0

        def advance(self, *a, **kw):
            pass

    def eval_progress(description="Testing"):
        """(progress, metrics_column) without rich: ``track`` passes the
        iterable through and ``update`` prints the metrics."""
        return _NullProgress(), _NullColumn()
