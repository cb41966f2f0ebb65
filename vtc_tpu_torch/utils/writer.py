"""Metric sinks: a TensorBoard writer with train/valid mode tagging.

The port's own copy of ``vtc_tpu/utils/writer.py``. Behavior contract from
the reference's ``logger/visualization.py:5-87`` (mirrored, not copied):
lazily bind whichever SummaryWriter implementation is installed
(``tensorboardX`` or ``torch.utils.tensorboard``; with neither, a warning
and every sink a no-op), tag every datum with the current mode (train/valid) and
global step, and emit a ``steps_per_sec`` scalar on every ``set_step``.
The reference's ``selected_module`` bug (error messages always naming the
last-probed module) does not apply here — unknown methods fail through
normal attribute lookup.
"""

from __future__ import annotations

import importlib
import time

# sink methods forwarded to the underlying SummaryWriter; histograms and
# embeddings keep their raw tag (per-parameter names must not fork into
# train/valid series)
_SINKS = (
    "add_scalar",
    "add_scalars",
    "add_image",
    "add_images",
    "add_audio",
    "add_text",
    "add_histogram",
    "add_pr_curve",
    "add_embedding",
)
_RAW_TAG_SINKS = frozenset({"add_histogram", "add_embedding"})

_IMPLEMENTATIONS = ("tensorboardX", "torch.utils.tensorboard")


def _bind_summary_writer(log_dir, logger):
    """First importable SummaryWriter implementation, or None (warned)."""
    for module in _IMPLEMENTATIONS:
        try:
            cls = importlib.import_module(module).SummaryWriter
        except ImportError:
            continue
        return cls(str(log_dir))
    if logger is not None:
        logger.warning(
            "Tensorboard logging requested but no SummaryWriter "
            "implementation (tensorboardX) is available; disabling."
        )
    return None


class TensorboardWriter:
    """No-op safe: with tensorboard disabled/missing every sink call is
    swallowed, so trainer code never branches on availability."""

    def __init__(self, log_dir, logger, enabled: bool):
        self.writer = _bind_summary_writer(log_dir, logger) if enabled else None
        self.step = 0
        self.mode = ""
        self._tick = time.monotonic()

    def set_step(self, step: int, mode: str = "train") -> None:
        """Advance the global step; emits a steps_per_sec scalar measuring
        the wall time since the previous call (reset at step 0)."""
        self.mode = mode
        self.step = step
        now = time.monotonic()
        if step != 0 and now > self._tick:
            self._log("add_scalar", "steps_per_sec", 1.0 / (now - self._tick))
        self._tick = now

    def _log(self, sink: str, tag: str, data, *args, **kwargs):
        fn = getattr(self.writer, sink, None)
        if fn is None:  # disabled, or the bound impl lacks this sink
            return
        if sink not in _RAW_TAG_SINKS:
            tag = f"{tag}/{self.mode}"
        fn(tag, data, self.step, *args, **kwargs)


def _make_sink(name):
    def sink(self, tag, data, *args, **kwargs):
        self._log(name, tag, data, *args, **kwargs)

    sink.__name__ = name
    sink.__qualname__ = f"TensorboardWriter.{name}"
    sink.__doc__ = f"Forward ``{name}`` with mode/step tagging."
    return sink


for _name in _SINKS:
    setattr(TensorboardWriter, _name, _make_sink(_name))
del _name
