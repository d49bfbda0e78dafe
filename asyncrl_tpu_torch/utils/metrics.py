"""Metrics sinks of the port (counterpart of ``asyncrl_tpu/utils/metrics.py``):
stdout and JSONL, and a fan-out to several.

``Trainer.train`` reads the device metrics back once a window (every
``log_every`` update calls) and hands the aggregated window dict to its
callback; a sink is such a callback. Every sink of a window gets the same
dict and must not change it. The JAX package's ``TensorBoardSink`` writes
through ``tf.summary``, which the port does not depend on; it is still to
port (``ROADMAP.md``, Queue A item 7).
"""

from __future__ import annotations

import json
import sys
from typing import Any, Mapping, TextIO


class MetricsSink:
    """One destination for per-window metric dicts."""

    def write(self, window: Mapping[str, Any]) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __call__(self, window: Mapping[str, Any]) -> None:
        """Sinks are usable directly as ``Trainer.train(callback=sink)``."""
        self.write(window)


class StdoutSink(MetricsSink):
    """A one-line summary per window (or the raw JSON with ``as_json``).
    Keys a window lacks are left out, never shown as zero."""

    def __init__(self, as_json: bool = False, stream: TextIO | None = None):
        self.as_json = as_json
        self.stream = stream or sys.stdout

    def write(self, window: Mapping[str, Any]) -> None:
        if self.as_json:
            print(json.dumps(dict(window)), file=self.stream)
        else:
            parts = []
            if "env_steps" in window:
                parts.append(f"steps={int(window['env_steps']):>10}")
            if "fps" in window:
                parts.append(f"fps={window['fps']:>12,.0f}")
            if "episode_return" in window:
                parts.append(f"ep_return={window['episode_return']:8.2f}")
            if "eval_return" in window:
                parts.append(f"eval_return={window['eval_return']:8.2f}")
            for k in ("loss", "entropy"):
                if k in window:
                    parts.append(f"{k}={window[k]:8.4f}")
            print("  ".join(parts), file=self.stream)
        self.stream.flush()


class JsonlSink(MetricsSink):
    """Append one JSON line per window to a file."""

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "a", buffering=1)

    def write(self, window: Mapping[str, Any]) -> None:
        self._f.write(json.dumps(dict(window)) + "\n")

    def close(self) -> None:
        self._f.close()


class MultiSink(MetricsSink):
    """Fan a window out to several sinks."""

    def __init__(self, *sinks: MetricsSink | None):
        self.sinks = [s for s in sinks if s is not None]

    def write(self, window: Mapping[str, Any]) -> None:
        for sink in self.sinks:
            sink.write(window)

    def close(self) -> None:
        first_error = None
        for sink in self.sinks:
            try:
                sink.close()
            # lint: broad-except-ok(every sink gets closed; the first failure re-raises after)
            except Exception as e:
                first_error = first_error or e
        if first_error is not None:
            raise first_error
