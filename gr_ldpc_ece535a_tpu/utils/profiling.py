"""Profiling and throughput metrics (absent in the reference, SURVEY.md §5).

``trace`` wraps ``jax.profiler.trace`` for TensorBoard-compatible device
traces; ``Timer``/``ThroughputMeter`` give wall-clock and bits-per-second
counters for pipeline stages (the per-kernel tokens/s analog).
"""

from __future__ import annotations

import contextlib
import time
from typing import Iterator, Optional

__all__ = ["Timer", "ThroughputMeter", "enable_persistent_compile_cache",
           "trace"]


class Timer:
    """Context-manager stopwatch: ``with Timer() as t: ...; t.elapsed``."""

    def __init__(self) -> None:
        self.elapsed = 0.0
        self._t0: Optional[float] = None

    def __enter__(self) -> "Timer":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self.elapsed = time.perf_counter() - self._t0


class ThroughputMeter:
    """Accumulate (items, seconds) across steps; report rates.

    The per-chip decoded-info-bits/s counter the north-star metric reads
    (BASELINE.md): ``meter.add(frames * K, t)``; ``meter.rate`` in items/s.
    """

    def __init__(self, unit: str = "bits") -> None:
        self.unit = unit
        self.items = 0.0
        self.seconds = 0.0
        self.steps = 0

    def add(self, items: float, seconds: float) -> None:
        self.items += items
        self.seconds += seconds
        self.steps += 1

    @contextlib.contextmanager
    def step(self, items: float) -> Iterator[None]:
        t0 = time.perf_counter()
        yield
        self.add(items, time.perf_counter() - t0)

    @property
    def rate(self) -> float:
        return self.items / self.seconds if self.seconds else 0.0

    def __repr__(self) -> str:
        return (f"<ThroughputMeter {self.rate:.3e} {self.unit}/s "
                f"over {self.steps} steps>")


@contextlib.contextmanager
def trace(log_dir: str, create_perfetto_link: bool = False) -> Iterator[None]:
    """Device+host profiler trace viewable in TensorBoard/XProf."""
    import jax
    with jax.profiler.trace(log_dir, create_perfetto_link=create_perfetto_link):
        yield


def enable_persistent_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache; returns its directory.

    If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already caches there and
    no other directory is set. Otherwise the cache is the fixed
    ``<checkout>/.jax_cache`` (listed in .gitignore): the path is part of
    the cache key, so it must not move between runs. Called by the CLI
    apps, bench.py and chip_smoke.py at startup.
    """
    import os
    from pathlib import Path

    import jax

    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = str(Path(__file__).resolve().parents[2] / ".jax_cache")
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return path
