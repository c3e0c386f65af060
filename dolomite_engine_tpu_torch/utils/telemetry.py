"""Bounded latency sketches for serving statistics (copy of the host-side part of
`dolomite_engine_tpu/utils/telemetry.py`; telemetry records come with a later slice)."""

from __future__ import annotations


def nearest_rank(ordered, q: float):
    """Nearest-rank quantile over an already-sorted sequence (the serving engine's p99
    convention: rank = ceil(q * n), clamped into range). None on empty input."""
    n = len(ordered)
    if n == 0:
        return None
    rank = min(n - 1, max(0, int(-(-q * n // 1)) - 1))
    return ordered[rank]


class QuantileSketch:
    """Bounded nearest-rank quantile sketch: fixed-size uniform reservoir + exact running
    count/sum.

    A long-running serve holds at most ``capacity`` floats per series while quantile
    queries stay nearest-rank over a uniform subsample. Below capacity the reservoir *is*
    the full stream in insertion order, so ``mean()``/``quantile()`` equal the exact
    list-based computation. Replacement uses a deterministic 64-bit LCG seeded per
    sketch, so results are reproducible for a given insertion order without touching any
    global RNG.

    Not thread-safe.
    """

    __slots__ = ("capacity", "values", "count", "total", "_rng")

    def __init__(self, capacity: int = 4096) -> None:
        if capacity < 1:
            raise ValueError(f"QuantileSketch capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self.values: list[float] = []
        self.count = 0  # samples offered over the stream's lifetime
        self.total = 0.0  # exact running sum (mean never degrades to the subsample's)
        self._rng = 0x9E3779B97F4A7C15

    def append(self, value: float) -> None:
        """Offer one sample (named ``append`` so it drops into list call sites)."""
        value = float(value)
        self.count += 1
        self.total += value
        if len(self.values) < self.capacity:
            self.values.append(value)
            return
        # algorithm R: replace a random retained sample with probability capacity/count
        self._rng = (self._rng * 6364136223846793005 + 1442695040888963407) % (1 << 64)
        slot = self._rng % self.count
        if slot < self.capacity:
            self.values[slot] = value

    def mean(self) -> float | None:
        return self.total / self.count if self.count else None

    def quantile(self, q: float) -> float | None:
        return nearest_rank(sorted(self.values), q)
