"""Straggler mitigation (the reference's ``repro.distributed.elastic``;
its mesh and replica-restore parts come with ROADMAP queue 1 item 9).

Mitigation is structural: the data pipeline is a pure function of (seed,
step, shard) (``data.pipeline``), so a backup host can recompute any shard
with no coordination; ``StragglerMonitor`` is the 'launch a backup after
k x the median step' policy hook."""
from __future__ import annotations


class StragglerMonitor:
    """Track per-step durations; signal when a step exceeds k x median —
    the driver then re-issues the step's shards to backup hosts (the data
    pipeline determinism makes the recompute exact)."""

    def __init__(self, k: float = 3.0, window: int = 50):
        self.k = k
        self.window = window
        self.durations = []

    def observe(self, seconds: float) -> bool:
        self.durations.append(seconds)
        hist = self.durations[-self.window:]
        if len(hist) < 5:
            return False
        med = sorted(hist)[len(hist) // 2]
        return seconds > self.k * med
