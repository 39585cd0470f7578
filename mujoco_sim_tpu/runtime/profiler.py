"""Tracing / profiling subsystem.

The reference's only instrumentation is the RTF tracker + XML-I/O timing
warnings (SURVEY §5).  Here: per-stage wall timings of the compiled
pipeline, steps/s + RTF gauges, and one-call jax.profiler trace capture for
xprof/tensorboard analysis of the device schedule.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field

import jax


@dataclass
class StepStats:
    steps: int = 0
    wall: float = 0.0
    sim_time: float = 0.0
    _t0: float | None = None

    def rate(self) -> float:
        return self.steps / self.wall if self.wall > 0 else 0.0

    def rtf(self) -> float:
        return self.sim_time / self.wall if self.wall > 0 else 0.0


class Profiler:
    """Aggregates step timing; optionally captures a device trace."""

    def __init__(self):
        self.stats = StepStats()
        self.stage_wall: dict[str, float] = {}

    @contextlib.contextmanager
    def step_block(self, n: int = 1, dt: float = 0.0):
        t0 = time.perf_counter()
        yield
        w = time.perf_counter() - t0
        self.stats.steps += n
        self.stats.wall += w
        self.stats.sim_time += n * dt

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        yield
        self.stage_wall[name] = self.stage_wall.get(name, 0.0) + (
            time.perf_counter() - t0)

    def report(self) -> dict:
        return {
            "steps": self.stats.steps,
            "steps_per_sec": round(self.stats.rate(), 1),
            "rtf": round(self.stats.rtf(), 3),
            "stages": {k: round(v, 4) for k, v in self.stage_wall.items()},
        }


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Capture a jax.profiler trace (open with xprof / tensorboard)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def stage_timings(m, d, repeats: int = 20) -> dict:
    """Wall-time each pipeline stage of the compiled step (diagnostics)."""
    from mujoco_sim_tpu import engine
    from mujoco_sim_tpu.ops import solver as solver_mod

    stages = {
        "fwd_position": jax.jit(engine.fwd_position),
        "fwd_velocity": jax.jit(engine.fwd_velocity),
        "fwd_acceleration": jax.jit(engine.fwd_acceleration),
        "solver": jax.jit(solver_mod.solve),
        "full_step": jax.jit(engine.step),
    }
    out = {}
    cur = d
    for name, fn in stages.items():
        try:
            res = fn(m, cur)
            jax.block_until_ready(jax.tree.leaves(res)[0])
            t0 = time.perf_counter()
            for _ in range(repeats):
                res = fn(m, cur)
            jax.block_until_ready(jax.tree.leaves(res)[0])
            out[name] = (time.perf_counter() - t0) / repeats
            if name.startswith("fwd"):
                cur = res
        except Exception as e:  # stage needs earlier stages' outputs
            out[name] = float("nan")
    return out
