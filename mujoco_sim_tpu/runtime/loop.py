"""Interactive sim loop: real-time pacing, RTF tracking, adaptive timestep.

Equivalent of simulate() + the RTF governor (reference: src/mj_main.cpp:54-165):
busy-wait sync to wall clock, trailing-window real-time-factor, timestep
doubled when >1 ms behind (capped at max_time_step) and halved back to
nominal when caught up.  Because Option.timestep is an array *leaf* (not a
static), retiming never retraces the compiled step.

Throughput mode (pace=None) runs free — the default for batch
rollouts (SURVEY §2.5 'real-time synchronization').
"""

from __future__ import annotations

import time
from collections import deque

import jax
import jax.numpy as jnp

from mujoco_sim_tpu import engine
from mujoco_sim_tpu.models.model import Model, Data


class SimLoop:
    def __init__(self, m: Model, d: Data, max_time_step: float | None = None,
                 real_time: bool = True, controller=None):
        self.m = m
        self.d = d
        self.nominal_dt = float(m.opt.timestep)
        self.max_dt = max_time_step or self.nominal_dt
        self.real_time = real_time
        self.controller = controller  # callable (m, d) -> d
        self._step = jax.jit(engine.step)
        self.rtf = 1.0
        self._window: deque[tuple[float, float]] = deque()
        self._start_wall = None
        self._start_sim = None
        self.current_dt = self.nominal_dt

    def _set_dt(self, dt: float):
        if dt != self.current_dt:
            self.current_dt = dt
            opt = self.m.opt.replace(
                timestep=jnp.asarray(dt, jnp.asarray(self.m.opt.timestep).dtype))
            self.m = self.m.replace(opt=opt)

    def run(self, sim_seconds: float):
        """Advance sim time by sim_seconds with pacing + governor."""
        if self._start_wall is None:
            self._start_wall = time.perf_counter()
            self._start_sim = float(self.d.time)
        end_time = float(self.d.time) + sim_seconds
        while float(self.d.time) < end_time:
            if self.controller is not None:
                self.d = self.controller(self.m, self.d)
            self.d = self._step(self.m, self.d)
            now = time.perf_counter()
            sim_elapsed = float(self.d.time) - self._start_sim
            wall_elapsed = now - self._start_wall
            lag = wall_elapsed - sim_elapsed
            if self.real_time:
                if lag < 0:
                    # ahead of wall clock: busy-wait (mj_main.cpp:127-131)
                    target = self._start_wall + sim_elapsed
                    while time.perf_counter() < target:
                        pass
                elif lag > 1e-3 and self.current_dt * 2 <= self.max_dt:
                    # behind: double timestep (mj_main.cpp:149-156)
                    self._set_dt(self.current_dt * 2)
                elif lag <= 1e-3 and self.current_dt > self.nominal_dt:
                    # caught up: halve back toward nominal (:157-163)
                    self._set_dt(max(self.nominal_dt, self.current_dt / 2))
            # trailing-window RTF over ~1 s of sim time (mj_main.cpp:115-147)
            self._window.append((now, float(self.d.time)))
            while (len(self._window) > 2
                   and float(self.d.time) - self._window[0][1] > 1.0):
                self._window.popleft()
            (w0, s0), (w1, s1) = self._window[0], self._window[-1]
            if w1 > w0:
                self.rtf = (s1 - s0) / (w1 - w0)
        return self.d
