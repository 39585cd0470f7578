"""Device-time profile of one bench scenario's rollout on the GPU.

Usage:  python benchmarks/profile_step.py [box|mobile|spawn|manip|manip_8k]
                                          [nsteps [nenv]]
                                          [--chol unrolled,cusolver]

Traces one warmed rollout with ``jax.profiler`` and reduces the trace to
per-step numbers: wall-clock time of an untraced call, device busy time
(the union of kernel intervals on the ``/device:GPU`` streams), idle
share of the traced window, device time per
pipeline stage (the ``jax.named_scope`` names the engine puts on its ops:
kinematics, crb, tendon, collision, mtv, constraint, solver, integrate)
and the leaf kernels ranked by time. XLA:GPU runs the step's kernels
inside command buffers (CUDA graphs), which a trace shows as one opaque
`command_buffer` op, so the script turns them off
(``--xla_gpu_enable_command_buffer=``) before JAX starts; the busy time it
reports is that of the step without command buffers.

``--chol`` is the A/B of the step's SPD factor and solve (the mass-matrix
solve and every Newton iteration): the rollout is traced once in each
named form (``chol_form``), the programs compile side by side, and each is
profiled twice in mirrored order (A B B A), so a drift of the card's
clock over the run falls on both alike.

The reduction is plain functions over ``jax.profiler.ProfileData``, so it
can be checked on a recorded trace without a card.
"""

from __future__ import annotations

import collections
import contextlib
import os
import re
import shutil
import sys
import tempfile
import time

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)

STAGES = ("kinematics", "crb", "tendon", "collision", "mtv", "constraint",
          "solver", "integrate")

CHOL_FORMS = ("unrolled", "cusolver")

_META = re.compile(r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=.*?"
                   r"metadata=\{[^}]*?op_name=\"([^\"]*)\"")


def gpu_kernel_events(trace_dir: str) -> list[dict]:
    """Kernel events of every ``/device:GPU`` plane under ``trace_dir``:
    dicts with name, start and duration (ns) and the HLO op they ran."""
    import glob

    import jax

    paths = glob.glob(os.path.join(trace_dir, "plugins", "profile", "*",
                                   "*.xplane.pb"))
    if not paths:
        raise FileNotFoundError(f"no trace under {trace_dir}")
    out = []
    for path in paths:
        pd = jax.profiler.ProfileData.from_file(path)
        for plane in pd.planes:
            if not plane.name.startswith("/device:GPU"):
                continue
            for line in plane.lines:
                if not line.name.startswith("Stream"):
                    continue
                for ev in line.events:
                    stats = dict(ev.stats)
                    out.append(dict(name=ev.name, start=ev.start_ns,
                                    dur=ev.duration_ns,
                                    hlo_op=str(stats.get("hlo_op", ev.name)),
                                    stream=line.name, plane=plane.name))
    return out


def busy_ns(events) -> float:
    """Length of the union of the events' [start, start + dur) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted((ev["start"], ev["start"] + ev["dur"])
                       for ev in events):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def window_ns(events) -> float:
    if not events:
        return 0.0
    return (max(ev["start"] + ev["dur"] for ev in events)
            - min(ev["start"] for ev in events))


def hlo_op_names(hlo_text: str) -> dict:
    """HLO instruction name -> its ``op_name`` metadata (the jax name
    stack, which carries the ``jax.named_scope`` names)."""
    out = {}
    for line in hlo_text.splitlines():
        mt = _META.match(line)
        if mt:
            out[mt.group(1)] = mt.group(2)
    return out


def stage_of(op_name: str) -> str:
    """Innermost pipeline stage named in an op_name path, else "other"."""
    for seg in reversed(op_name.split("/")):
        if seg in STAGES:
            return seg
    return "other"


def stage_breakdown(events, op_names: dict) -> dict:
    """Device ns per pipeline stage."""
    per = collections.Counter()
    for ev in events:
        per[stage_of(op_names.get(ev["hlo_op"], ""))] += ev["dur"]
    return dict(per)


def report(events, op_names, nsteps, top=20, out=sys.stdout):
    busy = busy_ns(events)
    win = window_ns(events)
    idle = 1.0 - busy / win if win else float("nan")
    print(f"device busy {busy / 1e6 / nsteps:.4f} ms/step over {nsteps} "
          f"steps; window {win / 1e6:.3f} ms; idle share {idle:.4f}; "
          f"{len(events)} kernel events", file=out)
    stages = stage_breakdown(events, op_names)
    ksum = sum(stages.values()) or 1.0
    for st, ns in sorted(stages.items(), key=lambda kv: -kv[1]):
        print(f"  stage {st:11s} {ns / 1e6 / nsteps:9.4f} ms/step "
              f"({100 * ns / ksum:5.1f}% of kernel time)", file=out)
    per = collections.Counter()
    cnt = collections.Counter()
    for ev in events:
        per[ev["hlo_op"]] += ev["dur"]
        cnt[ev["hlo_op"]] += 1
    for name, ns in per.most_common(top):
        print(f"  {ns / 1e3 / nsteps:9.1f} us/step x{cnt[name] / nsteps:6.1f}"
              f"  {name[:48]:48s} "
              f"{stage_of(op_names.get(name, ''))}", file=out)
    return dict(busy_ms_per_step=busy / 1e6 / nsteps, idle_share=idle,
                stages_ms_per_step={k: v / 1e6 / nsteps
                                    for k, v in stages.items()})


def profile(compiled, m, dB, nsteps, tdir=None):
    """Warm ``compiled``, time one untraced call, trace one more; returns
    (events, op_names, wall-clock ms per step)."""
    import jax

    tdir = tdir or tempfile.mkdtemp(prefix="mst_trace_")
    out = compiled(m, dB)
    jax.block_until_ready(out.qpos)
    t0 = time.perf_counter()
    out = compiled(m, out)
    jax.block_until_ready(out.qpos)
    wall_ms = 1e3 * (time.perf_counter() - t0) / nsteps
    with jax.profiler.trace(tdir):
        out = compiled(m, out)
        jax.block_until_ready(out.qpos)
    events = gpu_kernel_events(tdir)
    shutil.rmtree(tdir, ignore_errors=True)
    return events, hlo_op_names(compiled.as_text()), wall_ms


def _cho_solve_triangular(L, rhs):
    from jax.scipy.linalg import solve_triangular

    y = solve_triangular(L, rhs, lower=True)
    return solve_triangular(L, y, lower=True, trans=1)


@contextlib.contextmanager
def chol_form(form: str):
    """Trace the step's SPD factor and solve (``ops/linalg.cholesky`` and
    ``cho_solve``) in one of XLA's two forms: "unrolled", the engine's own
    blocked unrolled code, or "cusolver", ``jnp.linalg.cholesky`` and two
    triangular solves, which XLA:GPU lowers to cuSOLVER's batched factor
    and cuBLAS's triangular solve. The patch holds while the rollout is
    traced; jit caches are cleared on both sides of it, so no inner jitted
    function keeps a trace of the other form."""
    import jax
    import jax.numpy as jnp

    from mujoco_sim_tpu.ops import linalg

    if form not in CHOL_FORMS:
        raise SystemExit(f"unknown Cholesky form {form!r}; known: "
                         f"{list(CHOL_FORMS)}")
    saved = linalg.cholesky, linalg.cho_solve
    if form == "cusolver":
        linalg.cholesky = jnp.linalg.cholesky
        linalg.cho_solve = _cho_solve_triangular
    jax.clear_caches()
    try:
        yield
    finally:
        linalg.cholesky, linalg.cho_solve = saved
        jax.clear_caches()


def main(argv):
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_gpu_enable_command_buffer=")
    import bench
    from mujoco_sim_tpu.utils.cache import use_compile_cache

    forms = ["unrolled"]
    if "--chol" in argv:
        i = argv.index("--chol")
        forms = argv[i + 1].split(",")
        argv = argv[:i] + argv[i + 2:]
    scenario = argv[0] if argv else "manip"
    kw = {"nsteps": int(argv[1]) if len(argv) > 1 else 20}
    if len(argv) > 2:
        kw["nenv"] = int(argv[2])
    use_compile_cache()
    bench.require_gpu()
    print(f"card: {bench.card_info()}", flush=True)

    progs = {}
    for form in forms:
        def lower(run, m, dB, nenv, nsteps, reps=3, form=form):
            progs[form] = (run.lower(m, dB), m, dB, nenv)

        bench._time_rollout = lower
        with chol_form(form):
            bench.SCENARIOS[scenario](**kw)
    compiled = dict(zip(forms, bench.compile_all(
        *(progs[f][0] for f in forms))))
    order = forms + forms[::-1] if len(forms) > 1 else forms
    for form in order:
        exe, secs = compiled[form]
        _, m, dB, nenv = progs[form]
        events, op_names, wall_ms = profile(exe, m, dB, kw["nsteps"])
        print(f"== {scenario} at {nenv} envs, Cholesky form {form}: compile "
              f"{secs:.1f} s, wall {wall_ms:.4f} ms/step untraced",
              flush=True)
        report(events, op_names, kw["nsteps"])


if __name__ == "__main__":
    main(sys.argv[1:])
