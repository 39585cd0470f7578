"""Throughput of the batched physics step on one GPU (BASELINE.md configs).

Usage:  python bench.py [scenario ...]        (default: every scenario)

Scenarios:
  box       free box on the floor (smoke), 4096 envs — headline `value`
  mobile    mobile base (odom-driven) + 3-dof PD arm, 1024 envs — config 3
  spawn     4 spawnable balls/env, half the slots active, 4096  — config 4
  manip     6-dof arm stirring mesh objects in a bin, 1024      — config 5
  manip_8k  the manip scene at 8192 envs
  pr2       config 2; not measured until an in-repo PR2-class scene
            exists (its robot meshes are not in the repo)

The parent process never initializes a JAX backend: it runs one child
process per scenario, one at a time, so one process at a time holds the
card. Each child prints one JSON result; the parent prints ONE JSON line:
  {"metric": "env_steps_per_sec_per_chip", "value": <box rate>,
   "unit": "env-steps/s", "device": {...}, "scenarios": {name: {...}},
   "failed": [names], "not_measured": ["pr2"]}
A scenario that fails is named in "failed" and the parent exits non-zero;
no earlier number stands in for it.

`roofline` fractions divide XLA's compiled cost analysis (flops and bytes
per step) by the best measured step time and by the card's peaks (PEAKS,
keyed by device_kind; the step runs f32 at "highest" matmul precision, so
flops are held against the f32 rate outside the tensor cores). XLA's
byte count is an upper estimate of traffic, not a hardware counter.
"""

import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

_REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, _REPO)

# Published peaks (NVIDIA H100 SXM data sheet, dense): bf16 and TF32 on
# the tensor cores, f32 outside them, HBM bandwidth. Keyed by
# jax.Device.device_kind; a device missing here is an error, not a default.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16_flops": 989e12, "tf32_flops": 495e12,
                              "f32_flops": 67e12, "hbm_bytes": 3.35e12},
}

NOT_MEASURED = ("pr2",)


def peaks(device_kind: str) -> dict:
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise ValueError(
            f"no peak rates for device kind {device_kind!r}; add them to "
            "bench.PEAKS from the card's data sheet") from None


def card_info() -> str:
    """`name, power.limit` of the card as nvidia-smi reports them."""
    if shutil.which("nvidia-smi") is None:
        return "nvidia-smi not found"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    return out.stdout.strip() or out.stderr.strip()


def require_gpu():
    """The first device, which must be a GPU: a measurement that finds
    no card fails instead of timing the CPU."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"no GPU: JAX's first device is {dev.platform} "
                         f"({dev.device_kind})")
    return dev


def device_info() -> dict:
    import jax

    dev = jax.devices()[0]
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices()), "card": card_info()}


def _batch(m, d, nenv, jitter=True):
    import jax
    import jax.numpy as jnp

    dB = jax.tree.map(lambda x: jnp.broadcast_to(x, (nenv,) + x.shape), d)
    if jitter:
        key = jax.random.PRNGKey(0)
        dz = jax.random.uniform(key, (nenv,), minval=0.0, maxval=0.1)
        dB = dB.replace(qpos=dB.qpos.at[:, 2].add(dz))
    return dB


def _cost_analysis(compiled):
    """XLA compiled-cost totals {flops, bytes} for ONE STEP of the rollout.

    XLA's HLO cost analysis counts a while/scan body ONCE, not x trip
    count, so the numbers of an nsteps-scan rollout are per-step numbers.
    The nested Newton while is also counted once, so these are LOWER
    bounds on the solver's work per step."""
    ca = compiled.cost_analysis()
    flops = float(ca.get("flops", 0.0))
    nbytes = float(ca.get("bytes accessed", 0.0))
    if flops <= 0 and nbytes <= 0:
        return None
    return {"flops": flops, "bytes": nbytes}


def _time_rollout(run, m, dB, nenv, nsteps, reps=3):
    """Compile, one warmup dispatch, then best-of-`reps` timed rollouts;
    returns the result dict."""
    import jax

    t0 = time.perf_counter()
    compiled = run.lower(m, dB).compile()
    compile_s = time.perf_counter() - t0
    out = compiled(m, dB)
    jax.block_until_ready(out.qpos)
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        out = compiled(m, out)
        jax.block_until_ready(out.qpos)
        best = min(best, time.perf_counter() - t0)
    if not np.isfinite(np.asarray(out.qpos)).all():
        raise FloatingPointError("non-finite qpos after the rollout")
    res = {"nenv": nenv, "nsteps": nsteps, "rate": nenv * nsteps / best,
           "step_ms": 1e3 * best / nsteps, "compile_s": compile_s}
    cost = _cost_analysis(compiled)
    if cost:
        pk = peaks(jax.devices()[0].device_kind)
        step_s = best / nsteps
        res["roofline"] = {
            "f32_flops_frac": cost["flops"] / step_s / pk["f32_flops"],
            "hbm_bytes_frac": cost["bytes"] / step_s / pk["hbm_bytes"],
            "flops_per_step": cost["flops"],
            "bytes_per_step": cost["bytes"],
        }
    stats = jax.devices()[0].memory_stats() or {}
    if "peak_bytes_in_use" in stats:
        res["peak_bytes_in_use"] = stats["peak_bytes_in_use"]
    return res


def compile_all(*lowered):
    """Compile lowered programs concurrently (XLA compiles off the GIL, and
    a manip program takes minutes); returns [(compiled, seconds)] in
    order."""
    from concurrent.futures import ThreadPoolExecutor

    def one(lo):
        t0 = time.perf_counter()
        return lo.compile(), time.perf_counter() - t0

    with ThreadPoolExecutor(len(lowered)) as ex:
        return list(ex.map(one, lowered))


def _rollout_fn(nsteps):
    import jax

    from mujoco_sim_tpu.parallel import mesh as pmesh

    return jax.jit(lambda mm, dd: pmesh.rollout(mm, dd, nsteps,
                                                full_final=False))


def _euler_f32(m):
    import jax.numpy as jnp

    from mujoco_sim_tpu import engine
    from mujoco_sim_tpu.models.model import Integrator

    m = m.replace(opt=m.opt.replace(integrator=int(Integrator.EULER)))
    m32 = engine.put_model(m, jnp.float32)
    return m32, engine.make_data(m32, jnp.float32)


def _fixture(name):
    return os.path.join(_REPO, "tests", "fixtures", name)


def bench_box(nenv=4096, nsteps=1000, reps=3):
    """Headline smoke scenario: ONE free box on a plane (<= 1 contact
    pair) — measures the raw step pipeline, not contact richness;
    bench_manip is the contact-rich manipulation number."""
    import jax

    from mujoco_sim_tpu.models.compile import load_model

    m32, d = _euler_f32(load_model(_fixture("floor_box.xml")))
    dB = _batch(m32, d, nenv, jitter=False)
    key = jax.random.PRNGKey(0)
    dB = dB.replace(
        qpos=dB.qpos.at[:, 2].add(
            jax.random.uniform(key, (nenv,), minval=0.0, maxval=0.3)),
        qvel=dB.qvel.at[:, 3:6].set(
            jax.random.uniform(key, (nenv, 3), minval=-0.5, maxval=0.5)))
    return _time_rollout(_rollout_fn(nsteps), m32, dB, nenv, nsteps, reps)


def _mobile_model():
    from mujoco_sim_tpu.engine import set_const
    from mujoco_sim_tpu.models import scene
    from mujoco_sim_tpu.models.compile import compile_spec

    world = scene.compose(
        _fixture("empty_world.xml"),
        robots={"benchbot": scene.RobotConfig(
            path=_fixture("benchbot.xml"),
            add_odom_joints={"lin_odom_x_joint": True,
                             "lin_odom_y_joint": True,
                             "ang_odom_z_joint": True})})
    return set_const(compile_spec(world))


def bench_mobile(nenv=1024, nsteps=500, reps=5):
    """Config 3: base velocity control + PD arm, batched."""
    import jax
    import jax.numpy as jnp

    from mujoco_sim_tpu import engine
    from mujoco_sim_tpu.control import controllers as C
    from mujoco_sim_tpu.parallel import mesh as pmesh

    m = _mobile_model()
    m32, d = _euler_f32(m)
    ocfg = C.odom_config(m, "benchbot")
    pdc = C.pd_config_for_joints(m32, ["a1", "a2", "a3"], kp=80.0, kd=8.0)
    st = C.make_pd_state(m32, jnp.float32)
    qdes = jnp.zeros(m.nv, jnp.float32)
    cmd = jnp.asarray([0.4, 0.0, 0.0, 0.0, 0.0, 0.3], jnp.float32)

    def one_env_step(m_, carry):
        d_, st_ = carry
        d_ = engine.step1(m_, d_)
        st2 = C.pd_accel(pdc, st_, d_, qdes, m_.opt.timestep)
        d_, st3 = C.apply_control(m_, d_, st2, pdc.ctrl_mask)
        d_ = C.set_odom_vels(m_, d_, ocfg, cmd)
        d_ = engine.step2(m_, d_)
        return d_, st3

    dB = _batch(m32, d, nenv, jitter=False)
    stB = jax.tree.map(lambda x: jnp.broadcast_to(x, (nenv,) + x.shape), st)

    @jax.jit
    def run(m_, dB_):
        step = jax.vmap(lambda dd, ss: one_env_step(m_, (dd, ss)),
                        in_axes=(0, 0))
        dB_, _ = pmesh.scan_reduced(lambda c: step(c[0], c[1]),
                                    (dB_, stB), nsteps)
        return dB_

    return _time_rollout(run, m32, dB, nenv, nsteps, reps)


def bench_spawn(nenv=4096, nsteps=500, reps=5):
    """Config 4: masked spawn slots, half active."""
    import jax.numpy as jnp

    from mujoco_sim_tpu.engine import set_const
    from mujoco_sim_tpu.models import scene
    from mujoco_sim_tpu.models.compile import compile_spec

    world = scene.compose(
        _fixture("empty_world.xml"),
        robots={"sball": scene.RobotConfig(path=_fixture("spawn_ball.xml"))},
        instances=4)
    m = set_const(compile_spec(world))
    m32, d = _euler_f32(m)
    # half the slots inactive
    ba = np.ones(m.nbody, dtype=bool)
    for i, name in enumerate(m.names.body):
        if name.startswith(("2_", "3_")):
            ba[i] = False
    d = d.replace(body_active=jnp.asarray(ba))
    dB = _batch(m32, d, nenv)
    return _time_rollout(_rollout_fn(nsteps), m32, dB, nenv, nsteps, reps)


def manip_rollout(nenv, nsteps, phase=None):
    """(run, model, batched data) of the config-5 manipulation workload:
    a 6-dof arm stirring 6 free convex-mesh objects (24-vert tumblers,
    20-vert rock dodecahedra, cubes) inside a bin — mesh-mesh object
    pairs, object-bin, object-arm and floor contacts all live at once, on
    real >=20-vert hulls (tests/fixtures/manip_bin6.xml, capped at 32
    contacts by <size nconmax>). Each env stirs with its own `sin` phase
    (`phase` (nenv, nu), drawn from a fixed key when not given). Shared by
    the bench, the profiler and chip_smoke.py."""
    import jax
    import jax.numpy as jnp

    from mujoco_sim_tpu import engine
    from mujoco_sim_tpu.models.compile import load_model
    from mujoco_sim_tpu.parallel import mesh as pmesh

    m32, d = _euler_f32(load_model(_fixture("manip_bin6.xml")))
    dB = _batch(m32, d, nenv, jitter=False)
    if phase is None:
        phase = jax.random.uniform(jax.random.PRNGKey(1), (nenv, m32.nu),
                                   maxval=6.28)

    def one_step(m_, d_, ph):
        ctrl = jnp.sin(4.0 * d_.time + ph)  # stir
        return engine.step(m_, d_.replace(ctrl=ctrl))

    @jax.jit
    def run(m_, dB_):
        step = jax.vmap(lambda dd, ph: one_step(m_, dd, ph),
                        in_axes=(0, 0))
        dB_, _ = pmesh.scan_reduced(lambda c: (step(c[0], phase), c[1]),
                                    (dB_, 0), nsteps)
        return dB_

    return run, m32, dB


def bench_manip(nenv=1024, nsteps=300, reps=5):
    """Config 5 single-card analogue (BASELINE.md contact-rich
    manipulation); the box scenario is a smoke test by comparison. The
    step's dense (nenv, nefc, nv) constraint rows grow with the env
    count, so the scenario runs at two env counts (manip, manip_8k)."""
    run, m32, dB = manip_rollout(nenv, nsteps)
    return _time_rollout(run, m32, dB, nenv, nsteps, reps)


SCENARIOS = {
    "box": bench_box,
    "mobile": bench_mobile,
    "spawn": bench_spawn,
    "manip": bench_manip,
    "manip_8k": lambda **kw: bench_manip(**{"nenv": 8192, "nsteps": 100,
                                            "reps": 3, **kw}),
}


def _child(name):
    from mujoco_sim_tpu.utils.cache import use_compile_cache

    use_compile_cache()
    require_gpu()
    res = SCENARIOS[name]()
    print(json.dumps(dict(res, device=device_info())), flush=True)


def main(argv):
    if argv[:1] == ["--child"]:
        _child(argv[1])
        return 0
    names = argv or list(SCENARIOS) + list(NOT_MEASURED)
    unknown = [n for n in names if n not in SCENARIOS
               and n not in NOT_MEASURED]
    if unknown:
        raise SystemExit(f"unknown scenario(s) {unknown}; "
                         f"known: {list(SCENARIOS)}")
    results, failed, device = {}, [], None
    for name in names:
        if name in NOT_MEASURED:
            continue
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child", name],
            stdout=subprocess.PIPE, text=True)
        lines = proc.stdout.strip().splitlines()
        if proc.returncode != 0 or not lines:
            failed.append(name)
            results[name] = {"error": f"exit code {proc.returncode}"}
            print(f"# {name}: FAILED (exit code {proc.returncode})",
                  file=sys.stderr, flush=True)
            continue
        res = json.loads(lines[-1])
        device = res.pop("device")
        results[name] = res
        print(f"# {name}: nenv={res['nenv']} {res['rate']:.1f} env-steps/s "
              f"step {res['step_ms']:.4f} ms compile {res['compile_s']:.1f} s",
              file=sys.stderr, flush=True)
    line = {
        "metric": "env_steps_per_sec_per_chip",
        "value": results.get("box", {}).get("rate"),
        "unit": "env-steps/s",
        "device": device,
        "scenarios": results,
        "failed": failed,
        "not_measured": [n for n in NOT_MEASURED if n in names],
    }
    print(json.dumps(line), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
