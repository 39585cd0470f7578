"""Smoke run of the system's main paths on one GPU.

Usage:  python chip_smoke.py           one card: every phase below
        python chip_smoke.py --four    four cards: the env-mesh path and
                                       its one-card comparison, nothing else

Phases, in one process that holds the card (the `gpu` tests run in a child
before this process first touches it). Any failure exits non-zero.

  gpu-tests  the tests marked `gpu` (pytest -m gpu), on the card
  device     JAX's first device must be a GPU; no carrying on on the CPU
  rollout    learning deployment: tests/fixtures/manip_bin6.xml (nv=42,
             32 contacts, 131 constraint rows, 24-vert hulls) at 4096
             envs, Euler, each env stirring with its own `sin` phase, 100
             steps through engine.put_model -> parallel.mesh.scan_reduced
             under jax.jit. All state must stay finite.
  reference  4 of those envs, 20 steps on the card and on the CPU backend
             (f32 at "highest" matmul precision on both) from the stirred
             state after the rollout; arm angles, body positions and body
             rotations are bounded separately, and the same card program
             on a planted fault must exceed every bound.
  served     served-simulator deployment: a SimServer built by
             runtime.config.build around the empty world with a 4-slot
             spawnable sphere; through io.client.SimClient spawn 3 objects,
             read their state after they fall, take 3 object_states stream
             messages, destroy them.

The step runs XLA's own kernels only: each hand-written kernel the
system had was measured against XLA's form on the card and removed
(PERF.md), so there is no kernel phase.

Earlier lines print what is worth keeping (card name and power limit,
JAX version, compile and run seconds, the rollout's memory analysis); the
last line is {"ok": true, "device": {"platform", "kind", "count"}}.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import time

_REPO = os.path.dirname(os.path.abspath(__file__))

NENV = 4096
NSTEPS = 100
CHUNK = 20            # steps per rollout call; the reference is one chunk
NREF = 4

# Card vs CPU: 4 envs, 20 steps from the stirred state the rollout ends
# in (after the objects have landed: from the initial drop, support-vertex
# picks on near-flat faces flip by rounding and move orientations in
# jumps). Both sides run f32 at "highest" matmul precision (no TF32 on the
# card), so they differ only by the order of floating-point sums (XLA:GPU
# vs XLA:CPU reductions and fusions), which stiff contacts amplify. qpos
# is bounded per class: arm joint angles (rad), free-body positions (m),
# free-body rotations (rad, the angle between the two orientations). Each
# bound lies between the sound reading on an H100 (7.9e-6, 8.0e-5, 1.8e-3)
# and that of the planted fault below (8.7e-3, 6.3e-4, 2.2e-2; PERF.md).
REF_BOUNDS = {"joint": 2.5e-4, "pos": 2.5e-4, "rot": 6e-3}


def planted_fault(m):
    """The control: the same card program on a model with 10% less
    sliding friction on every contact pair. The reference check must
    tell it apart from the sound run in every class."""
    return m.replace(pair_friction=m.pair_friction.at[:, :2].multiply(0.9))


# --four: the first 4096 envs of the 4-card run vs the same envs on one
# card. Both run the same per-env arithmetic at the same per-card shape,
# so they may differ only where XLA partitions or fuses differently.
FOUR_ATOL = 1e-5


def _log(msg):
    print(msg, flush=True)


class Phases:
    """Runs named phases, prints each outcome, remembers failures."""

    def __init__(self):
        self.failed = []

    def run(self, name, fn, *args):
        t0 = time.perf_counter()
        try:
            out = fn(*args)
        except Exception as e:  # noqa: BLE001 - every phase must report
            import traceback

            traceback.print_exc()
            self.failed.append(name)
            _log(f"phase {name}: FAILED after {time.perf_counter() - t0:.1f}"
                 f" s: {type(e).__name__}: {e}")
            return None
        _log(f"phase {name}: ok ({time.perf_counter() - t0:.1f} s)")
        return out


def gpu_tests():
    """The `gpu`-marked tests, in a child process on the card."""
    env = dict(os.environ, JAX_PLATFORMS="cuda,cpu")
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-m", "gpu", "-rs",
         "-p", "no:cacheprovider", "tests/test_bench.py"],
        cwd=_REPO, env=env, capture_output=True, text=True)
    tail = proc.stdout.strip().splitlines()[-1:] or [proc.stderr.strip()]
    _log(f"  pytest -m gpu: {tail[0]}")
    if proc.returncode != 0 or "skipped" in proc.stdout or \
            "passed" not in tail[0]:
        _log(proc.stdout[-4000:] + proc.stderr[-4000:])
        raise RuntimeError("gpu-marked tests did not all pass on the card")


def device_phase():
    import jax

    dev = jax.devices()[0]
    _log(f"  jax {jax.__version__}; {len(jax.devices())} device(s); "
         f"{dev.platform} {dev.device_kind}")
    if dev.platform != "gpu":
        raise SystemExit(f"chip_smoke: no GPU (JAX's first device is "
                         f"{dev.platform}); nothing is run on the CPU")
    return dev


def rollout_phase(state):
    """The manip rollout on the card; the CPU program of the reference
    phase compiles beside it."""
    import jax
    import numpy as np

    import bench

    cpu = jax.devices("cpu")[0]
    phase = jax.random.uniform(jax.random.PRNGKey(1), (NENV, 6),
                               maxval=6.28)
    run, m32, dB = bench.manip_rollout(NENV, CHUNK, phase=phase)
    run4, m4, d4 = bench.manip_rollout(NREF, CHUNK, phase=phase[:NREF])
    m_cpu, d_cpu = jax.device_put(m4, cpu), jax.device_put(d4, cpu)
    t0 = time.perf_counter()
    lo, lo_cpu = run.lower(m32, dB), run4.lower(m_cpu, d_cpu)
    _log(f"  trace and lower {time.perf_counter() - t0:.1f} s")
    (compiled, tc), (c_cpu, tc_cpu) = bench.compile_all(lo, lo_cpu)
    _log(f"  rollout: {NENV} envs, compile {tc:.1f} s (CPU reference "
         f"program {tc_cpu:.1f} s, concurrently)")
    _log(f"  rollout memory_analysis: {compiled.memory_analysis()}")
    t0 = time.perf_counter()
    out = compiled(m32, dB)
    jax.block_until_ready(out.qpos)
    _log(f"  first chunk ({CHUNK} steps) {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    for _ in range(NSTEPS // CHUNK - 1):
        out = compiled(m32, out)
    jax.block_until_ready(out.qpos)
    dt = time.perf_counter() - t0
    steps = NSTEPS - CHUNK
    _log(f"  steady rollout: {steps} steps in {dt:.3f} s = "
         f"{1e3 * dt / steps:.3f} ms/step, {NENV * steps / dt:.1f} "
         f"env-steps/s")
    stats = jax.devices()[0].memory_stats() or {}
    _log(f"  peak_bytes_in_use {stats.get('peak_bytes_in_use')}")
    for name in ("qpos", "qvel", "act", "qacc_warmstart", "ctrl"):
        x = np.asarray(getattr(out, name))
        if not np.isfinite(x).all():
            raise FloatingPointError(f"non-finite {name} after {NSTEPS} "
                                     f"steps")
    state.update(card_run=(compiled, m32), cpu_run=(c_cpu, m_cpu),
                 stirred=out)


def qpos_gaps(m, qa, qb):
    """Largest difference of two qpos batches (envs, nq) per class: joint
    angles (hinge and slide joints), free-body positions, and free-body
    rotations as the angle of the relative rotation."""
    import numpy as np

    qa, qb = np.asarray(qa, np.float64), np.asarray(qb, np.float64)
    free = np.asarray(m.jnt_qposadr)[np.asarray(m.jnt_type) == 0]
    pos = (free[:, None] + np.arange(3)).ravel()
    quat = free[:, None] + 3 + np.arange(4)
    joint = np.setdiff1d(np.arange(qa.shape[1]),
                         np.concatenate([pos, quat.ravel()]))
    a, b = qa[:, quat], qb[:, quat]
    a /= np.linalg.norm(a, axis=-1, keepdims=True)
    b /= np.linalg.norm(b, axis=-1, keepdims=True)
    # conj(a) * b = (a.b, wa vb - wb va - va x vb)
    w = (a * b).sum(-1)
    v = (a[..., :1] * b[..., 1:] - b[..., :1] * a[..., 1:]
         - np.cross(a[..., 1:], b[..., 1:]))
    rot = 2 * np.arctan2(np.linalg.norm(v, axis=-1), np.abs(w))
    gap = np.abs(qa - qb)
    return {"joint": float(gap[:, joint].max(initial=0.0)),
            "pos": float(gap[:, pos].max(initial=0.0)),
            "rot": float(rot.max(initial=0.0))}


def _fmt(gaps):
    return ", ".join(f"{k} {v:.3e}" for k, v in gaps.items())


def reference_phase(state):
    """Card vs CPU from the stirred state, with the planted fault as the
    control that the bounds must catch."""
    import jax
    import numpy as np

    card, m32 = state["card_run"]
    cpu_run, m_cpu = state["cpu_run"]
    start = state["stirred"]
    head = jax.tree.map(lambda x: x[:NREF], start)
    q_cpu = cpu_run(m_cpu, jax.device_put(head, jax.devices("cpu")[0])).qpos

    def gaps(m):
        return qpos_gaps(m32, np.asarray(card(m, start).qpos)[:NREF], q_cpu)

    got, ctl = gaps(m32), gaps(planted_fault(m32))
    _log(f"  reference: {NREF} envs x {CHUNK} steps from step {NSTEPS}, "
         f"card vs cpu: {_fmt(got)}; planted fault vs cpu: {_fmt(ctl)}; "
         f"bounds {_fmt(REF_BOUNDS)}")
    failures = [f"{k} {got[k]:.3e} > {b}" for k, b in REF_BOUNDS.items()
                if not got[k] <= b]
    failures += [f"planted fault {k} {ctl[k]:.3e} within {b}"
                 for k, b in REF_BOUNDS.items() if not ctl[k] > b]
    if failures:
        raise AssertionError("reference check: " + "; ".join(failures))


def served_phase():
    import numpy as np

    from mujoco_sim_tpu.io.client import SimClient
    from mujoco_sim_tpu.io.server import SimServer
    from mujoco_sim_tpu.runtime import config

    cfg = {"world": "tests/fixtures/empty_world.xml",
           "robots": {"sball": {"path": "tests/fixtures/spawn_ball.xml"}},
           "spawn_instances": 4}
    spec, m, sim, meta = config.build(cfg, base_dir=_REPO)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    srv = SimServer(sim, port=port, spec=spec, robots=meta)
    t0 = time.perf_counter()
    srv.start(run_sim=True)
    try:
        c = SimClient(port=port, timeout=600.0)
        names = []
        for i in range(3):
            ang = 2 * np.pi * i / 3
            pose = [0.6 * np.cos(ang), 0.6 * np.sin(ang), 0.5, 1, 0, 0, 0]
            got = c.spawn_objects([{"info": {"name": f"obj_{i}", "type": 1},
                                    "class": "sball", "pose": pose}])
            names.extend(got)
        if len(set(names)) != 3:
            raise AssertionError(f"spawn returned {names}")
        deadline = time.time() + 600
        while True:
            st = c.get_state(names)
            zs = [o["pose"]["position"][2] for o in st["objects"]]
            if len(zs) == 3 and max(zs) < 0.45:
                break
            if time.time() > deadline:
                raise TimeoutError(f"objects did not fall: {st}")
            time.sleep(0.2)
        _log(f"  served: 3 spawned and fallen after "
             f"{time.perf_counter() - t0:.1f} s (sim time {st['time']:.3f},"
             f" z {[round(z, 4) for z in zs]})")
        c.close()
        sub = SimClient(port=port, timeout=600.0)
        msgs = []
        for msg in sub.subscribe(["object_states"], rate=30):
            msgs.append(msg)
            if len(msgs) >= 3:
                break
        times = [mm["object_states"]["time"] for mm in msgs]
        if len(msgs) != 3 or times != sorted(times):
            raise AssertionError(f"stream messages out of order: {times}")
        streamed = {o["name"] for o in msgs[-1]["object_states"]["objects"]}
        if not set(names) <= streamed:
            raise AssertionError(f"stream lacks spawned objects: {streamed}")
        c = SimClient(port=port, timeout=600.0)
        states = c.destroy_objects(names)
        if len(states) != 3 or any(len(s["pose"]) != 7 for s in states):
            raise AssertionError(f"destroy returned {states}")
        after = c.get_state(names)
        if after["objects"]:
            raise AssertionError(f"destroyed objects still listed: {after}")
        c.close()
        _log(f"  served: stream times {times}; destroyed {names}")
    finally:
        srv.stop()


def four_cards():
    """Env mesh over 4 cards: make_sharded_rollout of the manip scene at
    4 x 4096 envs and the ppermute ring, against the same first 4096 envs
    rolled out on one card."""
    import jax
    import numpy as np

    import bench
    from mujoco_sim_tpu.parallel import mesh as pmesh

    devs = jax.devices()
    if len(devs) < 4:
        raise RuntimeError(f"--four needs 4 devices, JAX sees {len(devs)}")
    mesh = pmesh.make_env_mesh(devs[:4])
    _, m32, dB = bench.manip_rollout(4 * NENV, CHUNK)
    phase = jax.random.uniform(jax.random.PRNGKey(1), (4 * NENV, 6),
                               maxval=6.28)
    dB = dB.replace(ctrl=np.sin(np.asarray(phase)).astype(np.float32))
    mr = pmesh.replicate_model(m32, mesh)
    dS = jax.device_put(dB, jax.sharding.NamedSharding(
        mesh, jax.sharding.PartitionSpec("env")))
    ro4 = pmesh.make_sharded_rollout(mr, mesh, nsteps=CHUNK,
                                     full_final=False)
    ro1 = bench._rollout_fn(CHUNK)
    m1 = jax.device_put(m32, devs[0])
    d1 = jax.device_put(jax.tree.map(lambda x: x[:NENV], dB), devs[0])
    (c4, t4), (c1, t1) = bench.compile_all(ro4.lower(mr, dS),
                                           ro1.lower(m1, d1))
    _log(f"  compile (side by side): 4-card {t4:.1f} s, 1-card {t1:.1f} s")
    rates = {}
    for label, c, mm, dd, n in (("1-card", c1, m1, d1, NENV),
                                ("4-card", c4, mr, dS, 4 * NENV)):
        out = c(mm, dd)
        jax.block_until_ready(out.qpos)
        first = out
        t0 = time.perf_counter()
        for _ in range(NSTEPS // CHUNK - 1):
            out = c(mm, out)
        jax.block_until_ready(out.qpos)
        dt = time.perf_counter() - t0
        rates[label] = n * (NSTEPS - CHUNK) / dt
        if not np.isfinite(np.asarray(out.qpos)).all():
            raise FloatingPointError(f"{label}: non-finite qpos")
        _log(f"  {label}: {n} envs, {1e3 * dt / (NSTEPS - CHUNK):.3f} "
             f"ms/step, {rates[label]:.1f} env-steps/s")
        if label == "1-card":
            ref = np.asarray(first.qpos)
        else:
            err = np.abs(np.asarray(first.qpos)[:NENV] - ref).max()
            _log(f"  first {NENV} envs after {CHUNK} steps, 4-card vs "
                 f"1-card: max |dqpos| {err:.3e} (atol {FOUR_ATOL})")
            if not err <= FOUR_ATOL:
                raise AssertionError(f"4-card and 1-card disagree: {err:.3e}"
                                     f" > {FOUR_ATOL}")
            # every env's body-1 position tagged with its env index
            tag = np.broadcast_to(
                np.arange(4 * NENV, dtype=np.float32)[:, None, None],
                out.xpos.shape)
            probe = out.replace(xpos=jax.device_put(tag, dS.qpos.sharding))
            pos, _ = pmesh.exchange_body_state(probe, mesh, body_id=1)
            got = np.asarray(pos)
            want = np.roll(tag[:, 1], NENV, axis=0)
            if not np.array_equal(got, want):
                raise AssertionError("ppermute ring did not pass each "
                                     "shard's poses to its neighbour")
            _log("  exchange_body_state: ring shift of 4 shards checked")
    _log(f"  scaling: 4-card / 1-card rate = "
         f"{rates['4-card'] / rates['1-card']:.3f} (ideal 4)")


def main(argv):
    four = "--four" in argv
    sys.path.insert(0, _REPO)
    try:
        import bench
        from mujoco_sim_tpu.utils.cache import use_compile_cache
    except ImportError as e:
        _log(f"chip_smoke: the repository is not beside this script ({e})")
        return 2
    _log(f"card: {bench.card_info()}")
    ph = Phases()
    if not four:
        ph.run("gpu-tests", gpu_tests)
    import jax

    use_compile_cache()
    dev = device_phase()
    if four:
        ph.run("four-cards", four_cards)
    else:
        state = {}
        ph.run("rollout", rollout_phase, state)
        if "card_run" in state:
            ph.run("reference", reference_phase, state)
        else:
            ph.failed.append("reference (no rollout)")
        ph.run("served", served_phase)
    if ph.failed:
        _log(f"chip_smoke: FAILED phases {ph.failed}")
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
