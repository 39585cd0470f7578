"""Masked-slot spawn/destroy: the reference service contract without reload.

Mirrors test/test_spawn_and_destroy.py scenarios (reference) on the padded
slot architecture: survivors' state preserved exactly, spawn atomic, destroy
returns final state, names auto-uniqued.
"""

import jax
import numpy as np

from mujoco_sim_tpu import engine
from mujoco_sim_tpu.engine import set_const
from mujoco_sim_tpu.models import scene
from mujoco_sim_tpu.models.compile import compile_spec
from mujoco_sim_tpu.runtime.sim import Simulation, NameAllocator

EMPTY_WORLD = "tests/fixtures/empty_world.xml"

BALL_XML = "tests/fixtures/spawn_ball.xml"


def make_sim():
    world = scene.compose(
        EMPTY_WORLD,
        robots={"sball": scene.RobotConfig(path=BALL_XML)},
        instances=3,
    )
    m = set_const(compile_spec(world))
    spawnable = {"sball": ["sball", "1_sball", "2_sball"]}
    return Simulation(m, spawnable=spawnable)


def test_spawn_destroy_preserves_survivors():
    sim = make_sim()
    # all slots initially inactive -> nothing moves
    sim.step(10)
    assert not bool(sim.d.body_active[1:].any())

    n1 = sim.spawn("sball", "ballA",
                   pose=np.array([0.5, 0, 0.5, 1, 0, 0, 0]))
    sim.step(100)  # falls and lands
    slotA = sim.by_public_name[n1]
    zA = float(sim.d.qpos[slotA.qpos_adr + 2])
    assert abs(zA - 0.1) < 0.02, zA

    stateA_before = np.asarray(
        sim.d.qpos[slotA.qpos_adr:slotA.qpos_adr + 7]).copy()
    # spawn a second object elsewhere; survivor A must be untouched
    n2 = sim.spawn("sball", "ballB",
                   pose=np.array([-0.5, 0.3, 0.8, 1, 0, 0, 0]))
    stateA_after = np.asarray(
        sim.d.qpos[slotA.qpos_adr:slotA.qpos_adr + 7])
    np.testing.assert_array_equal(stateA_before, stateA_after)

    sim.step(100)
    slotB = sim.by_public_name[n2]
    zB = float(sim.d.qpos[slotB.qpos_adr + 2])
    assert abs(zB - 0.1) < 0.02, zB

    # destroy A: returns final state; B keeps evolving normally
    final = sim.destroy(n1)
    assert abs(final["pose"][2] - 0.1) < 0.02
    stateB = np.asarray(sim.d.qpos[slotB.qpos_adr:slotB.qpos_adr + 7]).copy()
    sim.step(5)
    stateB2 = np.asarray(sim.d.qpos[slotB.qpos_adr:slotB.qpos_adr + 7])
    # B near rest: still micro-settling in the soft contact
    np.testing.assert_allclose(stateB, stateB2, atol=5e-3)

    # slot reuse after destroy
    n3 = sim.spawn("sball", "ballC", pose=np.array([0, -0.5, 0.5, 1, 0, 0, 0]))
    assert sim.by_public_name[n3] is slotA or sim.by_public_name[n3] is not None


def test_no_retrace_across_spawn():
    """The jitted step must not retrace when slots toggle (SURVEY §3.3)."""
    sim = make_sim()
    step = jax.jit(engine.step)
    d1 = step(sim.m, sim.d)
    compiles_before = step._cache_size()
    sim.spawn("sball", pose=np.array([0.4, 0, 0.5, 1, 0, 0, 0]))
    d2 = step(sim.m, sim.d)
    assert step._cache_size() == compiles_before


def test_name_allocator_semantics():
    alloc = NameAllocator(existing={"cube_0"})
    a = alloc.allocate("cube")     # cube_0 taken -> bumps
    assert a != "cube_0" and a.startswith("cube")
    b = alloc.allocate("cube")
    assert b != a
    alloc.release(a)
    c = alloc.allocate("cube")
    assert c not in (b,)


_PRIM_GEOM = {"cube": '<geom type="box" size=".05 .05 .05" mass="1"/>',
              "sphere": '<geom type="sphere" size=".05" mass="1"/>',
              "cylinder": '<geom type="cylinder" size=".05 .05" mass="1"/>'}


def make_prim_sim(instances=2):
    """cube/sphere/cylinder spawn classes like the reference driver
    (test/test_spawn_and_destroy.py:29-45 spawns random-size primitives)."""
    robots = {}
    for cls, geom in _PRIM_GEOM.items():
        path = f"tests/fixtures/spawn_{cls}.xml"
        with open(path, "w") as f:
            f.write(f"""
<mujoco model="{cls}">
  <worldbody>
    <body name="{cls}" pos="0 0 0.5"><freejoint/>{geom}</body>
  </worldbody>
</mujoco>""")
        robots[cls] = scene.RobotConfig(path=path)
    world = scene.compose(EMPTY_WORLD,
                          robots=robots, instances=instances)
    m = set_const(compile_spec(world))
    spawnable = {}
    for cls in _PRIM_GEOM:
        roots = [n for n in m.names.body
                 if n == cls or n.endswith("_" + cls)]
        spawnable[cls] = sorted(roots)
    return Simulation(m, spawnable=spawnable)


def test_spawn_request_geometry():
    """Request-specified size/rgba/inertial take effect with zero retrace
    (reference builds the geom from ObjectInfo, mj_ros.cpp:941-966)."""
    rng = np.random.default_rng(10)  # the reference driver seeds 10
    sim = make_prim_sim()
    step = jax.jit(engine.step)
    d0 = step(sim.m, sim.d)
    compiles = step._cache_size()

    lay = sim.m.layout
    expected = []
    for i, (cls, half_height) in enumerate(
            [("cube", None), ("sphere", None), ("cylinder", None)]):
        s = float(rng.uniform(0.04, 0.12))
        size = {"cube": [s, s, s], "sphere": [s, 0, 0],
                "cylinder": [s, s, 0]}[cls]
        rgba = rng.uniform(0, 1, 4).tolist()
        name = sim.spawn(cls, f"obj_{cls}",
                         pose=np.array([i * 0.8, 0, 0.4, 1, 0, 0, 0]),
                         size=np.asarray(size), rgba=np.asarray(rgba))
        slot = sim.by_public_name[name]
        g = int(slot.geoms[0])
        np.testing.assert_allclose(np.asarray(sim.d.geom_size[g])[:len(size)],
                                   size, atol=1e-6)
        np.testing.assert_allclose(np.asarray(sim.d.geom_rgba[g]), rgba,
                                   atol=1e-6)
        # density-derived mass: sphere 4/3 pi r^3 * 1000
        mass = float(sim.d.body_mass[slot.root_body])
        if cls == "sphere":
            np.testing.assert_allclose(mass, 4 / 3 * np.pi * s**3 * 1000,
                                       rtol=1e-5)
        expected.append((name, slot, s))

    for _ in range(150):
        sim.d = step(sim.m, sim.d)
    assert step._cache_size() == compiles  # zero retrace (SURVEY §3.3)

    # each object settles resting on the floor at its own size
    for name, slot, s in expected:
        z = float(sim.d.qpos[slot.qpos_adr + 2])
        assert abs(z - s) < 0.02, (name, z, s)

    # destroy restores compiled defaults for the slot
    g0 = int(expected[0][1].geoms[0])
    sim.destroy(expected[0][0])
    np.testing.assert_allclose(np.asarray(sim.d.geom_size[g0]),
                               np.asarray(sim.m.geom_size)[g0], atol=1e-6)


def test_spawn_inertial_override():
    sim = make_prim_sim()
    name = sim.spawn("cube", "heavy", pose=np.array([0, 0, 0.3, 1, 0, 0, 0]),
                     size=np.array([0.05, 0.05, 0.05]),
                     inertial={"m": 7.5, "ixx": 0.1, "iyy": 0.1, "izz": 0.1})
    slot = sim.by_public_name[name]
    assert abs(float(sim.d.body_mass[slot.root_body]) - 7.5) < 1e-6
    np.testing.assert_allclose(np.asarray(
        sim.d.body_inertia[slot.root_body]), [0.1, 0.1, 0.1], atol=1e-6)
    sim.step(50)
    assert np.isfinite(np.asarray(sim.d.qpos)).all()
