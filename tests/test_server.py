"""Live service integration: the reference's test_spawn_and_destroy scenario
driven through the TCP JSON API (SURVEY §4 test drivers, made automated)."""

import os
import time

import numpy as np
import pytest

from mujoco_sim_tpu.engine import set_const
from mujoco_sim_tpu.models import scene
from mujoco_sim_tpu.models.compile import compile_spec
from mujoco_sim_tpu.runtime.sim import Simulation
from mujoco_sim_tpu.io.server import SimServer
from mujoco_sim_tpu.io.client import SimClient

EMPTY_WORLD = "tests/fixtures/empty_world.xml"

BALL_XML = "tests/fixtures/spawn_ball.xml"
PORT = 7591


@pytest.fixture(scope="module")
def server():
    world = scene.compose(
        EMPTY_WORLD,
        robots={"sball": scene.RobotConfig(path=BALL_XML)},
        instances=4,
    )
    m = set_const(compile_spec(world))
    sim = Simulation(m, spawnable={
        "sball": ["sball", "1_sball", "2_sball", "3_sball"]})
    srv = SimServer(sim, port=PORT, spec=world)
    srv.start(run_sim=True)
    yield srv
    srv.stop()


def test_spawn_destroy_roundtrip(server):
    c = SimClient(port=PORT)
    # ring positions like the reference driver (test_spawn_and_destroy.py)
    names = []
    for i in range(3):
        ang = 2 * np.pi * i / 3
        pose = [0.6 * np.cos(ang), 0.6 * np.sin(ang), 0.5, 1, 0, 0, 0]
        got = c.spawn_objects([{"info": {"name": f"obj_{i}", "type": 1},
                                "class": "sball", "pose": pose}])
        names.extend(got)
    assert len(names) == 3 and len(set(names)) == 3

    time.sleep(1.0)  # objects fall to the floor while sim thread runs
    state = c.get_state(names)
    zs = {o["name"]: o["pose"]["position"][2] for o in state["objects"]}
    assert len(zs) == 3
    for z in zs.values():
        assert z < 0.45  # fell

    # capacity guard: 4th slot free, 5th spawn must fail cleanly
    c.spawn_objects([{"info": {"name": "x", "type": 1}, "class": "sball",
                      "pose": [0, 0, 2, 1, 0, 0, 0]}])
    resp = c.call("spawn_objects",
                  objects=[{"info": {"name": "y", "type": 1},
                            "class": "sball",
                            "pose": [0, 0, 3, 1, 0, 0, 0]}])
    assert "error" in resp

    states = c.destroy_objects(names)
    assert len(states) == 3
    for st in states:
        assert len(st["pose"]) == 7
    c.close()


def test_stream_and_cmd(server):
    c = SimClient(port=PORT)
    got = []
    for msg in c.subscribe(["object_states", "joint_states"], rate=30):
        got.append(msg)
        if len(got) >= 3:
            break
    assert "object_states" in got[0]
    times = [m["object_states"]["time"] for m in got]
    assert times[-1] >= times[0]


def test_screenshot_service(server, tmp_path):
    c = SimClient(port=PORT)
    resp = c.screenshot(out_dir=str(tmp_path), name="snap")
    assert resp["success"]
    files = resp["files"]
    assert os.path.exists(files["xml"])
    assert os.path.exists(files["state"])
    assert os.path.exists(files["data_txt"])
    # snapshot must be loadable by our own compiler
    from mujoco_sim_tpu.models.compile import load_model
    m2 = load_model(files["xml"])
    assert m2.nbody >= 2
    c.close()


def test_checkpoint_roundtrip(tmp_path):
    import jax
    from mujoco_sim_tpu import engine
    from mujoco_sim_tpu.models.compile import load_model
    from mujoco_sim_tpu.runtime.checkpoint import save_state, load_state

    m = load_model("tests/fixtures/floor_ball.xml")
    d = engine.make_data(m)
    step = jax.jit(engine.step)
    for _ in range(50):
        d = step(m, d)
    p = str(tmp_path / "ck.npz")
    save_state(d, p)
    d2, meta = load_state(m, p)
    np.testing.assert_array_equal(np.asarray(d.qpos), np.asarray(d2.qpos))
    np.testing.assert_array_equal(np.asarray(d.qacc_warmstart),
                                  np.asarray(d2.qacc_warmstart))
    # resumed trajectory identical to uninterrupted one
    d_a = step(m, d)
    d_b = step(m, d2)
    np.testing.assert_array_equal(np.asarray(d_a.qpos), np.asarray(d_b.qpos))


def test_live_viewer_headless(server):
    """LiveViewer consumes the markers stream and renders frames; keyboard
    spawn handler drives the spawn service (mj_main.cpp:40-46 parity)."""
    import types
    from mujoco_sim_tpu.viz.live import LiveViewer

    out = "/tmp/live_viewer_test"
    v = LiveViewer(port=PORT, rate=30.0, interactive=False, out_dir=out,
                   spawn_classes={"s": ("sball", 1)})
    try:
        n = v.run(max_frames=3)
        assert n == 3
        import glob
        assert len(glob.glob(out + "/live_*.png")) >= 3
        # keyboard spawn ('s' = sphere) goes through the live service
        before = len(v.spawned)
        v._on_key(types.SimpleNamespace(key="s"))
        assert len(v.spawned) == before + 1
        v._on_key(types.SimpleNamespace(key="x"))
        assert len(v.spawned) == before
    finally:
        v.close()


def test_per_class_publisher_rates():
    """Per-object-class rate config (robot.yaml:62-92): world bodies at rate
    0 are never published; spawned objects stream at their own rate."""
    import json
    import socket

    world = scene.compose(
        EMPTY_WORLD,
        robots={"sball": scene.RobotConfig(path=BALL_XML)},
        instances=2)
    m = set_const(compile_spec(world))
    sim = Simulation(m, spawnable={"sball": ["sball", "1_sball"]})
    srv = SimServer(sim, port=PORT + 7, spec=world, pub_config={
        "pub_object_state_array": {"free_bodies_only": False,
                                   "robot_bodies_rate": 0.0,
                                   "world_bodies_rate": 0.0,
                                   "spawned_object_bodies_rate": 60.0}})
    srv.start(run_sim=False)
    try:
        public = sim.spawn("sball", "streamball",
                           pose=np.array([0, 0, 0.5, 1, 0, 0, 0]))
        c = SimClient(port=PORT + 7)
        got = []
        for msg in c.subscribe(["object_states"], rate=60.0):
            if "object_states" in msg:
                got.append(msg["object_states"]["objects"])
            if len(got) >= 3:
                break
        c.close()
        names = {o["name"] for objs in got for o in objs}
        assert public in names                 # spawned class streams
        # every streamed body belongs to the spawned class (world/robot
        # classes are at rate 0)
        for n in names:
            slot = sim.by_public_name.get(n)
            bid = (slot.root_body if slot is not None
                   else m.names.body_id(n))
            assert srv._body_class[bid] == "spawned", (n, bid)
    finally:
        srv.stop()


def test_spawn_with_size_rgba_over_tcp(server):
    """ObjectInfo.size/rgba/inertial travel through the TCP spawn service
    into Data-resident geometry (mj_ros.cpp:941-966 parity end-to-end)."""
    c = SimClient(port=PORT)
    names = c.spawn_objects([{
        "info": {"name": "bigball", "type": 1, "size": [0.17, 0, 0],
                 "rgba": [0.9, 0.1, 0.2, 1.0],
                 "inertial": {"m": 2.5, "ixx": 0.03, "iyy": 0.03,
                              "izz": 0.03}},
        "class": "sball",
        "pose": [0, 0.9, 0.6, 1, 0, 0, 0]}])
    assert len(names) == 1
    sim = server.sim
    slot = sim.by_public_name[names[0]]
    g = int(slot.geoms[0])
    assert abs(float(sim.d.geom_size[g, 0]) - 0.17) < 1e-6
    np.testing.assert_allclose(np.asarray(sim.d.geom_rgba[g]),
                               [0.9, 0.1, 0.2, 1.0], atol=1e-6)
    assert abs(float(sim.d.body_mass[slot.root_body]) - 2.5) < 1e-6
    # settles at its requested radius (sim thread is stepping)
    deadline = time.time() + 60
    z = None
    while time.time() < deadline:
        time.sleep(0.5)
        z = float(sim.d.qpos[slot.qpos_adr + 2])
        if abs(z - 0.17) < 0.02:
            break
    assert z is not None and abs(z - 0.17) < 0.02, z
    c.destroy_objects(names)
    c.close()


def test_runtime_unregistered_asset_spawn(tmp_path):
    """Spawning a NEVER-registered scene XML on a live server succeeds via
    the recompile-and-transplant slow path (reference add_old_state
    contract, mj_sim.cpp:465-558; service behavior mj_ros.cpp:1340-1363):
    survivors' qpos/qvel/qacc_warmstart are BIT-preserved across the
    model swap, and the registered-class fast path keeps working."""
    world = scene.compose(
        EMPTY_WORLD,
        robots={"sball": scene.RobotConfig(path=BALL_XML)},
        instances=2)
    m = set_const(compile_spec(world))
    sim = Simulation(m, spawnable={"sball": ["sball", "1_sball"]})
    srv = SimServer(sim, port=PORT + 23, spec=world,
                    asset_dirs=[str(tmp_path)])
    srv.start(run_sim=False)
    try:
        c = SimClient(port=PORT + 23)
        n0 = c.spawn_objects([{"info": {"name": "ball0", "type": 1},
                               "class": "sball",
                               "pose": [0.3, 0, 0.4, 1, 0, 0, 0]}])
        sim.step(8)   # in flight: nonzero qvel + warmstart
        old_m = sim.m

        def snap(jn):
            lay = sim.m.layout
            j = sim.m.names.joint_id(jn)
            qa, da = int(lay.jnt_qposadr[j]), int(lay.jnt_dofadr[j])
            return (np.asarray(sim.d.qpos[qa:qa + 7]).copy(),
                    np.asarray(sim.d.qvel[da:da + 6]).copy(),
                    np.asarray(sim.d.qacc_warmstart[da:da + 6]).copy())

        ball_jnt = old_m.names.joint[
            sim.by_public_name[n0[0]].free_jnt]
        before = snap(ball_jnt)

        with open(tmp_path / "cup.xml", "w") as f:
            f.write("""
<mujoco model="cup">
  <worldbody>
    <body name="cup" pos="0 0 0.3">
      <freejoint/>
      <geom type="box" size=".05 .05 .08" mass="0.3"/>
    </body>
  </worldbody>
</mujoco>""")
        names = c.spawn_objects([{
            "info": {"name": "mycup", "type": 3, "mesh": "cup.xml"},
            "pose": [0, 0.5, 0.8, 1, 0, 0, 0]}])
        assert len(names) == 1
        assert sim.m is not old_m          # model swapped
        assert "cup" in sim.slots

        after = snap(ball_jnt)
        for b, a in zip(before, after):
            np.testing.assert_array_equal(b, a)   # BIT-preserved

        # the new object simulates (falls)
        z0 = float(sim.d.qpos[
            sim.by_public_name[names[0]].qpos_adr + 2])
        sim.step(30)
        z1 = float(sim.d.qpos[
            sim.by_public_name[names[0]].qpos_adr + 2])
        assert z1 < z0

        # fast path after the swap: registered class + second runtime
        # instance both spawn without another recompile
        m_now = sim.m
        more = c.spawn_objects(
            [{"info": {"name": "ball1", "type": 1}, "class": "sball",
              "pose": [-0.3, 0, 0.4, 1, 0, 0, 0]},
             {"info": {"name": "cup2", "type": 3, "mesh": "cup.xml"},
              "pose": [0, -0.5, 0.8, 1, 0, 0, 0]}])
        assert len(more) == 2
        assert sim.m is m_now              # no recompile
        c.destroy_objects(n0 + names + more)
        c.close()
    finally:
        srv.stop()


def test_named_sensor_stream():
    """The sensors topic names every sensor and carries its value slice
    (reference publishes named 3-D FORCE/TORQUE vectors per sensor,
    mj_ros.cpp:1933-1966; VERDICT r4 #7)."""
    import jax
    from mujoco_sim_tpu import engine
    from mujoco_sim_tpu.models.compile import load_model

    xml = "tests/fixtures/force_sensor_srv.xml"
    if not os.path.exists(xml):
        with open(xml, "w") as f:
            f.write("""
<mujoco model="fsense">
  <worldbody>
    <body name="blk" pos="0 0 0.5">
      <geom type="box" size=".1 .1 .1" mass="2"/>
      <site name="s" pos="0 0 0"/>
    </body>
    <body name="faller" pos="1 0 2">
      <freejoint/>
      <geom type="sphere" size=".05" mass="0.1"/>
    </body>
  </worldbody>
  <sensor>
    <force name="f_blk" site="s"/>
    <torque name="t_blk" site="s"/>
    <clock name="clk"/>
  </sensor>
</mujoco>""")
    m = load_model(xml)
    sim = Simulation(m)
    step = jax.jit(engine.step)
    for _ in range(20):
        sim.d = step(m, sim.d)
    srv = SimServer(sim, port=PORT + 11)
    srv.start(run_sim=False)
    try:
        c = SimClient(port=PORT + 11)
        msg = next(iter(c.subscribe(["sensors"], rate=30.0)))
        c.close()
        named = msg["sensors"]["sensors"]
        assert set(named) == {"f_blk", "t_blk", "clk"}
        assert len(named["f_blk"]) == 3 and len(named["t_blk"]) == 3
        assert len(named["clk"]) == 1
        # the weight of the resting block shows up on the force sensor
        assert abs(abs(named["f_blk"][2]) - 2 * 9.81) < 0.5, named["f_blk"]
        # named slices tile the flat sensordata exactly
        flat = msg["sensors"]["sensordata"]
        assert named["f_blk"] + named["t_blk"] + named["clk"] == flat
    finally:
        srv.stop()


def test_spawn_by_mesh_path_bridge(server):
    """The reference's spawn accepts mesh paths (mj_ros.cpp:1340-1363);
    static shapes resolve the path by basename against the classes
    registered at compile, and unregistered paths error with guidance
    instead of silently mapping to a class name."""
    c = SimClient(port=PORT)
    got = c.spawn_objects([{
        "info": {"name": "meshspawn", "type": 3,
                 "mesh": "../model/objects/sball.xml"},
        "pose": [0, 0, 1.5, 1, 0, 0, 0]}])
    assert len(got) == 1
    c.destroy_objects(got)

    resp = c.call("spawn_objects", objects=[{
        "info": {"name": "nope", "type": 3,
                 "mesh": "../test/cup.xml"},
        "pose": [0, 0, 1, 1, 0, 0, 0]}])
    assert "error" in resp
    assert "registered spawn class" in resp["error"]
    assert "spawnable" in resp["error"]
    c.close()
