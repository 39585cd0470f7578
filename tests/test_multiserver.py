"""Cross-process send/receive sync: two SimServers coupled over the TCP
surface, the reference's multi-instance mode (launch/multi_mujoco_sim.launch,
src/config/sim_1.yaml send:/receive:, MjSim::init_references
mj_sim.cpp:847-960).  Sim A publishes body state; sim B applies it to the
'<name>_ref' mocap twin whose weld drags the local body (VERDICT r1 #6)."""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mujoco_sim_tpu.engine import set_const
from mujoco_sim_tpu.models import scene
from mujoco_sim_tpu.models.compile import compile_spec
from mujoco_sim_tpu.runtime.sim import Simulation
from mujoco_sim_tpu.io.server import SimServer

EMPTY_WORLD = "tests/fixtures/empty_world.xml"

PORT_A, PORT_B = 7611, 7612
CUBE_XML = "tests/fixtures/sync_cube.xml"


def _make_world(with_receive: bool):
    with open(CUBE_XML, "w") as f:
        f.write("""
<mujoco model="cube">
  <worldbody>
    <body name="cube" pos="0 0 0.2">
      <freejoint/>
      <geom type="box" size=".1 .1 .1" mass="1"/>
    </body>
  </worldbody>
</mujoco>""")
    spec = scene.compose(
        EMPTY_WORLD,
        robots={"cube": scene.RobotConfig(path=CUBE_XML)})
    if with_receive:
        spec = scene.add_reference_bodies(spec, ["cube"])
    return spec, set_const(compile_spec(spec))


def test_send_receive_weld_sync():
    spec_a, m_a = _make_world(with_receive=False)
    spec_b, m_b = _make_world(with_receive=True)
    sim_a = Simulation(m_a)
    sim_b = Simulation(m_b)

    srv_a = SimServer(sim_a, port=PORT_A, spec=spec_a)
    srv_b = SimServer(sim_b, port=PORT_B, spec=spec_b,
                      receive={"cube": ["position", "quaternion"]},
                      peer=("127.0.0.1", PORT_A), receive_rate=120.0)
    srv_a.start(run_sim=True)
    srv_b.start(run_sim=True)
    try:
        # wait until both sims finished their first jit compile and stepped
        deadline = time.time() + 180.0
        while time.time() < deadline and (
                float(sim_a.d.time) < 0.05 or float(sim_b.d.time) < 0.05):
            time.sleep(0.3)
        assert float(sim_a.d.time) > 0 and float(sim_b.d.time) > 0
        # drag the cube in sim A sideways (the reference drags via mouse /
        # external pose set; here we teleport its freejoint)
        with srv_a._lock:
            d = sim_a.d
            q = d.qpos.at[0].set(0.5).at[1].set(0.3)
            sim_a.d = d.replace(qpos=q, qvel=jnp.zeros_like(d.qvel))
        # wait for B's welded twin to drag the local body over
        deadline = time.time() + 30.0
        got = None
        while time.time() < deadline:
            time.sleep(0.3)
            bid = m_b.names.body_id("cube")
            got = np.asarray(sim_b.d.xpos[bid])
            if abs(got[0] - 0.5) < 0.08 and abs(got[1] - 0.3) < 0.08:
                break
        assert got is not None
        assert abs(got[0] - 0.5) < 0.08 and abs(got[1] - 0.3) < 0.08, got
    finally:
        srv_b.stop()
        srv_a.stop()
