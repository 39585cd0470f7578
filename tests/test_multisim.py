"""Multi-instance coupling: mocap '_ref' twins + weld sync (SURVEY §2.5)."""

import jax
import jax.numpy as jnp
import numpy as np

from mujoco_sim_tpu import engine
from mujoco_sim_tpu.engine import set_const
from mujoco_sim_tpu.models import scene, mjcf
from mujoco_sim_tpu.models.compile import compile_spec

EMPTY_WORLD = "tests/fixtures/empty_world.xml"


def make_ref_model():
    world = scene.compose(
        EMPTY_WORLD,
        robots={"sball": scene.RobotConfig(path="tests/fixtures/spawn_ball.xml")},
    )
    scene.add_reference_bodies(world, ["sball"], torquescale=0.9)
    return set_const(compile_spec(world))


def test_mocap_ref_weld_drags_body():
    m = make_ref_model()
    assert m.nmocap == 1
    rid = m.names.body_id("sball_ref")
    bid = m.names.body_id("sball")
    assert rid >= 0 and bid >= 0
    assert int(m.body_mocapid[rid]) == 0
    assert m.neq == 1

    d = engine.make_data(m)
    # drive the mocap twin to a target above the floor; gravity disabled by
    # the weld pulling the ball up to it
    target = jnp.asarray([0.4, -0.2, 0.6])
    d = d.replace(mocap_pos=d.mocap_pos.at[0].set(target))

    @jax.jit
    def roll(m_, d_, n):
        return jax.lax.fori_loop(0, n, lambda i, dd: engine.step(m_, dd), d_)

    d = roll(m, d, 600)
    pos = np.asarray(d.xpos[bid])
    np.testing.assert_allclose(pos, np.asarray(target), atol=0.05)
    # ref body itself is exactly at the mocap pose
    np.testing.assert_allclose(np.asarray(d.xpos[rid]), np.asarray(target),
                               atol=1e-12)


def test_mocap_ref_contact_free():
    """Ref twins must not collide with anything (contype 0 + excludes)."""
    m = make_ref_model()
    lay = m.layout
    rid = m.names.body_id("sball_ref")
    for a, b in zip(lay.pair_geom1, lay.pair_geom2):
        assert lay.geom_bodyid[a] != rid and lay.geom_bodyid[b] != rid
