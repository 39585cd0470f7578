#!/usr/bin/env python3
"""Joint position command publisher (in-process).

Equivalent of model/ontology/script/joint_position_command_publisher.py +
the box_scenario controller demo (reference launch
model/ontology/box_scenario.launch): PD computed-torque position control of
the box flaps, driven to a sequence of setpoints.

Usage:  python examples/joint_position_commands.py <box.xml>
where <box.xml> is the reference stack's model/test/box.xml (the box with
two hinged flaps, not shipped in this repository).
"""

import os
import sys

import numpy as np

sys.path.insert(0, ".")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mujoco_sim_tpu import engine  # noqa: E402
from mujoco_sim_tpu.engine import set_const  # noqa: E402
from mujoco_sim_tpu.models import scene  # noqa: E402
from mujoco_sim_tpu.models.compile import compile_spec  # noqa: E402
from mujoco_sim_tpu.control import controllers as C  # noqa: E402


def main():
    # box resting on the world floor, like the box_scenario launch
    if len(sys.argv) != 2:
        raise SystemExit(__doc__)
    world = scene.compose(
        os.path.join("tests", "fixtures", "empty_world.xml"),
        robots={"box": scene.RobotConfig(
            path=sys.argv[1],
            pose_init=np.array([0.0, 0.0, 0.172, 0, 0, 0]))})
    m = set_const(compile_spec(world))
    d = engine.make_data(m)

    # settle on the floor first (on-device loop: one dispatch instead of
    # one per step)
    @jax.jit
    def roll(m_, d_, n):
        return jax.lax.fori_loop(0, n, lambda i, dd: engine.step(m_, dd), d_)

    d = roll(m, d, 300)
    joints = ["box_flap_side_1_joint", "box_flap_side_2_joint"]
    cfg = C.pd_config_for_joints(m, joints, kp=5.0, kd=0.8)
    st = C.make_pd_state(m)

    def ctrl(m_, d_, st_, qdes):
        st2 = C.pd_accel(cfg, st_, d_, qdes, m_.opt.timestep)
        return C.apply_control(m_, d_, st2, cfg.ctrl_mask)

    lay = m.layout
    dofs = [int(lay.jnt_dofadr[m.names.joint_id(j)]) for j in joints]
    @jax.jit
    def run_target(m_, d_, st_, qdes):
        def body(i, carry):
            dd, ss = carry
            return engine.step_with_control(
                m_, dd, lambda a, b, c: ctrl(a, b, c, qdes), ss)
        return jax.lax.fori_loop(0, 600, body, (d_, st_))

    for target in (0.0, 0.8, -0.4, 0.0):
        qdes = jnp.zeros(m.nv).at[jnp.asarray(dofs)].set(target)
        d, st = run_target(m, d, st, qdes)
        got = [float(d.qpos[lay.jnt_qposadr[m.names.joint_id(j)]])
               for j in joints]
        print(f"target {target:+.2f} -> flaps "
              f"{got[0]:+.3f} {got[1]:+.3f}")


if __name__ == "__main__":
    main()
