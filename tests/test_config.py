"""YAML config layer (runtime/config.py) — the reference's rosparam
pipeline equivalent (launch -> robot.yaml -> MjRos::set_params)."""

import os

import numpy as np

from mujoco_sim_tpu.runtime import config as RC

BOT = "tests/fixtures/cfgbot.xml"


def setup_module():
    os.makedirs("tests/fixtures", exist_ok=True)
    with open(BOT, "w") as f:
        f.write("""
<mujoco model="cfgbot">
  <worldbody>
    <body name="cfgbot" pos="0 0 0.15">
      <geom type="box" size=".2 .15 .05" mass="8"/>
      <body name="lift" pos="0 0 0.1">
        <joint name="lift_joint" type="slide" axis="0 0 1" damping="2"/>
        <geom type="box" size=".05 .05 .1" mass="1"/>
        <body name="head" pos="0 0 0.15">
          <joint name="pan_joint" type="hinge" axis="0 0 1" damping="1"/>
          <geom type="sphere" size=".05" mass="0.5"/>
        </body>
      </body>
    </body>
  </worldbody>
</mujoco>""")


def _build(yaml_text, tmp_path):
    p = tmp_path / "scene.yaml"
    p.write_text(yaml_text)
    cfg = RC.load_config(str(p))
    return RC.build(cfg, base_dir=os.getcwd())


def test_build_single_robot_shorthand(tmp_path):
    spec, m, sim, meta = _build("""
world: tests/fixtures/empty_world.xml
robot: tests/fixtures/cfgbot.xml
add_odom_joints:
  cfgbot: true
""", tmp_path)
    assert "cfgbot" in meta
    assert "odom" in meta["cfgbot"]
    joints = meta["cfgbot"]["joints"]
    assert "lift_joint" in joints and "pan_joint" in joints
    assert not any(j.endswith("_odom_x_joint") for j in joints)


def test_controller_claims_and_custom_type(tmp_path):
    """Controller claims narrow the controlled joints: standard
    position/velocity/effort types always claim; custom_controller_type
    allowlists one extra type substring (mj_ros.cpp:456-458,640-666;
    robot.yaml:60 'diff_drive_controller/DiffDriveController')."""
    base = """
world: tests/fixtures/empty_world.xml
robots:
  cfgbot:
    path: tests/fixtures/cfgbot.xml
    controllers:
      arm:
        type: position_controllers/JointTrajectoryController
        joints: [lift_joint]
      base:
        type: diff_drive_controller/DiffDriveController
        joints: [pan_joint]
"""
    # without the custom allowlist, only the standard controller claims
    spec, m, sim, meta = _build(base, tmp_path)
    assert meta["cfgbot"]["joints"] == ["lift_joint"]

    spec, m, sim, meta = _build(
        base + "custom_controller_type: diff_drive_controller\n", tmp_path)
    assert sorted(meta["cfgbot"]["joints"]) == [
        "lift_joint", "pan_joint"]


def test_reference_example_config_builds():
    spec, m, sim, meta = RC.build(
        RC.load_config("examples/config/mobile_scene.yaml"),
        base_dir="examples/config")
    assert m.nbody > 1 and meta
