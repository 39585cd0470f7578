"""YAML config -> composed scene + Simulation + SimServer (layer L9).

Equivalent of the reference's rosparam pipeline: launch args -> YAML
(src/config/robot.yaml) -> MjRos::set_params/init (mj_ros.cpp:212-567).
Schema mirrors the reference keys: robot(s), world, pose_init,
add_odom_joints (bool or per-joint map, mj_ros.cpp:317-373), disable_gravity,
joint_inits, spawn capacity, server host/port, pub rates.
"""

from __future__ import annotations

import os
from typing import Any

import numpy as np

from mujoco_sim_tpu.engine import set_const
from mujoco_sim_tpu.models import scene
from mujoco_sim_tpu.models.compile import compile_spec
from mujoco_sim_tpu.runtime.sim import Simulation


def _odom_map(v: Any) -> dict:
    """bool-or-map schema of add_odom_joints (mj_ros.cpp:317-373).

    bool true = the reference's default mobile-base set (lin_x, lin_y,
    ang_z; src/config/robot.yaml:24)."""
    keys = ["lin_odom_x_joint", "lin_odom_y_joint", "lin_odom_z_joint",
            "ang_odom_x_joint", "ang_odom_y_joint", "ang_odom_z_joint"]
    if isinstance(v, bool):
        default_on = {"lin_odom_x_joint", "lin_odom_y_joint",
                      "ang_odom_z_joint"}
        return {k: (v and k in default_on) for k in keys}
    if isinstance(v, dict):
        return {k: bool(v.get(k, False)) for k in keys}
    return {}


def load_config(path: str) -> dict:
    # PyYAML only for YAML files: build(dict) and the server need no more
    # than numpy, scipy and JAX
    import yaml

    with open(path) as f:
        cfg = yaml.safe_load(f) or {}
    return cfg


def build(cfg: dict | str, base_dir: str = "."):
    """Config -> (spec, model, Simulation, robot meta for SimServer)."""
    if isinstance(cfg, str):
        base_dir = os.path.dirname(os.path.abspath(cfg))
        cfg = load_config(cfg)

    world = cfg.get("world")
    if world is None:
        raise ValueError("config needs a 'world' MJCF path")
    world = os.path.join(base_dir, world)

    robots_cfg = cfg.get("robots") or {}
    if "robot" in cfg:  # single-robot shorthand like the reference ~robot
        name = os.path.splitext(os.path.basename(cfg["robot"]))[0]
        robots_cfg = {name: {"path": cfg["robot"], **cfg.get(name, {})}}

    robot_cfgs = {}
    for name, rc in robots_cfg.items():
        pose_init = rc.get("pose_init") or cfg.get("pose_init", {}).get(name)
        robot_cfgs[name] = scene.RobotConfig(
            path=os.path.join(base_dir, rc["path"]),
            pose_init=np.asarray(pose_init, float) if pose_init else None,
            add_odom_joints=_odom_map(
                rc.get("add_odom_joints",
                       cfg.get("add_odom_joints", {}).get(name, False))),
            disable_gravity=bool(rc.get("disable_gravity",
                                        cfg.get("disable_gravity", False))),
            joint_inits=rc.get("joint_inits",
                               cfg.get("joint_inits", {}).get(name, {})),
        )

    instances = int(cfg.get("spawn_instances", 1))
    spec = scene.compose(world, robots=robot_cfgs, instances=instances)
    # multi-instance coupling: receive-side '_ref' mocap twins
    # (src/config/sim_1.yaml receive:, MjSim::init_references)
    receive = cfg.get("receive") or {}
    if receive:
        spec = scene.add_reference_bodies(spec, list(receive))
    m = set_const(compile_spec(spec, ncon_budget=cfg.get("ncon_budget")))

    spawnable = {}
    if instances > 1:
        for name in robot_cfgs:
            spawnable[name] = [name] + [f"{i}_{name}"
                                        for i in range(1, instances)]
    sim = Simulation(m, spawnable=spawnable or None)
    joint_inits = {}
    for name, rc in robot_cfgs.items():
        joint_inits.update(rc.joint_inits)
    sim.set_joint_inits(joint_inits)

    from mujoco_sim_tpu.control.controllers import odom_config
    robots_meta = {}
    for name, rc in robot_cfgs.items():
        meta = {"joints": [jn for jn in m.names.joint
                           if not jn.endswith("_odom_x_joint")
                           and not jn.endswith("_odom_y_joint")
                           and not jn.endswith("_odom_z_joint")]}
        # controller claims narrow the controlled-joint set, mirroring the
        # reference's controller_manager scan: standard
        # position/velocity/effort controller types always claim their
        # joints; `custom_controller_type` allowlists one extra type
        # substring (mj_ros.cpp:456-458,640-666; robot.yaml:60)
        controllers = robots_cfg[name].get(
            "controllers", cfg.get("controllers", {}).get(name))
        if controllers:
            custom = str(cfg.get("custom_controller_type", ""))
            claimed = []
            for cc in controllers.values():
                ctype = str(cc.get("type", ""))
                ok = any(t in ctype for t in ("position_controllers",
                                              "velocity_controllers",
                                              "effort_controllers"))
                ok = ok or (custom and custom in ctype)
                if ok:
                    claimed += [j for j in cc.get("joints", [])]
            meta["joints"] = [jn for jn in meta["joints"] if jn in claimed]
        if any(rc.add_odom_joints.values()):
            meta["odom"] = odom_config(m, name)
        robots_meta[name] = meta
    return spec, m, sim, robots_meta


def serve(cfg_path: str, run_sim: bool = True):
    """One-call launch: config file -> running SimServer (the roslaunch
    mujoco_sim.launch equivalent)."""
    from mujoco_sim_tpu.io.server import SimServer

    cfg = load_config(cfg_path)
    spec, m, sim, robots_meta = build(cfg,
                                      os.path.dirname(os.path.abspath(cfg_path)))
    peer = cfg.get("peer")
    pub_config = {k: cfg[k] for k in
                  ("pub_object_marker_array", "pub_tf",
                   "pub_object_state_array", "pub_joint_states")
                  if k in cfg}
    srv = SimServer(sim,
                    host=cfg.get("host", "127.0.0.1"),
                    port=int(cfg.get("port", 7500)),
                    spec=spec, robots=robots_meta,
                    step_hz=cfg.get("step_hz"),
                    receive=cfg.get("receive") or None,
                    peer=(peer["host"], int(peer["port"])) if peer else None,
                    pub_config=pub_config or None)
    srv.start(run_sim=run_sim)
    return srv
