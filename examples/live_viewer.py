"""Live viewer against a running `python -m mujoco_sim_tpu serve cfg.yaml`.

Equivalent of the reference's GLFW window + keyboard spawning
(mj_visual.cpp, mj_main.cpp:40-46), but as a network client so the sim can
live on the accelerator's host.  With a display: interactive matplotlib window
(mouse-drag camera; keys b/s/c spawn, x destroy, arrows/+/- camera, q
quit).  Headless: dumps frames to --out.

Usage:
    python examples/live_viewer.py --port 7500 [--out /tmp/live_frames]
    python examples/live_viewer.py --demo       # self-contained demo server
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def start_demo_server(port: int):
    """Spin up a small spawnable-primitives world to view."""
    from mujoco_sim_tpu.engine import set_const
    from mujoco_sim_tpu.models import scene
    from mujoco_sim_tpu.models.compile import compile_spec
    from mujoco_sim_tpu.runtime.sim import Simulation
    from mujoco_sim_tpu.io.server import SimServer

    fixtures = os.path.join(os.path.dirname(__file__), "..", "tests",
                            "fixtures")
    robots = {cls: scene.RobotConfig(
        path=os.path.join(fixtures, f"spawn_{cls}.xml"))
        for cls in ("cube", "sphere", "cylinder")}
    spec = scene.compose(os.path.join(fixtures, "empty_world.xml"),
                         robots=robots, instances=4)
    m = set_const(compile_spec(spec))
    spawnable = {cls: [cls] + [f"{i}_{cls}" for i in range(1, 4)]
                 for cls in robots}
    sim = Simulation(m, spawnable=spawnable)
    srv = SimServer(sim, port=port, spec=spec, step_hz=200.0)
    srv.start(run_sim=True)
    # wait for the first jitted step
    deadline = time.time() + 120
    while time.time() < deadline and float(sim.d.time) <= 0:
        time.sleep(0.25)
    return srv


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=7500)
    ap.add_argument("--rate", type=float, default=60.0)
    ap.add_argument("--out", default=None,
                    help="frame-dump directory (default: interactive only)")
    ap.add_argument("--frames", type=int, default=None,
                    help="stop after N frames (default: run until q)")
    ap.add_argument("--demo", action="store_true",
                    help="start a built-in demo server first")
    args = ap.parse_args()

    srv = start_demo_server(args.port) if args.demo else None
    from mujoco_sim_tpu.viz.live import LiveViewer
    viewer = LiveViewer(args.host, args.port, rate=args.rate,
                        out_dir=args.out)
    try:
        n = viewer.run(max_frames=args.frames)
        print(f"rendered {n} frames")
    finally:
        viewer.close()
        if srv is not None:
            srv.stop()


if __name__ == "__main__":
    main()
