"""Where do the step program's ops come from?  (CPU, no card needed.)

On a GPU each unfused op of the step is a kernel launch, so a step made
of many small ops is launch-bound and the lever is FEWER, BIGGER ops.
This tool compiles one batched step on CPU and buckets the optimized-HLO
instructions by the source location XLA's op metadata carries, printing
the top op-producing file:line sites.  CPU fusion decisions differ from
the GPU's, but the *source attribution* of the op population is what we
need to decide what to fuse by hand.

Usage: python scripts/hlo_opcount.py [manip|box] [nenv]
"""

import collections
import os
import re
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)

import jax

from mujoco_sim_tpu.utils.cache import use_compile_cache  # noqa: E402

jax.config.update("jax_platforms", "cpu")
use_compile_cache()

import jax.numpy as jnp  # noqa: E402


def build(scenario):
    from mujoco_sim_tpu import engine
    from mujoco_sim_tpu.models.model import Integrator

    if scenario == "manip":
        from mujoco_sim_tpu.models.compile import load_model
        m = load_model(os.path.join(_REPO, "tests/fixtures/manip_bin6.xml"))
    else:
        from mujoco_sim_tpu.models.compile import load_model
        m = load_model(os.path.join(_REPO, "tests/fixtures/floor_box.xml"))
    m = m.replace(opt=m.opt.replace(integrator=int(Integrator.EULER)))
    return m


def main():
    scenario = sys.argv[1] if len(sys.argv) > 1 else "manip"
    nenv = int(sys.argv[2]) if len(sys.argv) > 2 else 4
    from mujoco_sim_tpu import engine

    m = build(scenario)
    m32 = engine.put_model(m, jnp.float32)
    d = engine.make_data(m32, jnp.float32)
    dB = jax.tree.map(lambda x: jnp.broadcast_to(x, (nenv,) + x.shape), d)

    step = jax.jit(jax.vmap(engine.step, in_axes=(None, 0)))
    txt = step.lower(m32, dB).compile().as_text()

    # entry-computation instruction lines carry op metadata:
    #   %name = type op(...), metadata={op_name="..." source_file="..."
    #   source_line=N}
    by_site = collections.Counter()
    by_opname = collections.Counter()
    total = 0
    fusions = 0
    in_entry = False
    for line in txt.splitlines():
        s = line.strip()
        if s.startswith("ENTRY "):
            in_entry = True
            continue
        if in_entry and s == "}":
            in_entry = False
        if not in_entry or "=" not in s:
            continue
        ms = re.search(r'source_file="([^"]+)" source_line=(\d+)', s)
        mo = re.search(r'op_name="([^"]+)"', s)
        total += 1
        if " fusion(" in s or s.startswith("fusion"):
            fusions += 1
        if ms:
            site = f"{os.path.basename(ms.group(1))}:{ms.group(2)}"
            by_site[site] += 1
        if mo:
            # bucket by the jit scope head (first two path segments)
            parts = mo.group(1).split("/")
            by_opname["/".join(parts[:3])] += 1
    print(f"{scenario}: {total} entry instructions ({fusions} fusions)")
    print("top source sites:")
    for site, n in by_site.most_common(30):
        print(f"  {n:5d}  {site}")
    print("top op-name scopes:")
    for scope, n in by_opname.most_common(30):
        print(f"  {n:5d}  {scope}")


if __name__ == "__main__":
    main()
