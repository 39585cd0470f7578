"""Env-axis parallelism over a device mesh.

The reference's scaling story is 3 sim processes exchanging body state over
ROS topics (launch/multi_mujoco_sim.launch, SURVEY §2.5).  Here:
thousands of env instances as a leading batch axis, sharded over
a ``Mesh`` with ``NamedSharding``/``shard_map``; cross-instance coupling
(the send:/receive: weld sync of src/config/sim_1.yaml) becomes in-mesh
collectives (ppermute) instead of sockets.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from mujoco_sim_tpu import engine
from mujoco_sim_tpu.models.model import Model, Data


def make_env_mesh(devices=None, axis: str = "env") -> Mesh:
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.asarray(devices), (axis,))


def replicate_model(m: Model, mesh: Mesh) -> Model:
    sharding = NamedSharding(mesh, P())
    return jax.tree.map(lambda x: jax.device_put(jnp.asarray(x), sharding), m)


def make_batch(m: Model, nenv: int, mesh: Mesh | None = None,
               dtype=jnp.float32) -> Data:
    """Batched Data with leading env axis, optionally sharded over mesh."""
    d = engine.make_data(m, dtype)
    dB = jax.tree.map(lambda x: jnp.broadcast_to(x, (nenv,) + x.shape), d)
    if mesh is not None:
        ax = mesh.axis_names[0]
        shard = NamedSharding(mesh, P(ax))
        dB = jax.tree.map(
            lambda x: jax.device_put(x, shard) if x.ndim >= 1 else x, dB)
    return dB


def batched_step(m: Model, dB: Data) -> Data:
    return jax.vmap(engine.step, in_axes=(None, 0))(m, dB)


# which Data leaves does step() read before writing?  Everything else is
# per-step derived output (efc_J is 20 MB at PR2x256!) that must NOT ride
# the scan carry: carried-but-dead leaves cost layout copies at the while
# boundary plus device-memory carry traffic.  Discovered automatically by
# DCE over the step jaxpr so the set can never drift out of sync with the
# engine.
_RECURRENT_CACHE: dict = {}


def _recurrent_mask(m: Model, dB: Data):
    leaves, treedef = jax.tree_util.tree_flatten(dB)
    key = (jax.tree_util.tree_structure(m), treedef,
           tuple((l.shape, str(l.dtype)) for l in leaves))
    hit = _RECURRENT_CACHE.get(key)
    if hit is not None:
        return hit
    try:
        closed = jax.make_jaxpr(lambda d: batched_step(m, d))(dB)
        from jax.interpreters import partial_eval as pe
        _, used = pe.dce_jaxpr(closed.jaxpr,
                               [True] * len(closed.jaxpr.outvars))
        used = tuple(bool(u) for u in used)
        assert len(used) == len(leaves)
    except Exception:        # unknown primitive etc: carry everything
        used = tuple(True for _ in leaves)
    _RECURRENT_CACHE[key] = used
    return used


def scan_reduced(step_fn, init, nsteps: int):
    """lax.scan of ``step_fn`` (pytree -> same pytree) with a DCE-reduced
    carry: only the leaves step_fn actually reads ride the loop.  Returns
    the final carry where non-recurrent leaves are STALE template values —
    use for perf paths that read recurrent state (qpos-class) only."""
    leaves, treedef = jax.tree_util.tree_flatten(init)
    try:
        closed = jax.make_jaxpr(step_fn)(init)
        from jax.interpreters import partial_eval as pe
        _, used = pe.dce_jaxpr(closed.jaxpr,
                               [True] * len(closed.jaxpr.outvars))
        used = tuple(bool(u) for u in used)
    except Exception:
        used = tuple(True for _ in leaves)

    def shrink(x):
        return [l for l, u in zip(jax.tree_util.tree_leaves(x), used) if u]

    def merge(c):
        it = iter(c)
        return treedef.unflatten(
            [next(it) if u else t for u, t in zip(used, leaves)])

    def body(c, _):
        return shrink(step_fn(merge(c))), ()

    c, _ = jax.lax.scan(body, shrink(init), None, length=nsteps)
    return merge(c)


def _carry_split(m: Model, dB: Data):
    """(merge, shrink): map between full Data and the reduced scan carry."""
    template, treedef = jax.tree_util.tree_flatten(dB)
    used = _recurrent_mask(m, dB)

    def shrink(d):
        fl = jax.tree_util.tree_leaves(d)
        return [l for l, u in zip(fl, used) if u]

    def merge(carry):
        it = iter(carry)
        return treedef.unflatten(
            [next(it) if u else t for u, t in zip(used, template)])

    return merge, shrink


def rollout(m: Model, dB: Data, nsteps: int, full_final: bool = True) -> Data:
    """On-device rollout: scan over time, env axis stays sharded.

    The scan carries only the recurrent leaves (qpos/qvel/act/warmstart/
    inputs); derived diagnostics are recomputed by a final full step so the
    result is bit-identical to the naive full-Data scan.

    full_final=False skips that trailing unrolled step: all nsteps run
    inside the loop (half the compiled program, ~half the jit time) and the
    returned Data's DERIVED leaves (xpos/contact/efc_*/qacc/...) are stale
    template values — only the recurrent state is meaningful.  Use it for
    perf paths that read qpos/qvel-class state only.
    """
    if nsteps <= 1:
        return batched_step(m, dB) if nsteps == 1 else dB
    merge, shrink = _carry_split(m, dB)

    def body(carry, _):
        return shrink(batched_step(m, merge(carry))), ()

    n_in_loop = nsteps if not full_final else nsteps - 1
    carry, _ = jax.lax.scan(body, shrink(dB), None, length=n_in_loop)
    if not full_final:
        return merge(carry)
    return batched_step(m, merge(carry))


def rollout_traj(m: Model, dB: Data, nsteps: int, extract=None):
    """On-device rollout that also stacks per-step observations.

    extract(d) -> pytree of observables (default: qpos).  Returns
    (final Data, traj pytree with leading [nsteps] axis).  This is the
    trajectory-egress path (SURVEY §2.5): scan on device, ONE
    device-to-host transfer at the end instead of per-step reads.
    """
    extract = extract or (lambda d: d.qpos)
    if nsteps <= 1:
        dB = batched_step(m, dB)
        return dB, jax.tree.map(lambda x: x[None], extract(dB))
    merge, shrink = _carry_split(m, dB)

    def body(carry, _):
        d = batched_step(m, merge(carry))
        return shrink(d), extract(d)

    carry, traj = jax.lax.scan(body, shrink(dB), None, length=nsteps - 1)
    dB = batched_step(m, merge(carry))
    traj = jax.tree.map(lambda t, last: jnp.concatenate([t, last[None]]),
                        traj, extract(dB))
    return dB, traj


def make_sharded_step(m: Model, mesh: Mesh):
    """jit-compiled batched step with env axis sharded over the mesh."""
    ax = mesh.axis_names[0]
    data_sharding = jax.tree.map(
        lambda _: NamedSharding(mesh, P(ax)), jax.tree.structure(None))
    step = jax.jit(
        batched_step,
        in_shardings=(NamedSharding(mesh, P()), NamedSharding(mesh, P(ax))),
        out_shardings=NamedSharding(mesh, P(ax)),
    )
    return step


def make_sharded_rollout(m: Model, mesh: Mesh, nsteps: int,
                         full_final: bool = True):
    """jit-compiled `rollout` with the env axis sharded over the mesh."""
    ax = mesh.axis_names[0]
    fn = jax.jit(
        partial(rollout, nsteps=nsteps, full_final=full_final),
        in_shardings=(NamedSharding(mesh, P()), NamedSharding(mesh, P(ax))),
        out_shardings=NamedSharding(mesh, P(ax)),
        static_argnames=(),
    )
    return fn


def exchange_body_state(dB: Data, mesh: Mesh, body_id: int):
    """Multi-instance send/receive coupling: each env instance receives the
    ring-neighbor's pose of `body_id` (in-mesh replacement for the
    reference's '_ref' mocap-weld sync over sockets, mj_sim.cpp:847-960).

    Returns (pos, quat) arrays aligned with the local env batch.
    """
    ax = mesh.axis_names[0]
    n = mesh.devices.size

    def shift(x):
        perm = [(i, (i + 1) % n) for i in range(n)]
        return jax.lax.ppermute(x, ax, perm)

    f = jax.shard_map(
        lambda p, q: (shift(p), shift(q)),
        mesh=mesh,
        in_specs=(P(ax), P(ax)),
        out_specs=(P(ax), P(ax)),
    )
    return f(dB.xpos[:, body_id], dB.xquat[:, body_id])
