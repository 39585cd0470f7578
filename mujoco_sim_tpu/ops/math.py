"""Quaternion and spatial (6D) algebra.

Conventions match MuJoCo so that model/state round-trip with the reference
semantics (reference delegates these to libmujoco's mju_* helpers, e.g. the
explicit rotation math re-derived in reference src/mujoco_sim/mj_sim.cpp:1100-1120):

* quaternions are (w, x, y, z), unit norm;
* spatial motion vectors are [angular(3); linear(3)];
* spatial force vectors are [torque(3); force(3)].

Everything broadcasts over arbitrary leading batch axes and is dtype-agnostic
(f32 for throughput, f64 on CPU for oracle-matching tests).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


# ---------------------------------------------------------------------------
# Quaternions
# ---------------------------------------------------------------------------

def quat_mul(a: jax.Array, b: jax.Array) -> jax.Array:
    """Hamilton product a*b, (w,x,y,z)."""
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return jnp.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        axis=-1,
    )


def quat_inv(q: jax.Array) -> jax.Array:
    """Conjugate (= inverse for unit quaternions)."""
    return q * jnp.array([1.0, -1.0, -1.0, -1.0], dtype=q.dtype)


def quat_normalize(q: jax.Array) -> jax.Array:
    norm = jnp.linalg.norm(q, axis=-1, keepdims=True)
    # Degenerate quaternion -> identity, like mju_normalize4.
    safe = jnp.where(norm > 1e-12, q / jnp.where(norm > 1e-12, norm, 1.0), 0.0)
    ident = jnp.zeros_like(q).at[..., 0].set(1.0)
    return jnp.where(norm > 1e-12, safe, ident)


def rot_vec_quat(v: jax.Array, q: jax.Array) -> jax.Array:
    """Rotate vector v by quaternion q (active rotation, mju_rotVecQuat)."""
    w = q[..., :1]
    u = q[..., 1:]
    # v' = v + 2w (u x v) + 2 u x (u x v)
    uv = jnp.cross(u, v)
    return v + 2.0 * (w * uv + jnp.cross(u, uv))


def rot_vec_quat_inv(v: jax.Array, q: jax.Array) -> jax.Array:
    return rot_vec_quat(v, quat_inv(q))


def quat_to_mat(q: jax.Array) -> jax.Array:
    """Quaternion -> 3x3 rotation matrix (..., 3, 3)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = jnp.stack(
        [
            1.0 - 2.0 * (yy + zz), 2.0 * (xy - wz), 2.0 * (xz + wy),
            2.0 * (xy + wz), 1.0 - 2.0 * (xx + zz), 2.0 * (yz - wx),
            2.0 * (xz - wy), 2.0 * (yz + wx), 1.0 - 2.0 * (xx + yy),
        ],
        axis=-1,
    )
    return m.reshape(*q.shape[:-1], 3, 3)


def mat_to_quat(m: jax.Array) -> jax.Array:
    """3x3 rotation matrix -> quaternion, numerically robust branch-free mix."""
    tr = m[..., 0, 0] + m[..., 1, 1] + m[..., 2, 2]
    # Four candidate constructions; pick the best-conditioned one.
    qw = jnp.stack(
        [
            1.0 + tr,
            m[..., 2, 1] - m[..., 1, 2],
            m[..., 0, 2] - m[..., 2, 0],
            m[..., 1, 0] - m[..., 0, 1],
        ],
        axis=-1,
    )
    qx = jnp.stack(
        [
            m[..., 2, 1] - m[..., 1, 2],
            1.0 + m[..., 0, 0] - m[..., 1, 1] - m[..., 2, 2],
            m[..., 0, 1] + m[..., 1, 0],
            m[..., 0, 2] + m[..., 2, 0],
        ],
        axis=-1,
    )
    qy = jnp.stack(
        [
            m[..., 0, 2] - m[..., 2, 0],
            m[..., 0, 1] + m[..., 1, 0],
            1.0 - m[..., 0, 0] + m[..., 1, 1] - m[..., 2, 2],
            m[..., 1, 2] + m[..., 2, 1],
        ],
        axis=-1,
    )
    qz = jnp.stack(
        [
            m[..., 1, 0] - m[..., 0, 1],
            m[..., 0, 2] + m[..., 2, 0],
            m[..., 1, 2] + m[..., 2, 1],
            1.0 - m[..., 0, 0] - m[..., 1, 1] + m[..., 2, 2],
        ],
        axis=-1,
    )
    cands = jnp.stack([qw, qx, qy, qz], axis=-2)  # (..., 4, 4)
    scores = jnp.stack(
        [
            tr,
            m[..., 0, 0] - m[..., 1, 1] - m[..., 2, 2],
            m[..., 1, 1] - m[..., 0, 0] - m[..., 2, 2],
            m[..., 2, 2] - m[..., 0, 0] - m[..., 1, 1],
        ],
        axis=-1,
    )
    best = jnp.argmax(scores, axis=-1)
    q = jnp.take_along_axis(cands, best[..., None, None].repeat(4, -1), axis=-2)[..., 0, :]
    q = quat_normalize(q)
    # Canonical sign: w >= 0.
    return q * jnp.where(q[..., :1] < 0, -1.0, 1.0)


def axis_angle_to_quat(axis: jax.Array, angle: jax.Array) -> jax.Array:
    half = 0.5 * angle
    s = jnp.sin(half)
    return jnp.concatenate([jnp.cos(half)[..., None], axis * s[..., None]], axis=-1)


def quat_integrate(q: jax.Array, omega_local: jax.Array, dt) -> jax.Array:
    """mju_quatIntegrate: rotate q by local angular velocity omega for dt."""
    scaled = omega_local * dt
    angle = jnp.linalg.norm(scaled, axis=-1)
    safe = jnp.where(angle > 1e-14, angle, 1.0)
    axis = scaled / safe[..., None]
    dq = axis_angle_to_quat(axis, angle)
    dq = jnp.where(angle[..., None] > 1e-14, dq,
                   jnp.zeros_like(dq).at[..., 0].set(1.0))
    return quat_normalize(quat_mul(q, dq))


def quat_sub(qa: jax.Array, qb: jax.Array) -> jax.Array:
    """3D velocity that takes qb to qa in unit time (mju_subQuat): local frame."""
    dq = quat_mul(quat_inv(qb), qa)
    dq = dq * jnp.where(dq[..., :1] < 0, -1.0, 1.0)  # shortest path
    sin_half = jnp.linalg.norm(dq[..., 1:], axis=-1)
    angle = 2.0 * jnp.arctan2(sin_half, dq[..., 0])
    safe = jnp.where(sin_half > 1e-14, sin_half, 1.0)
    axis = dq[..., 1:] / safe[..., None]
    return jnp.where(sin_half[..., None] > 1e-14, axis * angle[..., None], 2.0 * dq[..., 1:])


# ---------------------------------------------------------------------------
# Spatial algebra ([angular; linear] ordering)
# ---------------------------------------------------------------------------

def motion_cross(v: jax.Array, m: jax.Array) -> jax.Array:
    """Spatial motion cross product v x m."""
    vw, vl = v[..., :3], v[..., 3:]
    mw, ml = m[..., :3], m[..., 3:]
    return jnp.concatenate(
        [jnp.cross(vw, mw), jnp.cross(vw, ml) + jnp.cross(vl, mw)], axis=-1
    )


def force_cross(v: jax.Array, f: jax.Array) -> jax.Array:
    """Spatial force (dual) cross product v x* f."""
    vw, vl = v[..., :3], v[..., 3:]
    fw, fl = f[..., :3], f[..., 3:]
    return jnp.concatenate(
        [jnp.cross(vw, fw) + jnp.cross(vl, fl), jnp.cross(vw, fl)], axis=-1
    )


def skew(v: jax.Array) -> jax.Array:
    """(...,3) -> (...,3,3) cross-product matrix."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = jnp.zeros_like(x)
    m = jnp.stack([zero, -z, y, z, zero, -x, -y, x, zero], axis=-1)
    return m.reshape(*v.shape[:-1], 3, 3)


def spatial_inertia(mass: jax.Array, inertia_mat: jax.Array, com: jax.Array) -> jax.Array:
    """6x6 spatial inertia about a frame origin.

    mass (...,), inertia_mat (...,3,3) about the COM in the frame's
    orientation, com (...,3) COM offset from frame origin.
    Layout matches [ang; lin] vectors: f = I_spatial @ a.
    """
    c = skew(com)
    m = mass[..., None, None]
    eye = jnp.broadcast_to(jnp.eye(3, dtype=com.dtype), c.shape)
    # c c^T for a skew matrix is (v.v)I - v v^T: pure elementwise work
    # that fuses, where the literal batched (...,3,3)@(...,3,3)
    # dot_general would be its own op plus a layout copy.
    vv = (com * com).sum(-1)[..., None, None]
    outer = com[..., :, None] * com[..., None, :]
    top_left = inertia_mat + m * (vv * eye - outer)
    top_right = m * c
    bot_left = -top_right        # skew^T = -skew; avoids a transpose copy
    bot_right = m * eye
    top = jnp.concatenate([top_left, top_right], axis=-1)
    bot = jnp.concatenate([bot_left, bot_right], axis=-1)
    return jnp.concatenate([top, bot], axis=-2)


def transform_motion(v: jax.Array, pos: jax.Array, rot_new_from_old: jax.Array) -> jax.Array:
    """Change coordinates of a motion vector.

    New frame origin at `pos` (expressed in old frame), orientation given by
    rotation matrix R mapping old-frame vectors to new-frame vectors.
    """
    w, l = v[..., :3], v[..., 3:]
    w_new = jnp.einsum("...ij,...j->...i", rot_new_from_old, w)
    l_new = jnp.einsum("...ij,...j->...i", rot_new_from_old, l - jnp.cross(pos, w))
    return jnp.concatenate([w_new, l_new], axis=-1)


def normalize_with_norm(v: jax.Array, eps: float = 1e-12):
    n = jnp.linalg.norm(v, axis=-1, keepdims=True)
    return v / jnp.maximum(n, eps), n[..., 0]
