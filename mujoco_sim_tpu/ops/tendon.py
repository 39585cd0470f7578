"""Tendon lengths and moment rows (mj_tendon equivalent).

Fixed tendons are a STATIC linear form (length = W_q qpos, moment = W_v).
Spatial tendons are compiled into static LEG tables (models/compile.py):

- plain legs: straight site-to-site segments; length |pb - pa|, moment
  u . (Jp_b - Jp_a) over the sites' point jacobians.
- wrap legs: site -> sphere/cylinder wrap geom (optional sidesite) ->
  site.  The 2D tangent wrap is solved in closed form in the geom's
  local frame; the taut-string identity makes the moment the straight
  -segment formula with the tangent points attached to the wrap geom's
  body (the surface-arc sliding contributes zero to first order).
  Sidesite semantics were probed against mujoco 3.10 (mju_wrap):
    * wrap activates when the straight segment crosses the circle, or
      when a sidesite lies on the opposite side of the segment;
    * a sidesite INSIDE the circle means wrap-inside: the tendon must
      touch the geom — a single surface point minimizing path length
      (found by ternary search) unless the segment already crosses;
    * endpoints inside the circle fall back to straight.
- pulleys divide subsequent leg lengths/moments by `divisor` and break
  the chain (no segment across a pulley).

Everything is batched over all legs of all tendons with scatter-adds
into the (ntendon,) rows; no per-wrap loop (a batched replacement for
libmujoco's mj_tendon inside mj_step1, SURVEY §2.2).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from mujoco_sim_tpu.models.model import Model

_EPS = 1e-12


def _norm(v, axis=-1):
    return jnp.sqrt((v * v).sum(axis) + _EPS)


def _point_jac(m: Model, cdof, origin_body, pts, bodies, dtype):
    """pts (N, 3) world with static body ids -> point jacobians (N, 3, nv)."""
    ang, lin = cdof[:, :3], cdof[:, 3:]
    r = pts - origin_body[bodies]
    Jp = (lin.T[None]
          + jnp.cross(ang[None, :, :], r[:, None, :]).swapaxes(-1, -2))
    return Jp * jnp.asarray(m.ancestor_mask, dtype)[bodies][:, None, :]


def _tangent2d(P, r, s):
    """tangent point of the line from 2D point P to the circle of radius
    r, picking the candidate on the side of unit-ish vector s."""
    p2 = (P * P).sum(-1)
    safe = jnp.maximum(p2, _EPS)
    base = (r * r / safe)[:, None] * P
    k = r * jnp.sqrt(jnp.maximum(p2 - r * r, 0.0)) / safe
    perp = jnp.stack([-P[..., 1], P[..., 0]], -1)
    sgn = jnp.where((perp * s).sum(-1) >= 0.0, 1.0, -1.0)
    return base + (k * sgn)[:, None] * perp


def _wrap_inside_touch(A, B, c, r, iters=48):
    """2D point on the circle minimizing |A-P| + |P-B| (wrap-inside mode),
    by ternary search bracketed around the segment's closest approach."""
    aa = jnp.arctan2(A[..., 1], A[..., 0])
    ab = jnp.arctan2(B[..., 1], B[..., 0])
    ac = jnp.arctan2(c[..., 1], c[..., 0])

    def wrap_pi(x):
        return jnp.arctan2(jnp.sin(x), jnp.cos(x))

    ba = wrap_pi(aa - ac)
    bb = wrap_pi(ab - ac)
    lo = jnp.minimum(jnp.minimum(ba, bb), 0.0)
    hi = jnp.maximum(jnp.maximum(ba, bb), 0.0)

    def f(beta):
        P = r[:, None] * jnp.stack([jnp.cos(ac + beta),
                                    jnp.sin(ac + beta)], -1)
        return _norm(A - P) + _norm(P - B)

    def body(_, lohi):
        lo, hi = lohi
        m1 = lo + (hi - lo) / 3.0
        m2 = hi - (hi - lo) / 3.0
        smaller = f(m1) < f(m2)
        return (jnp.where(smaller, lo, m1), jnp.where(smaller, m2, hi))

    lo, hi = jax.lax.fori_loop(0, iters, body, (lo, hi))
    beta = 0.5 * (lo + hi)
    return r[:, None] * jnp.stack([jnp.cos(ac + beta),
                                   jnp.sin(ac + beta)], -1)


def tendon_quantities(m: Model, qpos: jax.Array, site_xpos: jax.Array,
                      cdof: jax.Array, origin_body: jax.Array,
                      geom_xpos=None, geom_xmat=None, geom_size=None):
    """(ten_length (ntendon,), ten_J (ntendon, nv)).

    origin_body: (nbody, 3) c-frame origin per body
    (subtree_com[body_rootid]).  geom_* needed only when wrap legs exist.
    """
    lay = m.layout
    dtype = qpos.dtype
    length = jnp.asarray(lay.ten_Wq, dtype) @ qpos
    J = jnp.asarray(lay.ten_Wv, dtype) + jnp.zeros((), dtype)

    # ---------------- plain site-site legs ----------------
    if len(lay.ten_leg_ten):
        sa = lay.ten_leg_sites[:, 0]
        sb = lay.ten_leg_sites[:, 1]
        w = jnp.asarray(lay.ten_leg_w, dtype)
        pa = site_xpos[sa]
        pb = site_xpos[sb]
        seg = pb - pa
        slen = _norm(seg)
        u = seg / slen[:, None]
        Ja = _point_jac(m, cdof, origin_body, pa, lay.site_bodyid[sa], dtype)
        Jb = _point_jac(m, cdof, origin_body, pb, lay.site_bodyid[sb], dtype)
        Jleg = (u[:, :, None] * (Jb - Ja)).sum(1)         # (L, nv)
        rows = jnp.asarray(lay.ten_leg_ten)
        length = length.at[rows].add(w * slen)
        J = J.at[rows].add(w[:, None] * Jleg)

    # ---------------- wrap legs ----------------
    if len(lay.ten_wleg_ten):
        sa = lay.ten_wleg_sites[:, 0]
        sb = lay.ten_wleg_sites[:, 1]
        ga = lay.ten_wleg_geom
        w = jnp.asarray(lay.ten_wleg_w, dtype)
        is_sph = jnp.asarray(lay.ten_wleg_sphere)
        has_side = jnp.asarray(lay.ten_wleg_side >= 0)
        side_sid = np.maximum(lay.ten_wleg_side, 0)
        pa = site_xpos[sa]
        pb = site_xpos[sb]
        gp = geom_xpos[ga]
        gR = geom_xmat[ga]
        r = geom_size[ga][:, 0]
        loc = lambda p: (gR * (p - gp)[:, :, None]).sum(1)   # R^T (p - gp)
        a3 = loc(pa)
        b3 = loc(pb)
        sd3 = loc(site_xpos[side_sid])

        # 2D reduction: cylinder uses local (x, y); sphere uses the plane
        # spanned by (a, b) through the center
        e1 = a3 / _norm(a3)[:, None]
        b_perp = b3 - (b3 * e1).sum(-1)[:, None] * e1
        e2 = b_perp / _norm(b_perp)[:, None]
        sphm = is_sph[:, None]
        A2 = jnp.where(sphm,
                       jnp.stack([_norm(a3), jnp.zeros_like(r)], -1),
                       a3[:, :2])
        B2 = jnp.where(sphm,
                       jnp.stack([(b3 * e1).sum(-1), (b3 * e2).sum(-1)], -1),
                       b3[:, :2])
        sd2 = jnp.where(sphm,
                        jnp.stack([(sd3 * e1).sum(-1),
                                   (sd3 * e2).sum(-1)], -1),
                        sd3[:, :2])

        sqa = (A2 * A2).sum(-1)
        sqb = (B2 * B2).sum(-1)
        outside = (sqa > r * r) & (sqb > r * r)
        d2 = B2 - A2
        dd = jnp.maximum((d2 * d2).sum(-1), _EPS)
        tpar = jnp.clip(-(A2 * d2).sum(-1) / dd, 0.0, 1.0)
        c2v = A2 + tpar[:, None] * d2                  # closest pt to center
        c2 = (c2v * c2v).sum(-1)
        sdin = has_side & ((sd2 * sd2).sum(-1) < r * r)
        crosses = c2 < r * r
        opposite = has_side & ((c2v * sd2).sum(-1) < 0.0)
        active_out = outside & ~sdin & (crosses | opposite)
        active_in = outside & sdin & ~crosses
        wrap_on = active_out | active_in

        s2 = jnp.where(has_side[:, None], sd2, c2v)
        t0 = _tangent2d(A2, r, s2)
        t1 = _tangent2d(B2, r, s2)
        cosang = jnp.clip((t0 * t1).sum(-1) / jnp.maximum(r * r, _EPS),
                          -1.0, 1.0)
        arc = r * jnp.arccos(cosang)
        P2 = _wrap_inside_touch(A2, B2, c2v, r)
        x0_2 = jnp.where(active_out[:, None], t0, P2)
        x1_2 = jnp.where(active_out[:, None], t1, P2)
        arc = jnp.where(active_out, arc, 0.0)

        # back to 3D local: sphere lifts through the plane basis;
        # cylinder interpolates z along the 2D path length (probed
        # mju_wrap convention), helix arc = hypot(arc2d, dz)
        la = _norm(A2 - x0_2)
        lb = _norm(B2 - x1_2)
        tot2 = jnp.maximum(la + arc + lb, _EPS)
        za = a3[..., 2]
        zb = b3[..., 2]
        z0 = za + (zb - za) * la / tot2
        z1 = za + (zb - za) * (la + arc) / tot2
        X0_loc = jnp.where(
            sphm,
            x0_2[:, 0:1] * e1 + x0_2[:, 1:2] * e2,
            jnp.concatenate([x0_2, z0[:, None]], -1))
        X1_loc = jnp.where(
            sphm,
            x1_2[:, 0:1] * e1 + x1_2[:, 1:2] * e2,
            jnp.concatenate([x1_2, z1[:, None]], -1))
        wlen = jnp.where(is_sph, arc, jnp.sqrt(arc * arc
                                               + (z1 - z0) ** 2 + _EPS))
        wlen = jnp.where(active_out, wlen, 0.0)
        X0 = gp + (gR * X0_loc[:, None, :]).sum(-1)    # gR @ X_loc, world
        X1 = gp + (gR * X1_loc[:, None, :]).sum(-1)

        # lengths
        l_wrap = _norm(pa - X0) + wlen + _norm(X1 - pb)
        l_straight = _norm(pb - pa)
        l_leg = jnp.where(wrap_on, l_wrap, l_straight)

        # moments: straight-segment formula; tangent points ride the
        # wrap geom's body (taut-string identity)
        u0 = (X0 - pa) / _norm(X0 - pa)[:, None]
        u1 = (pb - X1) / _norm(pb - X1)[:, None]
        us = (pb - pa) / l_straight[:, None]
        body_a = lay.site_bodyid[sa]
        body_b = lay.site_bodyid[sb]
        body_g = lay.geom_bodyid[ga]
        Ja = _point_jac(m, cdof, origin_body, pa, body_a, dtype)
        Jb = _point_jac(m, cdof, origin_body, pb, body_b, dtype)
        J0 = _point_jac(m, cdof, origin_body, X0, body_g, dtype)
        J1 = _point_jac(m, cdof, origin_body, X1, body_g, dtype)
        J_wrap = ((u0[:, :, None] * (J0 - Ja)).sum(1)
                  + (u1[:, :, None] * (Jb - J1)).sum(1))
        J_str = (us[:, :, None] * (Jb - Ja)).sum(1)
        J_leg = jnp.where(wrap_on[:, None], J_wrap, J_str)

        rows = jnp.asarray(lay.ten_wleg_ten)
        length = length.at[rows].add(w * l_leg)
        J = J.at[rows].add(w[:, None] * J_leg)
    return length, J
