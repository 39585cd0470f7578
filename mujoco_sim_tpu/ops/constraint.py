"""Constraint row assembly: equality, dof friction, limits, contacts.

Implements MuJoCo's soft-constraint model (impedance d(r) from solimp,
reference acceleration from solref, regularization R = (1-d)/d * diagApprox)
with *static* row layout: every potential row owns a fixed slot
(models/compile.py assigns addresses); inactive rows are masked.

Rows are built as vectorized per-section blocks and CONCATENATED in the
compile-time address order (equality, dof friction, limits, contacts —
models/compile.py:607-642) instead of scattered into preallocated arrays.
Scatters do not fuse; the concat form is pure elementwise/gather work that
XLA fuses into the step program.

The reference depends on these semantics through mj_step: joint-couple
equality for mimic joints (pr2.xml:398-411), weld equality for multi-instance
'_ref' sync (mj_sim.cpp:933-938), joint limits, and contacts (SURVEY §2.2).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from mujoco_sim_tpu.models.model import Model, Data, EqType, JointType, DisableBit
from mujoco_sim_tpu.ops import math as mm

_MINIMP, _MAXIMP = 0.0001, 0.9999


def impedance(solimp: jax.Array, pos: jax.Array) -> jax.Array:
    """Constraint impedance d(r) (MuJoCo getimpedance)."""
    d0, d1, width, mid, power = (solimp[..., 0], solimp[..., 1],
                                 solimp[..., 2], solimp[..., 3],
                                 solimp[..., 4])
    flat = 0.5 * (d0 + d1)
    x = jnp.clip(jnp.abs(pos) / jnp.maximum(width, 1e-12), 0.0, 1.0)
    mid = jnp.clip(mid, 0.0001, 0.9999)
    power = jnp.maximum(power, 1.0)
    # two power curves meeting at the midpoint (MuJoCo sigmoid)
    y_lo = mid * jnp.power(x / mid, power)
    y_hi = 1.0 - (1.0 - mid) * jnp.power((1.0 - x) / (1.0 - mid), power)
    y = jnp.where(x <= mid, y_lo, y_hi)
    imp = d0 + y * (d1 - d0)
    imp = jnp.where(width <= 1e-12, flat, imp)
    return jnp.clip(imp, _MINIMP, _MAXIMP)


def kbi(solref: jax.Array, solimp: jax.Array, pos: jax.Array, dtype):
    """(stiffness k, damping b, impedance imp) per row (MuJoCo mj_assignRef)."""
    imp = impedance(solimp, pos)
    dmax = jnp.clip(solimp[..., 1], _MINIMP, _MAXIMP)
    tc = solref[..., 0]
    dr = solref[..., 1]
    b_std = 2.0 / jnp.maximum(dmax * tc, 1e-12)
    k_std = 1.0 / jnp.maximum(dmax * dmax * tc * tc * dr * dr, 1e-12)
    k = jnp.where(tc > 0, k_std, -solref[..., 0])
    b = jnp.where(tc > 0, b_std, -solref[..., 1])
    return k, b, imp


def _point_jacobian(m: Model, d: Data, point: jax.Array, body_id,
                    origin: jax.Array):
    """Translational Jacobian (3, nv) of a world point on body_id.

    v(point) = cdof_lin + cdof_ang x (point - O), masked by dof ancestry.
    Batched over leading axes of point/body_id.
    """
    dtype = d.qpos.dtype
    cdof = d.cdof  # (nv, 6)
    ang, lin = cdof[:, :3], cdof[:, 3:]
    r = point - origin  # (...,3)
    # J[..., 3, nv]
    jac = lin.T[None] + jnp.cross(ang[None, :, :],
                                  r[..., None, :]).swapaxes(-1, -2)
    mask = jnp.asarray(m.ancestor_mask, dtype)[body_id]  # (..., nv)
    return jac * mask[..., None, :]


def _rot_jacobian(m: Model, d: Data, body_id):
    dtype = d.qpos.dtype
    ang = d.cdof[:, :3]  # (nv, 3)
    mask = jnp.asarray(m.ancestor_mask, dtype)[body_id]
    return ang.T[None] * mask[..., None, :]  # (..., 3, nv)


# ---------------------------------------------------------------------------
# Static (host-side) assembly plan, cached per Layout.
# ---------------------------------------------------------------------------

_PLAN_CACHE: dict = {}


class _EqPlan:
    """Static equality-section plan: per-type index arrays, constant one-hot
    bases for joint couples, and the permutation restoring compile-time
    (interleaved) row order from [JOINT | TENDON | CONNECT | WELD] block
    order."""

    def __init__(self, m: Model):
        lay = m.layout
        nv = m.nv
        et = lay.eq_type
        self.jsel = np.nonzero(et == int(EqType.JOINT))[0]
        self.csel = np.nonzero(et == int(EqType.CONNECT))[0]
        self.wsel = np.nonzero(et == int(EqType.WELD))[0]
        self.tsel = np.nonzero(et == int(EqType.TENDON))[0]
        if len(self.tsel):
            self.t_id1 = lay.eq_obj1id[self.tsel]
            self.t_has2 = lay.eq_obj2id[self.tsel] >= 0
            self.t_id2 = np.where(self.t_has2, lay.eq_obj2id[self.tsel], 0)
        # joint couples: dof addresses + one-hot base matrices
        if len(self.jsel):
            o1 = lay.eq_obj1id[self.jsel]
            o2 = lay.eq_obj2id[self.jsel]
            self.j_qa1 = lay.jnt_qposadr[o1]
            self.j_da1 = lay.jnt_dofadr[o1]
            self.j_has2 = o2 >= 0
            o2s = np.where(self.j_has2, o2, 0)
            self.j_qa2 = lay.jnt_qposadr[o2s]
            self.j_da2 = lay.jnt_dofadr[o2s]
            self.j_body = lay.jnt_bodyid[o1]
            nJ = len(self.jsel)
            b1 = np.zeros((nJ, nv))
            b1[np.arange(nJ), self.j_da1] = 1.0
            b2 = np.zeros((nJ, nv))
            b2[np.arange(nJ), self.j_da2] = 1.0
            b2[~self.j_has2] = 0.0
            self.j_base1, self.j_base2 = b1, b2
        # row permutation: dest row (relative to eq section) -> src row in
        # the [J | C | W] block concat
        rows_of = {int(EqType.JOINT): 1, int(EqType.TENDON): 1,
                   int(EqType.CONNECT): 3, int(EqType.WELD): 6}
        src_of_eq = {}
        cursor = 0
        for grp in (self.jsel, self.tsel, self.csel, self.wsel):
            for k in grp:
                src_of_eq[int(k)] = cursor
                cursor += rows_of[int(et[k])]
        self.n_rows = cursor
        inv = np.zeros(cursor, dtype=int)
        base = lay.eq_efcadr[0] if len(et) else 0
        for k in range(len(et)):
            adr = lay.eq_efcadr[k] - base
            src = src_of_eq[int(k)]
            for i in range(rows_of[int(et[k])]):
                inv[adr + i] = src + i
        self.perm = inv
        self.perm_is_identity = bool(np.all(inv == np.arange(cursor)))


def _eq_plan(m: Model) -> _EqPlan:
    key = (m.layout, "eq")
    got = _PLAN_CACHE.get(key)
    if got is None:
        got = _EqPlan(m)
        _PLAN_CACHE[key] = got
    return got


def _onehot_rows(idx: np.ndarray, nv: int, sign=None):
    """Constant (n, nv) one-hot matrix (host-side)."""
    B = np.zeros((len(idx), nv))
    B[np.arange(len(idx)), idx] = 1.0
    return B


def make_constraint(m: Model, d: Data, com: dict) -> Data:
    """Fill efc_* rows (mj_makeConstraint equivalent)."""
    lay = m.layout
    dtype = d.qpos.dtype
    nefc, nv = m.nefc_max, m.nv
    if nefc == 0:
        return d

    origin = com["origin"]
    binv = jnp.asarray(m.body_invweight0, dtype)
    dinv = jnp.asarray(m.dof_invweight0, dtype)
    disable = m.opt.disableflags

    # section accumulators (concatenated in address order at the end)
    secs = {k: [] for k in ("J", "pos", "margin", "solref", "solimp",
                            "diag", "floss", "active", "type", "flossrow")}

    def emit(J, pos, solref, solimp, diag, active, etype,
             margin=None, floss=None, flossrow=None):
        n = J.shape[0]
        z = jnp.zeros((n,), dtype)
        secs["J"].append(J)
        secs["pos"].append(pos)
        secs["margin"].append(z if margin is None else margin)
        secs["solref"].append(solref)
        secs["solimp"].append(solimp)
        secs["diag"].append(diag)
        secs["floss"].append(z if floss is None else floss)
        secs["active"].append(active)
        secs["type"].append(jnp.full((n,), etype, jnp.int32))
        secs["flossrow"].append(
            jnp.zeros((n,), bool) if flossrow is None else flossrow)

    # ---------------- equality ----------------
    if m.neq:
        plan = _eq_plan(m)
        eq_off = (disable & int(DisableBit.EQUALITY)) != 0
        eq_data = jnp.asarray(m.eq_data, dtype)
        eq_solref = jnp.asarray(m.eq_solref, dtype)
        eq_solimp = jnp.asarray(m.eq_solimp, dtype)
        eq_act0 = jnp.asarray(m.eq_active0)
        blocks = {k: [] for k in ("J", "pos", "solref", "solimp", "diag",
                                  "active")}

        def emit_eq(J, pos, solref, solimp, diag, active):
            blocks["J"].append(J)
            blocks["pos"].append(pos)
            blocks["solref"].append(solref)
            blocks["solimp"].append(solimp)
            blocks["diag"].append(diag)
            blocks["active"].append(active)

        if len(plan.jsel):
            js = plan.jsel
            data = eq_data[js]                       # (nJ, 11)
            qpos0 = jnp.asarray(m.qpos0, dtype)
            q1 = d.qpos[plan.j_qa1] - qpos0[plan.j_qa1]
            dx = jnp.where(jnp.asarray(plan.j_has2),
                           d.qpos[plan.j_qa2] - qpos0[plan.j_qa2], 0.0)
            # poly and its derivative (Horner)
            c = data[:, :5]
            poly = (((c[:, 4] * dx + c[:, 3]) * dx + c[:, 2]) * dx
                    + c[:, 1]) * dx + c[:, 0]
            dpoly = ((4.0 * c[:, 4] * dx + 3.0 * c[:, 3]) * dx
                     + 2.0 * c[:, 2]) * dx + c[:, 1]
            dpoly = jnp.where(jnp.asarray(plan.j_has2), dpoly, 0.0)
            rows = (jnp.asarray(plan.j_base1, dtype)
                    - dpoly[:, None] * jnp.asarray(plan.j_base2, dtype))
            pos = q1 - poly
            diag = dinv[plan.j_da1] + jnp.where(
                jnp.asarray(plan.j_has2), dinv[plan.j_da2], 0.0)
            active = eq_act0[js] & d.body_active[plan.j_body]
            emit_eq(rows, pos, eq_solref[js], eq_solimp[js], diag, active)

        if len(plan.tsel):
            # tendon couple: (L1 - L1_0) = poly(L2 - L2_0), same polynomial
            # form as joint couples but through the tendon moment rows
            ts = plan.tsel
            data = eq_data[ts]
            len0 = jnp.asarray(m.ten_length0, dtype)
            has2 = jnp.asarray(plan.t_has2)
            l1 = d.ten_length[plan.t_id1] - len0[plan.t_id1]
            dx = jnp.where(has2,
                           d.ten_length[plan.t_id2] - len0[plan.t_id2], 0.0)
            c = data[:, :5]
            poly = (((c[:, 4] * dx + c[:, 3]) * dx + c[:, 2]) * dx
                    + c[:, 1]) * dx + c[:, 0]
            dpoly = ((4.0 * c[:, 4] * dx + 3.0 * c[:, 3]) * dx
                     + 2.0 * c[:, 2]) * dx + c[:, 1]
            dpoly = jnp.where(has2, dpoly, 0.0)
            rows = (d.ten_J[plan.t_id1]
                    - dpoly[:, None] * d.ten_J[plan.t_id2])
            pos = l1 - poly
            tinv = jnp.asarray(m.ten_invweight0, dtype)
            diag = tinv[plan.t_id1] + jnp.where(has2, tinv[plan.t_id2], 0.0)
            active = eq_act0[ts]
            emit_eq(rows, pos, eq_solref[ts], eq_solimp[ts], diag, active)

        if len(plan.csel):
            cs = plan.csel
            o1 = lay.eq_obj1id[cs]
            o2 = lay.eq_obj2id[cs]
            data = eq_data[cs]
            anchor1, anchor2 = data[:, 0:3], data[:, 3:6]
            p1 = d.xpos[o1] + mm.rot_vec_quat(anchor1, d.xquat[o1])
            p2 = d.xpos[o2] + mm.rot_vec_quat(anchor2, d.xquat[o2])
            J1 = _point_jacobian(m, d, p1, o1, origin[o1])
            J2 = _point_jacobian(m, d, p2, o2, origin[o2])
            rows = (J1 - J2).reshape(-1, nv)         # (3*nC, nv)
            pos = (p1 - p2).reshape(-1)
            diag = jnp.repeat(binv[o1, 0] + binv[o2, 0], 3)
            active = jnp.repeat(eq_act0[cs] & d.body_active[o1], 3)
            emit_eq(rows, pos, jnp.repeat(eq_solref[cs], 3, axis=0),
                    jnp.repeat(eq_solimp[cs], 3, axis=0), diag, active)

        if len(plan.wsel):
            ws = plan.wsel
            o1 = lay.eq_obj1id[ws]
            o2 = lay.eq_obj2id[ws]
            data = eq_data[ws]
            anchor = data[:, 0:3]
            relpose_p = data[:, 3:6]
            relpose_q = data[:, 6:10]
            torquescale = data[:, 10]
            p2 = d.xpos[o2] + mm.rot_vec_quat(anchor, d.xquat[o2])
            target = d.xpos[o1] + mm.rot_vec_quat(
                relpose_p + mm.rot_vec_quat(anchor, relpose_q), d.xquat[o1])
            J2 = _point_jacobian(m, d, p2, o2, origin[o2])
            J1 = _point_jacobian(m, d, target, o1, origin[o1])
            rows_p = J2 - J1                         # (nW, 3, nv)
            pos_p = p2 - target
            q_target = mm.quat_mul(d.xquat[o1], relpose_q)
            q_err = mm.quat_mul(mm.quat_inv(q_target), d.xquat[o2])
            q_err = q_err * jnp.where(q_err[:, 0:1] < 0, -1.0, 1.0)
            pos_r = q_err[:, 1:] * torquescale[:, None]
            Jr2 = _rot_jacobian(m, d, o2)
            Jr1 = _rot_jacobian(m, d, o1)
            Rt = jnp.swapaxes(mm.quat_to_mat(q_target), -1, -2)
            rows_r = 0.5 * jnp.einsum("kij,kjv->kiv", Rt, Jr2 - Jr1) \
                * torquescale[:, None, None]
            rows = jnp.concatenate([rows_p, rows_r], axis=1).reshape(-1, nv)
            pos = jnp.concatenate([pos_p, pos_r], axis=1).reshape(-1)
            diag_p = (binv[o1, 0] + binv[o2, 0])[:, None].repeat(3, 1)
            diag_r = ((binv[o1, 1] + binv[o2, 1])
                      * torquescale * torquescale)[:, None].repeat(3, 1)
            diag = jnp.concatenate([diag_p, diag_r], axis=1).reshape(-1)
            active = jnp.repeat(eq_act0[ws] & d.body_active[o1], 6)
            emit_eq(rows, pos, jnp.repeat(eq_solref[ws], 6, axis=0),
                    jnp.repeat(eq_solimp[ws], 6, axis=0), diag, active)

        Jb = jnp.concatenate(blocks["J"], axis=0)
        posb = jnp.concatenate(blocks["pos"], axis=0)
        srb = jnp.concatenate(blocks["solref"], axis=0)
        sib = jnp.concatenate(blocks["solimp"], axis=0)
        diagb = jnp.concatenate(blocks["diag"], axis=0)
        actb = jnp.concatenate(blocks["active"], axis=0)
        if not plan.perm_is_identity:
            p = jnp.asarray(plan.perm)
            Jb, posb, srb, sib, diagb, actb = (
                Jb[p], posb[p], srb[p], sib[p], diagb[p], actb[p])
        if eq_off:
            actb = jnp.zeros_like(actb)
        emit(Jb, posb, srb, sib, diagb, actb, 0)

    # ---------------- dof friction loss ----------------
    if len(lay.fri_dofid):
        dofs = lay.fri_dofid
        n = len(dofs)
        rows = jnp.asarray(_onehot_rows(dofs, nv), dtype)
        active = jnp.full((n,), not (disable & int(DisableBit.FRICTIONLOSS)),
                          bool)
        emit(rows, jnp.zeros((n,), dtype),
             jnp.broadcast_to(jnp.asarray(m.opt.o_solref, dtype), (n, 2)),
             jnp.broadcast_to(jnp.asarray(m.opt.o_solimp, dtype), (n, 5)),
             dinv[dofs], active, 1,
             floss=jnp.asarray(m.dof_frictionloss, dtype)[dofs],
             flossrow=jnp.ones((n,), bool))

    # ---------------- joint limits (hinge/slide) ----------------
    if len(lay.lim_jntid):
        jids = lay.lim_jntid
        n = len(jids)
        qadr = lay.jnt_qposadr[jids]
        dadr = lay.jnt_dofadr[jids]
        rng = jnp.asarray(m.jnt_range, dtype)[jids]
        margin = jnp.asarray(m.jnt_margin, dtype)[jids]
        q = d.qpos[qadr]
        dist_lo = q - rng[:, 0]
        dist_hi = rng[:, 1] - q
        lower = dist_lo < dist_hi
        dist = jnp.where(lower, dist_lo, dist_hi)
        sign = jnp.where(lower, 1.0, -1.0).astype(dtype)
        rows = sign[:, None] * jnp.asarray(_onehot_rows(dadr, nv), dtype)
        active = (dist < margin) & d.body_active[lay.jnt_bodyid[jids]]
        if disable & int(DisableBit.LIMIT):
            active = jnp.zeros_like(active)
        emit(rows, dist - margin,
             jnp.asarray(m.jnt_solref, dtype)[jids],
             jnp.asarray(m.jnt_solimp, dtype)[jids],
             dinv[dadr], active, 2, margin=margin)

    # ---------------- tendon limits (fixed tendons) ----------------
    # same nearer-side single-row scheme as joint limits, with the static
    # tendon moment W_v as the row (MuJoCo mjCNSTR_LIMIT_TENDON)
    if len(lay.tlim_tenid):
        tids = lay.tlim_tenid
        Wv = d.ten_J[tids]                                 # (n, nv)
        length = d.ten_length[tids]
        rng = jnp.asarray(m.ten_range, dtype)[tids]
        margin = jnp.asarray(m.ten_margin, dtype)[tids]
        dist_lo = length - rng[:, 0]
        dist_hi = rng[:, 1] - length
        lower = dist_lo < dist_hi
        dist = jnp.where(lower, dist_lo, dist_hi)
        sign = jnp.where(lower, 1.0, -1.0).astype(dtype)
        rows = sign[:, None] * Wv
        active = dist < margin
        if disable & int(DisableBit.LIMIT):
            active = jnp.zeros_like(active)
        emit(rows, dist - margin,
             jnp.asarray(m.ten_solref, dtype)[tids],
             jnp.asarray(m.ten_solimp, dtype)[tids],
             jnp.asarray(m.ten_invweight0, dtype)[tids], active, 2,
             margin=margin)

    # ---------------- contacts (vectorized over the K budget) ----
    if m.ncon_max:
        from mujoco_sim_tpu.models.model import ConeType, contact_rows_per
        con = d.contact
        K = m.ncon_max
        mc = m.max_condim
        elliptic = m.opt.cone == int(ConeType.ELLIPTIC)
        nrows_per = contact_rows_per(mc, m.opt.cone)
        # all per-contact body lookups via one-hot matmuls instead of
        # dynamic element gathers; the (K, nbody) one-hots fuse.
        # geom->body is folded into the one-hot with a static 0/1 matrix.
        geom2body = np.zeros((m.ngeom, m.nbody))
        geom2body[np.arange(m.ngeom), lay.geom_bodyid] = 1.0
        g2b = jnp.asarray(geom2body, dtype)
        B1 = jax.nn.one_hot(con.geom1, m.ngeom, dtype=dtype) @ g2b  # (K,nb)
        B2 = jax.nn.one_hot(con.geom2, m.ngeom, dtype=dtype) @ g2b
        pos_c = con.pos            # (K, 3)
        frame = con.frame          # (K, 3, 3) rows n,t1,t2
        origin_of_body = d.subtree_com[lay.body_rootid]     # static gather
        o1 = B1 @ origin_of_body
        o2 = B2 @ origin_of_body
        anc = jnp.asarray(m.ancestor_mask, dtype)           # (nbody, nv)
        mask1 = B1 @ anc
        mask2 = B2 @ anc
        cdof = d.cdof
        ang, lin = cdof[:, :3], cdof[:, 3:]

        def point_jac(point, origin, mask):
            jac = lin.T[None] + jnp.cross(
                ang[None, :, :], (point - origin)[..., None, :]
            ).swapaxes(-1, -2)
            return jac * mask[:, None, :]

        Jp2 = point_jac(pos_c, o2, mask2)
        Jp1 = point_jac(pos_c, o1, mask1)
        Jdiff = Jp2 - Jp1          # (K, 3, nv)
        Jn = jnp.einsum("si,siv->sv", frame[:, 0], Jdiff)
        fric_axes = [
            jnp.einsum("si,siv->sv", frame[:, 1], Jdiff),
            jnp.einsum("si,siv->sv", frame[:, 2], Jdiff),
        ]
        if mc >= 4:
            Jrdiff = ang.T[None] * (mask2 - mask1)[:, None, :]
            fric_axes.append(jnp.einsum("si,siv->sv", frame[:, 0], Jrdiff))
            if mc >= 6:
                fric_axes.append(
                    jnp.einsum("si,siv->sv", frame[:, 1], Jrdiff))
                fric_axes.append(
                    jnp.einsum("si,siv->sv", frame[:, 2], Jrdiff))
        pen = con.dist - con.includemargin
        invw = (B1 + B2) @ binv[:, 0]
        con_active = con.active
        if disable & int(DisableBit.CONTACT):
            con_active = jnp.zeros_like(con_active)

        if mc == 1:
            rows = Jn[:, None, :]                      # (K,1,nv)
            diag_rows = invw[:, None]
            row_act = con_active[:, None]
        elif elliptic:
            # one row per contact dimension: [normal, t1, t2, tors, r1, r2].
            # Friction-row regularization follows the oracle exactly
            # (probed via mj_constraintUpdate, r2):
            #   R_i = R_normal * mu0^2 / (impratio * mu_i^2)
            # realized as diag_i = invw * mu0^2/(impratio mu_i^2) with the
            # friction rows sharing the normal row's efc_pos (hence its
            # impedance); the position term is removed from their aref below.
            axes = jnp.stack(fric_axes[: mc - 1], axis=1)   # (K, mc-1, nv)
            mu = con.friction[:, : mc - 1]                  # (K, mc-1)
            mu0 = con.friction[:, 0:1]
            impratio = jnp.asarray(m.opt.impratio, dtype)
            rows = jnp.concatenate([Jn[:, None, :], axes], axis=1)
            diag_fric = (invw[:, None] * mu0 * mu0
                         / (impratio * jnp.maximum(mu * mu, 1e-12)))
            diag_rows = jnp.concatenate([invw[:, None], diag_fric], axis=1)
            row_idx = np.arange(mc)                       # (mc,)
            row_act = con_active[:, None] & (
                jnp.asarray(row_idx)[None, :] < jnp.maximum(con.dim, 1)[:, None])
        else:
            axes = jnp.stack(fric_axes[: mc - 1], axis=1)   # (K, mc-1, nv)
            mu = con.friction[:, : mc - 1]                  # (K, mc-1)
            frictionless = (con.dim == 1)
            mu_eff = jnp.where(frictionless[:, None], 0.0, mu)
            plus = Jn[:, None, :] + mu_eff[..., None] * axes
            minus = Jn[:, None, :] - mu_eff[..., None] * axes
            rows = jnp.stack([plus, minus], axis=2).reshape(K, nrows_per, -1)
            dr = invw[:, None] * 2.0 * mu_eff * mu_eff * (1.0 + mu_eff * mu_eff)
            dr = jnp.where(frictionless[:, None], invw[:, None], dr)
            diag_rows = jnp.repeat(dr, 2, axis=1)
            # rows for friction axes beyond the contact's condim are masked;
            # frictionless contacts keep only the first +- pair (mu=0)
            axis_of_row = np.repeat(np.arange(mc - 1), 2)  # (nrows_per,)
            row_act = con_active[:, None] & (
                jnp.asarray(axis_of_row)[None, :]
                < jnp.maximum(con.dim - 1, 1)[:, None])
        emit(rows.reshape(K * nrows_per, nv),
             jnp.repeat(pen, nrows_per),
             jnp.repeat(con.solref, nrows_per, axis=0),
             jnp.repeat(con.solimp, nrows_per, axis=0),
             diag_rows.reshape(-1), row_act.reshape(-1), 3,
             margin=jnp.repeat(con.includemargin, nrows_per))

    efc_J = jnp.concatenate(secs["J"], axis=0)
    efc_pos = jnp.concatenate(secs["pos"], axis=0)
    efc_solref = jnp.concatenate(secs["solref"], axis=0)
    efc_solimp = jnp.concatenate(secs["solimp"], axis=0)
    efc_diag = jnp.concatenate(secs["diag"], axis=0)
    efc_floss = jnp.concatenate(secs["floss"], axis=0)
    efc_active = jnp.concatenate(secs["active"], axis=0)
    efc_type = jnp.concatenate(secs["type"], axis=0)
    efc_floss_row = jnp.concatenate(secs["flossrow"], axis=0)
    assert efc_J.shape[0] == nefc, (efc_J.shape, nefc)

    if disable & int(DisableBit.CONSTRAINT):
        efc_active = jnp.zeros_like(efc_active)

    # ---------------- aref / D / R ----------------
    k, b, imp = kbi(efc_solref, efc_solimp, efc_pos, dtype)
    vel = efc_J @ d.qvel
    aref = -b * vel - k * imp * efc_pos
    from mujoco_sim_tpu.models.model import ConeType as _CT
    if m.ncon_max and m.opt.cone == int(_CT.ELLIPTIC) and m.max_condim > 1:
        # elliptic friction rows: velocity damping only, no position term
        # (oracle efc_aref; they share the normal row's pos for impedance)
        from mujoco_sim_tpu.models.model import contact_rows_per
        rp = contact_rows_per(m.max_condim, m.opt.cone)
        fric_mask = np.zeros(nefc, dtype=bool)
        for kslot in range(m.ncon_max):
            base = m.contact_efcadr + kslot * rp
            fric_mask[base + 1: base + rp] = True
        aref = jnp.where(jnp.asarray(fric_mask),
                         aref + k * imp * efc_pos, aref)
    R = jnp.maximum((1.0 - imp) / jnp.maximum(imp, _MINIMP) * efc_diag,
                    1e-12)
    D = 1.0 / R
    return d.replace(
        efc_J=efc_J, efc_D=jnp.where(efc_active, D, 0.0),
        efc_R=R, efc_aref=aref,
        efc_frictionloss=efc_floss,
        efc_floss_active=efc_floss_row,
        efc_active=efc_active, efc_type=efc_type,
    )
