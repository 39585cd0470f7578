"""Smooth (unconstrained) dynamics kernels: FK, COM frame, CRB, RNEA.

Batched re-implementation of the MuJoCo pipeline stages the reference
calls through mj_step1/mj_forward/mj_mulM/mj_inverse (SURVEY.md §2.2;
reference call sites: src/mj_main.cpp:83, src/mujoco_sim/mj_sim.cpp:1057,
src/mujoco_sim/mj_hw_interface.cpp:61).

Design: single-env functions (vmap for the env axis).  Tree structure is
baked in as *static* numpy index arrays (Model.layout), so every
(level, joint-slot, joint-type) subgroup becomes a fully vectorized,
branch-free gather/compute/scatter; the O(nv^2) work (mass matrix, bias
projection) is expressed as batched einsums.

Quantities match MuJoCo's c-frame convention (world orientation, origin at
the subtree COM of each body's root) so cdof/cvel/qM are directly
oracle-comparable.
"""

from __future__ import annotations

from functools import wraps

import jax
import jax.numpy as jnp
import numpy as np

from mujoco_sim_tpu.models.model import Model, JointType
from mujoco_sim_tpu.ops import math as mm


def _fp(fn):
    """Force true-f32 matmuls regardless of caller context.

    These kernels are built on constant-mask matmuls (FK pointer doubling,
    tree-prefix sums); GPU f32 matmuls may run in TF32 (about three
    decimal digits) unless a precision is asked for, which would silently
    corrupt any eager caller outside engine's _full_precision-wrapped entry
    points (engine.set_const computes efc_D from inv(qM)).
    """
    @wraps(fn)
    def wrapper(*args, **kwargs):
        with jax.default_matmul_precision("highest"):
            return fn(*args, **kwargs)
    return wrapper


_PLAN_CACHE: dict = {}


def _subsets_by_joint(m: Model):
    """Static iteration plan: per level, per joint slot, per joint type.

    Returns list of (level_bodies, slots) with all arrays static numpy.
    Cached per Layout (rebuilt plans dominate trace time on big models).
    """
    lay = m.layout
    cached = _PLAN_CACHE.get(lay)
    if cached is not None:
        return cached
    plan = []
    for level in m.body_levels:
        bid = np.asarray(level, dtype=int)
        maxslots = int(lay.body_jntnum[bid].max()) if len(bid) else 0
        slots = []
        for k in range(maxslots):
            has = lay.body_jntnum[bid] > k
            bsub = bid[has]
            jsub = lay.body_jntadr[bsub] + k
            groups = []
            for jt in (JointType.FREE, JointType.BALL, JointType.SLIDE,
                       JointType.HINGE):
                sel = lay.jnt_type[jsub] == int(jt)
                if sel.any():
                    groups.append((int(jt), bsub[sel], jsub[sel]))
            slots.append(groups)
        plan.append((bid, slots))
    _PLAN_CACHE[lay] = plan
    return plan


def _fk_plan(m: Model, mocap_on: bool):
    """Static pointer-doubling FK plan (cached per Layout).

    The former level-by-level FK walked the tree depth-first with
    per-level gathers/scatters (~470 HLO ops on PR2, r3 profile).  Here
    every body's LOCAL transform (offset + its joints) is computed in one
    type-masked batched pass, then world poses come from ceil(log2(depth))
    pointer-doubling composition steps — each a single constant one-hot
    matmul + quaternion compose over ALL bodies at once.
    """
    lay = m.layout
    key = (lay, "fkplan", mocap_on)
    got = _PLAN_CACHE.get(key)
    if got is not None:
        return got
    nb = m.nbody
    njnt = m.njnt
    nq = max(int(m.nq), 1)
    parent = np.asarray(lay.body_parentid).copy()
    jt = np.asarray(lay.jnt_type)
    qadr = np.asarray(lay.jnt_qposadr)
    jbody = np.asarray(lay.jnt_bodyid)
    is_free = jt == int(JointType.FREE)
    is_ball = jt == int(JointType.BALL)
    is_slide = jt == int(JointType.SLIDE)
    is_hinge = jt == int(JointType.HINGE)
    # absolute-pose bodies compose with nothing: free-jointed (qpos IS the
    # world pose) and, when mocap arrays are supplied, mocap bodies
    absolute = np.zeros(nb, dtype=bool)
    absolute[jbody[is_free]] = True
    mocap_sel = np.asarray(lay.body_mocapid) >= 0
    if mocap_on:
        absolute |= mocap_sel
    P = parent.copy()
    P[absolute] = 0
    P[0] = 0
    mats = []
    Pk = P
    while np.any(Pk != 0):
        M = np.zeros((nb, nb))
        M[np.arange(nb), Pk] = 1.0
        mats.append(M)
        Pk = Pk[Pk]
    # per-slot body<-joint one-hot selectors
    jntnum = np.asarray(lay.body_jntnum)
    jntadr = np.asarray(lay.body_jntadr)
    slots = []
    maxslots = int(jntnum.max()) if nb else 0
    for k in range(maxslots):
        has = jntnum > k
        B = np.zeros((nb, max(njnt, 1)))
        B[np.nonzero(has)[0], jntadr[has] + k] = 1.0
        slots.append((B, has.astype(np.float64)[:, None]))
    # qpos gather indices (clipped so non-applicable types read safely)
    scal_idx = np.clip(qadr, 0, nq - 1)
    qstart = qadr + np.where(is_free, 3, 0)
    quat_idx = np.clip(qstart[:, None] + np.arange(4), 0, nq - 1)
    pos3_idx = np.clip(qadr[:, None] + np.arange(3), 0, nq - 1)
    # original-parent and joint<-body one-hot selectors for anchors
    par_oh = np.zeros((nb, nb))
    par_oh[np.arange(nb), parent] = 1.0
    j2b = np.zeros((max(njnt, 1), nb))
    j2b[np.arange(njnt), jbody[:njnt]] = 1.0
    # mocap body <- mocap id one-hot
    mc_oh = None
    if mocap_on and m.nmocap:
        mc_oh = np.zeros((nb, m.nmocap))
        mids = np.asarray(lay.body_mocapid)
        mc_oh[np.nonzero(mocap_sel)[0], mids[mocap_sel]] = 1.0
    got = dict(mats=mats, slots=slots, scal_idx=scal_idx, quat_idx=quat_idx,
               pos3_idx=pos3_idx, par_oh=par_oh, j2b=j2b, mc_oh=mc_oh,
               is_free=is_free, is_ball=is_ball, is_slide=is_slide,
               is_hinge=is_hinge, abs_free=absolute & ~(
                   mocap_sel if mocap_on else np.zeros(nb, bool)),
               mocap_sel=mocap_sel,
               f2b=(j2b * is_free[:, None]).T if njnt else None)
    _PLAN_CACHE[key] = got
    return got


@_fp
def kinematics(m: Model, qpos: jax.Array, mocap_pos=None, mocap_quat=None):
    """Forward kinematics: body/geom/site frames (mj_kinematics equivalent).

    Mocap bodies take their pose from (mocap_pos, mocap_quat) directly — the
    '_ref' twin mechanism of the reference's multi-instance sync
    (mj_sim.cpp:847-960).  World poses via batched local transforms +
    pointer-doubling composition (_fk_plan)."""
    lay = m.layout
    dtype = qpos.dtype
    nb = m.nbody
    njnt = m.njnt
    mocap_on = bool(mocap_pos is not None and m.nmocap)
    plan = _fk_plan(m, mocap_on)
    ident4 = jnp.zeros((1, 4), dtype).at[0, 0].set(1.0)

    if njnt:
        # ---- per-joint local transforms, one type-masked batched pass
        jpos = m.jnt_pos.astype(dtype)
        jaxis = m.jnt_axis.astype(dtype)
        val = qpos[plan["scal_idx"]] - m.jnt_ref.astype(dtype)   # (njnt,)
        q4 = mm.quat_normalize(qpos[plan["quat_idx"]])           # ball/free
        q_h = mm.axis_angle_to_quat(jaxis, val)
        is_h = jnp.asarray(plan["is_hinge"])[:, None]
        is_b = jnp.asarray(plan["is_ball"])[:, None]
        is_s = jnp.asarray(plan["is_slide"])[:, None]
        is_f = jnp.asarray(plan["is_free"])[:, None]
        qloc = jnp.where(is_h, q_h, jnp.where(is_b, q4, ident4))
        # rotation about the anchor: p_F = jpos - R(qloc) jpos
        p_rot = jpos - mm.rot_vec_quat(jpos, qloc)
        p_f = jnp.where(is_s, jaxis * val[:, None],
                        jnp.where(is_f, 0.0, p_rot))
        free_pos = qpos[plan["pos3_idx"]]                        # (njnt, 3)

        # ---- per-body joint composition (runs in the post-offset L0
        # frame; anchors/axes recorded pre-joint, MuJoCo convention)
        run_p = jnp.zeros((nb, 3), dtype)
        run_q = jnp.broadcast_to(ident4, (nb, 4))
        anchor_l = jnp.zeros((njnt, 3), dtype)
        axis_l = jnp.zeros((njnt, 3), dtype)
        for (B_np, has_np) in plan["slots"]:
            Bk = jnp.asarray(B_np, dtype)
            has = jnp.asarray(has_np, dtype)
            jp_b = Bk @ jpos
            ja_b = Bk @ jaxis
            anc_b = run_p + mm.rot_vec_quat(jp_b, run_q)
            axw_b = mm.rot_vec_quat(ja_b, run_q)
            anchor_l = anchor_l + Bk.T @ (anc_b * has)
            axis_l = axis_l + Bk.T @ (axw_b * has)
            qloc_b = Bk @ qloc
            qloc_b = jnp.where(has > 0.5, qloc_b, ident4)
            pf_b = Bk @ p_f
            run_p = run_p + mm.rot_vec_quat(pf_b, run_q) * has
            run_q = mm.quat_mul(run_q, qloc_b)
        lp = m.body_pos.astype(dtype) + mm.rot_vec_quat(
            run_p, m.body_quat.astype(dtype))
        lq = mm.quat_normalize(
            mm.quat_mul(m.body_quat.astype(dtype), run_q))
        # free-jointed bodies: qpos is the absolute world pose
        if plan["abs_free"].any():
            F2B = jnp.asarray(plan["f2b"], dtype)     # (nbody, njnt)
            absf = jnp.asarray(plan["abs_free"])[:, None]
            lp = jnp.where(absf, F2B @ free_pos, lp)
            lq = jnp.where(absf, F2B @ q4, lq)
    else:
        lp = m.body_pos.astype(dtype)
        lq = m.body_quat.astype(dtype)
        anchor_l = jnp.zeros((0, 3), dtype)
        axis_l = jnp.zeros((0, 3), dtype)
        free_pos = jnp.zeros((0, 3), dtype)
        is_f = jnp.zeros((0, 1), bool)

    if mocap_on and plan["mc_oh"] is not None:
        MC = jnp.asarray(plan["mc_oh"], dtype)
        mcm = jnp.asarray(plan["mocap_sel"])[:, None]
        lp = jnp.where(mcm, MC @ mocap_pos.astype(dtype), lp)
        lq = jnp.where(mcm, mm.quat_normalize(MC @ mocap_quat.astype(dtype)),
                       lq)

    # ---- pointer doubling: world = prod of ancestor locals
    for M_np in plan["mats"]:
        Mk = jnp.asarray(M_np, dtype)
        G = Mk @ jnp.concatenate([lp, lq], axis=1)
        gp, gq = G[:, :3], G[:, 3:]
        lp = gp + mm.rot_vec_quat(lp, gq)
        lq = mm.quat_normalize(mm.quat_mul(gq, lq))
    xpos, xquat = lp, lq

    # ---- joint anchors/axes in world (pre-joint L0 frame per body)
    if njnt:
        PAR = jnp.asarray(plan["par_oh"], dtype)
        Gp = PAR @ jnp.concatenate([xpos, xquat], axis=1)
        p_par, q_par = Gp[:, :3], Gp[:, 3:]
        p_l0 = p_par + mm.rot_vec_quat(m.body_pos.astype(dtype), q_par)
        q_l0 = mm.quat_mul(q_par, m.body_quat.astype(dtype))
        J2B = jnp.asarray(plan["j2b"], dtype)
        Gj = J2B @ jnp.concatenate([p_l0, q_l0], axis=1)
        xanchor = Gj[:, :3] + mm.rot_vec_quat(anchor_l, Gj[:, 3:])
        xaxis = mm.rot_vec_quat(axis_l, Gj[:, 3:])
        xanchor = jnp.where(is_f, free_pos, xanchor)
        xaxis = jnp.where(is_f, jnp.asarray([0.0, 0.0, 1.0], dtype), xaxis)
    else:
        xanchor = jnp.zeros((0, 3), dtype)
        xaxis = jnp.zeros((0, 3), dtype)

    xmat = mm.quat_to_mat(xquat)
    xipos = xpos + mm.rot_vec_quat(m.body_ipos.astype(dtype), xquat)
    ximat = mm.quat_to_mat(mm.quat_mul(xquat, m.body_iquat.astype(dtype)))
    geom_q = mm.quat_mul(xquat[lay.geom_bodyid], m.geom_quat.astype(dtype))
    geom_xpos = (xpos[lay.geom_bodyid]
                 + mm.rot_vec_quat(m.geom_pos.astype(dtype),
                                   xquat[lay.geom_bodyid]))
    geom_xmat = mm.quat_to_mat(geom_q)
    site_q = mm.quat_mul(xquat[lay.site_bodyid], m.site_quat.astype(dtype))
    site_xpos = (xpos[lay.site_bodyid]
                 + mm.rot_vec_quat(m.site_pos.astype(dtype),
                                   xquat[lay.site_bodyid]))
    site_xmat = mm.quat_to_mat(site_q)
    return dict(xpos=xpos, xquat=xquat, xmat=xmat, xipos=xipos, ximat=ximat,
                xanchor=xanchor, xaxis=xaxis, geom_xpos=geom_xpos,
                geom_xmat=geom_xmat, site_xpos=site_xpos, site_xmat=site_xmat)


@_fp
def com_pos(m: Model, kin: dict, mass=None, inertia=None):
    """Subtree COM, c-frame body inertias, dof axes (mj_comPos equivalent).

    mass/inertia default to the compiled model values; the engine passes the
    Data-resident copies so spawn-time inertial overrides (runtime/sim.py)
    take effect without retracing."""
    lay = m.layout
    xipos = kin["xipos"]
    ximat = kin["ximat"]
    dtype = xipos.dtype
    mass = (jnp.asarray(m.body_mass, dtype) if mass is None
            else mass.astype(dtype))
    body_inertia = (jnp.asarray(m.body_inertia, dtype) if inertia is None
                    else inertia.astype(dtype))

    # subtree com: one subtree-mask matmul (see _tree_masks; the former
    # level-loop scatter-adds cost ~2 HLO ops per level on the dispatch-
    # bound flagship step)
    S = jnp.asarray(_tree_masks(m)["sub"], dtype)
    momm = jnp.concatenate([mass[:, None] * xipos, mass[:, None]], axis=1)
    sub = S @ momm                                   # (nbody, 4)
    sub_mass = sub[:, 3]
    subtree_com = sub[:, :3] / jnp.maximum(sub_mass, 1e-12)[:, None]

    # c-frame origin per body: subtree_com of its root
    origin = subtree_com[lay.body_rootid]

    # spatial inertia of each body about its c-frame origin
    # R diag(I) R^T as mul+reduce (a K=3 contraction fuses this way)
    RI = ximat * body_inertia[..., None, :]
    inert_world = (RI[..., :, None, :] * ximat[..., None, :, :]).sum(-1)
    cinert = mm.spatial_inertia(mass, inert_world, xipos - origin)

    # cdof
    cdof = jnp.zeros((m.nv, 6), dtype)
    jnt_body = lay.jnt_bodyid
    for jt in (JointType.FREE, JointType.BALL, JointType.SLIDE,
               JointType.HINGE):
        jsel = np.nonzero(lay.jnt_type == int(jt))[0]
        if len(jsel) == 0:
            continue
        dadr = lay.jnt_dofadr[jsel]
        b = jnt_body[jsel]
        O = origin[b]
        anchor = kin["xanchor"][jsel]
        if jt == JointType.SLIDE:
            ax = kin["xaxis"][jsel]
            col = jnp.concatenate([jnp.zeros_like(ax), ax], axis=-1)
            cdof = cdof.at[dadr].set(col)
        elif jt == JointType.HINGE:
            ax = kin["xaxis"][jsel]
            lin = jnp.cross(ax, O - anchor)
            cdof = cdof.at[dadr].set(jnp.concatenate([ax, lin], axis=-1))
        elif jt == JointType.BALL:
            R = kin["xmat"][b]  # child frame columns: local-frame qvel
            for i in range(3):
                ax = R[:, :, i]
                lin = jnp.cross(ax, O - anchor)
                cdof = cdof.at[dadr + i].set(
                    jnp.concatenate([ax, lin], axis=-1))
        else:  # FREE: 3 world translations + 3 local-frame rotations @ origin
            e = jnp.eye(3, dtype=dtype)
            zero = jnp.zeros((len(jsel), 3), dtype)
            for i in range(3):
                col = jnp.concatenate(
                    [zero, jnp.broadcast_to(e[i], (len(jsel), 3))], axis=-1)
                cdof = cdof.at[dadr + i].set(col)
            R = kin["xmat"][b]
            for i in range(3):
                ax = R[:, :, i]
                lin = jnp.cross(ax, O - anchor)
                cdof = cdof.at[dadr + 3 + i].set(
                    jnp.concatenate([ax, lin], axis=-1))
    return dict(subtree_com=subtree_com, cinert=cinert, cdof=cdof,
                origin=origin)


@_fp
def com_vel(m: Model, com: dict, qvel: jax.Array):
    """Body spatial velocities + cdof time-derivatives (mj_comVel).

    cvel[b] = sum of cdof_d qvel_d over ancestor-or-self dofs, and
    cdof_dot[d] = v_pre(d) x* cdof[d] with v_pre the velocity accumulated
    strictly before d's joint (free-joint rotational dofs also see their
    own translations — MuJoCo convention).  Both prefixes are static tree
    sums, evaluated as two constant-mask matmuls (_tree_masks) instead of
    the former per-level scatter loop (~100 HLO ops on PR2)."""
    cdof = com["cdof"]
    dtype = cdof.dtype
    masks = _tree_masks(m)
    contrib = cdof * qvel[:, None]                     # (nv, 6)
    v_pre = jnp.asarray(masks["pre"], dtype) @ contrib  # (nv, 6)
    cdof_dot = mm.motion_cross(v_pre, cdof)
    cvel = jnp.asarray(m.ancestor_mask, dtype) @ contrib  # (nbody, 6)
    return dict(cvel=cvel, cdof_dot=cdof_dot)


_MASK_CACHE: dict = {}


def _tree_masks(m: Model):
    """Static 0/1 masks that turn tree accumulations into single matmuls.

    The level-by-level scatter-add loops (subtree COM, composite inertia,
    spatial-velocity and qacc=0-acceleration propagation) each cost dozens
    of small gather/scatter HLO ops per step; as (nbody, nbody)/(nv, nv)
    constant-mask matmuls they are single ops with identical semantics (the
    sums commute; only f.p. association order changes).

    Returns dict:
      sub  (nbody, nbody): sub[b, c] = 1 iff b is ancestor-or-self of c
                           (X_subtree = sub @ X)
      pre  (nv, nv): pre[d, e] = 1 iff dof e belongs to a joint processed
                     strictly before dof d's joint along d's kinematic
                     chain (ancestor bodies' joints + earlier joint slots
                     on the same body), PLUS the free-joint convention
                     that rotational dofs see their own joint's
                     translational dofs (mj_comVel: rotation axes ride
                     the already-translating frame).
    """
    lay = m.layout
    got = _MASK_CACHE.get(lay)
    if got is not None:
        return got
    nb, nv = m.nbody, m.nv
    parent = np.asarray(lay.body_parentid)
    # ancestor-or-self body matrix
    anc = np.zeros((nb, nb))
    for c in range(nb):
        b = c
        while b >= 0:
            anc[b, c] = 1.0
            b = parent[b] if b != 0 else -1
    # dof -> joint, joint slot order
    jnt_of_dof = np.zeros(nv, dtype=int)
    ndof_of = {int(JointType.FREE): 6, int(JointType.BALL): 3,
               int(JointType.SLIDE): 1, int(JointType.HINGE): 1}
    for j in range(len(lay.jnt_type)):
        a = lay.jnt_dofadr[j]
        jnt_of_dof[a:a + ndof_of[int(lay.jnt_type[j])]] = j
    dof_body = np.asarray(lay.dof_bodyid)
    pre = np.zeros((nv, nv))
    for d in range(nv):
        jd = jnt_of_dof[d]
        bd = dof_body[d]
        for e in range(nv):
            je = jnt_of_dof[e]
            be = dof_body[e]
            if be == bd:
                if je < jd:          # earlier joint slot on the same body
                    pre[d, e] = 1.0
                elif je == jd and int(lay.jnt_type[jd]) == int(JointType.FREE):
                    # free joint: rotational dofs (3..5) see translations
                    if (d - lay.jnt_dofadr[jd]) >= 3 and \
                            (e - lay.jnt_dofadr[jd]) < 3:
                        pre[d, e] = 1.0
            elif anc[be, bd] and be != bd:
                pre[d, e] = 1.0
    got = dict(sub=anc, pre=pre)
    _MASK_CACHE[lay] = got
    return got


_ANC_CACHE: dict = {}


def _dof_ancestor_upper(m: Model):
    """Upper-triangular ancestor-or-self dof mask (cached per Layout)."""
    lay = m.layout
    got = _ANC_CACHE.get(lay)
    if got is not None:
        return got
    A = np.zeros((m.nv, m.nv), dtype=bool)
    for j in range(m.nv):
        i = j
        while i >= 0:
            A[i, j] = True
            i = lay.dof_parentid[i]
    Au = np.triu(A)
    _ANC_CACHE[lay] = Au
    return Au


@_fp
def crb(m: Model, com: dict):
    """Dense joint-space inertia matrix via composite-rigid-body (mj_crb).

    M_ij = cdof_i^T IC_{body(j)} cdof_j for i ancestor-or-self of j, where
    IC is the subtree composite inertia.  Batched over envs this becomes one
    big einsum instead of MuJoCo's sparse CPU recursion.
    """
    lay = m.layout
    cinert = com["cinert"]
    cdof = com["cdof"]
    dtype = cdof.dtype

    # composite inertia: one subtree-mask matmul (see _tree_masks)
    S = jnp.asarray(_tree_masks(m)["sub"], dtype)
    IC = (S @ cinert.reshape(m.nbody, 36)).reshape(m.nbody, 6, 6)

    # F_j = IC_{body(j)} @ cdof_j
    F = jnp.einsum("juv,jv->ju", IC[lay.dof_bodyid], cdof)
    W = cdof @ F.T  # (nv, nv): W_ij = cdof_i . F_j
    Au = jnp.asarray(_dof_ancestor_upper(m))
    Wu = jnp.where(Au, W, 0.0)
    qM = Wu + Wu.T - jnp.diag(jnp.diag(Wu))
    qM = qM + jnp.diag(m.dof_armature.astype(dtype))
    return qM


@_fp
def rne(m: Model, com: dict, vel: dict, qvel: jax.Array,
        gravity_on=True):
    """Bias force C(q,qvel)·qvel + gravity (mj_rne with qacc=0)."""
    cdof, cinert = com["cdof"], com["cinert"]
    cvel, cdof_dot = vel["cvel"], vel["cdof_dot"]
    dtype = cdof.dtype

    # qacc=0 spatial accelerations: a_b = a_parent + sum cdof_dot_d qvel_d,
    # with the gravity trick a_world = [0; -g]
    g = m.opt.gravity.astype(dtype)
    a0 = jnp.concatenate([jnp.zeros(3, dtype), -g]) if gravity_on else jnp.zeros(6, dtype)
    # cacc[b] = a0 + sum of cdof_dot_d qvel_d over ancestor-or-self dofs:
    # one ancestor-mask matmul (see _tree_masks) instead of the former
    # per-level propagation loop
    mask = jnp.asarray(m.ancestor_mask, dtype)  # (nbody, nv)
    cacc = a0 + mask @ (cdof_dot * qvel[:, None])

    # per-body bias force: f = I a + v x* (I v)
    Iv = jnp.einsum("buv,bv->bu", cinert, cvel)
    f = jnp.einsum("buv,bv->bu", cinert, cacc) + mm.force_cross(cvel, Iv)
    # project through ancestors: qfrc_bias_d = cdof_d . sum_{b in subtree} f_b
    qfrc_bias = jnp.einsum("du,bu,bd->d", cdof, f, mask)
    return qfrc_bias


def mul_m(m: Model, qM: jax.Array, vec: jax.Array) -> jax.Array:
    """M @ v (mj_mulM equivalent, used by the computed-torque controller;
    reference: src/mujoco_sim/mj_sim.cpp:1057)."""
    return qM @ vec


def factor_chol(qM: jax.Array) -> jax.Array:
    # ops/linalg unrolled/blocked kernels: they fuse into the step program
    # at robot-sim sizes
    from mujoco_sim_tpu.ops import linalg
    return linalg.cholesky(qM)


def solve_chol(L: jax.Array, rhs: jax.Array) -> jax.Array:
    from mujoco_sim_tpu.ops import linalg
    return linalg.cho_solve(L, rhs)
