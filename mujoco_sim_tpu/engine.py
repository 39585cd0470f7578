"""Public engine API: make_data, forward, step, inverse.

Batched JAX replacement for the libmujoco step pipeline the reference drives
through mj_step1/mj_step2/mj_forward/mj_inverse (reference call sites:
src/mj_main.cpp:83,108; src/mujoco_sim/mj_ros.cpp:608; mj_hw_interface.cpp:61).

All functions are pure: ``d' = f(m, d)``; batching is ``jax.vmap`` over Data,
sharding is pjit/shard_map over the env axis (mujoco_sim_tpu.parallel).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from functools import wraps

from mujoco_sim_tpu.models.model import (
    Model, Data, Contact, Integrator, DisableBit,
)
from mujoco_sim_tpu.ops import smooth, passive as passive_mod, support
from mujoco_sim_tpu.ops import integrate as integrate_mod


def _full_precision(fn):
    """GPU f32 matmuls may run in TF32 (about three decimal digits) unless
    a precision is asked for; mass-matrix/solver linear algebra needs true
    f32 or the Cholesky factor NaNs out on stiff contact rows."""

    @wraps(fn)
    def wrapper(*args, **kwargs):
        with jax.default_matmul_precision("highest"):
            return fn(*args, **kwargs)

    return wrapper


def put_model(m: Model, dtype=jnp.float32, device=None) -> Model:
    """Cast float leaves and place the model on device."""
    def cast(x):
        x = jnp.asarray(x)
        if jnp.issubdtype(x.dtype, jnp.floating):
            x = x.astype(dtype)
        if device is not None:
            x = jax.device_put(x, device)
        return x

    return jax.tree.map(cast, m)


def _mocap_pos0(m: Model, dtype):
    ids = np.nonzero(np.asarray(m.layout.body_mocapid) >= 0)[0]
    return jnp.asarray(np.asarray(m.body_pos)[ids], dtype)


def _mocap_quat0(m: Model, dtype):
    ids = np.nonzero(np.asarray(m.layout.body_mocapid) >= 0)[0]
    return jnp.asarray(np.asarray(m.body_quat)[ids], dtype)


def make_data(m: Model, dtype=None, keyframe=None) -> Data:
    """Fresh Data at qpos0 (mj_makeData + reset equivalent).

    keyframe: optional <keyframe><key> name or index — the returned Data
    starts from that snapshot (mj_resetDataKeyframe equivalent).
    """
    if dtype is None:
        dtype = jnp.asarray(m.qpos0).dtype
    z = lambda *shape: jnp.zeros(shape, dtype)
    nv, nbody, njnt = m.nv, m.nbody, m.njnt
    ncon, nefc = m.ncon_max, m.nefc_max
    contact = Contact(
        dist=z(ncon), pos=z(ncon, 3), frame=z(ncon, 3, 3),
        geom1=jnp.full((ncon,), -1, jnp.int32),
        geom2=jnp.full((ncon,), -1, jnp.int32),
        includemargin=z(ncon), friction=z(ncon, 5),
        solref=z(ncon, 2), solimp=z(ncon, 5),
        dim=jnp.ones((ncon,), jnp.int32),
        efc_address=jnp.full((ncon,), -1, jnp.int32),
        active=jnp.zeros((ncon,), bool),
    )
    d = Data(
        time=jnp.asarray(0.0, dtype),
        qpos=jnp.asarray(m.qpos0, dtype),
        qvel=z(nv), qacc=z(nv), qacc_warmstart=z(nv),
        qfrc_applied=z(nv), xfrc_applied=z(nbody, 6),
        ctrl=z(m.nu), act=z(m.nu), act_dot=z(m.nu),
        actuator_length=z(m.nu), actuator_velocity=z(m.nu),
        actuator_force=z(m.nu), qfrc_actuator=z(nv),
        ten_length=z(m.ntendon), ten_velocity=z(m.ntendon),
        ten_J=z(m.ntendon, nv),
        body_active=jnp.ones((nbody,), bool),
        geom_size=jnp.asarray(m.geom_size, dtype),
        geom_rbound=jnp.asarray(m.geom_rbound, dtype),
        geom_rgba=jnp.asarray(m.geom_rgba, dtype),
        body_mass=jnp.asarray(m.body_mass, dtype),
        body_inertia=jnp.asarray(m.body_inertia, dtype),
        mocap_pos=_mocap_pos0(m, dtype),
        mocap_quat=_mocap_quat0(m, dtype),
        xpos=z(nbody, 3), xquat=z(nbody, 4).at[:, 0].set(1.0),
        xipos=z(nbody, 3), ximat=z(nbody, 3, 3),
        xanchor=z(njnt, 3), xaxis=z(njnt, 3),
        geom_xpos=z(m.ngeom, 3), geom_xmat=z(m.ngeom, 3, 3),
        site_xpos=z(m.nsite, 3), site_xmat=z(m.nsite, 3, 3),
        subtree_com=z(nbody, 3),
        cvel=z(nbody, 6), cdof=z(nv, 6), cdof_dot=z(nv, 6),
        qM=z(nv, nv), qLD=z(nv, nv),
        qfrc_bias=z(nv), qfrc_passive=z(nv), qfrc_spring=z(nv),
        qfrc_damper=z(nv), qfrc_gravcomp=z(nv), qfrc_smooth=z(nv),
        qacc_smooth=z(nv), qfrc_constraint=z(nv), qfrc_inverse=z(nv),
        contact=contact, ncon=jnp.asarray(0, jnp.int32),
        efc_J=z(nefc, nv), efc_D=z(nefc), efc_aref=z(nefc), efc_R=z(nefc),
        efc_frictionloss=z(nefc),
        efc_floss_active=jnp.zeros((nefc,), bool),
        efc_active=jnp.zeros((nefc,), bool),
        efc_type=jnp.zeros((nefc,), jnp.int32),
        efc_force=z(nefc),
        sensordata=z(m.nsensordata),
        energy=z(2),
    )
    if keyframe is not None:
        kid = (m.names.key_id(keyframe) if isinstance(keyframe, str)
               else int(keyframe))
        if kid < 0 or kid >= m.nkey:
            raise ValueError(f"unknown keyframe {keyframe!r}")
        d = d.replace(
            time=jnp.asarray(m.key_time, dtype)[kid],
            qpos=jnp.asarray(m.key_qpos, dtype)[kid],
            qvel=jnp.asarray(m.key_qvel, dtype)[kid],
            act=jnp.asarray(m.key_act, dtype)[kid],
            ctrl=jnp.asarray(m.key_ctrl, dtype)[kid],
            mocap_pos=jnp.asarray(m.key_mpos, dtype)[kid],
            mocap_quat=jnp.asarray(m.key_mquat, dtype)[kid],
        )
    return d


def set_const(m: Model) -> Model:
    """Compute qpos0-derived constants: dof/body invweight0 (mj_setConst).

    These feed the constraint regularization diagApprox (ops/constraint.py).
    """
    # _full_precision is load-bearing here: set_const runs on the default
    # backend, and reduced-precision (TF32) matmuls through the FK/CRB
    # mask-matmul kernels corrupt qM -> inv(qM) -> invweight0 -> efc_D,
    # which explodes to 1e12 (Newton Cholesky breakdown, qvel 1e7)
    @jax.jit
    @_full_precision
    def _compute(m):
        qpos0 = jnp.asarray(m.qpos0)
        kin = smooth.kinematics(m, qpos0)
        com = smooth.com_pos(m, kin)
        qM = smooth.crb(m, com)
        Minv = jnp.linalg.inv(qM)
        dof_invweight0 = jnp.diag(Minv)

        dtype = qpos0.dtype
        lay = m.layout
        origin = com["subtree_com"][lay.body_rootid]
        cdof = com["cdof"]
        ang, lin = cdof[:, :3], cdof[:, 3:]
        mask = jnp.asarray(m.ancestor_mask, dtype)  # (nbody, nv)
        r = kin["xipos"] - origin  # (nbody, 3)
        # translational jacobian at body COM: (nbody, 3, nv)
        Jt = (lin.T[None] + jnp.cross(ang[None, :, :],
                                      r[:, None, :]).swapaxes(-1, -2))
        Jt = Jt * mask[:, None, :]
        Jr = ang.T[None] * mask[:, None, :]
        At = jnp.einsum("biv,vw,biw->b", Jt, Minv, Jt) / 3.0
        Ar = jnp.einsum("biv,vw,biw->b", Jr, Minv, Jr) / 3.0
        body_invweight0 = jnp.stack([At, Ar], axis=-1)
        if m.ntendon:
            from mujoco_sim_tpu.ops import tendon as tendon_mod
            origin_body = com["subtree_com"][lay.body_rootid]
            length0, W = tendon_mod.tendon_quantities(
                m, qpos0, kin["site_xpos"], com["cdof"], origin_body,
                kin["geom_xpos"], kin["geom_xmat"],
                jnp.asarray(m.geom_size, dtype))
            ten_invweight0 = ((W @ Minv) * W).sum(-1)
            # spatial-tendon springlength defaults were NaN-marked at
            # compile (the wrap path needs the full qpos0 evaluation)
            springlength = jnp.where(jnp.isnan(m.ten_springlength),
                                     length0[:, None], m.ten_springlength)
        else:
            W = None
            ten_invweight0 = jnp.zeros((0,), dtype)
            springlength = m.ten_springlength
            length0 = jnp.zeros((0,), dtype)
        if m.nu:
            # actuator_acc0 = |M^-1 moment| at qpos0 (site rows stay 0 —
            # muscle-on-site raises at compile)
            gear0 = m.actuator_gear[:, 0]
            mom = jnp.asarray(lay.act_moment01, dtype) * gear0[:, None]
            from mujoco_sim_tpu.models.model import TrnType as _TT
            ten_rows = np.nonzero(lay.act_trntype == int(_TT.TENDON))[0]
            if len(ten_rows) and W is not None:
                mom = mom.at[ten_rows].set(
                    gear0[ten_rows, None] * W[lay.act_trnid[ten_rows]])
            acc0 = jnp.linalg.norm(mom @ Minv, axis=-1)
        else:
            acc0 = jnp.zeros((0,), dtype)
        return (dof_invweight0, body_invweight0, ten_invweight0, acc0,
                springlength, length0)

    import numpy as np_
    (dof_invweight0, body_invweight0, ten_invweight0, acc0,
     springlength, length0) = _compute(m)
    return m.replace(dof_invweight0=np_.asarray(dof_invweight0),
                     body_invweight0=np_.asarray(body_invweight0),
                     ten_invweight0=np_.asarray(ten_invweight0),
                     ten_springlength=np_.asarray(springlength),
                     ten_length0=np_.asarray(length0),
                     actuator_acc0=np_.asarray(acc0))


def _com_dict(m: Model, d: Data) -> dict:
    lay = m.layout
    return dict(subtree_com=d.subtree_com,
                origin=d.subtree_com[lay.body_rootid],
                cdof=d.cdof)


def fwd_position(m: Model, d: Data) -> Data:
    # named scopes tag the emitted ops per phase — they show up in the
    # HLO op_name metadata (scripts/hlo_opcount.py) and the on-chip
    # profiler trace, turning "4.7k anonymous fusions" into a phase
    # breakdown
    with jax.named_scope("kinematics"):
        kin = smooth.kinematics(m, d.qpos, d.mocap_pos, d.mocap_quat)
        com = smooth.com_pos(m, kin, d.body_mass, d.body_inertia)
    with jax.named_scope("crb"):
        qM = smooth.crb(m, com)
        qLD = smooth.factor_chol(qM)
    d = d.replace(
        xpos=kin["xpos"], xquat=kin["xquat"], xipos=kin["xipos"],
        ximat=kin["ximat"], xanchor=kin["xanchor"], xaxis=kin["xaxis"],
        geom_xpos=kin["geom_xpos"], geom_xmat=kin["geom_xmat"],
        site_xpos=kin["site_xpos"], site_xmat=kin["site_xmat"],
        subtree_com=com["subtree_com"], cdof=com["cdof"],
        qM=qM, qLD=qLD,
    )
    if m.ntendon:
        from mujoco_sim_tpu.ops import tendon as tendon_mod
        with jax.named_scope("tendon"):
            origin_body = d.subtree_com[m.layout.body_rootid]
            tlen, tJ = tendon_mod.tendon_quantities(
                m, d.qpos, d.site_xpos, d.cdof, origin_body,
                d.geom_xpos, d.geom_xmat, d.geom_size)
            d = d.replace(ten_length=tlen, ten_J=tJ,
                          ten_velocity=tJ @ d.qvel)
    # collision + constraint assembly
    from mujoco_sim_tpu.ops import collision as collision_mod
    from mujoco_sim_tpu.ops import constraint as constraint_mod
    with jax.named_scope("collision"):
        d = collision_mod.collision(m, d)
    with jax.named_scope("constraint"):
        d = constraint_mod.make_constraint(m, d, com)
    return d


def fwd_velocity(m: Model, d: Data) -> Data:
    com = _com_dict(m, d)
    com_full = dict(com, cinert=_cinert(m, d))
    vel = smooth.com_vel(m, com_full, d.qvel)
    qfrc_bias = smooth.rne(m, com_full, vel, d.qvel)
    ten = ((d.ten_length, d.ten_velocity, d.ten_J) if m.ntendon else None)
    fluid_state = ((vel["cvel"], d.ximat, d.body_inertia)
                   if m.opt.has_fluid else None)
    qfrc_passive, qsp, qdm, qgc = passive_mod.passive(
        m, com, d.qpos, d.qvel, d.xipos, d.body_mass, ten=ten,
        fluid_state=fluid_state)
    return d.replace(cvel=vel["cvel"], cdof_dot=vel["cdof_dot"],
                     qfrc_bias=qfrc_bias, qfrc_passive=qfrc_passive,
                     qfrc_spring=qsp, qfrc_damper=qdm, qfrc_gravcomp=qgc)


def _xmat(d: Data):
    from mujoco_sim_tpu.ops import math as mm
    return mm.quat_to_mat(d.xquat)


def _cinert(m: Model, d: Data):
    from mujoco_sim_tpu.ops import math as mm
    dtype = d.qpos.dtype
    lay = m.layout
    # R diag(I) R^T as broadcast-multiply + reduce: a K=3 contraction as a
    # dot_general would be its own op; the elementwise form fuses
    RI = d.ximat * d.body_inertia.astype(dtype)[..., None, :]
    inert_world = (RI[..., :, None, :] * d.ximat[..., None, :, :]).sum(-1)
    origin = d.subtree_com[lay.body_rootid]
    return mm.spatial_inertia(d.body_mass.astype(dtype), inert_world,
                              d.xipos - origin)


def fwd_actuation(m: Model, d: Data) -> Data:
    """mj_fwdActuation equivalent: ctrl clamp -> activation dynamics ->
    affine gain/bias force -> force clamp -> moment^T into dof space.

    The reference delegates this to libmujoco inside mj_step2 (SURVEY
    §2.2).  All shortcut actuators (motor/position/velocity/damper/
    intvelocity) are the fixed/affine gain + none/affine bias special
    cases, so the whole set is one branch-free vectorized formula; joint
    (hinge/slide) transmissions make the moment matrix a STATIC 0/1 dof
    mask scaled by gear[0] (Layout.act_moment01), so qfrc_actuator is a
    single (nu,) x (nu, nv) matmul."""
    if m.nu == 0:
        return d
    from mujoco_sim_tpu.models.model import (DynType, GainType, BiasType,
                                             TrnType, JointType)
    dtype = d.qpos.dtype
    lay = m.layout
    gear0 = m.actuator_gear.astype(dtype)[:, 0]
    # scalar-joint rows: length/velocity = gear0 * joint state; free/ball
    # rows read length 0 and velocity = (gear vector) . qvel via moment01
    # (act_gear0_eff = 1 there, the gear is folded into moment01)
    g0eff = jnp.asarray(lay.act_gear0_eff, dtype)
    moment01 = jnp.asarray(lay.act_moment01, dtype)     # (nu, nv) static
    length = (d.qpos[lay.act_qposadr] * gear0
              * jnp.asarray(lay.act_len_valid, dtype))
    velocity = g0eff * (moment01 @ d.qvel)
    # ball-joint rows: length = gear[:3] . rotation vector of the joint
    # quaternion (mju_quat2Vel semantics, wrapped to [-pi, pi])
    ball_rows = np.nonzero(
        (lay.act_trntype == int(TrnType.JOINT)) & (lay.act_trnjnt >= 0)
        & (lay.jnt_type[np.maximum(lay.act_trnjnt, 0)]
           == int(JointType.BALL)))[0]
    if len(ball_rows):
        from mujoco_sim_tpu.ops import math as mm
        qadr = lay.act_qposadr[ball_rows]
        q = mm.quat_normalize(d.qpos[qadr[:, None] + np.arange(4)])
        sin_half = jnp.sqrt((q[:, 1:] ** 2).sum(-1) + 1e-30)
        ang = 2.0 * jnp.arctan2(sin_half, q[:, 0])
        ang = jnp.where(ang > jnp.pi, ang - 2.0 * jnp.pi, ang)
        rv = q[:, 1:] / sin_half[:, None] * ang[:, None]
        gear3 = m.actuator_gear.astype(dtype)[ball_rows, :3]
        length = length.at[ball_rows].set((gear3 * rv).sum(-1))

    # site transmissions (mj_transmission mjTRN_SITE, oracle-probed): the
    # moment row is the site jacobian (minus the refsite's, if any)
    # expressed in the site/refsite frame and dotted with the 6D gear; the
    # refsite length's rotation part composes each site's quat OFFSET-FIRST
    # with its body xquat (site_quat o xquat — NOT the xmat chain order)
    # and takes subQuat in the refsite frame, matching the oracle exactly
    # (tests/test_actuators.py::test_site_transmission_oracle).
    # tendon transmissions: length/velocity are static gathers of the
    # tendon state; the moment row (gear0 * ten_Wv) is folded into the
    # static moment01 matrix at compile
    ten_rows = np.nonzero(lay.act_trntype == int(TrnType.TENDON))[0]
    moment_ten = None
    if len(ten_rows):
        tid = lay.act_trnid[ten_rows]
        length = length.at[ten_rows].set(gear0[ten_rows] * d.ten_length[tid])
        velocity = velocity.at[ten_rows].set(
            gear0[ten_rows] * d.ten_velocity[tid])
        moment_ten = gear0[ten_rows, None] * d.ten_J[tid]   # (nta, nv)

    site_rows = np.nonzero(lay.act_trntype == int(TrnType.SITE))[0]
    moment_site = None
    if len(site_rows):
        from mujoco_sim_tpu.ops.constraint import (_point_jacobian,
                                                   _rot_jacobian)
        from mujoco_sim_tpu.ops import math as mm
        sid = lay.act_trnid[site_rows]
        rid = lay.act_refid[site_rows]
        has_ref = rid >= 0                       # static numpy mask
        rid_s = np.where(has_ref, rid, 0)
        bs = lay.site_bodyid[sid]
        br = lay.site_bodyid[rid_s]
        origin_s = d.subtree_com[lay.body_rootid[bs]]
        origin_r = d.subtree_com[lay.body_rootid[br]]
        ps, Rs = d.site_xpos[sid], d.site_xmat[sid]
        pr, Rr = d.site_xpos[rid_s], d.site_xmat[rid_s]
        gearS = m.actuator_gear.astype(dtype)[site_rows]        # (ns, 6)
        jacp = _point_jacobian(m, d, ps, bs, origin_s)          # (ns, 3, nv)
        jacr = _rot_jacobian(m, d, bs)
        href = jnp.asarray(has_ref, dtype)[:, None, None]
        jacp = jacp - href * _point_jacobian(m, d, pr, br, origin_r)
        jacr = jacr - href * _rot_jacobian(m, d, br)
        R_use = jnp.where(href > 0.5, Rr, Rs)                   # (ns, 3, 3)
        # local jac rows: R^T J as mul+reduce (K=3 contractions fuse)
        jl_p = (R_use[:, :, :, None] * jacp[:, :, None, :]).sum(1)
        jl_r = (R_use[:, :, :, None] * jacr[:, :, None, :]).sum(1)
        moment_site = ((gearS[:, :3, None] * jl_p).sum(1)
                       + (gearS[:, 3:, None] * jl_r).sum(1))    # (ns, nv)
        # length (0 without refsite)
        qoff_s = m.site_quat.astype(dtype)[sid]
        qoff_r = m.site_quat.astype(dtype)[rid_s]
        qts = mm.quat_mul(qoff_s, d.xquat[bs])
        qtr = mm.quat_mul(qoff_r, d.xquat[br])
        rotvec = mm.quat_sub(qts, qtr)                          # (ns, 3)
        dp_ref = ((Rr * (ps - pr)[:, :, None]).sum(1))          # R_r^T dp
        len_site = ((gearS[:, :3] * dp_ref).sum(-1)
                    + (gearS[:, 3:] * rotvec).sum(-1))
        len_site = jnp.where(jnp.asarray(has_ref), len_site, 0.0)
        vel_site = (moment_site * d.qvel[None, :]).sum(-1)
        length = length.at[site_rows].set(len_site)
        velocity = velocity.at[site_rows].set(vel_site)

    ctrl = d.ctrl.astype(dtype)
    cr = m.actuator_ctrlrange.astype(dtype)
    ctrl = jnp.where(jnp.asarray(lay.act_ctrllimited),
                     jnp.clip(ctrl, cr[:, 0], cr[:, 1]), ctrl)
    dyn = lay.act_dyntype                      # static numpy
    act = d.act.astype(dtype)
    tau = jnp.maximum(m.actuator_dynprm.astype(dtype)[:, 0], 1e-12)
    h = jnp.asarray(m.opt.timestep, dtype)
    is_int = jnp.asarray(dyn == int(DynType.INTEGRATOR))
    is_filt = jnp.asarray(dyn == int(DynType.FILTER))
    # filterexact folds the exact exponential update into act_dot so the
    # integrators' plain act += h*act_dot advance reproduces it
    is_fex = jnp.asarray(dyn == int(DynType.FILTEREXACT))
    filt_dot = (ctrl - act) / tau
    fex_dot = (ctrl - act) * (1.0 - jnp.exp(-h / tau)) / jnp.maximum(h, 1e-12)
    # muscle activation (mju_muscleDynamics, zero smoothing width): tau
    # scales with activation, asymmetric for act/deact — oracle-probed
    is_mus = jnp.asarray(dyn == int(DynType.MUSCLE))
    dprm = m.actuator_dynprm.astype(dtype)
    cclamp = jnp.clip(ctrl, 0.0, 1.0)
    tau_m = jnp.where(cclamp > act,
                      jnp.maximum(dprm[:, 0], 1e-12) * (0.5 + 1.5 * act),
                      jnp.maximum(dprm[:, 1], 1e-12)
                      / jnp.maximum(0.5 + 1.5 * act, 1e-12))
    mus_dot = (cclamp - act) / tau_m
    act_dot = jnp.where(is_int, ctrl,
                        jnp.where(is_filt, filt_dot,
                                  jnp.where(is_fex, fex_dot,
                                            jnp.where(is_mus, mus_dot,
                                                      0.0))))
    has_act = jnp.asarray(dyn != int(DynType.NONE))
    inp = jnp.where(has_act, act, ctrl)
    gp = m.actuator_gainprm.astype(dtype)
    gain_aff = jnp.asarray(lay.act_gaintype == int(GainType.AFFINE))
    gain = gp[:, 0] + jnp.where(
        gain_aff, gp[:, 1] * length + gp[:, 2] * velocity, 0.0)
    bp = m.actuator_biasprm.astype(dtype)
    bias_aff = jnp.asarray(lay.act_biastype == int(BiasType.AFFINE))
    bias = jnp.where(
        bias_aff, bp[:, 0] + bp[:, 1] * length + bp[:, 2] * velocity, 0.0)

    gain_mus_np = lay.act_gaintype == int(GainType.MUSCLE)   # static numpy
    bias_mus_np = lay.act_biastype == int(BiasType.MUSCLE)
    gain_mus = jnp.asarray(gain_mus_np)
    bias_mus = jnp.asarray(bias_mus_np)
    if gain_mus_np.any() or bias_mus_np.any():
        # mju_muscleGain/Bias FLV curves, oracle-probed to machine
        # precision (tests/test_muscles.py): normalized length L in L0
        # units, FL bump(lmin,1,lmax), FV piecewise quadratic saturating
        # at fvmax, FP half-quadratic-then-linear scaled by fpmax
        lr = m.actuator_lengthrange.astype(dtype)
        acc0 = jnp.maximum(m.actuator_acc0.astype(dtype), 1e-12)
        r0, r1 = gp[:, 0], gp[:, 1]
        L0 = (lr[:, 1] - lr[:, 0]) / jnp.maximum(r1 - r0, 1e-12)
        L0s = jnp.maximum(L0, 1e-12)
        L = r0 + (length - lr[:, 0]) / L0s
        V = velocity / (L0s * jnp.maximum(gp[:, 6], 1e-12))
        F0 = jnp.where(gp[:, 2] < 0, gp[:, 3] / acc0, gp[:, 2])
        lmin, lmax, fpmax, fvmax = gp[:, 4], gp[:, 5], gp[:, 7], gp[:, 8]
        mid = 1.0
        left = 0.5 * (lmin + mid)
        right = 0.5 * (mid + lmax)
        x_a = (L - lmin) / jnp.maximum(left - lmin, 1e-12)
        x_b = (mid - L) / jnp.maximum(mid - left, 1e-12)
        x_c = (L - mid) / jnp.maximum(right - mid, 1e-12)
        x_d = (lmax - L) / jnp.maximum(lmax - right, 1e-12)
        FL = jnp.where((L <= lmin) | (L >= lmax), 0.0,
             jnp.where(L < left, 0.5 * x_a * x_a,
             jnp.where(L < mid, 1.0 - 0.5 * x_b * x_b,
             jnp.where(L < right, 1.0 - 0.5 * x_c * x_c,
                       0.5 * x_d * x_d))))
        y = fvmax - 1.0
        FV = jnp.where(V <= -1.0, 0.0,
             jnp.where(V <= 0.0, (V + 1.0) * (V + 1.0),
             jnp.where(V <= y,
                       fvmax - (y - V) * (y - V) / jnp.maximum(y, 1e-12),
                       fvmax)))
        bmid = 0.5 * (1.0 + lmax)
        x_p = (L - 1.0) / jnp.maximum(bmid - 1.0, 1e-12)
        FP = jnp.where(L <= 1.0, 0.0,
             jnp.where(L <= bmid, 0.5 * fpmax * x_p * x_p,
                       fpmax * (0.5 + (L - bmid)
                                / jnp.maximum(bmid - 1.0, 1e-12))))
        gain = jnp.where(gain_mus, -F0 * FL * FV, gain)
        bias = jnp.where(bias_mus, -F0 * FP, bias)

    force = gain * inp + bias
    fr = m.actuator_forcerange.astype(dtype)
    force = jnp.where(jnp.asarray(lay.act_forcelimited),
                      jnp.clip(force, fr[:, 0], fr[:, 1]), force)
    qfrc = (force * g0eff) @ moment01   # joint rows (site/tendon rows zero)
    if moment_site is not None:
        qfrc = qfrc + force[site_rows] @ moment_site
    if moment_ten is not None:
        qfrc = qfrc + force[ten_rows] @ moment_ten
    return d.replace(act_dot=act_dot, actuator_length=length,
                     actuator_velocity=velocity, actuator_force=force,
                     qfrc_actuator=qfrc)


def fwd_acceleration(m: Model, d: Data) -> Data:
    com = _com_dict(m, d)
    qfrc_x = support.xfrc_accumulate(m, com, d.xipos, d.xfrc_applied)
    qfrc_smooth = (d.qfrc_passive + d.qfrc_actuator + d.qfrc_applied
                   + qfrc_x - d.qfrc_bias)
    qacc_smooth = smooth.solve_chol(d.qLD, qfrc_smooth)
    return d.replace(qfrc_smooth=qfrc_smooth, qacc_smooth=qacc_smooth)


def fwd_constraint(m: Model, d: Data) -> Data:
    from mujoco_sim_tpu.ops import solver as solver_mod
    if m.nefc_max == 0 or (m.opt.disableflags & int(DisableBit.CONSTRAINT)):
        return d.replace(qacc=d.qacc_smooth,
                         qfrc_constraint=jnp.zeros_like(d.qacc_smooth))
    with jax.named_scope("solver"):
        d = solver_mod.solve(m, d)
    if m.opt.noslip_iterations > 0:
        from mujoco_sim_tpu.ops import noslip as noslip_mod
        d = noslip_mod.noslip(m, d)
    return d


@_full_precision
def forward_core(m: Model, d: Data) -> Data:
    d = fwd_position(m, d)
    d = fwd_velocity(m, d)
    d = fwd_actuation(m, d)
    d = fwd_acceleration(m, d)
    d = fwd_constraint(m, d)
    return d


# inner-jit: RK4 evaluates forward_core four times per step; without this
# each stage RE-TRACES the whole pipeline (PR2: ~25 s of tracing per
# stage, 100 s/step program).  As a pjit call the jaxpr traces once and
# the other calls are trace-cache hits; XLA also dedups the called
# computation, cutting backend compile similarly.
_forward_core_jit = jax.jit(forward_core)


@_full_precision
def forward(m: Model, d: Data) -> Data:
    """Full forward dynamics + derived outputs (mj_forward equivalent)."""
    d = _forward_core_jit(m, d)
    d = sensor_energy(m, d)
    return d


def sensor_energy(m: Model, d: Data) -> Data:
    dtype = d.qpos.dtype
    g = jnp.asarray(m.opt.gravity, dtype)
    mass = d.body_mass.astype(dtype)
    potential = -jnp.sum(mass * jnp.einsum("bi,i->b", d.xipos, g))
    # joint springs
    lay = m.layout
    from mujoco_sim_tpu.models.model import JointType
    from mujoco_sim_tpu.ops import math as mm
    spring = jnp.asarray(0.0, dtype)
    for jt in (JointType.SLIDE, JointType.HINGE):
        jsel = np.nonzero(lay.jnt_type == int(jt))[0]
        if len(jsel) == 0:
            continue
        k = jnp.asarray(m.jnt_stiffness, dtype)[jsel]
        qadr = lay.jnt_qposadr[jsel]
        disp = d.qpos[qadr] - jnp.asarray(m.qpos_spring, dtype)[qadr]
        spring = spring + 0.5 * jnp.sum(k * disp * disp)
    for jt in (JointType.BALL,):
        jsel = np.nonzero(lay.jnt_type == int(jt))[0]
        if len(jsel):
            k = jnp.asarray(m.jnt_stiffness, dtype)[jsel]
            qadr = lay.jnt_qposadr[jsel]
            q = d.qpos[qadr[:, None] + np.arange(4)]
            qref = jnp.asarray(m.qpos_spring, dtype)[qadr[:, None] + np.arange(4)]
            rot = mm.quat_sub(q, qref)
            spring = spring + 0.5 * jnp.sum(k * jnp.sum(rot * rot, axis=-1))
    kinetic = 0.5 * d.qvel @ d.qM @ d.qvel
    d = d.replace(energy=jnp.stack([potential + spring, kinetic]))
    from mujoco_sim_tpu.ops import sensor as sensor_mod
    return sensor_mod.sensors(m, d)


def _dof_active(m: Model, d: Data) -> jax.Array:
    """Dofs of masked-out (despawned) bodies are frozen (SURVEY §3.3)."""
    return d.body_active[m.layout.dof_bodyid]


def _euler(m: Model, d: Data) -> Data:
    dtype = d.qpos.dtype
    h = jnp.asarray(m.opt.timestep, dtype)
    damping = jnp.asarray(m.dof_damping, dtype)
    # implicit joint damping: (M + h*diag(B)) qacc' = qfrc_smooth + qfrc_constraint
    # (matches mj_Euler; qfrc_smooth already contains the explicit -B qvel)
    MhB = d.qM + jnp.diag(h * damping)
    rhs = d.qfrc_smooth + d.qfrc_constraint
    from mujoco_sim_tpu.ops import linalg as _linalg
    qacc = smooth.solve_chol(_linalg.cholesky(MhB), rhs)
    qvel = jnp.where(_dof_active(m, d), d.qvel + h * qacc, 0.0)
    qpos = integrate_mod.integrate_pos(m, d.qpos, qvel, h)
    return d.replace(qpos=qpos, qvel=qvel, act=_advance_act(m, d, h),
                     time=d.time + h)


def _advance_act(m: Model, d: Data, h) -> jax.Array:
    if m.nu == 0:
        return d.act
    act = d.act + h * d.act_dot
    lim = m.layout.act_actlimited
    if lim.any():
        ar = m.actuator_actrange.astype(act.dtype)
        act = jnp.where(jnp.asarray(lim),
                        jnp.clip(act, ar[:, 0], ar[:, 1]), act)
    return act


def _implicit(m: Model, d: Data, fast: bool) -> Data:
    """mj_implicit / mj_implicitFast: integrate velocity implicitly using
    d(qfrc)/d(qvel).  implicitfast keeps only the passive-damping derivative
    (with no tendons/actuators/fluid that is diag(dof_damping), making it
    coincide with mj_Euler's implicit-damping form); full implicit also
    differentiates the RNE bias Coriolis term — obtained here by forward-mode
    AD of ops/smooth.rne instead of MuJoCo's hand-written mjd_smooth_vel.
    The modified matrix is nonsymmetric, so a general LU solve is used
    (models requesting implicit are off the reference's hot path).
    """
    dtype = d.qpos.dtype
    h = jnp.asarray(m.opt.timestep, dtype)
    damping = jnp.asarray(m.dof_damping, dtype)
    MhB = d.qM + jnp.diag(h * damping)
    rhs = d.qfrc_smooth + d.qfrc_constraint
    if fast:
        from mujoco_sim_tpu.ops import linalg as _linalg
        qacc = _linalg.cho_solve(_linalg.cholesky(MhB), rhs)
    else:
        com = _com_dict(m, d)
        com_full = dict(com, cinert=_cinert(m, d))

        def frc_of_v(v):
            # everything velocity-dependent whose derivative enters the
            # implicit matrix: RNE bias MINUS the velocity-dependent
            # passive forces (fluid drag, tendon damping) — mjd_smooth_vel
            # + mjd_passive_vel in MuJoCo's mj_implicit
            vel = smooth.com_vel(m, com_full, v)
            out = smooth.rne(m, com_full, vel, v)
            if m.opt.has_fluid:
                out = out - passive_mod.fluid(
                    m, com, d.xipos, vel["cvel"], d.ximat, d.body_mass,
                    d.body_inertia)
            return out

        dfrc_dv = jax.jacfwd(frc_of_v)(d.qvel)     # (nv, nv), nonsymmetric
        A = MhB + h * dfrc_dv
        if m.ntendon:
            # tendon damping enters as the DIAGONAL approximation of
            # J^T b J (probed: the full outer product mismatches
            # mj_implicit; MuJoCo folds it like joint damping)
            b = m.ten_damping.astype(dtype)
            A = A + h * jnp.diag((b[:, None] * d.ten_J ** 2).sum(0))
        qacc = jnp.linalg.solve(A, rhs)
    qvel = jnp.where(_dof_active(m, d), d.qvel + h * qacc, 0.0)
    qpos = integrate_mod.integrate_pos(m, d.qpos, qvel, h)
    return d.replace(qpos=qpos, qvel=qvel, act=_advance_act(m, d, h),
                     time=d.time + h)


_RK4_A = ((0.5,), (0.0, 0.5), (0.0, 0.0, 1.0))
_RK4_B = (1.0 / 6.0, 1.0 / 3.0, 1.0 / 3.0, 1.0 / 6.0)


def _rk4(m: Model, d: Data) -> Data:
    """mj_RungeKutta(4): stages re-run forward_core; pos via manifold update."""
    h = jnp.asarray(m.opt.timestep, d.qpos.dtype)
    qpos0, qvel0, act0 = d.qpos, d.qvel, d.act
    F = [(d.qvel, d.qacc, d.act_dot)]
    dcur = d
    for i in range(3):
        dq = sum(a * f[0] for a, f in zip(_RK4_A[i], F) if a)
        dv = sum(a * f[1] for a, f in zip(_RK4_A[i], F) if a)
        qpos_i = integrate_mod.integrate_pos(m, qpos0, dq, h)
        qvel_i = qvel0 + h * dv
        # seed each stage's solver with the previous stage's solution:
        # stage states are close, cutting lockstep Newton iterations
        dcur = dcur.replace(qpos=qpos_i, qvel=qvel_i,
                            qacc_warmstart=dcur.qacc)
        if m.nu:
            da = sum(a * f[2] for a, f in zip(_RK4_A[i], F) if a)
            dcur = dcur.replace(act=act0 + h * da)
        dcur = _forward_core_jit(m, dcur)
        F.append((dcur.qvel, dcur.qacc, dcur.act_dot))
    dq = sum(b * f[0] for b, f in zip(_RK4_B, F))
    dv = sum(b * f[1] for b, f in zip(_RK4_B, F))
    act = _dof_active(m, d)
    qpos = integrate_mod.integrate_pos(m, qpos0, jnp.where(act, dq, 0.0), h)
    qvel = jnp.where(act, qvel0 + h * dv, 0.0)
    if m.nu:
        act_new = _advance_act(
            m, d.replace(act=act0,
                         act_dot=sum(b * f[2] for b, f in zip(_RK4_B, F))),
            h)
    else:
        act_new = d.act
    return d.replace(qpos=qpos, qvel=qvel, act=act_new, time=d.time + h)


@_full_precision
def step(m: Model, d: Data) -> Data:
    """One physics step (mj_step equivalent)."""
    d = forward(m, d)
    d = d.replace(qacc_warmstart=d.qacc)
    if m.opt.integrator == int(Integrator.RK4):
        return _rk4(m, d)
    if m.opt.integrator == int(Integrator.IMPLICIT):
        return _implicit(m, d, fast=False)
    if m.opt.integrator == int(Integrator.IMPLICITFAST):
        return _implicit(m, d, fast=True)
    with jax.named_scope("integrate"):
        return _euler(m, d)


@_full_precision
def step1(m: Model, d: Data) -> Data:
    """Position+velocity stages only — the hook point where the reference
    runs controllers between mj_step1 and mj_step2 (src/mj_main.cpp:83-108)."""
    d = fwd_position(m, d)
    d = fwd_velocity(m, d)
    return d


@_full_precision
def step2(m: Model, d: Data) -> Data:
    d = fwd_actuation(m, d)
    d = fwd_acceleration(m, d)
    d = fwd_constraint(m, d)
    d = sensor_energy(m, d)
    d = d.replace(qacc_warmstart=d.qacc)
    if m.opt.integrator == int(Integrator.RK4):
        return _rk4(m, d)
    if m.opt.integrator == int(Integrator.IMPLICIT):
        return _implicit(m, d, fast=False)
    if m.opt.integrator == int(Integrator.IMPLICITFAST):
        return _implicit(m, d, fast=True)
    return _euler(m, d)


@_full_precision
def step_with_control(m: Model, d: Data, ctrl_fn, *ctrl_args):
    """step1 -> controller -> step2, mirroring the reference's interleaving
    of mjcb_control / ControllerManager::update / HW write inside one step
    (src/mj_main.cpp:82-112).  ctrl_fn(m, d, *ctrl_args) -> (d, aux)."""
    d = step1(m, d)
    d, aux = ctrl_fn(m, d, *ctrl_args)
    d = step2(m, d)
    return d, aux


@_full_precision
def inverse(m: Model, d: Data, qacc: jax.Array) -> jax.Array:
    """Inverse dynamics: applied generalized force that would produce qacc
    (mj_inverse equivalent; used for effort feedback, mj_hw_interface.cpp:61).

    The constraint force is evaluated from the GIVEN qacc by the inverse
    constraint solver (jar = J qacc - aref -> analytic per-row force),
    matching mj_inverse for arbitrary (state, qacc) queries — reusing the
    carried qfrc_constraint is only correct at the solved state (r2
    VERDICT weak #6)."""
    from mujoco_sim_tpu.ops.solver import constraint_force_from_qacc
    d = fwd_position(m, d)
    d = fwd_velocity(m, d)
    _, qfrc_constraint = constraint_force_from_qacc(m, d, qacc)
    return d.qM @ qacc + d.qfrc_bias - d.qfrc_passive - qfrc_constraint
