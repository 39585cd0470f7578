"""Frozen device-resident model + per-env state containers.

The reference keeps a mutable ``mjModel*``/``mjData*`` pair behind a global
mutex and rewrites XML + reloads to change the scene (reference:
src/mujoco_sim/mj_sim.cpp:804-845, src/mujoco_sim/mj_model.cpp:26-47).  Here
the model is compiled ONCE into an immutable pytree of padded arrays; scene
edits (spawn/destroy) flip per-slot ``body_active`` masks in ``Data`` so the
jitted step never retraces.

Enumerations mirror MuJoCo's so name-for-name parity is auditable.
"""

from __future__ import annotations

import enum
from typing import Any

import jax
import numpy as np

from mujoco_sim_tpu.utils.struct import pytree, static, field


class JointType(enum.IntEnum):
    FREE = 0
    BALL = 1
    SLIDE = 2
    HINGE = 3


class GeomType(enum.IntEnum):
    PLANE = 0
    HFIELD = 1
    SPHERE = 2
    CAPSULE = 3
    ELLIPSOID = 4
    CYLINDER = 5
    BOX = 6
    MESH = 7


class EqType(enum.IntEnum):
    CONNECT = 0
    WELD = 1
    JOINT = 2
    TENDON = 3
    FLEX = 4


class Integrator(enum.IntEnum):
    EULER = 0
    RK4 = 1
    IMPLICIT = 2
    IMPLICITFAST = 3


class ConeType(enum.IntEnum):
    PYRAMIDAL = 0
    ELLIPTIC = 1


class DynType(enum.IntEnum):
    NONE = 0
    INTEGRATOR = 1
    FILTER = 2
    FILTEREXACT = 3
    MUSCLE = 4


class GainType(enum.IntEnum):
    FIXED = 0
    AFFINE = 1
    MUSCLE = 2


class TrnType(enum.IntEnum):
    # mjtTrn values (mujoco 2.3.7 mjmodel.h) for parity
    JOINT = 0
    TENDON = 3
    SITE = 4


class BiasType(enum.IntEnum):
    NONE = 0
    AFFINE = 1
    MUSCLE = 2


class SensorType(enum.IntEnum):
    # mjtSensor values (mujoco 2.3.7 mjmodel.h) for parity; the reference
    # itself registers FORCE/TORQUE only (mj_sim.cpp:973-1014) but its
    # libmujoco backend evaluates the full set for arbitrary user worlds
    TOUCH = 0
    ACCELEROMETER = 1
    VELOCIMETER = 2
    GYRO = 3
    FORCE = 4
    TORQUE = 5
    MAGNETOMETER = 6
    RANGEFINDER = 7
    JOINTPOS = 8
    JOINTVEL = 9
    TENDONPOS = 10
    TENDONVEL = 11
    ACTUATORPOS = 12
    ACTUATORVEL = 13
    ACTUATORFRC = 14
    BALLQUAT = 15
    BALLANGVEL = 16
    JOINTLIMITPOS = 17
    JOINTLIMITVEL = 18
    JOINTLIMITFRC = 19
    TENDONLIMITPOS = 20
    TENDONLIMITVEL = 21
    TENDONLIMITFRC = 22
    FRAMEPOS = 23
    FRAMEQUAT = 24
    FRAMEXAXIS = 25
    FRAMEYAXIS = 26
    FRAMEZAXIS = 27
    FRAMELINVEL = 28
    FRAMEANGVEL = 29
    SUBTREECOM = 32
    SUBTREELINVEL = 33
    SUBTREEANGMOM = 34
    CLOCK = 35


class ObjType(enum.IntEnum):
    # mjtObj subset used by frame sensors
    BODY = 1
    XBODY = 2
    GEOM = 5
    SITE = 6


class DisableBit(enum.IntFlag):
    CONSTRAINT = 1 << 0
    EQUALITY = 1 << 1
    FRICTIONLOSS = 1 << 2
    LIMIT = 1 << 3
    CONTACT = 1 << 4
    PASSIVE = 1 << 5
    GRAVITY = 1 << 6
    WARMSTART = 1 << 7


@pytree
class Option:
    """Simulation options (mjOption equivalent)."""

    timestep: jax.Array
    gravity: jax.Array          # (3,)
    wind: jax.Array             # (3,)
    magnetic: jax.Array         # (3,) global magnetic flux (magnetometer)
    density: jax.Array          # fluid density
    viscosity: jax.Array
    impratio: jax.Array
    o_margin: jax.Array
    o_solref: jax.Array         # (2,)
    o_solimp: jax.Array         # (5,)
    # static (jit cache keys)
    integrator: int = static(default=int(Integrator.EULER))
    cone: int = static(default=int(ConeType.PYRAMIDAL))
    solver_iterations: int = static(default=50)
    ls_iterations: int = static(default=20)
    ls_tolerance: float = static(default=0.01)
    tolerance: float = static(default=1e-8)
    noslip_iterations: int = static(default=0)
    noslip_tolerance: float = static(default=1e-6)
    disableflags: int = static(default=0)
    has_fluid: int = static(default=0)  # density/viscosity/wind nonzero
    override_contacts: int = static(default=0)  # mjENBL_OVERRIDE
    # oracle-form exact manifolds for ALL contacting mesh pairs instead
    # of only deep ones: PR2 err50 vs mujoco 3.10 drops 1.7e-4 -> 7.7e-6
    # (the default SAT manifolds emit 2+2 points where the oracle's EPA
    # emits one witness); costs the gated exact query whenever any mesh
    # pair touches.  m.replace(opt=m.opt.replace(exact_meshcollide=1)).
    exact_meshcollide: int = static(default=0)


@pytree
class Model:
    """Compiled, padded, immutable model. Single source of truth for kernels.

    Counts and index tables are static; numeric fields are array leaves so a
    model can be donated/sharded like any pytree.  Mirrors the information
    content of mjModel for the supported feature set (reference loads it via
    mj_loadXML, include/mujoco_sim/mj_util.h:185-193).
    """

    opt: Option

    # ---- bodies
    body_parentid: jax.Array      # (nbody,) i32
    body_rootid: jax.Array        # (nbody,) i32
    body_weldid: jax.Array        # (nbody,) i32
    body_jntadr: jax.Array        # (nbody,) i32  (-1 if none)
    body_jntnum: jax.Array        # (nbody,) i32
    body_dofadr: jax.Array        # (nbody,) i32
    body_dofnum: jax.Array        # (nbody,) i32
    body_pos: jax.Array           # (nbody, 3)
    body_quat: jax.Array          # (nbody, 4)
    body_ipos: jax.Array          # (nbody, 3)
    body_iquat: jax.Array         # (nbody, 4)
    body_mass: jax.Array          # (nbody,)
    body_inertia: jax.Array       # (nbody, 3) diagonal in i-frame
    body_gravcomp: jax.Array      # (nbody,)
    body_invweight0: jax.Array    # (nbody, 2) [tran, rot]
    body_subtreemass: jax.Array   # (nbody,)
    body_mocapid: jax.Array       # (nbody,) i32, -1 if not mocap

    # ---- joints
    jnt_type: jax.Array           # (njnt,) i32
    jnt_qposadr: jax.Array        # (njnt,) i32
    jnt_dofadr: jax.Array         # (njnt,) i32
    jnt_bodyid: jax.Array         # (njnt,) i32
    jnt_pos: jax.Array            # (njnt, 3)
    jnt_axis: jax.Array           # (njnt, 3)
    jnt_range: jax.Array          # (njnt, 2)
    jnt_limited: jax.Array        # (njnt,) bool
    jnt_stiffness: jax.Array      # (njnt,)
    jnt_springref: jax.Array      # (njnt,)
    jnt_ref: jax.Array            # (njnt,)
    jnt_margin: jax.Array         # (njnt,)
    jnt_solref: jax.Array         # (njnt, 2) limit solref
    jnt_solimp: jax.Array         # (njnt, 5) limit solimp

    # ---- dofs
    dof_bodyid: jax.Array         # (nv,) i32
    dof_jntid: jax.Array          # (nv,) i32
    dof_parentid: jax.Array       # (nv,) i32 (-1 root)
    dof_armature: jax.Array       # (nv,)
    dof_damping: jax.Array        # (nv,)
    dof_frictionloss: jax.Array   # (nv,)
    dof_invweight0: jax.Array     # (nv,)

    # ---- geoms
    geom_type: jax.Array          # (ngeom,) i32
    geom_bodyid: jax.Array        # (ngeom,) i32
    geom_dataid: jax.Array        # (ngeom,) i32 mesh id or -1
    geom_pos: jax.Array           # (ngeom, 3)
    geom_quat: jax.Array          # (ngeom, 4)
    geom_size: jax.Array          # (ngeom, 3)
    geom_rbound: jax.Array        # (ngeom,) bounding radius (0 = plane)
    geom_friction: jax.Array      # (ngeom, 3)
    geom_contype: jax.Array       # (ngeom,) i32
    geom_conaffinity: jax.Array   # (ngeom,) i32
    geom_condim: jax.Array        # (ngeom,) i32
    geom_priority: jax.Array      # (ngeom,) i32
    geom_solmix: jax.Array        # (ngeom,)
    geom_solref: jax.Array        # (ngeom, 2)
    geom_solimp: jax.Array        # (ngeom, 5)
    geom_margin: jax.Array        # (ngeom,)
    geom_gap: jax.Array           # (ngeom,)
    geom_rgba: jax.Array          # (ngeom, 4) viz only

    # ---- sites
    site_bodyid: jax.Array        # (nsite,) i32
    site_pos: jax.Array           # (nsite, 3)
    site_quat: jax.Array          # (nsite, 4)

    # ---- meshes (convex hulls, padded)
    mesh_vert: jax.Array          # (nmeshvert_total, 3) hull vertices, packed
    mesh_vertadr: jax.Array       # (nmesh,) i32
    mesh_vertnum: jax.Array       # (nmesh,) i32
    hfield_data: jax.Array        # (nhfield, maxrow, maxcol) in [0,1]
    hfield_size: jax.Array        # (nhfield, 4) rx ry ztop zbottom
    mesh_vert_pad: jax.Array      # (nmesh, maxvert, 3) padded hull verts
    mesh_vert_mask: jax.Array     # (nmesh, maxvert) 1.0 for real verts
    mesh_face_pad: jax.Array      # (nmesh, maxface, 4) [normal, offset]
    # merged coplanar faces + ordered face polygons, for the face-clip
    # overlap-polygon manifold (mesh_io.face_polygons); fpoly padding
    # repeats each face's last vertex so circular adjacency survives
    mesh_fplane: jax.Array        # (nhull, maxmface, 4)
    mesh_fmask: jax.Array         # (nhull, maxmface) 1.0 for real faces
    mesh_fpoly: jax.Array         # (nhull, maxmface, maxfv, 3)
    # [is_cyl, radius, half_height]: prism hulls the exact manifold
    # treats as true cylinders (analytic support, axis = local +z)
    mesh_cyl: jax.Array           # (nhull, 3)
    # FULL (undecimated) hull verts for the deep-pair exact manifold:
    # 32-vert decimation error (mm) rotates the exact MTV at cm-scale
    # penetration.  Only read inside the deep-pair gate.
    mesh_vert_hi: jax.Array       # (nhull, maxvhi, 3), pad = 1st vertex
    #   (repeat-pad: support min/max runs UNMASKED — ops/manifold.py)
    mesh_vert_hi_mask: jax.Array  # (nhull, maxvhi)
    # full-hull edge endpoint pairs (exact-MTV top-K edge refinement)
    mesh_hedge: jax.Array         # (nhull, maxhe, 2, 3), pad 1e6
    mesh_hedge_mask: jax.Array    # (nhull, maxhe)

    # ---- actuators (normalized general form; joint transmissions only.
    # type/limited flags live in Layout so kernels branch statically;
    # parameters are leaves so they stay runtime-tunable without retrace)
    actuator_gear: jax.Array      # (nu, 6)
    actuator_gainprm: jax.Array   # (nu, 10) (mjNGAIN)
    actuator_biasprm: jax.Array   # (nu, 10)
    actuator_dynprm: jax.Array    # (nu, 10)
    actuator_ctrlrange: jax.Array  # (nu, 2)
    actuator_forcerange: jax.Array  # (nu, 2)
    actuator_lengthrange: jax.Array  # (nu, 2) muscle operating range
    actuator_acc0: jax.Array      # (nu,) |M^-1 moment| at qpos0 (set_const)
    actuator_actrange: jax.Array  # (nu, 2) activation clamp (actlimited)

    # ---- fixed tendons (length = Layout.ten_Wq @ qpos, a static matmul)
    ten_range: jax.Array          # (ntendon, 2)
    ten_solref: jax.Array         # (ntendon, 2)
    ten_solimp: jax.Array         # (ntendon, 5)
    ten_stiffness: jax.Array      # (ntendon,)
    ten_damping: jax.Array        # (ntendon,)
    ten_springlength: jax.Array   # (ntendon, 2) deadband [lo, hi]
    ten_length0: jax.Array        # (ntendon,) length at qpos0 (set_const)
    ten_margin: jax.Array         # (ntendon,)
    ten_invweight0: jax.Array     # (ntendon,) W M(q0)^-1 W^T (mj_setConst)

    # ---- equality constraints
    eq_type: jax.Array            # (neq,) i32
    eq_obj1id: jax.Array          # (neq,) i32
    eq_obj2id: jax.Array          # (neq,) i32
    eq_active0: jax.Array         # (neq,) bool
    eq_data: jax.Array            # (neq, 11)
    eq_solref: jax.Array          # (neq, 2)
    eq_solimp: jax.Array          # (neq, 5)

    # ---- precomputed collision pair list (static shapes; SURVEY §2.2)
    pair_geom1: jax.Array         # (npair,) i32
    pair_geom2: jax.Array         # (npair,) i32
    pair_friction: jax.Array      # (npair, 5) mixed contact friction
    pair_solref: jax.Array        # (npair, 2)
    pair_solimp: jax.Array        # (npair, 5)
    pair_margin: jax.Array        # (npair,)
    pair_gap: jax.Array           # (npair,)

    # ---- sensors
    sensor_type: jax.Array        # (nsensor,) i32
    sensor_objid: jax.Array       # (nsensor,) i32
    sensor_adr: jax.Array         # (nsensor,) i32
    sensor_cutoff: jax.Array      # (nsensor,) 0 = no cutoff clamp

    # ---- reference configuration
    qpos0: jax.Array              # (nq,)
    qpos_spring: jax.Array        # (nq,)

    # ---- keyframes (<keyframe><key>, mj_resetDataKeyframe targets)
    key_time: jax.Array           # (nkey,)
    key_qpos: jax.Array           # (nkey, nq)
    key_qvel: jax.Array           # (nkey, nv)
    key_act: jax.Array            # (nkey, nu)
    key_ctrl: jax.Array           # (nkey, nu)
    key_mpos: jax.Array           # (nkey, nmocap, 3)
    key_mquat: jax.Array          # (nkey, nmocap, 4)

    # ---- static metadata
    nq: int = static(default=0)
    nv: int = static(default=0)
    nbody: int = static(default=0)
    njnt: int = static(default=0)
    ngeom: int = static(default=0)
    nsite: int = static(default=0)
    nmesh: int = static(default=0)
    neq: int = static(default=0)
    npair: int = static(default=0)
    nsensor: int = static(default=0)
    nsensordata: int = static(default=0)
    nmocap: int = static(default=0)
    nkey: int = static(default=0)
    nu: int = static(default=0)         # actuators (na act slots == nu)
    ntendon: int = static(default=0)
    ncon_max: int = static(default=0)   # contact budget K (top-K compaction)
    nefc_max: int = static(default=0)   # padded constraint-row capacity
    ncand: int = static(default=0)      # total narrowphase candidates
    max_condim: int = static(default=1)  # rows per contact = 2*(max_condim-1)
    contact_efcadr: int = static(default=0)  # first contact row address
    npair_unsupported: int = static(default=0)  # dropped pair-type combos
    # tree levels: tuple of tuples of body ids, root (world) excluded
    body_levels: tuple = static(default=())
    # per-body joint slots: max joints in any body (for unrolled FK loop)
    max_jnt_per_body: int = static(default=0)
    # dof ancestry: tuple-of-tuples static masks are big; keep as array leaf
    ancestor_mask: jax.Array = field(default=None)   # (nbody, nv) f, 1 if dof is ancestor
    dof_jnt_slot: jax.Array = field(default=None)    # unused placeholder
    # host-side static structure arrays (parent ids, joint layout, ...)
    layout: Any = static(default=None)  # Layout

    # host-only name tables (static, hashable-ish: tuples)
    names: Any = static(default=None)  # NameTable


class Layout:
    """Host-side static structure arrays (numpy), hashable for jit caching.

    Kernels index model/state leaves with these *constant* arrays, so XLA
    sees static gathers and the tree structure never becomes traced data.
    """

    def __init__(self, **arrays):
        self._arrays = {k: np.ascontiguousarray(v) for k, v in arrays.items()}
        self._hash = hash(tuple(
            (k, v.shape, v.tobytes()) for k, v in sorted(self._arrays.items())))

    def __getattr__(self, k):
        try:
            return self._arrays[k]
        except KeyError:
            raise AttributeError(k)

    def __hash__(self):
        return self._hash

    def __eq__(self, other):
        return isinstance(other, Layout) and self._hash == other._hash and all(
            np.array_equal(v, other._arrays.get(k))
            for k, v in self._arrays.items())


class NameTable:
    """Host-side bidirectional name<->id maps per object class.

    Equivalent of mj_name2id/mj_id2name used ~50x by the reference
    (SURVEY.md §2.2).  Hashable so it can ride in pytree aux data.
    """

    __slots__ = ("body", "joint", "geom", "site", "mesh", "sensor", "eq",
                 "actuator", "tendon", "key", "_body_inv", "_joint_inv",
                 "_geom_inv", "_site_inv", "_act_inv", "_ten_inv",
                 "_key_inv")

    def __init__(self, body=(), joint=(), geom=(), site=(), mesh=(),
                 sensor=(), eq=(), actuator=(), tendon=(), key=()):
        self.body = tuple(body)
        self.joint = tuple(joint)
        self.geom = tuple(geom)
        self.site = tuple(site)
        self.mesh = tuple(mesh)
        self.sensor = tuple(sensor)
        self.eq = tuple(eq)
        self.actuator = tuple(actuator)
        self.tendon = tuple(tendon)
        self.key = tuple(key)
        self._key_inv = {n: i for i, n in enumerate(self.key)}
        self._ten_inv = {n: i for i, n in enumerate(self.tendon)}
        self._act_inv = {n: i for i, n in enumerate(self.actuator)}
        self._body_inv = {n: i for i, n in enumerate(self.body)}
        self._joint_inv = {n: i for i, n in enumerate(self.joint)}
        self._geom_inv = {n: i for i, n in enumerate(self.geom)}
        self._site_inv = {n: i for i, n in enumerate(self.site)}

    def body_id(self, name: str) -> int:
        return self._body_inv.get(name, -1)

    def joint_id(self, name: str) -> int:
        return self._joint_inv.get(name, -1)

    def geom_id(self, name: str) -> int:
        return self._geom_inv.get(name, -1)

    def site_id(self, name: str) -> int:
        return self._site_inv.get(name, -1)

    def actuator_id(self, name: str) -> int:
        return self._act_inv.get(name, -1)

    def tendon_id(self, name: str) -> int:
        return self._ten_inv.get(name, -1)

    def key_id(self, name: str) -> int:
        return self._key_inv.get(name, -1)

    def __hash__(self):
        return hash((self.body, self.joint, self.geom, self.site, self.mesh,
                     self.sensor, self.eq, self.actuator, self.tendon,
                     self.key))

    def __eq__(self, other):
        return isinstance(other, NameTable) and (
            self.body, self.joint, self.geom, self.site, self.mesh,
            self.sensor, self.eq, self.actuator, self.tendon,
        ) == (
            other.body, other.joint, other.geom, other.site, other.mesh,
            other.sensor, other.eq, other.actuator, other.tendon,
        )


@pytree
class Contact:
    """Padded contact set (ncon_max slots, mask-active)."""

    dist: jax.Array        # (ncon,)
    pos: jax.Array         # (ncon, 3)
    frame: jax.Array       # (ncon, 3, 3) rows: normal, tangent1, tangent2
    geom1: jax.Array       # (ncon,) i32
    geom2: jax.Array       # (ncon,) i32
    includemargin: jax.Array  # (ncon,)
    friction: jax.Array    # (ncon, 5)
    solref: jax.Array      # (ncon, 2)
    solimp: jax.Array      # (ncon, 5)
    dim: jax.Array         # (ncon,) i32 condim
    efc_address: jax.Array  # (ncon,) i32
    active: jax.Array      # (ncon,) bool


@pytree
class Data:
    """Per-env dynamic state + derived quantities (mjData equivalent).

    Everything is (potentially) batched with a leading env axis via vmap.
    """

    time: jax.Array
    qpos: jax.Array            # (nq,)
    qvel: jax.Array            # (nv,)
    qacc: jax.Array            # (nv,)
    qacc_warmstart: jax.Array  # (nv,)
    qfrc_applied: jax.Array    # (nv,)
    xfrc_applied: jax.Array    # (nbody, 6) [torque, force] world at body com
    ctrl: jax.Array            # (nu,) actuator controls
    act: jax.Array             # (nu,) activation state (0 for dyntype none)
    act_dot: jax.Array         # (nu,) activation derivative
    actuator_length: jax.Array    # (nu,)
    actuator_velocity: jax.Array  # (nu,)
    actuator_force: jax.Array  # (nu,) scalar transmission force
    qfrc_actuator: jax.Array   # (nv,)
    ten_length: jax.Array      # (ntendon,)
    ten_velocity: jax.Array    # (ntendon,)
    ten_J: jax.Array           # (ntendon, nv) moment rows (mj_tendon)

    # masked-slot scene state (spawn/destroy; SURVEY §3.3 contract)
    body_active: jax.Array     # (nbody,) bool
    # request-parameterized spawn geometry (mj_ros.cpp:941-966,1340-1412):
    # the reference rebuilds the model from the request's size/rgba/inertial;
    # here they are per-env STATE so a spawn applies them with zero retrace
    geom_size: jax.Array       # (ngeom, 3)
    geom_rbound: jax.Array     # (ngeom,)
    geom_rgba: jax.Array       # (ngeom, 4)
    body_mass: jax.Array       # (nbody,)
    body_inertia: jax.Array    # (nbody, 3)
    # mocap bodies: pose set directly by the host/collectives (the '_ref'
    # twins of the reference's multi-instance sync, mj_sim.cpp:847-960)
    mocap_pos: jax.Array       # (nmocap, 3)
    mocap_quat: jax.Array      # (nmocap, 4)

    # kinematics
    xpos: jax.Array            # (nbody, 3)
    xquat: jax.Array           # (nbody, 4)
    xipos: jax.Array           # (nbody, 3)
    ximat: jax.Array           # (nbody, 3, 3)
    xanchor: jax.Array         # (njnt, 3)
    xaxis: jax.Array           # (njnt, 3)
    geom_xpos: jax.Array       # (ngeom, 3)
    geom_xmat: jax.Array       # (ngeom, 3, 3)
    site_xpos: jax.Array       # (nsite, 3)
    site_xmat: jax.Array       # (nsite, 3, 3)
    subtree_com: jax.Array     # (nbody, 3)

    # dynamics
    cvel: jax.Array            # (nbody, 6) com-frame spatial velocity
    cdof: jax.Array            # (nv, 6) dof motion axes (about subtree com)
    cdof_dot: jax.Array        # (nv, 6)
    qM: jax.Array              # (nv, nv) dense mass matrix
    # cholesky factor of qM (+ armature)
    qLD: jax.Array             # (nv, nv)
    qfrc_bias: jax.Array       # (nv,)
    qfrc_passive: jax.Array    # (nv,)
    qfrc_spring: jax.Array     # (nv,)
    qfrc_damper: jax.Array     # (nv,)
    qfrc_gravcomp: jax.Array   # (nv,)
    qfrc_smooth: jax.Array     # (nv,)
    qacc_smooth: jax.Array     # (nv,)
    qfrc_constraint: jax.Array  # (nv,)
    qfrc_inverse: jax.Array    # (nv,)

    # constraints
    contact: Contact
    ncon: jax.Array            # i32 active contact count
    efc_J: jax.Array           # (nefc, nv)
    efc_D: jax.Array           # (nefc,)
    efc_aref: jax.Array        # (nefc,)
    efc_R: jax.Array           # (nefc,)
    efc_frictionloss: jax.Array  # (nefc,)
    efc_floss_active: jax.Array  # (nefc,) bool friction-loss rows
    efc_active: jax.Array      # (nefc,) bool
    efc_type: jax.Array        # (nefc,) i32 0=eq,1=fric,2=limit,3=contact
    efc_force: jax.Array       # (nefc,)

    # outputs
    sensordata: jax.Array      # (nsensordata,)
    energy: jax.Array          # (2,) potential, kinetic


def contact_rows_per(max_condim: int, cone: int) -> int:
    """efc rows per contact slot: pyramidal = +-pair per friction axis;
    elliptic = one row per contact dimension (normal + frictions)."""
    if cone == int(ConeType.ELLIPTIC):
        return max(1, max_condim)
    return max(1, 2 * (max_condim - 1))


def np_f(x, dtype=np.float64):
    return np.asarray(x, dtype=dtype)


def np_i(x):
    return np.asarray(x, dtype=np.int32)
