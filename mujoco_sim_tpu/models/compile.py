"""Spec -> frozen Model compiler (host side).

Replaces the reference's reliance on mj_loadXML + mjModel (reference:
include/mujoco_sim/mj_util.h:185-193, src/mujoco_sim/mj_sim.cpp:804-845) with
our own compiler that produces a padded, device-ready pytree.  Field
semantics are oracle-tested against mujoco.MjModel in tests/test_compile.py.
"""

from __future__ import annotations

import os

import numpy as np

from mujoco_sim_tpu.models import mjcf, rotations as R
from mujoco_sim_tpu.models.model import (
    Model, Option, NameTable, Layout, JointType, GeomType, EqType, Integrator,
    ConeType, SensorType, np_f, np_i,
)

_JNT_TYPE = {"free": JointType.FREE, "ball": JointType.BALL,
             "slide": JointType.SLIDE, "hinge": JointType.HINGE}
_GEOM_TYPE = {"plane": GeomType.PLANE, "hfield": GeomType.HFIELD,
              "sphere": GeomType.SPHERE, "capsule": GeomType.CAPSULE,
              "ellipsoid": GeomType.ELLIPSOID, "cylinder": GeomType.CYLINDER,
              "box": GeomType.BOX, "mesh": GeomType.MESH}
_JNT_NQ = {JointType.FREE: 7, JointType.BALL: 4, JointType.SLIDE: 1,
           JointType.HINGE: 1}
_JNT_NV = {JointType.FREE: 6, JointType.BALL: 3, JointType.SLIDE: 1,
           JointType.HINGE: 1}
_INTEGRATOR = {"Euler": Integrator.EULER, "RK4": Integrator.RK4,
               "implicit": Integrator.IMPLICIT,
               "implicitfast": Integrator.IMPLICITFAST}

# candidate-contact capacities and group layout are shared with the
# collision kernels (ops/colgroups.py); unsupported type combos are DROPPED
# from the candidate list and counted in Model.npair_unsupported.
from mujoco_sim_tpu.ops.colgroups import (
    PAIR_NCON as _PAIR_NCON, build_groups, pair_key)


def _geom_mass_inertia(g: mjcf.GeomSpec, mesh_props=None):
    """(mass, com(3) in geom frame, inertia about com in geom frame).

    Inertia is returned as a diag 3-vector for primitives and a full 3x3
    matrix for meshes.  Formulas match MuJoCo's mjCGeom::SetInertia.
    """
    t = _GEOM_TYPE[g.type]
    s = g.size
    if t == GeomType.SPHERE:
        vol = 4.0 / 3.0 * np.pi * s[0] ** 3
        m = g.mass if g.mass is not None else g.density * vol
        i = 0.4 * m * s[0] ** 2
        return m, np.zeros(3), np.array([i, i, i])
    if t == GeomType.BOX:
        vol = 8.0 * s[0] * s[1] * s[2]
        m = g.mass if g.mass is not None else g.density * vol
        return m, np.zeros(3), m / 3.0 * np.array(
            [s[1] ** 2 + s[2] ** 2, s[0] ** 2 + s[2] ** 2, s[0] ** 2 + s[1] ** 2])
    if t == GeomType.CYLINDER:
        r, hh = s[0], s[1]
        vol = 2.0 * np.pi * r * r * hh
        m = g.mass if g.mass is not None else g.density * vol
        ix = m * (3.0 * r * r + 4.0 * hh * hh) / 12.0
        return m, np.zeros(3), np.array([ix, ix, 0.5 * m * r * r])
    if t == GeomType.CAPSULE:
        r, hh = s[0], s[1]
        vs = 4.0 / 3.0 * np.pi * r ** 3
        vc = 2.0 * np.pi * r * r * hh
        m = g.mass if g.mass is not None else g.density * (vs + vc)
        ms = m * vs / (vs + vc)
        mc = m - ms
        iz = 0.4 * ms * r * r + 0.5 * mc * r * r
        ix = (0.4 * ms * r * r + ms * (0.75 * r * hh + hh * hh)
              + mc * (r * r / 4.0 + hh * hh / 3.0))
        return m, np.zeros(3), np.array([ix, ix, iz])
    if t == GeomType.ELLIPSOID:
        vol = 4.0 / 3.0 * np.pi * s[0] * s[1] * s[2]
        m = g.mass if g.mass is not None else g.density * vol
        return m, np.zeros(3), m / 5.0 * np.array(
            [s[1] ** 2 + s[2] ** 2, s[0] ** 2 + s[2] ** 2, s[0] ** 2 + s[1] ** 2])
    if t == GeomType.MESH:
        assert mesh_props is not None, "mesh geom without mesh data"
        vol, com, imat = mesh_props  # unit-density inertia about com
        m = g.mass if g.mass is not None else g.density * vol
        return m, com, imat * (m / max(vol, 1e-30))
    if t in (GeomType.PLANE, GeomType.HFIELD):
        return 0.0, np.zeros(3), np.zeros(3)
    raise NotImplementedError(f"geom type {g.type}")


def _accumulate_inertia(geoms, mesh_lookup):
    """Combine per-geom mass properties into body (mass, ipos, iquat, diag)."""
    masses, coms, inertias, contrib = [], [], [], []
    for g in geoms:
        mesh_props = mesh_lookup(g) if g.type == "mesh" else None
        m, com_g, diag = _geom_mass_inertia(g, mesh_props)
        if m <= 0:
            continue
        rot = R.quat_to_mat_np(g.quat)
        com_b = g.pos + rot @ com_g
        local = diag if np.ndim(diag) == 2 else np.diag(diag)
        imat = rot @ local @ rot.T
        masses.append(m)
        coms.append(com_b)
        inertias.append(imat)
        contrib.append((g, com_g, diag))
    if not masses:
        return 0.0, np.zeros(3), np.array([1.0, 0, 0, 0]), np.zeros(3)
    if len(masses) == 1 and np.ndim(contrib[0][2]) == 1:
        # single primitive geom: the oracle keeps the geom's own frame and
        # its (unsorted) diagonal — eigendecomposition would pick an
        # arbitrary gauge for degenerate pairs (probed vs body_iquat)
        g, com_g, diag = contrib[0]
        rot = R.quat_to_mat_np(g.quat)
        return float(masses[0]), g.pos + rot @ com_g, \
            np.asarray(g.quat, float), np.asarray(diag, float)
    mass = float(np.sum(masses))
    com = np.sum([m * c for m, c in zip(masses, coms)], axis=0) / mass
    total = np.zeros((3, 3))
    for m, c, imat in zip(masses, coms, inertias):
        d = c - com
        total += imat + m * (np.dot(d, d) * np.eye(3) - np.outer(d, d))
    evals, evecs = np.linalg.eigh(total)
    # MuJoCo orders principal axes by decreasing inertia
    order = np.argsort(evals)[::-1]
    evals = evals[order]
    evecs = evecs[:, order]
    if np.linalg.det(evecs) < 0:
        evecs[:, 2] *= -1
    return mass, com, R.mat_to_quat_np(evecs), np.maximum(evals, 0.0)


def compile_spec(spec: mjcf.SpecTree, ncon_budget: int | None = None,
                 max_hull_verts: int = 32) -> Model:
    """Flatten a SpecTree into a frozen Model (numpy-backed; f64).

    ncon_budget: max simultaneous contacts kept per step (top-K compaction);
    default min(total candidates, 64).
    max_hull_verts: collision-hull decimation cap (mesh_io.decimate_hull);
    the padded mesh-narrowphase tensors scale with the largest hull, so the
    cap bounds the PR2-class contact cost.  Mass properties always use the
    full raw mesh.  0 disables decimation.
    """
    from mujoco_sim_tpu.models import mesh_io

    # ---- meshes
    mesh_names = [m.name for m in spec.meshes]
    mesh_idx = {n: i for i, n in enumerate(mesh_names)}
    mesh_verts, mesh_props, mesh_fulls, mesh_vis = [], [], [], []
    meshdir = os.path.join(spec.base_dir, spec.compiler.meshdir)
    for msp in spec.meshes:
        if msp.vertex is not None:
            # inline vertex mesh: hull of the given points (MuJoCo
            # qhulls inline meshes the same way)
            hull, props, full = mesh_io.process_mesh(
                msp.vertex * np.asarray(msp.scale),
                max_hull_verts=max_hull_verts)
            mesh_verts.append(hull)
            mesh_props.append(props)
            mesh_fulls.append(full)
            mesh_vis.append(mesh_io.convex_hull(full))
            continue
        path = os.path.join(meshdir, msp.file)
        verts = mesh_io.load_mesh_vertices(path, msp.scale)
        tris = None
        if path.lower().endswith(".stl"):
            # raw triangles feed the oracle-matching legacy inertia
            tris = mesh_io.load_stl(path) * np.asarray(msp.scale)
        hull, props, full = mesh_io.process_mesh(
            verts, max_hull_verts=max_hull_verts, tris=tris)
        mesh_verts.append(hull)
        mesh_props.append(props)  # (volume, com, inertia_mat about com)
        mesh_fulls.append(full)
        # RAW indexed triangle surface (may be non-convex) for visual
        # fidelity — USD export + viewer (VERDICT r4 missing #3); the
        # hull is only the COLLISION shape.  Hull fallback for formats
        # without face data.
        vis = mesh_io.load_visual_mesh(path, msp.scale)
        mesh_vis.append(vis if vis is not None
                        else mesh_io.convex_hull(full))

    # packed visual-mesh tables (host-only, ride in Layout)
    vis_vert, vis_face = [], []
    vis_vertadr, vis_vertnum = [], []
    vis_faceadr, vis_facenum = [], []
    for vv, vf in mesh_vis:
        vis_vertadr.append(sum(len(x) for x in vis_vert))
        vis_vertnum.append(len(vv))
        vis_faceadr.append(sum(len(x) for x in vis_face))
        vis_facenum.append(len(vf))
        vis_vert.append(np.asarray(vv, float))
        vis_face.append(np.asarray(vf, dtype=int))
    mesh_visvert = (np.concatenate(vis_vert) if vis_vert
                    else np.zeros((0, 3)))
    mesh_visface = (np.concatenate(vis_face) if vis_face
                    else np.zeros((0, 3), dtype=int))

    # ---- materials / textures (appearance metadata; VERDICT r4 #4)
    mat_idx = {x.name: i for i, x in enumerate(spec.materials)}
    tex_idx = {x.name: i for i, x in enumerate(spec.textures)}
    _BUILTIN = {"none": 0, "gradient": 1, "checker": 2, "flat": 3}
    nmat, ntex = len(spec.materials), len(spec.textures)
    mat_rgba = (np.stack([x.rgba for x in spec.materials])
                if nmat else np.zeros((0, 4)))
    mat_texid = np.asarray([tex_idx.get(x.texture, -1)
                            for x in spec.materials], dtype=int)
    mat_texrepeat = (np.stack([x.texrepeat for x in spec.materials])
                     if nmat else np.zeros((0, 2)))
    mat_scalar = np.asarray(
        [[x.emission, x.specular, x.shininess, x.reflectance]
         for x in spec.materials], dtype=float).reshape(nmat, 4)
    tex_rgb12 = np.asarray([[*x.rgb1, *x.rgb2] for x in spec.textures],
                           dtype=float).reshape(ntex, 6)
    tex_builtin = np.asarray(
        [_BUILTIN.get(x.builtin, 0) for x in spec.textures], dtype=int)

    # ---- flatten bodies depth-first (preorder = MuJoCo id order)
    bodies: list[mjcf.BodySpec] = []
    parents: list[int] = []

    def walk(b, parent_id):
        bid = len(bodies)
        bodies.append(b)
        parents.append(parent_id)
        for c in b.children:
            walk(c, bid)

    walk(spec.world, -1)
    nbody = len(bodies)

    body_name = [b.name or f"body{i}" for i, b in enumerate(bodies)]
    body_name[0] = "world"
    body_parentid = np.array(parents)
    body_parentid[0] = 0

    # joints / dofs / qpos layout
    jnt_specs, jnt_bodyid = [], []
    body_jntadr = np.full(nbody, -1)
    body_jntnum = np.zeros(nbody, dtype=int)
    for i, b in enumerate(bodies):
        if b.joints:
            body_jntadr[i] = len(jnt_specs)
            body_jntnum[i] = len(b.joints)
        for j in b.joints:
            jnt_specs.append(j)
            jnt_bodyid.append(i)
    njnt = len(jnt_specs)
    jnt_type = np.array([int(_JNT_TYPE[j.type]) for j in jnt_specs])
    jnt_qposadr = np.zeros(njnt, dtype=int)
    jnt_dofadr = np.zeros(njnt, dtype=int)
    nq = nv = 0
    for k, j in enumerate(jnt_specs):
        jnt_qposadr[k] = nq
        jnt_dofadr[k] = nv
        nq += _JNT_NQ[JointType(jnt_type[k])]
        nv += _JNT_NV[JointType(jnt_type[k])]

    body_dofadr = np.full(nbody, -1)
    body_dofnum = np.zeros(nbody, dtype=int)
    for i in range(nbody):
        if body_jntnum[i]:
            body_dofadr[i] = jnt_dofadr[body_jntadr[i]]
            body_dofnum[i] = sum(
                _JNT_NV[JointType(jnt_type[body_jntadr[i] + k])]
                for k in range(body_jntnum[i]))

    # dof tables
    dof_bodyid = np.zeros(nv, dtype=int)
    dof_jntid = np.zeros(nv, dtype=int)
    dof_parentid = np.full(nv, -1)
    dof_armature = np.zeros(nv)
    dof_damping = np.zeros(nv)
    dof_frictionloss = np.zeros(nv)
    # last dof of each body's chain (walking up to find dof parent)
    last_dof_of_body = np.full(nbody, -1)
    for i in range(nbody):
        if i == 0:
            continue
        p = body_parentid[i]
        inherited = last_dof_of_body[p]
        cursor = inherited
        for k in range(body_jntnum[i]):
            jid = body_jntadr[i] + k
            j = jnt_specs[jid]
            ndof = _JNT_NV[JointType(jnt_type[jid])]
            for d in range(ndof):
                dv = jnt_dofadr[jid] + d
                dof_bodyid[dv] = i
                dof_jntid[dv] = jid
                dof_parentid[dv] = cursor
                cursor = dv
                dof_armature[dv] = j.armature
                dof_damping[dv] = j.damping
                dof_frictionloss[dv] = j.frictionloss
        last_dof_of_body[i] = cursor if body_jntnum[i] else inherited

    # weldid: body welded to parent when jointless
    body_weldid = np.zeros(nbody, dtype=int)
    for i in range(1, nbody):
        body_weldid[i] = i if body_jntnum[i] else body_weldid[body_parentid[i]]

    # rootid: top-level ancestor under world
    body_rootid = np.zeros(nbody, dtype=int)
    for i in range(1, nbody):
        p = body_parentid[i]
        body_rootid[i] = i if p == 0 else body_rootid[p]

    # tree levels (world excluded)
    depth = np.zeros(nbody, dtype=int)
    for i in range(1, nbody):
        depth[i] = depth[body_parentid[i]] + 1
    maxd = depth.max() if nbody > 1 else 0
    body_levels = tuple(
        tuple(int(i) for i in np.nonzero(depth == lv)[0])
        for lv in range(1, maxd + 1))

    # ancestor dof mask
    ancestor_mask = np.zeros((nbody, nv))
    for i in range(1, nbody):
        b = i
        while b != 0:
            if body_dofnum[b]:
                a = body_dofadr[b]
                ancestor_mask[i, a:a + body_dofnum[b]] = 1.0
            b = body_parentid[b]

    # ---- inertial properties
    comp = spec.compiler
    body_pos = np.stack([b.pos for b in bodies])
    body_quat = np.stack([b.quat for b in bodies])
    body_mass = np.zeros(nbody)
    body_ipos = np.zeros((nbody, 3))
    body_iquat = np.tile(np.array([1.0, 0, 0, 0]), (nbody, 1))
    body_inertia = np.zeros((nbody, 3))
    body_gravcomp = np.array([b.gravcomp for b in bodies])
    body_mocapid = np.full(nbody, -1)
    mocap_ids = [i for i, b in enumerate(bodies) if getattr(b, "mocap", False)]
    for k, i in enumerate(mocap_ids):
        body_mocapid[i] = k
    nmocap = len(mocap_ids)

    def mesh_lookup(g):
        return mesh_props[mesh_idx[g.mesh]]

    for i, b in enumerate(bodies):
        if i == 0:
            continue
        use_geom = (comp.inertiafromgeom == "true"
                    or (comp.inertiafromgeom == "auto" and b.inertial is None))
        if use_geom:
            m, com, iquat, diag = _accumulate_inertia(b.geoms, mesh_lookup)
        elif b.inertial is not None:
            ine = b.inertial
            m = ine.mass
            com = ine.pos
            if ine.fullinertia is not None:
                fi = ine.fullinertia
                mat = np.array([[fi[0], fi[3], fi[4]],
                                [fi[3], fi[1], fi[5]],
                                [fi[4], fi[5], fi[2]]])
                evals, evecs = np.linalg.eigh(mat)
                order = np.argsort(evals)[::-1]
                evals, evecs = evals[order], evecs[:, order]
                if np.linalg.det(evecs) < 0:
                    evecs[:, 2] *= -1
                iquat = R.mat_to_quat_np(evecs)
                diag = evals
            else:
                iquat = ine.quat
                diag = (ine.diaginertia if ine.diaginertia is not None
                        else np.zeros(3))
        else:
            m, com, iquat, diag = 0.0, np.zeros(3), np.array([1.0, 0, 0, 0]), np.zeros(3)
        diag = np.asarray(diag, dtype=float).copy()
        m = float(m)
        if comp.boundmass > 0:
            m = max(m, comp.boundmass)
        if comp.boundinertia > 0:
            diag = np.maximum(diag, comp.boundinertia)
        if comp.balanceinertia:
            A, B, C = np.sort(diag)[::-1]
            if A > B + C:
                diag[:] = (A + B + C) / 3.0
        body_mass[i] = m
        body_ipos[i] = com
        body_iquat[i] = iquat
        body_inertia[i] = diag

    body_subtreemass = body_mass.copy()
    for i in range(nbody - 1, 0, -1):
        body_subtreemass[body_parentid[i]] += body_subtreemass[i]

    # ---- joints arrays
    jnt_pos = np.stack([j.pos for j in jnt_specs]) if njnt else np.zeros((0, 3))
    jnt_axis = np.stack([j.axis for j in jnt_specs]) if njnt else np.zeros((0, 3))
    jnt_range = np.stack([j.range for j in jnt_specs]) if njnt else np.zeros((0, 2))
    jnt_limited = (np.array([j.limited for j in jnt_specs])
                   if njnt else np.zeros(0, dtype=bool))
    jnt_stiffness = np.array([j.stiffness for j in jnt_specs]) if njnt else np.zeros(0)
    jnt_springref = np.array([j.springref for j in jnt_specs]) if njnt else np.zeros(0)
    jnt_ref = np.array([j.ref for j in jnt_specs]) if njnt else np.zeros(0)
    jnt_margin = np.array([j.margin for j in jnt_specs]) if njnt else np.zeros(0)
    jnt_solref = (np.stack([j.solref_limit for j in jnt_specs])
                  if njnt else np.zeros((0, 2)))
    jnt_solimp = (np.stack([j.solimp_limit for j in jnt_specs])
                  if njnt else np.zeros((0, 5)))

    # ---- geoms
    geom_specs, geom_bodyid = [], []
    for i, b in enumerate(bodies):
        for g in b.geoms:
            geom_specs.append(g)
            geom_bodyid.append(i)
    ngeom = len(geom_specs)
    geom_type = np.array([int(_GEOM_TYPE[g.type]) for g in geom_specs])
    geom_dataid = np.array([mesh_idx.get(g.mesh, -1) if g.type == "mesh" else -1
                            for g in geom_specs])
    geom_pos = (np.stack([g.pos for g in geom_specs]) if ngeom
                else np.zeros((0, 3)))
    geom_quat = (np.stack([g.quat for g in geom_specs]) if ngeom
                 else np.zeros((0, 4)))
    geom_size = (np.stack([g.size for g in geom_specs]) if ngeom
                 else np.zeros((0, 3)))

    # mesh re-centering: shift hull verts to COM/principal frame, compose the
    # offset into geom pos/quat (MuJoCo does the same; the reference works
    # around it in save_geom_quat, src/mujoco_sim/mj_sim.cpp:715-793)
    mesh_vert_list, mesh_vertadr, mesh_vertnum = [], [], []
    mesh_hi_list = []   # full-fidelity hulls, same recentered frame
    adr = 0
    recentered = []
    for verts, (vol, com, imat), full in zip(mesh_verts, mesh_props,
                                             mesh_fulls):
        evals, evecs = np.linalg.eigh(imat)
        order = np.argsort(evals)[::-1]
        evecs = evecs[:, order]
        if np.linalg.det(evecs) < 0:
            evecs[:, 2] *= -1
        local = (verts - com) @ evecs
        recentered.append((com, R.mat_to_quat_np(evecs)))
        mesh_vert_list.append(local)
        mesh_hi_list.append((full - com) @ evecs)
        mesh_vertadr.append(adr)
        mesh_vertnum.append(len(local))
        adr += len(local)
    for gi, g in enumerate(geom_specs):
        if geom_dataid[gi] >= 0:
            com, mq = recentered[geom_dataid[gi]]
            rot = R.quat_to_mat_np(geom_quat[gi])
            geom_pos[gi] = geom_pos[gi] + rot @ com
            geom_quat[gi] = R.quat_mul_np(geom_quat[gi], mq)
    mesh_vert = (np.concatenate(mesh_vert_list, axis=0) if mesh_vert_list
                 else np.zeros((0, 3)))

    # padded hull tables for the hull narrowphase: verts (nhull,maxvert,3)
    # and face planes (nhull,maxface,4) [normal, offset] per-hull frame.
    # Hulls = mesh convex hulls + synthetic 16-gon prisms for cylinders
    # (one hull code path for cylinder-vs-anything-but-plane).  Padding
    # verts are masked; padding planes sit at -inf so they never win the
    # hull-SDF max.
    geom_hullid = np.full(ngeom, -1)
    hull_entries = []  # (verts, face_planes) — decimated, hot shallow SAT
    hull_hi_entries = []  # (verts, face_planes) — FULL hull, exact manifold
    hull_cyl_list = []  # per hull [is_cyl, radius, half_height]

    def _plane_eqs(hv, faces):
        a_ = hv[faces[:, 0]]
        b_ = hv[faces[:, 1]]
        c_ = hv[faces[:, 2]]
        nrm = np.cross(b_ - a_, c_ - a_)
        nrm /= np.maximum(np.linalg.norm(nrm, axis=1, keepdims=True), 1e-30)
        off = np.einsum("ij,ij->i", nrm, a_)
        return np.concatenate([nrm, off[:, None]], axis=1)

    if mesh_vert_list:
        from mujoco_sim_tpu.models import mesh_io as _mio
        for local, hi in zip(mesh_vert_list, mesh_hi_list):
            hv, faces = _mio.convex_hull(local)
            hull_entries.append((local, _plane_eqs(hv, faces)))
            hv2, faces2 = _mio.convex_hull(hi)
            hull_hi_entries.append((hv2, _plane_eqs(hv2, faces2)))
            hull_cyl_list.append([0.0, 0.0, 0.0])
    for gi in range(ngeom):
        t = GeomType(geom_type[gi])
        if t == GeomType.MESH:
            geom_hullid[gi] = geom_dataid[gi]
        elif t == GeomType.CYLINDER:
            # circumscribed 16-gon prism (side planes at exactly radius r)
            r, hh = geom_size[gi][0], geom_size[gi][1]
            nside = 16
            th = np.arange(nside) * 2 * np.pi / nside
            rv = r / np.cos(np.pi / nside)
            ring = np.stack([rv * np.cos(th + np.pi / nside),
                             rv * np.sin(th + np.pi / nside)], axis=1)
            verts = np.concatenate([
                np.concatenate([ring, np.full((nside, 1), hh)], axis=1),
                np.concatenate([ring, np.full((nside, 1), -hh)], axis=1)])
            side_n = np.stack([np.cos(th), np.sin(th),
                               np.zeros(nside)], axis=1)
            planes = np.concatenate([
                np.concatenate([side_n, np.full((nside, 1), r)], axis=1),
                [[0, 0, 1, hh], [0, 0, -1, hh]]])
            geom_hullid[gi] = len(hull_entries)
            hull_entries.append((verts, planes))
            hull_hi_entries.append((verts, planes))
            # the deep-pair exact manifold treats prism hulls as TRUE
            # cylinders (analytic support + tangent-line features): the
            # prism's vertex features sweep as the cylinder rolls and the
            # resulting off-center friction at depth spins wheel joints
            # up (ridgeback base-wheel pairs, r3 diagnosis)
            hull_cyl_list.append([1.0, float(r), float(hh)])

    if hull_entries:
        maxvert = max(len(v) for v, _ in hull_entries)
        maxface = max(len(f) for _, f in hull_entries)
        nhull = len(hull_entries)
        mesh_vert_pad = np.full((nhull, maxvert, 3), 1e6)
        mesh_vert_mask = np.zeros((nhull, maxvert))
        mesh_face_pad = np.zeros((nhull, maxface, 4))
        mesh_face_pad[:, :, 3] = 1e9  # padding: n.x - d = -1e9
        for hi, (verts, fp) in enumerate(hull_entries):
            mesh_vert_pad[hi, :len(verts)] = verts
            mesh_vert_mask[hi, :len(verts)] = 1.0
            mesh_face_pad[hi, :len(fp)] = fp
        # ---- exact deep-pair manifold tables (ops/manifold.py), built
        # from the FULL hulls: decimation error (mm-scale) rotates the
        # exact MTV at deep penetration (hsrb4s wheel-well diagnosis).
        # These are only touched inside the deep-pair gate, so their
        # larger padding never costs the hot shallow-SAT path.
        maxvhi = max(len(v) for v, _ in hull_hi_entries)
        # pads REPEAT the first real vertex (not a 1e6 sentinel): the
        # exact query's support min/max then needs no mask, so XLA fuses
        # the (C, V) axis-support product straight into each reduction
        # instead of materializing it for masked re-reads.  The mask
        # stays for the feature-classification step (duplicate verts
        # would inflate its in-window count).
        mesh_vert_hi = np.zeros((nhull, maxvhi, 3))
        mesh_vert_hi_mask = np.zeros((nhull, maxvhi))
        for hi, (verts, _) in enumerate(hull_hi_entries):
            mesh_vert_hi[hi] = verts[0]
            mesh_vert_hi[hi, :len(verts)] = verts
            mesh_vert_hi_mask[hi, :len(verts)] = 1.0
        # merged-face polygon tables for the face-clip manifold
        from mujoco_sim_tpu.models.mesh_io import face_polygons
        fp_list = [face_polygons(v, f) for v, f in hull_hi_entries]
        maxmface = max(len(fp) for fp, _, _ in fp_list)
        maxfv = max(p.shape[1] for _, p, _ in fp_list)
        mesh_fplane = np.zeros((nhull, maxmface, 4))
        mesh_fplane[:, :, 3] = 1e9
        mesh_fmask = np.zeros((nhull, maxmface))
        mesh_fpoly = np.zeros((nhull, maxmface, maxfv, 3))
        for hi, (fpl, poly, nfv) in enumerate(fp_list):
            mesh_fplane[hi, :len(fpl)] = fpl
            mesh_fmask[hi, :len(fpl)] = 1.0
            # face_polygons pads every poly to maxfv_cap columns by
            # repeating the last vertex, so poly.shape[1] == maxfv
            assert poly.shape[1] == maxfv
            mesh_fpoly[hi, :len(fpl)] = poly
        from mujoco_sim_tpu.models.mesh_io import hull_edges
        # full edge endpoint tables (exact-MTV top-K edge refinement)
        he_list = [hull_edges(p, n) for _, p, n in fp_list]
        maxhe = max(len(e) for e in he_list)
        mesh_hedge = np.full((nhull, maxhe, 2, 3), 1e6)
        mesh_hedge_mask = np.zeros((nhull, maxhe))
        for hi, he in enumerate(he_list):
            mesh_hedge[hi, :len(he)] = he
            mesh_hedge_mask[hi, :len(he)] = 1.0
        mesh_cyl = np.asarray(hull_cyl_list)
        # static local AABB per hull (FULL verts: conservative for the
        # decimated-SAT candidates) — the mesh-group AABB prefilter
        # (ops/collision._geom_aabb_static) reads this off the Layout
        hull_aabb = np.zeros((nhull, 2, 3))
        for hi, (verts, _) in enumerate(hull_hi_entries):
            v = np.asarray(verts)
            hull_aabb[hi, 0] = 0.5 * (v.min(0) + v.max(0))
            hull_aabb[hi, 1] = 0.5 * (v.max(0) - v.min(0))
    else:
        mesh_vert_pad = np.zeros((0, 1, 3))
        mesh_vert_mask = np.zeros((0, 1))
        mesh_face_pad = np.zeros((0, 1, 4))
        mesh_fplane = np.zeros((0, 1, 4))
        mesh_fmask = np.zeros((0, 1))
        mesh_fpoly = np.zeros((0, 1, 1, 3))
        mesh_cyl = np.zeros((0, 3))
        mesh_vert_hi = np.zeros((0, 1, 3))
        mesh_vert_hi_mask = np.zeros((0, 1))
        mesh_hedge = np.full((0, 1, 2, 3), 1e6)
        mesh_hedge_mask = np.zeros((0, 1))
        hull_aabb = np.zeros((0, 2, 3))

    # mesh geoms inherit the recentered hull's AABB half-extents as size
    # (matches mjModel.geom_size semantics for meshes)
    for gi in range(ngeom):
        if geom_dataid[gi] >= 0:
            v = mesh_vert_list[geom_dataid[gi]]
            geom_size[gi] = (v.max(axis=0) - v.min(axis=0)) / 2.0

    # ---- hfield assets: padded grids + per-geom hfield ids
    nhf = len(spec.hfields)
    hf_name2id = {h.name: i for i, h in enumerate(spec.hfields) if h.name}
    if nhf:
        maxr = max(h.nrow for h in spec.hfields)
        maxc = max(h.ncol for h in spec.hfields)
        hfield_data = np.zeros((nhf, maxr, maxc))
        for i, h in enumerate(spec.hfields):
            hfield_data[i, :h.nrow, :h.ncol] = h.data
        hfield_size = np.stack([h.size for h in spec.hfields])
    else:
        hfield_data = np.zeros((0, 1, 1))
        hfield_size = np.zeros((0, 4))
    hf_nrow = np.array([h.nrow for h in spec.hfields], dtype=int)
    hf_ncol = np.array([h.ncol for h in spec.hfields], dtype=int)
    geom_hfieldid = np.full(ngeom, -1, dtype=int)
    for gi, g in enumerate(geom_specs):
        if GeomType(geom_type[gi]) == GeomType.HFIELD:
            hid = hf_name2id.get(g.hfield, -1)
            if hid < 0:
                raise ValueError(f"geom '{g.name}': unknown hfield "
                                 f"'{g.hfield}'")
            geom_hfieldid[gi] = hid
            geom_size[gi] = spec.hfields[hid].size[:3]

    # bounding radius
    geom_rbound = np.zeros(ngeom)
    for gi, g in enumerate(geom_specs):
        t = GeomType(geom_type[gi])
        s = geom_size[gi]
        if t in (GeomType.PLANE, GeomType.HFIELD):
            geom_rbound[gi] = 0.0
        elif t == GeomType.SPHERE:
            geom_rbound[gi] = s[0]
        elif t == GeomType.CAPSULE:
            geom_rbound[gi] = s[0] + s[1]
        elif t == GeomType.CYLINDER:
            geom_rbound[gi] = np.sqrt(s[0] ** 2 + s[1] ** 2)
        elif t in (GeomType.BOX,):
            geom_rbound[gi] = np.linalg.norm(s)
        elif t == GeomType.ELLIPSOID:
            geom_rbound[gi] = s.max()
        elif t == GeomType.MESH:
            v = mesh_vert_list[geom_dataid[gi]]
            geom_rbound[gi] = np.linalg.norm(v, axis=1).max() if len(v) else 0.0

    # ---- sites
    site_specs, site_bodyid = [], []
    for i, b in enumerate(bodies):
        for s in b.sites:
            site_specs.append(s)
            site_bodyid.append(i)
    nsite = len(site_specs)

    # ---- equality constraints
    name2body = {n: i for i, n in enumerate(body_name)}
    name2jnt = {j.name: k for k, j in enumerate(jnt_specs) if j.name}
    name2ten_eq = {t.name: k for k, t in enumerate(spec.tendons) if t.name}
    eq_rows = []
    for e in spec.equalities:
        et = {"connect": EqType.CONNECT, "weld": EqType.WELD,
              "joint": EqType.JOINT, "tendon": EqType.TENDON}[e.type]
        data = np.array(e.data, dtype=float)
        if et == EqType.JOINT:
            o1 = name2jnt[e.obj1]
            o2 = name2jnt[e.obj2] if e.obj2 else -1
        elif et == EqType.TENDON:
            o1 = name2ten_eq[e.obj1]
            o2 = name2ten_eq[e.obj2] if e.obj2 else -1
        else:
            o1 = name2body[e.obj1]
            o2 = name2body[e.obj2] if e.obj2 else 0
            if et == EqType.WELD:
                data[10] = e.torquescale
        eq_rows.append((int(et), o1, o2, e.active, data, e.solref, e.solimp,
                        e.name))
    neq = len(eq_rows)

    # ---- collision pair list (static broadphase filter; SURVEY §2.2)
    exclude_sig = set()
    for b1, b2 in spec.excludes:
        i1, i2 = name2body.get(b1, -1), name2body.get(b2, -1)
        if i1 >= 0 and i2 >= 0:
            exclude_sig.add((min(i1, i2), max(i1, i2)))
    pair_g1, pair_g2 = [], []
    npair_unsupported = 0
    for g1 in range(ngeom):
        for g2 in range(g1 + 1, ngeom):
            b1, b2 = geom_bodyid[g1], geom_bodyid[g2]
            w1, w2 = body_weldid[b1], body_weldid[b2]
            if w1 == w2:
                continue
            # parent-child filter (unless parent weld is world)
            pw1 = body_weldid[body_parentid[w1]]
            pw2 = body_weldid[body_parentid[w2]]
            if (w1 == pw2 and w1 != 0) or (w2 == pw1 and w2 != 0):
                continue
            g1s, g2s = geom_specs[g1], geom_specs[g2]
            if not ((g1s.contype & g2s.conaffinity)
                    or (g2s.contype & g1s.conaffinity)):
                continue
            if (min(b1, b2), max(b1, b2)) in exclude_sig:
                continue
            t1, t2 = GeomType(geom_type[g1]), GeomType(geom_type[g2])
            if t1 == GeomType.PLANE and t2 == GeomType.PLANE:
                continue
            pk = pair_key(t1, t2)
            if pk is None:
                npair_unsupported += 1
                continue
            _, swapped = pk
            if swapped:
                pair_g1.append(g2)
                pair_g2.append(g1)
            else:
                pair_g1.append(g1)
                pair_g2.append(g2)
    npair = len(pair_g1)

    # ---- per-geom solver params already parsed; sensors
    # rows: (type, objid, objtype, adr, dim, cutoff, name)
    from mujoco_sim_tpu.models.model import ObjType
    sens = []
    name2site = {s.name: k for k, s in enumerate(site_specs) if s.name}
    name2jnt = {j.name: k for k, j in enumerate(jnt_specs) if j.name}
    name2act = {a.name: k for k, a in enumerate(spec.actuators) if a.name}
    name2ten = {t.name: k for k, t in enumerate(spec.tendons) if t.name}
    name2geom = {g.name: k for k, g in enumerate(geom_specs) if g.name}
    name2body_l = {n: k for k, n in enumerate(body_name)}
    _SDIM = {"touch": 1, "accelerometer": 3, "velocimeter": 3, "gyro": 3,
             "force": 3, "torque": 3, "magnetometer": 3, "rangefinder": 1,
             "jointpos": 1, "jointvel": 1, "ballquat": 4, "ballangvel": 3,
             "jointlimitpos": 1, "jointlimitvel": 1, "jointlimitfrc": 1,
             "tendonlimitpos": 1, "tendonlimitvel": 1, "tendonlimitfrc": 1,
             "tendonpos": 1, "tendonvel": 1,
             "actuatorpos": 1, "actuatorvel": 1, "actuatorfrc": 1,
             "framepos": 3, "framequat": 4, "framexaxis": 3,
             "frameyaxis": 3, "framezaxis": 3, "framelinvel": 3,
             "frameangvel": 3,
             "subtreecom": 3, "subtreelinvel": 3, "subtreeangmom": 3,
             "clock": 1}
    _FRAME_OBJ = {"site": (ObjType.SITE, name2site),
                  "body": (ObjType.BODY, name2body_l),
                  "xbody": (ObjType.XBODY, name2body_l),
                  "geom": (ObjType.GEOM, name2geom)}
    sadr = 0
    for s in spec.sensors:
        st = SensorType[s.type.upper()]
        objtype = 0
        reftype, refid = -1, -1
        if s.type in ("touch", "accelerometer", "velocimeter", "gyro",
                      "force", "torque", "magnetometer", "rangefinder"):
            objid = name2site.get(s.site, -1)
            if objid < 0:
                raise ValueError(f"sensor '{s.name}': unknown site "
                                 f"'{s.site}'")
        elif s.type in ("jointpos", "jointvel", "ballquat", "ballangvel",
                        "jointlimitpos", "jointlimitvel", "jointlimitfrc"):
            objid = name2jnt.get(s.objname, -1)
            if objid < 0:
                raise ValueError(f"sensor '{s.name}': unknown joint "
                                 f"'{s.objname}'")
            jt = JointType(jnt_type[objid])
            scalar = s.type not in ("ballquat", "ballangvel")
            if scalar != (jt in (JointType.HINGE, JointType.SLIDE)):
                raise ValueError(f"sensor '{s.name}': joint type mismatch "
                                 f"({s.type} on {jt.name})")
        elif s.type in ("tendonpos", "tendonvel", "tendonlimitpos",
                        "tendonlimitvel", "tendonlimitfrc"):
            objid = name2ten.get(s.objname, -1)
            if objid < 0:
                raise ValueError(f"sensor '{s.name}': unknown tendon "
                                 f"'{s.objname}'")
        elif s.type in ("actuatorpos", "actuatorvel", "actuatorfrc"):
            objid = name2act.get(s.objname, -1)
            if objid < 0:
                raise ValueError(f"sensor '{s.name}': unknown actuator "
                                 f"'{s.objname}'")
        elif s.type.startswith("frame"):
            if s.objtype not in _FRAME_OBJ:
                raise ValueError(f"sensor '{s.name}': objtype "
                                 f"'{s.objtype}' not supported")
            ot, table = _FRAME_OBJ[s.objtype]
            objtype = int(ot)
            objid = table.get(s.objname, -1)
            if objid < 0:
                raise ValueError(f"sensor '{s.name}': unknown {s.objtype} "
                                 f"'{s.objname}'")
            if getattr(s, "refname", ""):
                if s.reftype not in _FRAME_OBJ:
                    raise ValueError(f"sensor '{s.name}': reftype "
                                     f"'{s.reftype}' not supported")
                rot, rtable = _FRAME_OBJ[s.reftype]
                reftype = int(rot)
                refid = rtable.get(s.refname, -1)
                if refid < 0:
                    raise ValueError(f"sensor '{s.name}': unknown "
                                     f"{s.reftype} '{s.refname}'")
        elif s.type.startswith("subtree"):
            objid = name2body_l.get(s.objname, -1)
            if objid < 0:
                raise ValueError(f"sensor '{s.name}': unknown body "
                                 f"'{s.objname}'")
        else:                   # clock
            objid = -1
        dim = _SDIM[s.type]
        sens.append((int(st), objid, objtype, sadr, dim, s.cutoff, s.name,
                     reftype, refid))
        sadr += dim
    nsensor = len(sens)
    nsensordata = sadr

    # ---- actuators: shortcut-normalized general form (mjcf.py), joint
    # transmissions: joint (STATIC moment: gear[0] on the joint's dof, one
    # one-hot matmul at runtime) or site (dynamic moment from site
    # jacobians; mj_transmission mjTRN_SITE semantics, oracle-probed —
    # tests/test_actuators.py)
    from mujoco_sim_tpu.models.model import (DynType, GainType, BiasType,
                                             TrnType)
    jname2id = {j.name: k for k, j in enumerate(jnt_specs) if j.name}
    nu = len(spec.actuators)
    act_trntype = np.zeros(nu, dtype=int)
    act_trnid = np.zeros(nu, dtype=int)
    act_refid = np.full(nu, -1, dtype=int)
    act_trnjnt = np.zeros(nu, dtype=int)
    act_qposadr = np.zeros(nu, dtype=int)
    act_dofadr = np.zeros(nu, dtype=int)
    act_dyntype = np.zeros(nu, dtype=int)
    act_gaintype = np.zeros(nu, dtype=int)
    act_biastype = np.zeros(nu, dtype=int)
    act_ctrllimited = np.zeros(nu, dtype=bool)
    act_forcelimited = np.zeros(nu, dtype=bool)
    act_actlimited = np.zeros(nu, dtype=bool)
    act_actrange = np.zeros((nu, 2))
    act_gear = np.zeros((nu, 6))
    act_gainprm = np.zeros((nu, 10))
    act_biasprm = np.zeros((nu, 10))
    act_dynprm = np.zeros((nu, 10))
    act_ctrlrange = np.zeros((nu, 2))
    act_forcerange = np.zeros((nu, 2))
    act_lengthrange = np.zeros((nu, 2))
    _dyn_map = {"none": DynType.NONE, "integrator": DynType.INTEGRATOR,
                "filter": DynType.FILTER, "filterexact": DynType.FILTEREXACT,
                "muscle": DynType.MUSCLE}
    tname2id = {t.name: i for i, t in enumerate(spec.tendons) if t.name}
    for k, a in enumerate(spec.actuators):
        if a.tendon:
            tid = tname2id.get(a.tendon, -1)
            if tid < 0:
                raise ValueError(
                    f"actuator '{a.name}' targets unknown tendon "
                    f"'{a.tendon}'")
            act_trntype[k] = int(TrnType.TENDON)
            act_trnid[k] = tid
        elif a.site:
            sid = name2site.get(a.site, -1)
            if sid < 0:
                raise ValueError(
                    f"actuator '{a.name}' targets unknown site '{a.site}'")
            rid = -1
            if a.refsite:
                rid = name2site.get(a.refsite, -1)
                if rid < 0:
                    raise ValueError(f"actuator '{a.name}': unknown refsite "
                                     f"'{a.refsite}'")
            act_trntype[k] = int(TrnType.SITE)
            act_trnid[k] = sid
            act_refid[k] = rid
        else:
            jid = jname2id.get(a.joint, -1)
            if jid < 0:
                raise ValueError(
                    f"actuator '{a.name}' targets unknown joint '{a.joint}'")
            jt = JointType(jnt_type[jid])
            if jt not in (JointType.HINGE, JointType.SLIDE):
                # free/ball: the moment IS the (dof-count) gear vector,
                # constant in the joint's dof coordinates (probed:
                # actuator_moment equals gear at any orientation);
                # length reads 0
                if a.dyntype == "muscle" or a.gaintype == "muscle":
                    raise ValueError(
                        f"muscle actuator '{a.name}' cannot drive a "
                        f"{jt.name.lower()} joint")
            act_trntype[k] = int(TrnType.JOINT)
            act_trnid[k] = jid
            act_trnjnt[k] = jid
            act_qposadr[k] = jnt_qposadr[jid]
            act_dofadr[k] = jnt_dofadr[jid]
        act_dyntype[k] = int(_dyn_map[a.dyntype])
        _gain_map = {"fixed": GainType.FIXED, "affine": GainType.AFFINE,
                     "muscle": GainType.MUSCLE}
        _bias_map = {"none": BiasType.NONE, "affine": BiasType.AFFINE,
                     "muscle": BiasType.MUSCLE}
        act_gaintype[k] = int(_gain_map[a.gaintype])
        act_biastype[k] = int(_bias_map[a.biastype])
        act_ctrllimited[k] = a.ctrllimited
        act_forcelimited[k] = a.forcelimited
        act_actlimited[k] = a.actlimited
        act_actrange[k] = a.actrange
        act_gear[k] = a.gear
        act_gainprm[k] = a.gainprm[:10]
        act_biasprm[k] = a.biasprm[:10]
        act_dynprm[k] = a.dynprm[:10]
        act_ctrlrange[k] = a.ctrlrange
        act_forcerange[k] = a.forcerange
        # muscle lengthrange: explicit attr, else exact analytic range of
        # the (linear) joint/tendon transmission over the joint limits
        # (MuJoCo's mj_setLengthRange copies limits for these modes)
        is_muscle = "muscle" in (a.gaintype, a.biastype, a.dyntype)
        if a.lengthrange is not None:
            act_lengthrange[k] = np.sort(a.lengthrange)
        elif is_muscle:
            if act_trntype[k] == int(TrnType.JOINT):
                jid = act_trnid[k]
                if not jnt_limited[jid]:
                    raise ValueError(
                        f"muscle actuator '{a.name}': joint must have "
                        "limits (or give an explicit lengthrange)")
                g0 = a.gear[0]
                act_lengthrange[k] = np.sort(
                    np.asarray(jnt_range[jid]) * g0)
            elif act_trntype[k] == int(TrnType.TENDON):
                if spec.tendons[act_trnid[k]].sites:
                    raise ValueError(
                        f"muscle actuator '{a.name}': spatial-tendon "
                        "muscles need an explicit lengthrange")
                lo = hi = 0.0
                for jn, coef in spec.tendons[act_trnid[k]].joints:
                    jid2 = jname2id[jn]
                    if not jnt_limited[jid2]:
                        raise ValueError(
                            f"muscle actuator '{a.name}': all tendon "
                            "joints must have limits")
                    vals = coef * np.asarray(jnt_range[jid2])
                    lo += vals.min()
                    hi += vals.max()
                g0 = a.gear[0]
                act_lengthrange[k] = np.sort(np.array([lo, hi]) * g0)
            else:
                raise ValueError(
                    f"muscle actuator '{a.name}': site transmissions need "
                    "an explicit lengthrange")
    act_moment01 = np.zeros((nu, nv))
    # gear scale folded into the force->qfrc map: scalar joints use a
    # one-hot row scaled by gear[0] at runtime; free/ball joints fold the
    # full gear vector here and scale by 1 (act_gear0_eff)
    act_gear0_eff = np.ones(nu)
    act_len_valid = np.zeros(nu)
    _NDOF = {int(JointType.FREE): 6, int(JointType.BALL): 3}
    for k in np.nonzero(act_trntype == int(TrnType.JOINT))[0]:
        jid = act_trnjnt[k]
        jt = int(jnt_type[jid])
        if jt in _NDOF:
            n = _NDOF[jt]
            act_moment01[k, act_dofadr[k]:act_dofadr[k] + n] = \
                spec.actuators[k].gear[:n]
        else:
            act_moment01[k, act_dofadr[k]] = 1.0
            act_gear0_eff[k] = spec.actuators[k].gear[0]
            act_len_valid[k] = 1.0

    # ---- qpos0 / qpos_spring
    qpos0 = np.zeros(nq)
    qpos_spring = np.zeros(nq)
    # accumulate world pose at reference for free joints
    world_pos0 = np.zeros((nbody, 3))
    world_quat0 = np.tile(np.array([1.0, 0, 0, 0]), (nbody, 1))
    for i in range(1, nbody):
        p = body_parentid[i]
        world_pos0[i] = world_pos0[p] + R.rot_vec_np(body_pos[i], world_quat0[p])
        world_quat0[i] = R.quat_mul_np(world_quat0[p], body_quat[i])
    for k, j in enumerate(jnt_specs):
        t = JointType(jnt_type[k])
        a = jnt_qposadr[k]
        if t == JointType.FREE:
            bid = jnt_bodyid[k]
            qpos0[a:a + 3] = world_pos0[bid]
            qpos0[a + 3:a + 7] = world_quat0[bid]
            qpos_spring[a:a + 7] = qpos0[a:a + 7]
        elif t == JointType.BALL:
            qpos0[a:a + 4] = [1, 0, 0, 0]
            qpos_spring[a:a + 4] = [1, 0, 0, 0]
        else:
            qpos0[a] = j.ref
            qpos_spring[a] = j.springref

    # ---- pair parameter mixing (mj_collideGeoms combination rules)
    pair_condim, pair_friction = [], []
    pair_solref, pair_solimp = [], []
    pair_margin, pair_gap = [], []
    for a, b in zip(pair_g1, pair_g2):
        ga, gb = geom_specs[a], geom_specs[b]
        if ga.priority != gb.priority:
            hi = ga if ga.priority > gb.priority else gb
            condim = hi.condim
            fr3 = hi.friction
            solref = hi.solref
            solimp = hi.solimp
        else:
            condim = max(ga.condim, gb.condim)
            fr3 = np.maximum(ga.friction, gb.friction)
            smix = ga.solmix + gb.solmix
            w1 = ga.solmix / smix if smix > 1e-12 else 0.5
            w2 = 1.0 - w1
            if ga.solref[0] > 0 and gb.solref[0] > 0:
                solref = w1 * ga.solref + w2 * gb.solref
            else:
                solref = np.minimum(ga.solref, gb.solref)
            solimp = w1 * ga.solimp + w2 * gb.solimp
        pair_condim.append(condim)
        pair_friction.append(np.array(
            [fr3[0], fr3[0], fr3[1], fr3[2], fr3[2]]))
        pair_solref.append(solref)
        pair_solimp.append(solimp)
        pair_margin.append(max(ga.margin, gb.margin))
        pair_gap.append(max(ga.gap, gb.gap))

    # ---- tendons: fixed = static linear form W_q qpos (two tiny constant
    # matmuls at runtime); spatial = static LEG tables — plain site-site
    # segments plus sphere/cylinder wrap legs — evaluated batched by
    # ops/tendon.py (a batched replacement for mj_tendon's per-wrap loop)
    ntendon = len(spec.tendons)
    ten_Wq = np.zeros((ntendon, nq))
    ten_Wv = np.zeros((ntendon, nv))
    plain_legs = []          # (ten, site_a, site_b, 1/divisor)
    wrap_legs = []           # (ten, s_a, s_b, geom, side, is_sphere, 1/div)
    geom_name2id = {g.name: k for k, g in enumerate(geom_specs) if g.name}
    any_spatial = False
    ten_limited = np.zeros(ntendon, dtype=bool)
    ten_range = np.zeros((ntendon, 2))
    ten_solref = np.zeros((ntendon, 2))
    ten_solimp = np.zeros((ntendon, 5))
    ten_stiffness = np.zeros(ntendon)
    ten_damping = np.zeros(ntendon)
    ten_springlength = np.zeros((ntendon, 2))
    ten_margin = np.zeros(ntendon)
    for ti, t in enumerate(spec.tendons):
        for jn, coef in t.joints:
            jid = jname2id.get(jn, -1)
            if jid < 0:
                raise ValueError(f"tendon '{t.name}': unknown joint '{jn}'")
            if JointType(jnt_type[jid]) not in (JointType.HINGE,
                                                JointType.SLIDE):
                raise ValueError(f"tendon '{t.name}': fixed tendons need "
                                 "scalar (hinge/slide) joints")
            ten_Wq[ti, jnt_qposadr[jid]] += coef
            ten_Wv[ti, jnt_dofadr[jid]] += coef
        if t.path:
            any_spatial = True
            div = 1.0
            prev_site = None     # last site of the current branch
            pend_wrap = None     # (geom, side) between prev_site and next
            for el in t.path:
                if el[0] == "pulley":
                    if pend_wrap is not None:
                        raise ValueError(f"tendon '{t.name}': pulley "
                                         "cannot follow a wrap geom")
                    div = float(el[1])
                    if div <= 0:
                        raise ValueError(f"tendon '{t.name}': pulley "
                                         "divisor must be positive")
                    prev_site = None          # pulley starts a new branch
                elif el[0] == "site":
                    sid = name2site.get(el[1], -1)
                    if sid < 0:
                        raise ValueError(f"tendon '{t.name}': unknown "
                                         f"site '{el[1]}'")
                    if pend_wrap is not None:
                        gid, side = pend_wrap
                        is_sph = GeomType(geom_type[gid]) == GeomType.SPHERE
                        wrap_legs.append((ti, prev_site, sid, gid, side,
                                          is_sph, 1.0 / div))
                        pend_wrap = None
                    elif prev_site is not None:
                        plain_legs.append((ti, prev_site, sid, 1.0 / div))
                    prev_site = sid
                else:                         # wrap geom
                    gid = geom_name2id.get(el[1], -1)
                    if gid < 0:
                        raise ValueError(f"tendon '{t.name}': unknown "
                                         f"wrap geom '{el[1]}'")
                    if GeomType(geom_type[gid]) not in (GeomType.SPHERE,
                                                        GeomType.CYLINDER):
                        raise ValueError(
                            f"tendon '{t.name}': wrap geom '{el[1]}' must "
                            "be a sphere or cylinder")
                    if prev_site is None:
                        raise ValueError(f"tendon '{t.name}': wrap geom "
                                         "must follow a site")
                    if pend_wrap is not None:
                        raise ValueError(f"tendon '{t.name}': consecutive "
                                         "wrap geoms need a site between")
                    side = -1
                    if el[2]:
                        side = name2site.get(el[2], -1)
                        if side < 0:
                            raise ValueError(f"tendon '{t.name}': unknown "
                                             f"sidesite '{el[2]}'")
                    pend_wrap = (gid, side)
            if pend_wrap is not None:
                raise ValueError(f"tendon '{t.name}': wrap geom at the "
                                 "end of the path")
        ten_limited[ti] = t.limited
        ten_range[ti] = t.range
        ten_solref[ti] = t.solref_limit
        ten_solimp[ti] = t.solimp_limit
        ten_stiffness[ti] = t.stiffness
        ten_damping[ti] = t.damping
        ten_margin[ti] = t.margin
        if t.springlength is None:
            if t.path:
                # spatial length0 needs the full wrap path: NaN marker,
                # filled from the qpos0 evaluation in engine.set_const
                ten_springlength[ti] = [np.nan, np.nan]
            else:
                length0 = float(ten_Wq[ti] @ qpos0)
                ten_springlength[ti] = [length0, length0]
        else:
            ten_springlength[ti] = t.springlength
    ten_leg_ten = np.asarray([l[0] for l in plain_legs], dtype=int)
    ten_leg_sites = (np.asarray([l[1:3] for l in plain_legs], dtype=int)
                     if plain_legs else np.zeros((0, 2), dtype=int))
    ten_leg_w = np.asarray([l[3] for l in plain_legs], dtype=float)
    ten_wleg_ten = np.asarray([l[0] for l in wrap_legs], dtype=int)
    ten_wleg_sites = (np.asarray([l[1:3] for l in wrap_legs], dtype=int)
                      if wrap_legs else np.zeros((0, 2), dtype=int))
    ten_wleg_geom = np.asarray([l[3] for l in wrap_legs], dtype=int)
    ten_wleg_side = np.asarray([l[4] for l in wrap_legs], dtype=int)
    ten_wleg_sphere = np.asarray([l[5] for l in wrap_legs], dtype=bool)
    ten_wleg_w = np.asarray([l[6] for l in wrap_legs], dtype=float)

    # ---- static efc row layout + contact candidate tables
    # row order matches MuJoCo: equality, dof friction, limits, contacts
    eq_efcadr, adr_cursor = [], 0
    for r in eq_rows:
        eq_efcadr.append(adr_cursor)
        adr_cursor += {int(EqType.CONNECT): 3, int(EqType.WELD): 6,
                       int(EqType.JOINT): 1, int(EqType.TENDON): 1}[r[0]]
    fri_dofid = np.nonzero(dof_frictionloss > 0)[0]
    fri_efcadr = adr_cursor + np.arange(len(fri_dofid))
    adr_cursor += len(fri_dofid)
    lim_jntid = (np.nonzero(np.asarray(jnt_limited))[0]
                 if njnt else np.zeros(0, dtype=int))
    lim_efcadr = adr_cursor + np.arange(len(lim_jntid))
    adr_cursor += len(lim_jntid)
    tlim_tenid = np.nonzero(ten_limited)[0]
    tlim_efcadr = adr_cursor + np.arange(len(tlim_tenid))
    adr_cursor += len(tlim_tenid)

    # contact candidates: all pairs narrowphased every step (vectorized per
    # type group), then top-K compacted into ncon_budget contact slots so efc
    # shapes stay static regardless of scene size (static-shape replacement
    # for runtime broadphase; SURVEY §7 'static shapes everywhere')
    pair_keys = [pair_key(GeomType(geom_type[a]), GeomType(geom_type[b]))[0]
                 for a, b in zip(pair_g1, pair_g2)]
    groups, ncand = build_groups(pair_keys)
    cand_pairid = np.zeros(ncand, dtype=int)
    for g in groups:
        for sslot in range(g.top_p):
            pid = g.pair_idx[min(sslot, len(g.pair_idx) - 1)]
            a0 = g.cand_adr + sslot * g.cap
            cand_pairid[a0:a0 + g.cap] = pid
    if ncon_budget is None:
        # <size nconmax> (parsed in mjcf.py) bounds the contact-slot
        # budget like mujoco's legacy nconmax: large-batch scenes are
        # bandwidth-bound on the dense (nenv, nefc, nv) efc rows, and a
        # scene-appropriate capacity halves that traffic (r4, config-5).
        # nconmax can only LOWER the budget: legacy MJCF commonly sets a
        # huge nconmax purely to size mujoco's arena, and honoring it
        # upward would inflate the efc rows (callers wanting more slots
        # pass ncon_budget explicitly)
        sz = getattr(spec, "nconmax", -1)
        default = min(ncand, 64)
        ncon_budget = min(sz, default) if sz and sz > 0 else default
    ncon_max = min(ncon_budget, ncand)
    from mujoco_sim_tpu.models.model import contact_rows_per, ConeType as _CT
    max_condim = int(max(pair_condim)) if pair_condim else 1
    cone_i = int(_CT.PYRAMIDAL if spec.option.cone == "pyramidal"
                 else _CT.ELLIPTIC)
    rows_per_con = contact_rows_per(max_condim, cone_i)
    contact_efcadr = adr_cursor
    adr_cursor += ncon_max * rows_per_con
    nefc_max = adr_cursor

    # resolve equality reference data needing the qpos0 world poses:
    # connect anchor2 and weld default relpose (MuJoCo compiler behavior)
    for idx, (et, o1, o2, act, data, sr, si, nm) in enumerate(eq_rows):
        if et == int(EqType.CONNECT):
            p_world = world_pos0[o1] + R.rot_vec_np(data[0:3], world_quat0[o1])
            q2inv = np.array([1.0, -1, -1, -1]) * world_quat0[o2]
            data[3:6] = R.rot_vec_np(p_world - world_pos0[o2], q2inv)
        elif et == int(EqType.WELD):
            if np.linalg.norm(data[6:10]) < 1e-12:
                # relpose = inv(T1_0) o T2_0
                q1inv = np.array([1.0, -1, -1, -1]) * world_quat0[o1]
                data[3:6] = R.rot_vec_np(world_pos0[o2] - world_pos0[o1], q1inv)
                data[6:10] = R.quat_mul_np(q1inv, world_quat0[o2])
        eq_rows[idx] = (et, o1, o2, act, data, sr, si, nm)

    # ---- option
    ospec = spec.option
    opt = Option(
        timestep=np_f(ospec.timestep),
        gravity=np_f(ospec.gravity),
        wind=np_f(ospec.wind),
        magnetic=np_f(ospec.magnetic),
        density=np_f(ospec.density),
        viscosity=np_f(ospec.viscosity),
        impratio=np_f(ospec.impratio),
        o_margin=np_f(ospec.o_margin),
        o_solref=np_f(ospec.o_solref),
        o_solimp=np_f(ospec.o_solimp),
        integrator=int(_INTEGRATOR[ospec.integrator]),
        cone=int(ConeType.PYRAMIDAL if ospec.cone == "pyramidal"
                 else ConeType.ELLIPTIC),
        solver_iterations=ospec.iterations,
        ls_iterations=ospec.ls_iterations,
        ls_tolerance=ospec.ls_tolerance,
        tolerance=ospec.tolerance,
        noslip_iterations=ospec.noslip_iterations,
        noslip_tolerance=ospec.noslip_tolerance,
        disableflags=ospec.disableflags,
        has_fluid=int(ospec.density > 0 or ospec.viscosity > 0
                      or np.any(np.asarray(ospec.wind) != 0)),
        override_contacts=int(ospec.override_contacts),
    )

    layout = Layout(
        body_parentid=body_parentid,
        body_rootid=body_rootid,
        body_weldid=body_weldid,
        body_jntadr=body_jntadr,
        body_jntnum=body_jntnum,
        body_dofadr=body_dofadr,
        body_dofnum=body_dofnum,
        body_mocapid=body_mocapid,
        jnt_type=jnt_type,
        jnt_qposadr=jnt_qposadr,
        jnt_dofadr=jnt_dofadr,
        jnt_bodyid=np.asarray(jnt_bodyid, dtype=int),
        dof_bodyid=dof_bodyid,
        dof_jntid=dof_jntid,
        dof_parentid=dof_parentid,
        geom_bodyid=np.asarray(geom_bodyid, dtype=int),
        geom_type=geom_type,
        geom_dataid=geom_dataid,
        geom_hullid=geom_hullid,
        geom_hfieldid=geom_hfieldid,
        hull_aabb=hull_aabb,
        geom_invisible=np.asarray(
            [g.rgba[3] <= 0.0 for g in geom_specs], dtype=bool),
        hf_nrow=hf_nrow,
        hf_ncol=hf_ncol,
        site_bodyid=np.asarray(site_bodyid, dtype=int),
        site_type=np.asarray(
            [int(GeomType[s.type.upper()]) for s in site_specs], dtype=int),
        site_size=(np.stack([s.size for s in site_specs])
                   if site_specs else np.zeros((0, 3))),
        mesh_vertadr=np.asarray(mesh_vertadr, dtype=int),
        mesh_vertnum=np.asarray(mesh_vertnum, dtype=int),
        # visual-fidelity raw surfaces + appearance (host-side tables)
        mesh_visvert=mesh_visvert,
        mesh_visvertadr=np.asarray(vis_vertadr, dtype=int),
        mesh_visvertnum=np.asarray(vis_vertnum, dtype=int),
        mesh_visface=mesh_visface,
        mesh_visfaceadr=np.asarray(vis_faceadr, dtype=int),
        mesh_visfacenum=np.asarray(vis_facenum, dtype=int),
        geom_matid=np.asarray([mat_idx.get(g.material, -1)
                               for g in geom_specs], dtype=int),
        mat_rgba=mat_rgba,
        mat_texid=mat_texid,
        mat_texrepeat=mat_texrepeat,
        mat_scalar=mat_scalar,     # [emission, specular, shininess, refl]
        tex_rgb12=tex_rgb12,
        tex_builtin=tex_builtin,
        eq_type=np.asarray([r[0] for r in eq_rows], dtype=int),
        eq_obj1id=np.asarray([r[1] for r in eq_rows], dtype=int),
        eq_obj2id=np.asarray([r[2] for r in eq_rows], dtype=int),
        pair_geom1=np.asarray(pair_g1, dtype=int),
        pair_geom2=np.asarray(pair_g2, dtype=int),
        pair_condim=np.asarray(pair_condim, dtype=int),
        eq_efcadr=np.asarray(eq_efcadr, dtype=int),
        fri_dofid=np.asarray(fri_dofid, dtype=int),
        fri_efcadr=np.asarray(fri_efcadr, dtype=int),
        lim_jntid=np.asarray(lim_jntid, dtype=int),
        lim_efcadr=np.asarray(lim_efcadr, dtype=int),
        tlim_tenid=np.asarray(tlim_tenid, dtype=int),
        tlim_efcadr=np.asarray(tlim_efcadr, dtype=int),
        ten_Wq=ten_Wq,
        ten_Wv=ten_Wv,
        ten_limited=ten_limited,
        ten_any_spatial=any_spatial,
        ten_leg_ten=ten_leg_ten,
        ten_leg_sites=ten_leg_sites,
        ten_leg_w=ten_leg_w,
        ten_wleg_ten=ten_wleg_ten,
        ten_wleg_sites=ten_wleg_sites,
        ten_wleg_geom=ten_wleg_geom,
        ten_wleg_side=ten_wleg_side,
        ten_wleg_sphere=ten_wleg_sphere,
        ten_wleg_w=ten_wleg_w,
        cand_pairid=np.asarray(cand_pairid, dtype=int),
        jnt_limited=np.asarray(jnt_limited, dtype=bool),
        sensor_type=np.asarray([s[0] for s in sens], dtype=int),
        sensor_objid=np.asarray([s[1] for s in sens], dtype=int),
        sensor_objtype=np.asarray([s[2] for s in sens], dtype=int),
        sensor_adr=np.asarray([s[3] for s in sens], dtype=int),
        sensor_dim=np.asarray([s[4] for s in sens], dtype=int),
        sensor_cutoff=np.asarray([s[5] for s in sens], dtype=float),
        sensor_reftype=np.asarray([s[7] for s in sens], dtype=int),
        sensor_refid=np.asarray([s[8] for s in sens], dtype=int),
        act_trnjnt=act_trnjnt,
        act_trntype=act_trntype,
        act_trnid=act_trnid,
        act_refid=act_refid,
        act_qposadr=act_qposadr,
        act_dofadr=act_dofadr,
        act_dyntype=act_dyntype,
        act_gaintype=act_gaintype,
        act_biastype=act_biastype,
        act_ctrllimited=act_ctrllimited,
        act_forcelimited=act_forcelimited,
        act_actlimited=act_actlimited,
        act_moment01=act_moment01,
        act_gear0_eff=act_gear0_eff,
        act_len_valid=act_len_valid,
    )

    # ---- keyframes: defaults follow mj_resetDataKeyframe (qpos0 / zeros /
    # initial mocap pose); explicit values are length-checked
    nkey = len(spec.keys)
    key_time = np.zeros(nkey)
    key_qpos = np.tile(qpos0, (nkey, 1)) if nkey else np.zeros((0, nq))
    key_qvel = np.zeros((nkey, nv))
    key_act = np.zeros((nkey, nu))
    key_ctrl = np.zeros((nkey, nu))
    mocap_body_ids = np.nonzero(body_mocapid >= 0)[0]
    mpos0 = np.array([world_pos0[b] for b in mocap_body_ids]).reshape(-1, 3)
    mquat0 = np.array([world_quat0[b]
                       for b in mocap_body_ids]).reshape(-1, 4)
    key_mpos = np.tile(mpos0, (nkey, 1, 1)) if nkey else np.zeros(
        (0, nmocap, 3))
    key_mquat = np.tile(mquat0, (nkey, 1, 1)) if nkey else np.zeros(
        (0, nmocap, 4))
    for ki, kf in enumerate(spec.keys):
        key_time[ki] = kf.time
        for attr, arr, dim in (("qpos", key_qpos, nq),
                               ("qvel", key_qvel, nv),
                               ("act", key_act, nu),
                               ("ctrl", key_ctrl, nu)):
            v = getattr(kf, attr)
            if v is not None:
                if len(v) != dim:
                    raise ValueError(
                        f"key '{kf.name}': {attr} has {len(v)} values, "
                        f"expected {dim}")
                arr[ki] = v
        for attr, arr, dim in (("mpos", key_mpos, 3),
                               ("mquat", key_mquat, 4)):
            v = getattr(kf, attr)
            if v is not None:
                if len(v) != nmocap * dim:
                    raise ValueError(
                        f"key '{kf.name}': {attr} has {len(v)} values, "
                        f"expected {nmocap * dim}")
                arr[ki] = v.reshape(nmocap, dim)

    names = NameTable(
        key=[k.name or f"key{i}" for i, k in enumerate(spec.keys)],
        body=body_name,
        joint=[j.name or f"joint{k}" for k, j in enumerate(jnt_specs)],
        geom=[g.name or f"geom{k}" for k, g in enumerate(geom_specs)],
        site=[s.name or f"site{k}" for k, s in enumerate(site_specs)],
        mesh=mesh_names,
        sensor=[s[6] or f"sensor{k}" for k, s in enumerate(sens)],
        eq=[r[7] or f"eq{k}" for k, r in enumerate(eq_rows)],
        actuator=[a.name or f"actuator{k}"
                  for k, a in enumerate(spec.actuators)],
        tendon=[t.name or f"tendon{k}"
                for k, t in enumerate(spec.tendons)],
    )

    model = Model(
        opt=opt,
        body_parentid=np_i(body_parentid),
        body_rootid=np_i(body_rootid),
        body_weldid=np_i(body_weldid),
        body_jntadr=np_i(body_jntadr),
        body_jntnum=np_i(body_jntnum),
        body_dofadr=np_i(body_dofadr),
        body_dofnum=np_i(body_dofnum),
        body_pos=np_f(body_pos),
        body_quat=np_f(body_quat),
        body_ipos=np_f(body_ipos),
        body_iquat=np_f(body_iquat),
        body_mass=np_f(body_mass),
        body_inertia=np_f(body_inertia),
        body_gravcomp=np_f(body_gravcomp),
        body_invweight0=np_f(np.zeros((nbody, 2))),
        body_subtreemass=np_f(body_subtreemass),
        body_mocapid=np_i(body_mocapid),
        jnt_type=np_i(jnt_type),
        jnt_qposadr=np_i(jnt_qposadr),
        jnt_dofadr=np_i(jnt_dofadr),
        jnt_bodyid=np_i(jnt_bodyid),
        jnt_pos=np_f(jnt_pos),
        jnt_axis=np_f(jnt_axis),
        jnt_range=np_f(jnt_range),
        jnt_limited=np.asarray(jnt_limited, dtype=bool),
        jnt_stiffness=np_f(jnt_stiffness),
        jnt_springref=np_f(jnt_springref),
        jnt_ref=np_f(jnt_ref),
        jnt_margin=np_f(jnt_margin),
        jnt_solref=np_f(jnt_solref),
        jnt_solimp=np_f(jnt_solimp),
        dof_bodyid=np_i(dof_bodyid),
        dof_jntid=np_i(dof_jntid),
        dof_parentid=np_i(dof_parentid),
        dof_armature=np_f(dof_armature),
        dof_damping=np_f(dof_damping),
        dof_frictionloss=np_f(dof_frictionloss),
        dof_invweight0=np_f(np.zeros(nv)),
        geom_type=np_i(geom_type),
        geom_bodyid=np_i(geom_bodyid),
        geom_dataid=np_i(geom_dataid),
        geom_pos=np_f(geom_pos),
        geom_quat=np_f(geom_quat),
        geom_size=np_f(geom_size),
        geom_rbound=np_f(geom_rbound),
        geom_friction=np_f(np.stack([g.friction for g in geom_specs])
                           if ngeom else np.zeros((0, 3))),
        geom_contype=np_i([g.contype for g in geom_specs]),
        geom_conaffinity=np_i([g.conaffinity for g in geom_specs]),
        geom_condim=np_i([g.condim for g in geom_specs]),
        geom_priority=np_i([g.priority for g in geom_specs]),
        geom_solmix=np_f([g.solmix for g in geom_specs]),
        geom_solref=np_f(np.stack([g.solref for g in geom_specs])
                         if ngeom else np.zeros((0, 2))),
        geom_solimp=np_f(np.stack([g.solimp for g in geom_specs])
                         if ngeom else np.zeros((0, 5))),
        geom_margin=np_f([g.margin for g in geom_specs]),
        geom_gap=np_f([g.gap for g in geom_specs]),
        geom_rgba=np_f(np.stack([g.rgba for g in geom_specs])
                       if ngeom else np.zeros((0, 4))),
        site_bodyid=np_i(site_bodyid),
        site_pos=np_f(np.stack([s.pos for s in site_specs])
                      if nsite else np.zeros((0, 3))),
        site_quat=np_f(np.stack([s.quat for s in site_specs])
                       if nsite else np.zeros((0, 4))),
        mesh_vert=np_f(mesh_vert),
        mesh_vert_pad=np_f(mesh_vert_pad),
        hfield_data=np_f(hfield_data),
        hfield_size=np_f(hfield_size),
        mesh_vert_mask=np_f(mesh_vert_mask),
        mesh_face_pad=np_f(mesh_face_pad),
        mesh_fplane=np_f(mesh_fplane),
        mesh_fmask=np_f(mesh_fmask),
        mesh_fpoly=np_f(mesh_fpoly),
        mesh_cyl=np_f(mesh_cyl),
        mesh_vert_hi=np_f(mesh_vert_hi),
        mesh_vert_hi_mask=np_f(mesh_vert_hi_mask),
        mesh_hedge=np_f(mesh_hedge),
        mesh_hedge_mask=np_f(mesh_hedge_mask),
        mesh_vertadr=np_i(mesh_vertadr),
        mesh_vertnum=np_i(mesh_vertnum),
        eq_type=np_i([r[0] for r in eq_rows]),
        eq_obj1id=np_i([r[1] for r in eq_rows]),
        eq_obj2id=np_i([r[2] for r in eq_rows]),
        eq_active0=np.asarray([r[3] for r in eq_rows], dtype=bool),
        eq_data=np_f(np.stack([r[4] for r in eq_rows])
                     if neq else np.zeros((0, 11))),
        eq_solref=np_f(np.stack([r[5] for r in eq_rows])
                       if neq else np.zeros((0, 2))),
        eq_solimp=np_f(np.stack([r[6] for r in eq_rows])
                       if neq else np.zeros((0, 5))),
        pair_geom1=np_i(pair_g1),
        pair_geom2=np_i(pair_g2),
        pair_friction=np_f(np.stack(pair_friction)
                           if npair else np.zeros((0, 5))),
        pair_solref=np_f(np.stack(pair_solref)
                         if npair else np.zeros((0, 2))),
        pair_solimp=np_f(np.stack(pair_solimp)
                         if npair else np.zeros((0, 5))),
        pair_margin=np_f(pair_margin),
        pair_gap=np_f(pair_gap),
        sensor_type=np_i([s[0] for s in sens]),
        sensor_objid=np_i([s[1] for s in sens]),
        sensor_adr=np_i([s[3] for s in sens]),
        sensor_cutoff=np_f([s[5] for s in sens]),
        qpos0=np_f(qpos0),
        qpos_spring=np_f(qpos_spring),
        key_time=np_f(key_time),
        key_qpos=np_f(key_qpos),
        key_qvel=np_f(key_qvel),
        key_act=np_f(key_act),
        key_ctrl=np_f(key_ctrl),
        key_mpos=np_f(key_mpos),
        key_mquat=np_f(key_mquat),
        nq=nq, nv=nv, nbody=nbody, njnt=njnt, ngeom=ngeom, nsite=nsite,
        nmesh=len(mesh_names), neq=neq, npair=npair, nsensor=nsensor,
        nu=nu,
        actuator_gear=np_f(act_gear),
        actuator_gainprm=np_f(act_gainprm),
        actuator_biasprm=np_f(act_biasprm),
        actuator_dynprm=np_f(act_dynprm),
        actuator_ctrlrange=np_f(act_ctrlrange),
        actuator_forcerange=np_f(act_forcerange),
        actuator_lengthrange=np_f(act_lengthrange),
        actuator_acc0=np_f(np.zeros(nu)),
        actuator_actrange=np_f(act_actrange),
        ten_range=np_f(ten_range),
        ten_solref=np_f(ten_solref),
        ten_solimp=np_f(ten_solimp),
        ten_stiffness=np_f(ten_stiffness),
        ten_damping=np_f(ten_damping),
        ten_springlength=np_f(ten_springlength),
        ten_length0=np_f(np.full(ntendon, np.nan)),
        ten_margin=np_f(ten_margin),
        ten_invweight0=np_f(np.zeros(ntendon)),
        ntendon=ntendon,
        nsensordata=nsensordata, nmocap=nmocap, nkey=nkey,
        ncon_max=ncon_max, nefc_max=nefc_max,
        ncand=ncand, max_condim=max_condim, contact_efcadr=contact_efcadr,
        npair_unsupported=npair_unsupported,
        body_levels=body_levels,
        max_jnt_per_body=int(body_jntnum.max()) if nbody else 0,
        ancestor_mask=np_f(ancestor_mask),
        dof_jnt_slot=np_i(np.zeros(nv)),
        layout=layout,
        names=names,
    )
    return model


def load_model(path: str) -> Model:
    """MJCF file -> compiled Model (the mj_loadXML equivalent)."""
    from mujoco_sim_tpu.engine import set_const

    return set_const(compile_spec(mjcf.parse_mjcf(path)))
