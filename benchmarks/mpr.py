"""Batched Minkowski Portal Refinement for convex vertex clouds.

The reference's physics backend (MuJoCo 2.3.7) resolves deeply
penetrating convex pairs with libccd's MPR (mjc_Convex ->
ccdMPRPenetration); MuJoCo 3.x replaced it with native GJK/EPA whose
results MPR closely tracks for the shallow-to-moderate depths robots
operate at.  This is a fixed-iteration, mask-converged JAX port of the
penetration query:

  mpr_penetration(vertsA, maskA, vertsB, maskB) ->
      (depth >= 0 or -1 on miss, dir (unit, oriented A -> B like
      mjContact.frame[0:3] with A = geom1), pos)

Everything is written for a SINGLE pair in local/world-consistent
coordinates and vmapped by callers; supports are one-hot argmax matmuls
(no data-dependent gathers).  All loops are lax.while_loop
with hard iteration caps so the jitted step keeps static shapes.

Reference behavior: libccd ccdMPRPenetration (portal discovery +
refinement + barycentric position), validated against analytic MTVs and
the mujoco 3.10 oracle in benchmarks/test_mpr.py.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

_EPS = 1e-10
_TOL = 1e-7
_MAX_DISCOVER = 32
_MAX_REFINE = 64


def _support(verts, mask, d):
    """farthest masked vertex of a cloud along d, one-hot form."""
    score = (verts * d[None, :]).sum(-1)
    score = jnp.where(mask > 0.5, score, -1e30)
    oh = jax.nn.one_hot(jnp.argmax(score), verts.shape[0],
                        dtype=verts.dtype)
    return oh @ verts


def _center(verts, mask):
    w = jnp.maximum(mask.sum(), 1.0)
    return (verts * mask[:, None]).sum(0) / w


def mpr_penetration(vertsA, maskA, vertsB, maskB, enabled=None):
    """(depth, dir, pos): depth >= 0 when penetrating (-1.0 when the
    shapes are separated), dir = unit MTV axis oriented from A toward B
    (translate A by -depth*dir to resolve; same orientation as
    mjContact.frame[0:3] with A = geom1), pos = contact point.

    enabled: optional traced bool; when False the query short-circuits to
    a miss with BOTH while_loops starting converged.  Callers vmap over
    candidate pairs and gate on "deep penetration" — when no lane needs
    refinement the loops exit at the first condition check, so the jitted
    step pays ~nothing on shallow-contact scenes (PR2 bench)."""
    dtype = vertsA.dtype

    def sup(d):
        """Minkowski difference support: S_{A-B}(d) = S_A(d) - S_B(-d);
        also returns the midpoint of the witness pair."""
        a = _support(vertsA, maskA, d)
        b = _support(vertsB, maskB, -d)
        return a - b, 0.5 * (a + b)

    # v0: interior point of the difference.  The tiny fixed off-axis
    # nudge breaks exact symmetric/axis-aligned degeneracies (zero cross
    # products misroute the strict > tests; libccd leans on fp noise for
    # the same cases) at an O(1e-6) cost to the reported direction.
    v0 = _center(vertsA, maskA) - _center(vertsB, maskB)
    v0 = v0 + jnp.asarray([1.1e-6, 1.7e-6, 2.3e-6], dtype)
    v0 = jnp.where(jnp.linalg.norm(v0) < _EPS,
                   jnp.asarray([1e-5, 0.0, 0.0], dtype), v0)

    # ---- portal discovery (libccd discoverPortal)
    # v1: support toward the origin
    d1 = -v0
    v1, p1 = sup(d1)
    sep = (v1 * d1).sum() < 0.0
    if enabled is not None:
        sep = sep | ~enabled

    # v2: perpendicular to (v0, v1)
    d2 = jnp.cross(v0, v1)
    deg2 = jnp.linalg.norm(d2) < _EPS     # origin on the v0-v1 line
    d2 = jnp.where(deg2, _any_perp(v0), d2)
    v2, p2 = sup(d2)
    sep |= (v2 * d2).sum() < 0.0

    # initial portal plane; orient away from the origin side of v0
    d3 = jnp.cross(v1 - v0, v2 - v0)
    flip = (d3 * v0).sum() > 0.0
    v1, v2 = (jnp.where(flip, v2, v1), jnp.where(flip, v1, v2))
    p1, p2 = (jnp.where(flip, p2, p1), jnp.where(flip, p1, p2))
    d3 = jnp.where(flip, -d3, d3)

    def disc_cond(st):
        *_, it, done, _sep = st
        return (~done) & (~_sep) & (it < _MAX_DISCOVER)

    def disc_body(st):
        v1, v2, p1, p2, d3, v3, p3, it, _, _sep = st
        v3n, p3n = sup(d3)
        _sep = (v3n * d3).sum() < 0.0
        # origin outside plane (v1, v0, v3) -> replace v2 with v3;
        # outside plane (v3, v0, v2) -> replace v1 with v3
        c_a = (jnp.cross(v1, v3n) * v0).sum() < 0.0
        c_b = (jnp.cross(v3n, v2) * v0).sum() < 0.0
        v2n = jnp.where(c_a, v3n, v2)
        p2n = jnp.where(c_a, p3n, p2)
        v1n = jnp.where(~c_a & c_b, v3n, v1)
        p1n = jnp.where(~c_a & c_b, p3n, p1)
        done = ~c_a & ~c_b
        d3n = jnp.cross(v1n - v0, v2n - v0)
        d3n = jnp.where(done, d3, d3n)
        return (v1n, v2n, p1n, p2n, d3n, v3n, p3n, it + 1, done, _sep)

    st = (v1, v2, p1, p2, d3, v1, p1, jnp.asarray(0),
          jnp.asarray(False), sep)
    v1, v2, p1, p2, d3, v3, p3, _, found, sep = jax.lax.while_loop(
        disc_cond, disc_body, st)

    # ---- refinement: push the portal toward the surface
    def ref_cond(st):
        *_, it, done = st
        return (~done) & (it < _MAX_REFINE)

    def ref_body(st):
        v1, v2, v3, p1, p2, p3, depth, it, _ = st
        n = jnp.cross(v2 - v1, v3 - v1)
        nn = jnp.linalg.norm(n)
        n = n / jnp.maximum(nn, _EPS)
        n = jnp.where((n * (v1 - v0)).sum() < 0.0, -n, n)  # outward
        v4, p4 = sup(n)
        # progress: how much farther the support goes past the portal
        prog = ((v4 - v1) * n).sum()
        done = (prog < _TOL) | (nn < _EPS)
        # which portal vertex to replace: libccd expandPortal's case
        # analysis with v4v0 = v4 x v0
        v4v0 = jnp.cross(v4, v0)
        e1 = (v1 * v4v0).sum() > 0.0
        e2 = (v2 * v4v0).sum() > 0.0
        e3 = (v3 * v4v0).sum() > 0.0
        r1 = e1 & e2
        r3 = e1 & ~e2
        r2 = ~e1 & e3
        r1b = ~e1 & ~e3
        v1n = jnp.where(r1 | r1b, v4, v1)
        p1n = jnp.where(r1 | r1b, p4, p1)
        v2n = jnp.where(r2, v4, v2)
        p2n = jnp.where(r2, p4, p2)
        v3n = jnp.where(r3, v4, v3)
        p3n = jnp.where(r3, p4, p3)
        # current depth estimate: origin distance to the portal plane
        depth_new = jnp.abs((n * v1).sum())
        return (v1n, v2n, v3n, p1n, p2n, p3n, depth_new, it + 1, done)

    # separated / disabled / undiscovered lanes skip refinement entirely
    # (the refine loop used to spin its 64 iterations even for misses)
    st = (v1, v2, v3, p1, p2, p3, jnp.asarray(0.0, dtype),
          jnp.asarray(0), sep | ~found)
    v1, v2, v3, p1, p2, p3, depth, _, _ = jax.lax.while_loop(
        ref_cond, ref_body, st)

    n = jnp.cross(v2 - v1, v3 - v1)
    n = n / jnp.maximum(jnp.linalg.norm(n), _EPS)
    n = jnp.where((n * (v1 - v0)).sum() < 0.0, -n, n)
    depth = jnp.maximum((n * v1).sum(), 0.0)
    # origin inside the final portal (on the v0 side) => penetration
    penetrating = found & ~sep & ((n * v1).sum() >= -_TOL)

    # contact position: barycentric weights of the origin projected on
    # the portal triangle, applied to the witness midpoints (libccd
    # findPenetrPos uses the v0..v3 tetra; the portal triangle converges
    # to the same surface patch)
    b = _barycentric_origin(v1, v2, v3)
    pos = b[0] * p1 + b[1] * p2 + b[2] * p3

    depth = jnp.where(penetrating, depth, -1.0)
    return depth, n, pos


def _any_perp(v):
    a = jnp.where(jnp.abs(v[0]) < 0.5,
                  jnp.asarray([1.0, 0.0, 0.0], v.dtype),
                  jnp.asarray([0.0, 1.0, 0.0], v.dtype))
    p = jnp.cross(v, a)
    return p / jnp.maximum(jnp.linalg.norm(p), _EPS)


def _barycentric_origin(a, b, c):
    """barycentric coords of the origin's projection on triangle abc."""
    ab = b - a
    ac = c - a
    ap = -a
    d00 = (ab * ab).sum()
    d01 = (ab * ac).sum()
    d11 = (ac * ac).sum()
    d20 = (ap * ab).sum()
    d21 = (ap * ac).sum()
    den = jnp.maximum(d00 * d11 - d01 * d01, _EPS)
    v = (d11 * d20 - d01 * d21) / den
    w = (d00 * d21 - d01 * d20) / den
    v = jnp.clip(v, 0.0, 1.0)
    w = jnp.clip(w, 0.0, 1.0 - v)
    return jnp.stack([1.0 - v - w, v, w])
