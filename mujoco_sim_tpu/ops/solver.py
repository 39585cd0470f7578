"""Constraint solver: projected Newton on the primal soft-constraint problem.

Solves  min_a  0.5 (a - a_smooth)' M (a - a_smooth) + sum_i c_i(J_i a - aref_i)

with per-row costs matching MuJoCo's convex formulation:
  equality rows     : 0.5 D x^2                  (two-sided)
  friction-loss rows: Huber(x; R*floss)          (linear tails +- floss)
  limit/contact rows: 0.5 D x^2 for x < 0 else 0 (one-sided, pyramidal)
  elliptic contacts : zone cost on the whole contact block (below)

Elliptic cones (verified pointwise against the oracle's
mj_constraintUpdate, r2): with whitened friction coords
v_i = x_i * sqrt(impratio) * mu_i / mu0, T = |v|, and solver coefficient
mu_v = mu0/sqrt(impratio):
  top zone    N >= mu_v T         : cost 0
  bottom zone T <= -mu_v N        : cost 0.5 D0 (N^2 + T^2)
  middle zone                     : cost 0.5 D0 (mu_v T - N)^2 / (1+mu_v^2)

The optimum is the same as MuJoCo's Newton solver (same convex program), so
single-env trajectories converge to the oracle's; the implementation is
batched dense Cholesky + einsums instead of sparse CPU recursions.
Exact-ish line search via a few 1D Newton steps on the piecewise-quadratic
restriction, like the reference solver's exact search.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from mujoco_sim_tpu.models.model import (Model, Data, DisableBit, ConeType,
                                         contact_rows_per)
from mujoco_sim_tpu.ops import smooth

_PLAN_CACHE: dict = {}


def _cone_plan(m: Model):
    """Static elliptic-contact row layout: (crows (K, rp), noncone mask)."""
    key = (m.layout, "cone", m.opt.cone, m.ncon_max, m.max_condim)
    got = _PLAN_CACHE.get(key)
    if got is None:
        rp = contact_rows_per(m.max_condim, m.opt.cone)
        crows = (m.contact_efcadr
                 + np.arange(m.ncon_max)[:, None] * rp
                 + np.arange(rp)[None, :])
        noncone = np.ones(m.nefc_max, dtype=bool)
        noncone[crows.reshape(-1)] = False
        got = (crows, noncone)
        _PLAN_CACHE[key] = got
    return got


def _row_force_and_curv(m, d, x, D=None):
    """c'(x) and c''(x) per row given jar x (vectorized, masked)."""
    if D is None:
        D = d.efc_D  # zeroed for inactive rows
    floss = d.efc_frictionloss
    is_floss = d.efc_floss_active
    one_sided = (d.efc_type >= 2)
    quad = D * x
    # one-sided: zero cost for x >= 0
    f = jnp.where(one_sided & (x >= 0), 0.0, quad)
    curv = jnp.where(one_sided & (x >= 0), 0.0, D)
    # friction loss: clamp to +-floss (linear tails)
    f = jnp.where(is_floss, jnp.clip(quad, -floss, floss), f)
    curv = jnp.where(is_floss & (jnp.abs(quad) >= floss), 0.0, curv)
    return f, curv


def _row_cost(m, d, x, D):
    floss = d.efc_frictionloss
    is_floss = d.efc_floss_active
    one_sided = (d.efc_type >= 2)
    quad = 0.5 * D * x * x
    c = jnp.where(one_sided & (x >= 0), 0.0, quad)
    lin = floss * jnp.abs(x) - 0.5 * jnp.where(
        D > 0, floss * floss / jnp.maximum(D, 1e-12), 0.0)
    c = jnp.where(is_floss & (jnp.abs(D * x) >= floss), lin, c)
    return c


class _EllipticCone:
    """Zone cost/gradient/Hessian for the elliptic contact blocks.

    Vectorized over the K contact slots; inactive contacts have D0 = 0 so
    they contribute nothing; frictionless contacts (dim==1) reduce to the
    one-sided quadratic on the normal row.
    """

    def __init__(self, m: Model, d: Data, crows):
        dtype = d.qpos.dtype
        con = d.contact
        rp = crows.shape[1]
        self.rp = rp
        fr = con.friction[:, : rp - 1]                    # (K, rp-1)
        mu0 = jnp.maximum(con.friction[:, 0], 1e-12)
        impratio = jnp.asarray(m.opt.impratio, dtype)
        dim_ok = (jnp.arange(1, rp)[None, :] < con.dim[:, None])
        self.s = jnp.where(dim_ok,
                           jnp.sqrt(impratio) * fr / mu0[:, None], 0.0)
        self.muv = mu0 / jnp.sqrt(impratio)
        self.frictionless = con.dim == 1
        self.D0 = d.efc_D[crows[:, 0]]                    # 0 when inactive

    def terms(self, x_c):
        """x_c (K, rp) -> (cost (K,), grad (K, rp), hess (K, rp, rp))."""
        rp = self.rp
        N = x_c[:, 0]
        v = x_c[:, 1:] * self.s                           # whitened coords
        T2 = jnp.sum(v * v, axis=-1)
        T = jnp.sqrt(jnp.maximum(T2, 1e-24))
        muv, D0 = self.muv, self.D0
        top = N >= muv * T
        bottom = T <= -muv * N
        mid = ~top & ~bottom
        Dm = D0 / (1.0 + muv * muv)
        r = muv * T - N

        s2x = x_c[:, 1:] * self.s * self.s                # s_i^2 x_i
        # gradients per zone
        g_bot = jnp.concatenate([(D0 * N)[:, None], D0[:, None] * s2x],
                                axis=1)
        gr = jnp.concatenate([-jnp.ones_like(N)[:, None],
                              muv[:, None] * s2x / T[:, None]], axis=1)
        g_mid = (Dm * r)[:, None] * gr
        grad = jnp.where(mid[:, None], g_mid,
                         jnp.where(bottom[:, None], g_bot,
                                   jnp.zeros_like(x_c)))
        neg = N < 0
        g_fl = jnp.concatenate([jnp.where(neg, D0 * N, 0.0)[:, None],
                                jnp.zeros_like(s2x)], axis=1)
        grad = jnp.where(self.frictionless[:, None], g_fl, grad)

        # cost per zone
        c_mid = 0.5 * Dm * r * r
        c_bot = 0.5 * D0 * (N * N + T2)
        cost = jnp.where(mid, c_mid, jnp.where(bottom, c_bot, 0.0))
        cost = jnp.where(self.frictionless,
                         jnp.where(neg, 0.5 * D0 * N * N, 0.0), cost)

        # Hessians: bottom diag(D_i) with D_i = D0 s_i^2; middle = cone
        eyep = jnp.eye(rp, dtype=x_c.dtype)
        D_bot = jnp.concatenate(
            [D0[:, None], D0[:, None] * self.s * self.s], axis=1)
        H_bot = eyep[None] * D_bot[:, :, None]
        s2 = self.s * self.s
        d2r_f = (muv[:, None, None]
                 * (jnp.eye(rp - 1, dtype=x_c.dtype)[None] * s2[:, None, :]
                    / T[:, None, None]
                    - s2x[:, :, None] * s2x[:, None, :]
                    / (T ** 3)[:, None, None]))
        d2r = jnp.zeros((x_c.shape[0], rp, rp), x_c.dtype)
        d2r = d2r.at[:, 1:, 1:].set(d2r_f)
        H_mid = Dm[:, None, None] * (
            gr[:, :, None] * gr[:, None, :] + r[:, None, None] * d2r)
        H = jnp.where(mid[:, None, None], H_mid,
                      jnp.where(bottom[:, None, None], H_bot, 0.0))
        H_fl = eyep[None] * jnp.concatenate(
            [jnp.where(neg, D0, 0.0)[:, None],
             jnp.zeros_like(self.s)], axis=1)[:, :, None]
        H = jnp.where(self.frictionless[:, None, None], H_fl, H)
        return cost, grad, H


def solve(m: Model, d: Data) -> Data:
    dtype = d.qpos.dtype
    M = d.qM
    a_smooth = d.qacc_smooth
    J = d.efc_J
    aref = d.efc_aref

    elliptic = (m.opt.cone == int(ConeType.ELLIPTIC) and m.ncon_max > 0
                and m.max_condim > 1)
    if elliptic:
        crows, noncone = _cone_plan(m)
        D_nc = jnp.where(jnp.asarray(noncone), d.efc_D, 0.0)
        cone = _EllipticCone(m, d, crows)
    else:
        D_nc = d.efc_D

    warm = not (m.opt.disableflags & int(DisableBit.WARMSTART))
    a0 = d.qacc_warmstart if warm else a_smooth
    # guard: warmstart of wrong scale falls back to smooth
    a0 = jnp.where(jnp.any(jnp.isnan(a0)), a_smooth, a0)

    # jar x = J a - aref is CARRIED through the Newton loop and updated
    # as x += alpha * Jp (exact: J(a + alpha p) - aref = x + alpha Jp).
    # Through r4 every cost/gradient evaluation recomputed J @ a — at
    # the contact-rich manip batch each (nenv, nefc, nv) J stream is
    # ~22 MB/1024 envs and the solver streamed J ~6x per Newton
    # iteration (2x total_cost, J@a, J.T f, Hessian, J@p); the r5
    # carried form streams it twice (J.T f + Hessian; J@p in the line
    # search), and all cost evaluations are (nefc,) elementwise.
    def rowcost_sum(x):
        c = jnp.sum(_row_cost(m, d, x, D_nc))
        if elliptic:
            cc, _, _ = cone.terms(x[crows])
            c = c + jnp.sum(cc)
        return c

    def grad_hess(a, x):
        f, curv = _row_force_and_curv(m, d, x, D_nc)
        Mda = M @ (a - a_smooth)
        grad = Mda + J.T @ f
        H = M + jnp.einsum("iv,i,iw->vw", J, curv, J)
        if elliptic:
            Jc = J[crows]                   # (K, rp, nv) static row gather
            _, gc, Hc = cone.terms(x[crows])
            grad = grad + jnp.einsum("krv,kr->v", Jc, gc)
            H = H + jnp.einsum("krv,krs,ksw->vw", Jc, Hc, Jc)
        return grad, H, Mda

    def line_search(a, p, x0, Mda):
        """Returns (alpha, Jp, cost(alpha), cost(0.5)) — the two candidate
        costs are evaluated on x0 + alpha*Jp and the scalar M-quadratic
        (cost_M(alpha) = c0M + alpha p'Mda + 0.5 alpha^2 p'Mp), so the
        Newton body never re-forms J @ a."""
        Jp = J @ p
        Mp = M @ p
        pMp = p @ Mp
        pM_da = p @ Mda
        c0M = 0.5 * ((a - a_smooth) @ Mda)

        def phi_cost(alpha):
            return (c0M + alpha * pM_da + 0.5 * alpha * alpha * pMp
                    + rowcost_sum(x0 + alpha * Jp))

        if elliptic:
            Jpc = Jp[crows]                 # (K, rp)
            x0c = x0[crows]

        def phi_d(alpha):
            x = x0 + alpha * Jp
            f, curv = _row_force_and_curv(m, d, x, D_nc)
            d1 = pM_da + alpha * pMp + f @ Jp
            d2 = pMp + curv @ (Jp * Jp)
            if elliptic:
                xc = x0c + alpha * Jpc
                _, gc, Hc = cone.terms(xc)
                d1 = d1 + jnp.sum(gc * Jpc)
                d2 = d2 + jnp.einsum("kr,krs,ks->", Jpc, Hc, Jpc)
            return d1, d2

        d1_0, _ = phi_d(jnp.asarray(0.0, dtype))
        # stop when the slope has dropped to ls_tolerance of its initial
        # magnitude — the analogue of MuJoCo's ls_tolerance=0.01 (the r2
        # 1e-8 relative stop over-iterated the lockstep batch ~2x without
        # moving the accepted step)
        gtol = jnp.asarray(m.opt.ls_tolerance, dtype) * jnp.maximum(
            1e-8, jnp.abs(d1_0))
        curv_floor = 1e-8 * jnp.maximum(pMp, 1e-12)

        if not elliptic:
            # pyramidal: plain 1D Newton on phi' (fast path; the piecewise
            # quadratics here are benign — r1-validated)
            def c1(carry):
                alpha, it, d1 = carry
                return ((it < m.opt.ls_iterations) & (jnp.abs(d1) > gtol)
                        & jnp.isfinite(d1))

            def b1(carry):
                alpha, it, _ = carry
                d1, d2 = phi_d(alpha)
                step = d1 / jnp.maximum(d2, curv_floor)
                return (jnp.clip(alpha - step, 0.0, 8.0), it + 1, d1)

            alpha, _, _ = jax.lax.while_loop(
                c1, b1, (jnp.asarray(1.0, dtype), jnp.asarray(0, jnp.int32),
                         jnp.asarray(1e30, dtype)))
            alpha = jnp.where(jnp.isfinite(alpha), alpha, 0.0)
            alpha = jnp.clip(alpha, 0.0, 8.0)
            return alpha, Jp, phi_cost(alpha), phi_cost(
                jnp.asarray(0.5, dtype))

        # elliptic: phi is convex but has cone-zone kinks where pure 1D
        # Newton oscillates (r2); phi' is nondecreasing, so bracket its
        # root then run safeguarded Newton-bisection.

        def expand_cond(carry):
            lo, hi, d1hi, it = carry
            return (d1hi < 0) & (it < 8)

        def expand_body(carry):
            lo, hi, d1hi, it = carry
            hi2 = hi * 2.0
            d1n, _ = phi_d(hi2)
            return hi, hi2, d1n, it + 1

        d1_1, _ = phi_d(jnp.asarray(1.0, dtype))
        lo, hi, d1hi, _ = jax.lax.while_loop(
            expand_cond, expand_body,
            (jnp.asarray(0.0, dtype), jnp.asarray(1.0, dtype), d1_1,
             jnp.asarray(0, jnp.int32)))
        # if phi' never turned positive, take the largest bracketed alpha
        alpha0 = jnp.where(d1hi < 0, hi, 0.5 * (lo + hi))

        def cond(carry):
            lo, hi, alpha, d1, it = carry
            return ((it < m.opt.ls_iterations) & (jnp.abs(d1) > gtol)
                    & jnp.isfinite(d1))

        def body(carry):
            lo, hi, alpha, _, it = carry
            d1, d2 = phi_d(alpha)
            lo = jnp.where(d1 < 0, alpha, lo)
            hi = jnp.where(d1 < 0, hi, alpha)
            newton = alpha - d1 / jnp.maximum(d2, curv_floor)
            inside = (newton > lo) & (newton < hi) & jnp.isfinite(newton)
            alpha_new = jnp.where(inside, newton, 0.5 * (lo + hi))
            return (lo, hi, alpha_new, d1, it + 1)

        _, _, alpha, _, _ = jax.lax.while_loop(
            cond, body,
            (lo, hi, alpha0, jnp.asarray(1e30, dtype),
             jnp.asarray(0, jnp.int32)))
        alpha = jnp.where(jnp.isfinite(alpha), alpha, 0.0)
        alpha = jnp.clip(alpha, 0.0, 256.0)
        return alpha, Jp, phi_cost(alpha), phi_cost(jnp.asarray(0.5, dtype))

    def newton_body(carry):
        a, x, it, prev_cost, _ = carry
        grad, H, Mda = grad_hess(a, x)
        # small relative ridge keeps H SPD under f32 rounding
        ridge = 1e-7 * jnp.trace(H) / H.shape[0]
        H = H + ridge * jnp.eye(H.shape[0], dtype=H.dtype)
        from mujoco_sim_tpu.ops import linalg
        p = -smooth.solve_chol(linalg.cholesky(H), grad)
        p = jnp.where(jnp.isfinite(p), p, 0.0)
        alpha, Jp, new_cost, half_cost = line_search(a, p, x, Mda)
        # never accept an ascent step: the 1D Newton line search can
        # overshoot across cone-zone kinks (elliptic); fall back to a
        # halved plain step, else reject and stop.  alpha_eff keeps the
        # carried jar x consistent with the accepted a on every branch.
        use_half = (new_cost > prev_cost) & (half_cost < prev_cost)
        alpha_eff = jnp.where(use_half, jnp.asarray(0.5, dtype), alpha)
        new_cost = jnp.where(use_half, half_cost, new_cost)
        worse = new_cost > prev_cost
        alpha_eff = jnp.where(worse, jnp.asarray(0.0, dtype), alpha_eff)
        new_cost = jnp.where(worse, prev_cost, new_cost)
        a_new = a + alpha_eff * p
        x_new = x + alpha_eff * Jp
        improved = prev_cost - new_cost
        done = improved < m.opt.tolerance * jnp.maximum(1.0, jnp.abs(new_cost))
        return a_new, x_new, it + 1, new_cost, done

    def newton_cond(carry):
        a, x, it, cost, done = carry
        return (it < m.opt.solver_iterations) & jnp.logical_not(done)

    # best-of-two init like the reference solver: warmstart vs smooth
    # (the two J @ a streams here run once per solve, not per iteration)
    x_warm = J @ a0 - aref
    x_smooth = J @ a_smooth - aref
    da_w = a0 - a_smooth
    c_warm = 0.5 * (da_w @ (M @ da_w)) + rowcost_sum(x_warm)
    c_smooth = rowcost_sum(x_smooth)
    take_warm = c_warm <= c_smooth
    a0 = jnp.where(take_warm, a0, a_smooth)
    x0 = jnp.where(take_warm, x_warm, x_smooth)
    c0 = jnp.where(take_warm, c_warm, c_smooth)

    a, x, _, _, _ = jax.lax.while_loop(
        newton_cond, newton_body,
        (a0, x0, jnp.asarray(0, jnp.int32), c0, jnp.asarray(False)))

    efc_force, qfrc_constraint = constraint_force_from_qacc(m, d, a, jar=x)
    return d.replace(qacc=a, qfrc_constraint=qfrc_constraint,
                     efc_force=efc_force)


def constraint_force_from_qacc(m: Model, d: Data, qacc: jax.Array,
                               jar: jax.Array | None = None):
    """Constraint force for a GIVEN qacc — the inverse constraint solver
    (mj_invConstraint): jar = J qacc - aref, force = -dcost/djar per row
    (one-sided clamp / frictionloss tails / elliptic cone zones).  Used
    both to finalize the forward Newton solve and by engine.inverse,
    which must evaluate the force at the CALLER's qacc rather than reuse
    the carried solution (mj_inverse semantics,
    /root/reference/src/mujoco_sim/mj_hw_interface.cpp:61)."""
    J = d.efc_J
    aref = d.efc_aref
    elliptic = (m.opt.cone == int(ConeType.ELLIPTIC) and m.ncon_max > 0
                and m.max_condim > 1)
    if elliptic:
        crows, noncone = _cone_plan(m)
        D_nc = jnp.where(jnp.asarray(noncone), d.efc_D, 0.0)
    else:
        D_nc = d.efc_D
    # `jar` (J qacc - aref) may be passed by the forward solver, which
    # carries it through the Newton loop — skips one full J stream
    x = (J @ qacc - aref) if jar is None else jar
    f, _ = _row_force_and_curv(m, d, x, D_nc)
    efc_force = -f
    if elliptic:
        cone = _EllipticCone(m, d, crows)
        xc = x[crows]
        _, gc, _ = cone.terms(xc)
        efc_force = efc_force.at[jnp.asarray(crows.reshape(-1))].set(
            -gc.reshape(-1))
    qfrc_constraint = J.T @ efc_force
    return efc_force, qfrc_constraint
