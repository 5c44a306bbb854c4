"""Traversal-time fixed-point solver (reference quad_moving.py:29-57).

Iterates  t1 <- t1 + (t2 - t1)/2,  t2 = DNN2(window inputs at the gate pose
predicted t1 seconds ahead)[6]  until |t2 - t1| <= tol, as a
`lax.while_loop` (jit/vmap-safe, with an iteration cap the reference lacks —
a diverging fixed point would hang the reference's while loop).

Gate prediction semantics (quad_moving.py:36-42): translate the CURRENT gate
by velo*t1 and rotate_y by w*t1, then build the 18-dim window input
(width |p0-p1|, pitch atan(dz/dx), window-frame state + final point).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from learningagileflight_se3.geometry.gate import (
    rotate_y,
    translate,
    window_inputs,
)


def make_traversal_time_solver(model2, tol: float = 1e-3, max_iters: int = 100,
                               accel: str = "reference"):
    """solver(nn2_params, quad_state, final_point, gate_pts, velo, w) -> t.

    tol: 1e-3 main variant (quad_moving.py:45) / 1e-2 PyBullet fork.

    accel:
      * "reference" — the reference's averaging update t1 <- t1 + (t2-t1)/2
        (linear convergence; tens of DNN2 evaluations when the response is
        stiff — ~40+ trips per call on the tick).
      * "secant" — secant iteration on g(t) = DNN2_t(t) - t: the SAME fixed
        point to the same tolerance in ~3-6 evaluations (superlinear), with
        a guarded fall-back to the averaging step when the secant
        denominator degenerates and a runaway clamp to t in [-20, 20] s
        (symmetric: the reference's averaging iteration legitimately lands
        on NEGATIVE fixed points once the gate is behind the vehicle —
        main.py feeds them to the planner unfiltered — so the guard bounds
        magnitude without truncating the reference's range).  Use for the
        deployed 10 Hz tick where each evaluation has real latency."""

    def predict_t(nn2_params, state, final_point, gate_pts, velo, t1, w):
        pts = rotate_y(translate(gate_pts, velo * t1), w * t1)
        inp = window_inputs(pts, state, final_point)
        return model2.apply(nn2_params, inp)[6]

    def solve_reference(nn2_params, state, final_point, gate_pts, velo, w):
        centroid = jnp.mean(gate_pts, axis=0)
        t1 = jnp.linalg.norm(centroid - state[0:3]) / 3.0  # t_guess (line 32)
        t2 = predict_t(nn2_params, state, final_point, gate_pts, velo, t1, w)

        def cond(carry):
            t1, t2, it = carry
            return (jnp.abs(t2 - t1) > tol) & (it < max_iters)

        def body(carry):
            t1, t2, it = carry
            t1 = t1 + (t2 - t1) / 2.0
            t2 = predict_t(nn2_params, state, final_point, gate_pts, velo, t1, w)
            return (t1, t2, it + 1)

        t1, t2, _ = jax.lax.while_loop(cond, body, (t1, t2, jnp.zeros((), jnp.int32)))
        return t1

    def solve_secant(nn2_params, state, final_point, gate_pts, velo, w):
        def g(t):
            return predict_t(nn2_params, state, final_point, gate_pts, velo,
                             t, w) - t

        centroid = jnp.mean(gate_pts, axis=0)
        t0 = jnp.linalg.norm(centroid - state[0:3]) / 3.0
        g0 = g(t0)
        t1 = t0 + g0 / 2.0  # one averaging step seeds the secant pair
        g1 = g(t1)

        def cond(c):
            t0, g0, t1, g1, it = c
            return (jnp.abs(g1) > tol) & (it < max_iters)

        def body(c):
            t0, g0, t1, g1, it = c
            denom = g1 - g0
            sec = t1 - g1 * (t1 - t0) / denom
            ok = jnp.isfinite(sec) & (jnp.abs(denom) > 1e-8)
            fall = jnp.clip(t1 + g1 / 2.0, -20.0, 20.0)
            cand = jnp.clip(jnp.where(ok, sec, fall), -20.0, 20.0)
            g_cand = g(cand)
            # GUARDED acceptance: an unguarded secant can cycle on a
            # non-contraction DNN2 response — keep the secant step only if
            # it reduced |g|, else fall back to the reference's averaging
            # step (always convergent for the responses the averaging
            # iteration handles).  Both g(cand) and g(fall) are evaluated
            # every iteration (jnp.where is eager), so the cost is exactly
            # two g-evaluations per iteration — still ~5x fewer total than
            # averaging alone at the trip counts measured on the tick.
            use = jnp.abs(g_cand) < jnp.abs(g1)
            tn = jnp.where(use, cand, fall)
            gn = jnp.where(use, g_cand, g(fall))
            return (t1, g1, tn, gn, it + 1)

        _, _, t1, g1, _ = jax.lax.while_loop(
            cond, body, (t0, g0, t1, g1, jnp.zeros((), jnp.int32))
        )
        return t1

    if accel == "secant":
        return solve_secant
    if accel != "reference":
        raise ValueError(f"unknown accel: {accel!r}")
    return solve_reference
