"""Independent pure-NumPy (float64) implementation of the dynamics and the
gate-traversal objective, written directly from the reference's math spec
(quad_model.py:106-119, 121-213; quad_OC.py:136-167).

Purpose: a CPU oracle that shares NO code with the JAX implementation, so the
unit tests cross-check two independent derivations of the same spec (the role
CasADi/IPOPT plays in BASELINE.md; CasADi is not available in this image).
Test-only — never imported by the device compute path.
"""

from __future__ import annotations

import numpy as np

from learningagileflight_se3.config import CostWeights, QuadParams


def _dcm_w2b(q):
    w, x, y, z = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y + w * z), 2 * (x * z - w * y)],
            [2 * (x * y - w * z), 1 - 2 * (x * x + z * z), 2 * (y * z + w * x)],
            [2 * (x * z + w * y), 2 * (y * z - w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def np_quad_ode(x, u, p: QuadParams):
    r, v, q, w = x[0:3], x[3:6], x[6:10], x[10:13]
    T = np.sum(u)
    C_I_B = _dcm_w2b(q).T
    dv = C_I_B @ np.array([0.0, 0.0, T]) / p.mass + np.array([0.0, 0.0, -p.g])
    Om = np.array(
        [
            [0, -w[0], -w[1], -w[2]],
            [w[0], 0, w[2], -w[1]],
            [w[1], -w[2], 0, w[0]],
            [w[2], w[1], -w[0], 0],
        ]
    )
    dq = 0.5 * Om @ q
    J = np.diag([p.Jx, p.Jy, p.Jz])
    M = np.array(
        [
            -u[1] * p.l / 2 + u[3] * p.l / 2,
            -u[0] * p.l / 2 + u[2] * p.l / 2,
            (u[0] - u[1] + u[2] - u[3]) * p.c,
        ]
    )
    dw = np.linalg.inv(J) @ (M - np.cross(w, J @ w))
    return np.concatenate([v, dv, dq, dw])


def np_euler_step(x, u, dt, p: QuadParams):
    return x + dt * np_quad_ode(x, u, p)


def np_rollout(x0, U, dt, p: QuadParams):
    X = [np.asarray(x0, dtype=float)]
    for u in U:
        X.append(np_euler_step(X[-1], u, dt, p))
    return np.stack(X)


def _att_err(q, q_ref):
    return np.trace(np.eye(3) - _dcm_w2b(q_ref).T @ _dcm_w2b(q))


def np_total_cost(
    X,
    U,
    u_last,
    dt,
    t,
    goal_pos,
    tra_pos,
    tra_quat,
    w: CostWeights,
):
    """Exact objective of the reference's lifted NLP (quad_OC.py:136-167),
    evaluated on shooting variables."""
    H = len(U)
    J = 0.0
    up = np.asarray(u_last, dtype=float)
    for k in range(H):
        x, u = X[k], U[k]
        wk = w.tra_amp * np.exp(-w.tra_decay * (dt * k - t) ** 2)
        att = _att_err(x[6:10], tra_quat)
        att_term = att**2 if w.squared_attitude else att
        tra = w.wrt * np.sum((x[0:3] - tra_pos) ** 2) + w.wqt * att_term
        goal = (
            w.wrf * np.sum((x[0:3] - goal_pos) ** 2)
            + w.wvf * np.sum(x[3:6] ** 2)
            + w.wwf * np.sum(x[10:13] ** 2)
        )
        if w.wqf != 0.0:
            goal += w.wqf * _att_err(x[6:10], np.array([1.0, 0, 0, 0]))
        J += wk * tra + goal + w.wthrust * np.sum(u**2) + w.w_du * np.sum((u - up) ** 2)
        up = u
    xH = X[H]
    J += (
        w.wrf * np.sum((xH[0:3] - goal_pos) ** 2)
        + w.wvf * np.sum(xH[3:6] ** 2)
        + w.wwf * np.sum(xH[10:13] ** 2)
    )
    if w.wqf != 0.0:
        J += w.wqf * _att_err(xH[6:10], np.array([1.0, 0, 0, 0]))
    return J
