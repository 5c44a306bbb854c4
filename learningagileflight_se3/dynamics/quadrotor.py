"""Analytic SE(3) quadrotor dynamics (pure JAX).

State  x = [r_I(3), v_I(3), q(4, wxyz), w_B(3)]  in R^13
Input  u = [f1, f2, f3, f4]  per-rotor thrusts   in R^4

ODE (reference quad_model.py:106-119):
    r_dot = v
    v_dot = C_I_B @ [0,0,sum(f)]/m + [0,0,-g]
    q_dot = 0.5 * Omega(w) @ q
    w_dot = J^-1 (M - w x (J w))
with plus-configuration mixer (quad_model.py:86-98):
    Mx = (-f2 + f4) l/2,  My = (-f1 + f3) l/2,  Mz = (f1 - f2 + f3 - f4) c

Discretization: forward Euler x + dt*f (quad_model.py:218, quad_OC.py:52) —
deliberately WITHOUT quaternion renormalization, matching the reference
bit-for-bit semantics; an RK4 stepper (the commented-out variant at
quad_model.py:221-236) is provided as the higher-fidelity option.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from learningagileflight_se3.config import QuadParams
from learningagileflight_se3.core.rotations import quat_to_dcm_w2b, omega_matrix


def quad_ode(x, u, params: QuadParams):
    """Continuous-time dynamics f(x, u) -> x_dot, single (13,) state."""
    v = x[3:6]
    q = x[6:10]
    w = x[10:13]

    thrust = u[0] + u[1] + u[2] + u[3]
    C_B_I = quat_to_dcm_w2b(q)
    # C_I_B @ [0,0,T] is simply T * (third row of C_B_I), saving a transpose+matmul
    acc_body_z = C_B_I[2, :] * (thrust / params.mass)
    dv = acc_body_z + jnp.array([0.0, 0.0, -params.g], dtype=x.dtype)

    dq = 0.5 * omega_matrix(w) @ q

    J = jnp.array([params.Jx, params.Jy, params.Jz], dtype=x.dtype)
    M = jnp.array(
        [
            (-u[1] + u[3]) * (params.l / 2.0),
            (-u[0] + u[2]) * (params.l / 2.0),
            (u[0] - u[1] + u[2] - u[3]) * params.c,
        ]
    )
    Jw = J * w
    dw = (M - jnp.cross(w, Jw)) / J

    return jnp.concatenate([v, dv, dq, dw])


def euler_step(x, u, dt, params: QuadParams):
    """x_{k+1} = x_k + dt f(x_k,u_k) — matches reference discretization exactly
    (no quaternion renorm; quad_OC.py:52-53)."""
    return x + dt * quad_ode(x, u, params)


def euler_step_renorm(x, u, dt, params: QuadParams):
    """Euler step with quaternion renormalization — the physically-consistent
    PLANT step for long closed-loop sims.

    The reference's plant (main.py:108, the same no-renorm Euler as its MPC
    model) silently lets |q| drift; under aggressive maneuvers the drift
    compounds (quat_to_dcm of a non-unit q scales the thrust direction by
    ~|q|^2) and the sim diverges.  The reference's demos stay in the gentle
    regime where the drift is negligible; renormalizing makes the 100 Hz
    plant correct in all regimes while the SOLVER keeps the reference-exact
    discretization (bit-parity with the CasADi model, quad_OC.py:52-53)."""
    xn = x + dt * quad_ode(x, u, params)
    q = xn[6:10]
    q = q / jnp.maximum(jnp.linalg.norm(q), 1e-12)
    return jnp.concatenate([xn[0:6], q, xn[10:13]])


def rk4_step(x, u, dt, params: QuadParams, substeps: int = 4):
    """Classic RK4 with `substeps` sub-intervals (the commented-out variant,
    quad_model.py:221-236 uses M=4)."""
    h = dt / substeps

    def sub(x, _):
        k1 = quad_ode(x, u, params)
        k2 = quad_ode(x + 0.5 * h * k1, u, params)
        k3 = quad_ode(x + 0.5 * h * k2, u, params)
        k4 = quad_ode(x + h * k3, u, params)
        return x + (h / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4), None

    x, _ = jax.lax.scan(sub, x, None, length=substeps)
    return x


def rollout(x0, U, dt, params: QuadParams, method: str = "euler"):
    """Roll a control sequence U (H, 4) from x0; returns X (H+1, 13)."""
    step = euler_step if method == "euler" else rk4_step

    def body(x, u):
        xn = step(x, u, dt, params)
        return xn, xn

    _, X = jax.lax.scan(body, x0, U)
    return jnp.concatenate([x0[None], X], axis=0)


def mixer_matrix(params: QuadParams, dtype=jnp.float64):
    """u_m: rotor thrusts -> [total thrust, Mx, My, Mz] (quad_model.py:93-98)."""
    l2 = params.l / 2.0
    c = params.c
    return jnp.array(
        [
            [1.0, 1.0, 1.0, 1.0],
            [0.0, -l2, 0.0, l2],
            [-l2, 0.0, l2, 0.0],
            [c, -c, c, -c],
        ],
        dtype=dtype,
    )


def thrust_torque(u, params: QuadParams):
    """[T, Mx, My, Mz] for logging/actuation (main.py:111-115)."""
    return mixer_matrix(params, dtype=u.dtype) @ u


def rotor_positions(x, wing_len: float):
    """World positions of the 4 rotor tips, (4, 3), for the collision reward.

    Body-frame tip offsets are the X-configuration used by
    get_quadrotor_position (quad_model.py:242-245): (+-wl/2/sqrt2, +-wl/2/sqrt2, 0).
    """
    r = x[0:3]
    q = x[6:10]
    a = wing_len * 0.5 / jnp.sqrt(2.0)
    tips_B = jnp.array(
        [
            [a, a, 0.0],
            [-a, a, 0.0],
            [-a, -a, 0.0],
            [a, -a, 0.0],
        ],
        dtype=x.dtype,
    )
    C_I_B = quat_to_dcm_w2b(q).T
    return r[None, :] + tips_B @ C_I_B.T
