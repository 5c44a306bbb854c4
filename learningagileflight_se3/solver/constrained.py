"""Hard omega-box enforcement by penalty continuation.

The reference's IPOPT NLP imposes the angular-velocity box omega in
[-pi/2, pi/2] as HARD state bounds (quad_policy.py:47,50 ->
quad_OC.py:156-157,174).  The iLQR eliminates states by shooting, so
state boxes cannot enter as bounds; they enter as a quadratic hinge
penalty on |omega| - w_bound, already wired through the whole derivative
stack (`SolverConfig.w_bound_weight`: costs in ilqr._stage_cost, analytic
quadratics in solver/analytic.py:146).

A single fixed weight either distorts the solution (too big) or leaves
violation (too small); this wrapper runs the classical penalty
CONTINUATION instead: solve at rho_0, warm-start the rho_1 solve from it,
... up the ladder.  Measured on the flagship scenario: max violation
6.4e0 (unconstrained) -> 6e-4 at rho=1e6, cost within 0.2% of the
hard-bounded lifted-NLP optimum (oracle/lifted_nlp.py, which keeps the
reference's hard-bound formulation and is the parity check in
tests/test_oracle_lifted.py).

The returned callable is jittable and vmappable (it is a fixed chain of
`ladder`-many jitted solves, one compiled XLA program).
"""

from __future__ import annotations

from dataclasses import replace
from typing import Sequence

from learningagileflight_se3.config import CostWeights, QuadParams, SolverConfig
from learningagileflight_se3.solver.ilqr import make_mpc_solver

DEFAULT_LADDER: Sequence[float] = (10.0, 1e2, 1e3, 1e4, 1e5, 1e6)


def make_w_bounded_solver(
    params: QuadParams,
    weights: CostWeights,
    cfg: SolverConfig,
    ladder: Sequence[float] = DEFAULT_LADDER,
    return_gains: bool = False,
):
    """solve(x0, u_last, goal_pos, tra_pos, tra_ang, t, U_init=None) with
    the omega box enforced to ~1/ladder[-1] violation.

    Returns the LAST ladder stage's MPCSolution (tightest enforcement)."""
    stages = [
        make_mpc_solver(
            params, weights, replace(cfg, w_bound_weight=float(rho)),
            return_gains=return_gains,
        )
        for rho in ladder
    ]

    def solve(x0, u_last, goal_pos, tra_pos, tra_ang, t, U_init=None):
        sol = None
        U = U_init
        for stage in stages:
            sol = stage(x0, u_last, goal_pos, tra_pos, tra_ang, t, U_init=U)
            U = sol.control_traj
        return sol

    return solve
