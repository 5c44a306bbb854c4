"""Study: the PYBULLET fork's UNSQUARED traversal-attitude cost is a
degenerate objective for cold trajectory optimization.

The gym fork changes the traversal attitude term from wqt*(3-tr)^2 to
wqt*(3 - tr(R_g^T R)) (gym_pybullet_drone/quad_model.py:200 vs
quad_model.py:210).  Because the reference's quaternion is NEVER normalized
(no renorm in the Euler integrator, quad_model.py:218) and R's entries scale
with |q|^2, the linear trace term is UNBOUNDED BELOW in |q|:

  1. off the dynamics manifold, the lifted NLP has infeasible descent
     directions to -inf (scipy trust-constr rides them: cost -2e4 at
     constraint violation ~1);
  2. ON the manifold, the no-renorm Euler rollout lets |q(t)| grow under
     spin, so cold full-horizon optimization (DDP from any start, or
     homotopy-seeded L-BFGS-B) discovers trajectories with |q| up to ~5
     and total cost deeply NEGATIVE — a quaternion-norm artifact, not a
     flight.

The fork "works" in the reference only because its deployment MPC is
receding-horizon and warm-starts near hover, staying in the physical local
basin — IPOPT never explores far enough to find the artifact.  Consequence
for benchmarks/bench_accuracy.py: a COLD-basin "match the oracle" claim is
ill-posed on the unsquared objective (there is no physical global optimum
to match), so the accuracy artifact's PYBULLET cells exercise the fork's
bound/sampler deltas under the well-posed squared attitude term, and this
script documents the degeneracy with measurements.

Writes artifacts/study_unsquared_degeneracy.json.

Usage: python scripts/dev_unsquared_degeneracy.py [--n 8]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=8)
    ap.add_argument("--out", default="artifacts/study_unsquared_degeneracy.json")
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from learningagileflight_se3.config import Variant, preset
    from learningagileflight_se3.models.sampler import (
        sample_scenarios,
        scenario_to_problem,
    )
    from learningagileflight_se3.solver.ilqr import make_mpc_solver

    pp, wp, cp, _, sp, _ = preset(Variant.PYBULLET)
    assert not wp.squared_attitude
    cfg = dataclasses.replace(cp, horizon=50, max_iters=300,
                              w_bound=float("inf"))
    scen = np.asarray(sample_scenarios(jax.random.PRNGKey(7), args.n, sp))
    solve = jax.jit(make_mpc_solver(pp, wp, cfg))
    U_hover = jnp.full((cfg.horizon, 4), float(pp.mass) * float(pp.g) / 4.0)
    rows = []
    for i in range(args.n):
        prob = scenario_to_problem(jnp.asarray(scen[i]))
        tra_ang = jnp.array([0.0, float(scen[i, 8]) * 0.5, 0.0])
        t_nom = float(np.clip(
            np.linalg.norm(np.asarray(prob["x0"])[0:3]) / 4.0, 2.0, 4.0))
        cell = (prob["x0"], jnp.zeros(4), prob["goal_pos"],
                jnp.zeros(3), tra_ang, jnp.asarray(t_nom))
        sm = solve(*cell)
        sh = solve(*cell, U_init=U_hover)
        s = sm if float(sm.cost) <= float(sh.cost) else sh
        qn = np.linalg.norm(np.asarray(s.state_traj)[:, 6:10], axis=1)
        rows.append({
            "scenario": i,
            "cold_cost": float(s.cost),
            "negative_cost": bool(float(s.cost) < 0.0),
            "quat_norm_max": round(float(qn.max()), 3),
            "exit_status": int(s.status),
        })
        print(f"scenario {i}: cost {float(s.cost):12.1f}  "
              f"|q|max {qn.max():.2f}  status {int(s.status)}", flush=True)

    out = {
        "what": ("Cold full-horizon optimization of the PYBULLET fork's "
                 "UNSQUARED traversal-attitude objective (gym "
                 "quad_model.py:200) exploits the unnormalized quaternion: "
                 "|q| grows along the no-renorm Euler rollout, the linear "
                 "trace term goes negative, and 'optimal' cold trajectories "
                 "are quaternion-norm artifacts, not flights. The lifted "
                 "NLP is additionally unbounded below OFF the manifold. "
                 "Cold-basin oracle comparison is therefore ill-posed for "
                 "this variant; see benchmarks/bench_accuracy.py docstring."),
        "n_negative_cost": int(sum(r["negative_cost"] for r in rows)),
        "max_quat_norm": max(r["quat_norm_max"] for r in rows),
        "rows": rows,
    }
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
