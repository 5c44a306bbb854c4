"""Validation of the closed-form derivative engine (solver/analytic.py)
against jax.jacfwd/jax.hessian ground truth on random points."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from learningagileflight_se3.config import CostWeights, QuadParams, SolverConfig
from learningagileflight_se3.core.rotations import rodrigues_to_quat
from learningagileflight_se3.solver import ilqr as M
from learningagileflight_se3.solver.analytic import (
    DynamicsTaylor,
    attitude_curvature,
    make_cost_quadratics,
    make_final_quadratics,
)

PQ = QuadParams()
DT = 0.1
NZ, NU = 17, 4


def rand_zu(rng, n):
    zu = rng.normal(size=(n, 21))
    zu[:, 13:17] = rng.uniform(0, 2.44, size=(n, 4))  # u_prev
    zu[:, 17:21] = rng.uniform(0, 2.44, size=(n, 4))  # u
    return zu


class TestDynamicsTaylor:
    @pytest.mark.slow
    def test_jacobians_exact(self, rng):
        dyn = DynamicsTaylor(PQ, DT)
        ZU = jnp.asarray(rand_zu(rng, 8))
        A, B = dyn.jacobians(ZU)

        def f(zu):
            return M._aug_dynamics(zu[:NZ], zu[NZ:], DT, PQ)

        for h in range(8):
            F = np.asarray(jax.jacfwd(f)(ZU[h]))
            np.testing.assert_allclose(np.asarray(A[h]), F[:, :NZ], atol=1e-10)
            np.testing.assert_allclose(np.asarray(B[h]), F[:, NZ:], atol=1e-10)

    @pytest.mark.slow
    def test_hamiltonian_hessian_exact(self, rng):
        dyn = DynamicsTaylor(PQ, DT)
        ZU = jnp.asarray(rand_zu(rng, 5))
        Lam = jnp.asarray(rng.normal(size=(5, NZ)))
        H2 = dyn.hamiltonian_hessians(ZU, Lam)

        def vf(zu, lam):
            return lam @ M._aug_dynamics(zu[:NZ], zu[NZ:], DT, PQ)

        for h in range(5):
            Hx = np.asarray(jax.hessian(vf)(ZU[h], Lam[h]))
            np.testing.assert_allclose(np.asarray(H2[h]), Hx, atol=1e-9)


class TestAttitudeCurvature:
    def test_matches_hessian(self, rng):
        from learningagileflight_se3.costs.gate_costs import attitude_error

        for _ in range(5):
            tq = rodrigues_to_quat(jnp.asarray(rng.normal(size=3) * 0.5))
            Hatt = np.asarray(attitude_curvature(tq))
            q = jnp.asarray(rng.normal(size=4))
            Hx = np.asarray(jax.hessian(lambda qq: attitude_error(qq, tq))(q))
            np.testing.assert_allclose(Hatt, Hx, atol=1e-10)
            # quadratic reconstruction: att(q) = att(0) + 0.5 q^T H q
            att = float(attitude_error(q, tq))
            att0 = float(attitude_error(jnp.zeros(4), tq))
            assert att == np.testing.assert_allclose(
                att, att0 + 0.5 * float(q @ jnp.asarray(Hatt) @ q), atol=1e-10
            ) or True


class TestCostQuadratics:
    def _problem(self, rng, weights, cfg, H=7):
        Z = jnp.asarray(rand_zu(rng, H)[:, :NZ])
        U = jnp.asarray(rng.uniform(0, 2.44, size=(H, NU)))
        tw = jnp.asarray(60 * np.exp(-10 * (0.1 * np.arange(H) - 0.4) ** 2))
        goal = jnp.asarray(rng.normal(size=3))
        tra_pos = jnp.asarray(rng.normal(size=3))
        tq = rodrigues_to_quat(jnp.asarray(rng.normal(size=3) * 0.4))
        prob = M._Problem(
            z0=jnp.zeros(NZ), goal_pos=goal, tra_pos=tra_pos, tra_quat=tq, t_weights=tw
        )
        return Z, U, tw, goal, tra_pos, tq, prob

    def _check(self, rng, weights, cfg):
        Z, U, tw, goal, tra_pos, tq, prob = self._problem(rng, weights, cfg)
        quad = make_cost_quadratics(weights, cfg)
        lz, lu, lzz, luz, luu = quad(Z, U, tw, goal, tra_pos, tq)
        for h in range(Z.shape[0]):
            zu = jnp.concatenate([Z[h], U[h]])

            def fc(zu_):
                return M._stage_cost(zu_[:NZ], zu_[NZ:], tw[h], prob, weights, cfg)

            g = np.asarray(jax.grad(fc)(zu))
            Hc = np.asarray(jax.hessian(fc)(zu))
            np.testing.assert_allclose(np.asarray(lz[h]), g[:NZ], atol=1e-9)
            np.testing.assert_allclose(np.asarray(lu[h]), g[NZ:], atol=1e-9)
            np.testing.assert_allclose(np.asarray(lzz[h]), Hc[:NZ, :NZ], atol=1e-9)
            np.testing.assert_allclose(np.asarray(luz[h]), Hc[NZ:, :NZ], atol=1e-9)
            np.testing.assert_allclose(np.asarray(luu[h]), Hc[NZ:, NZ:], atol=1e-9)

    @pytest.mark.slow
    def test_main_variant(self, rng):
        self._check(rng, CostWeights(), SolverConfig())

    def test_unsquared_attitude(self, rng):
        self._check(rng, CostWeights(squared_attitude=False), SolverConfig())

    @pytest.mark.slow
    def test_with_goal_attitude_and_bound_penalty(self, rng):
        self._check(
            rng,
            CostWeights(wqf=2.5),
            SolverConfig(w_bound_weight=7.0),
        )

    def test_final_quadratics(self, rng):
        weights = CostWeights()
        zH = jnp.asarray(rand_zu(rng, 1)[0, :NZ])
        goal = jnp.asarray(rng.normal(size=3))
        prob = M._Problem(
            z0=jnp.zeros(NZ), goal_pos=goal, tra_pos=jnp.zeros(3),
            tra_quat=jnp.asarray([1.0, 0, 0, 0]), t_weights=jnp.zeros(1),
        )
        fq = make_final_quadratics(weights)
        pz, pzz = fq(zH, goal)
        g = np.asarray(jax.grad(lambda z: M._final_cost(z, prob, weights))(zH))
        Hx = np.asarray(jax.hessian(lambda z: M._final_cost(z, prob, weights))(zH))
        np.testing.assert_allclose(np.asarray(pz), g, atol=1e-10)
        np.testing.assert_allclose(np.asarray(pzz), Hx, atol=1e-10)


class TestExplicitForms:
    """The sparse closed-form Jacobians/H2 must equal the dense Taylor path."""

    def test_explicit_jacobians(self, rng):
        from learningagileflight_se3.solver.analytic import explicit_jacobians

        dyn = DynamicsTaylor(PQ, DT)
        ZU = jnp.asarray(rand_zu(rng, 10))
        A1, B1 = dyn.jacobians(ZU)
        A2, B2 = explicit_jacobians(ZU, PQ, DT)
        np.testing.assert_allclose(np.asarray(A2), np.asarray(A1), atol=1e-10)
        np.testing.assert_allclose(np.asarray(B2), np.asarray(B1), atol=1e-10)

    def test_explicit_h2(self, rng):
        from learningagileflight_se3.solver.analytic import explicit_h2

        dyn = DynamicsTaylor(PQ, DT)
        ZU = jnp.asarray(rand_zu(rng, 6))
        Lam = jnp.asarray(rng.normal(size=(6, NZ)))
        H2d = dyn.hamiltonian_hessians(ZU, Lam)
        for h in range(6):
            H2e = explicit_h2(ZU[h], Lam[h], PQ, DT)
            np.testing.assert_allclose(np.asarray(H2e), np.asarray(H2d[h]), atol=1e-10)
