// fastquad: native host-side runtime for LearningAgileFlight-SE3.
//
// The reference relies on native code for everything hot (IPOPT's C++
// interior point, CasADi's C++ AD, PyBullet physics).  In this framework the
// accelerator owns the compute path; this library owns the HOST side:
//   * a high-throughput scenario sampler (the quad_nn.py:18-48 distribution,
//     xoshiro256++ PRNG) for feeding training without Python overhead,
//   * a float64 Euler plant (quad_model.py:106-119,215-219 semantics:
//     no quaternion renormalization) as an independent verification oracle
//     and host-side simulator (the PyBullet-role stand-in),
//   * the collision score / trajectory reward (solid_geometry.py:104-168,
//     quad_policy.py:85-90) for host-side evaluation of device rollouts.
//
// Pure C API over double arrays; no external dependencies. Built by
// native/Makefile into libfastquad.so, loaded via ctypes
// (learningagileflight_se3/native.py).

#include <cmath>
#include <cstdint>
#include <cstring>

namespace {

// ----------------------------------------------------------------- xoshiro
struct Xoshiro256pp {
    uint64_t s[4];
    static uint64_t splitmix64(uint64_t& x) {
        x += 0x9E3779B97f4A7C15ULL;
        uint64_t z = x;
        z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ULL;
        z = (z ^ (z >> 27)) * 0x94D049BB133111EBULL;
        return z ^ (z >> 31);
    }
    explicit Xoshiro256pp(uint64_t seed) {
        uint64_t x = seed;
        for (int i = 0; i < 4; i++) s[i] = splitmix64(x);
    }
    static uint64_t rotl(uint64_t x, int k) { return (x << k) | (x >> (64 - k)); }
    uint64_t next() {
        uint64_t result = rotl(s[0] + s[3], 23) + s[0];
        uint64_t t = s[1] << 17;
        s[2] ^= s[0];
        s[3] ^= s[1];
        s[1] ^= s[2];
        s[0] ^= s[3];
        s[2] ^= t;
        s[3] = rotl(s[3], 45);
        return result;
    }
    double uniform() {  // [0,1)
        return (next() >> 11) * 0x1.0p-53;
    }
    double uniform(double lo, double hi) { return lo + (hi - lo) * uniform(); }
    double normal() {  // Box-Muller (one value per call; cache the pair)
        if (has_cache) {
            has_cache = false;
            return cache;
        }
        double u1 = uniform();
        double u2 = uniform();
        if (u1 < 1e-300) u1 = 1e-300;
        double r = std::sqrt(-2.0 * std::log(u1));
        double th = 6.283185307179586476925286766559 * u2;
        cache = r * std::sin(th);
        has_cache = true;
        return r * std::cos(th);
    }
    double cache = 0.0;
    bool has_cache = false;
};

inline double clip(double v, double lo, double hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}

// ------------------------------------------------------------- small linalg
inline void cross3(const double a[3], const double b[3], double out[3]) {
    out[0] = a[1] * b[2] - a[2] * b[1];
    out[1] = a[2] * b[0] - a[0] * b[2];
    out[2] = a[0] * b[1] - a[1] * b[0];
}
inline double dot3(const double a[3], const double b[3]) {
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}
inline double norm3(const double a[3]) { return std::sqrt(dot3(a, a)); }
inline void unit3(const double a[3], double out[3]) {
    double n = norm3(a);
    out[0] = a[0] / n;
    out[1] = a[1] / n;
    out[2] = a[2] / n;
}

}  // namespace

extern "C" {

// ------------------------------------------------------------------ sampler
// scenarios: out (n, 9) — the 9-dim DNN1 scenario vector (quad_nn.py:18-48).
void fastquad_sample_scenarios(uint64_t seed, int64_t n, double* out) {
    Xoshiro256pp rng(seed);
    const double PI = 3.14159265358979323846;
    for (int64_t i = 0; i < n; i++) {
        double* s = out + 9 * i;
        s[0] = rng.uniform(-5, 5);
        s[1] = rng.uniform(-5, 5) - 9.0;
        s[2] = rng.uniform(-5, 5);
        s[3] = rng.uniform(-2, 2);
        s[4] = rng.uniform(-2, 2) + 6.0;
        s[5] = rng.uniform(-2, 2);
        s[6] = rng.uniform(-0.1, 0.1);
        s[7] = clip(0.9 + 0.3 * rng.normal(), 0.5, 1.25);
        double angle = clip(1.3 * (1.2 - s[7]), 0.0, PI / 3);
        double angle1 = (PI / 2 - angle) / 3.0;
        double judge = rng.normal();
        double eps = rng.normal();
        if (judge > 0)
            s[8] = clip(angle + angle1 + (2 * angle1 / 3) * eps, angle, PI / 2);
        else
            s[8] = clip(-angle - angle1 + (2 * angle1 / 3) * eps, -PI / 2, -angle);
    }
}

// ------------------------------------------------------------------- plant
// One Euler step of the 13-state quadrotor (quad_model.py:106-119, dt*f).
// params: [Jx, Jy, Jz, mass, l, c, g]
void fastquad_euler_step(const double* x, const double* u, double dt,
                         const double* params, double* out) {
    const double Jx = params[0], Jy = params[1], Jz = params[2];
    const double m = params[3], l = params[4], cc = params[5], g = params[6];
    const double* r = x;
    const double* v = x + 3;
    const double* q = x + 6;  // wxyz
    const double* w = x + 10;

    double T = u[0] + u[1] + u[2] + u[3];
    // third row of C_B_I (world->body DCM): c(q)
    double c1 = 2 * (q[1] * q[3] + q[0] * q[2]);
    double c2 = 2 * (q[2] * q[3] - q[0] * q[1]);
    double c3 = 1 - 2 * (q[1] * q[1] + q[2] * q[2]);

    double dv[3] = {T / m * c1, T / m * c2, T / m * c3 - g};
    double dq[4] = {
        0.5 * (-w[0] * q[1] - w[1] * q[2] - w[2] * q[3]),
        0.5 * (w[0] * q[0] + w[2] * q[2] - w[1] * q[3]),
        0.5 * (w[1] * q[0] - w[2] * q[1] + w[0] * q[3]),
        0.5 * (w[2] * q[0] + w[1] * q[1] - w[0] * q[2]),
    };
    double Mx = (-u[1] + u[3]) * l / 2;
    double My = (-u[0] + u[2]) * l / 2;
    double Mz = (u[0] - u[1] + u[2] - u[3]) * cc;
    double dw[3] = {
        (Mx - (w[1] * Jz * w[2] - w[2] * Jy * w[1])) / Jx,
        (My - (w[2] * Jx * w[0] - w[0] * Jz * w[2])) / Jy,
        (Mz - (w[0] * Jy * w[1] - w[1] * Jx * w[0])) / Jz,
    };
    for (int i = 0; i < 3; i++) out[i] = r[i] + dt * v[i];
    for (int i = 0; i < 3; i++) out[3 + i] = v[i] + dt * dv[i];
    for (int i = 0; i < 4; i++) out[6 + i] = q[i] + dt * dq[i];
    for (int i = 0; i < 3; i++) out[10 + i] = w[i] + dt * dw[i];
}

// Roll a control sequence: x0 (13), U (H,4) -> X (H+1,13).
void fastquad_rollout(const double* x0, const double* U, int64_t H, double dt,
                      const double* params, double* X) {
    std::memcpy(X, x0, 13 * sizeof(double));
    for (int64_t k = 0; k < H; k++) {
        fastquad_euler_step(X + 13 * k, U + 4 * k, dt, params, X + 13 * (k + 1));
    }
}

// -------------------------------------------------------------- collision
// Reference collis_det (solid_geometry.py:104-168) for one tip trajectory.
// gate: (4,3) corners; traj: (n,3); uses first `horizon` points.
double fastquad_collision_score(const double* gate, const double* traj,
                                int64_t horizon, double d_min) {
    double c[3] = {0, 0, 0};
    for (int i = 0; i < 4; i++)
        for (int j = 0; j < 3; j++) c[j] += gate[3 * i + j] / 4.0;

    auto corner = [&](int i) { return gate + 3 * (((i % 4) + 4) % 4); };

    // plane i: centroid, p_i, p_{i+1}; normal = unit(cross(vec2, vec1))
    auto plane = [&](int i, double* normal, double* n1, double* n2, double* n3) {
        double v1[3], v2[3], v3[3], t[3];
        for (int j = 0; j < 3; j++) {
            v1[j] = corner(i)[j] - c[j];
            v2[j] = corner(i + 1)[j] - c[j];
            v3[j] = corner(i + 1)[j] - corner(i)[j];
        }
        cross3(v2, v1, t);
        unit3(t, normal);
        cross3(v1, normal, t);
        unit3(t, n1);
        cross3(normal, v2, t);
        unit3(t, n2);
        cross3(normal, v3, t);
        unit3(t, n3);
    };

    double n_main[3], tmp1[3], tmp2[3], tmp3[3];
    plane(0, n_main, tmp1, tmp2, tmp3);

    double rel0[3] = {traj[0] - c[0], traj[1] - c[1], traj[2] - c[2]};
    if (dot3(n_main, rel0) < 0) return 0.0;

    auto vertical = [&](int i, const double* pt) {
        // distance from pt to infinite line through p_i, p_{i+1}; dir=unit(p_i-p_{i+1})
        double d[3], rel[3], cr[3];
        for (int j = 0; j < 3; j++) d[j] = corner(i)[j] - corner(i + 1)[j];
        double nd = norm3(d);
        for (int j = 0; j < 3; j++) d[j] /= nd;
        for (int j = 0; j < 3; j++) rel[j] = pt[j] - corner(i)[j];
        cross3(rel, d, cr);
        return norm3(cr);
    };
    auto segdist = [&](int i, const double* pt) {
        double a = vertical(i, pt);
        double b1[3], c1v[3], d1[3];
        for (int j = 0; j < 3; j++) {
            b1[j] = pt[j] - corner(i)[j];
            c1v[j] = pt[j] - corner(i + 1)[j];
            d1[j] = corner(i)[j] - corner(i + 1)[j];
        }
        double b = norm3(b1), cd = norm3(c1v), d = norm3(d1);
        if (b > cd) return (b * b - d * d) > a * a ? cd : a;
        return (cd * cd - d * d) > a * a ? b : a;
    };

    double collision = 0.0;
    for (int64_t t = 0; t < horizon; t++) {
        double rel[3] = {traj[3 * t] - c[0], traj[3 * t + 1] - c[1],
                         traj[3 * t + 2] - c[2]};
        if (dot3(n_main, rel) < 0) {
            const double* pt = traj + 3 * t;
            const double* pp = traj + 3 * (t - 1);
            double dir[3] = {pt[0] - pp[0], pt[1] - pp[1], pt[2] - pp[2]};
            double nd = norm3(dir);
            for (int j = 0; j < 3; j++) dir[j] /= nd;
            double tt = dot3(n_main, rel) / dot3(dir, n_main);
            double inter[3] = {pt[0] - tt * dir[0], pt[1] - tt * dir[1],
                               pt[2] - tt * dir[2]};
            double irel[3] = {inter[0] - c[0], inter[1] - c[1], inter[2] - c[2]};
            for (int s = 0; s < 4; s++) {
                double normal[3], n1[3], n2[3], n3[3];
                plane(s, normal, n1, n2, n3);
                if (dot3(n1, irel) > 0 && dot3(n2, irel) > 0) {
                    double pi_rel[3] = {corner(s)[0] - inter[0],
                                        corner(s)[1] - inter[1],
                                        corner(s)[2] - inter[2]};
                    if (dot3(pi_rel, n3) > 0) {
                        double m = 1e300;
                        for (int e = 0; e < 4; e++) {
                            double ve = vertical(e, inter);
                            if (ve < m) m = ve;
                        }
                        double pen = d_min - m;
                        collision = pen > 0 ? -pen * pen : 0.0;
                    } else {
                        double m = 1e300;
                        for (int e = s - 1; e <= s + 1; e++) {
                            double se = segdist(e, inter);
                            if (se < m) m = se;
                        }
                        collision = -2.0 * d_min * m - d_min * d_min;
                    }
                }
            }
            break;
        }
    }
    return collision;
}

// Full trajectory reward (quad_policy.py:78-91): states (H+1,13).
// Returns reward; also writes [collision_sum, path] into stats[2].
double fastquad_trajectory_reward(const double* states, int64_t horizon,
                                  const double* gate, const double* goal,
                                  double wing_len, double d_min,
                                  double collision_weight, double path_weight,
                                  double offset, double* stats) {
    const double inv_sqrt2 = 0.70710678118654752440;
    double a = wing_len * 0.5 * inv_sqrt2;
    const double tips_B[4][3] = {
        {a, a, 0}, {-a, a, 0}, {-a, -a, 0}, {a, -a, 0}};

    double collision = 0.0;
    // per-rotor tip trajectories
    for (int rtr = 0; rtr < 4; rtr++) {
        double* tip = new double[(horizon + 1) * 3];
        for (int64_t t = 0; t <= horizon; t++) {
            const double* x = states + 13 * t;
            const double* q = x + 6;
            // C_I_B = C_B_I^T: world position = r + C_I_B @ tip_B
            double R[3][3] = {
                {1 - 2 * (q[2] * q[2] + q[3] * q[3]),
                 2 * (q[1] * q[2] - q[0] * q[3]),
                 2 * (q[1] * q[3] + q[0] * q[2])},
                {2 * (q[1] * q[2] + q[0] * q[3]),
                 1 - 2 * (q[1] * q[1] + q[3] * q[3]),
                 2 * (q[2] * q[3] - q[0] * q[1])},
                {2 * (q[1] * q[3] - q[0] * q[2]),
                 2 * (q[2] * q[3] + q[0] * q[1]),
                 1 - 2 * (q[1] * q[1] + q[2] * q[2])}};
            for (int j = 0; j < 3; j++) {
                tip[3 * t + j] = x[j] + R[j][0] * tips_B[rtr][0] +
                                 R[j][1] * tips_B[rtr][1] +
                                 R[j][2] * tips_B[rtr][2];
            }
        }
        collision += fastquad_collision_score(gate, tip, horizon, d_min);
        delete[] tip;
    }

    double path = 0.0;
    for (int p = 0; p < 4; p++) {
        const double* r = states + 13 * (horizon - 1 - p);
        double dx = r[0] - goal[0], dy = r[1] - goal[1], dz = r[2] - goal[2];
        path += dx * dx + dy * dy + dz * dz;
    }
    if (stats) {
        stats[0] = collision;
        stats[1] = path;
    }
    return collision_weight * collision - path_weight * path + offset;
}

}  // extern "C"
