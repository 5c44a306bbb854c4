"""Generate the external-simulator assets (component #27).

The reference ships hand-authored URDF/OBJ assets for its PyBullet harness
(gym_pybullet_drone/model/: hb.urdf, window.urdf, window_frozen.urdf —
GateAviary.py:23-104 loads them).  Here the equivalents are GENERATED from
the framework's typed config so the physical parameters can never drift from
the trained model:

  assets/hb.urdf            quadrotor; inertial values from QuadParams
                            (quad_policy.py:36-37), actuator properties in the
                            gym-pybullet-drones `properties` schema the
                            external harness parses (arm = l/2 = 0.175,
                            kf = 6.11e-8, km = kf*c, thrust2weight = 2 —
                            model/hb.urdf's numbers, which are consistent with
                            QuadParams: c == km/kf)
  assets/window.urdf        moving gate: four box bars framing a width x 2h
                            opening (gate_from_width geometry), floating base
  assets/window_frozen.urdf same, with a world-fixed joint (the reference's
                            "frozen" variant)
  assets/quad.obj + .mtl    visual mesh of the plus-config vehicle
  assets/window.obj + .mtl  visual mesh of the window frame
                            (reference model/quad.obj, window.obj role)

Usage: python scripts/gen_assets.py [--out assets] [--width 1.0] [--half-height 1.0]
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from learningagileflight_se3.config import QuadParams
from learningagileflight_se3.utils.mesh import (
    QUAD_MTL,
    WINDOW_MTL,
    quad_obj,
    window_obj,
)
from learningagileflight_se3.utils.urdf import (  # noqa: F401 (re-export)
    KF,
    quad_urdf,
    window_urdf,
)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="assets")
    ap.add_argument("--width", type=float, default=1.0)
    ap.add_argument("--half-height", type=float, default=1.0)
    args = ap.parse_args()
    os.makedirs(args.out, exist_ok=True)
    p = QuadParams()
    files = {
        "hb.urdf": quad_urdf(p),
        "window.urdf": window_urdf(args.width, args.half_height),
        "window_frozen.urdf": window_urdf(args.width, args.half_height, frozen=True),
        # visual meshes (the reference's model/quad.obj + window.obj role)
        "quad.obj": quad_obj(p),
        "quad.mtl": QUAD_MTL,
        "window.obj": window_obj(args.width, args.half_height),
        "window.mtl": WINDOW_MTL,
    }
    for name, text in files.items():
        path = os.path.join(args.out, name)
        with open(path, "w") as f:
            f.write(text)
        print(f"wrote {path} ({len(text)} bytes)")


if __name__ == "__main__":
    main()
