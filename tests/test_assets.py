"""External-simulator assets (component #27): the generated URDFs must agree
with the trained model's physical parameters (QuadParams) and the gate
geometry (gate_from_width) — the reference's hand-authored model/hb.urdf and
window.urdf can silently drift from quad_policy.py:36-37; generated assets
cannot."""

import os
import subprocess
import sys
import xml.etree.ElementTree as ET

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from learningagileflight_se3.config import QuadParams
from learningagileflight_se3.utils.mesh import parse_obj, quad_obj, window_obj
from scripts.gen_assets import quad_urdf, window_urdf


class TestQuadURDF:
    def setup_method(self):
        self.p = QuadParams()
        self.root = ET.fromstring(quad_urdf(self.p))

    def test_inertial_matches_quadparams(self):
        inertial = self.root.find("./link[@name='base_link']/inertial")
        assert float(inertial.find("mass").get("value")) == self.p.mass
        inertia = inertial.find("inertia")
        assert float(inertia.get("ixx")) == self.p.Jx
        assert float(inertia.get("iyy")) == self.p.Jy
        assert float(inertia.get("izz")) == self.p.Jz

    def test_actuator_properties(self):
        """arm = l/2 (hb.urdf 0.175 vs quad_policy.py l=0.35) and the torque
        coefficient identity c == km/kf (quad_model.py:91)."""
        props = self.root.find("properties")
        arm = float(props.get("arm"))
        kf = float(props.get("kf"))
        km = float(props.get("km"))
        assert arm == pytest.approx(self.p.l / 2.0)
        assert km / kf == pytest.approx(self.p.c)
        assert float(props.get("thrust2weight")) == 2.0

    def test_rotor_layout_matches_mixer(self):
        """Rotor positions must reproduce the plus-config mixer signs:
        Mx = (-f2+f4)*l/2, My = (-f1+f3)*l/2 (quad_model.py:89-90), i.e.
        torque about x from a rotor at (x, y) is -y * f, about y is +x * f...
        actually Mx = -sum(y_i f_i), My = +sum(x_i f_i)."""
        arm = self.p.l / 2.0
        pos = {}
        for j in self.root.findall("joint"):
            child = j.find("child").get("link")
            xyz = [float(v) for v in j.find("origin").get("xyz").split()]
            pos[child] = xyz
        xs = np.array([pos[f"prop{i}"][0] for i in range(4)])
        ys = np.array([pos[f"prop{i}"][1] for i in range(4)])
        # Mx coefficient per rotor = -y_i  -> (0, -arm, 0, +arm) = l/2*(0,-1,0,1)
        assert np.allclose(-ys, [0, -arm, 0, arm])
        # My coefficient per rotor = +x_i  -> (arm, 0, -arm, 0) = l/2*(1,0,-1,0)
        assert np.allclose(xs, [arm, 0, -arm, 0])


class TestWindowURDF:
    def test_opening_geometry(self):
        """The four bars must frame exactly a width x 2*half_height opening."""
        w, hh, bar = 1.2, 0.5, 0.05
        root = ET.fromstring(window_urdf(w, hh, bar=bar))
        boxes = {}
        for vis in root.findall("./link[@name='frame']/collision"):
            xyz = [float(v) for v in vis.find("origin").get("xyz").split()]
            size = [float(v) for v in vis.find("geometry/box").get("size").split()]
            boxes[tuple(np.round(xyz, 6))] = size
        zs = sorted(x[2] for x in boxes)
        xs = sorted(x[0] for x in boxes)
        # inner faces of top/bottom bars at +-half_height
        assert zs[0] + bar / 2 == pytest.approx(-hh)
        assert zs[-1] - bar / 2 == pytest.approx(hh)
        # inner faces of left/right bars at +-width/2
        assert xs[0] + bar / 2 == pytest.approx(-w / 2)
        assert xs[-1] - bar / 2 == pytest.approx(w / 2)

    def test_frozen_variant_anchored(self):
        root = ET.fromstring(window_urdf(1.0, 1.0, frozen=True))
        j = root.find("./joint[@name='anchor']")
        assert j is not None and j.get("type") == "fixed"
        root = ET.fromstring(window_urdf(1.0, 1.0, frozen=False))
        assert root.find("./joint[@name='anchor']") is None


class TestVisualMeshes:
    """Generated .obj visual meshes (reference model/quad.obj + window.obj
    role): geometry must agree with the same config that drives the URDFs."""

    def test_window_mesh_frames_opening(self):
        w, hh, bar = 1.2, 0.5, 0.05
        verts, faces = parse_obj(window_obj(w, hh, bar=bar))
        v = np.asarray(verts)
        assert len(faces) == 24  # 4 boxes x 6 faces
        # outer envelope
        assert np.allclose(v[:, 0].max(), w / 2 + bar)
        assert np.allclose(v[:, 2].max(), hh + bar)
        # the opening itself contains no geometry: no vertex strictly inside
        inside = (np.abs(v[:, 0]) < w / 2 - 1e-9) & (np.abs(v[:, 2]) < hh - 1e-9)
        assert not inside.any()
        # face indices in range (1-based OBJ)
        assert max(max(f) for f in faces) == len(verts)

    def test_quad_mesh_rotors_match_mixer(self):
        p = QuadParams()
        arm = p.l / 2.0
        verts, faces = parse_obj(quad_obj(p))
        v = np.asarray(verts)
        assert max(max(f) for f in faces) == len(verts)
        # a rotor disc's vertex ring is centered on each mixer rotor position
        for x, y in [(arm, 0), (0, arm), (-arm, 0), (0, -arm)]:
            d = np.linalg.norm(v[:, :2] - np.array([x, y]), axis=1)
            ring = np.isclose(d, 0.06, atol=1e-4)  # verts quantized to 1e-5
            assert ring.sum() >= 16, f"no rotor ring at ({x}, {y})"


def test_generator_cli(tmp_path):
    out = tmp_path / "assets"
    subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", "gen_assets.py"),
         "--out", str(out)],
        check=True, capture_output=True,
    )
    for name in ("hb.urdf", "window.urdf", "window_frozen.urdf"):
        assert (out / name).exists()
        ET.parse(out / name)  # well-formed XML
    for name in ("quad.obj", "quad.mtl", "window.obj", "window.mtl"):
        assert (out / name).exists()
