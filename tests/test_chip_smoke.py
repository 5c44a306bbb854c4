"""The phases of chip_smoke.py at a tiny size on the CPU: the control flow,
the checks and the printed lines of the script the GPU runs at full size
(device detection is the part these cannot reach; tests/test_entry_points.py
covers the refusal without a GPU)."""

import dataclasses
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from bench import bench_problems, bench_solver_config  # noqa: E402

CARD = "cpu"


def test_one_card_phases(capsys):
    cfg = dataclasses.replace(bench_solver_config(), horizon=8, max_iters=10)
    problems = bench_problems(16, seed=0)
    golden = chip_smoke.phase_reference(cfg, problems, CARD, n_ref=8)
    chip_smoke.phase_solves(cfg, problems, golden, CARD)
    chip_smoke.phase_training(cfg, CARD, batch=8)
    chip_smoke.phase_closed_loop(CARD, n=2, steps=30)
    out = capsys.readouterr().out
    for tag in ("[2 reference]", "[3 solves]", "[4 training]", "[5 closed loop]"):
        assert tag in out


def test_sharded_rl_phase_on_virtual_devices(capsys):
    """The --chips 4 path on 4 virtual CPU devices: sharded and single-card
    RL steps agree at a short horizon in both learning signals."""
    chip_smoke.phase_multichip(CARD, 4, batch=8, horizon=6)
    out = capsys.readouterr().out
    assert "rl[fd]" in out and "rl[analytic]" in out
