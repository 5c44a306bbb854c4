"""Entry-point contracts that hold on any host: the compile-cache location
and the chip smoke test's refusal to run without a GPU.  Each case runs in a
fresh interpreter so that no JAX configuration leaks into other tests."""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(code_or_args, env_extra=None, drop=(), cwd=REPO):
    env = {k: v for k, v in os.environ.items() if k not in drop}
    env["JAX_PLATFORMS"] = "cpu"
    env.update(env_extra or {})
    args = ([sys.executable, "-c", code_or_args] if isinstance(code_or_args, str)
            else [sys.executable, *code_or_args])
    return subprocess.run(args, cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=240)


_PROBE = (
    "import json, jax\n"
    "from learningagileflight_se3.utils.compile_cache import enable_compile_cache\n"
    "d = enable_compile_cache()\n"
    "print(json.dumps([d, jax.config.jax_compilation_cache_dir]))\n"
)


class TestCompileCache:
    @pytest.mark.parametrize("env_dir", [None, "given"])
    def test_cache_dir(self, tmp_path, env_dir):
        """JAX_COMPILATION_CACHE_DIR wins and nothing else is set; without
        it the cache lives at the fixed <repo>/.jax_cache, which git
        ignores."""
        if env_dir:
            want = str(tmp_path / "cache")
            r = _run(_PROBE, {"JAX_COMPILATION_CACHE_DIR": want})
        else:
            want = os.path.join(REPO, ".jax_cache")
            r = _run(_PROBE, drop=("JAX_COMPILATION_CACHE_DIR",))
        assert r.returncode == 0, r.stderr[-2000:]
        used, config = json.loads(r.stdout.strip().splitlines()[-1])
        assert used == want and config == want
        if not env_dir:
            with open(os.path.join(REPO, ".gitignore")) as f:
                assert ".jax_cache/" in f.read().split(), (
                    ".jax_cache must be git-ignored")


class TestChipSmoke:
    def test_refuses_without_gpu(self):
        """On a host with no GPU the smoke test exits non-zero and prints no
        result line; it never carries on on the CPU."""
        r = _run(["chip_smoke.py"])
        assert r.returncode != 0
        assert '"ok"' not in r.stdout
        assert "no GPU" in r.stderr

    def test_refuses_outside_the_repo(self, tmp_path):
        """Alone in a directory, without the package, it fails too."""
        lone = tmp_path / "chip_smoke.py"
        lone.write_text(open(os.path.join(REPO, "chip_smoke.py")).read())
        r = _run([str(lone)], cwd=str(tmp_path))
        assert r.returncode != 0
        assert '"ok"' not in r.stdout
