"""Entry-point setup: the compile-cache location and chip_smoke.py's refusal
to run without a GPU."""
import os
import shutil
import subprocess
import sys

import pytest

from altro_mpc.utils import runtime

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_compile_cache_env_honoured(monkeypatch):
    calls = []
    monkeypatch.setattr("jax.config.update",
                        lambda *a: calls.append(a))
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/somewhere/cache")
    assert runtime.compile_cache_dir() == ("/somewhere/cache", True)
    assert runtime.enable_compile_cache() == "/somewhere/cache"
    assert calls == []          # JAX reads the variable itself


def test_compile_cache_fixed_default(monkeypatch):
    calls = []
    monkeypatch.setattr("jax.config.update",
                        lambda *a: calls.append(a))
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = os.path.join(ROOT, ".jax_cache")
    assert runtime.compile_cache_dir() == (path, False)
    assert runtime.enable_compile_cache() == path
    assert calls == [("jax_compilation_cache_dir", path)]
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_chip_smoke_refuses_cpu(tmp_path, where):
    """On a CPU-only host the smoke script exits non-zero and prints no
    result line, both in a checkout and copied alone into a directory."""
    script = os.path.join(ROOT, "chip_smoke.py")
    cwd = ROOT
    if where == "alone":
        shutil.copy(script, tmp_path)
        script, cwd = str(tmp_path / "chip_smoke.py"), str(tmp_path)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
