"""Runtime set-up: the persistent compile cache location and the GPU gate of
chip_smoke.py."""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax

from pantax_tpu.utils import enable_compilation_cache

CHECKOUT = Path(__file__).resolve().parents[1]


def _restore_cache_dir(old):
    jax.config.update("jax_compilation_cache_dir", old)


def test_compile_cache_honours_env(monkeypatch, tmp_path):
    old = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    try:
        assert enable_compilation_cache() == str(tmp_path)
        # JAX reads the variable itself; no other directory is set in code
        assert jax.config.jax_compilation_cache_dir == old
    finally:
        _restore_cache_dir(old)


def test_compile_cache_defaults_to_checkout(monkeypatch):
    old = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    try:
        path = enable_compilation_cache()
        assert path == str(CHECKOUT / ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
        assert os.path.isdir(path)
    finally:
        _restore_cache_dir(old)


def test_chip_smoke_refuses_cpu_backend():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, str(CHECKOUT / "chip_smoke.py")],
        cwd=CHECKOUT, env=env, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0
    assert "not 'gpu'" in proc.stderr
    assert "setup:" not in proc.stdout  # stopped before any phase
    for line in proc.stdout.splitlines():
        try:
            assert not json.loads(line).get("ok")
        except (ValueError, AttributeError):
            pass
