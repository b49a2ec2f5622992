"""Run-time set-up that must not depend on where the tree was built: the
persistent compile cache's location and the native libraries' rebuild key."""

import os
import shutil
import subprocess
import sys

import pytest

from ratatosk_tpu import nativebuild

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("env_dir", [None, "custom"])
def test_compile_cache_dir(tmp_path, env_dir):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=ROOT)
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    want = os.path.join(ROOT, ".jax_cache")
    if env_dir:
        want = str(tmp_path / env_dir)
        env["JAX_COMPILATION_CACHE_DIR"] = want
    p = subprocess.run(
        [sys.executable, "-c",
         "import ratatosk_tpu, jax; print(jax.config.jax_compilation_cache_dir)"],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=120)
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip() == want


@pytest.fixture
def native_copy(tmp_path):
    d = tmp_path / "native"
    shutil.copytree(nativebuild.NATIVE_DIR, d,
                    ignore=shutil.ignore_patterns("*.so", "*.stamp", ".*"))
    return str(d)


def _spy_builds(monkeypatch):
    calls = []
    real = subprocess.run

    def run(cmd, *a, **kw):
        calls.append(cmd)
        return real(cmd, *a, **kw)

    monkeypatch.setattr(nativebuild.subprocess, "run", run)
    return calls


def test_stale_stamp_triggers_rebuild(native_copy, monkeypatch):
    calls = _spy_builds(monkeypatch)
    lib = nativebuild.ensure_built("align", native_copy)
    assert os.path.exists(lib) and len(calls) == 1
    nativebuild.ensure_built("align", native_copy)
    assert len(calls) == 1                      # stamp matches: no build
    with open(lib + ".stamp", "w") as f:
        f.write("built elsewhere")
    nativebuild.ensure_built("align", native_copy)
    assert len(calls) == 2
    with open(lib + ".stamp") as f:
        assert f.read() == nativebuild.build_key("align", native_copy)


def test_other_cpu_triggers_rebuild(native_copy, monkeypatch):
    calls = _spy_builds(monkeypatch)
    nativebuild.ensure_built("align", native_copy)
    monkeypatch.setattr(nativebuild, "_cpu_id", lambda: "another cpu")
    nativebuild.ensure_built("align", native_copy)
    nativebuild.ensure_built("align", native_copy)
    assert len(calls) == 2
