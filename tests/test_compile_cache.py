"""The one compile-cache helper (digiham_jax/utils.py)."""
import os
import subprocess
import sys
from pathlib import Path

import pytest

from digiham_jax.utils import compilation_cache_dir, enable_compilation_cache

ROOT = Path(__file__).resolve().parent.parent


def test_env_var_wins(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compilation_cache_dir() == str(tmp_path)


def test_default_is_fixed_checkout_dir(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    first = compilation_cache_dir()
    assert first == str(ROOT / ".jax_cache")
    assert compilation_cache_dir() == first  # no pid / time component


def test_default_dir_is_gitignored():
    assert ".jax_cache/" in (ROOT / ".gitignore").read_text().split()


def _config_after_enable(env):
    """jax's cache setting in a fresh process after the helper ran."""
    code = ("import jax\n"
            "from digiham_jax.utils import enable_compilation_cache\n"
            "print(enable_compilation_cache())\n"
            "print(jax.config.jax_compilation_cache_dir)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    return r.stdout.split()


@pytest.mark.parametrize("use_env", [True, False])
def test_enable_sets_exactly_one_directory(tmp_path, use_env):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["PYTHONPATH"] = str(ROOT)
    want = str(ROOT / ".jax_cache")
    if use_env:
        env["JAX_COMPILATION_CACHE_DIR"] = want = str(tmp_path)
    returned, configured = _config_after_enable(env)
    assert returned == configured == want


def test_no_other_cache_path_in_code():
    """Nothing but the helper names a compile-cache directory."""
    hits = []
    for path in list(ROOT.glob("digiham_jax/**/*.py")) + \
            list(ROOT.glob("tools/*.py")) + [ROOT / "bench.py",
                                              ROOT / "chip_smoke.py"]:
        text = path.read_text()
        if "jax_compilation_cache_dir" in text and \
                path.name != "utils.py":
            hits.append(str(path))
    assert hits == []


def test_enable_returns_the_directory_in_process(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert enable_compilation_cache() == str(tmp_path)
