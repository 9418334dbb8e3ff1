# -*- coding: utf-8 -*-
"""Host plumbing: the local-CPU-backend hooks that place budget-only
device programs on the CPU (hostinfo.ensure_cpu_platform /
local_cpu_device, wired from tpukit/__init__ and the CLI), and where the
persistent compile cache lives."""
import os
import subprocess
import sys

import jax
import pytest


def test_bare_import_stays_jax_free():
    """`import tpukit` in a process that has NOT imported jax must not
    pull it in (CLI --help and io/viz-only consumers stay fast). -S
    skips site/sitecustomize, so no site hook can import jax first."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (f"import sys; sys.path.insert(0, {repo!r}); import tpukit; "
            "assert 'jax' not in sys.modules, 'tpukit import pulled jax'; "
            "print('LAZY-OK')")
    r = subprocess.run([sys.executable, "-S", "-c", code],
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "LAZY-OK" in r.stdout


def test_local_cpu_device_available_and_idempotent():
    """local_cpu_device self-heals (re-runs ensure_cpu_platform) and
    returns a CPU device under the suite's cpu pin; repeated calls are
    stable."""
    from tpukit.hostinfo import ensure_cpu_platform, local_cpu_device

    d1 = local_cpu_device()
    ensure_cpu_platform()          # idempotent, config-only
    d2 = local_cpu_device()
    assert d1 is not None and d1.platform == "cpu"
    assert d2 == d1
    # the suite's platform pin survives untouched (cpu stays first /
    # default)
    assert jax.config.jax_platforms.split(",")[0] == "cpu"
    assert jax.default_backend() == "cpu"


_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cache_dir_in_child(env_dir, entry):
    """The compile-cache dir a fresh process ends up with after ``entry``
    (the CLI's init or the shared helper) under JAX_COMPILATION_CACHE_DIR
    = ``env_dir`` (unset when None)."""
    env = dict(os.environ)
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    if env_dir is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = env_dir
    code = (f"import sys; sys.path.insert(0, {_REPO!r}); import jax; "
            f"{entry}; print(jax.config.jax_compilation_cache_dir)")
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    return r.stdout.strip().splitlines()[-1]


_ENTRIES = [
    "from tpukit.cli.main import _init_jax_compile_cache; "
    "_init_jax_compile_cache()",
    "from tpukit.hostinfo import configure_jax_compile_cache; "
    "configure_jax_compile_cache()",
]


@pytest.mark.parametrize("entry", _ENTRIES, ids=["cli", "helper"])
def test_compile_cache_honours_env_verbatim(tmp_path, entry):
    """JAX_COMPILATION_CACHE_DIR is used exactly as given — no suffix, no
    fingerprint, no other directory."""
    want = str(tmp_path / "jc")
    assert _cache_dir_in_child(want, entry) == want


def test_compile_cache_default_is_checkout_dir(monkeypatch):
    """Without the variable the cache is the fixed <checkout>/.jax_cache,
    never under HOME or a temporary name."""
    from tpukit.hostinfo import compile_cache_dir

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert compile_cache_dir() == os.path.join(_REPO, ".jax_cache")
    assert _cache_dir_in_child(None, _ENTRIES[0]) == compile_cache_dir()
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/x/y")
    assert compile_cache_dir() == "/x/y"
