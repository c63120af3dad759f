"""The persistent compile cache follows one rule (cutesdr_tpu/cache.py)."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROBE = ("import jax; from cutesdr_tpu.cache import enable_compile_cache; "
         "print(enable_compile_cache()); "
         "print(jax.config.jax_compilation_cache_dir)")


def _probe(cwd, **env_extra):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env.update(PYTHONPATH=ROOT, JAX_PLATFORMS="cpu", **env_extra)
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout.split()


def test_compile_cache_env_var_is_honoured(tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, JAX's own setting is used and
    no directory is set in code."""
    want = str(tmp_path / "from_env")
    used, configured = _probe(str(tmp_path),
                              JAX_COMPILATION_CACHE_DIR=want)
    assert used == want and configured == want


def test_compile_cache_default_is_checkout_dir_from_any_cwd(tmp_path):
    """Without the variable the cache is <checkout>/.jax_cache, the same
    from any working directory."""
    want = os.path.join(ROOT, ".jax_cache")
    for cwd in (str(tmp_path), ROOT):
        used, configured = _probe(cwd)
        assert used == want and configured == want
