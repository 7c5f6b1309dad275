"""Where the persistent XLA compile cache lives (utils/cache.py): at
JAX_COMPILATION_CACHE_DIR when it is set, and only there; otherwise at a
fixed path inside the checkout."""
import os
import subprocess
import sys
from pathlib import Path

from zorak_tpu.utils import cache

REPO = Path(__file__).resolve().parents[1]

# compiles one function with the cache on and prints the directory the
# module chose; the in-checkout root is redirected to argv[1]
_PROBE = """
import sys
from pathlib import Path
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
from zorak_tpu.utils import cache
cache.CACHE_ROOT = Path(sys.argv[1])
print(cache.enable_persistent_cache(min_compile_secs=0.0))
jax.block_until_ready(jax.jit(lambda v: jnp.sin(v) * 3.0 + v)(jnp.ones(7)))
"""


def _probe(tmp_path, env_dir=None):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["PYTHONPATH"] = str(REPO)
    if env_dir is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = str(env_dir)
    root = tmp_path / "checkout_cache"
    out = subprocess.run([sys.executable, "-c", _PROBE, str(root)],
                         env=env, capture_output=True, text=True,
                         timeout=120, check=True)
    return out.stdout.strip().splitlines()[-1], root


def _files(path: Path):
    return [p for p in path.rglob("*") if p.is_file()] if path.exists() \
        else []


def test_env_dir_is_the_only_cache(tmp_path):
    env_dir = tmp_path / "env_cache"
    chosen, root = _probe(tmp_path, env_dir)
    assert chosen == str(env_dir)
    assert _files(env_dir), "nothing was compiled into the env directory"
    assert not _files(root)


def test_default_is_fixed_path_in_checkout(tmp_path):
    chosen, root = _probe(tmp_path)
    expect = root / "xla" / f"cpu-{cache.host_fingerprint()}"
    assert chosen == str(expect)
    assert _files(expect)


def test_default_cache_dir_keys():
    cpu = cache.default_cache_dir("cpu")
    assert cpu.parent == cache.CACHE_ROOT / "xla"
    assert cpu.name == f"cpu-{cache.host_fingerprint()}"
    assert cache.default_cache_dir("gpu") == cache.CACHE_ROOT / "xla" / "gpu"
    # inside the checkout, and the same on every call
    assert cache.CACHE_ROOT == REPO / ".cache"
    assert cache.default_cache_dir("cpu") == cpu
