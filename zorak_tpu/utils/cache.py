"""Persistent XLA compile cache.

Coupled-pipeline plugins have multi-minute first compiles; the cache
makes every later process (tests, bench, CLI) reuse them.  Where
`JAX_COMPILATION_CACHE_DIR` is set, JAX keeps its cache there and this
module sets no other directory.  Otherwise the cache lives at a fixed
path inside the checkout (`.cache/xla/<key>`, listed in .gitignore): the
path is part of what makes a later process hit.  The CPU key carries a
host fingerprint, because XLA:CPU AOT entries compiled for another
machine's feature set SIGILL when loaded."""
import hashlib
import os
import platform
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parents[2]
CACHE_ROOT = REPO_ROOT / ".cache"


def host_fingerprint() -> str:
    # model name/family/stepping matter, not just the flags line: two
    # hosts with identical cpuinfo flags can still get different LLVM
    # tuning (prefer-no-scatter/gather), and loading the other host's
    # XLA:CPU AOT entries then corrupts the process (observed: stale
    # entries from a migrated container SIGILL/segfault mid-run).
    keys = ("flags", "Features", "model name", "cpu family", "model",
            "stepping", "vendor_id")
    feat = []
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                k = line.split(":", 1)[0].strip()
                if k in keys:
                    feat.append(line.strip())
                if line.strip() == "" and feat:
                    break  # first core only
    except OSError:
        pass
    raw = f"{platform.machine()}|{'|'.join(feat)}"
    return hashlib.sha1(raw.encode()).hexdigest()[:12]


def raise_map_count(target: int = 1 << 20) -> None:
    """XLA:CPU's ORC JIT maps thousands of sections per big executable;
    many large compiles in one process exhaust the default
    vm.max_map_count=65530 (symptom: 'LLVM compilation error: Cannot
    allocate memory' + munmap ENOMEM, then a segfault).  Raise it when
    we can; harmless no-op otherwise."""
    try:
        with open("/proc/sys/vm/max_map_count") as f:
            cur = int(f.read().strip())
        if cur < target:
            with open("/proc/sys/vm/max_map_count", "w") as f:
                f.write(str(target))
    except OSError:
        pass


def default_cache_dir(backend: str) -> Path:
    """The in-checkout cache directory for one backend."""
    key = f"cpu-{host_fingerprint()}" if backend == "cpu" else backend
    return CACHE_ROOT / "xla" / key


def enable_persistent_cache(min_compile_secs: float = 10.0) -> str:
    """Turn the persistent compile cache on; returns its directory."""
    import jax

    raise_map_count()
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      float(min_compile_secs))
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        # JAX reads the variable itself; keep whatever it chose
        return env
    path = default_cache_dir(jax.default_backend())
    path.mkdir(parents=True, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", str(path))
    return str(path)
