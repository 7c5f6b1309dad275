"""One-command CI gate (fills the reference's
.github/workflows/release.yml role for this offline renderer).

Tiers:
  python scripts/ci.py            # fast: full pytest suite + multichip dryrun
  python scripts/ci.py --slow     # + RUN_SLOW tier (devexec catalog plugins,
                                  #   heavy perturbed slider configs) — the
                                  #   "weekly" tier; hours on one core
  python scripts/ci.py --gpu      # + chip_smoke.py, on a machine with
                                  #   the GPU

Exit code 0 = gate passed.  Stages run one after another; each stage
streams its output and a failed stage stops the run.
"""
from __future__ import annotations

import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run(name: str, cmd: list[str], env: dict | None = None) -> None:
    print(f"\n=== ci: {name}: {' '.join(cmd)}", flush=True)
    t0 = time.time()
    e = dict(os.environ)
    parts = [p for p in e.get("PYTHONPATH", "").split(":") if p]
    if REPO not in parts:
        parts.append(REPO)
    e["PYTHONPATH"] = ":".join(parts)
    if env:
        e.update(env)
    r = subprocess.run(cmd, cwd=REPO, env=e)
    dt = time.time() - t0
    if r.returncode != 0:
        print(f"=== ci: {name} FAILED (exit {r.returncode}, {dt:.0f}s)",
              flush=True)
        sys.exit(r.returncode)
    print(f"=== ci: {name} ok ({dt:.0f}s)", flush=True)


def main() -> None:
    slow = "--slow" in sys.argv
    gpu = "--gpu" in sys.argv
    py = sys.executable

    # 1. unit + integration suite: frontend negatives, golden-executor
    #    parity, specializer nulls, devexec synthetics, engine, comm, gfx
    run("pytest", [py, "-m", "pytest", "tests/", "-q"])

    # 2. multi-chip sharding dryrun on a virtual 8-device CPU mesh
    run("multichip-dryrun", [py, "__graft_entry__.py"],
        env={"XLA_FLAGS": (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8"
                           ).strip()})

    if slow:
        # 3. weekly tier: devexec catalog fallbacks + HEAVY perturbed
        #    slider configs in the deep null sweep
        run("pytest-slow",
            [py, "-m", "pytest", "tests/test_catalog_nulls.py",
             "tests/test_long_null.py", "-q"],
            env={"RUN_SLOW": "1"})

    if gpu:
        # 4. the render path on the card, null-tested phase by phase
        run("chip-smoke", [py, "chip_smoke.py"])

    print("\n=== ci: gate PASSED", flush=True)


if __name__ == "__main__":
    main()
