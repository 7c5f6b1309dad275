"""Staged-lowering dumps — the observability analog of the reference AOT's
--opt-report / --opt-dump-dir staged files (ref: dsp_jsfx_aot.py:6315-6357),
with the device pipeline's stages: source -> lowered AST -> specialization
plan -> jaxpr -> StableHLO.
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict

from ..frontend.printer import program_text


def dump_stages(kernel, out_dir: str | Path,
                example_len: int = 1024) -> Dict[str, str]:
    """Write staged artifacts for one specialized kernel; returns paths."""
    import jax

    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    paths: Dict[str, str] = {}
    P = kernel.P

    def put(name: str, text: str) -> None:
        p = out / name
        p.write_text(text)
        paths[name] = str(p)

    put("01_source.jsfx", P.source)

    sections = []
    for sec in ("init", "slider", "block", "sample"):
        sections.append(f"@{sec}")
        sections.append(program_text(P.sections.get(sec, [])))
        sections.append("")
    for name, f in P.fn_defs.items():
        sections.append(f"// specialized function {name}({', '.join(f.params)})")
        sections.append(program_text([f.body]))
        sections.append("")
    put("02_sections_lowered.jsfx", "\n".join(sections))

    plan_lines = [
        f"segment_len={kernel.L} block_size={kernel.B} nch={kernel.nch}",
        f"has_block={kernel.has_block} "
        f"control_vars={len(kernel.control_vars)} "
        f"ctrl_streams={len(kernel.ctrl_order)}",
        f"carried_scalars={len(kernel.carried_vars)}",
        f"ring_regions={[(o, m) for (o, m) in kernel.ring_regions]}",
        f"scan_group({len(kernel.scan_group)})="
        f"{sorted(kernel.scan_group, key=repr)}",
        "",
        "var plans:",
    ]
    for key in sorted(kernel.plans, key=repr):
        plan_lines.append(f"  {key!r}: {kernel.plans[key].kind}")
    put("03_plan.txt", "\n".join(plan_lines))

    L = min(example_len, kernel.L)
    seg = kernel._make_seg_fn(L)
    carry = kernel.initial_carry()
    import numpy as np

    x = np.zeros((kernel.nch, L), dtype=np.float64)
    rows = -(-L // kernel.B)
    ctrl = np.zeros((rows, len(kernel.ctrl_order)), dtype=np.float64)
    rand = np.zeros((L, kernel.n_rand), dtype=np.float64)
    jaxpr = jax.make_jaxpr(seg)(carry, (x, ctrl, rand))
    put("04_jaxpr.txt", str(jaxpr))

    lowered = jax.jit(seg).lower(carry, (x, ctrl, rand))
    put("05_stablehlo.txt", lowered.as_text())
    try:
        put("06_compiled_hlo.txt", lowered.compile().as_text())
    except Exception as exc:  # noqa: BLE001 — backend-dependent
        put("06_compiled_hlo.txt", f"(compile text unavailable: {exc})")
    return paths
