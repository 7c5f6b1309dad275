#!/usr/bin/env python3
"""Smoke run of the render path on the GPU.

    python chip_smoke.py              # five phases on one GPU
    python chip_smoke.py --four-gpus  # the mesh phases, on four GPUs

Every phase renders through the entry points a user calls
(`PluginInstance.render`, `BatchRenderer.render_files`, `RenderGraph.run`),
asserts the engine it must take, and compares the output with its
reference: the native C golden at the null-test contract (audio 1e-5,
scalars 1e-8), the all-shadow graph, or a render on one device.  Each
phase prints one JSON line with its set-up, first-render (trace +
compile + render) and warm render times and its deltas.  The last line
is {"ok": true, "device": {"platform", "kind", "count"}}.

The script exits non-zero, and prints no such line, when JAX finds no
GPU or when any phase fails.  It runs in one process, so one process
holds each card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

PROGRAMS = Path(__file__).resolve().parent / "benchmarks" / "programs"
SRATE = 48000.0


def require_gpu(count: int = 1):
    """The JAX devices, or exit non-zero when they are not `count`+ GPUs."""
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        sys.exit(f"chip_smoke: JAX found no GPU (platform "
                 f"{devices[0].platform!r}); nothing was run")
    if len(devices) < count:
        sys.exit(f"chip_smoke: needs {count} GPUs, JAX found "
                 f"{len(devices)}")
    return devices


def result_line(devices) -> str:
    """The contract's last line for a run that passed on `devices`."""
    return json.dumps({"ok": True, "device": {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices)}})


def card_lines() -> list:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]


def emit(record: dict) -> None:
    print(json.dumps(record), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def noise(seed: int, shape) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * 0.25).astype(np.float32)


def load(name: str):
    from zorak_tpu.ir import load_plugin_file

    return load_plugin_file(PROGRAMS / name)


def timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return time.perf_counter() - t0, out


def single_render_phase(name: str, program: str, engine: str,
                        seconds: float, coupled: bool = False,
                        rerender: bool = True) -> dict:
    """One plugin through PluginInstance: specialize, render an input
    (null-tested with the final vars), render a fresh one (timed) and,
    with `rerender`, the first input again, which must give the same bits
    (the vector engine starts every render from the instance's initial
    state; the sequential executor continues from the last one)."""
    from zorak_tpu.runtime.engine import PluginInstance
    from zorak_tpu.verify import compare_audio, compare_states, golden_render

    prog = load(program)
    n = int(seconds * SRATE)
    setup_s, inst = timed(lambda: PluginInstance(prog, srate=SRATE))
    check(inst.engine == engine,
          f"{name}: engine {inst.engine}, expected {engine} "
          f"({inst.spec_error})")
    if coupled:
        check(bool(inst.kernel.coupled),
              f"{name}: @block did not take the device path")
    x1, x2 = noise(1, (2, n)), noise(2, (2, n))
    first_s, r1 = timed(lambda: inst.render(x1))
    state1 = inst.shadow.state.clone()
    render_s, _ = timed(lambda: inst.render(x2))
    check(r1.audio.shape == (2, n) and np.isfinite(r1.audio).all(),
          f"{name}: output shape {r1.audio.shape} or non-finite values")
    check(float(np.abs(r1.audio - x1).max()) > 1e-3,
          f"{name}: output equals the dry input")
    gold_state, y_ref, _ = golden_render(prog, x1, SRATE)
    rep = compare_audio(y_ref, r1.audio)
    compare_states(gold_state, state1, report=rep)
    check(rep.passed, f"{name}: {rep.summary()} {rep.var_mismatches[:4]}")
    out = {"phase": name, "engine": inst.engine, "samples": n,
           "setup_s": setup_s, "first_render_s": first_s,
           "render_s": render_s, "rtx": seconds / render_s,
           "null_max_abs_delta": rep.max_abs_delta}
    if rerender:
        r1b = inst.render(x1)
        check(np.array_equal(r1.audio, r1b.audio),
              f"{name}: the same input rendered twice gave different "
              f"audio (max delta "
              f"{float(np.abs(r1.audio - r1b.audio).max())})")
        out["rerender_bit_identical"] = True
    return out


def phase_ddt(seconds: float = 60.0) -> dict:
    return single_render_phase("ddt_class_render", "ddt_class.jsfx",
                               "tpu-vector", seconds)


def phase_batch(seconds: float = 60.0, files: int = 8) -> dict:
    """8 DDT-class files in one dispatch, each against its own render."""
    import jax

    from zorak_tpu.parallel import BatchRenderer
    from zorak_tpu.verify import compare_audio

    prog = load("ddt_class.jsfx")
    n = int(seconds * SRATE)
    setup_s, br = timed(lambda: BatchRenderer(prog, srate=SRATE))
    xb = noise(3, (files, 2, n))
    first_s, y = timed(
        lambda: jax.block_until_ready(br.render_files(xb)))
    xb2 = noise(4, (files, 2, n))
    render_s, _ = timed(
        lambda: jax.block_until_ready(br.render_files(xb2)))
    y = np.asarray(y)
    check(y.shape == xb.shape and np.isfinite(y).all(),
          f"batch: output shape {y.shape} or non-finite values")
    worst, identical = 0.0, 0
    for i in range(files):
        yi, _ = br.kernel.render(xb[i])
        rep = compare_audio(yi, y[i])
        check(rep.audio_passed, f"batch: file {i}: {rep.summary()}")
        worst = max(worst, rep.max_abs_delta)
        identical += int(np.array_equal(yi, y[i]))
    return {"phase": "ddt_class_batch", "engine": "tpu-vector",
            "files": files, "samples": n, "setup_s": setup_s,
            "first_render_s": first_s, "render_s": render_s,
            "audio_s_per_s": files * seconds / render_s,
            "max_abs_delta_vs_single": worst,
            "files_bit_identical_to_single": identical}


def phase_coupled_fft(seconds: float = 10.0) -> dict:
    return single_render_phase("coupled_block_fft", "spectral_meter.jsfx",
                               "tpu-vector", seconds, coupled=True)


def phase_devexec(seconds: float = 1.0) -> dict:
    return single_render_phase("devexec_loop", "grain_loop.jsfx",
                               "tpu-devexec", seconds, rerender=False)


def phase_gmem_graph(seconds: float = 2.0) -> dict:
    """A gmem-coupled pair on the joint lockstep scan vs all-shadow."""
    from zorak_tpu.runtime.graph import RenderGraph
    from zorak_tpu.verify import SCALAR_EPS, compare_audio

    prog = load("gmem_pair.jsfx")
    n = int(seconds * SRATE)
    x = noise(5, (2, n))
    res = {}
    for prefer in ("shadow", "auto"):
        g = RenderGraph(srate=SRATE, prefer=prefer)
        g.add("a", prog, sliders={0: 0.0})
        g.add("b", prog, sliders={0: 1.0})
        setup_s, _ = timed(g.init_all)
        run_s, outs = timed(lambda: g.run({"a": x, "b": x}))
        res[prefer] = (g, outs, setup_s, run_s)
    gd, outs_d, setup_s, first_s = res["auto"]
    gs, outs_s = res["shadow"][:2]
    check(gd.node_engines == ["tpu-lockstep", "tpu-lockstep"],
          f"graph: engines {gd.node_engines} ({gd.spec_errors})")
    worst = 0.0
    for name in ("a", "b"):
        rep = compare_audio(outs_s[name], outs_d[name])
        check(rep.audio_passed, f"graph: node {name}: {rep.summary()}")
        worst = max(worst, rep.max_abs_delta)
    seg_s = gs.hosts[0].attached_gmem.cells
    seg_d = gd.hosts[0].attached_gmem.cells
    check(bool(seg_s[:2].any()), "graph: the pair wrote no gmem")
    gmem_delta = float(np.abs(seg_s - seg_d).max())
    check(gmem_delta <= SCALAR_EPS, f"graph: gmem delta {gmem_delta}")
    return {"phase": "gmem_pair_graph", "engines": gd.node_engines,
            "samples": n, "setup_s": setup_s, "first_render_s": first_s,
            "shadow_render_s": res["shadow"][3],
            "null_max_abs_delta": worst, "gmem_max_abs_delta": gmem_delta}


def phase_mesh_batch(seconds: float = 60.0, files: int = 8,
                     n_devices: int = 4) -> dict:
    """The files axis sharded over a mesh, bit for bit against the
    one-device vmap of the same batch."""
    import jax
    from jax.sharding import Mesh

    from zorak_tpu.parallel import BatchRenderer

    prog = load("ddt_class.jsfx")
    n = int(seconds * SRATE)
    mesh = Mesh(np.array(jax.devices()[:n_devices]), ("files",))
    br = BatchRenderer(prog, srate=SRATE)
    xb = noise(3, (files, 2, n))
    one_s, y1 = timed(lambda: np.asarray(br.render_files(xb)))
    first_s, ym = timed(lambda: np.asarray(br.render_files(xb, mesh=mesh)))
    xb2 = noise(4, (files, 2, n))
    render_s, _ = timed(
        lambda: jax.block_until_ready(br.render_files(xb2, mesh=mesh)))
    check(np.isfinite(ym).all(), "mesh batch: non-finite values")
    check(np.array_equal(y1, ym),
          f"mesh batch: sharded differs from one-device vmap by "
          f"{float(np.abs(y1 - ym).max())}")
    return {"phase": "ddt_class_batch_mesh", "devices": n_devices,
            "files": files, "samples": n, "one_device_first_s": one_s,
            "first_render_s": first_s, "render_s": render_s,
            "audio_s_per_s": files * seconds / render_s,
            "bit_identical_to_one_device": True}


def phase_mesh_gmem(n_devices: int = 4) -> dict:
    """Producer lanes on every device publish gmem meters; an all-lane sum
    crosses the devices and the consumer lanes duck by it."""
    from __graft_entry__ import _dryrun_heterogeneous_comm

    run_s, _ = timed(lambda: _dryrun_heterogeneous_comm(n_devices))
    return {"phase": "gmem_exchange_mesh", "devices": n_devices,
            "first_render_s": run_s, "sum_asserted": True}


DEFAULT_PHASES = (phase_ddt, phase_batch, phase_coupled_fft, phase_devexec,
                  phase_gmem_graph)
FOUR_GPU_PHASES = (phase_mesh_batch, phase_mesh_gmem)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-gpus", action="store_true",
                    help="run only the phases that span four GPUs")
    args = ap.parse_args(argv)

    devices = require_gpu(4 if args.four_gpus else 1)

    import jax

    from zorak_tpu.utils.cache import enable_persistent_cache

    for line in card_lines():
        print(line, flush=True)
    emit({"jax": jax.__version__,
          "devices": [d.device_kind for d in devices],
          "xla_flags": os.environ.get("XLA_FLAGS", ""),
          "compile_cache": enable_persistent_cache()})
    t0 = time.perf_counter()
    for phase in (FOUR_GPU_PHASES if args.four_gpus else DEFAULT_PHASES):
        emit(phase())
    emit({"total_s": time.perf_counter() - t0})
    print(result_line(devices), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
