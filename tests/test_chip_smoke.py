"""chip_smoke.py's and bench.py's contracts, checked on the CPU: no GPU
means a non-zero exit and no result line; the result line has the
contract's shape; and the phases and sections pass here at small sizes
(on the card they run at full size)."""
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import bench  # noqa: E402
import chip_smoke  # noqa: E402


def _run(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_exits_nonzero_without_gpu():
    out = _run(REPO, REPO / "chip_smoke.py")
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "no GPU" in out.stderr


def test_exits_nonzero_alone(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = _run(tmp_path, tmp_path / "chip_smoke.py")
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_result_line_shape():
    devs = [SimpleNamespace(platform="gpu", device_kind="NVIDIA H100")] * 4
    line = json.loads(chip_smoke.result_line(devs))
    assert line == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100", "count": 4}}


@pytest.mark.parametrize("phase,kwargs", [
    ("phase_ddt", {"seconds": 0.25}),
    ("phase_batch", {"seconds": 0.1, "files": 2}),
    ("phase_coupled_fft", {"seconds": 0.1}),
    ("phase_devexec", {"seconds": 0.05}),
    ("phase_gmem_graph", {"seconds": 0.05}),
])
def test_phase_passes_small(phase, kwargs, monkeypatch):
    monkeypatch.setenv("ZORAK_TRACE_CACHE", "0")
    out = getattr(chip_smoke, phase)(**kwargs)
    assert out["phase"]
    deltas = [v for k, v in out.items() if "delta" in k]
    assert deltas and max(deltas) <= 1e-5


def test_ddt_class_vector_bit_exact_2s():
    # the north-star program takes the vector engine and nulls bit-exact
    # against the native golden over 2 s on the CPU, vars included
    from zorak_tpu.runtime.engine import PluginInstance
    from zorak_tpu.verify import compare_audio, compare_states, golden_render

    prog = chip_smoke.load("ddt_class.jsfx")
    inst = PluginInstance(prog, srate=48000.0)
    assert inst.engine == "tpu-vector", inst.spec_error
    x = chip_smoke.noise(7, (2, 96000))
    y = inst.render(x).audio
    state, y_ref, _ = golden_render(prog, x, 48000.0)
    rep = compare_audio(y_ref, y)
    compare_states(state, inst.shadow.state, report=rep)
    assert rep.passed and rep.max_abs_delta == 0.0, rep.summary()
    # the reflections are audible: the wet part is far from silence
    assert np.abs(y - x * (1 - 0.35)).max() > 1e-2


def test_bench_exits_nonzero_without_gpu():
    out = _run(REPO, REPO / "bench.py")
    assert out.returncode != 0
    assert out.stdout == ""


@pytest.mark.parametrize("section", sorted(bench.SECTIONS))
def test_bench_section_small(section, monkeypatch):
    for name, value in (("N_SAMPLES", 4800), ("SECONDS", 0.1), ("RUNS", 2),
                        ("LANES", 2), ("KERNEL_SECONDS", 0.25)):
        monkeypatch.setattr(bench, name, value)
    fn = bench.SECTIONS[section]
    out = fn(n=4800) if section == "onepole_scan" else fn()
    assert len(out["wall_s"]) == 2
    assert out["median_s"] > 0 and out["audio_s_per_s"] > 0
