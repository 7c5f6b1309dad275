"""Disk reification of devgen traces (lowering/tracecache.py).

The devexec build's Python trace is minutes-to-an-hour on the multi-kLoC
catalog plugins; the trace cache serializes the lowered step (jax.export
StableHLO) so a second process replays it.  Contract: a cache-hit render
is BIT-IDENTICAL to a fresh-trace render."""
import os

import numpy as np
import pytest

from zorak_tpu.ir import compile_plugin_source
from zorak_tpu.lowering import tracecache
from zorak_tpu.lowering.devexec import DeviceExecKernel
from zorak_tpu.verify.nulltest import make_initialized_shadow

SRC = """\
desc:tracecache probe
slider1:0.5<0,1,0.01>depth
@init
ph = 0;
buf = 1000;
@sample
// data-dependent loop keeps the vectorizer out -> devexec path
n = 1 + floor(abs(spl0) * 3);
acc = 0;
i = 0;
loop(n,
  acc += sin(ph + i * 0.1);
  i += 1;
);
ph += 0.01;
buf[floor(ph) % 16] = acc;
spl0 = spl0 * 0.5 + acc * 0.01 * slider1;
spl1 = spl1 * 0.5 + acc * 0.01 * slider1;
"""


@pytest.fixture()
def trace_dir(tmp_path, monkeypatch):
    d = tmp_path / "traces"
    monkeypatch.setenv("ZORAK_TRACE_CACHE_DIR", str(d))
    monkeypatch.setenv("ZORAK_TRACE_CACHE", "1")
    return d


def _render(x):
    prog = compile_plugin_source(SRC)
    snap = make_initialized_shadow(prog, 48000.0, None)
    kern = DeviceExecKernel(prog, snap.state, 2, block_size=64)
    y, carry = kern.render(x)
    return np.asarray(y), np.asarray(carry[0]), np.asarray(carry[1])


def test_fresh_then_cached_bit_identical(trace_dir):
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((2, 256)) * 0.3).astype(np.float32)

    y1, v1, m1 = _render(x)           # cold: traces + stores
    blobs = sorted(p for p in os.listdir(trace_dir) if p.endswith(".jexp"))
    assert blobs, "trace artifacts were not written"

    y2, v2, m2 = _render(x)           # warm: must load from disk
    np.testing.assert_array_equal(y1, y2)
    np.testing.assert_array_equal(v1, v2)
    np.testing.assert_array_equal(m1, m2)


def test_cache_key_changes_with_source(trace_dir):
    prog_a = compile_plugin_source(SRC)
    prog_b = compile_plugin_source(SRC.replace("* 0.5", "* 0.25"))
    snap_a = make_initialized_shadow(prog_a, 48000.0, None)
    snap_b = make_initialized_shadow(prog_b, 48000.0, None)
    from zorak_tpu.lowering.devgen import DeviceSection, section_dynamic_keys

    dyn_a = section_dynamic_keys(prog_a, ("sample",))
    dyn_b = section_dynamic_keys(prog_b, ("sample",))
    sec_a = DeviceSection(prog_a, snap_a.state, "sample", dyn_a, 4096,
                          consts={"samplesblock": 64.0})
    sec_b = DeviceSection(prog_b, snap_b.state, "sample", dyn_b, 4096,
                          consts={"samplesblock": 64.0})
    shapes = ((sec_a.n_vars,), (sec_a.total_mem,), None)
    assert tracecache.section_key(sec_a, shapes) \
        != tracecache.section_key(sec_b, shapes)
    # same inputs -> same key (stable across processes)
    assert tracecache.section_key(sec_a, shapes) \
        == tracecache.section_key(sec_a, shapes)


def test_disabled_by_env(trace_dir, monkeypatch):
    monkeypatch.setenv("ZORAK_TRACE_CACHE", "0")
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((2, 128)) * 0.3).astype(np.float32)
    _render(x)
    assert not trace_dir.exists() or not any(
        p.endswith(".jexp") for p in os.listdir(trace_dir))


def test_section_key_differs_by_platform(trace_dir, monkeypatch):
    # an export runs only on the platform it was lowered for, so the
    # platform is part of the key: a CPU trace never serves a GPU render
    prog = compile_plugin_source(SRC)
    snap = make_initialized_shadow(prog, 48000.0, None)
    from zorak_tpu.lowering.devgen import DeviceSection, section_dynamic_keys

    sec = DeviceSection(prog, snap.state, "sample",
                        section_dynamic_keys(prog, ("sample",)), 4096,
                        consts={"samplesblock": 64.0})
    shapes = ((sec.n_vars,), (sec.total_mem,), None)
    assert tracecache.export_platform() == "cpu"
    cpu_key = tracecache.section_key(sec, shapes)
    monkeypatch.setattr(tracecache, "export_platform", lambda: "cuda")
    assert tracecache.section_key(sec, shapes) != cpu_key


def test_export_names_only_current_platform(trace_dir):
    from jax import export as jexport

    x = (np.random.RandomState(2).randn(2, 192) * 0.4).astype(np.float32)
    _render(x)
    blobs = [p for p in os.listdir(trace_dir) if p.endswith(".jexp")]
    assert blobs
    for name in blobs:
        with open(trace_dir / name, "rb") as f:
            exp = jexport.deserialize(bytearray(f.read()))
        assert tuple(exp.platforms) == ("cpu",)
