"""Big-branch outlining (devgen cond_outline): traced-branch arms past
an AST-weight threshold lower as real stablehlo.case regions
(jax.lax.switch) — exactly one arm executes — instead of if-converted
speculative execution.  Partitions huge per-sample steps into separate
XLA computations (a compiler's memory tracks the largest computation;
Sample.jsfx's monolithic @sample scan body is ~950k ops) and skips
untaken FX arms at run time.

Every test here forces a tiny threshold so small synthetic arms take the
switch path, then demands bit-exact parity vs the native golden
(audio + vars + mem), including rand() draw-count parity and ambient-
predicate nesting (the 3-way identity/else/then switch).
"""
import numpy as np
import pytest

from zorak_tpu.ir import compile_plugin_source
from zorak_tpu.lowering.devexec import DeviceExecKernel
from zorak_tpu.verify.nulltest import (
    apply_slider_state, compare_audio, compare_memory_pages, compare_states,
    make_initialized_shadow)
from zorak_tpu.shadow import compile_native_shadow


def _golden_render(prog, x, block=512):
    gold = compile_native_shadow(prog)
    gold.state.srate = 48000.0
    apply_slider_state(gold.state, prog, None)
    gold.run_init()
    gold.run_slider()
    y = np.zeros_like(x)
    for s in range(0, x.shape[1], block):
        e = min(s + block, x.shape[1])
        gold.process_block(x[:, s:e], y[:, s:e])
    return gold, y


@pytest.fixture(autouse=True)
def _trace_fresh(monkeypatch):
    # the tests assert a trace-time counter, so the trace must actually
    # run: a disk trace-cache hit would skip it
    monkeypatch.setenv("ZORAK_TRACE_CACHE", "0")


def _null(src, x, threshold=5, expect_outlined=True):
    prog = compile_plugin_source(src)
    gold, y_ref = _golden_render(prog, x)
    snap = make_initialized_shadow(prog, 48000.0, None)
    old = DeviceExecKernel._SAMPLE_COND_OUTLINE
    DeviceExecKernel._SAMPLE_COND_OUTLINE = threshold
    try:
        kern = DeviceExecKernel(prog, snap.state, x.shape[0],
                                block_size=512)
        y, carry = kern.render(x)
    finally:
        DeviceExecKernel._SAMPLE_COND_OUTLINE = old
    if expect_outlined:
        assert kern.sample._n_cond_outlined > 0, \
            "threshold should have routed at least one branch to switch"
    rep = compare_audio(y_ref, y)
    assert rep.audio_passed, rep.summary()
    assert rep.max_abs_delta <= 1e-6
    kern.writeback(carry, snap.state)
    rep2 = compare_states(gold.state, snap.state)
    compare_memory_pages(gold.state, snap.state, report=rep2)
    assert rep2.passed, rep2.summary()
    return kern


def noise(ch, n, seed=5, scale=0.6):
    return (np.random.RandomState(seed).randn(ch, n) * scale).astype(
        np.float32)


class TestCondOutline:
    def test_two_arm_ternary_state(self):
        # stateful arms with heap writes on both sides
        src = ("@init\nhist = 100;\n"
               "@sample\n"
               "spl0 > 0 ? (\n"
               "  a = spl0 * 2; b = a + spl1; hist[idx] = b;\n"
               "  idx += 1; idx >= 32 ? idx = 0;\n"
               "  acc = acc * 0.99 + b;\n"
               ") : (\n"
               "  c = spl1 * 3; hist[idx2 + 40] = c;\n"
               "  idx2 += 1; idx2 >= 16 ? idx2 = 0;\n"
               "  acc = acc * 0.95 - c;\n"
               ");\n"
               "spl0 = acc * 0.1; spl1 = acc * 0.05;\n")
        _null(src, noise(2, 3000))

    def test_if_without_else(self):
        src = ("@init\nbuf = 64;\n"
               "@sample\n"
               "abs(spl0) > 0.4 ? (\n"
               "  e = e * 0.9 + abs(spl0); buf[w] = e; w = (w + 1) % 8;\n"
               "  g = min(1, e * 2);\n"
               ");\n"
               "spl0 *= 0.5 + 0.1 * g; spl1 *= 0.5 + 0.1 * g;\n")
        _null(src, noise(2, 2048))

    def test_nested_ambient_pred(self):
        # outer branch stays if-converted (below threshold via a high
        # outer arm?), inner heavy branch outlines under the ambient
        # predicate -> 3-way identity/else/then switch
        src = ("@init\nt = 200;\n"
               "@sample\n"
               "gate = abs(spl0) > 0.3;\n"
               "gate ? (\n"
               "  spl1 > 0 ? (\n"
               "    s1 = s1 * 0.9 + spl0; t[p] = s1; p = (p + 1) % 16;\n"
               "    q = s1 * s1;\n"
               "  ) : (\n"
               "    s2 = s2 * 0.8 - spl0; t[p + 32] = s2;\n"
               "    q = -s2;\n"
               "  );\n"
               ");\n"
               "spl0 = q * 0.2;\n")
        prog = compile_plugin_source(src)
        gold, y_ref = _golden_render(prog, noise(2, 2500))
        snap = make_initialized_shadow(prog, 48000.0, None)
        old = DeviceExecKernel._SAMPLE_COND_OUTLINE
        # weight window: inner arms (~15 nodes) outline, outer arm
        # (~40 nodes incl. inner) would too — exercise both nesting ways
        DeviceExecKernel._SAMPLE_COND_OUTLINE = 5
        try:
            kern = DeviceExecKernel(prog, snap.state, 2, block_size=512)
            y, carry = kern.render(noise(2, 2500))
        finally:
            DeviceExecKernel._SAMPLE_COND_OUTLINE = old
        assert kern.sample._n_cond_outlined > 0
        rep = compare_audio(y_ref, y)
        assert rep.audio_passed, rep.summary()
        kern.writeback(carry, snap.state)
        rep2 = compare_states(gold.state, snap.state)
        compare_memory_pages(gold.state, snap.state, report=rep2)
        assert rep2.passed, rep2.summary()

    def test_branch_inside_while(self):
        src = ("@init\nvoices = 500;\n"
               "@sample\n"
               "n = abs(spl0) > 0.5 ? 4 : 2;\n"
               "i = 0; acc = 0;\n"
               "while (i < n) (\n"
               "  v = voices + i * 8;\n"
               "  v[0] > 0.2 ? (\n"
               "    v[1] = v[1] * 0.99 + spl0; v[0] *= 0.999;\n"
               "    acc += v[1];\n"
               "  ) : (\n"
               "    v[0] = min(1, v[0] + abs(spl1) * 0.01);\n"
               "    v[2] = v[2] * 0.9; acc += v[2] * 0.1;\n"
               "  );\n"
               "  i += 1;\n"
               ");\n"
               "spl0 = acc * 0.25; spl1 = acc * 0.125;\n")
        _null(src, noise(2, 2048))

    def test_rand_draw_parity(self):
        # rand() only draws in the taken arm; the golden draws exactly
        # the same sequence — a cursor mismatch would skew every later
        # draw and fail the state compare
        src = ("@init\nseed = 0;\n"
               "@sample\n"
               "spl0 > 0 ? (\n"
               "  r = rand(1); s = s * 0.9 + r; m = max(m, r);\n"
               ") : (\n"
               "  t = t * 0.95 + rand(0.5); k += 1;\n"
               ");\n"
               "spl0 = s * 0.1 + t * 0.05;\n")
        _null(src, noise(2, 2000))

    def test_value_of_ternary(self):
        # expression value flows out of the switch
        src = ("@init\nd = 300;\n"
               "@sample\n"
               "v = spl0 > 0 ? (\n"
               "  u = u * 0.9 + spl0; d[a] = u; a = (a + 1) % 8; u * 2;\n"
               ") : (\n"
               "  w = w * 0.8 + spl1; d[a + 16] = w; w - 1;\n"
               ");\n"
               "spl0 = v * 0.3;\n")
        _null(src, noise(2, 1500))

    def test_threshold_off_keeps_merged(self):
        src = ("@init\nhist = 100;\n"
               "@sample\n"
               "spl0 > 0 ? (h = h * 0.9 + spl0; hist[0] = h;) "
               ": (h = h * 0.8; hist[1] = h;);\n"
               "spl0 = h;\n")
        kern = _null(src, noise(2, 1024), threshold=0,
                     expect_outlined=False)
        assert kern.sample._n_cond_outlined == 0
