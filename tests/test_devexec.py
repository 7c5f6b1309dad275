"""Sequential device executor: whole plugin stepped on-device.

The middle path for plugins the time-vectorizer rejects (data-dependent
voice loops, draw-interleaved rand): devgen-compiled @block/@slider/
@sample fused into one scan program, bit-exact vs the golden executors.
"""
import numpy as np
import pytest

from zorak_tpu.ir import compile_plugin_source
from zorak_tpu.lowering.devexec import DeviceExecKernel
from zorak_tpu.shadow import compile_native_shadow
from zorak_tpu.verify.nulltest import (
    apply_slider_state, compare_audio, compare_memory_pages, compare_states,
    make_initialized_shadow)


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


def _null(src, x, renders=1):
    prog = compile_plugin_source(src)
    gold, y_ref = _golden_render(prog, x)
    snap = make_initialized_shadow(prog, 48000.0, None)
    kern = DeviceExecKernel(prog, snap.state, x.shape[0], block_size=512)
    if renders == 1:
        y, carry = kern.render(x)
    else:
        cut = (x.shape[1] // renders // 512) * 512
        parts = []
        carry = None
        pos = 0
        while pos < x.shape[1]:
            stop = min(pos + cut, x.shape[1]) if pos + cut < x.shape[1] \
                else x.shape[1]
            yp, carry = kern.render(x[:, pos:stop], carry=carry)
            parts.append(yp)
            pos = stop
        y = np.concatenate(parts, axis=1)
    rep = compare_audio(y_ref, y)
    # devexec promises the reference audio contract (1e-5 on f32 samples;
    # XLA may contract mul+add to FMA inside the scan body, a 1-ulp
    # f64 wobble the golden's strict IEEE ordering doesn't have)
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


class TestDeviceExec:
    def test_data_dependent_voice_loop(self):
        # the exact class the vectorizer rejects: loop(n) with audio-
        # dependent n over a voice table
        src = ("@init\nbuf = 1000;\nn_active = 0;\n"
               "@block\nctr += 1;\n"
               "@sample\n"
               "x = abs(spl0);\n"
               "x > 0.5 ? n_active = min(n_active + 2, 8) :"
               " (n_active > 0 ? n_active -= 1);\n"
               "acc = 0; i = 0;\n"
               "loop(n_active,\n"
               "  acc += buf[i] * 0.1 + x * 0.01;\n"
               "  buf[i] = x;\n"
               "  i += 1;\n"
               ");\n"
               "spl0 = spl0 * 0.7 + acc * 0.05;\n"
               "spl1 = spl1 * 0.7;\n")
        _null(src, noise(2, 3000))

    def test_rand_interleaved_block_and_sample(self):
        # rand() draws in @block interleave with @sample's stream — the
        # staged-pool cursor must reproduce the golden MT19937 sequence,
        # across resumed renders (rng rebase)
        src = ("@init\nnz = 0;\n"
               "@block\n"
               "want = 2 + (bc % 3);\nbc += 1;\ni = 0;\n"
               "loop(want, noise[i] = rand(2) - 1; i += 1; );\n"
               "@sample\n"
               "p = abs(spl0) > 0.4 ? rand() * 0.1 : 0;\n"
               "spl0 = spl0 * 0.8 + p + noise[0] * 0.01;\n")
        kern = _null(src, noise(1, 3000), renders=2)
        assert kern.uses_rand

    def test_pending_slider_retrigger(self):
        src = ("slider1:10<0,100,1>Amt\n"
               "@init\nq = 0;\n"
               "@slider\ng = slider1 / 100;\n"
               "@block\n"
               "bc += 1;\n"
               "bc == 3 ? ( slider1 = 50; sliderchange(slider1); );\n"
               "@sample\nspl0 *= g;\n")
        _null(src, noise(1, 4000))

    def test_loaded_pool_device_gathers(self):
        # sample_* reads over a LOADED generation become device gathers
        # (devgen._pool_gather_call); bit-exact vs the python golden that
        # answers the same calls through the host pool service
        from zorak_tpu.runtime.services import EngineHost
        from zorak_tpu.shadow import compile_shadow

        src = ("@init\n"
               "pool = sample_pool_from_slot(0, #nm);\n"
               "sample_pool_commit(pool);\n"
               "nsel = sample_pool_loaded(pool);\n"
               "sid = sample_get(pool, 0);\n"
               "len0 = sample_len(pool, sid);\n"
               "pk = sample_peak(pool, sid);\n"
               "pos = 0;\n"
               "@sample\n"
               "sid2 = abs(spl0) > 0.3 ? sid : sample_get(pool, 1);\n"
               "v = sample_read(pool, sid2, 0, pos);\n"
               "vi = sample_read_interp(pool, sid2, 1, pos * 0.5 + 0.25);\n"
               "ok = sample_read2_interp(pool, sid2, pos * 0.33, l, r);\n"
               "spl0 = spl0 * 0.5 + v * 0.3 + vi * 0.1 + l * 0.05"
               " + ok * 0.001 + pk * 0.001;\n"
               "spl1 = spl1 * 0.5 + r * 0.2;\n"
               "pos += 1;\n"
               "pos >= len0 ? pos = 0;\n")

        rng = np.random.RandomState(9)
        wave_a = (rng.randn(2, 220) * 0.4)      # stereo
        wave_b = (rng.randn(1, 97) * 0.7)       # mono

        def host():
            h = EngineHost()
            h.files.load_slot(0, wave_a, srate=44100.0, name="a")
            h.files.load_slot(0, wave_b, srate=48000.0, name="b")
            return h

        prog = compile_plugin_source(src)
        x = noise(2, 2500)

        gold = compile_shadow(prog, host=host())
        gold.state.srate = 48000.0
        apply_slider_state(gold.state, prog, None)
        gold.run_init()
        gold.run_slider()
        y_ref = np.zeros_like(x)
        for s in range(0, x.shape[1], 512):
            e = min(s + 512, x.shape[1])
            gold.process_block(x[:, s:e], y_ref[:, s:e])

        snap = make_initialized_shadow(prog, 48000.0, None, host=host())
        assert snap.state.host.pool.generation is not None
        kern = DeviceExecKernel(prog, snap.state, 2, block_size=512)
        y, carry = kern.render(x)
        rep = compare_audio(y_ref, y)
        assert rep.audio_passed and rep.max_abs_delta <= 1e-6, rep.summary()
        kern.writeback(carry, snap.state)
        rep2 = compare_states(gold.state, snap.state)
        compare_memory_pages(gold.state, snap.state, report=rep2)
        assert rep2.passed, rep2.summary()

    def test_adaptive_while_unroll_bailout(self, monkeypatch):
        # a static-predicate voice while() whose unroll exceeds the merge
        # budget must restore pre-loop state and re-trace as ONE
        # lax.while_loop body (Sample.jsfx's 16-voice while would
        # otherwise unroll to 65k+ merges), staying bit-faithful
        from zorak_tpu.lowering import devgen as DG

        monkeypatch.setattr(DG.DeviceSection, "_UNROLL_MERGE_BUDGET", 48)
        # this test introspects trace-time merge counts, so the trace must
        # actually run (a disk trace-cache hit skips it)
        monkeypatch.setenv("ZORAK_TRACE_CACHE", "0")
        body = ["vi = 0;", "acc = 0;", "while (vi < 16) (",
                "  v = 100 + vi * 8;"]
        for k in range(10):
            c = f"buf[v + {k % 8}]"
            body.append(
                f"  {c} > 0.5 ? (acc += {c} * 0.01; {c} -= 0.1;)"
                f" : ({c} += abs(spl0) * 0.03;);")
        body += ["  vi += 1;", ");"]
        src = ("options: maxmem=4096\n@init\nbuf = 1000;\n@sample\n"
               + "\n".join(body) + "\nspl0 = spl0 * 0.7 + acc;\n")
        kern = _null(src, noise(1, 2000))
        # the bail kept the trace small: merges ~= one body, not 16x
        assert kern.sample._n_merges < 100

    def test_fft_at_traced_base(self):
        # fft_real at a data-dependent base pointer: the WDL FFT family
        # must run through the dynamic-slice path (Sample.jsfx's decrust
        # passes its fft buffers through vars the trace cannot fold)
        src = ("@init\nbufA = 1024; bufB = 2048;\nacc = 0;\n"
               "@sample\n"
               "sel = spl0 > 0 ? bufA : bufB;\n"
               "sel[w] = spl0;\n"
               "w += 1;\n"
               "w >= 64 ? (\n"
               "  w = 0;\n"
               "  fft_real(sel, 64);\n"
               "  fft_permute(sel, 16);\n"
               "  acc = sel[0] * 0.01 + sel[2] * 0.005;\n"
               "  j = 0; loop(64, sel[j] = 0; j += 1;);\n"
               ");\n"
               "spl0 = spl0 * 0.5 + acc * 0.001;\n")
        _null(src, noise(1, 2000))

    def test_reduced_heap_grows_on_overflow(self):
        # the device heap sizes from observed post-@init use (4096 min),
        # NOT declared maxmem; a dynamic write past it must bump the
        # high-water slot, rebuild with a doubled heap and replay —
        # bit-faithful incl. the mem-page compare
        src = ("@init\nbuf = 100;\nctr = 0;\n"
               "@sample\n"
               "n = abs(spl0) > 0.2 ? 3 : 1;\n"
               "loop(n, buf[ctr] = spl0; ctr += 1; );\n"
               "spl0 = spl0 * 0.5 + buf[ctr > 3000 ? ctr - 3000 : 0]"
               " * 0.1;\n")
        kern = _null(src, noise(1, 6000))
        assert kern.sample.mem_size > 4096  # grew past the initial floor

    def test_engine_falls_back_to_devexec(self):
        from zorak_tpu.runtime.engine import PluginInstance

        src = ("@init\nbuf = 0;\n"
               "@sample\n"
               "n = abs(spl0) > 0.3 ? 3 : 1;\n"
               "s = 0; i = 0;\n"
               "loop(n, s += buf[i]; buf[i] = spl0 * 0.5; i += 1; );\n"
               "spl0 = spl0 * 0.6 + s * 0.1;\n")
        inst = PluginInstance(compile_plugin_source(src),
                              smart_idle="always_awake")
        assert inst.engine == "tpu-devexec"
        x = noise(1, 2048)
        res = inst.render(x)
        prog = compile_plugin_source(src)
        _gold, y_ref = _golden_render(prog, x)
        assert np.abs(res.audio.astype(np.float64)
                      - y_ref.astype(np.float64)).max() <= 1e-6


class TestSectionedMode:
    """Host-driven per-section render (devexec 'sectioned' mode): one
    bounded program per section for plugins whose fused program is huge
    (Sample.jsfx: 24 MB fused).  Must be a drop-in for the fused program:
    same audio, same final state, same MIDI/pending behavior."""

    SRC = ("slider1:10<0,100,1>Amt\n"
           "@init\nbuf = 1000;\n"
           "@slider\ng = slider1 / 100;\n"
           "gq = g * g;\n"
           "@block\n"
           "bc += 1;\n"
           "avg = acc / max(samplesblock, 1);\n"
           "acc = 0;\n"
           "bc == 3 ? ( slider1 = 50; sliderchange(slider1); );\n"
           "drive = 1 / (1 + avg);\n"
           "@sample\n"
           "acc += abs(spl0);\n"
           "k = abs(spl0) * 3;\n"
           "i = 0; v = 0;\n"
           "while (i < k) ( v += buf[i] * 0.1; i += 1; );\n"
           "buf[floor(abs(spl0)*7)] = spl0;\n"
           "spl0 = spl0 * g * drive + v * gq * 0.01;\n")

    def test_sectioned_matches_fused_and_golden(self, monkeypatch):
        monkeypatch.setattr(DeviceExecKernel, "_SPLIT_WEIGHT", 30)
        prog = compile_plugin_source(self.SRC)
        x = noise(1, 2100)   # 4 full blocks + 52-sample remainder
        gold, y_ref = _golden_render(prog, x)

        results = {}
        for mode in ("fused", "sectioned"):
            monkeypatch.setenv("ZORAK_DEVEXEC_MODE", mode)
            snap = make_initialized_shadow(prog, 48000.0, None)
            kern = DeviceExecKernel(prog, snap.state, 1, block_size=512)
            y, carry = kern.render(x)
            kern.writeback(carry, snap.state)
            results[mode] = (np.asarray(y), snap.state)
            rep = compare_audio(y_ref, y)
            assert rep.audio_passed and rep.max_abs_delta <= 1e-6, \
                (mode, rep.summary())
            rep2 = compare_states(gold.state, snap.state, eps=1e-9)
            compare_memory_pages(gold.state, snap.state, report=rep2)
            assert rep2.passed, (mode, rep2.summary())
        # sectioned mode actually split the @block/@slider bodies
        monkeypatch.setenv("ZORAK_DEVEXEC_MODE", "sectioned")
        snap = make_initialized_shadow(prog, 48000.0, None)
        kern = DeviceExecKernel(prog, snap.state, 1, block_size=512)
        kern.render(x)
        assert len(kern._split_parts("block", 512)) >= 2

    def test_sectioned_midi_and_mout(self, monkeypatch):
        src = ("@init\nlast = 0;\n"
               "@block\n"
               "while (midirecv(ofs, m1, m23)) (\n"
               "  last = m23 & 127;\n"
               "  midisend(ofs, m1, m23);\n"
               ");\n"
               "@sample\nspl0 = spl0 * 0.5 + last / 254;\n")
        prog = compile_plugin_source(src)
        x = noise(1, 1024)
        midi = [(10, 0x90, 60, 100), (600, 0x80, 60, 0)]
        outs = {}
        for mode in ("fused", "sectioned"):
            monkeypatch.setenv("ZORAK_DEVEXEC_MODE", mode)
            snap = make_initialized_shadow(prog, 48000.0, None)
            kern = DeviceExecKernel(prog, snap.state, 1, block_size=512)
            y, carry = kern.render(x, midi=midi)
            outs[mode] = (np.asarray(y), list(kern.last_midi_out))
        np.testing.assert_array_equal(outs["fused"][0], outs["sectioned"][0])
        assert outs["fused"][1] == outs["sectioned"][1]
        assert outs["sectioned"][1]   # events actually came back
