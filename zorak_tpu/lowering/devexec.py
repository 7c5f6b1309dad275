"""Sequential device executor: the WHOLE plugin stepped on the device.

The vectorizing specializer (specialize.py) rejects @sample bodies whose
control structure resists time-vectorization (data-dependent voice
loops, gated feedback delay networks).  This module is the honest
middle path the reference has no analogue for: every section compiles
through devgen's scalar-contract tracer (bit-exact vs the golden
executors by construction) and the render runs as ONE fused XLA
program — an outer lax.scan over host blocks (@block → pending-mask
@slider retrigger → inner lax.scan over the block's samples running
@sample).  Sequential in time like the reference's native loop
(ref: dsp_jsfx_aot.py:5713-5905 block driver), but device-resident:
audio, heap and vars never leave HBM mid-render.

Use when `specialize_sample_kernel` raises: slower than the vector path
(per-sample dependent ops), far faster than shipping every block to the
host golden, and it keeps multi-plugin graphs on-device.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..ir.program import PluginProgram
from .devgen import (DeviceSection, DevgenError, MEM_HIWATER_SLOT,
                     MIDI_POS_SLOT, PENDING_SLOT_NAMES, RAND_POS_SLOT,
                     section_dynamic_keys)
from .specialize import SpecializeError


class DeviceExecKernel:
    """Whole-plugin sequential device render kernel."""

    # @sample big-branch outlining (devgen cond_outline): arms past this
    # AST weight lower as real stablehlo.case regions, partitioning the
    # per-sample step into separate XLA computations, so a huge @sample
    # body compiles as several bounded computations and untaken arms
    # are skipped at run time.  Applied to the @sample section only.
    _SAMPLE_COND_OUTLINE = int(__import__("os").environ.get(
        "ZORAK_SAMPLE_COND_OUTLINE", 500))

    def __init__(self, program: PluginProgram, snapshot, nch: int,
                 segment_len: int = 1 << 17, block_size: int = 512,
                 rand_pool: int = 1 << 18,
                 heap_size: Optional[int] = None):
        import jax

        self.P = program
        self.snap = snapshot
        self.nch = int(nch)
        self.B = int(block_size)
        self.engine = "devexec"
        self._rand_pool_req = int(rand_pool)
        if not program.sections.get("sample"):
            raise SpecializeError("no @sample section")

        secs = tuple(s for s in ("block", "slider", "sample")
                     if program.sections.get(s))
        self._dyn = section_dynamic_keys(program, secs)

        # heap sizing: declared maxmem (8-32M cells) is the CAP, not the
        # working set — a maxmem-sized heap carried through per-sample
        # while_loops costs two full copies per iteration when XLA cannot
        # alias the carry.  Start from observed post-@init use with 2x
        # headroom; dynamic writes track a high-water mark and the render
        # retries with a doubled heap on overflow (reduced_heap mode).
        top = int(program.memtop or 0)
        used = int(getattr(snapshot, "mem_used", 0))
        self._full_size = 1 << max(12, int(top - 1).bit_length()
                                   if top > 1 else 12)
        if heap_size is not None:
            size = min(int(heap_size), self._full_size)
        else:
            size = min(self._full_size,
                       1 << max(12, (2 * max(used, 1) - 1).bit_length()))

        import os
        import sys
        import time as _time

        def _dbg(msg: str) -> None:
            if os.environ.get("ZORAK_DEVEXEC_DEBUG"):
                print(f"[devexec +{_time.time() - _t0:7.1f}s] {msg}",
                      file=sys.stderr, flush=True)

        _t0 = _time.time()
        probe = None
        self._fft_sizes: Tuple[int, ...] = ()
        while True:
            try:
                # layout union probe (construction only scans the AST)
                if probe is None:
                    _dbg(f"probe build (heap {size})")
                    probe = {s: DeviceSection(
                        program, snapshot, s, self._dyn, size,
                        consts={"samplesblock": float(self.B)},
                        rand_pool=rand_pool, reify=True,
                        cond_outline=(self._SAMPLE_COND_OUTLINE
                                      if s == "sample" else 0))
                        for s in secs}
                    self._any_gmem = any(p.uses_gmem
                                         for p in probe.values())
                    self._any_mout = any(p.uses_midi_out
                                         for p in probe.values())
                    self.uses_rand = any(p._detect_call("rand")
                                         for p in probe.values())
                    self._rand_cap = (int(rand_pool) if self.uses_rand
                                      else 0)
                    self._rng_state = None
                    self._rng_prestate = None

                def build(section, nblk):
                    return DeviceSection(
                        program, snapshot, section, self._dyn, size,
                        consts={"samplesblock": float(nblk)},
                        force_gmem=self._any_gmem,
                        force_midi_out=self._any_mout,
                        rand_pool=self._rand_cap, reduced_heap=True,
                        fft_sizes=self._fft_sizes, reify=True,
                        cond_outline=(self._SAMPLE_COND_OUTLINE
                                      if section == "sample" else 0))

                _dbg(f"section builds (heap {size})")
                self.sample = build("sample", self.B)
                self.block = (build("block", self.B)
                              if "block" in secs else None)
                self.slider = build("slider", self.B) if "slider" in secs \
                    and self.block is not None else None

                # trace every section now: static heap addresses beyond
                # the reduced size surface here and climb the size ladder
                import jax.numpy as jnp

                for sec in (self.block, self.slider, self.sample):
                    if sec is None:
                        continue
                    _dbg(f"trace {sec.section} (heap {size})")
                    kw = {}
                    if sec.uses_midi_in:
                        kw["midi"] = (
                            jax.ShapeDtypeStruct((1, 4), jnp.float64),
                            jax.ShapeDtypeStruct((), jnp.float64))
                    # cached_step: this trace primes the pjit cache the
                    # render jit replays from — the devgen Python trace
                    # (minutes on the multi-kLoC plugins) runs once
                    jax.eval_shape(
                        sec.cached_step,
                        jax.ShapeDtypeStruct((sec.n_vars,), jnp.float64),
                        jax.ShapeDtypeStruct((sec.total_mem,),
                                             jnp.float64), **kw)
                # FFT sizes discover on the first trace; the DFT matmul
                # tables then move from baked 2 MB dense literals to a
                # heap-tail region (Sample.jsfx: 33 MB of constants) —
                # rebuild once with them
                used: set = set()
                for sec in (self.block, self.slider, self.sample):
                    if sec is not None:
                        used |= sec.fft_sizes_used
                if used - set(self._fft_sizes):
                    self._fft_sizes = tuple(sorted(used))
                    _dbg(f"fft tables: rebuild with sizes "
                         f"{self._fft_sizes}")
                    continue
                _dbg("build done")
                break
            except DevgenError as exc:
                grows = "beyond device heap" in str(exc)
                if grows and size < self._full_size:
                    _dbg(f"heap ladder: {exc}")
                    # the message carries the offending static address —
                    # jump the ladder straight there (each retry re-traces
                    # every section; doubling blind is minutes per step on
                    # the multi-kLoC plugins)
                    import re as _re

                    m = _re.search(r"address (\d+)", str(exc))
                    need = int(m.group(1)) if m else 0
                    size = min(self._full_size,
                               max(size * 2,
                                   1 << max(12, (need - 1).bit_length())))
                    continue
                raise SpecializeError(
                    f"device executor: {exc}") from None
        # every section must agree on the shared state layout
        for sec in (self.block, self.slider):
            if sec is not None:
                assert sec.slots == self.sample.slots
                assert sec.total_mem == self.sample.total_mem

        self._spl_in = np.asarray(
            [self.sample.slots[("spl", c)] for c in range(self.nch)],
            np.int64)
        self._rpos = self.sample.slots[("var", RAND_POS_SLOT)]
        self._hw = self.sample.slots[("var", MEM_HIWATER_SLOT)]
        self._pend = [self.sample.slots[("var", nm)]
                      for nm in PENDING_SLOT_NAMES]
        self._mpos = self.sample.slots[("var", MIDI_POS_SLOT)]
        self._render_fns: Dict[Tuple[int, int], Any] = {}
        self._rem_cache: Dict[int, Any] = {}
        self._part_cache: Dict[Tuple[str, int], Any] = {}
        self._sect_fns: Dict[Any, Any] = {}
        self._mode: Optional[str] = None
        self.last_midi_out: List[Tuple[int, int, int, int]] = []
        self.coupled = True          # device @block (engine introspection)
        self.rand_gated = False
        self.n_rand = 0

    # -- carries --------------------------------------------------------------

    def initial_carry(self):
        return (self.sample.initial_vars(), self.sample.initial_mem())

    @property
    def accepts_midi(self) -> bool:
        return bool(self.block is not None and self.block.uses_midi_in)

    # -- render ---------------------------------------------------------------

    def _rem_sections(self, rem: int):
        """Remainder-block sections (samplesblock=rem), cached per rem so
        distinct render lengths sharing a remainder re-use one devgen
        trace (each trace is minutes on the multi-kLoC plugins)."""
        secs = self._rem_cache.get(rem)
        if secs is None:
            samp_r = DeviceSection(
                self.P, self.snap, "sample", self._dyn,
                self.sample.mem_size,
                consts={"samplesblock": float(rem)},
                force_gmem=self._any_gmem, force_midi_out=self._any_mout,
                rand_pool=self._rand_cap, reduced_heap=True,
                fft_sizes=self._fft_sizes, reify=True,
                cond_outline=self._SAMPLE_COND_OUTLINE)
            blk_r = DeviceSection(
                self.P, self.snap, "block", self._dyn,
                self.sample.mem_size,
                consts={"samplesblock": float(rem)},
                force_gmem=self._any_gmem,
                force_midi_out=self._any_mout,
                rand_pool=self._rand_cap,
                reduced_heap=True,
                fft_sizes=self._fft_sizes,
                reify=True) if self.block is not None \
                else None
            secs = (samp_r, blk_r)
            self._rem_cache[rem] = secs
        return secs

    # -- sectioned mode --------------------------------------------------------
    #
    # One XLA program per section — with @block/@slider bodies
    # statement-split into parts when a single section is itself large —
    # and a host-driven block loop threading the device-resident
    # (vars, mem) carry.  @sample cannot be dispatch-split (sample n's
    # later statements run before sample n+1's earlier ones), so its
    # scan stays one program.  It bounds the size of each compiled
    # program at the price of several dispatches per block; the default
    # is the fused program, and ZORAK_DEVEXEC_MODE=sectioned selects this.

    _SPLIT_WEIGHT = int(__import__("os").environ.get(
        "ZORAK_SECTION_SPLIT_WEIGHT", 20_000))

    def _split_parts(self, section: str, nblk: int):
        """Statement-split a section body into DeviceSection parts, each
        under the split weight budget; parts that fail to trace on their
        own (e.g. a file open/read/close sequence crossing a boundary)
        merge with their successor and retry."""
        import jax
        import jax.numpy as jnp

        key = (section, nblk)
        got = self._part_cache.get(key)
        if got is not None:
            return got
        body = list(self.P.sections.get(section) or [])
        weigher = self.sample
        weights = [max(1, weigher._node_weight(st)) for st in body]
        budget = max(self._SPLIT_WEIGHT, max(weights, default=1))
        groups: List[List] = []
        cur: List = []
        w = 0
        for st, sw in zip(body, weights):
            if cur and w + sw > budget:
                groups.append(cur)
                cur, w = [], 0
            cur.append(st)
            w += sw
        if cur:
            groups.append(cur)

        def build(stmts):
            return DeviceSection(
                self.P, self.snap, section, self._dyn,
                self.sample.mem_size,
                consts={"samplesblock": float(nblk)},
                body=stmts,
                force_gmem=self._any_gmem, force_midi_out=self._any_mout,
                rand_pool=self._rand_cap, reduced_heap=True,
                fft_sizes=self._fft_sizes, reify=True)

        parts: List[DeviceSection] = []
        i = 0
        while i < len(groups):
            stmts = groups[i]
            while True:
                sec = build(stmts)
                try:
                    kw = {}
                    if sec.uses_midi_in:
                        kw["midi"] = (
                            jax.ShapeDtypeStruct((1, 4), jnp.float64),
                            jax.ShapeDtypeStruct((), jnp.float64))
                    jax.eval_shape(
                        sec.cached_step,
                        jax.ShapeDtypeStruct((sec.n_vars,), jnp.float64),
                        jax.ShapeDtypeStruct((sec.total_mem,), jnp.float64),
                        **kw)
                    break
                except DevgenError:
                    if i + 1 >= len(groups):
                        raise
                    stmts = stmts + groups[i + 1]
                    del groups[i + 1]
            parts.append(sec)
            i += 1
        self._part_cache[key] = parts
        return parts

    def _make_sectioned(self, T: int, midi_k: int = 1):
        """Host-driven render with the same signature and return
        convention as _make_run's fused program."""
        import jax
        import jax.numpy as jnp

        B, nch = self.B, self.nch
        nfull = T // B
        rem = T - nfull * B
        spl_in = jnp.asarray(self._spl_in)
        pend = jnp.asarray(self._pend)
        mpos, hw = self._mpos, self._hw
        mo_base, mo_cells = self.sample.midi_out_base, \
            self.sample.midi_out_cells
        use_midi = self.accepts_midi
        use_mout = self._any_mout
        jfns = self._sect_fns

        def jit1(name, f, donate=(0, 1)):
            fn = jfns.get(name)
            if fn is None:
                fn = jax.jit(f, donate_argnums=donate)
                jfns[name] = fn
            return fn

        def part_fn(sec, tag):
            if sec.uses_midi_in:
                return jit1((tag, "m"),
                            lambda bv, bm, me, mc:
                            sec.cached_step(bv, bm, midi=(me, mc)))
            return jit1(tag, lambda bv, bm: sec.cached_step(bv, bm))

        def slider_fn(sec, tag):
            def f(bv, bm):
                p = bv[pend[0]] + bv[pend[1]] + bv[pend[2]]

                def run(a):
                    return sec.cached_step(a[0], a[1])

                return jax.lax.cond(p != 0.0, run, lambda a: a, (bv, bm))
            return jit1(tag, f)

        def sample_fn(sec, tag):
            def f(bv, bm, xblk):
                def body(c, x_t):
                    cv, cm = c
                    cv = cv.at[spl_in].set(x_t)
                    cv, cm = sec.cached_step(cv, cm)
                    return (cv, cm), cv[spl_in]

                (bv, bm), y = jax.lax.scan(body, (bv, bm), xblk)
                return bv, bm, y
            return jit1(tag, f)

        prep = jit1("prep", lambda bv, bm: (
            bv.at[mpos].set(0.0) if use_midi else bv,
            bm.at[mo_base:mo_base + mo_cells].set(0.0) if use_mout else bm))
        clear_pend = jit1("clear_pend",
                          lambda bv: bv.at[pend].set(0.0), donate=(0,))

        has_block = self.block is not None
        has_slider = self.slider is not None
        if has_block:
            bparts = self._split_parts("block", B)
            bparts_r = self._split_parts("block", rem) if rem else None
        sparts = self._split_parts("slider", B) if has_slider else []
        samp_fn = sample_fn(self.sample, ("samp", B))
        if rem:
            samp_r = self._rem_cache.get(("samp", rem))
            if samp_r is None:
                samp_r = DeviceSection(
                    self.P, self.snap, "sample", self._dyn,
                    self.sample.mem_size,
                    consts={"samplesblock": float(rem)},
                    force_gmem=self._any_gmem,
                    force_midi_out=self._any_mout,
                    rand_pool=self._rand_cap, reduced_heap=True,
                    fft_sizes=self._fft_sizes, reify=True,
                    cond_outline=self._SAMPLE_COND_OUTLINE)
                self._rem_cache[("samp", rem)] = samp_r
            samp_fn_r = sample_fn(samp_r, ("samp", rem))

        def run(carry, x32, mev=None, mn=None):
            bv, bm = carry
            bv = jnp.asarray(bv, jnp.float64)
            bm = jnp.asarray(bm, jnp.float64)
            x64 = jnp.asarray(x32).astype(jnp.float64).T
            ys = []
            mouts = []
            rows = nfull + (1 if rem else 0)
            for b in range(rows):
                n = B if b < nfull else rem
                xblk = x64[b * B: b * B + n]
                if has_block:
                    if use_midi or use_mout:
                        bv, bm = prep(bv, bm)
                    for pi, sec in enumerate(
                            bparts if b < nfull else bparts_r):
                        f = part_fn(sec, ("blk", n, pi))
                        if sec.uses_midi_in:
                            bv, bm = f(bv, bm, jnp.asarray(mev[b]),
                                       jnp.asarray(mn[b]))
                        else:
                            bv, bm = f(bv, bm)
                    if has_slider:
                        for pi, sec in enumerate(sparts):
                            bv, bm = slider_fn(sec, ("sld", pi))(bv, bm)
                        bv = clear_pend(bv)
                fs = samp_fn if b < nfull else samp_fn_r
                bv, bm, y = fs(bv, bm, xblk)
                ys.append(y)
                if use_mout:
                    mouts.append(bm[mo_base:mo_base + mo_cells][None, :])
            y = jnp.concatenate(ys, axis=0) if len(ys) > 1 else ys[0]
            out = y.T.astype(jnp.float32)
            if use_mout:
                mo = (jnp.concatenate(mouts, axis=0) if len(mouts) > 1
                      else mouts[0])
                return out, (bv, bm), mo
            return out, (bv, bm)

        return run

    def _make_run(self, T: int, midi_k: int = 1):
        import jax
        import jax.numpy as jnp

        B = self.B
        nch = self.nch
        nfull = T // B
        rem = T - nfull * B
        blk = self.block
        sld = self.slider
        samp = self.sample
        use_midi = self.accepts_midi
        use_mout = self._any_mout
        mo_base, mo_cells = samp.midi_out_base, samp.midi_out_cells
        spl_in = jnp.asarray(self._spl_in)
        pend = jnp.asarray(self._pend)
        mpos = self._mpos

        if rem:
            try:
                samp_r, blk_r = self._rem_sections(rem)
                sld_r = sld
            except DevgenError as exc:  # pragma: no cover - build checked
                raise SpecializeError(f"device executor: {exc}") from None

        def sample_loop(carry, xblk, sampsec):
            # xblk: f64[n, nch] -> scan over samples
            def body(c, x_t):
                bv, bm = c
                bv = bv.at[spl_in].set(x_t)
                bv, bm = sampsec.cached_step(bv, bm)
                return (bv, bm), bv[spl_in]

            return jax.lax.scan(body, carry, xblk)

        def block_step(carry, xblk, midi_blk, blksec, sldsec, sampsec):
            bv, bm = carry
            if blksec is not None:
                if use_midi:
                    bv = bv.at[mpos].set(0.0)
                if use_mout:
                    bm = bm.at[mo_base:mo_base + mo_cells].set(0.0)
                bv, bm = blksec.cached_step(bv, bm, midi=midi_blk)
                if sldsec is not None:
                    p = bv[self._pend[0]] + bv[self._pend[1]] \
                        + bv[self._pend[2]]

                    def rerun(a):
                        v, m = sldsec.cached_step(a[0], a[1])
                        # host consumes the masks each block
                        # (ref: JSFXJuceProcessor.cpp:5667-5737)
                        return v.at[pend].set(0.0), m

                    bv, bm = jax.lax.cond(p != 0.0, rerun, lambda a: a,
                                          (bv, bm))
            (bv, bm), y = sample_loop((bv, bm), xblk, sampsec)
            if use_mout:
                return (bv, bm), (y, bm[mo_base:mo_base + mo_cells])
            return (bv, bm), y

        def run(carry, x32, mev=None, mn=None):
            x64 = x32.astype(jnp.float64).T  # [T, nch]
            ys = []
            mouts = []
            if nfull:
                xin = x64[:nfull * B].reshape(nfull, B, nch)

                def step(c, xs):
                    if use_midi:
                        xb, me, mc = xs
                        return block_step(c, xb, (me, mc), blk, sld, samp)
                    return block_step(c, xs, None, blk, sld, samp)

                xs = (xin, mev[:nfull], mn[:nfull]) if use_midi else xin
                carry, yb = jax.lax.scan(step, carry, xs)
                if use_mout:
                    yb, mo = yb
                    mouts.append(mo)
                ys.append(yb.reshape(nfull * B, nch))
            if rem:
                mb = (mev[nfull], mn[nfull]) if use_midi else None
                carry, y_r = block_step(carry, x64[nfull * B:], mb,
                                        blk_r, sld_r, samp_r)
                if use_mout:
                    y_r, mo_r = y_r
                    mouts.append(mo_r[None, :])
                ys.append(y_r)
            y = jnp.concatenate(ys, axis=0) if len(ys) > 1 else ys[0]
            out = y.T.astype(jnp.float32)
            if use_mout:
                mo = (jnp.concatenate(mouts, axis=0) if len(mouts) > 1
                      else mouts[0])
                return out, carry, mo
            return out, carry

        return run

    def _render_fn(self, T: int, midi_k: int = 1):
        import jax

        key = (T, midi_k)
        fn = self._render_fns.get(key)
        if fn is None:
            if self._mode is None:
                import os

                self._mode = ("sectioned" if os.environ.get(
                    "ZORAK_DEVEXEC_MODE") == "sectioned" else "fused")
            if self._mode == "sectioned":
                fn = self._make_sectioned(T, midi_k)
            else:
                fn = jax.jit(self._make_run(T, midi_k), donate_argnums=(0,))
            self._render_fns[key] = fn
        return fn

    def _midi_planes(self, midi, T: int):
        B = self.B
        rows = T // B + (1 if T % B else 0)
        per: List[List[Tuple[float, float, float, float]]] = \
            [[] for _ in range(rows)]
        for ev in sorted(midi or [], key=lambda e: e[0]):
            off = max(0, min(int(ev[0]), T - 1))
            per[off // B].append((float(off - (off // B) * B),
                                  float(int(ev[1]) & 0xFF),
                                  float(int(ev[2]) & 0xFF),
                                  float(int(ev[3]) & 0xFF)))
        K = max(1, max((len(p) for p in per), default=1))
        mev = np.zeros((rows, K, 4), dtype=np.float64)
        mn = np.zeros((rows,), dtype=np.float64)
        for b, evs in enumerate(per):
            mn[b] = len(evs)
            for k, e in enumerate(evs):
                mev[b, k] = e
        return mev, mn

    def render_device(self, x: np.ndarray, carry=None, midi=None):
        nch, T = x.shape
        assert nch == self.nch
        carry_in = carry
        rng_save = (self._rng_state, self._rng_prestate)
        while True:
            fresh = carry is None
            if carry is None:
                carry = self.initial_carry()
            if self.uses_rand:
                carry = self._stage_rand_pool(carry, fresh)
            self.last_midi_out = []
            if midi and not self.accepts_midi:
                raise SpecializeError(
                    "MIDI events supplied but this kernel has no @block "
                    "midirecv path")
            if self.accepts_midi:
                mev, mn = self._midi_planes(midi, T)
                fn = self._render_fn(T, midi_k=mev.shape[1])
                out = fn(carry, np.ascontiguousarray(x, np.float32),
                         mev, mn)
            else:
                fn = self._render_fn(T)
                out = fn(carry, np.ascontiguousarray(x, np.float32))
            if len(out) == 3:
                y_dev, carry, mo = out
            else:
                y_dev, carry = out
                mo = None
            # reduced-heap overflow check: a dynamic write at/beyond
            # mem_size was dropped — the render is invalid; double the
            # heap and replay from this render's input state
            hw = float(np.asarray(carry[0][self._hw]))
            if hw < self.sample.mem_size:
                if mo is not None:
                    self.last_midi_out = self._decode_midi_out(
                        np.asarray(mo))
                return y_dev, carry
            if self.sample.mem_size >= self._full_size:
                raise SpecializeError(
                    f"device heap overflow (write at {int(hw)} with "
                    f"maxmem-sized heap {self.sample.mem_size})")
            old = self
            bigger = DeviceExecKernel(
                self.P, self.snap, self.nch, block_size=self.B,
                rand_pool=self._rand_pool_req,
                heap_size=max(self.sample.mem_size * 2,
                              1 << (int(hw).bit_length())))
            carry = (None if carry_in is None
                     else bigger._migrate_carry(old, carry_in))
            self.__dict__.update(bigger.__dict__)
            self._rng_state, self._rng_prestate = rng_save
            carry_in = carry

    def _migrate_carry(self, old: "DeviceExecKernel", carry):
        """Re-layout an old kernel's (vars, mem) carry onto this kernel's
        larger heap (grown region zero-filled, heap-tail regions moved to
        their new bases).  Slot tables are size-independent."""
        bv, bm = carry
        bv = np.array(bv, dtype=np.float64, copy=True)
        bm = np.asarray(bm, dtype=np.float64)
        o, n = old.sample, self.sample
        out = np.zeros(n.total_mem, dtype=np.float64)
        out[:o.mem_size] = bm[:o.mem_size]
        if o.gmem_cells:
            out[n.gmem_base:n.gmem_base + o.gmem_cells] = \
                bm[o.gmem_base:o.gmem_base + o.gmem_cells]
        if o.midi_out_cells:
            out[n.midi_out_base:n.midi_out_base + o.midi_out_cells] = \
                bm[o.midi_out_base:o.midi_out_base + o.midi_out_cells]
        if o.rand_cells:
            out[n.rand_base:n.rand_base + o.rand_cells] = \
                bm[o.rand_base:o.rand_base + o.rand_cells]
        if n.fft_cells:
            # deterministic tables: refill rather than copy (the old
            # kernel may not have carried them)
            from .devgen import _dft_mats

            for sz, off in n.fft_table_off.items():
                C, S_ = _dft_mats(sz)
                b = n.fft_base + off
                out[b:b + sz * sz] = C.reshape(-1)
                out[b + sz * sz:b + 2 * sz * sz] = S_.reshape(-1)
        return (bv, out)

    def render(self, x: np.ndarray, carry=None, midi=None):
        y_dev, carry = self.render_device(x, carry, midi=midi)
        return np.asarray(y_dev), carry

    def _decode_midi_out(self, mo: np.ndarray):
        from .devgen import MIDI_OUT_CAP

        events = []
        for b in range(mo.shape[0]):
            n = int(mo[b, 0])
            for k in range(min(n, MIDI_OUT_CAP)):
                ofs, b1, b2, b3 = mo[b, 1 + 4 * k: 5 + 4 * k]
                events.append((b * self.B + int(ofs), int(b1), int(b2),
                               int(b3)))
        return events

    def _stage_rand_pool(self, carry, fresh: bool):
        """Refill the heap-tail MT19937 pool and rebase the cursor; on
        resumed renders first advance the host generator by the draws the
        previous render consumed (one scalar D2H)."""
        import jax.numpy as jnp

        from ..semantics import mt19937np as MT

        bv, bm = carry
        if fresh or self._rng_state is None:
            self._rng_state = MT.eelrng_state_tuple(self.snap.rng)
        else:
            used = int(np.asarray(bv[self._rpos]))
            if used > self._rand_cap:
                raise SpecializeError(
                    f"device rand pool exhausted ({used} > "
                    f"{self._rand_cap}); rebuild with a larger rand_pool")
            if used > 0:
                _, self._rng_state = MT.generate(used, self._rng_prestate)
            else:
                self._rng_state = self._rng_prestate
        self._rng_prestate = self._rng_state
        draws, _ = MT.generate(self._rand_cap, self._rng_state)
        base = self.sample.rand_base
        if isinstance(bm, np.ndarray):
            bm = bm.copy()
            bm[base:base + self._rand_cap] = draws
            bv = np.asarray(bv).copy()
            bv[self._rpos] = 0.0
        else:
            bm = jnp.asarray(bm).at[base:base + self._rand_cap].set(
                jnp.asarray(draws, jnp.float64))
            bv = jnp.asarray(bv).at[self._rpos].set(0.0)
        return (bv, bm)

    # -- writeback ------------------------------------------------------------

    def writeback(self, carry, state) -> None:
        """Flush the final (vars, mem) into a ShadowState."""
        bv, bm = carry
        bv = np.asarray(bv)
        bm = np.asarray(bm)
        samp = self.sample
        if self.uses_rand and self._rng_prestate is not None:
            from ..semantics import mt19937np as MT

            used = int(bv[self._rpos])
            if used > self._rand_cap:
                raise SpecializeError(
                    f"device rand pool exhausted ({used} > "
                    f"{self._rand_cap}); rebuild with a larger rand_pool")
            rng_state = self._rng_prestate
            if used > 0:
                _, rng_state = MT.generate(used, self._rng_prestate)
            MT.restore_eelrng(state.rng, rng_state)
        if samp.uses_gmem and samp.gmem_cells:
            gm = bm[samp.gmem_base:samp.gmem_base + samp.gmem_cells]
            old = np.asarray(state.gmem, dtype=np.float64)
            n = min(len(old), len(gm))
            changed = np.nonzero(old[:n] != gm[:n])[0]
            state.gmem[:n] = gm[:n]
            host = getattr(state, "host", None)
            seg = getattr(host, "attached_gmem", None)
            if seg is not None and changed.size:
                seg.bump(int(changed.min()), int(changed.max()),
                         getattr(host, "instance_id_int", 0))
        heap = bm[:samp.mem_size]
        state.mem_ensure(len(heap))
        state.mem[:len(heap)] = heap
        masks = ("pending_change_mask", "pending_automate_mask",
                 "pending_automate_end_mask")
        for key, slot in samp.slots.items():
            if key[0] == "param":
                continue
            if key[0] == "var" and key[1] in (MIDI_POS_SLOT,
                                              RAND_POS_SLOT,
                                              MEM_HIWATER_SLOT):
                continue
            v = float(bv[slot])
            if key[0] == "var" and key[1] in PENDING_SLOT_NAMES:
                setattr(state, masks[PENDING_SLOT_NAMES.index(key[1])],
                        int(max(0.0, v)))
            elif key[0] == "var":
                state.V[key[1]] = v
            elif key[0] == "spl":
                state.spl[key[1]] = v
            elif key[0] == "slider":
                state.sliders[key[1]] = v
            elif key[0] == "builtin":
                setattr(state, key[1], v)


def device_exec_kernel(program: PluginProgram, snapshot, nch: int,
                       segment_len: int = 1 << 17,
                       block_size: int = 512) -> DeviceExecKernel:
    return DeviceExecKernel(program, snapshot, nch, segment_len,
                            block_size=block_size)
