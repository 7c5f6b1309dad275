"""On-device EEL2 section executor (the @block half of the fused
block/sample pipeline).

Compiles a section's AST to a pure JAX function over a packed state
``(vars, mem) -> (vars, mem)`` so audio-coupled @block work (control
computed FROM the audio: meters, accumulators, spectral state) runs on
the device between vectorized @sample segments — one fused XLA program,
zero host round-trips per block.  This replaces the reference's
interleaved per-block interpreter dispatch (ref: src/JSFXJuceProcessor.cpp
processBlock -> @block -> per-sample loop) with a scan-of-blocks.

Design mirrors the numeric contract of the golden executors
(shadow/pyexec.py) exactly:

* values are python floats (STATIC: derived only from @init/@slider
  state, folded at trace time — this keeps fft sizes, loop bounds and
  buffer bases compile-time constants) or traced f64 scalars (DYNAMIC:
  anything @block or @sample can change between blocks),
* rhs-before-target assignment order, loop(count) truncates once,
  while() re-evaluates side-effecting predicates per iteration,
  branches on traced predicates run both arms and select-merge state,
* mem uses EEL bracket addressing trunc(base + idx + 1e-5) clamped >= 0.

Unsupported constructs raise DevgenError; the caller falls back to the
host-interpreted trajectory or the shadow executor (honest coverage).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from ..frontend.astnodes import (
    Asn, Bin, Block, CallExpr, Cond, Const, IfStmt, LoopExpr, Mem, Name,
    Node, Str, Un, WhileStmt,
)
from ..ir.program import PluginProgram
from ..ir.symbols import dollar_const, slider_index, spl_index
from ..semantics import scalar as SC
from . import eelmath as EM

import os as _os
import sys as _sys
import time as _time

_DEVGEN_DEBUG = bool(_os.environ.get("ZORAK_DEVEXEC_DEBUG"))


def _trace_note(msg: str) -> None:
    if _DEVGEN_DEBUG:
        print(f"[devgen trace] {msg}", file=_sys.stderr, flush=True)



class DevgenError(Exception):
    """Section uses a construct the device executor does not support."""


PENDING_SLOT_NAMES = ("__pend_chg__", "__pend_auto__", "__pend_auto_end__")
MIDI_POS_SLOT = "__midi_pos__"
MIDI_OUT_CAP = 64  # staged sends per block (drop past this, like the ref queue)
# device message-bus staging (graph joint-lockstep scan, VERDICT r4 #5):
# a coupled node's @block sends land in a heap-tail OUT table (count +
# rows of [dest, chan_id, tag, a, b, c, d]) the joint scan appends to the
# threaded ring window; inbound matched entries are routed into per-
# channel FIFO queues ([head, count, cap rows of [sender, tag, a..d]])
# msg_recv pops.  Capacities bound per-BLOCK traffic; the in-region's
# first cell counts device-side queue-overflow drops the graph refuses
# post-render (the shadow inbox is unbounded, so an overflow would be a
# silent semantic deviation).  Ref: src/DspJsfxMessageBus.cpp:529,609.
MSG_OUT_CAP = 32       # sends per member per block
MSG_QUEUE_CAP = 64     # pending scalar messages per receive channel
# OUT row: [bc, dest, chan_id, tag, a, b, c, d] — bc is an explicit
# broadcast flag (a dest sentinel would collide with msg_sendto(-1,...))
MSG_ENT = 8
MSG_QENT = 6           # queue row: sender, tag, a, b, c, d


class MsgConfig:
    """Live-bus lowering context for a DeviceSection (graph lockstep).

    chan_ids: the graph-shared channel-name -> small-int registry (one
    dict per CommWorld so every member bakes the same ids); host: the
    node's InstanceComm, used to FOLD static topology queries
    (instance_id / msg_peer_* / msg_dropped) at trace time — the peer
    registry is frozen during a render, exactly the reference's
    begin/end-block world."""

    def __init__(self, chan_ids: Dict[str, int], host):
        self.chan_ids = chan_ids
        self.host = host

    def intern(self, name: str) -> int:
        got = self.chan_ids.get(name)
        if got is None:
            got = len(self.chan_ids)
            self.chan_ids[name] = got
        return got
RAND_POS_SLOT = "__rand_pos__"  # draws consumed from the staged MT19937 pool
# reduced-heap mode: high-water mark of dynamic plugin-heap WRITE
# addresses; the render wrapper checks it and rebuilds with a larger
# heap when a write landed at/beyond mem_size (write dropped, render
# discarded) — lets the device heap size from OBSERVED use instead of
# the declared maxmem (8-32M cells), which otherwise dominates
# while-loop carry traffic
MEM_HIWATER_SLOT = "__mem_hiwater__"


_dft_mat_cache: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}


def _dft_mats(n: int) -> Tuple[np.ndarray, np.ndarray]:
    got = _dft_mat_cache.get(n)
    if got is None:
        k = np.arange(n, dtype=np.float64)
        ang = (2.0 * np.pi / n) * np.outer(k, k)
        got = (np.cos(ang), np.sin(ang))
        _dft_mat_cache[n] = got
    return got


_SC_UNARY = {
    "sin": SC.eel_sin, "cos": SC.eel_cos, "tan": SC.eel_tan,
    "asin": SC.eel_asin, "acos": SC.eel_acos, "atan": SC.eel_atan,
    "exp": SC.eel_exp, "log": SC.eel_log, "log10": SC.eel_log10,
    "sqrt": SC.eel_sqrt, "abs": SC.eel_abs, "fabs": SC.eel_abs,
    "floor": SC.eel_floor, "ceil": SC.eel_ceil, "invsqrt": SC.eel_invsqrt,
    "sign": SC.eel_sign, "sqr": SC.eel_sqr,
}
_SC_BINARY = {
    "+": lambda a, b: a + b, "-": lambda a, b: a - b,
    "*": lambda a, b: a * b,
    "/": SC.eel_div, "^": SC.eel_pow, "%": SC.eel_mod,
    "|": SC.eel_or, "&": SC.eel_and, "~": SC.eel_xor,
    "<<": SC.eel_shl, ">>": SC.eel_shr,
    "<": SC.cmp_lt, "<=": SC.cmp_le, ">": SC.cmp_gt, ">=": SC.cmp_ge,
    "==": SC.cmp_eq, "!=": SC.cmp_ne,
    "min": SC.eel_min, "max": SC.eel_max,
    "pow": SC.eel_pow, "atan2": SC.eel_atan2,
}
_COMPOUND_OPS = {
    "+=": "+", "-=": "-", "*=": "*", "/=": "/", "%=": "%", "^=": "^",
    "|=": "|", "&=": "&", "~=": "~",
}
# EM.UNARY lacks a couple of entries the scalar side has
_EM_UNARY_EXTRA = {"sqr": lambda x: x * x}


def _env_key(ident: str):
    i = spl_index(ident)
    if i is not None:
        return ("spl", i)
    i = slider_index(ident)
    if i is not None:
        return ("slider", i)
    if ident in ("srate", "samplesblock", "midi_bus", "ext_midi_bus"):
        return ("builtin", ident)
    return ("var", ident)


def section_dynamic_keys(program: PluginProgram, sections: Sequence[str]):
    """Env keys any DSP section can CHANGE at runtime (everything else is
    frozen @init/@slider state and folds to constants on the device)."""
    from .specialize import section_var_usage

    dyn: Set[Any] = set()
    for sec in sections:
        if program.sections.get(sec):
            _, writes, _, _ = section_var_usage(program, sec)
            dyn |= writes
    dyn |= {("spl", c) for c in range(64)}
    return dyn


class DeviceSection:
    """One EEL2 section compiled to a traceable (vars, mem) step."""

    def __init__(self, program: PluginProgram, snapshot, section: str,
                 dynamic_keys: Set[Any], mem_size: int,
                 consts: Optional[Dict[str, float]] = None,
                 body: Optional[Sequence[Node]] = None,
                 force_gmem: bool = False, force_midi_out: bool = False,
                 rand_pool: int = 0, reduced_heap: bool = False,
                 fft_sizes: Sequence[int] = (), reify: bool = False,
                 cond_outline: int = 0, msg_cfg: Optional[MsgConfig] = None):
        """force_gmem / force_midi_out: include the gmem segment / MIDI-OUT
        table in the heap layout even when THIS section doesn't touch them,
        so several sections (block/slider/sample in the sequential device
        executor) can step one shared (vars, mem) state."""
        self.P = program
        self.snap = snapshot
        self.section = section
        self.mem_size = int(mem_size)
        self.consts = dict(consts or {})
        # deferred slot writes + read memo (see the vars property)
        self._vars_arr = None
        self._vpend: Dict[int, Any] = {}
        self._vmemo: Dict[int, Any] = {}
        self._force_gmem = bool(force_gmem)
        self._force_midi_out = bool(force_midi_out)
        # rand() support: a host-pregenerated MT19937 u32 pool rides the
        # heap tail; each call consumes pool[cursor] (cursor slot) so the
        # draw SEQUENCE matches the golden exactly.  0 = rand forbidden.
        self.rand_cells = int(rand_pool)
        self.reduced_heap = bool(reduced_heap)
        # reify: allow the disk trace cache (tracecache.py) to serve this
        # section's step as a jax.export artifact.  Only the sequential
        # device executor opts in: exported calls have no vmap batching
        # rule, so the lane-batched coupled pipeline must keep plain jit.
        self.reify = bool(reify)
        # big-branch outlining: traced-branch arms past this AST weight
        # lower as REAL stablehlo.case regions (jax.lax.switch) instead
        # of if-converted speculative execution (_merged).  Two effects:
        # (1) the arm becomes its own XLA computation — compiler memory
        # and time track the largest single computation after call
        # inlining (Sample.jsfx's @sample step flattens to ~950k ops in
        # ONE scan-body computation), and control-flow regions are the
        # only partition XLA cannot inline away; (2) the untaken
        # arm is SKIPPED at run time instead of executed-and-masked —
        # the FX-strip idiom `amt > 0.0001 ? apply_fx()` stops paying
        # for disabled effects.  0 = off (if-conversion only).
        self.cond_outline = int(cond_outline)
        self._n_merges = 0
        self._n_cond_outlined = 0
        self._stmt_weights: Dict[int, int] = {}
        # explicit statement list (e.g. an extracted hop-call body) instead
        # of a named section
        self.body = list(body) if body is not None \
            else list(program.sections.get(section, []))
        # solo-instance comm folding: with no live bus host (standalone /
        # null-test renders, or an engine-promised single-instance graph),
        # msg_*/comm_join fold to the inert golden-host semantics at trace
        # time (ref: DspJsfxMessageBus.cpp delivers nothing without peers;
        # graph-scheduled multi-instance renders use the shadow path)
        from ..comm.bus import InstanceComm

        host = getattr(snapshot, "host", None)
        self.comm_solo = (not isinstance(host, InstanceComm)
                          or bool(getattr(host, "comm_solo", False)))
        # live-bus msg staging (graph joint-lockstep scan): only with an
        # explicit config AND a live bus host — solo folding wins otherwise
        self.msg_cfg = msg_cfg if (msg_cfg is not None
                                   and not self.comm_solo) else None
        self._validate(self.body)
        # memoized transitive node weights per user function (see
        # _node_weight; drives the unroll-vs-fori decision)
        self._fn_weights: Dict[str, int] = {}
        self._pure_cache: Dict[int, bool] = {}
        self._fn_pure_cache: Dict[str, bool] = {}
        self._dyn_calls: Dict[str, int] = {}
        # function outlining (program-size dedup): heavy user functions
        # called from several sites lower ONCE as a jitted subfunction
        # (func.call in the StableHLO) instead of re-tracing their body
        # inline at every call site — see _outlined_call
        self._outline_cache: Dict[Any, Any] = {}
        self._outline_bad: Set[str] = set()
        self._outline_w: Dict[str, int] = {}
        self._outline_safe_memo: Dict[str, bool] = {}
        self._call_counts: Optional[Dict[str, int]] = None
        self._fn_writesets: Dict[str, Set[Any]] = {}
        # cached_step(): step() behind an inner jit boundary so the
        # Python trace of the section body runs ONCE per shape signature
        # (multi-kLoC plugins pay minutes per trace; devexec otherwise
        # re-pays it at build eval_shape, again at render jit, and again
        # per remainder build)
        self._step_jit = None
        self._merge_hist: Dict[Any, int] = {}
        self.uses_gmem = self._detect_gmem(self.body) or self._force_gmem
        self.uses_midi_in = self._detect_call("midirecv")
        self.uses_midi_out = self._detect_call("midisend") \
            or self._force_midi_out
        # gmem maps into the device heap right after plugin mem: all state
        # plumbing (branch merges, loop carries, the coupled pipeline's
        # heap sync) covers it for free; plugin mem addressing clamps at
        # mem_size so the regions never alias
        self.gmem_cells = int(len(getattr(snapshot, "gmem", ()))) \
            if self.uses_gmem else 0
        self.gmem_base = self.mem_size
        # staged MIDI OUT rides the heap tail too (branch merges / loop
        # carries then cover it for free): [count | CAP rows of 4]
        self.midi_out_base = self.mem_size + self.gmem_cells
        self.midi_out_cells = (1 + MIDI_OUT_CAP * 4) \
            if self.uses_midi_out else 0
        # staged message-bus regions (live-bus lockstep members only;
        # zero cells otherwise so solo layouts are bit-unchanged).  Both
        # regions are allocated whenever msg_cfg is on — uniform plumbing
        # lets the joint scan consume/emit one plane shape per member.
        self.msg_out_base = self.midi_out_base + self.midi_out_cells
        self.msg_out_cells = (1 + MSG_OUT_CAP * MSG_ENT) \
            if self.msg_cfg is not None else 0
        self.msg_in_base = self.msg_out_base + self.msg_out_cells
        self.msg_queues: Dict[int, int] = {}   # chan_id -> queue base
        if self.msg_cfg is not None:
            off = self.msg_in_base + 1         # cell 0: device-drop count
            for name in self._msg_recv_channel_names():
                cid = self.msg_cfg.intern(name)
                self.msg_queues[cid] = off
                off += 2 + MSG_QUEUE_CAP * MSG_QENT
            self.msg_in_cells = off - self.msg_in_base
        else:
            self.msg_in_cells = 0
        self.rand_base = self.msg_in_base + self.msg_in_cells
        # DFT matmul tables (cos/sin, n^2 cells each) ride the heap tail
        # too: BAKED dense constants for the catalog's 512-point FFTs were
        # 2 MB of StableHLO text apiece (33 MB of constants in
        # Sample.jsfx's step), all of which the compiler has to carry.
        # Values are the SAME
        # host-numpy matrices (read from memory instead of literals), so
        # numerics are bit-identical to the constant path.  The executor
        # discovers the sizes on a first trace and rebuilds (see
        # devexec.py); sections sharing one state must agree on the list.
        self.fft_base = self.rand_base + self.rand_cells
        self.fft_sizes = tuple(sorted({int(n) for n in fft_sizes}))
        self.fft_table_off: Dict[int, int] = {}
        off = 0
        for n in self.fft_sizes:
            self.fft_table_off[n] = off
            off += 2 * n * n          # cos matrix then sin matrix
        self.fft_cells = off
        self.fft_sizes_used: Set[int] = set()
        # +1: one trailing TRASH cell.  Scalar heap writes lower as
        # dynamic_update_slice (one compact op) instead of scatter
        # (an op with a region — ~10x the StableHLO text and a heavier
        # lowering; Texture's @sample carried 20k of them, 17.9 MB).
        # DUS has
        # no drop mode: dropped writes (inactive branch arms, reduced-
        # heap overflow) redirect their index to total_mem and DUS's
        # start-clamp lands them in the trash cell, which nothing reads.
        self.total_mem = self.mem_size + self.gmem_cells \
            + self.midi_out_cells + self.msg_out_cells \
            + self.msg_in_cells + self.rand_cells + self.fft_cells + 1

        # slot table: dynamic vars + every specialized-fn param (params are
        # assigned per call; functions are non-reentrant, so one slot each)
        keys = sorted((k for k in dynamic_keys if k[0] != "builtin"),
                      key=repr)
        self.slots: Dict[Any, int] = {k: i for i, k in enumerate(keys)}
        for fname, fdef in program.fn_defs.items():
            for p in fdef.params:
                k = ("param", fname, p)
                self.slots[k] = len(self.slots)
        # pending slider masks (sliderchange/slider_automate from @block
        # retrigger @slider, ref: dsp_jsfx_aot.py:5788-5804): pseudo vars
        # the fused pipeline polls to fire the device @slider section
        names = PENDING_SLOT_NAMES + (MIDI_POS_SLOT, RAND_POS_SLOT)
        if self.reduced_heap:
            names = names + (MEM_HIWATER_SLOT,)
        for nm in names:
            self.slots[("var", nm)] = len(self.slots)
        self.n_vars = len(self.slots)

    # -- static validation ----------------------------------------------------

    # msg_*/comm builtins that fold to inert golden-host semantics in the
    # solo regime (comm_solo) and reject otherwise
    _COMM_FNS = frozenset({
        "msg_send", "msg_sendto", "msg_recv", "msg_peek",
        "msg_send_buf", "msg_sendto_buf",
        "msg_advertise", "msg_subscribe", "msg_unsubscribe",
        "msg_avail", "msg_kind", "msg_length", "msg_dropped", "msg_clear",
        "msg_peer_count", "msg_peer_id", "msg_peer_caps", "msg_peer_alive",
        "comm_join", "instance_id", "instance_set_name",
    })

    # the live-bus subset a lockstep member's device section supports:
    # scalar ring traffic via staged planes + static topology folds.
    # Registry mutators (subscribe/advertise/join/set_name), buffer
    # messages, and msg_peek stay rejected — honest shadow fallback.
    _MSG_DEVICE_FNS = frozenset({
        "msg_send", "msg_sendto", "msg_recv",
        "msg_avail", "msg_kind", "msg_length", "msg_dropped", "msg_clear",
        "msg_peer_count", "msg_peer_id", "msg_peer_caps", "msg_peer_alive",
        "instance_id",
    })

    _FORBIDDEN = frozenset({
        "rand", "midisend_buf", "midirecv_buf", "midisend_str",
        "midirecv_str", "midisyx",
        "slider_show", "slider_next_chg",
        "msg_send", "msg_recv", "msg_peek",
        "msg_advertise", "msg_subscribe", "msg_peer_count", "msg_peer_id",
        "comm_join", "instance_id", "instance_set_name",
        "file_string", "file_read", "file_write",
        "get_host_placement", "export_buffer_to_project",
        "mem_set_values", "mem_get_values", "atomic_setifequal",
        "stack_push", "stack_pop", "stack_peek", "stack_exch",
    })

    def _validate(self, stmts: Sequence[Node]) -> None:
        from ..frontend.astnodes import walk

        seen_fns: Set[str] = set()

        def scan(nodes):
            for root in nodes:
                for n in walk(root):
                    if isinstance(n, CallExpr):
                        f = n.func
                        if f in self.P.fn_defs:
                            if f not in seen_fns:
                                seen_fns.add(f)
                                scan([self.P.fn_defs[f].body])
                        elif f in self._COMM_FNS and self.comm_solo:
                            pass  # folds inert at trace time (_comm_call)
                        elif f in self._MSG_DEVICE_FNS \
                                and self.msg_cfg is not None:
                            pass  # staged ring traffic (_msg_call)
                        elif f == "rand" and self.rand_cells > 0:
                            pass  # staged-pool draws (_rand_call)
                        elif f in self._FORBIDDEN:
                            raise DevgenError(
                                f"@{self.section} uses {f}() — not "
                                "device-executable")
        scan(stmts)

    _GMEM_FNS = frozenset({
        "gmem_attach", "gmem_attach_size", "gmem_size", "gmem_get",
        "gmem_put", "gmem_fill", "gmem_zero", "gmem_copy"})

    def _detect_call(self, fname: str) -> bool:
        from ..frontend.astnodes import walk

        seen: Set[str] = set()

        def scan(nodes) -> bool:
            for root in nodes:
                for n in walk(root):
                    if isinstance(n, CallExpr):
                        if n.func == fname:
                            return True
                        if n.func in self.P.fn_defs and n.func not in seen:
                            seen.add(n.func)
                            if scan([self.P.fn_defs[n.func].body]):
                                return True
            return False

        return scan(self.body)

    def _detect_gmem(self, stmts: Sequence[Node]) -> bool:
        from ..frontend.astnodes import walk

        seen: Set[str] = set()

        def scan(nodes) -> bool:
            for root in nodes:
                for n in walk(root):
                    if isinstance(n, Mem) and isinstance(n.base, Name) \
                            and n.base.ident == "gmem":
                        return True
                    if isinstance(n, CallExpr):
                        if n.func in self._GMEM_FNS:
                            return True
                        if n.func in self.P.fn_defs and n.func not in seen:
                            seen.add(n.func)
                            if scan([self.P.fn_defs[n.func].body]):
                                return True
            return False

        return scan(stmts)

    # -- trace-time state -----------------------------------------------------

    def step(self, vars_vec, mem, midi=None):
        """Trace the section body once. vars_vec: f64[n_vars]; mem:
        f64[total_mem] = [plugin heap | gmem segment view] (the gmem tail
        is the block-synchronous HBM view of the shared array,
        ref: src/DspJsfxGmem.h).  midi: optional (events f64[K,4],
        count f64) — this block's staged host MIDI queue, consumed by
        midirecv via the __midi_pos__ cursor slot (caller resets it per
        block).  Returns the updated (vars, mem) pair."""
        import jax.numpy as jnp

        self._jnp = jnp
        self.vars = vars_vec
        self.mem = mem
        self.midi = midi
        self._n_merges = 0
        # debug: merge counts keyed by source position of the branch node
        self._merge_hist: Dict[Any, int] = {}
        # predicated execution (if-conversion): inside a traced branch arm
        # this holds the conjunction of the enclosing branch predicates.
        # Heap writes mask themselves against it (index redirected to the
        # out-of-bounds dropland when inactive), so a branch merge never
        # re-applies or where-merges the heap at all — one scatter per
        # original write regardless of nesting depth.  Texture's @sample
        # previously lowered to 16.6k scatters (17 MB of StableHLO)
        # mostly from per-merge write re-application; vars stay cheap
        # whole-vector wheres.
        self._pred = None
        # trace-time constant overlay: slots assigned a static value read
        # back static until a traced write / branch divergence / loop body
        # invalidates them (lets file handles, reload flags and local
        # derivations stay foldable through dynamic slots)
        self._known: Dict[int, float] = {}
        # file-slot contents are static per specialization; each trace
        # starts from a pristine cursor state (loads are self-contained
        # within one @block invocation — open/read/close)
        self._files = self._fresh_file_service()
        t_last = _time.time()
        for si, stmt in enumerate(self.body):
            self.ex(stmt)
            if _DEVGEN_DEBUG and _time.time() - t_last > 30.0:
                t_last = _time.time()
                _trace_note(f"@{self.section} stmt {si + 1}/"
                            f"{len(self.body)} (merges {self._n_merges})")
        if _DEVGEN_DEBUG and self._merge_hist:
            top = sorted(self._merge_hist.items(), key=lambda kv: -kv[1])
            _trace_note(f"@{self.section} merge sources (top 12 of "
                        f"{len(top)}, total {self._n_merges}): "
                        + ", ".join(f"{p}:{c}" for p, c in top[:12]))
        return self.vars, self.mem

    def cached_step(self, vars_vec, mem, midi=None):
        """step() behind a jit boundary AND the disk trace cache.  Inside
        an outer trace the call lowers to one pjit eqn whose jaxpr comes
        from the pjit tracing cache, so the (expensive, pure-Python)
        devgen trace of the section body runs once per shape signature
        instead of once per enclosing jit trace — and tracecache.py
        reifies the lowered step to disk as a jax.export artifact, so
        LATER PROCESSES replay it in seconds instead of re-tracing
        (Sample.jsfx: ~an hour of single-core Python per section set).
        XLA inlines the call either way, so the compiled program is
        identical to inlining step() directly.  Reification is opt-in
        (see `reify` in __init__): exported calls cannot be vmapped, so
        only the un-batched devexec path uses the disk layer."""
        if self._step_jit is None:
            if self.reify:
                from .tracecache import step_callable

                self._step_jit = step_callable(self)
            else:
                import jax

                self._step_jit = jax.jit(self.step)
        if midi is None:
            return self._step_jit(vars_vec, mem)
        return self._step_jit(vars_vec, mem, midi=midi)

    def _fresh_file_service(self):
        from ..runtime.services import FileSlotService

        svc = FileSlotService()
        host = getattr(self.snap, "host", None)
        src = getattr(host, "files", None)
        if src is not None:
            svc.slots = src.slots  # shared static decoded audio
        return svc

    def _file_fingerprint(self):
        return tuple(sorted(
            (k, h.cursor, h.selected)
            for k, h in self._files.open_handles.items()))

    def initial_vars(self) -> np.ndarray:
        out = np.zeros(self.n_vars, dtype=np.float64)
        for key, slot in self.slots.items():
            out[slot] = self._snap_value(key)
        return out

    def initial_mem(self) -> np.ndarray:
        self.snap.mem_ensure(1)
        out = np.zeros(self.total_mem, dtype=np.float64)
        n = min(len(self.snap.mem), self.mem_size)
        out[:n] = self.snap.mem[:n]
        if self.gmem_cells:
            gm = np.asarray(self.snap.gmem, dtype=np.float64)
            out[self.gmem_base:self.gmem_base + len(gm)] = gm
        for sz, off in self.fft_table_off.items():
            C, S_ = _dft_mats(sz)
            b = self.fft_base + off
            out[b:b + sz * sz] = C.reshape(-1)
            out[b + sz * sz:b + 2 * sz * sz] = S_.reshape(-1)
        return out

    def _snap_value(self, key) -> float:
        kind = key[0]
        if kind == "spl":
            return float(self.snap.spl[key[1]])
        if kind == "slider":
            return float(self.snap.sliders[key[1]])
        if kind == "var":
            return float(self.snap.V.get(key[1], 0.0))
        if kind == "param":
            return 0.0
        raise AssertionError(key)

    # -- value helpers --------------------------------------------------------

    @staticmethod
    def _is_static(v) -> bool:
        return isinstance(v, float)

    def _truthy(self, v):
        if isinstance(v, float):
            return SC.truthy(v)
        return EM.truthy_mask(v)

    # -- deferred var-slot traffic -------------------------------------------
    # Scalar slot plumbing dominated the lowered step of big plugins
    # (Sample.jsfx @sample: ~21.5k dynamic_update_slices + ~56k
    # reshape/slice from per-write/per-read packing, all of which the
    # compiler has to carry).  Writes buffer in _vpend and
    # flush as DUS only when the ARRAY itself is observed (property get:
    # control-flow save/restore, loop carries, step return); reads
    # memoize in _vmemo.  Branch merges select per written SLOT instead
    # of re-materializing the vector (see _merged).  Pure CSE/sinking —
    # the flushed array is bit-identical to the eager form's.

    @property
    def vars(self):
        self._vflush()
        return self._vars_arr

    @vars.setter
    def vars(self, arr):
        self._vars_arr = arr
        self._vpend.clear()
        self._vmemo.clear()

    def _vflush(self) -> None:
        if not self._vpend:
            return
        import jax

        jnp = self._jnp
        arr = self._vars_arr
        for slot, val in self._vpend.items():
            v = jnp.asarray(val, arr.dtype).reshape((1,))
            arr = jax.lax.dynamic_update_slice(arr, v, (slot,))
        self._vpend.clear()
        self._vars_arr = arr

    def _read_slot(self, key):
        slot = self.slots[key]
        got = self._known.get(slot)
        if got is not None:
            return got
        v = self._vpend.get(slot)
        if v is not None:
            return v
        v = self._vmemo.get(slot)
        if v is not None:
            return v
        v = self._vars_arr[slot]
        self._vmemo[slot] = v
        return v

    def _write_slot(self, key, val):
        if key not in self.slots:
            raise DevgenError(f"write to unclassified state {key!r}")
        slot = self.slots[key]
        if isinstance(val, float):
            self._known[slot] = val
        else:
            self._known.pop(slot, None)
        self._vpend[slot] = val
        self._vmemo[slot] = val

    def _read_name(self, ident: str, scope: Dict[str, Any]):
        if ident in scope:
            return self._read_slot(scope[ident])
        if ident == "mem":
            return 0.0
        if ident == "gmem":
            raise DevgenError("gmem in device section")
        c = dollar_const(ident)
        if c is not None:
            return float(c)
        key = _env_key(ident)
        if key[0] == "builtin":
            name = key[1]
            if name in self.consts:
                return float(self.consts[name])
            return float(getattr(self.snap, name))
        if key in self.slots:
            return self._read_slot(key)
        return self._snap_value(key)

    def _mem_addr(self, base, idx):
        if isinstance(base, float) and isinstance(idx, float):
            a = SC.mem_address(base, idx)
            if a >= self.mem_size:
                raise DevgenError(
                    f"static mem address {a} beyond device heap "
                    f"({self.mem_size})")
            return a
        jnp = self._jnp
        b = jnp.float64(base) if isinstance(base, float) else base
        i = jnp.float64(idx) if isinstance(idx, float) else idx
        a = EM.to_i64(b + i + 1.0e-5)
        if self.reduced_heap:
            # raw (>=0) address: reads fill 0 past mem_size, writes drop
            # and bump the high-water slot so the render wrapper can
            # rebuild with a larger heap
            return jnp.maximum(a, 0)
        return jnp.clip(a, 0, self.mem_size - 1)

    def _mem_get(self, a):
        if isinstance(a, int):
            return self.mem[a]
        if self.reduced_heap:
            jnp = self._jnp
            return jnp.where(a < self.mem_size,
                             self.mem[jnp.minimum(a, self.mem_size - 1)],
                             jnp.float64(0.0))
        return self.mem[a]

    def _mem_set(self, a, v, drop: bool = False, heap: bool = False):
        import jax

        jnp = self._jnp
        vec = getattr(v, "ndim", 0) >= 1 or getattr(a, "ndim", 0) >= 1
        vv = (jnp.asarray(v, self.mem.dtype) if vec
              else jnp.asarray(v, self.mem.dtype).reshape((1,)))
        if heap and self.reduced_heap and not isinstance(a, int):
            hw = ("var", MEM_HIWATER_SLOT)
            cur = self._arr(self._read_slot(hw))
            self._write_slot(hw, jnp.maximum(cur, a.astype(jnp.float64)))
            a = jnp.where(a < self.mem_size, a, self.total_mem)
            drop = True
        if self._pred is not None:
            # predicated write: redirect the index past the end when the
            # enclosing branch arm is inactive — dropped either way below
            a = jnp.where(self._pred, a, self.total_mem)
            drop = True
        if vec:
            # vector writes at (possibly strided) index vectors keep the
            # scatter path; only the out-of-bounds dropland discards them
            if drop:
                self.mem = self.mem.at[a].set(vv, mode="drop")
            else:
                self.mem = self.mem.at[a].set(vv)
            return
        # scalar writes lower as dynamic_update_slice: one compact op vs
        # scatter's region (~10x the StableHLO text, heavier lowering).
        # DUS clamps start to [0, total_mem-1]; dropped writes (index
        # redirected to total_mem) land in the trailing trash cell
        self.mem = jax.lax.dynamic_update_slice(self.mem, vv, (a,))

    def _mem_bulk(self, start, chunk):
        """Contiguous heap write [start, start+len(chunk)); start is a
        static int or a traced i64 pre-clamped by the caller.  Under a
        branch predicate the chunk is value-masked against the current
        region so an untaken arm leaves the heap bit-identical."""
        import jax

        jnp = self._jnp
        n = int(chunk.shape[0])
        if self._pred is not None:
            old = (self.mem[start:start + n] if isinstance(start, int)
                   else jax.lax.dynamic_slice(self.mem, (start,), (n,)))
            chunk = jnp.where(self._pred, chunk, old)
        if isinstance(start, int):
            self.mem = self.mem.at[start:start + n].set(chunk)
        else:
            self.mem = jax.lax.dynamic_update_slice(
                self.mem, chunk, (start,))

    # -- gmem (attached shared segment, block-synchronous HBM view) ----------

    def _gmem_index(self, x):
        """max(0, trunc(x + 1e-5)) per shadow/state.py:_gmem_index."""
        if isinstance(x, float):
            try:
                return max(0, int(x + 1.0e-5))
            except (ValueError, OverflowError):
                return 0
        return self._jnp.maximum(EM.to_i64(x + 1.0e-5), 0)

    def _gmem_get(self, idx):
        if not self.gmem_cells:
            return 0.0
        jnp = self._jnp
        base = self.gmem_base
        i = self._gmem_index(idx)
        if isinstance(i, int):
            if i >= self.gmem_cells:
                return 0.0
            return self.mem[base + i]
        return jnp.where(
            i < self.gmem_cells,
            self.mem[base + jnp.clip(i, 0, self.gmem_cells - 1)],
            jnp.float64(0.0))

    def _gmem_set(self, idx, val):
        if not self.gmem_cells:
            return
        jnp = self._jnp
        base = self.gmem_base
        i = self._gmem_index(idx)
        vv = jnp.float64(val) if isinstance(val, float) else val
        if isinstance(i, int):
            if i < self.gmem_cells:
                self._mem_set(base + i, vv)
            return
        ii = jnp.where(i < self.gmem_cells, base + i, self.total_mem)
        self._mem_set(ii, vv, drop=True)

    # -- structured control flow ----------------------------------------------

    def _clone_files(self):
        import copy

        svc = self._fresh_file_service()
        svc.open_handles = {k: copy.copy(h)
                            for k, h in self._files.open_handles.items()}
        svc._next_handle = self._files._next_handle
        svc._free_handles = list(self._files._free_handles)
        return svc

    # branch-merge budget: every traced branch where-merges the whole
    # heap; past this count the XLA CPU compile blows up (observed: CMD's
    # 6922 merges OOM at 127 GB, ERBTilt's 562 compile fine) — reject at
    # trace time so the build falls back honestly
    _MERGE_BUDGET = 2048
    # adaptive static-while unroll: past this many branch merges the
    # unroll attempt is abandoned and the loop traces as a lax.while_loop
    # (env-overridable: tighter budgets shrink the lowered program, and
    # with it compile time and memory, at the cost of more lax loops)
    _UNROLL_MERGE_BUDGET = int(_os.environ.get(
        "ZORAK_UNROLL_MERGE_BUDGET", 2048))
    # companion budget for OP-EMITTING unrolls: iterations whose body
    # fails to fold (the vars/mem carries get new traced arrays) emit
    # real ops each trip — Sample.jsfx's @block has static whiles of
    # ~120k trips with near-zero merges that unrolled into an 843 MB
    # StableHLO module.  Folded iterations (pure trace-time arithmetic /
    # static-overlay writes) stay free; traced iterations charge their
    # body weight against this budget, then the loop re-traces as ONE
    # lax.while_loop.
    _UNROLL_TRACED_WEIGHT_BUDGET = int(_os.environ.get(
        "ZORAK_UNROLL_TRACED_WEIGHT_BUDGET", 1 << 14))

    # builtins with no observable side effects (heap reads are pure: they
    # gather, clamp, and touch no state)
    _PURE_FNS = frozenset(_SC_UNARY) | {
        "min", "max", "pow", "atan2", "strlen", "str_getchar", "__memtop"}

    def _is_pure(self, node: Node) -> bool:
        """True when evaluating `node` has NO observable side effect: no
        assignments anywhere (including inside called user functions), no
        loops, no stateful builtins.  Pure conditional arms evaluate
        speculatively and select with ONE jnp.where instead of the full
        branch-merge machinery (whole-vars where + heap-clone bookkeeping
        per merge): Sample.jsfx's denorm_zap ternary alone accounted for
        ~1000 merges per traced section.  Param-slot binding by pure user
        calls is the one write that slips through — unobservable, since
        every writeback skips ("param", ...) keys and call entry rebinds.
        """
        cached = self._pure_cache.get(id(node))
        if cached is None:
            cached = self._pure_walk(node, frozenset())
            self._pure_cache[id(node)] = cached
        return cached

    def _pure_walk(self, node, stack: frozenset) -> bool:
        from ..frontend.astnodes import walk

        for x in walk(node):
            if isinstance(x, (Asn, LoopExpr, WhileStmt, IfStmt)):
                return False
            if isinstance(x, CallExpr):
                if x.func in self.P.fn_defs:
                    if not self._fn_pure(x.func, stack):
                        return False
                elif x.func not in self._PURE_FNS:
                    return False
        return True

    def _fn_pure(self, fname: str, stack: frozenset) -> bool:
        c = self._fn_pure_cache.get(fname)
        if c is not None:
            return c
        ok = fname not in stack and self._pure_walk(
            self.P.fn_defs[fname].body, stack | {fname})
        self._fn_pure_cache[fname] = ok
        return ok

    def _pure_where(self, cond, then_node, else_node, scope):
        """cond ? pure : pure -> one select, zero merges."""
        jnp = self._jnp
        t = self.ex(then_node, scope) if then_node is not None else 0.0
        e = self.ex(else_node, scope) if else_node is not None else 0.0
        if isinstance(t, float) and isinstance(e, float) and t == e:
            return t
        m = EM.truthy_mask(cond)
        tv = jnp.float64(t) if isinstance(t, float) else t
        ev = jnp.float64(e) if isinstance(e, float) else e
        return jnp.where(m, tv, ev)

    def _merged(self, cond, then_fn, else_fn, src=None):
        """Predicated branch execution (if-conversion).

        Both arms run SPECULATIVELY on shared state under a branch
        predicate: heap writes self-mask against the predicate stack (see
        _mem_set/_mem_bulk), so the merged heap materializes in place —
        no write re-application, no whole-heap wheres.  An arm's heap
        writes are value-invisible to the other arm (a masked write
        leaves the old value wherever the arm is inactive), which gives
        exactly the sequential branch semantics.  Vars stay copy-based:
        a whole-vector where per merge is one cheap op, and it preserves
        arm-local static-constant folding (_known)."""
        jnp = self._jnp
        self._n_merges += 1
        if _DEVGEN_DEBUG and src is not None:
            self._merge_hist[src] = self._merge_hist.get(src, 0) + 1
        if self._n_merges > (self._MERGE_BUDGET << 5):
            raise DevgenError(
                "traced-branch merge count exceeds the fused-program "
                "compile budget")
        m = EM.truthy_mask(cond)
        outer = self._pred
        base_arr = self._vars_arr
        base_pend = dict(self._vpend)
        base_memo = dict(self._vmemo)
        files0 = self._clone_files()
        fp0 = self._file_fingerprint()
        known0 = dict(self._known)

        self._pred = m if outer is None else outer & m
        tval = then_fn() if then_fn is not None else 0.0
        t_arr, t_pend = self._vars_arr, dict(self._vpend)
        fp_t = self._file_fingerprint()
        t_known = self._known
        # rewind to the pre-branch state for the else arm
        self._vars_arr = base_arr
        self._vpend = dict(base_pend)
        self._vmemo = dict(base_memo)
        self._files, files_t = files0, self._files
        self._known = dict(known0)
        not_m = ~m
        self._pred = not_m if outer is None else outer & not_m
        eval_ = else_fn() if else_fn is not None else 0.0
        e_arr, e_pend = self._vars_arr, dict(self._vpend)
        fp_e = self._file_fingerprint()
        self._pred = outer
        # a slot stays statically known only if both arms agree on it
        self._known = {s: v for s, v in t_known.items()
                       if s in self._known and self._known[s] == v}
        # trace-time file-cursor state cannot be select-merged; arms must
        # leave it equal (self-contained open/read/close both sides, or
        # untouched) — otherwise later folds would be wrong
        if fp_t != fp_e:
            raise DevgenError(
                "file cursor state diverges across a data-dependent branch")
        if fp_t != fp0:
            self._files = files_t
        if t_arr is base_arr and e_arr is base_arr:
            # no nested flush in either arm: merge per written SLOT —
            # the whole-vector where and the per-write DUS both vanish
            self._vars_arr = base_arr
            self._vpend = dict(base_pend)
            self._vmemo = dict(base_memo)

            def _base_val(slot):
                v = base_pend.get(slot)
                if v is None:
                    v = base_memo.get(slot)
                if v is None:
                    v = base_arr[slot]
                return v

            for slot in set(t_pend) | set(e_pend):
                tv = t_pend.get(slot)
                ev = e_pend.get(slot)
                if tv is None:
                    tv = _base_val(slot)
                if ev is None:
                    ev = _base_val(slot)
                if tv is ev or (isinstance(tv, float)
                                and isinstance(ev, float) and tv == ev):
                    merged = tv
                else:
                    tvv = jnp.float64(tv) if isinstance(tv, float) else tv
                    evv = jnp.float64(ev) if isinstance(ev, float) else ev
                    merged = jnp.where(m, tvv, evv)
                self._vpend[slot] = merged
                self._vmemo[slot] = merged
        else:
            # an arm flushed mid-trace (nested loop/switch carried the
            # array): materialize both sides and where-merge the vector
            self._vars_arr, self._vpend = t_arr, t_pend
            self._vflush()
            t_full = self._vars_arr
            self._vars_arr, self._vpend = e_arr, e_pend
            self._vflush()
            e_full = self._vars_arr
            self.vars = (t_full if t_full is e_full
                         else jnp.where(m, t_full, e_full))
        if isinstance(tval, float) and isinstance(eval_, float) \
                and tval == eval_:
            return tval
        tv = jnp.float64(tval) if isinstance(tval, float) else tval
        ev = jnp.float64(eval_) if isinstance(eval_, float) else eval_
        return jnp.where(m, tv, ev)

    def _cond_outline_ok(self, then_node, else_node) -> bool:
        """Outline a traced branch as a real stablehlo.case when either
        arm is heavy (see cond_outline).  Trace-time file-cursor folds
        cannot ride a deferred region, so arms touching the file API
        keep the if-conversion path."""
        if not self.cond_outline:
            return False
        w = 0
        for node in (then_node, else_node):
            if node is None:
                continue
            got = self._stmt_weights.get(id(node))
            if got is None:
                got = self._node_weight(node)
                self._stmt_weights[id(node)] = got
            w = max(w, got)
        if w < self.cond_outline:
            return False
        for node in (then_node, else_node):
            if node is not None and self._has_file_ops(node):
                return False
        return True

    def _cond_switch(self, cond, then_node, else_node, scope, src=None):
        """Traced branch as jax.lax.switch: exactly one arm executes.

        Semantics match _merged (and the golden executors): the taken
        arm's writes land, the untaken arm's don't, the expression value
        is the taken arm's value (0.0 for a missing arm).  Under an
        ambient branch predicate the switch gains an identity branch so
        an inactive speculative context touches nothing.  Arms trace
        with NO predicate stack (they only run when taken, so their
        writes need no masking), entering with the current static
        overlay (valid at the branch point) and leaving only statics
        neither arm can write (_loop_kept_known)."""
        import jax

        jnp = self._jnp
        self._n_cond_outlined += 1
        m = EM.truthy_mask(cond)
        outer = self._pred
        kept = self._loop_kept_known(
            [x for x in (then_node, else_node) if x is not None], scope)
        known0 = dict(self._known)

        def arm(node):
            def f(ops):
                vars0, mem0 = ops
                save = (self.vars, self.mem, self._known, self._pred)
                self.vars, self.mem = vars0, mem0
                self._known = dict(known0)
                self._pred = None
                try:
                    val = self.ex(node, scope) if node is not None else 0.0
                    return (self.vars, self.mem,
                            jnp.asarray(self._arr(val), jnp.float64))
                finally:
                    (self.vars, self.mem,
                     self._known, self._pred) = save
            return f

        def ident(ops):
            v, mm = ops
            return v, mm, jnp.float64(0.0)

        mi = m.astype(jnp.int32)
        if outer is None:
            idx = mi
            branches = [arm(else_node), arm(then_node)]
        else:
            idx = jnp.where(outer, 1 + mi, 0)
            branches = [ident, arm(else_node), arm(then_node)]
        self.vars, self.mem, val = jax.lax.switch(
            idx, branches, (self.vars, self.mem))
        self._known = dict(kept)
        return val

    _FILE_FNS = frozenset({
        "file_open", "file_open_multi", "file_close", "file_avail",
        "file_rewind", "file_seek", "file_mem", "file_riff", "file_var",
        "file_multi_count", "file_multi_select"})

    def _has_file_ops(self, root: Node) -> bool:
        from ..frontend.astnodes import walk

        seen: Set[str] = set()

        def scan(node) -> bool:
            for x in walk(node):
                if isinstance(x, CallExpr):
                    if x.func in self._FILE_FNS:
                        return True
                    if x.func in self.P.fn_defs and x.func not in seen:
                        seen.add(x.func)
                        if scan(self.P.fn_defs[x.func].body):
                            return True
            return False

        return scan(root)

    # -- elementwise loop vectorization -----------------------------------------

    def _try_vec_elementwise(self, iv_ident: str, start: float, trip: int,
                             stmts: Sequence[Node], scope) -> bool:
        """Vectorize a unit-step elementwise loop (`while (i < n) (
        dest[i] = f(src[i], ...); i += 1 )`, the addbuf/overlap-add shape,
        ref: PsychoConvolver.jsfx:44-52,405-413) into sliced gathers and
        scatters — a traced per-element loop would be sequential scalar
        work on the device and a full unroll would explode the graph.

        Sound only when every mem address is concrete (statics + the
        induction), write addresses are strictly increasing, and read/write
        index sets are either identical or disjoint (no cross-iteration
        flow).  Returns True when handled; False restores state untouched."""
        jnp = self._jnp
        if trip <= 1:
            return False
        ivec = float(start) + np.arange(trip, dtype=np.float64)
        env: Dict[Any, Any] = {}
        reads: List[np.ndarray] = []
        writes: List[np.ndarray] = []
        # names assigned anywhere in the body: reading one before this
        # iteration assigned it would be cross-iteration flow
        assigned_names: Set[str] = set()
        for st in stmts:
            if isinstance(st, Asn) and isinstance(st.target, Name):
                assigned_names.add(st.target.ident)

        class _Reject(Exception):
            pass

        def concrete(v):
            if isinstance(v, float):
                return np.full(trip, v)
            if isinstance(v, np.ndarray):
                return v
            raise _Reject

        def addr_of(base, idx):
            a = concrete(base) + concrete(idx) + 1.0e-5
            a = np.trunc(a).astype(np.int64)
            a = np.maximum(a, 0)
            if int(a.max()) >= self.mem_size:
                raise _Reject
            return a

        _NP_BIN = {
            "+": np.add, "-": np.subtract, "*": np.multiply,
            "<": lambda a, b: (a < b).astype(np.float64),
            "<=": lambda a, b: (a <= b).astype(np.float64),
            ">": lambda a, b: (a > b).astype(np.float64),
            ">=": lambda a, b: (a >= b).astype(np.float64),
            "==": lambda a, b: (a == b).astype(np.float64),
            "!=": lambda a, b: (a != b).astype(np.float64),
        }
        _NP_UN = {"floor": np.floor, "ceil": np.ceil, "abs": np.abs,
                  "sqrt": np.sqrt}

        def vex(node, reading_addr=False):
            if isinstance(node, Const):
                return float(node.value)
            if isinstance(node, Str):
                return float(self.P.string_handle(node.text))
            if isinstance(node, Name):
                ident = node.ident
                if ident == iv_ident:
                    return ivec
                got = env.get(ident)
                if got is not None:
                    return got
                if ident in assigned_names:
                    raise _Reject  # read-before-write: cross-iteration
                if ident == "mem":
                    return 0.0
                c = dollar_const(ident)
                if c is not None:
                    return float(c)
                return self._read_name(ident, scope)
            if isinstance(node, Mem):
                if isinstance(node.base, Name) and node.base.ident == "gmem":
                    raise _Reject
                a = addr_of(vex(node.base), vex(node.index))
                reads.append(a)
                return self.mem[a]
            if isinstance(node, Un):
                v = vex(node.operand)
                if node.op == "+":
                    return v
                if node.op == "-":
                    return -v if isinstance(v, (float, np.ndarray)) \
                        else 0.0 - v
                if node.op == "!":
                    if isinstance(v, float):
                        return SC.eel_not(v)
                    if isinstance(v, np.ndarray):
                        return (np.abs(v) < 0.5).astype(np.float64)
                    return EM.eel_not(v)
                raise _Reject
            if isinstance(node, Bin):
                if node.op in ("&&", "||"):
                    raise _Reject
                a = vex(node.lhs)
                b = vex(node.rhs)
                if isinstance(a, float) and isinstance(b, float):
                    return _SC_BINARY[node.op](a, b)
                if isinstance(a, (float, np.ndarray)) \
                        and isinstance(b, (float, np.ndarray)) \
                        and node.op in _NP_BIN:
                    return _NP_BIN[node.op](a, b)
                return EM.BINARY[node.op](self._varr(a), self._varr(b))
            if isinstance(node, Cond):
                c = vex(node.pred)
                if isinstance(c, float):
                    return vex(node.then if SC.truthy(c) else node.other)
                t = vex(node.then)
                e = vex(node.other)
                if isinstance(c, np.ndarray) \
                        and isinstance(t, (float, np.ndarray)) \
                        and isinstance(e, (float, np.ndarray)):
                    return np.where(np.abs(c) >= 0.5, t, e) + 0.0
                return jnp.where(EM.truthy_mask(self._varr(c)),
                                 self._varr(t), self._varr(e))
            if isinstance(node, CallExpr):
                f = node.func
                if f in ("min", "max") and len(node.args) == 2:
                    a, b = vex(node.args[0]), vex(node.args[1])
                    if isinstance(a, float) and isinstance(b, float):
                        return _SC_BINARY[f](a, b)
                    if isinstance(a, (float, np.ndarray)) \
                            and isinstance(b, (float, np.ndarray)):
                        return (np.minimum if f == "min"
                                else np.maximum)(a, b)
                    return EM.BINARY[f](self._varr(a), self._varr(b))
                if f in _SC_UNARY and len(node.args) == 1:
                    a = vex(node.args[0])
                    if isinstance(a, float):
                        return _SC_UNARY[f](a)
                    if isinstance(a, np.ndarray) and f in _NP_UN:
                        return _NP_UN[f](a)
                    fn = EM.UNARY.get(f) or _EM_UNARY_EXTRA.get(f)
                    if fn is None:
                        raise _Reject
                    return fn(self._varr(a))
                if f in ("pow", "atan2") and len(node.args) == 2:
                    a, b = vex(node.args[0]), vex(node.args[1])
                    if isinstance(a, float) and isinstance(b, float):
                        return _SC_BINARY[f](a, b)
                    return EM.BINARY[f](self._varr(a), self._varr(b))
                raise _Reject
            raise _Reject

        mem0, vars0, known0 = self.mem, self.vars, dict(self._known)
        try:
            for st in stmts:
                if not isinstance(st, Asn):
                    raise _Reject
                tgt = st.target
                if isinstance(tgt, Name):
                    if tgt.ident == iv_ident:
                        raise _Reject  # only the recognized increment may
                    rhs = vex(st.value)
                    if st.op != "=":
                        cur = vex(tgt)
                        op = _COMPOUND_OPS[st.op]
                        if isinstance(cur, float) and isinstance(rhs, float):
                            rhs = _SC_BINARY[op](cur, rhs)
                        elif isinstance(cur, (float, np.ndarray)) \
                                and isinstance(rhs, (float, np.ndarray)) \
                                and op in _NP_BIN:
                            rhs = _NP_BIN[op](cur, rhs)
                        else:
                            rhs = EM.BINARY[op](self._varr(cur),
                                                self._varr(rhs))
                    env[tgt.ident] = rhs
                elif isinstance(tgt, Mem):
                    if isinstance(tgt.base, Name) and tgt.base.ident == "gmem":
                        raise _Reject
                    a = addr_of(vex(tgt.base), vex(tgt.index))
                    if not bool(np.all(np.diff(a) > 0)):
                        raise _Reject  # duplicate/unordered write slots
                    rhs = vex(st.value)
                    if st.op != "=":
                        reads.append(a)
                        cur = self.mem[a]
                        rhs = EM.BINARY[_COMPOUND_OPS[st.op]](
                            cur, self._varr(rhs))
                    writes.append(a)
                    vals = self._varr(rhs)
                    if getattr(vals, "ndim", 0) == 0:
                        vals = jnp.full((trip,), vals, dtype=jnp.float64)
                    self._mem_set(a, vals)
                else:
                    raise _Reject
            # cross-iteration hazard check: every (read, write) index pair
            # must be identical (same-cell-same-iteration) or disjoint
            for w in writes:
                for r in reads:
                    if r.shape == w.shape and np.array_equal(r, w):
                        continue
                    if np.intersect1d(r, w).size:
                        raise _Reject
            # write-write: two statements writing shifted overlapping
            # addresses reorder under vectorization (all of stmt1, then
            # all of stmt2) — require identical (later statement wins,
            # same as sequential) or disjoint address vectors
            for i in range(len(writes)):
                for j in range(i + 1, len(writes)):
                    w1, w2 = writes[i], writes[j]
                    if w1.shape == w2.shape and np.array_equal(w1, w2):
                        continue
                    if np.intersect1d(w1, w2).size:
                        raise _Reject
        except _Reject:
            self.mem, self.vars, self._known = mem0, vars0, known0
            return False
        # commit final values of iteration temps and the induction
        ivk = scope.get(iv_ident) or _env_key(iv_ident)
        keys = {ident: (scope.get(ident) or _env_key(ident))
                for ident in env}
        if ivk not in self.slots or ivk[0] == "builtin" or any(
                k not in self.slots or k[0] == "builtin"
                for k in keys.values()):
            self.mem, self.vars, self._known = mem0, vars0, known0
            return False
        for ident, v in env.items():
            key = keys[ident]
            if isinstance(v, np.ndarray):
                self._write_slot(key, float(v[-1]))
            elif isinstance(v, float):
                self._write_slot(key, v)
            else:
                last = v[-1] if getattr(v, "ndim", 0) else v
                self._write_slot(key, last)
        self._write_slot(ivk, float(start + trip))
        return True

    def _varr(self, v):
        """Promote float/np/traced to a traced value."""
        if isinstance(v, float):
            return self._jnp.float64(v)
        if isinstance(v, np.ndarray):
            return self._jnp.asarray(v)
        return v

    @staticmethod
    def _match_unit_increment(st: Node, scope) -> Optional[str]:
        """`i += 1` / `i = i + 1` -> 'i'."""
        if not (isinstance(st, Asn) and isinstance(st.target, Name)):
            return None
        iv = st.target.ident
        if st.op == "+=" and isinstance(st.value, Const) \
                and st.value.value == 1.0:
            return iv
        if st.op == "=" and isinstance(st.value, Bin) and st.value.op == "+":
            a, b = st.value.lhs, st.value.rhs
            if isinstance(a, Name) and a.ident == iv \
                    and isinstance(b, Const) and b.value == 1.0:
                return iv
            if isinstance(b, Name) and b.ident == iv \
                    and isinstance(a, Const) and a.value == 1.0:
                return iv
        return None

    def _vec_while(self, n: WhileStmt, scope) -> bool:
        """Try elementwise vectorization of `while (i < bound) (...; i+=1)`."""
        p = n.pred
        if not (isinstance(p, Bin) and p.op == "<" and isinstance(p.lhs, Name)):
            return False
        iv = p.lhs.ident
        body = n.body.items if isinstance(n.body, Block) else [n.body]
        if not body or self._match_unit_increment(body[-1], scope) != iv:
            return False
        try:
            bound = self.ex(p.rhs, dict(scope))
            start = self._read_name(iv, scope)
        except DevgenError:
            return False
        if not (isinstance(bound, float) and isinstance(start, float)):
            return False
        trip = int(SC.eel_ceil(bound - start))
        if trip <= 1 or trip > (1 << 22):
            return False
        return self._try_vec_elementwise(iv, start, trip, body[:-1], scope)

    def _loop_kept_known(self, nodes: Sequence[Node], scope) -> Dict[int, float]:
        """Static overlay surviving a traced loop: slots whose env key the
        loop body can never assign keep their known values (e.g. a file
        handle consulted after a long resample loop)."""
        from ..frontend.astnodes import walk as _walk

        written: Set[Any] = set()
        seen_fns: Set[str] = set()

        def lval(node, sc):
            if isinstance(node, Name):
                written.add(sc.get(node.ident) or _env_key(node.ident))

        def scan(roots, sc):
            for root in roots:
                for x in _walk(root):
                    if isinstance(x, Asn):
                        lval(x.target, sc)
                    elif isinstance(x, CallExpr):
                        f = x.func
                        if f in self.P.fn_defs and f not in seen_fns:
                            seen_fns.add(f)
                            fdef = self.P.fn_defs[f]
                            inner = {p: ("param", f, p) for p in fdef.params}
                            written.update(inner.values())
                            scan([fdef.body], inner)
                        elif f == "file_riff" and len(x.args) == 3:
                            lval(x.args[1], sc)
                            lval(x.args[2], sc)
                        elif f == "file_var" and len(x.args) == 2:
                            lval(x.args[1], sc)

        scan(nodes, scope)
        wslots = {self.slots[k] for k in written if k in self.slots}
        return {s: v for s, v in self._known.items() if s not in wslots}

    # short static loops unroll for trace-time folding — UNLESS the body
    # is big: re-tracing a large body per iteration multiplies the traced
    # program (Texture's loop(beam_width, ...) over candidate_weight
    # re-traced the ~150-line weight stack 160x -> a 7 MB StableHLO
    # module).  Past this node-weight x
    # trip product the loop lowers as lax.fori_loop (body traced once).
    _UNROLL_WEIGHT_BUDGET = int(_os.environ.get(
        "ZORAK_UNROLL_WEIGHT_BUDGET", 2048))

    def _node_weight(self, root: Node) -> int:
        """Approximate traced size of a subtree: AST nodes, with calls to
        user functions expanded once each (memoized, cycle-guarded)."""
        from ..frontend.astnodes import walk

        cache = self._fn_weights

        def fn_weight(fname: str, stack: frozenset) -> int:
            if fname in cache:
                return cache[fname]
            if fname in stack:
                return 0
            w = weigh(self.P.fn_defs[fname].body, stack | {fname})
            cache[fname] = w
            return w

        def weigh(node, stack: frozenset) -> int:
            w = 0
            for x in walk(node):
                w += 1
                if isinstance(x, CallExpr) and x.func in self.P.fn_defs:
                    w += fn_weight(x.func, stack)
            return w

        return weigh(root, frozenset())

    def _loop(self, n: LoopExpr, scope):
        import jax

        jnp = self._jnp
        cnt = self.ex(n.count, scope)
        if isinstance(cnt, float):
            trip = max(SC.trunc_i64(cnt), 0)
            if trip > 8 and self._has_file_ops(n.body):
                # trace-time file folds must run once per iteration
                if trip > (1 << 16):
                    raise DevgenError("file-reading loop too long to unroll")
                last: Any = 0.0
                for _it in range(trip):
                    if _it and _it % 8192 == 0:
                        _trace_note(f"file-loop unroll {_it}/{trip}")
                    last = self.ex(n.body, scope)
                return last
            if trip <= 8 and (self._has_file_ops(n.body)
                              or trip * self._node_weight(n.body)
                              <= self._UNROLL_WEIGHT_BUDGET):
                last: Any = 0.0
                for _ in range(trip):
                    last = self.ex(n.body, scope)
                return last
            body_items = n.body.items if isinstance(n.body, Block) \
                else [n.body]
            if body_items and trip <= (1 << 22):
                iv = self._match_unit_increment(body_items[-1], scope)
                if iv is not None:
                    start = self._read_name(iv, scope)
                    if isinstance(start, float) and self._try_vec_elementwise(
                            iv, start, trip, body_items[:-1], scope):
                        return 0.0
            trip_val: Any = trip
        else:
            if self._has_file_ops(n.body):
                raise DevgenError("file ops inside a dynamic-count loop")
            trip_val = jnp.maximum(EM.to_i64(cnt), 0)

        kept = self._loop_kept_known([n.body], scope)

        def body(_i, carry):
            self.vars, self.mem, _last = carry
            self._known = dict(kept)  # loop-written slots are not static
            v = self.ex(n.body, scope)
            v = jnp.float64(v) if isinstance(v, float) else v
            return (self.vars, self.mem, v)

        if self._pred is not None:
            # speculative arm: a garbage traced trip must not spin the
            # loop (and a static trip need not run at all when inactive)
            trip_val = jnp.where(self._pred, trip_val, 0)
        carry0 = (self.vars, self.mem, jnp.float64(0.0))
        self.vars, self.mem, last = jax.lax.fori_loop(
            0, trip_val, body, carry0)
        self._known = dict(kept)
        return last

    def _while(self, n: WhileStmt, scope):
        import jax

        jnp = self._jnp
        # predicate side effects run once before each test: evaluate the
        # predicate now, then (body; predicate) per iteration
        p0 = self.ex(n.pred, scope)
        if isinstance(p0, float) and (self._has_file_ops(n.body)
                                      or self._has_file_ops(n.pred)):
            # file folds must run per iteration: unroll while the
            # predicate stays static (chunked readers)
            guard = 1 << 16
            while isinstance(p0, float) and SC.truthy(p0):
                guard -= 1
                if guard < 0:
                    raise DevgenError("file-reading while() too long")
                if guard % 8192 == 0:
                    _trace_note(f"file-while unroll (guard {guard})")
                self.ex(n.body, scope)
                p0 = self.ex(n.pred, scope)
            if isinstance(p0, float):
                return 0.0
            raise DevgenError(
                "file-reading while() predicate became data-dependent")
        if isinstance(p0, float):
            if not SC.truthy(p0):
                return 0.0
            # elementwise shape -> sliced gathers/scatters in one shot
            if self._vec_while(n, scope):
                return 0.0
            # static predicate: unroll at trace time while it stays static
            # (trim/energy scans over folded state); transition to a traced
            # loop the moment it becomes data-dependent.  The unroll is
            # ADAPTIVE: once its traced-branch expansion passes a budget the
            # pre-loop state is restored and the whole loop re-traces as ONE
            # lax.while_loop body — Sample.jsfx's 16-voice x ~1400-line
            # voice while() would otherwise unroll to 65k+ branch merges
            # (observed) and an uncompilable program.
            saved = (self.vars, self.mem, dict(self._known),
                     self._n_merges)
            m0 = self._n_merges
            bw = max(1, self._node_weight(n.body))
            traced_weight = 0
            bailed = False
            guard = 1 << 17
            while isinstance(p0, float) and SC.truthy(p0):
                guard -= 1
                if guard < 0:
                    raise DevgenError("static while() too long to unroll")
                if guard % 8192 == 0:
                    _trace_note(f"static-while unroll (guard {guard}, "
                                f"merges {self._n_merges}, "
                                f"traced weight {traced_weight})")
                if (self._n_merges - m0 > self._UNROLL_MERGE_BUDGET
                        or traced_weight
                        > self._UNROLL_TRACED_WEIGHT_BUDGET):
                    bailed = True
                    break
                # op-emitting iterations are detectable by identity: jnp
                # arrays are immutable, so any traced write replaces
                # self.vars/self.mem; a fully folded iteration (pure
                # trace-time arithmetic / static-overlay writes) leaves
                # both objects untouched and stays free
                vars0, mem0 = self.vars, self.mem
                self.ex(n.body, scope)
                if self.vars is not vars0 or self.mem is not mem0:
                    traced_weight += bw
                p0 = self.ex(n.pred, scope)
            if not bailed and isinstance(p0, float):
                return 0.0
            if bailed:
                (self.vars, self.mem, self._known, self._n_merges) = saved
                p0 = jnp.float64(1.0)  # predicate was statically true
        carry0 = (self.vars, self.mem, p0)
        kept = self._loop_kept_known([n.body, n.pred], scope)
        pred = self._pred

        def cond(c):
            t = EM.truthy_mask(c[2])
            # speculative arm: a garbage predicate must not spin the loop
            return t if pred is None else t & pred

        def body(c):
            self.vars, self.mem, _p = c
            self._known = dict(kept)  # loop-written slots are not static
            self.ex(n.body, scope)
            p = self.ex(n.pred, scope)
            p = jnp.float64(p) if isinstance(p, float) else p
            return (self.vars, self.mem, p)

        self.vars, self.mem, _ = jax.lax.while_loop(cond, body, carry0)
        self._known = dict(kept)
        return 0.0

    # -- expression evaluation --------------------------------------------------

    def ex(self, n: Node, scope: Optional[Dict[str, Any]] = None):
        scope = scope if scope is not None else {}
        jnp = self._jnp
        if isinstance(n, Const):
            return float(n.value)
        if isinstance(n, Str):
            return float(self.P.string_handle(n.text))
        if isinstance(n, Name):
            return self._read_name(n.ident, scope)
        if isinstance(n, Mem):
            if isinstance(n.base, Name) and n.base.ident == "gmem":
                return self._gmem_get(self.ex(n.index, scope))
            b = self.ex(n.base, scope)
            i = self.ex(n.index, scope)
            return self._mem_get(self._mem_addr(b, i))
        if isinstance(n, Un):
            a = self.ex(n.operand, scope)
            if n.op == "+":
                return a
            if n.op == "-":
                return (0.0 - a) if isinstance(a, float) else 0.0 - a
            if n.op == "!":
                return SC.eel_not(a) if isinstance(a, float) else EM.eel_not(a)
            raise DevgenError(f"unary {n.op!r}")
        if isinstance(n, Bin):
            if n.op in ("&&", "||"):
                return self._logical(n, scope)
            a = self.ex(n.lhs, scope)
            b = self.ex(n.rhs, scope)
            if isinstance(a, float) and isinstance(b, float):
                return _SC_BINARY[n.op](a, b)
            return EM.BINARY[n.op](self._arr(a), self._arr(b))
        if isinstance(n, Cond):
            c = self.ex(n.pred, scope)
            if isinstance(c, float):
                taken = n.then if SC.truthy(c) else n.other
                return self.ex(taken, scope)
            if self._is_pure(n.then) and (n.other is None
                                          or self._is_pure(n.other)):
                return self._pure_where(c, n.then, n.other, scope)
            if self._cond_outline_ok(n.then, n.other):
                return self._cond_switch(c, n.then, n.other, scope,
                                         src=n.pos)
            return self._merged(c, lambda: self.ex(n.then, scope),
                                lambda: self.ex(n.other, scope), src=n.pos)
        if isinstance(n, Asn):
            return self._assign(n, scope)
        if isinstance(n, CallExpr):
            return self._call(n, scope)
        if isinstance(n, LoopExpr):
            return self._loop(n, scope)
        if isinstance(n, Block):
            last: Any = 0.0
            for item in n.items:
                last = self.ex(item, scope)
            return last
        if isinstance(n, IfStmt):
            c = self.ex(n.pred, scope)
            if isinstance(c, float):
                if SC.truthy(c):
                    self.ex(n.then, scope)
                elif n.other is not None:
                    self.ex(n.other, scope)
                return 0.0
            if self._cond_outline_ok(n.then, n.other):
                self._cond_switch(c, n.then, n.other, scope, src=n.pos)
                return 0.0
            self._merged(
                c, lambda: self.ex(n.then, scope),
                (lambda: self.ex(n.other, scope))
                if n.other is not None else None, src=n.pos)
            return 0.0
        if isinstance(n, WhileStmt):
            return self._while(n, scope)
        raise DevgenError(f"unsupported node {type(n).__name__}")

    def _arr(self, v):
        return self._jnp.float64(v) if isinstance(v, float) else v

    def _logical(self, n: Bin, scope):
        a = self.ex(n.lhs, scope)
        if isinstance(a, float):
            at = SC.truthy(a)
            if n.op == "&&" and not at:
                return 0.0
            if n.op == "||" and at:
                return 1.0
            b = self.ex(n.rhs, scope)
            if isinstance(b, float):
                return 1.0 if SC.truthy(b) else 0.0
            return EM._bool_to_f(EM.truthy_mask(b))
        # traced lhs + pure rhs: no state to merge — evaluate the rhs
        # speculatively and combine the truth masks directly
        if self._is_pure(n.rhs):
            jnp = self._jnp
            b = self.ex(n.rhs, scope)
            bm = EM.truthy_mask(jnp.float64(b) if isinstance(b, float)
                                else b)
            am = EM.truthy_mask(a)
            return EM._bool_to_f(am & bm if n.op == "&&" else am | bm)
        # traced lhs: the rhs arm runs under a state merge (it may assign)
        if n.op == "&&":
            return self._merged(
                a, lambda: self._bool_val(self.ex(n.rhs, scope)), None,
                src=n.pos)
        inv = EM.eel_not(a)
        return self._merged(
            inv, lambda: self._bool_val(self.ex(n.rhs, scope)),
            lambda: 1.0, src=n.pos)

    def _bool_val(self, v):
        if isinstance(v, float):
            return 1.0 if SC.truthy(v) else 0.0
        return EM._bool_to_f(EM.truthy_mask(v))

    def _assign(self, n: Asn, scope):
        rhs = self.ex(n.value, scope)
        tgt = n.target
        if isinstance(tgt, Name):
            ident = tgt.ident
            if ident in ("mem", "gmem"):
                raise DevgenError(f"assignment to {ident}")
            key = scope.get(ident) or _env_key(ident)
            if n.op == "=":
                out = rhs
            else:
                cur = self._read_name(ident, scope)
                op = _COMPOUND_OPS[n.op]
                if isinstance(cur, float) and isinstance(rhs, float):
                    out = _SC_BINARY[op](cur, rhs)
                else:
                    out = EM.BINARY[op](self._arr(cur), self._arr(rhs))
            if key[0] == "builtin":
                raise DevgenError(f"assignment to builtin {key[1]}")
            self._write_slot(key, out)
            return out
        if isinstance(tgt, Mem):
            if isinstance(tgt.base, Name) and tgt.base.ident == "gmem":
                i = self.ex(tgt.index, scope)
                if n.op == "=":
                    out = rhs
                else:
                    out = EM.BINARY[_COMPOUND_OPS[n.op]](
                        self._arr(self._gmem_get(i)), self._arr(rhs))
                self._gmem_set(i, out)
                return out
            b = self.ex(tgt.base, scope)
            i = self.ex(tgt.index, scope)
            a = self._mem_addr(b, i)
            if n.op == "=":
                out = rhs
            else:
                cur = self._mem_get(a)
                out = EM.BINARY[_COMPOUND_OPS[n.op]](self._arr(cur),
                                                     self._arr(rhs))
            self._mem_set(a, out, heap=True)
            return out
        if isinstance(tgt, CallExpr) and tgt.func in ("slider", "spl") \
                and len(tgt.args) == 1:
            raise DevgenError(f"dynamic {tgt.func}() assignment")
        raise DevgenError("invalid assignment target")

    # -- calls ------------------------------------------------------------------

    def _call(self, n: CallExpr, scope):
        f = n.func
        if f in self.P.fn_defs:
            return self._user_call(f, n.args, scope)
        if f in ("min", "max") and len(n.args) == 2:
            a = self.ex(n.args[0], scope)
            b = self.ex(n.args[1], scope)
            if isinstance(a, float) and isinstance(b, float):
                return _SC_BINARY[f](a, b)
            return EM.BINARY[f](self._arr(a), self._arr(b))
        if f in _SC_UNARY and len(n.args) == 1:
            a = self.ex(n.args[0], scope)
            if isinstance(a, float):
                return _SC_UNARY[f](a)
            fn = EM.UNARY.get(f) or _EM_UNARY_EXTRA.get(f)
            if fn is None:
                raise DevgenError(f"no device impl for {f}()")
            return fn(a)
        if f in ("pow", "atan2") and len(n.args) == 2:
            a = self.ex(n.args[0], scope)
            b = self.ex(n.args[1], scope)
            if isinstance(a, float) and isinstance(b, float):
                return _SC_BINARY[f](a, b)
            return EM.BINARY[f](self._arr(a), self._arr(b))
        if f == "memset" and len(n.args) == 3:
            return self._memset(n.args, scope)
        if f == "memcpy" and len(n.args) == 3:
            return self._memcpy(n.args, scope)
        if f in ("fft", "ifft", "fft_real", "ifft_real", "fft_permute",
                 "fft_ipermute", "convolve_c"):
            return self._fft_call(f, n.args, scope)
        if f in ("file_open", "file_open_multi", "file_close", "file_avail",
                 "file_rewind", "file_seek", "file_text", "file_mem",
                 "file_riff", "file_var", "file_multi_count",
                 "file_multi_select"):
            return self._file_call(f, n.args, scope)
        if f == "midirecv":
            return self._midirecv(n.args, scope)
        if f == "midisend":
            return self._midisend(n.args, scope)
        if f in ("strlen", "str_getchar"):
            # static string table (literal pool); mutations are inert in
            # ALL executors (golden contract: shadow/pyexec._INERT_FUNCS)
            vals = [self.ex(a, scope) for a in n.args]
            if not all(isinstance(v, float) for v in vals):
                # traced handle/index (e.g. inside a traced loop): strings
                # are static data, so the call lowers to gathers over the
                # packed literal-pool table
                return self._str_gather(f, vals)
            host = getattr(self.snap, "host", None)
            if host is None:
                return 0.0
            if f == "strlen":
                return float(host.strlen(self.snap, vals[0]))
            return float(host.str_getchar(self.snap, vals[0], vals[1]))
        if f in ("sprintf", "printf", "strcpy", "strcat", "strcmp",
                 "str_setchar", "str_insert", "str_delete", "str_mid",
                 "strncpy"):
            for a in n.args:
                self.ex(a, scope)
            return 0.0
        if f in self._MSG_DEVICE_FNS and self.msg_cfg is not None:
            return self._msg_call(f, n.args, scope)
        if f in self._COMM_FNS and self.comm_solo:
            # inert solo semantics (matches shadow.state.HostServices):
            # args still evaluate (reads only — out-params of msg_recv/
            # msg_peek stay untouched when no message arrives, exactly the
            # golden executors' behavior), result is 0 / the instance id
            for a in n.args:
                self.ex(a, scope)
            if f == "instance_id":
                host = getattr(self.snap, "host", None)
                return float(getattr(host, "instance_id_value", 0.0))
            return 0.0
        if f == "rand" and self.rand_cells > 0:
            return self._rand_call(n.args, scope)
        if f in self._POOL_FNS:
            return self._pool_call(f, n.args, scope)
        if f == "__memtop":
            return float(self.P.memtop)
        if f == "freembuf":
            for a in n.args:
                self.ex(a, scope)
            return 0.0
        if f in ("time", "time_precise"):
            # deterministic virtual clock (host-advanced; static per render)
            host = getattr(self.snap, "host", None)
            v = float(host.now(f == "time_precise")) if host is not None \
                else 0.0
            if n.args:
                self._store_lv(n.args[0], v, scope, f)
            return v
        if f in self._GMEM_FNS:
            return self._gmem_call(f, n.args, scope)
        if f in ("sliderchange", "slider_automate"):
            return self._slider_pending_call(f, n.args, scope)
        if f in ("slider", "spl") and len(n.args) == 1:
            raise DevgenError(f"dynamic {f}() read")
        raise DevgenError(f"@{self.section} builtin {f}() not "
                          "device-executable")

    _str_tab = None

    def _str_tables(self):
        """Packed literal-pool tables: (handles i64[H], lengths f64[H],
        chars f64[H, maxlen]).  Strings are immutable in all executors so
        a snapshot at build time is the complete truth."""
        if self._str_tab is None:
            items = sorted((int(h), s or "") for h, s in
                           getattr(self.snap, "strings_by_handle",
                                   {}).items())
            if not items:
                items = [(-1, "")]
            maxlen = max(1, max(len(s) for _, s in items))
            handles = np.asarray([h for h, _ in items], np.int64)
            lengths = np.asarray([len(s) for _, s in items], np.float64)
            chars = np.zeros((len(items), maxlen), np.float64)
            for r, (_h, s) in enumerate(items):
                for i, ch in enumerate(s):
                    chars[r, i] = float(ord(ch))
            # cache NUMPY arrays: converting here would capture trace-local
            # constants (tracers) when first called under jit and leak them
            # into later traces
            self._str_tab = (handles, lengths, chars)
        return self._str_tab

    def _str_gather(self, f: str, vals):
        """strlen/str_getchar with a traced handle (and index): row lookup
        by exact handle match, zero for unknown handles / out-of-range
        indices — the golden-host semantics (shadow/state.py:130-138)."""
        jnp = self._jnp
        handles, lengths, chars = (jnp.asarray(a)
                                   for a in self._str_tables())
        h = EM.to_i64(self._arr(vals[0]))
        idx = jnp.searchsorted(handles, h)
        idx_c = jnp.clip(idx, 0, handles.shape[0] - 1)
        ok = handles[idx_c] == h
        ln = jnp.where(ok, lengths[idx_c], 0.0)
        if f == "strlen":
            return ln
        i = EM.to_i64(self._arr(vals[1]))
        inb = ok & (i >= 0) & (i < EM.to_i64(ln))
        ch = chars[idx_c, jnp.clip(i, 0, chars.shape[1] - 1)]
        return jnp.where(inb, ch, 0.0)

    from ..ir.analyses import FUNSETS as _FUNSETS
    _POOL_FNS = _FUNSETS.POOL_ALL
    _POOL_SETUP = frozenset({"sample_pool_from_slot", "sample_pool_commit",
                             "sample_pool_set_mode",
                             "sample_pool_set_budget_mb"})

    def _store_lv(self, tgt: Node, val, scope, fn: str) -> None:
        """Write a value to an out-param lvalue (Name or mem[])."""
        if isinstance(tgt, Name):
            key = scope.get(tgt.ident) or _env_key(tgt.ident)
            if key[0] == "builtin":
                raise DevgenError(f"{fn}: out-arg writes builtin {key[1]}")
            self._write_slot(key, val)
            return
        if isinstance(tgt, Mem):
            if isinstance(tgt.base, Name) and tgt.base.ident == "gmem":
                self._gmem_set(self.ex(tgt.index, scope), val)
                return
            a = self._mem_addr(self.ex(tgt.base, scope),
                               self.ex(tgt.index, scope))
            self._mem_set(a, val, heap=True)
            return
        raise DevgenError(f"{fn}: out-arg must be an lvalue")

    def _pool_call(self, fn: str, args: Sequence[Node], scope):
        """sample_* pool API at trace time.

        The pool is host-side state; with NO loaded generation every call
        is inert/constant (reads return 0, queries their empty-pool
        values — exactly the golden host's behavior), so the whole API
        folds.  A LOADED pool would need device gathers over the packed
        generation buffer — rejected honestly until that lands."""
        host = getattr(self.snap, "host", None)
        pool = getattr(host, "pool", None)
        gen = getattr(pool, "generation", None) if pool is not None else None
        loaded = bool(gen is not None and getattr(gen, "entries", None))
        if fn in self._POOL_SETUP:
            if loaded:
                raise DevgenError(
                    f"{fn} with a loaded sample pool — a device section "
                    "cannot re-commit generations (host golden handles "
                    "pool mutation)")
            files = getattr(host, "files", None)
            if files is not None and any(files.slots.values()):
                raise DevgenError(
                    f"{fn} with populated file slots — pool setup would "
                    "load at trace time (host golden handles it)")
        if loaded:
            return self._pool_gather_call(fn, args, scope)
        if fn in ("sample_read2", "sample_read2_interp") and len(args) == 5:
            for a in args[:3]:
                self.ex(a, scope)
            self._store_lv(args[3], 0.0, scope, fn)
            self._store_lv(args[4], 0.0, scope, fn)
            return 0.0
        if fn == "sample_preview_read" and len(args) == 6:
            for a in args[:3]:
                self.ex(a, scope)
            for a in args[3:]:
                self._store_lv(a, 0.0, scope, fn)
            return 0.0
        if fn == "sample_name" and len(args) >= 2:
            self.ex(args[0], scope)
            for a in args[2:]:
                self.ex(a, scope)
            return 0.0
        vals = [self.ex(a, scope) for a in args]
        if host is None:
            return 0.0
        if all(isinstance(v, float) for v in vals):
            try:
                return float(host.sample_pool_call(self.snap, fn,
                                                   list(vals)))
            except Exception:  # noqa: BLE001 — inert like the stub host
                return 0.0
        # traced args over an EMPTY pool: reads/queries are 0
        return 0.0

    _pool_tab = None

    def _pool_tables(self):
        """Packed device view of the LOADED pool generation: per-sid
        metadata tables (row 0 = invalid sid) + ONE concatenated
        frame-major f32 data buffer + packed preview bins.  A generation
        is immutable for the life of a render (the async pipeline swaps
        whole generations, ref: DspJsfxSamplePool.cpp:96-150), so a
        build-time snapshot is the complete truth.  Cached as NUMPY so
        repeated traces (lax.scan traces its body twice) never leak
        trace-local constants."""
        if self._pool_tab is None:
            gen = self.snap.host.pool.generation
            maxsid = max(gen.entries)
            offs = np.zeros(maxsid + 1, np.int64)
            frm = np.zeros(maxsid + 1, np.int64)
            nchs = np.zeros(maxsid + 1, np.int64)
            meta = np.zeros((maxsid + 1, 3), np.float64)  # srate, peak, rms
            pv_off = np.zeros(maxsid + 1, np.int64)
            pv_bins = np.zeros(maxsid + 1, np.int64)
            datas, pvs = [], []
            cur = pcur = 0
            for sid in sorted(gen.entries):
                e = gen.entries[sid]
                offs[sid], frm[sid] = cur, e.data.shape[0]
                nchs[sid] = e.data.shape[1]
                meta[sid] = (float(e.srate), e.peak, e.rms)
                datas.append(np.asarray(e.data, np.float32).reshape(-1))
                cur += e.data.size
                pv_off[sid], pv_bins[sid] = pcur, len(e.preview)
                pvs.append(np.asarray(e.preview, np.float64).reshape(-1))
                pcur += e.preview.size
            self._pool_tab = {
                "maxsid": maxsid, "offs": offs, "frm": frm, "nch": nchs,
                "meta": meta, "pv_off": pv_off, "pv_bins": pv_bins,
                "data": (np.concatenate(datas) if cur
                         else np.zeros(1, np.float32)),
                "pv": (np.concatenate(pvs) if pcur
                       else np.zeros(3, np.float64)),
                "order": np.asarray(gen.order or [0], np.int64),
                "n_order": len(gen.order),
            }
        return self._pool_tab

    def _pool_sid_ok(self, sid):
        """(sid_clipped_i64, valid_mask) for a traced sample id."""
        jnp = self._jnp
        t = self._pool_tables()
        sid_i = EM.to_i64(self._arr(sid))
        ok = (sid_i >= 1) & (sid_i <= t["maxsid"])
        return jnp.clip(sid_i, 0, t["maxsid"]), ok

    def _pool_read_scalar(self, sid, ch, frame):
        """sample_read semantics on device (services.py:284-299): python
        round() (half-even) frame index, truncated+clamped channel,
        non-finite frame treated as 0, out-of-range -> 0.0."""
        jnp = self._jnp
        t = self._pool_tables()
        sc, ok = self._pool_sid_ok(sid)
        n_fr = jnp.asarray(t["frm"])[sc]
        n_ch = jnp.asarray(t["nch"])[sc]
        fr = self._arr(frame)
        fr = jnp.where(jnp.isfinite(fr), fr, 0.0)
        f = jnp.round(fr).astype(jnp.int64)
        c = jnp.clip(EM.to_i64(self._arr(ch)), 0, jnp.maximum(n_ch - 1, 0))
        ok = ok & (n_fr > 0) & (n_ch > 0) & (f >= 0) & (f < n_fr)
        data = jnp.asarray(t["data"])
        idx = jnp.asarray(t["offs"])[sc] + f * n_ch + c
        val = data[jnp.clip(idx, 0, data.shape[0] - 1)].astype(jnp.float64)
        return jnp.where(ok, val, 0.0)

    def _pool_read_interp(self, sid, ch, phase):
        jnp = self._jnp
        ph = self._arr(phase)
        ph = jnp.where(jnp.isfinite(ph), ph, 0.0)
        base = jnp.floor(ph)
        frac = ph - base
        x0 = self._pool_read_scalar(sid, ch, base)
        x1 = self._pool_read_scalar(sid, ch, base + 1.0)
        return x0 + (x1 - x0) * frac

    def _pool_gather_call(self, fn: str, args: Sequence[Node], scope):
        """Loaded-pool API on device: metadata/read calls become gathers
        over the packed generation buffer; generation-static pool-level
        queries fold to constants (exactly the golden host's values,
        services.py:349-404)."""
        jnp = self._jnp
        host = self.snap.host
        t = self._pool_tables()

        if fn in ("sample_export_mem", "sample_export_mem2"):
            raise DevgenError(
                f"{fn} with a loaded pool — device heap export not "
                "implemented (host golden handles it)")

        if fn in ("sample_read2", "sample_read2_interp") and len(args) == 5:
            self.ex(args[0], scope)  # pool handle (side effects only)
            sid = self.ex(args[1], scope)
            ph = self._arr(self.ex(args[2], scope))
            sc, oks = self._pool_sid_ok(sid)
            n_fr = jnp.asarray(t["frm"])[sc]
            n_ch = jnp.asarray(t["nch"])[sc]
            # hard sample-boundary rule (services.py:309-320 read2)
            ok = (oks & (n_fr > 0) & (n_ch > 0) & jnp.isfinite(ph)
                  & (ph >= 0.0) & (ph <= (n_fr - 1).astype(jnp.float64)))
            rd = (self._pool_read_interp if fn.endswith("interp")
                  else self._pool_read_scalar)
            l_val = rd(sid, 0.0, ph)
            r_raw = rd(sid, 1.0, ph)
            r_val = jnp.where(n_ch >= 2, r_raw, l_val)
            self._store_lv(args[3], jnp.where(ok, l_val, 0.0), scope, fn)
            self._store_lv(args[4], jnp.where(ok, r_val, 0.0), scope, fn)
            return jnp.where(ok, 1.0, 0.0)

        if fn == "sample_preview_read" and len(args) == 6:
            self.ex(args[0], scope)
            sid = self.ex(args[1], scope)
            b = EM.to_i64(self._arr(self.ex(args[2], scope)))
            sc, oks = self._pool_sid_ok(sid)
            bins = jnp.asarray(t["pv_bins"])[sc]
            ok = oks & (b >= 0) & (b < bins)
            pv = jnp.asarray(t["pv"])
            base = jnp.asarray(t["pv_off"])[sc] + jnp.clip(b, 0) * 3
            for k in range(3):
                v = pv[jnp.clip(base + k, 0, pv.shape[0] - 1)]
                self._store_lv(args[3 + k], jnp.where(ok, v, 0.0),
                               scope, fn)
            return jnp.where(ok, 1.0, 0.0)

        if fn == "sample_name" and len(args) >= 2:
            # golden: emitted as sample_pool_call('sample_name', ...)
            # which has no dispatch case -> 0.0 (shadow/pyexec.py:750-757)
            self.ex(args[0], scope)
            for a in args[2:]:
                self.ex(a, scope)
            return 0.0

        vals = [self.ex(a, scope) for a in args]
        if all(isinstance(v, float) for v in vals):
            # static args against a static generation: the host's answer
            # is a render-constant — keep it foldable
            try:
                return float(host.sample_pool_call(self.snap, fn,
                                                   list(vals)))
            except Exception:  # noqa: BLE001 — inert like the stub host
                return 0.0

        if fn in ("sample_pool_state", "sample_pool_selected",
                  "sample_pool_loaded", "sample_pool_failed",
                  "sample_pool_ram_mb", "sample_pool_generation"):
            return float(host.sample_pool_call(self.snap, fn, [0.0]))
        if fn == "sample_get" and len(vals) >= 2:
            i = EM.to_i64(self._arr(vals[1]))
            ok = (i >= 0) & (i < t["n_order"])
            order = jnp.asarray(t["order"])
            return jnp.where(
                ok, order[jnp.clip(i, 0, order.shape[0] - 1)]
                .astype(jnp.float64), 0.0)
        if fn in ("sample_len", "sample_channels", "sample_srate",
                  "sample_peak", "sample_rms",
                  "sample_preview_bins") and len(vals) >= 2:
            sc, ok = self._pool_sid_ok(vals[1])
            if fn == "sample_len":
                v = jnp.asarray(t["frm"])[sc].astype(jnp.float64)
            elif fn == "sample_channels":
                v = jnp.asarray(t["nch"])[sc].astype(jnp.float64)
            elif fn == "sample_preview_bins":
                v = jnp.asarray(t["pv_bins"])[sc].astype(jnp.float64)
            else:
                col = {"sample_srate": 0, "sample_peak": 1,
                       "sample_rms": 2}[fn]
                v = jnp.asarray(t["meta"])[sc, col]
            return jnp.where(ok, v, 0.0)
        if fn in ("sample_read", "sample_read_interp") and len(vals) >= 4:
            rd = (self._pool_read_interp if fn.endswith("interp")
                  else self._pool_read_scalar)
            return rd(vals[1], vals[2], vals[3])
        raise DevgenError(f"loaded-pool call {fn} not supported on device")

    def _rand_call(self, args: Sequence[Node], scope):
        """rand(limit): u32 * (1/4294967295) * max(floor(limit), 1) with
        the u32 gathered from the staged pool (semantics/scalar.py:359).
        The cursor keeps counting past capacity (reads clamp); the render
        wrapper checks it at writeback and rejects exhausted pools."""
        jnp = self._jnp
        lim = self.ex(args[0], scope) if args else 1.0
        cur = self._arr(self._read_slot(("var", RAND_POS_SLOT)))
        idx = EM.to_i64(cur)
        draw = self.mem[self.rand_base
                        + jnp.clip(idx, 0, self.rand_cells - 1)]
        self._write_slot(("var", RAND_POS_SLOT), cur + 1.0)
        if isinstance(lim, float):
            top = SC.eel_floor(lim)
            if not top >= 1.0:
                top = 1.0
            return draw * ((1.0 / 4294967295.0) * top)
        top = jnp.floor(self._arr(lim))
        top = jnp.where(top >= 1.0, top, 1.0)
        return draw * (1.0 / 4294967295.0) * top

    def _slider_pending_call(self, f: str, args: Sequence[Node], scope):
        """sliderchange/slider_automate: OR the mask into the pending
        pseudo slots (consumed by the fused pipeline's @slider cond).
        A bare sliderN argument means that slider's bit, matching the
        golden executors (shadow/pyexec._slider_mask_arg)."""
        jnp = self._jnp
        if not args:
            raise DevgenError(f"{f} expects a mask")
        a0 = args[0]
        mask = None
        if isinstance(a0, Name):
            i = slider_index(a0.ident)
            if i is not None:
                if i >= 53:
                    raise DevgenError(f"{f}: slider bit {i} beyond f64 "
                                      "exact-integer range")
                mask = float(1 << i)
        if mask is None:
            mask = self.ex(a0, scope)
        if f == "slider_automate":
            end = self.ex(args[1], scope) if len(args) > 1 else 0.0
            if not isinstance(end, float):
                raise DevgenError("slider_automate with dynamic end flag")
            key = ("var", PENDING_SLOT_NAMES[2] if SC.truthy(end)
                   else PENDING_SLOT_NAMES[1])
        else:
            key = ("var", PENDING_SLOT_NAMES[0])
        cur = self._read_slot(key)
        if isinstance(cur, float) and isinstance(mask, float):
            newv: Any = float(int(max(0.0, cur)) | int(max(0.0, mask)))
        else:
            ci = jnp.maximum(EM.to_i64(self._arr(cur)), 0)
            mi = jnp.maximum(EM.to_i64(self._arr(mask)), 0)
            newv = jnp.bitwise_or(ci, mi).astype(jnp.float64)
        self._write_slot(key, newv)
        return 0.0

    def _midirecv(self, args: Sequence[Node], scope):
        """Pop the next staged host MIDI event (golden semantics:
        shadow/pyexec._midirecv4; 3-arg form packs msg23 = b2 + b3*256).
        Out-params write only when an event is available."""
        if len(args) not in (3, 4):
            raise DevgenError("midirecv expects 3 or 4 args")
        if self.midi is None:
            raise DevgenError("midirecv: no staged MIDI plane")
        jnp = self._jnp
        ev, count = self.midi
        K = int(ev.shape[0])
        key = ("var", MIDI_POS_SLOT)
        pos = self._arr(self._read_slot(key))
        have = pos < self._arr(count)
        idx = jnp.clip(EM.to_i64(pos), 0, max(0, K - 1))
        row = ev[idx]
        if len(args) == 4:
            outs = [row[0], row[1], row[2], row[3]]
        else:
            outs = [row[0], row[1], row[2] + row[3] * 256.0]
        for a, v in zip(args, outs):
            if not isinstance(a, Name):
                raise DevgenError("midirecv out-param must be a variable")
            k = scope.get(a.ident) or _env_key(a.ident)
            if k[0] == "builtin":
                raise DevgenError("midirecv writes builtin")
            old = self._arr(self._read_slot(k)) if k in self.slots else None
            if old is None:
                raise DevgenError(f"midirecv out-param {a.ident} "
                                  "unclassified")
            self._write_slot(k, jnp.where(have, v, old))
        self._write_slot(key, jnp.where(have, pos + 1.0, pos))
        return jnp.where(have, jnp.float64(1.0), jnp.float64(0.0))

    def _midisend(self, args: Sequence[Node], scope):
        """Append to the block's staged OUT table at the heap tail
        (golden semantics: shadow/pyexec._midisend byte masking; 3-arg
        msg23 unpacks).  Overflow past MIDI_OUT_CAP drops, mirroring the
        reference's bounded midiOut queue (dsp_jsfx_aot.py State)."""
        if len(args) not in (3, 4):
            raise DevgenError("midisend expects 3 or 4 args")
        if not self.midi_out_cells:
            raise DevgenError("midisend: no staged MIDI out table")
        jnp = self._jnp
        base = self.midi_out_base
        vals = [self._arr(self.ex(a, scope)) for a in args]
        ofs = jnp.maximum(EM.to_i64(vals[0]), 0).astype(jnp.float64)
        b1 = jnp.bitwise_and(EM.to_i64(vals[1]), 255).astype(jnp.float64)
        if len(args) == 4:
            b2 = jnp.bitwise_and(EM.to_i64(vals[2]), 255).astype(jnp.float64)
            b3 = jnp.bitwise_and(EM.to_i64(vals[3]), 255).astype(jnp.float64)
        else:
            m23 = EM.to_i64(vals[2])
            b2 = jnp.bitwise_and(m23, 255).astype(jnp.float64)
            b3 = jnp.bitwise_and(m23 >> 8, 255).astype(jnp.float64)
        n0 = self.mem[base]
        ni = EM.to_i64(n0)
        live = ni < MIDI_OUT_CAP
        slot = base + 1 + jnp.where(live, ni, MIDI_OUT_CAP) * 4
        row = jnp.stack([ofs, b1, b2, b3])
        idx = slot + jnp.arange(4)
        idx = jnp.where(live, idx, self.total_mem)
        self._mem_set(idx, row, drop=True)
        self._mem_set(base, jnp.minimum(n0 + 1.0, float(MIDI_OUT_CAP)))
        return vals[1]

    # -- message bus (live-bus lockstep staging) -----------------------------

    _MSG_RECV_SIDE = frozenset({
        "msg_recv", "msg_avail", "msg_kind", "msg_length", "msg_clear"})

    def _msg_recv_channel_names(self):
        """Receive channels this section (and its callees) name statically,
        in source order — each gets a heap FIFO queue.  A receive call
        whose channel doesn't resolve to one of these at trace time
        raises (honest shadow fallback)."""
        from ..frontend.astnodes import walk

        names: list = []
        seen_fns: Set[str] = set()

        def resolve(a) -> Optional[str]:
            if isinstance(a, Str):
                return a.text
            if isinstance(a, Name):
                try:
                    v = self._snap_value(_env_key(a.ident))
                except AssertionError:
                    return None
                return self._handle_name(v)
            if isinstance(a, Const):
                return self._handle_name(float(a.value))
            return None

        def scan(nodes) -> None:
            for root in nodes:
                for n in walk(root):
                    if not isinstance(n, CallExpr):
                        continue
                    if n.func in self.P.fn_defs \
                            and n.func not in seen_fns:
                        seen_fns.add(n.func)
                        scan([self.P.fn_defs[n.func].body])
                    elif n.func in self._MSG_RECV_SIDE and n.args:
                        nm = resolve(n.args[0])
                        if nm is not None and nm not in names:
                            names.append(nm)
        scan(self.body)
        return names

    def _handle_name(self, handle: float) -> str:
        """bus.InstanceComm._chan_name: interned text, else the numeric
        repr (numeric channel handles are legal)."""
        text = self.snap.string_for_handle(float(handle))
        return text if text is not None else repr(float(handle))

    def _msg_chan_id(self, arg: Node, scope, f: str) -> int:
        v = self.ex(arg, scope)
        if not self._is_static(v):
            raise DevgenError(f"{f}: channel must fold static on device")
        return self.msg_cfg.intern(self._handle_name(v))

    def _msg_bump_drops(self, extra) -> None:
        """Count a dropped staged send / queue overflow in the in-region's
        drop cell; the graph REFUSES a render whose members dropped (the
        shadow outbox/inbox are unbounded, so capacity loss would be a
        silent semantic deviation)."""
        c = self.msg_in_base
        self._mem_set(c, self._arr(self.mem[c]) + self._arr(extra))

    def _msg_append_out(self, bc: float, dest, cid: int, vals, live):
        """Append [bc, dest, chan_id, tag, a, b, c, d] to the OUT table
        when `live` (traced bool); drops count toward the refuse cell."""
        jnp = self._jnp
        base = self.msg_out_base
        n0 = self._arr(self.mem[base])
        fits = n0 < float(MSG_OUT_CAP)
        ok = jnp.logical_and(live, fits)
        slot = base + 1 + jnp.where(
            ok, EM.to_i64(n0), jnp.int64(MSG_OUT_CAP)) * MSG_ENT
        row = jnp.stack([jnp.float64(bc), self._arr(dest),
                         jnp.float64(float(cid))]
                        + [self._arr(v) for v in vals])
        idx = slot + jnp.arange(MSG_ENT)
        idx = jnp.where(ok, idx, self.total_mem)
        self._mem_set(idx, row, drop=True)
        self._mem_set(base, jnp.where(ok, n0 + 1.0, n0))
        self._msg_bump_drops(jnp.where(jnp.logical_and(live, ~fits),
                                       1.0, 0.0))

    def _msg_call(self, f: str, args: Sequence[Node], scope):
        """Live-bus builtins for a joint-lockstep member (graph device
        mode): sends stage into the heap OUT table the joint scan
        publishes to the threaded ring window; receives pop per-channel
        heap FIFO queues the scan materializes at the member's
        begin-block point; topology queries fold against the frozen
        registry.  Semantics: comm/bus.py InstanceComm (ref:
        src/DspJsfxMessageBus.cpp:529,609 block-resolved delivery)."""
        jnp = self._jnp
        host = self.msg_cfg.host

        if f == "instance_id":
            return float(host.instance_id_value)

        if f in ("msg_peer_count", "msg_peer_id"):
            name = self._handle_name(self._static_arg(args[0], scope, f))
            role = int(self._static_arg(args[1], scope, f))
            peers = host.domain.peers_for(name, role,
                                          exclude=host.instance_id_int)
            if f == "msg_peer_count":
                return float(len(peers))
            idx = self.ex(args[2], scope)
            if self._is_static(idx):
                i = int(idx)
                return float(peers[i]) if 0 <= i < len(peers) else 0.0
            tab = jnp.asarray(np.asarray(peers, np.float64)) if peers \
                else jnp.zeros((1,), jnp.float64)
            i = EM.to_i64(self._arr(idx))
            ok = jnp.logical_and(i >= 0, i < len(peers))
            return jnp.where(ok, tab[jnp.clip(i, 0, max(0, len(peers) - 1))],
                             0.0)

        if f in ("msg_peer_caps", "msg_peer_alive"):
            ids = sorted(host.domain.instances)
            caps = [float(host.domain.instances[i].caps) for i in ids]
            peer = self.ex(args[0], scope)
            if self._is_static(peer):
                p = host.domain.instances.get(int(peer)) \
                    if np.isfinite(peer) else None
                if f == "msg_peer_alive":
                    return 1.0 if p is not None else 0.0
                return float(p.caps) if p is not None else 0.0
            idtab = jnp.asarray(np.asarray(ids or [-1], np.int64))
            captab = jnp.asarray(np.asarray(caps or [0.0], np.float64))
            pi = EM.to_i64(self._arr(peer))
            j = jnp.clip(jnp.searchsorted(idtab, pi), 0, idtab.shape[0] - 1)
            alive = idtab[j] == pi
            if f == "msg_peer_alive":
                return jnp.where(alive, 1.0, 0.0)
            return jnp.where(alive, captab[j], 0.0)

        if f == "msg_send":
            cid = self._msg_chan_id(args[0], scope, f)
            vals = [self.ex(a, scope) for a in args[1:]]
            self._msg_append_out(1.0, 0.0, cid, vals, jnp.asarray(True))
            return 1.0

        if f == "msg_sendto":
            dest = self._arr(self.ex(args[0], scope))
            cid = self._msg_chan_id(args[1], scope, f)
            vals = [self.ex(a, scope) for a in args[2:]]
            # int(dest) raises on NaN/inf in the golden -> returns 0.0
            # without sending (NaN != NaN covers NaN; the magnitude
            # guard covers inf)
            valid = jnp.logical_and(dest == dest, jnp.abs(dest) < 1e18)
            di = jnp.trunc(jnp.where(valid, dest, 0.0))
            self._msg_append_out(0.0, di, cid, vals, valid)
            return jnp.where(valid, 1.0, 0.0)

        # queue-side builtins
        cid = self._msg_chan_id(args[0], scope, f)
        if f == "msg_dropped":
            # frozen host count: the device path never evicts (window
            # capacity is enforced post-render by the graph)
            name = self._handle_name(self._static_arg(args[0], scope, f))
            return float(host.dropped.get(name, 0))
        qb = self.msg_queues.get(cid)
        if qb is None:
            raise DevgenError(f"{f}: channel not in the static receive "
                              "set of this section")
        head = self._arr(self.mem[qb])
        cnt = self._arr(self.mem[qb + 1])
        if f == "msg_avail":
            return cnt
        if f == "msg_kind":
            # device members exchange scalars only (buffer sends are
            # rejected at build), so a pending message is KIND_SCALAR
            return jnp.where(cnt > 0.0, 1.0, 0.0)
        if f == "msg_length":
            return jnp.where(cnt > 0.0, 4.0, 0.0)
        if f == "msg_clear":
            self._mem_set(qb, jnp.mod(head + cnt, float(MSG_QUEUE_CAP)))
            self._mem_set(qb + 1, jnp.float64(0.0))
            return cnt
        if f == "msg_recv":
            if len(args) != 7:
                raise DevgenError("msg_recv expects 7 args")
            import jax

            have = cnt > 0.0
            slot = qb + 2 + EM.to_i64(head) * MSG_QENT
            row = jax.lax.dynamic_slice(self.mem, (slot,), (MSG_QENT,))
            for k, a in enumerate(args[1:]):
                self._msg_store_outparam(a, row[k], have, scope, f)
            nh = head + 1.0
            nh = jnp.where(nh >= float(MSG_QUEUE_CAP), 0.0, nh)
            self._mem_set(qb, jnp.where(have, nh, head))
            self._mem_set(qb + 1, jnp.where(have, cnt - 1.0, cnt))
            return jnp.where(have, 1.0, 0.0)
        raise DevgenError(f"{f}: not device-executable")

    def _static_arg(self, a: Node, scope, f: str) -> float:
        v = self.ex(a, scope)
        if not self._is_static(v):
            raise DevgenError(f"{f}: argument must fold static on device")
        return float(v)

    def _msg_store_outparam(self, tgt: Node, val, have, scope,
                            fn: str) -> None:
        """Out-params write only when a message arrived (golden: stores
        untouched otherwise)."""
        jnp = self._jnp
        if isinstance(tgt, Name):
            key = scope.get(tgt.ident) or _env_key(tgt.ident)
            if key[0] == "builtin":
                raise DevgenError(f"{fn}: out-arg writes builtin {key[1]}")
            if key not in self.slots:
                raise DevgenError(f"{fn}: out-param {tgt.ident} "
                                  "unclassified")
            old = self._arr(self._read_slot(key))
            self._write_slot(key, jnp.where(have, self._arr(val), old))
            return
        if isinstance(tgt, Mem) and not (isinstance(tgt.base, Name)
                                         and tgt.base.ident == "gmem"):
            a = self._mem_addr(self.ex(tgt.base, scope),
                               self.ex(tgt.index, scope))
            idx = jnp.where(have, a, self.total_mem)
            self._mem_set(idx, self._arr(val), drop=True, heap=True)
            return
        raise DevgenError(f"{fn}: out-arg must be a variable or mem[] slot")

    def _gmem_call(self, f: str, args: Sequence[Node], scope):
        """Bulk gmem ops on the heap-tail segment view; semantics mirror
        shadow/state.py gmem_* (clamped counts, silent drops).  Counts and
        MEM bases must fold static; the gmem-side base may be traced (slot
        tables discovered per block) via dynamic slices."""
        jnp = self._jnp
        if f in ("gmem_attach", "gmem_attach_size"):
            for a in args:
                self.ex(a, scope)
            # the HOST attaches segments; on-device re-attach of the same
            # namespace is the steady-state no-op
            return 1.0 if self.gmem_cells else 0.0
        if f == "gmem_size":
            return float(self.gmem_cells)
        if not self.gmem_cells:
            raise DevgenError("gmem used but no segment attached")
        import jax

        vals = [self.ex(a, scope) for a in args]
        if len(vals) >= 3 and not isinstance(vals[2], float):
            raise DevgenError(f"{f} with non-static count")
        G = self.gmem_cells
        base = self.gmem_base

        if f in ("gmem_fill", "gmem_zero"):
            if f == "gmem_zero":
                fillv: Any = 0.0
                cnt = vals[1]
            else:
                fillv = vals[1]
                cnt = vals[2]
            if not isinstance(cnt, float):
                raise DevgenError(f"{f} with non-static count")
            if isinstance(vals[0], float):
                d0 = max(0, int(vals[0] + 1.0e-5))
                nln = min(max(0, int(cnt + 1.0e-5)), G - d0)
                if nln > 0:
                    fv = jnp.full((nln,), self._arr(fillv),
                                  dtype=jnp.float64)
                    self._mem_bulk(base + d0, fv)
                return float(max(0, nln))
            nln = max(0, int(cnt + 1.0e-5))
            if 0 < nln <= G:
                fv = jnp.full((nln,), self._arr(fillv), dtype=jnp.float64)
                d = base + jnp.clip(self._gmem_index(vals[0]), 0, G - nln)
                self._mem_bulk(d, fv)
            return float(nln)
        if f == "gmem_put" and len(args) == 3:
            m = vals[1]
            if not isinstance(m, float):
                raise DevgenError("gmem_put with non-static mem base")
            mi = max(0, int(m + 1.0e-5))
            nln = max(0, int(vals[2] + 1.0e-5))
            if nln <= 0 or nln > G:
                return 0.0
            if mi + nln > self.mem_size:
                raise DevgenError("gmem_put beyond device heap")
            chunk = self.mem[mi:mi + nln]
            if isinstance(vals[0], float):
                d0 = max(0, int(vals[0] + 1.0e-5))
                k = min(nln, G - d0)
                if k > 0:
                    self._mem_bulk(base + d0, chunk[:k])
                return float(max(0, k))
            d = base + jnp.clip(self._gmem_index(vals[0]), 0, G - nln)
            self._mem_bulk(d, chunk)
            return float(nln)
        if f == "gmem_get" and len(args) == 3:
            m = vals[0]
            if not isinstance(m, float):
                raise DevgenError("gmem_get with non-static mem base")
            mi = max(0, int(m + 1.0e-5))
            nln = max(0, int(vals[2] + 1.0e-5))
            if nln <= 0 or nln > G:
                return 0.0
            if mi + nln > self.mem_size:
                raise DevgenError("gmem_get beyond device heap")
            if isinstance(vals[1], float):
                g0 = max(0, int(vals[1] + 1.0e-5))
                k = min(nln, G - g0)
                if k > 0:
                    self._mem_bulk(mi, self.mem[base + g0:base + g0 + k])
                return float(max(0, k))
            g = base + jnp.clip(self._gmem_index(vals[1]), 0, G - nln)
            chunk = jax.lax.dynamic_slice(self.mem, (g,), (nln,))
            self._mem_bulk(mi, chunk)
            return float(nln)
        if f == "gmem_copy" and len(args) == 3:
            if not all(isinstance(v, float) for v in vals):
                raise DevgenError("gmem_copy with non-static operands")
            d = max(0, int(vals[0] + 1.0e-5))
            sidx = max(0, int(vals[1] + 1.0e-5))
            nln = max(0, int(vals[2] + 1.0e-5))
            nln = min(nln, G - max(d, sidx))
            if nln > 0:
                self._mem_bulk(base + d,
                               self.mem[base + sidx:base + sidx + nln])
            return float(max(0, nln))
        raise DevgenError(f"{f}: unsupported arity")

    # -- function outlining (program-size dedup) ------------------------------
    #
    # Inline tracing replicates a function body at EVERY call site; on the
    # multi-kLoC catalog plugins (Texture: 7k LoC, dozens of helpers hit
    # from loops) that multiplies the StableHLO, and the compile time and
    # memory with it.  Heavy functions called from several
    # sites instead lower ONCE as a jitted subfunction over the full
    # (vars, mem, pred, dyn-args) state — call sites become func.calls to
    # one shared private function.  Static args specialize the body (one
    # outline per static signature), so constant folding inside is kept.

    _OUTLINE_MIN_WEIGHT = 24

    def _outline_counts(self) -> Dict[str, int]:
        """Static call-site appearance counts per user function over the
        section body plus every reachable function body."""
        from ..frontend.astnodes import walk

        counts: Dict[str, int] = {}
        seen: Set[str] = set()
        pending: List[str] = []

        def scan(nodes) -> None:
            for st in nodes:
                for x in walk(st):
                    if isinstance(x, CallExpr) and x.func in self.P.fn_defs:
                        counts[x.func] = counts.get(x.func, 0) + 1
                        if x.func not in seen:
                            seen.add(x.func)
                            pending.append(x.func)

        scan(self.body)
        while pending:
            scan([self.P.fn_defs[pending.pop()].body])
        return counts

    def _outline_safe(self, fname: str) -> bool:
        """True when the function's transitive body only touches state
        that lives in (vars, mem): no trace-time host folding (files,
        pool setup) and no staged-plane readers (midirecv)."""
        memo = self._outline_safe_memo
        got = memo.get(fname)
        if got is not None:
            return got
        from ..frontend.astnodes import walk

        bad = self._FILE_FNS | self._POOL_SETUP | {
            "midirecv", "midirecv_buf", "midirecv_str"}
        ok = True
        seen = {fname}
        stack = [fname]
        while stack and ok:
            f = stack.pop()
            for x in walk(self.P.fn_defs[f].body):
                if isinstance(x, CallExpr):
                    if x.func in bad:
                        ok = False
                        break
                    if x.func in self.P.fn_defs and x.func not in seen:
                        seen.add(x.func)
                        stack.append(x.func)
        memo[fname] = ok
        return ok

    def _fn_writes(self, fname: str) -> Set[Any]:
        """Slot keys the function (transitively) may write — used to
        invalidate the static-constant overlay after an outlined call."""
        got = self._fn_writesets.get(fname)
        if got is not None:
            return got
        from ..frontend.astnodes import walk

        keys: Set[Any] = set()
        seen = {fname}
        stack = [fname]
        while stack:
            f = stack.pop()
            fdef = self.P.fn_defs[f]
            params = set(fdef.params)
            for p in fdef.params:
                keys.add(("param", f, p))
            for x in walk(fdef.body):
                if isinstance(x, Asn) and isinstance(x.target, Name):
                    ident = x.target.ident
                    keys.add(("param", f, ident) if ident in params
                             else _env_key(ident))
                elif isinstance(x, CallExpr) and x.func in self.P.fn_defs \
                        and x.func not in seen:
                    seen.add(x.func)
                    stack.append(x.func)
        for pseudo in PENDING_SLOT_NAMES + (RAND_POS_SLOT, MIDI_POS_SLOT):
            keys.add(("var", pseudo))
        self._fn_writesets[fname] = keys
        return keys

    def _outline_ok(self, fname: str, fdef, vals) -> bool:
        if fname in self._outline_bad:
            return False
        # all-static calls usually fold to a constant inline; keep them
        if fdef.params and all(isinstance(v, float) for v in vals):
            return False
        w = self._outline_w.get(fname)
        if w is None:
            w = self._node_weight(fdef.body)
            self._outline_w[fname] = w
        if w < self._OUTLINE_MIN_WEIGHT:
            return False
        if self._call_counts is None:
            self._call_counts = self._outline_counts()
        # static call-site count misses the dominant repetition mode: ONE
        # site inside a statically-unrolled loop expands per trip (Sample's
        # voice loop inlined its ~40 kB body 16x into one 41 MB step fn) —
        # the dynamic trace-time call count catches those
        if self._call_counts.get(fname, 0) < 2 \
                and self._dyn_calls.get(fname, 0) < 2:
            return False
        return self._outline_safe(fname)

    def _outlined_call(self, fname: str, fdef, vals):
        """Call `fname` through its shared jitted subfunction.  Returns a
        1-tuple (ret,) or None to fall back to inline tracing."""
        import jax

        jnp = self._jnp
        statics = tuple(v if isinstance(v, float) else None for v in vals)
        dyn = [v for v in vals if not isinstance(v, float)]
        dkey = tuple((tuple(getattr(v, "shape", ())),
                      str(getattr(v, "dtype", "f8"))) for v in dyn)
        skey = (fname, statics, dkey)
        fn = self._outline_cache.get(skey)
        if fn is None:
            def outlined(vars_vec, mem, pred, dyn_args):
                save = (self.vars, self.mem, self._known, self._pred)
                self.vars, self.mem = vars_vec, mem
                self._known = {}
                self._pred = pred
                try:
                    it = iter(dyn_args)
                    inner: Dict[str, Any] = {}
                    for p, sv in zip(fdef.params, statics):
                        key = ("param", fname, p)
                        self._write_slot(key,
                                         sv if sv is not None else next(it))
                        inner[p] = key
                    ret = self.ex(fdef.body, inner)
                    return self.vars, self.mem, self._arr(ret)
                finally:
                    (self.vars, self.mem,
                     self._known, self._pred) = save

            fn = jax.jit(outlined)
            self._outline_cache[skey] = fn
        pred = jnp.asarray(True) if self._pred is None else self._pred
        try:
            new_vars, new_mem, ret = fn(self.vars, self.mem, pred,
                                        tuple(dyn))
        except DevgenError as exc:
            if "beyond device heap" in str(exc):
                raise  # heap-size ladder must keep climbing
            self._outline_bad.add(fname)
            return None
        except (TypeError, jax.errors.TracerBoolConversionError,
                jax.errors.ConcretizationTypeError):
            # body relies on per-call-site static knowledge the outline
            # doesn't carry — trace it inline instead
            self._outline_bad.add(fname)
            return None
        self.vars, self.mem = new_vars, new_mem
        for k in self._fn_writes(fname):
            s = self.slots.get(k)
            if s is not None:
                self._known.pop(s, None)
        return (ret,)

    def _user_call(self, fname: str, args: Sequence[Node], scope):
        fdef = self.P.fn_defs[fname]
        if len(args) != len(fdef.params):
            raise DevgenError(f"{fname}: arg count {len(args)} != "
                              f"{len(fdef.params)}")
        vals = [self.ex(a, scope) for a in args]
        self._dyn_calls[fname] = self._dyn_calls.get(fname, 0) + 1
        if self._outline_ok(fname, fdef, vals):
            got = self._outlined_call(fname, fdef, vals)
            if got is not None:
                return got[0]
        inner: Dict[str, Any] = {}
        for p, v in zip(fdef.params, vals):
            key = ("param", fname, p)
            self._write_slot(key, v)
            inner[p] = key
        return self.ex(fdef.body, inner)

    def _store_lvalue(self, node: Node, value, scope) -> None:
        """Out-parameter store (file_riff/file_var style)."""
        if isinstance(node, Name):
            key = scope.get(node.ident) or _env_key(node.ident)
            if key[0] == "builtin":
                raise DevgenError(f"out-param writes builtin {key[1]}")
            self._write_slot(key, value)
            return
        if isinstance(node, Mem):
            b = self.ex(node.base, scope)
            i = self.ex(node.index, scope)
            self._mem_set(self._mem_addr(b, i), value, heap=True)
            return
        raise DevgenError("unsupported out-parameter lvalue")

    def _file_call(self, f: str, args: Sequence[Node], scope):
        """Legacy file API, folded at TRACE time: slot contents are static
        per specialization and every load is self-contained within one
        @block invocation (ref pattern: PsychoConvolver.jsfx:130-199
        open -> riff -> avail -> file_mem -> close, gated on a reload
        flag).  Cursor state lives only inside the trace; the audio data
        folds into the traced heap as constants under the ambient branch
        merge.  Semantics mirror runtime/services.py file_call exactly."""
        svc = self._files
        if f == "file_riff" and len(args) == 3:
            h = self.ex(args[0], scope)
            if not isinstance(h, float):
                raise DevgenError("file_riff with non-static handle")
            r = svc.riff(h)
            if r is None:
                return 0.0
            self._store_lvalue(args[1], float(r[0]), scope)
            self._store_lvalue(args[2], float(r[1]), scope)
            return 1.0
        if f == "file_var" and len(args) == 2:
            h = self.ex(args[0], scope)
            if not isinstance(h, float):
                raise DevgenError("file_var with non-static handle")
            r = svc.var_read(h)
            if r is None:
                return 0.0
            self._store_lvalue(args[1], float(r[1]), scope)
            return float(r[0])
        vals = [self.ex(a, scope) for a in args]
        if not all(isinstance(v, float) for v in vals):
            raise DevgenError(f"{f} with non-static arguments")
        if f in ("file_open", "file_open_multi"):
            return float(svc.open(vals[0] if vals else -1.0))
        if f == "file_close":
            return float(svc.close(vals[0]))
        if f == "file_avail":
            return float(svc.avail(vals[0]))
        if f == "file_rewind":
            return float(svc.rewind(vals[0]))
        if f == "file_seek":
            return float(svc.seek(vals[0], vals[1]))
        if f == "file_text":
            return 0.0
        if f == "file_multi_count":
            return float(svc.multi_count(vals[0]))
        if f == "file_multi_select":
            return float(svc.multi_select(vals[0], vals[1]))
        if f == "file_mem":
            # mirror FileSlotService.mem_read against the traced heap
            h = svc._h(vals[0])
            if h is None or h.current is None:
                return 0.0
            try:
                dst = max(0, int(vals[1] + 1e-5))
                want = max(0, int(vals[2]))
            except (ValueError, OverflowError):
                return 0.0
            inter = h.current.audio.T.reshape(-1)
            n_items = min(want, max(0, len(inter) - h.cursor))
            if n_items:
                if dst + n_items > self.mem_size:
                    raise DevgenError(f"file_mem: static mem address {dst + n_items} beyond device heap")
                chunk = np.asarray(inter[h.cursor:h.cursor + n_items],
                                   dtype=np.float64)
                self._mem_bulk(dst, self._jnp.asarray(chunk))
                h.cursor += n_items
            return float(n_items)
        raise DevgenError(f"file builtin {f} not supported")

    def _memset(self, args, scope):
        dest = self.ex(args[0], scope)
        val = self.ex(args[1], scope)
        length = self.ex(args[2], scope)
        if not isinstance(length, float):
            raise DevgenError("memset with non-static length")
        ln = max(SC.trunc_i64(length + 1.0e-5), 0)
        if ln == 0:
            return dest
        jnp = self._jnp
        fill = jnp.full((ln,), self._arr(val), dtype=jnp.float64)
        if isinstance(dest, float):
            a = SC.blob_address(dest)
            if a + ln > self.mem_size:
                raise DevgenError(f"memset: static mem address {a + ln} beyond device heap")
            self._mem_bulk(a, fill)
        else:
            a = jnp.clip(EM.to_i64(dest + 1.0e-5), 0,
                         self.mem_size - ln)
            self._mem_bulk(a, fill)
        return dest

    def _memcpy(self, args, scope):
        dest = self.ex(args[0], scope)
        src = self.ex(args[1], scope)
        length = self.ex(args[2], scope)
        if not isinstance(length, float):
            raise DevgenError("memcpy with non-static length")
        ln = max(SC.trunc_i64(length + 1.0e-5), 0)
        if ln == 0:
            return dest
        import jax

        jnp = self._jnp
        if isinstance(src, float):
            sa = SC.blob_address(src)
            if sa + ln > self.mem_size:
                raise DevgenError(f"memcpy: static mem address {sa + ln} beyond device heap")
            chunk = self.mem[sa:sa + ln]
        else:
            sa = jnp.clip(EM.to_i64(src + 1.0e-5), 0, self.mem_size - ln)
            chunk = jax.lax.dynamic_slice(self.mem, (sa,), (ln,))
        if isinstance(dest, float):
            da = SC.blob_address(dest)
            if da + ln > self.mem_size:
                raise DevgenError(f"memcpy: static mem address {da + ln} beyond device heap")
            self._mem_bulk(da, chunk)
        else:
            da = jnp.clip(EM.to_i64(dest + 1.0e-5), 0, self.mem_size - ln)
            self._mem_bulk(da, chunk)
        return dest

    _DFT_MAX = 4096  # f64 DFT-matmul bound (matrices are n^2 doubles)

    def _dft(self, re, im, n: int, inverse: bool):
        """Unnormalized DFT via f64 matmuls (golden-executor precision for
        the WDL sizes the catalog uses; the dots stay f64, so they run in
        full double precision).  Returns (re, im)."""
        jnp = self._jnp
        self.fft_sizes_used.add(n)
        off = self.fft_table_off.get(n)
        if off is not None:
            # heap-tail tables (same numpy values, zero baked literals)
            b = self.fft_base + off
            C = self.mem[b:b + n * n].reshape(n, n)
            S_ = self.mem[b + n * n:b + 2 * n * n].reshape(n, n)
        else:
            C, S_ = _dft_mats(n)
            C = jnp.asarray(C)
            S_ = jnp.asarray(S_)
        if not inverse:  # X = sum x * e^{-i theta}
            return C @ re + S_ @ im, C @ im - S_ @ re
        return C @ re - S_ @ im, C @ im + S_ @ re

    def _fft_call(self, which: str, args, scope):
        """WDL FFT family on a static mem slice.  Bases and sizes must fold
        to constants (they are @init constants in the catalog).  Semantics
        mirror runtime/fftops.py exactly (the empirically-verified WDL
        contract); region-guard failures are the same silent no-op."""
        from ..runtime import fftops as FO

        if which == "convolve_c":
            dest = self.ex(args[0], scope)
            src = self.ex(args[1], scope)
            size = self.ex(args[2], scope)
        else:
            dest = self.ex(args[0], scope)
            size = self.ex(args[1], scope)
            src = None
        if not isinstance(size, float):
            raise DevgenError(f"{which} with non-static size")
        if not isinstance(dest, float) \
                or (src is not None and not isinstance(src, float)):
            return self._fft_call_dyn(which, dest, src, size)
        jnp = self._jnp
        sz = FO._round_index(size)
        da = max(0, FO._round_index(dest))

        def store_complex(base, re, im):
            inter = jnp.stack([re, im], axis=1).reshape(-1)
            self._mem_bulk(base, inter)

        def load_complex(base, n):
            buf = self.mem[base:base + 2 * n].reshape(n, 2)
            return buf[:, 0], buf[:, 1]

        if which == "convolve_c":
            n = FO._round_index(size)
            sa = max(0, FO._round_index(src))
            if (n <= 0 or n > FO.PAGE_DOUBLES // 2
                    or not FO._same_page(da, 2 * n)
                    or not FO._same_page(sa, 2 * n)):
                return 0.0  # WDL guard: silent no-op
            if da + 2 * n > self.mem_size or sa + 2 * n > self.mem_size:
                if self.reduced_heap:
                    # the golden grows its heap for this call
                    raise DevgenError(
                        f"{which}: static mem address {da + 2 * n} "
                        f"beyond device heap ({self.mem_size})")
                return 0.0
            dr, di = load_complex(da, n)
            sr, si = load_complex(sa, n)
            store_complex(da, dr * sr - di * si, dr * si + di * sr)
            return 0.0

        if not FO._pow2_ok(sz):
            return 0.0
        if which in ("fft", "ifft", "fft_permute", "fft_ipermute"):
            span = 2 * sz
        else:
            span = sz
        if not FO._same_page(da, span):
            return 0.0
        if da + span > self.mem_size:
            if self.reduced_heap:
                # the golden grows its heap for this call
                raise DevgenError(
                    f"{which}: static mem address {da + span} beyond "
                    f"device heap ({self.mem_size})")
            return 0.0
        if which in ("fft", "ifft", "fft_real", "ifft_real") \
                and sz > self._DFT_MAX:
            raise DevgenError(f"{which} size {sz} beyond device DFT bound")

        if which == "fft":
            re, im = load_complex(da, sz)
            xr, xi = self._dft(re, im, sz, inverse=False)
            ip = jnp.asarray(FO.iperm_table(sz))
            store_complex(da, xr[ip], xi[ip])  # natural -> WDL order
        elif which == "ifft":
            re, im = load_complex(da, sz)
            p = jnp.asarray(FO.perm_table(sz))
            xr, xi = self._dft(re[p], im[p], sz, inverse=True)
            store_complex(da, xr, xi)
        elif which == "fft_permute":
            re, im = load_complex(da, sz)
            p = jnp.asarray(FO.perm_table(sz))
            store_complex(da, re[p], im[p])
        elif which == "fft_ipermute":
            re, im = load_complex(da, sz)
            ip = jnp.asarray(FO.iperm_table(sz))
            store_complex(da, re[ip], im[ip])
        elif which == "fft_real":
            half = sz // 2
            x = self.mem[da:da + sz]
            zero = jnp.zeros_like(x)
            Rr, Ri = self._dft(x, zero, sz, inverse=False)
            Rr, Ri = 2.0 * Rr[:half + 1], 2.0 * Ri[:half + 1]
            nat_r = Rr[:half]
            nat_i = Ri[:half].at[0].set(Rr[half])  # bin0 = (2*DC, 2*Nyq)
            ip = jnp.asarray(FO.iperm_table(half))
            store_complex(da, nat_r[ip], nat_i[ip])
        elif which == "ifft_real":
            half = sz // 2
            wr, wi = load_complex(da, half)
            p = jnp.asarray(FO.perm_table(half))
            nr, ni = wr[p], wi[p]
            # R[0]=nat0.re/2, R[half]=nat0.im/2, R[k]=nat[k]/2; x =
            # irfft(R, n) * 2n == 2 * Re(unnormalized hermitian IDFT)
            Rr = jnp.concatenate([nr / 2.0, ni[:1] / 2.0])
            Ri = jnp.concatenate([ni / 2.0, jnp.zeros((1,))])
            Rr = Rr.at[0].set(nr[0] / 2.0)
            Ri = Ri.at[0].set(0.0)
            Ri = Ri.at[half].set(0.0)
            # hermitian extension to the full n-point spectrum
            fr = jnp.concatenate([Rr, Rr[1:half][::-1]])
            fi = jnp.concatenate([Ri, -Ri[1:half][::-1]])
            xr, _xi = self._dft(fr, fi, sz, inverse=True)
            # irfft(R, n) * 2n  ==  2 * unnormalized hermitian IDFT
            self._mem_bulk(da, 2.0 * xr)
        return 0.0

    def _fft_call_dyn(self, which: str, dest, src, size: float):
        """WDL FFT family at a TRACED base pointer (static size): the mem
        span moves through lax.dynamic_slice/dynamic_update_slice, the
        WDL page guard becomes a traced select (silent no-op semantics
        preserved), and in reduced-heap mode a base reaching past the
        heap bumps the high-water slot so the render rebuilds bigger
        (the golden grows its heap for the same call)."""
        import jax

        from ..runtime import fftops as FO

        jnp = self._jnp
        sz = FO._round_index(size)
        if which in ("fft", "ifft", "fft_permute", "fft_ipermute"):
            span = 2 * sz
        elif which == "convolve_c":
            span = 2 * sz
        else:
            span = sz
        if which == "convolve_c":
            if sz <= 0 or sz > FO.PAGE_DOUBLES // 2:
                return 0.0
        elif not FO._pow2_ok(sz):
            return 0.0
        if which in ("fft", "ifft", "fft_real", "ifft_real") \
                and sz > self._DFT_MAX:
            raise DevgenError(f"{which} size {sz} beyond device DFT bound")
        if span > self.mem_size:
            raise DevgenError(
                f"{which} span {span} beyond device heap ({self.mem_size})")

        P = FO.PAGE_DOUBLES

        def base_ok(b):
            page = (b // P) == ((b + span - 1) // P)
            ok_sz = (b + span) <= self.mem_size
            if self.reduced_heap:
                hw = ("var", MEM_HIWATER_SLOT)
                cur = self._arr(self._read_slot(hw))
                bump = jnp.where(page & ~ok_sz,
                                 (b + span - 1).astype(jnp.float64), -1.0)
                self._write_slot(hw, jnp.maximum(cur, bump))
            return page & ok_sz

        da = jnp.maximum(EM.to_i64(self._arr(dest)), 0)
        ok = base_ok(da)
        if which == "convolve_c":
            sa = jnp.maximum(EM.to_i64(self._arr(src)), 0)
            ok = ok & base_ok(sa)
            safe_s = jnp.where(ok, sa, 0)
        safe = jnp.where(ok, da, 0)
        buf = jax.lax.dynamic_slice(self.mem, (safe,), (span,))

        if which == "convolve_c":
            sbuf = jax.lax.dynamic_slice(self.mem, (safe_s,), (span,))
            d = buf.reshape(sz, 2)
            s = sbuf.reshape(sz, 2)
            dr, di = d[:, 0], d[:, 1]
            sr, si = s[:, 0], s[:, 1]
            new = jnp.stack([dr * sr - di * si, dr * si + di * sr],
                            axis=1).reshape(-1)
        elif which == "fft":
            c = buf.reshape(sz, 2)
            xr, xi = self._dft(c[:, 0], c[:, 1], sz, inverse=False)
            ip = jnp.asarray(FO.iperm_table(sz))
            new = jnp.stack([xr[ip], xi[ip]], axis=1).reshape(-1)
        elif which == "ifft":
            c = buf.reshape(sz, 2)
            p = jnp.asarray(FO.perm_table(sz))
            xr, xi = self._dft(c[:, 0][p], c[:, 1][p], sz, inverse=True)
            new = jnp.stack([xr, xi], axis=1).reshape(-1)
        elif which == "fft_permute":
            c = buf.reshape(sz, 2)
            p = jnp.asarray(FO.perm_table(sz))
            new = jnp.stack([c[:, 0][p], c[:, 1][p]], axis=1).reshape(-1)
        elif which == "fft_ipermute":
            c = buf.reshape(sz, 2)
            ip = jnp.asarray(FO.iperm_table(sz))
            new = jnp.stack([c[:, 0][ip], c[:, 1][ip]],
                            axis=1).reshape(-1)
        elif which == "fft_real":
            half = sz // 2
            zero = jnp.zeros_like(buf)
            Rr, Ri = self._dft(buf, zero, sz, inverse=False)
            Rr, Ri = 2.0 * Rr[:half + 1], 2.0 * Ri[:half + 1]
            nat_r = Rr[:half]
            nat_i = Ri[:half].at[0].set(Rr[half])
            ip = jnp.asarray(FO.iperm_table(half))
            new = jnp.stack([nat_r[ip], nat_i[ip]], axis=1).reshape(-1)
        elif which == "ifft_real":
            half = sz // 2
            c = buf.reshape(half, 2)
            p = jnp.asarray(FO.perm_table(half))
            nr, ni = c[:, 0][p], c[:, 1][p]
            Rr = jnp.concatenate([nr / 2.0, ni[:1] / 2.0])
            Ri = jnp.concatenate([ni / 2.0, jnp.zeros((1,))])
            Rr = Rr.at[0].set(nr[0] / 2.0)
            Ri = Ri.at[0].set(0.0)
            Ri = Ri.at[half].set(0.0)
            fr = jnp.concatenate([Rr, Rr[1:half][::-1]])
            fi = jnp.concatenate([Ri, -Ri[1:half][::-1]])
            xr, _xi = self._dft(fr, fi, sz, inverse=True)
            new = 2.0 * xr
        else:  # pragma: no cover
            raise DevgenError(f"unknown fft call {which}")

        upd = jnp.where(ok, new, buf)
        self._mem_bulk(safe, upd)
        return 0.0
