"""Disk reification of devgen section traces (jax.export artifacts).

A DeviceSection step trace is minutes of single-core Python on the
multi-kLoC catalog plugins (Sample.jsfx: ~66 min across its sections)
and re-ran in EVERY process, because only the XLA *compile* was
persistently cached (utils/cache.py) while the jaxpr the compile
consumes was rebuilt each time (the reference pays the analogous cost
once at AOT build time — ref: dsp_jsfx_aot.py emits C sources that are
compiled once and dlopened thereafter).

This module serializes the traced+lowered step as a jax.export
StableHLO artifact, keyed by everything the trace folds:

* the plugin source text and the section body's node positions,
* the section layout (heap sizes, slot table, staged-region bases),
* snapshot statics the trace folds to constants (vars/sliders/spl,
  builtins, file-slot contents, sample-pool generation),
* the lowering code itself (devgen/eelmath/scalar/services file hashes,
  so editing the compiler invalidates every artifact), and
* the jax version.

Artifacts are exported for the current platform only, under its
`jax.export` name, and that name is part of the key: an artifact traced
on the CPU is never served to a GPU render.  `ZORAK_TRACE_CACHE=0`
disables the disk layer entirely; `ZORAK_TRACE_CACHE_DIR` moves it from
its default inside the checkout (`.cache/devgen_traces`).
"""
from __future__ import annotations

import hashlib
import json
import os
import sys
import time
from typing import Any, Dict, Optional

_DEBUG = bool(os.environ.get("ZORAK_DEVEXEC_DEBUG"))


def _dbg(msg: str) -> None:
    if _DEBUG:
        print(f"[tracecache] {msg}", file=sys.stderr, flush=True)


def enabled() -> bool:
    return os.environ.get("ZORAK_TRACE_CACHE", "1") not in ("0", "off", "")


def cache_dir() -> str:
    from ..utils.cache import CACHE_ROOT

    path = os.environ.get("ZORAK_TRACE_CACHE_DIR",
                          str(CACHE_ROOT / "devgen_traces"))
    os.makedirs(path, exist_ok=True)
    return path


def export_platform() -> str:
    """The current backend under its jax.export name ("cuda", "cpu")."""
    from jax import export as jexport

    return jexport.default_export_platform()


# ---------------------------------------------------------------------------
# fingerprinting

_code_hash_memo: Optional[str] = None


def _code_hash() -> str:
    """Hash of the lowering code whose behavior the trace bakes in."""
    global _code_hash_memo
    if _code_hash_memo is None:
        import jax

        from ..runtime import services as _services
        from ..semantics import scalar as _scalar
        from . import devgen as _devgen
        from . import eelmath as _eelmath

        h = hashlib.sha1()
        for mod in (_devgen, _eelmath, _scalar, _services):
            try:
                with open(mod.__file__, "rb") as f:
                    h.update(f.read())
            except OSError:
                h.update(repr(mod).encode())
        h.update(jax.__version__.encode())
        _code_hash_memo = h.hexdigest()
    return _code_hash_memo


def _hash_array(h, arr) -> None:
    import numpy as np

    a = np.asarray(arr)
    h.update(str(a.dtype).encode())
    h.update(str(a.shape).encode())
    h.update(a.tobytes())


def section_key(sec, shapes_key) -> str:
    """Cache key for one DeviceSection step at one call-shape signature.

    Over-keying is safe (a miss re-traces); under-keying is not, so this
    hashes every input the trace can fold: see module docstring."""
    h = hashlib.sha1()
    h.update(_code_hash().encode())
    # an export runs only on the platform it was lowered for
    h.update(f"platform={export_platform()};".encode())
    # env-tunable trace-shaping budgets (devgen class attrs read from
    # ZORAK_UNROLL_* at import) change the emitted program
    h.update(repr((sec._UNROLL_MERGE_BUDGET,
                   sec._UNROLL_WEIGHT_BUDGET,
                   sec._UNROLL_TRACED_WEIGHT_BUDGET,
                   sec._MERGE_BUDGET,
                   sec.cond_outline)).encode())
    h.update(sec.P.source.encode())
    h.update(sec.section.encode())
    h.update(repr([repr(n.pos) for n in sec.body]).encode())
    h.update(repr(sorted(sec.consts.items())).encode())
    h.update(repr((sec.mem_size, sec.gmem_cells, sec.midi_out_cells,
                   sec.rand_cells, sec.reduced_heap, sec.fft_sizes,
                   sec.total_mem, sec.n_vars, sec.comm_solo,
                   sec.uses_gmem, sec.uses_midi_in,
                   sec.uses_midi_out)).encode())
    h.update(repr(sorted((repr(k), v)
                         for k, v in sec.slots.items())).encode())
    snap = sec.snap
    # statics the trace reads through _snap_value / builtins
    h.update(repr(sorted(snap.V.items())).encode())
    _hash_array(h, getattr(snap, "sliders", ()))
    _hash_array(h, getattr(snap, "spl", ()))
    for name in ("srate", "num_ch", "pdc_delay", "tempo", "play_state",
                 "play_position", "beats_position", "ts_num", "ts_denom",
                 "midi_bus", "ext_midi_bus", "ext_noinit", "gfx_ext_retina",
                 "sample_pool_ram_mb", "sample_pool_generation"):
        v = getattr(snap, name, None)
        if v is not None:
            try:
                h.update(f"{name}={float(v)!r};".encode())
            except (TypeError, ValueError):
                h.update(f"{name}={v!r};".encode())
    host = getattr(snap, "host", None)
    files = getattr(host, "files", None)
    if files is not None and getattr(files, "slots", None):
        for idx in sorted(files.slots):
            for la in files.slots[idx]:
                h.update(f"file{idx}:{getattr(la, 'name', '')}:"
                         f"{getattr(la, 'srate', 0)!r};".encode())
                aud = getattr(la, "audio", None)
                if aud is not None:
                    _hash_array(h, aud)
    pool = getattr(host, "pool", None)
    gen = getattr(pool, "generation", None)
    if gen is not None and getattr(gen, "entries", None):
        for sid in sorted(gen.entries):
            e = gen.entries[sid]
            h.update(f"pool{sid}:{e.srate!r}:{e.peak!r}:{e.rms!r};"
                     .encode())
            _hash_array(h, e.data)
    h.update(repr(shapes_key).encode())
    return h.hexdigest()


# ---------------------------------------------------------------------------
# the step callable


def step_callable(sec):
    """Return f(vars, mem, midi=None) for a DeviceSection, backed by the
    disk trace cache.  Numerics: a disk hit replays the exact StableHLO
    a fresh trace lowers to, so cached and fresh renders are
    bit-identical (tests/test_tracecache.py)."""
    import jax

    state: Dict[str, Any] = {"jit": None, "by_shape": {}}

    def _avals(vars_vec, mem, midi):
        import jax.numpy as jnp

        av = (jax.ShapeDtypeStruct(tuple(vars_vec.shape), jnp.float64),
              jax.ShapeDtypeStruct(tuple(mem.shape), jnp.float64))
        kw = {}
        if midi is not None:
            kw["midi"] = (
                jax.ShapeDtypeStruct(tuple(midi[0].shape), jnp.float64),
                jax.ShapeDtypeStruct(tuple(midi[1].shape), jnp.float64))
        return av, kw

    def _resolve(vars_vec, mem, midi):
        shapes = (tuple(vars_vec.shape), tuple(mem.shape),
                  None if midi is None else
                  (tuple(midi[0].shape), tuple(midi[1].shape)))
        ent = state["by_shape"].get(shapes)
        if ent is not None:
            return ent
        use_disk = enabled()
        key = section_key(sec, shapes) if use_disk else None
        blob_path = os.path.join(cache_dir(), f"{key}.jexp") \
            if use_disk else None
        meta_path = os.path.join(cache_dir(), f"{key}.json") \
            if use_disk else None
        if use_disk and os.path.exists(blob_path):
            try:
                from jax import export as jexport

                t0 = time.time()
                with open(blob_path, "rb") as f:
                    exp = jexport.deserialize(bytearray(f.read()))
                meta = {}
                if os.path.exists(meta_path):
                    with open(meta_path) as f:
                        meta = json.load(f)
                sec.fft_sizes_used |= set(meta.get("fft_sizes_used", ()))
                _dbg(f"hit @{sec.section} {shapes} "
                     f"({time.time() - t0:.1f}s deserialize)")
                ent = ("exp", exp)
                state["by_shape"][shapes] = ent
                return ent
            except Exception as exc:  # stale/corrupt artifact: re-trace
                _dbg(f"load failed @{sec.section}: {exc}")
        if state["jit"] is None:
            state["jit"] = jax.jit(sec.step)
        jitted = state["jit"]
        if use_disk:
            try:
                from jax import export as jexport

                av, kw = _avals(vars_vec, mem, midi)
                t0 = time.time()
                exp = jexport.export(
                    jitted, platforms=(export_platform(),))(*av, **kw)
                blob = exp.serialize()
                meta = {"fft_sizes_used": sorted(sec.fft_sizes_used),
                        "section": sec.section,
                        "plugin": getattr(sec.P, "desc", ""),
                        "platforms": list(getattr(exp, "platforms", ()))}
                tmp = blob_path + f".tmp{os.getpid()}"
                with open(tmp, "wb") as f:
                    f.write(bytes(blob))
                os.replace(tmp, blob_path)
                tmp = meta_path + f".tmp{os.getpid()}"
                with open(tmp, "w") as f:
                    json.dump(meta, f)
                os.replace(tmp, meta_path)
                _dbg(f"stored @{sec.section} {shapes} "
                     f"({time.time() - t0:.1f}s export, "
                     f"{len(blob)} bytes)")
                ent = ("exp", exp)
                state["by_shape"][shapes] = ent
                return ent
            except Exception as exc:
                _dbg(f"export failed @{sec.section}: {exc} — "
                     "falling back to in-process jit")
        ent = ("jit", jitted)
        state["by_shape"][shapes] = ent
        return ent

    def call(vars_vec, mem, midi=None):
        kind, fn = _resolve(vars_vec, mem, midi)
        if kind == "exp":
            if midi is None:
                return fn.call(vars_vec, mem)
            return fn.call(vars_vec, mem, midi=midi)
        if midi is None:
            return fn(vars_vec, mem)
        return fn(vars_vec, mem, midi=midi)

    return call
