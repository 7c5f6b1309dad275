"""Batch scale-out: many files x many plugin configs on one chip (vmap),
or sharded over a device mesh (files = data-parallel axis, instances =
config-parallel axis).

This is the data-parallel replacement for the reference's throughput model
(one realtime process per plugin instance): the whole catalog renders as
one vmapped XLA program; multi-chip scale-out shards the batch axes over
`jax.sharding.Mesh` (ref mapping: SURVEY.md section 5.8 — the reference's
parallel axes are files x channels x instances, not model parallelism).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..ir.program import PluginProgram
from ..lowering import SpecializeError, specialize_sample_kernel
from ..verify.nulltest import make_initialized_shadow


class BatchRenderer:
    """One plugin, many (slider-config) instances, many files.

    Instances share one compiled kernel when their CONTROL STATE is
    identical; differing slider configs specialize separately (control
    state is baked into the XLA program — that is where the speed comes
    from), so the batch axes here are files and channels, and the
    instance axis vmaps over per-instance carried state.
    """

    def __init__(self, program: PluginProgram, srate: float = 48000.0,
                 sliders: Optional[Dict[int, float]] = None,
                 segment_len: int = 1 << 16, block_size: int = 512):
        self.program = program
        self.srate = srate
        self._sliders = dict(sliders) if sliders else None
        self.nch = max(1, program.io_channels["process"])
        shadow = make_initialized_shadow(program, srate, sliders)
        self.kernel = specialize_sample_kernel(
            program, shadow.state, self.nch, segment_len=segment_len,
            block_size=block_size)
        self._batched_fns: Dict[Tuple[int, int, int], object] = {}
        # (files, T) -> device-resident (carry, ctrl, rand)
        self._staged: Dict[Tuple[int, int], tuple] = {}

    def render_files(self, x: np.ndarray, mesh=None):
        """x: float32 [files, nch, T] -> y float32 device array (same shape).

        With a mesh, the files axis shards across devices ('files' axis
        name); otherwise it vmaps on one chip.
        """
        import jax
        import jax.numpy as jnp

        nf, nch, T = x.shape
        assert nch == self.nch
        kern = self.kernel
        L = min(kern.L, max(kern.B, (T // kern.B) * kern.B))

        key = (nf, T, 0 if mesh is None else 1)
        fn = self._batched_fns.get(key)
        if fn is None:
            # use the raw (unjitted) pipeline so vmap sees one function
            raw = _raw_render(kern, T, L)
            batched = jax.vmap(raw, in_axes=(0, 0, None, None))
            if mesh is not None:
                from jax.sharding import NamedSharding, PartitionSpec as P

                fn = jax.jit(
                    batched,
                    in_shardings=(
                        jax.tree.map(lambda _: NamedSharding(mesh, P("files")),
                                     kern.initial_carry()),
                        NamedSharding(mesh, P("files")),
                        None, None),
                    out_shardings=(NamedSharding(mesh, P("files")),
                                   jax.tree.map(
                                       lambda _: NamedSharding(mesh, P("files")),
                                       kern.initial_carry())))
            else:
                fn = jax.jit(batched)
            self._batched_fns[key] = fn

        # the batched fn does not donate: stage carry/ctrl/rand once per
        # (files, T) shape and reuse device-resident copies on every call
        skey = (nf, T)
        staged = self._staged.get(skey)
        if staged is None:
            carry0 = kern.initial_carry()
            carry = jax.tree.map(
                lambda leaf: np.broadcast_to(np.asarray(leaf),
                                             (nf,) + np.shape(leaf)).copy(),
                carry0)

            n_full_blocks = T // kern.B
            rem_block = T - n_full_blocks * kern.B
            if kern.has_block and not kern.coupled:
                ctrl = kern.cached_trajectory(n_full_blocks, rem_block)
            else:
                rows = n_full_blocks + (1 if rem_block else 0)
                ctrl = np.zeros((rows, len(kern.ctrl_order)),
                                dtype=np.float64)

            rand = kern._rand_streams(T, reset=True)
            staged = (jax.device_put(carry), jnp.asarray(ctrl),
                      jnp.asarray(rand))
            if len(self._staged) < 8:
                self._staged[skey] = staged
        carry, ctrl, rand = staged
        if not isinstance(x, jax.Array):
            x = jnp.asarray(np.ascontiguousarray(x, np.float32))
        y, fcarry = fn(carry, x, ctrl, rand)
        if getattr(kern.sym, "masked_loops", None):
            # guessed masked-loop bound: check the carried overflow
            # monitor across the batch (one scalar D2H, only for kernels
            # that carry the guard) and rebuild+replay with a doubled K
            # when any file's realized loop count exceeded it — the
            # render_device ladder, batched
            c0 = fcarry[0]
            svec = c0[0] if isinstance(c0, tuple) else c0
            slot = kern.scalar_index[("mloop", "ovf")]
            ovf = float(np.asarray(svec[..., slot]).max())
            if ovf > 0.0:
                new_k = 1 << max(1, int(kern.masked_loop_k + ovf
                                        - 1).bit_length())
                from ..lowering import specialize_sample_kernel
                from ..verify.nulltest import make_initialized_shadow

                shadow = make_initialized_shadow(
                    self.program, self.srate, self._sliders)
                self.kernel = specialize_sample_kernel(
                    self.program, shadow.state, self.nch,
                    segment_len=kern.L, block_size=kern.B,
                    masked_loop_k=new_k)
                self._batched_fns.clear()
                self._staged.clear()
                return self.render_files(x, mesh=mesh)
        return y


def _raw_render(kern, T: int, L: int):
    """Unjitted whole-render pipeline (vmap-able)."""
    import jax
    import jax.numpy as jnp

    if kern.coupled:
        return kern._coupled_run(T)
    if kern._hop is not None:
        return kern._hop_run(T, kern._hop_phase0)

    nch = kern.nch
    nfull = T // L
    rem = T - nfull * L
    seg = kern._make_seg_fn(L)
    seg_rem = kern._make_seg_fn(rem) if rem else None
    B = kern.B
    rows_per_seg = L // B
    n_ctrl = len(kern.ctrl_order)

    n_rand = kern.n_rand

    rand_gated = kern.rand_gated

    def run(carry, x32, ctrl, rand):
        x64 = x32.astype(jnp.float64)
        ys = []
        if rand_gated:
            # whole-render flat pool, indexed by the carried draw count
            pool = rand.reshape(-1)
            body = lambda c, xs: seg(c, (xs[0], xs[1], pool))  # noqa: E731
        else:
            body = None
        if nfull:
            xin = x64[:, : nfull * L].reshape(nch, nfull, L).transpose(1, 0, 2)
            cin = ctrl[: nfull * rows_per_seg].reshape(nfull, rows_per_seg, n_ctrl)
            if rand_gated:
                carry2, yseg = jax.lax.scan(body, carry, (xin, cin))
            else:
                rin = rand[: nfull * L].reshape(nfull, L, n_rand)
                carry2, yseg = jax.lax.scan(seg, carry, (xin, cin, rin))
        else:
            carry2 = carry
        if rem:
            if rand_gated:
                carry2, y_r = seg_rem(
                    carry2, (x64[:, nfull * L:],
                             ctrl[nfull * rows_per_seg:], pool))
            else:
                carry2, y_r = seg_rem(
                    carry2, (x64[:, nfull * L:], ctrl[nfull * rows_per_seg:],
                             rand[nfull * L:]))
        if nfull:
            ys.append(yseg.transpose(1, 0, 2).reshape(nch, nfull * L))
        if rem:
            ys.append(y_r)
        y = jnp.concatenate(ys, axis=1) if len(ys) > 1 else ys[0]
        return y.astype(jnp.float32), carry2

    return run


def render_batch(program: PluginProgram, x_files: np.ndarray,
                 srate: float = 48000.0, mesh=None, **kw):
    return BatchRenderer(program, srate=srate, **kw).render_files(
        x_files, mesh=mesh)


class _FaustKernelShim:
    """Just enough kernel surface for the stacked-render group planner
    (Faust modules are light: no coupled pipeline, no hop section)."""
    coupled = False
    _hop = None
    has_block = False


class FaustBatchRenderer:
    """Faust-family catalog entry: a native JAX module (models/faustmods)
    rendered whole-T — functional, no carried segment state — exposing the
    same render_files / stacked-entry surface as BatchRenderer so the
    catalog sweep covers the full plugin set, not just the JSFX family."""

    is_faust = True

    def __init__(self, slug: str, srate: float = 48000.0):
        from ..models import get_faust_module

        mod = get_faust_module(slug)
        if mod is None:
            raise SpecializeError(f"no Faust module for {slug}")
        self.mod = mod
        self.slug = slug
        self.srate = float(srate)
        self.nch = int(mod.n_in)
        self.values = mod.values()
        self.kernel = _FaustKernelShim()
        self._fns: Dict[Tuple[int, int], object] = {}

    def raw_render(self, T: int):
        import jax.numpy as jnp

        mod, v, sr = self.mod, self.values, self.srate

        def run(x32):
            # module contract is f64 (matches the NumPy goldens); output
            # rides the sweep as f32 like every other catalog entry
            y = mod.render(jnp.asarray(x32, jnp.float64), v, sr)
            return jnp.asarray(y, jnp.float32), None

        return run

    def render_files(self, x: np.ndarray):
        import jax
        import jax.numpy as jnp

        nf, nch, T = x.shape
        assert nch == self.nch
        fn = self._fns.get((nf, T))
        if fn is None:
            raw = self.raw_render(T)
            fn = jax.jit(jax.vmap(lambda a: raw(a)[0]))
            self._fns[(nf, T)] = fn
        if not isinstance(x, jax.Array):
            x = jnp.asarray(np.ascontiguousarray(x, np.float32))
        return fn(x)


def build_catalog_renderers(catalog_root: str, srate: float = 48000.0,
                            only: str = "", segment_len: int = 1 << 16):
    """Specialize every vectorizable catalog plugin once.

    Returns ({slug: renderer}, {slug: fallback reason}) so callers can
    render (and time) repeatedly without paying re-specialization.  JSFX
    plugins get BatchRenderer (the time-vectorized kernel); the Faust
    five get FaustBatchRenderer (native JAX modules)."""
    from ..catalog import discover, select

    renderers: Dict[str, BatchRenderer] = {}
    skipped: Dict[str, str] = {}
    for spec in select(discover(catalog_root), only):
        if spec.plugin_type != "jsfx":
            try:
                renderers[spec.slug] = FaustBatchRenderer(
                    spec.slug, srate=srate)
            except SpecializeError as exc:
                skipped[spec.slug] = str(exc)
            continue
        try:
            renderers[spec.slug] = BatchRenderer(
                spec.load_program(), srate=srate, segment_len=segment_len)
        except SpecializeError as exc:
            skipped[spec.slug] = str(exc)
    return renderers, skipped


def catalog_stacked_render(renderers: Dict[str, "BatchRenderer"],
                           x: np.ndarray, groups=None, plan=None):
    """Render one input through MANY plugins in as few device dispatches
    as possible: each group of plugins fuses into ONE jitted XLA program
    (the sequential sweep pays one dispatch per plugin).

    groups: optional list of slug-lists; default = one group per heavy
    coupled plugin (their compiles are multi-minute on their own) plus
    one group with everything else.  Returns ({slug: device audio},
    n_dispatches)."""
    import jax

    T = int(x.shape[1])
    # the fused programs do NOT donate their inputs, so everything can be
    # staged to the device ONCE and reused across timed renders — repeated
    # sweeps pay zero host->device transfer
    ekey = ("entries", T)
    xkey = ("xdev", T)
    entries = {} if plan is None else plan.setdefault(ekey, {})
    x_dev: Dict[int, object] = {} if plan is None \
        else plan.setdefault(xkey, {})
    for slug, r in renderers.items():
        if slug in entries:
            continue
        if getattr(r, "is_faust", False):
            nch = r.nch
            if nch not in x_dev:
                xf = x[:nch] if x.shape[0] >= nch else np.broadcast_to(
                    x[:1], (nch, T))
                x_dev[nch] = jax.device_put(
                    np.ascontiguousarray(xf, np.float32))
            entries[slug] = (r.raw_render(T), (x_dev[nch],))
            continue
        kern = r.kernel
        L = min(kern.L, max(kern.B, (T // kern.B) * kern.B))
        raw = _raw_render(kern, T, L)
        n_full = T // kern.B
        rem = T - n_full * kern.B
        if kern.has_block and not kern.coupled:
            ctrl = kern.cached_trajectory(n_full, rem)
        else:
            rows = n_full + (1 if rem else 0)
            ctrl = np.zeros((rows, len(kern.ctrl_order)),
                            dtype=np.float64)
        rand = kern._rand_streams(T, reset=True)
        nch = kern.nch
        if nch not in x_dev:
            xf = x[:nch] if x.shape[0] >= nch else np.broadcast_to(
                x[:1], (nch, T))
            x_dev[nch] = jax.device_put(
                np.ascontiguousarray(xf, np.float32))
        entries[slug] = (raw, (
            jax.device_put(kern.initial_carry()), x_dev[nch],
            jax.device_put(ctrl), jax.device_put(rand)))

    if groups is None:
        # group from THIS call's renderers — a shared plan's entries
        # cache holds every slug ever staged, including ones not being
        # rendered now
        heavy = [s for s in renderers if s in entries
                 and (renderers[s].kernel.coupled
                      or renderers[s].kernel._hop is not None)]
        light = [s for s in renderers
                 if s in entries and s not in heavy]
        # bound each fused program's size, and with it compile time
        # and memory
        groups = [light[i:i + 5] for i in range(0, len(light), 5)]
        groups += [[s] for s in heavy]
    groups = [[s for s in g if s in entries] for g in groups]
    groups = [g for g in groups if g]

    outs: Dict[str, Any] = {}
    for group in groups:
        key = (tuple(sorted(group)), T)
        fn = None if plan is None else plan.get(key)
        if fn is None:
            raws = {s: entries[s][0] for s in group}

            def stacked(inputs, _raws=raws):
                return {s: _raws[s](*inputs[s])[0] for s in _raws}

            fn = jax.jit(stacked)
            if plan is not None:
                plan[key] = fn
        ys = fn({s: entries[s][1] for s in group})
        outs.update(ys)
    return outs, len(groups)


def catalog_batch_render(catalog_root: str, x: np.ndarray,
                         srate: float = 48000.0, only: str = "",
                         segment_len: int = 1 << 16, renderers=None):
    """Render the same input through every vectorizable catalog plugin;
    returns {slug: device audio} plus the skip map — the 'whole catalog on
    one chip' configuration.  Pass a prebuilt `renderers` map (from
    build_catalog_renderers) to skip re-specialization."""
    import jax

    skipped: Dict[str, str] = {}
    if renderers is None:
        renderers, skipped = build_catalog_renderers(
            catalog_root, srate=srate, only=only, segment_len=segment_len)
    outs = {}
    x_dev: Dict[int, object] = {}  # one upload per channel count
    for slug, r in renderers.items():
        nch = r.nch
        if nch not in x_dev:
            xf = x[None, :nch] if x.shape[0] >= nch else np.broadcast_to(
                x[None, :1], (1, nch, x.shape[1]))
            x_dev[nch] = jax.device_put(np.ascontiguousarray(xf, np.float32))
        outs[slug] = r.render_files(x_dev[nch])
    return outs, skipped
