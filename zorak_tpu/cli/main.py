"""Command-line interface: list / inspect / render / verify / bench.

Mirrors the reference build tool's UX (--list / --only filters, ref:
scripts/build.py:548-607) but for offline device rendering instead of
VST/CLAP packaging:

    python -m zorak_tpu.cli.main list   --catalog /root/reference
    python -m zorak_tpu.cli.main inspect --catalog ... --only DDT
    python -m zorak_tpu.cli.main render --catalog ... --only DDT \
        --in in.wav --out out.wav [--slider 1=30] [--engine auto|tpu|shadow]
    python -m zorak_tpu.cli.main verify --catalog ... --only DDT \
        [--seconds 2] [--export-dir out/]
    python -m zorak_tpu.cli.main bench  --catalog ... --only DDT --seconds 60
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np


def _specs(args):
    from ..catalog import discover, select

    specs = discover(args.catalog)
    if getattr(args, "only", None):
        specs = select(specs, args.only)
    return specs


def cmd_list(args) -> int:
    for s in _specs(args):
        print(f"{s.category:16s} {s.slug:18s} {s.plugin_type:5s} "
              f"{s.plugin_code} {s.entry_path.name}")
    return 0


def cmd_inspect(args) -> int:
    from ..models import get_faust_module

    for s in _specs(args):
        print(f"== {s.category}/{s.slug} ({s.plugin_type}) ==")
        if s.plugin_type == "jsfx":
            prog = s.load_program()
            caps = prog.capabilities()
            print(f"  desc: {prog.desc}")
            print(f"  io: {caps['io_channels']}  kind: {caps['plugin_kind']}")
            print(f"  midi: {caps['midi']}")
            print(f"  comm: uses_msg={prog.comm['uses_msg']} "
                  f"uses_gmem={prog.comm['uses_gmem']}")
            print(f"  sample_pool: {prog.sample_pool['uses_sample_pool']} "
                  f"file_io: {prog.sample_pool['uses_legacy_file_io']}")
            print(f"  memtop: {prog.memtop}")
            print(f"  sliders: {len(prog.slider_decls)}")
            for d in prog.slider_decls:
                kind = ("string" if d.is_string
                        else "choice" if d.is_choice else d.shape)
                print(f"    {d.ident:9s} [{kind:7s}] default={d.default:g} "
                      f"{d.label}")
        else:
            mod = get_faust_module(s.slug)
            if mod is None:
                print("  (no native module registered)")
                continue
            print(f"  module: {mod.name}  io: {mod.n_in}->{mod.n_out}  "
                  f"latency: {mod.latency_frames}")
            for p in mod.params:
                print(f"    {p.name:14s} default={p.default:g} "
                      f"[{p.lo:g}..{p.hi:g}] {p.unit}")
    return 0


def _parse_sliders(pairs):
    out = {}
    for p in pairs or []:
        k, _, v = p.partition("=")
        out[int(k) - 1] = float(v)
    return out


def cmd_render(args) -> int:
    from ..runtime import wavio
    from ..runtime.engine import PluginInstance

    specs = _specs(args)
    if len(specs) != 1:
        print(f"render needs exactly one plugin (matched {len(specs)})",
              file=sys.stderr)
        return 2
    spec = specs[0]
    x, rate = wavio.read_wav(args.infile)
    sliders = _parse_sliders(args.slider)

    if spec.plugin_type == "faust":
        from ..models import get_faust_module

        mod = get_faust_module(spec.slug)
        if mod is None:
            print(f"no native module for faust plugin {spec.slug}",
                  file=sys.stderr)
            return 2
        import jax.numpy as jnp

        vals = mod.values()
        if x.shape[0] < mod.n_in:
            x = np.concatenate(
                [x, np.zeros((mod.n_in - x.shape[0], x.shape[1]), np.float32)])
        t0 = time.perf_counter()
        y = np.asarray(mod.render(jnp.asarray(x[: mod.n_in], jnp.float64),
                                  vals, float(rate)), np.float32)
        wall = time.perf_counter() - t0
        engine = "tpu-faust"
    else:
        prog = spec.load_program()
        prefer = {"auto": "auto", "tpu": "tpu", "shadow": "none"}[args.engine]
        inst = PluginInstance(prog, srate=float(rate), sliders=sliders,
                              prefer=prefer)
        res = inst.render(x, monitor=args.monitor)
        y, wall, engine = res.audio, res.wall_seconds, res.engine
        if args.monitor != "compiled":
            print(f"monitor={args.monitor} "
                  f"max_delta={res.details['max_delta']:.3e}")

    wavio.write_wav(args.outfile, y, int(rate))
    secs = x.shape[1] / float(rate)
    print(f"rendered {secs:.2f}s via {engine} in {wall:.3f}s "
          f"({secs / max(wall, 1e-9):.0f}x realtime) -> {args.outfile}")
    return 0


def cmd_verify(args) -> int:
    from ..lowering import SpecializeError
    from ..verify import null_test_plugin

    failures = 0
    for spec in _specs(args):
        if spec.plugin_type != "jsfx":
            print(f"{spec.slug}: faust module (no shadow null test)")
            continue
        prog = spec.load_program()
        n = int(args.seconds * args.srate)
        rng = np.random.RandomState(42)
        ch = max(1, prog.io_channels["process"])
        x = (rng.randn(ch, n) * 0.25).astype(np.float32)
        try:
            rep = null_test_plugin(
                prog, x, srate=args.srate, golden=args.golden,
                export_dir=(args.export_dir if args.export_dir else None),
                name=spec.slug)
            print(f"{spec.slug}: {rep.summary()}")
            if not rep.audio_passed:
                failures += 1
        except SpecializeError as exc:
            print(f"{spec.slug}: SKIP vector engine ({exc}) — shadow-only")
    return 1 if failures else 0


def cmd_bench(args) -> int:
    from ..runtime.engine import PluginInstance

    specs = _specs(args)
    results = []
    for spec in specs:
        if spec.plugin_type != "jsfx":
            continue
        prog = spec.load_program()
        n = int(args.seconds * args.srate)
        ch = max(1, prog.io_channels["process"])
        x = (np.random.RandomState(1).randn(ch, n) * 0.25).astype(np.float32)
        try:
            inst = PluginInstance(prog, srate=args.srate, prefer="tpu")
        except Exception as exc:  # noqa: BLE001
            print(f"{spec.slug}: no vector engine ({exc})")
            continue
        inst.render(x[:, : min(n, 1 << 17)], fetch_audio=False, sync_state=False)
        best = 0.0
        for _ in range(3):
            t0 = time.perf_counter()
            inst.render(x, fetch_audio=False, sync_state=False)
            best = max(best, args.seconds / (time.perf_counter() - t0))
        print(f"{spec.slug}: {best:.0f}x realtime ({args.seconds:.0f}s render)")
        results.append((spec.slug, best))
    if args.json and results:
        print(json.dumps({slug: round(v, 1) for slug, v in results}))
    return 0


NEW_PLUGIN_TEMPLATE = """\
desc:{name}

slider1:50<0,100,1>Amount

@init
g = 0;

@slider
g = slider1 / 100;

@sample
spl0 *= g;
spl1 *= g;
"""


def cmd_help(args) -> int:
    """Render a plugin's embedded README help — the offline form of the
    reference editor's '?' markdown panel (ref: src/PluginMarkdownHelp.h:
    28-59 source selection + fallback, :830-859 title from the README).
    Adds a generated Controls reference from the slider metadata, like
    the editor's control surface."""
    from ..utils.mdtext import NO_README_FALLBACK, render_markdown

    ansi = sys.stdout.isatty() and not args.plain
    found = False
    for s in _specs(args):
        found = True
        md = s.help_markdown() or NO_README_FALLBACK
        if args.raw:
            print(md, end="" if md.endswith("\n") else "\n")
            continue
        print(render_markdown(md, width=args.width, ansi=ansi), end="")
        if s.plugin_type == "jsfx" and not args.no_controls:
            try:
                prog = s.load_program()
            except Exception:  # noqa: BLE001 — help must not hard-fail
                continue
            rows = []
            for d in prog.slider_decls:
                if d.hidden:
                    continue
                if d.is_string or d.is_choice:
                    rng = "choice" if d.is_choice else "text"
                else:
                    rng = f"{d.lo:g}..{d.hi:g}" \
                        if d.lo is not None and d.hi is not None else ""
                    if d.default is not None:
                        rng += f" (default {d.default:g})"
                lbl = d.label or ""
                if d.tooltip:
                    lbl += f" — {d.tooltip}"
                rows.append((f"slider{d.index0 + 1}", lbl, rng))
            if rows:
                ctl = ["", "## Controls", ""]
                ctl += [f"- `{n}` — {lbl}" + (f" `{rng}`" if rng else "")
                        for n, lbl, rng in rows]
                print(render_markdown("\n".join(ctl), width=args.width,
                                      ansi=ansi), end="")
    if not found:
        print("no matching plugin", file=sys.stderr)
        return 2
    return 0


def cmd_new_plugin(args) -> int:
    """Scaffold a catalog leaf (ref: scripts/new_plugin.py)."""
    import json as _json

    root = Path(args.catalog) / "plugins" / args.category / args.key
    if root.exists():
        print(f"{root} already exists", file=sys.stderr)
        return 2
    (root / "src").mkdir(parents=True)
    code = (args.key.upper() + "1111")[:4]
    (root / "plugin.json").write_text(_json.dumps({
        "name": args.name or args.key,
        "slug": args.key,
        "pluginCode": code,
        "pluginType": "jsfx",
    }, indent=2) + "\n")
    (root / "README.md").write_text(f"# {args.name or args.key}\n\n"
                                    f"Describe the plugin here; this file "
                                    f"is the embedded '?' help panel.\n")
    (root / "src" / f"{args.key}.jsfx").write_text(
        NEW_PLUGIN_TEMPLATE.format(name=args.name or args.key))
    print(f"scaffolded {root}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="zorak-tpu")
    sub = ap.add_subparsers(dest="cmd", required=True)

    def common(p):
        p.add_argument("--catalog", default="/root/reference",
                       help="catalog root (contains plugins/)")
        p.add_argument("--only", default="", help="filter plugins by substring")

    p = sub.add_parser("list")
    common(p)
    p.set_defaults(fn=cmd_list)

    p = sub.add_parser("inspect")
    common(p)
    p.set_defaults(fn=cmd_inspect)

    p = sub.add_parser("render")
    common(p)
    p.add_argument("--in", dest="infile", required=True)
    p.add_argument("--out", dest="outfile", required=True)
    p.add_argument("--slider", action="append",
                   help="sliderN=value (repeatable, 1-based N)")
    p.add_argument("--engine", choices=("auto", "tpu", "shadow"),
                   default="auto")
    p.add_argument("--monitor", choices=("compiled", "shadow", "delta"),
                   default="compiled",
                   help="correctness-monitor output selection (ref "
                        "JSFXCorrectnessCheck.h:1042): write the golden "
                        "shadow's audio or the compiled-minus-shadow null")
    p.set_defaults(fn=cmd_render)

    p = sub.add_parser("verify")
    common(p)
    p.add_argument("--seconds", type=float, default=0.5)
    p.add_argument("--srate", type=float, default=48000.0)
    p.add_argument("--golden", choices=("python", "native"), default="native")
    p.add_argument("--export-dir", default="")
    p.set_defaults(fn=cmd_verify)

    p = sub.add_parser("bench")
    common(p)
    p.add_argument("--seconds", type=float, default=60.0)
    p.add_argument("--srate", type=float, default=48000.0)
    p.add_argument("--json", action="store_true")
    p.set_defaults(fn=cmd_bench)

    p = sub.add_parser("help")
    common(p)
    p.add_argument("--raw", action="store_true",
                   help="print the raw embedded markdown")
    p.add_argument("--plain", action="store_true",
                   help="disable ANSI styling")
    p.add_argument("--width", type=int, default=78)
    p.add_argument("--no-controls", action="store_true",
                   help="omit the generated Controls reference")
    p.set_defaults(fn=cmd_help)

    p = sub.add_parser("new-plugin")
    p.add_argument("--catalog", required=True,
                   help="catalog root to scaffold into (must be writable)")
    p.add_argument("--category", required=True)
    p.add_argument("--key", required=True)
    p.add_argument("--name", default="")
    p.set_defaults(fn=cmd_new_plugin)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
