#!/usr/bin/env python3
"""Benchmark: the DDT-class 60 s, 48 kHz stereo offline render and the
kernel sections, in one process on one GPU.

    python bench.py

Sections (one JSON line each on stdout, progress on stderr):
  ddt          DDT-class program (benchmarks/programs/ddt_class.jsfx),
               one 60 s stereo render through the vector engine;
  ddt_batched  8 such renders in one dispatch (BatchRenderer);
  stft, denoiser, convolution
               the kernels/ pipelines over 32 lanes x 20 s;
  onepole_scan dspkit.switching_onepole (a lax.scan over time) over
               32 lanes x 960,000 samples: the bar a fused recurrence
               kernel has to beat.

Every timing ends in block_until_ready on a fresh on-device input; the
first call of each section (trace + compile + run) is reported apart.
The last line is the whole result with the device it ran on and the
card's name and power limit.  Any backend but the GPU exits non-zero.
"""
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

DDT_PATH = Path(__file__).resolve().parent / "benchmarks" / "programs" \
    / "ddt_class.jsfx"
SRATE = 48000.0
N_SAMPLES = int(60 * SRATE)
SECONDS = N_SAMPLES / SRATE
RUNS = 5
LANES = 32
KERNEL_SECONDS = 20.0
T0 = time.time()


def log(msg: str) -> None:
    print(f"[bench {time.time() - T0:6.1f}s] {msg}", file=sys.stderr,
          flush=True)


def timed_section(make_input, fn, audio_seconds: float) -> dict:
    """First call, then RUNS timed calls, each on a fresh input."""
    import jax

    x = jax.block_until_ready(make_input(0))
    t0 = time.perf_counter()
    jax.block_until_ready(fn(x))
    first = time.perf_counter() - t0
    walls = []
    for i in range(RUNS):
        x = jax.block_until_ready(make_input(i + 1))
        t0 = time.perf_counter()
        jax.block_until_ready(fn(x))
        walls.append(time.perf_counter() - t0)
    med = statistics.median(walls)
    return {"first_call_s": first, "wall_s": walls, "median_s": med,
            "audio_s_per_s": audio_seconds / med}


def noise_fn(shape, dtype, scale=0.25):
    import jax

    gen = jax.jit(lambda key: jax.random.normal(key, shape, dtype) * scale)
    return lambda i: gen(jax.random.PRNGKey(i))


def section_ddt() -> dict:
    import jax.numpy as jnp

    from zorak_tpu.ir import load_plugin_file
    from zorak_tpu.runtime.engine import PluginInstance

    inst = PluginInstance(load_plugin_file(DDT_PATH), srate=SRATE)
    if inst.engine != "tpu-vector":
        raise RuntimeError(f"DDT-class took {inst.engine}: "
                           f"{inst.spec_error}")
    out = timed_section(noise_fn((2, N_SAMPLES), jnp.float32),
                        lambda x: inst.kernel.render_device(x)[0], SECONDS)
    out["engine"] = inst.engine
    return out


def section_ddt_batched(files: int = 8) -> dict:
    import jax.numpy as jnp

    from zorak_tpu.ir import load_plugin_file
    from zorak_tpu.parallel import BatchRenderer

    br = BatchRenderer(load_plugin_file(DDT_PATH), SRATE)
    out = timed_section(noise_fn((files, 2, N_SAMPLES), jnp.float32),
                        br.render_files, files * SECONDS)
    out["files"] = files
    return out


def section_stft() -> dict:
    import jax
    import jax.numpy as jnp

    from zorak_tpu.kernels.stft import stft_process

    n = int(KERNEL_SECONDS * SRATE)

    def bins(spec):
        return spec * jnp.linspace(0.5, 1.5, spec.shape[-1],
                                   dtype=jnp.float32)

    run = jax.jit(jax.vmap(
        lambda ch: stft_process(ch, bins, size=2048, hop=512)))
    return timed_section(noise_fn((LANES, n), jnp.float32), run,
                         LANES * n / SRATE)


def section_denoiser() -> dict:
    import jax
    import jax.numpy as jnp

    from zorak_tpu.kernels.stft import spectral_gate

    n = int(KERNEL_SECONDS * SRATE)
    gate = jax.jit(jax.vmap(lambda ch: spectral_gate(ch, size=2048)))
    return timed_section(noise_fn((LANES, n), jnp.float32, 0.02), gate,
                         LANES * n / SRATE)


def section_convolution() -> dict:
    import jax
    import jax.numpy as jnp

    from zorak_tpu.kernels.convolution import partitioned_convolve

    n = int(KERNEL_SECONDS * SRATE)
    k = 131072
    rng = np.random.RandomState(11)
    ir = jnp.asarray(rng.randn(k) * np.exp(-np.arange(k) / (k / 5)),
                     jnp.float32)
    conv = jax.jit(jax.vmap(
        lambda ch: partitioned_convolve(ch, ir, part_size=2048)))
    return timed_section(noise_fn((LANES, n), jnp.float32), conv,
                         LANES * n / SRATE)


def section_onepole_scan(n: int = 960_000) -> dict:
    import jax
    import jax.numpy as jnp

    from zorak_tpu.models.dspkit import switching_onepole

    run = jax.jit(lambda x: switching_onepole(jnp.abs(x), 0.999, 0.9999))
    out = timed_section(noise_fn((LANES, n), jnp.float64), run,
                        LANES * n / SRATE)
    out["shape"] = [LANES, n]
    return out


SECTIONS = {
    "ddt": section_ddt,
    "ddt_batched": section_ddt_batched,
    "stft": section_stft,
    "denoiser": section_denoiser,
    "convolution": section_convolution,
    "onepole_scan": section_onepole_scan,
}


def main() -> int:
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        log(f"backend is {devices[0].platform}, not gpu; nothing measured")
        return 3

    from zorak_tpu.utils.cache import enable_persistent_cache

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60
    ).stdout.strip().splitlines()[0]
    result = {"card": card, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)},
        "compile_cache": enable_persistent_cache(), "sections": {}}
    log(f"card: {card}")
    for name, fn in SECTIONS.items():
        log(f"{name}: start")
        out = fn()
        result["sections"][name] = out
        print(json.dumps({"section": name, "card": card, **out}),
              flush=True)
        log(f"{name}: {out['audio_s_per_s']:.1f} audio-s/s")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
