"""Probe: step a plugin block-by-block on devexec (device) vs the Python
golden and print a set of vars after each block — locates the first
divergent block/var when a null test reports var mismatches.

Usage: PYTHONPATH=... python scripts/probe_var_trace.py <slug> <vars,csv> [nblocks] [B]
"""
import sys

import jax

jax.config.update("jax_enable_x64", True)

from zorak_tpu.utils.cache import enable_persistent_cache

enable_persistent_cache()

import numpy as np

from zorak_tpu.catalog import discover
from zorak_tpu.lowering.devexec import DeviceExecKernel
from zorak_tpu.verify.nulltest import make_initialized_shadow

print("devices:", jax.devices(), flush=True)

specs = {s.slug: s for s in discover("/root/reference")}
slug = sys.argv[1]
names = sys.argv[2].split(",")
nblocks = int(sys.argv[3]) if len(sys.argv) > 3 else 8
B = int(sys.argv[4]) if len(sys.argv) > 4 else 512
cand = [k for k in specs if slug.lower() in k.lower()]
prog = specs[cand[0]].load_program()

gold = make_initialized_shadow(prog, 48000.0, None)
kern = DeviceExecKernel(prog, gold.state, 2, block_size=B)
print("kernel built", flush=True)

rng = np.random.default_rng(7)
x = (rng.standard_normal((2, nblocks * B)) * 0.25).astype(np.float32)

slots = {nm: kern.sample.slots.get(("var", nm)) for nm in names}
carry = None
for b in range(nblocks):
    xb = x[:, b * B:(b + 1) * B]
    y_dev, carry = kern.render_device(xb, carry)
    bv = np.asarray(carry[0])
    yg = np.zeros_like(xb)
    gold.process_block(xb, yg)
    yd = np.asarray(y_dev)
    aerr = float(np.max(np.abs(yd.astype(np.float32) - yg)))
    row = []
    for nm in names:
        gv = gold.state.V.get(nm, 0.0)
        dv = float(bv[slots[nm]]) if slots[nm] is not None else float("nan")
        mark = "" if gv == dv else "  <<<"
        row.append(f"{nm}: g={gv!r} d={dv!r}{mark}")
    print(f"block {b} audio_err={aerr:.3e}", flush=True)
    for r in row:
        print("   ", r, flush=True)
