"""JAX DSP building blocks for the Faust-family plugin modules.

Data-parallel implementations of the stdfaust primitives the catalog's five
Faust plugins use (ref: plugins/*/src/*.dsp): one-pole smoothers and
biquads as associative scans, max-hold followers as max-plus scans,
switching (attack/release) one-poles as lax.scan, FIRs as convolutions,
and Faust's LCG noise in closed form.  Everything is f64, [..., T]-shaped
with time last, and jit/vmap friendly.
"""
from __future__ import annotations

import math
from functools import partial
from typing import Tuple

import jax.numpy as jnp
from jax import lax

F64 = jnp.float64


def db2lin(db):
    return jnp.power(10.0, jnp.asarray(db, F64) / 20.0)


def lin2db(x, floor=1e-30):
    return 20.0 * jnp.log10(jnp.maximum(x, floor))


def clamp(x, lo, hi):
    return jnp.minimum(jnp.maximum(x, lo), hi)


def smoothstep01(x):
    u = clamp(x, 0.0, 1.0)
    return u * u * (3.0 - 2.0 * u)


def ms2pole(ms, srate):
    return jnp.exp(-1.0 / (srate * (ms / 1000.0)))


def hz2pole(hz, srate):
    return jnp.exp(-2.0 * math.pi * jnp.maximum(hz, 1e-3) / srate)


# ---------------------------------------------------------------------------
# recurrences


def onepole(x, pole, z0=0.0):
    """y[t] = (1-pole)*x[t] + pole*y[t-1]  (si.smooth / onePoleExp)."""
    def combine(p, q):
        a1, b1 = p
        a2, b2 = q
        return a1 * a2, a2 * b1 + b2

    n = x.shape[-1]
    a = jnp.broadcast_to(jnp.asarray(pole, F64), x.shape)
    b = (1.0 - a) * x
    A, B = lax.associative_scan(combine, (a, b), axis=-1)
    return A * z0 + B


def integrator(x, pole, z0=0.0):
    """y[t] = x[t] + pole*y[t-1]  (plain leaky accumulation)."""
    def combine(p, q):
        a1, b1 = p
        a2, b2 = q
        return a1 * a2, a2 * b1 + b2

    a = jnp.broadcast_to(jnp.asarray(pole, F64), x.shape)
    A, B = lax.associative_scan(combine, (a, x), axis=-1)
    return A * z0 + B


def max_follower(x, rel_pole, z0=0.0):
    """y[t] = max(x[t], rel_pole*y[t-1])  — max-plus associative scan."""
    def combine(p, q):
        a1, b1 = p
        a2, b2 = q
        return a1 * a2, jnp.maximum(b1 * a2, b2)

    a = jnp.broadcast_to(jnp.asarray(rel_pole, F64), x.shape)
    A, B = lax.associative_scan(combine, (a, x), axis=-1)
    return jnp.maximum(A * z0, B)


def switching_onepole(x, up_pole, down_pole, z0=0.0):
    """si.lag_ud / si.onePoleSwitching: pole depends on rise vs fall.

    Genuinely sequential (coefficient depends on the state); runs as a
    lax.scan over time with all leading axes vectorized.
    """
    up = jnp.asarray(up_pole, F64)
    dn = jnp.asarray(down_pole, F64)

    def step(z, xt):
        pole = jnp.where(xt > z, up, dn)
        z = xt + (z - xt) * pole
        return z, z

    xt = jnp.moveaxis(x, -1, 0)
    _, y = lax.scan(step, jnp.broadcast_to(jnp.asarray(z0, F64), x.shape[:-1]), xt)
    return jnp.moveaxis(y, 0, -1)


def amp_follower_ar(x, att_sec, rel_sec, srate, z0=0.0):
    """Faust an.amp_follower_ar: abs + attack/release switching one-pole."""
    up = jnp.exp(-1.0 / (srate * jnp.maximum(att_sec, 1e-9)))
    dn = jnp.exp(-1.0 / (srate * jnp.maximum(rel_sec, 1e-9)))
    return switching_onepole(jnp.abs(x), up, dn, z0)


def biquad_tf2(x, b0, b1, b2, a1, a2, s0=(0.0, 0.0)):
    """Transposed direct-form II biquad (fi.tf22t) via matrix scan.

    y[t]  = b0*x + s1
    s1'   = b1*x - a1*y + s2
    s2'   = b2*x - a2*y

    State recurrence s' = A s + B x with constant A -> associative scan on
    (2x2 matrix, 2-vector) pairs; y reconstructed from the shifted states.
    """
    b0 = jnp.asarray(b0, F64)
    b1 = jnp.asarray(b1, F64)
    b2 = jnp.asarray(b2, F64)
    a1 = jnp.asarray(a1, F64)
    a2 = jnp.asarray(a2, F64)

    A = jnp.array([[-a1, 1.0], [-a2, 0.0]], dtype=F64)
    Bvec = jnp.stack([b1 - a1 * b0, b2 - a2 * b0])  # s' contribution of x

    n = x.shape[-1]
    As = jnp.broadcast_to(A, x.shape[:-1] + (n, 2, 2))
    Bs = Bvec * x[..., None]  # [..., T, 2]

    def combine(p, q):
        A1, b1_ = p
        A2, b2_ = q
        return A2 @ A1, jnp.einsum("...ij,...j->...i", A2, b1_) + b2_

    Acum, Bcum = lax.associative_scan(combine, (As, Bs), axis=-3)
    s_init = jnp.asarray(s0, F64)
    states = jnp.einsum("...ij,j->...i", Acum, s_init) + Bcum  # state AFTER t
    s1_prev = jnp.concatenate(
        [jnp.broadcast_to(s_init[0], x.shape[:-1] + (1,)),
         states[..., :-1, 0]], axis=-1)
    return b0 * x + s1_prev


def rbj_coeffs(kind: str, fc, q, srate) -> Tuple:
    """RBJ biquad coefficients as used by VAR (ref: VAR .dsp rbjHP/LP/BP)."""
    fc = jnp.minimum(jnp.asarray(fc, F64), 0.45 * srate)
    q = jnp.maximum(jnp.asarray(q, F64), 0.001)
    w0 = 2.0 * math.pi * fc / srate
    cw = jnp.cos(w0)
    sw = jnp.sin(w0)
    alpha = sw / (2.0 * q)
    if kind == "hp":
        bb = ((1 + cw) / 2, -(1 + cw), (1 + cw) / 2)
    elif kind == "lp":
        bb = ((1 - cw) / 2, 1 - cw, (1 - cw) / 2)
    elif kind == "bp_skirt":
        bb = (sw / 2, 0.0 * sw, -sw / 2)
    else:
        raise ValueError(kind)
    a0 = 1 + alpha
    return (bb[0] / a0, bb[1] / a0, bb[2] / a0, (-2 * cw) / a0, (1 - alpha) / a0)


# ---------------------------------------------------------------------------
# FIR / delay


def delay(x, samples: int):
    """Static integer delay with zero history."""
    if samples <= 0:
        return x
    n = x.shape[-1]
    if samples >= n:
        return jnp.zeros_like(x)
    pad = jnp.zeros(x.shape[:-1] + (samples,), dtype=x.dtype)
    return jnp.concatenate([pad, x[..., : n - samples]], axis=-1)


def fir(x, taps):
    """Causal FIR y[t] = sum_k taps[k] * x[t-k], zero history.

    Runs as an XLA convolution in x's dtype (f64 for the modules).
    """
    taps = jnp.asarray(taps, jnp.asarray(x).dtype)
    k = taps.shape[-1]
    lead = x.shape[:-1]
    xf = x.reshape((-1, 1, x.shape[-1]))
    w = taps[::-1].reshape((1, 1, k))
    y = lax.conv_general_dilated(xf, w, window_strides=(1,),
                                 padding=[(k - 1, 0)])
    return y.reshape(lead + (x.shape[-1],))


def gaussian_fir_taps(sigma_samples, radius: int):
    """GTS kernel: normalized symmetric Gaussian over [-R..R]
    (ref: Gaussian Transient Shaper (GTS).dsp gaussKernel)."""
    sigma = jnp.maximum(jnp.asarray(sigma_samples, F64), 0.25)
    i = jnp.arange(-radius, radius + 1, dtype=F64)
    g = jnp.exp(-0.5 * jnp.square(i / sigma))
    g0 = jnp.exp(jnp.float64(0.0))
    rest = jnp.sum(jnp.exp(-0.5 * jnp.square(jnp.arange(1, radius + 1, dtype=F64) / sigma)))
    return g / (g0 + 2.0 * rest + 1e-20)


# ---------------------------------------------------------------------------
# noise (Faust no.noise: int32 LCG, closed form so it vectorizes)

_LCG_A = 1103515245
_LCG_C = 12345
_LCG_M = 1 << 32


def lcg_noise(n: int, seed: int = 12345, dtype=F64):
    """Faust-style noise in (-1, 1): x_k = lcg^k(seed)/2^31, computed in
    closed form (A^k and the geometric sum mod 2^32 are precomputable)."""
    import numpy as np

    ks = np.arange(n, dtype=np.uint64)
    # iterate in O(n) on host once; values cached by callers via jit consts
    vals = np.empty(n, dtype=np.int64)
    s = seed & 0xFFFFFFFF
    for k in range(n):
        s = (_LCG_A * s + _LCG_C) & 0xFFFFFFFF
        vals[k] = s if s < (1 << 31) else s - _LCG_M
    return jnp.asarray(vals.astype(np.float64) / float(1 << 31), dtype=dtype)
