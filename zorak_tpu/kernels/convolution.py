"""Convolution kernels: direct FIR (XLA conv) and partitioned FFT
convolution for long impulse responses.

The data-parallel form of PsychoConvolver's partitioned engine (ref:
plugins/Spatialization/PsychoConvolver/src/PsychoConvolver.jsfx:288-401 —
per-block fft_real + convolve_c accumulation over partitions): all
partitions and all frames multiply-accumulate as ONE batched complex
product accumulated over partitions, then overlap-add.
"""
from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp

F64 = jnp.float64


def fir_conv(x: jnp.ndarray, taps: jnp.ndarray) -> jnp.ndarray:
    """Causal direct FIR via XLA conv: y[t] = sum_k taps[k] x[t-k].

    x: [..., T]; taps: [K]. Right choice for K up to a few thousand."""
    taps = jnp.asarray(taps, F64)
    k = taps.shape[-1]
    lead = x.shape[:-1]
    xf = x.reshape((-1, 1, x.shape[-1])).astype(F64)
    w = taps[::-1].reshape((1, 1, k))
    y = jax.lax.conv_general_dilated(xf, w, window_strides=(1,),
                                     padding=[(k - 1, 0)])
    return y.reshape(lead + (x.shape[-1],))


@partial(jax.jit, static_argnames=("part_size",))
def partitioned_convolve(x: jnp.ndarray, ir: jnp.ndarray,
                         part_size: int = 2048) -> jnp.ndarray:
    """Uniform partitioned convolution (overlap-save per partition).

    x: [T] input; ir: [K] impulse response. Output length T (causal,
    truncated like a realtime convolver). part_size must be a power of 2.

    Frequency-domain MAC across partitions is one einsum over
    [frames, parts, bins] x [parts, bins] — batched work XLA maps well.
    """
    B = part_size
    N = 2 * B
    # f32/c64 end-to-end: the audio contract compares f32-rounded
    # samples at 1e-5; the partition MAC is elementwise, not a matmul
    x = jnp.asarray(x, jnp.float32)
    ir = jnp.asarray(ir, jnp.float32)
    T = x.shape[-1]
    k = ir.shape[-1]
    n_parts = max(1, -(-k // B))
    ir_p = jnp.pad(ir, (0, n_parts * B - k)).reshape(n_parts, B)
    H = jnp.fft.rfft(ir_p, N, axis=-1)  # [parts, bins]

    n_frames = -(-T // B)
    xp = jnp.pad(x, (B, n_frames * B - T))  # leading history block
    # frame f covers input samples [f*B - B, f*B + B) (overlap-save)
    idx = jnp.arange(n_frames)[:, None] * B + jnp.arange(N)[None, :]
    X = jnp.fft.rfft(xp[idx], axis=-1)  # [frames, bins]

    # delay-line of spectra: output frame f accumulates X[f - p] * H[p].
    # NOT a materialized [frames, parts, bins] gather — that is an
    # O(parts) memory blow-up (0.5 GB per 20 s lane at 64 partitions;
    # OOMed HBM under 32 vmapped lanes).  Accumulate over partitions
    # instead: n_parts sequential FMAs over [frames, bins], peak memory
    # O(frames * bins).
    Xpad = jnp.concatenate(
        [jnp.zeros((n_parts - 1,) + X.shape[1:], X.dtype), X], axis=0)

    def mac(acc, ph):
        h, p = ph
        xs = jax.lax.dynamic_slice_in_dim(Xpad, n_parts - 1 - p,
                                          n_frames, axis=0)
        return acc + xs * h, None

    Y, _ = jax.lax.scan(mac, jnp.zeros_like(X),
                        (H, jnp.arange(n_parts)))
    y = jnp.fft.irfft(Y.astype(jnp.complex64), N, axis=-1)[:, B:]
    return y.reshape(-1)[:T]
