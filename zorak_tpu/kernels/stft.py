"""STFT overlap-add processing on XLA FFT.

The data-parallel form of the reference catalog's Spectral-category pattern
(accumulate a block, fft_real, per-bin processing, ifft_real, overlap-add
— e.g. Sample.jsfx's FFT-512 decrust, PsychoConvolver's partitions): all
frames are processed AT ONCE as a batched FFT over [frames, fft_size],
instead of one FFT per @block.

Dtype policy: the whole pipeline is f32/c64.  The audio contract
compares f32-rounded samples at 1e-5, and an f64 framing/window/OLA path
would move twice the bytes for precision the contract cannot see.  No
stage is a matrix product, so no stage can fall to a reduced-precision
matmul mode.  The overlap-add and its window
normalization are built without scatters: frames split into size//hop
chunks accumulate via static shifted slice-adds, and the window-sum is
precomputed with numpy at trace time (it is input-independent).
"""
from __future__ import annotations

from functools import partial
from typing import Callable, Optional

import numpy as np

import jax
import jax.numpy as jnp

F32 = jnp.float32


def _n_frames(t: int, size: int, hop: int) -> int:
    return max(1, -(-max(t - size, 0) // hop) + 1)


def _frame(x: jnp.ndarray, size: int, hop: int) -> jnp.ndarray:
    """[T] -> [frames, size] with zero padding at the tail."""
    t = x.shape[-1]
    n_frames = _n_frames(t, size, hop)
    pad = (n_frames - 1) * hop + size - t
    xp = jnp.pad(x, [(0, pad)])
    idx = (jnp.arange(n_frames)[:, None] * hop
           + jnp.arange(size)[None, :])
    return xp[idx]


def stft(x: jnp.ndarray, size: int = 2048, hop: Optional[int] = None,
         window: Optional[jnp.ndarray] = None):
    """x: [T] real -> (spec [frames, size//2+1] complex64, meta)."""
    hop = hop or size // 2
    # the window stays NUMPY through meta: it is a trace-time constant,
    # and the OLA normalization needs its concrete values at trace time
    if window is None:
        window = np.hanning(size).astype(np.float32)
    else:
        window = np.asarray(window, np.float32)
    frames = _frame(x.astype(F32), size, hop) * window
    spec = jnp.fft.rfft(frames, axis=-1)
    return spec, (size, hop, window, x.shape[-1])


def _overlap_add(frames: jnp.ndarray, size: int, hop: int) -> jnp.ndarray:
    """[n_frames, size] -> [(n_frames-1)*hop + size] via shifted
    slice-adds (no scatter) when hop divides size; scatter fallback
    otherwise."""
    n_frames = frames.shape[0]
    total = (n_frames - 1) * hop + size
    if size % hop == 0:
        k = size // hop
        chunks = frames.reshape(n_frames, k, hop)
        acc = jnp.zeros((n_frames + k - 1, hop), dtype=frames.dtype)
        for r in range(k):
            acc = acc.at[r:r + n_frames].add(chunks[:, r, :])
        return acc.reshape(-1)[:total]
    idx = (jnp.arange(n_frames)[:, None] * hop + jnp.arange(size)[None, :])
    y = jnp.zeros(total, dtype=frames.dtype)
    return y.at[idx.reshape(-1)].add(frames.reshape(-1))


def _ola_window_norm(window: jnp.ndarray, n_frames: int, size: int,
                     hop: int) -> np.ndarray:
    """Input-independent analysis*synthesis window-power normalization,
    computed host-side at trace time (numpy) so it folds to a constant."""
    w2 = np.asarray(window, np.float64) ** 2
    total = (n_frames - 1) * hop + size
    wsum = np.zeros(total, np.float64)
    for f in range(n_frames):
        wsum[f * hop:f * hop + size] += w2
    return np.maximum(wsum, 1e-12).astype(np.float32)


def istft(spec: jnp.ndarray, meta) -> jnp.ndarray:
    size, hop, window, t_out = meta
    frames = jnp.fft.irfft(spec.astype(jnp.complex64), size,
                           axis=-1) * window
    n_frames = frames.shape[0]
    y = _overlap_add(frames, size, hop)
    y = y * (1.0 / jnp.asarray(
        _ola_window_norm(window, n_frames, size, hop)))
    return y[:t_out]


def stft_process(x: jnp.ndarray, bin_fn: Callable, size: int = 2048,
                 hop: Optional[int] = None) -> jnp.ndarray:
    """Spectral processing pipeline: stft -> bin_fn(spec) -> istft.

    bin_fn receives [frames, bins] complex and returns the same shape;
    vmap/jit composable (use jax.vmap for channels).
    """
    spec, meta = stft(x, size, hop)
    return istft(bin_fn(spec), meta)


@partial(jax.jit, static_argnames=("size", "hop", "floor_db"))
def spectral_gate(x: jnp.ndarray, threshold_db: float = -50.0,
                  size: int = 2048, hop: Optional[int] = None,
                  floor_db: float = -24.0) -> jnp.ndarray:
    """Reference-style restoration denoiser: per-bin gating against a
    noise floor with psychoacoustic-ish soft knee (BASELINE config 3)."""
    def gate(spec):
        mag = jnp.abs(spec)
        # broadband noise estimate: the median across bins of each bin's
        # quiet-frame level (stationary tones occupy few bins, so the
        # median tracks the noise bed, not the signal)
        per_bin_quiet = jnp.percentile(mag, 10.0, axis=0)
        noise_est = jnp.median(per_bin_quiet)
        thr = jnp.maximum(noise_est,
                          F32(10.0 ** (threshold_db / 20.0))) * 4.0
        over = mag / jnp.maximum(thr, 1e-12)
        gain = jnp.clip((over - 1.0) / 2.0, 0.0, 1.0)
        min_gain = F32(10.0 ** (floor_db / 20.0))
        g = min_gain + (1.0 - min_gain) * gain * gain * (3.0 - 2.0 * gain)
        # keep the spectrum c64: an f64 gain would promote it to c128
        return spec * g.astype(jnp.float32)

    return stft_process(x, gate, size, hop)
