"""EEL2 numeric semantics on jnp time-series (the vector counterpart of
semantics/scalar.py — keep the two in lockstep).

All values are f64 arrays; int ops truncate toward zero to i64, wrap to
i32, and return f64.  Comparisons are ordered (NaN -> 0.0) and produce
1.0/0.0.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

F64 = jnp.float64
I32 = jnp.int32
I64 = jnp.int64


def to_i64(x):
    # fptosi-style trunc toward zero; NaN/inf are UB upstream, clamp here
    return jnp.trunc(x).astype(I64)


def to_i32(x):
    return to_i64(x).astype(I32)  # wraps mod 2^32


def from_i(x):
    return x.astype(F64)


def eel_or(a, b):
    return from_i(to_i32(a) | to_i32(b))


def eel_and(a, b):
    return from_i(to_i32(a) & to_i32(b))


def eel_xor(a, b):
    return from_i(to_i32(a) ^ to_i32(b))


def eel_shl(a, b):
    return from_i(to_i32(a) << (to_i32(b) & 31))


def eel_shr(a, b):
    return from_i(to_i32(a) >> (to_i32(b) & 31))  # arithmetic on int32


def eel_mod(a, b):
    li, ri = to_i32(a), to_i32(b)
    mag = jnp.where(ri == 0, jnp.zeros_like(li), jnp.abs(li) % jnp.maximum(jnp.abs(ri), 1))
    return from_i(jnp.where(li < 0, -mag, mag))


def eel_div(a, b):
    return a / b  # IEEE: inf/NaN, never raises


def eel_pow(a, b):
    # XLA pow follows C pow edge cases (neg base frac exp -> NaN, etc.)
    return jnp.power(a, b)


def _bool_to_f(c):
    return c.astype(F64)


def cmp_lt(a, b):
    return _bool_to_f(a < b)


def cmp_le(a, b):
    return _bool_to_f(a <= b)


def cmp_gt(a, b):
    return _bool_to_f(a > b)


def cmp_ge(a, b):
    return _bool_to_f(a >= b)


def cmp_eq(a, b):
    return _bool_to_f(a == b)


def cmp_ne(a, b):
    # ordered: NaN present -> 0
    return _bool_to_f((a == a) & (b == b) & (a != b))


def truthy_mask(x):
    return (x < 0.0) | (x > 0.0)  # NaN falsy


def eel_not(x):
    return _bool_to_f(x == 0.0)


def eel_select(c, a, b):
    return jnp.where(truthy_mask(c), a, b)


def eel_min(a, b):
    return jnp.where(a < b, a, b)  # NaN -> b, matching scalar select


def eel_max(a, b):
    return jnp.where(a > b, a, b)


def eel_sign(a):
    return jnp.where(a > 0.0, 1.0, jnp.where(a < 0.0, -1.0, 0.0))


def eel_invsqrt(x):
    x32 = x.astype(jnp.float32)
    bits = lax.bitcast_convert_type(x32, I32)
    approx = jnp.int32(0x5F3759DF) - (bits >> 1)
    y0 = lax.bitcast_convert_type(approx, jnp.float32).astype(F64)
    return y0 * (1.5 - 0.5 * x * y0 * y0)


UNARY = {
    "sin": jnp.sin, "cos": jnp.cos, "tan": jnp.tan,
    "asin": jnp.arcsin, "acos": jnp.arccos, "atan": jnp.arctan,
    "exp": jnp.exp, "log": jnp.log, "log10": jnp.log10,
    "sqrt": jnp.sqrt, "abs": jnp.abs, "fabs": jnp.abs,
    "floor": jnp.floor, "ceil": jnp.ceil, "invsqrt": eel_invsqrt,
    "not": eel_not, "sign": eel_sign,
}

BINARY = {
    "+": lambda a, b: a + b,
    "-": lambda a, b: a - b,
    "*": lambda a, b: a * b,
    "/": eel_div,
    "^": eel_pow,
    "%": eel_mod,
    "|": eel_or,
    "&": eel_and,
    "~": eel_xor,
    "<<": eel_shl,
    ">>": eel_shr,
    "<": cmp_lt, "<=": cmp_le, ">": cmp_gt, ">=": cmp_ge,
    "==": cmp_eq, "!=": cmp_ne,
    "min": eel_min, "max": eel_max,
    "atan2": jnp.arctan2, "pow": eel_pow,
}


def linrec_assoc_scan(a, b, z0):
    """Solve z_t = a_t * z_{t-1} + b_t (z_{-1} = z0) in O(log N) stages.

    a may be a scalar (broadcast) or a length-N array; b is length-N.
    Returns the length-N stream of z_t.

    Lowered as a Hillis-Steele doubling scan rather than
    `lax.associative_scan`: the recursive odd/even scheme emits ~2*log2(N)
    slice+concat stages per channel, while doubling emits exactly
    ceil(log2(N)) pad+fma stages — and when `a` is a compile-time scalar
    the prefix-product channel collapses to one host-squared weight per
    stage, so the whole recurrence is log2(N) single-array FMAs: about
    half the stages of the odd/even scheme, each on one channel instead
    of two, which matters when many small stages run inside a segment
    scan.

    z0 is folded into b[0] (b0' = b0 + a0*z0, identical op order to the
    sequential golden's first step), so no separate A*z0 term is needed.
    """
    b = jnp.asarray(b, F64)
    n = b.shape[0]
    if n == 0:
        return b
    a_scalar = jnp.ndim(a) == 0

    if a_scalar:
        a = jnp.asarray(a, F64)
        b = b.at[0].add(a * z0)
        s = 1
        w = a
        while s < n:
            shifted = jnp.concatenate([jnp.zeros((s,), F64), b[:-s]])
            b = b + w * shifted
            w = w * w
            s <<= 1
        return b

    a = jnp.asarray(a, F64)
    b = b.at[0].add(a[0] * z0)
    A = a
    s = 1
    one = jnp.ones((), F64)
    while s < n:
        A_sh = jnp.concatenate([jnp.full((s,), one), A[:-s]])
        b_sh = jnp.concatenate([jnp.zeros((s,), F64), b[:-s]])
        b = b + A * b_sh
        A = A * A_sh
        s <<= 1
    return b


def linrec_doubling_scalar_batch(a_vec, B, z0_vec):
    """Batched constant-coefficient linear recurrences: row i solves
    z_t = a_vec[i] * z_{t-1} + B[i, t] with z_{-1} = z0_vec[i].

    One doubling-scan ladder serves every row — k independent
    recurrences cost the same ceil(log2(L)) stages as one (the
    stage-launch-bound regime of a segment scan body makes stage COUNT,
    not element count, the dominant cost).  Per-row op order is
    identical to linrec_assoc_scan's scalar path.
    """
    k, n = B.shape
    if n == 0 or k == 0:
        return B
    a_vec = jnp.asarray(a_vec, F64)
    B = B.at[:, 0].add(a_vec * jnp.asarray(z0_vec, F64))
    w = a_vec
    s = 1
    while s < n:
        shifted = jnp.concatenate(
            [jnp.zeros((k, s), F64), B[:, :-s]], axis=1)
        B = B + w[:, None] * shifted
        w = w * w
        s <<= 1
    return B


def linrec_doubling_vector_batch(A, B, z0_vec):
    """Batched varying-coefficient linear recurrences: row i solves
    z_t = A[i, t] * z_{t-1} + B[i, t] with z_{-1} = z0_vec[i]."""
    k, n = B.shape
    if n == 0 or k == 0:
        return B
    A = jnp.asarray(A, F64)
    B = B.at[:, 0].add(A[:, 0] * jnp.asarray(z0_vec, F64))
    s = 1
    one = jnp.ones((), F64)
    while s < n:
        A_sh = jnp.concatenate([jnp.full((k, s), one), A[:, :-s]], axis=1)
        B_sh = jnp.concatenate([jnp.zeros((k, s), F64), B[:, :-s]], axis=1)
        B = B + A * B_sh
        A = A * A_sh
        s <<= 1
    return B
