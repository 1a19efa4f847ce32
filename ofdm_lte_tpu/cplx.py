"""Complex arithmetic as real pairs.

A complex tensor is a `C` NamedTuple of two float32 arrays (re, im) — an
explicit struct-of-arrays representation. This is a JAX pytree, so it flows
through jit / vmap / scan / shard_map unchanged, and every operation below
maps onto real elementwise work or real matmuls. (Whether complex64 and
jnp.fft serve the GPU better is ROADMAP design debt 3.2.)

Complex matmul is expanded into real matmuls. Two forms are provided: the
straightforward 4-multiply form (`matmul`, the default — fully parallel dots,
no extra elementwise traffic) and the 3-multiply Gauss/Karatsuba form
(`matmul_gauss`, −25% matmul FLOPs at the cost of two operand adds and a longer
dependency chain; selectable in the modem via OFDM_LTE_TPU_CMATMUL=gauss —
see ops/ofdm._cmm).

This module replaces NumPy complex arrays used throughout the reference
(e.g. /root/reference/core/modulator.py:78, core/channel.py:56-60).
"""
from __future__ import annotations

from typing import NamedTuple, Union

import numpy as np
import jax.numpy as jnp

Scalar = Union[int, float]


class C(NamedTuple):
    """A complex tensor as a (re, im) pair of same-shape real arrays."""

    re: jnp.ndarray
    im: jnp.ndarray

    # ---- structural ----
    @property
    def shape(self):
        return self.re.shape

    @property
    def ndim(self):
        return self.re.ndim

    @property
    def dtype(self):
        return self.re.dtype

    def __len__(self):
        return len(self.re)

    def __getitem__(self, idx) -> "C":
        return C(self.re[idx], self.im[idx])

    def reshape(self, *shape) -> "C":
        return C(self.re.reshape(*shape), self.im.reshape(*shape))

    def transpose(self, *axes) -> "C":
        return C(self.re.transpose(*axes), self.im.transpose(*axes))

    @property
    def T(self) -> "C":
        return C(self.re.T, self.im.T)

    def astype(self, dt) -> "C":
        return C(self.re.astype(dt), self.im.astype(dt))

    def flatten(self) -> "C":
        return C(self.re.flatten(), self.im.flatten())

    # ---- arithmetic ----
    def __add__(self, o) -> "C":
        if isinstance(o, C):
            return C(self.re + o.re, self.im + o.im)
        return C(self.re + o, self.im)

    def __radd__(self, o) -> "C":
        return self.__add__(o)

    def __sub__(self, o) -> "C":
        if isinstance(o, C):
            return C(self.re - o.re, self.im - o.im)
        return C(self.re - o, self.im)

    def __rsub__(self, o) -> "C":
        return C(o - self.re, -self.im)

    def __neg__(self) -> "C":
        return C(-self.re, -self.im)

    def __mul__(self, o) -> "C":
        if isinstance(o, C):
            return C(self.re * o.re - self.im * o.im,
                     self.re * o.im + self.im * o.re)
        return C(self.re * o, self.im * o)

    def __rmul__(self, o) -> "C":
        return self.__mul__(o)

    def __truediv__(self, o) -> "C":
        if isinstance(o, C):
            d = o.re * o.re + o.im * o.im
            return C((self.re * o.re + self.im * o.im) / d,
                     (self.im * o.re - self.re * o.im) / d)
        return C(self.re / o, self.im / o)

    def conj(self) -> "C":
        return C(self.re, -self.im)

    def abs2(self) -> jnp.ndarray:
        return self.re * self.re + self.im * self.im

    def abs(self) -> jnp.ndarray:
        return jnp.sqrt(self.abs2())

    def sum(self, axis=None, keepdims=False) -> "C":
        return C(self.re.sum(axis=axis, keepdims=keepdims),
                 self.im.sum(axis=axis, keepdims=keepdims))

    def mean(self, axis=None, keepdims=False) -> "C":
        return C(self.re.mean(axis=axis, keepdims=keepdims),
                 self.im.mean(axis=axis, keepdims=keepdims))

    # ---- interop ----
    def to_numpy(self) -> np.ndarray:
        return np.asarray(self.re) + 1j * np.asarray(self.im)


# ---------------------------------------------------------------------------
# constructors
# ---------------------------------------------------------------------------

def czeros(shape, dtype=jnp.float32) -> C:
    z = jnp.zeros(shape, dtype)
    return C(z, z)


def cones(shape, dtype=jnp.float32) -> C:
    return C(jnp.ones(shape, dtype), jnp.zeros(shape, dtype))


def from_numpy(x, dtype=jnp.float32) -> C:
    x = np.asarray(x)
    return C(jnp.asarray(x.real, dtype), jnp.asarray(x.imag, dtype))


def const(x, dtype=jnp.float32) -> C:
    """Embed a NumPy complex constant (computed at trace time) as a C pair."""
    return from_numpy(x, dtype)


def expi(theta: jnp.ndarray) -> C:
    """exp(i·theta) elementwise."""
    return C(jnp.cos(theta), jnp.sin(theta))


# ---------------------------------------------------------------------------
# linear algebra
# ---------------------------------------------------------------------------

def matmul(a: C, b: C, precision=None) -> C:
    """Complex matmul as 4 real matmuls. preferred_element_type=f32."""
    f32 = jnp.float32
    rr = jnp.matmul(a.re, b.re, precision=precision, preferred_element_type=f32)
    ii = jnp.matmul(a.im, b.im, precision=precision, preferred_element_type=f32)
    ri = jnp.matmul(a.re, b.im, precision=precision, preferred_element_type=f32)
    ir = jnp.matmul(a.im, b.re, precision=precision, preferred_element_type=f32)
    return C(rr - ii, ri + ir)


def matmul_gauss(a: C, b: C, precision=None) -> C:
    """Complex matmul in the 3-multiply Gauss/Karatsuba form:

        t1 = ar·br, t2 = ai·bi, t3 = (ar+ai)·(br+bi)
        C  = (t1 − t2) + j·(t3 − t1 − t2)

    One fewer real matmul than `matmul` (−25% FLOPs) in exchange for two
    operand-sized adds and three result-sized adds. Can win when the
    matmul is compute-bound (large K, HIGHEST-precision f32); numerically
    the imaginary part carries one extra rounding of magnitude ~|t1|+|t2|.
    When `b` is a trace-time constant (the modem's DFT matrices), XLA
    constant-folds br+bi so only the `a` add costs anything per call."""
    f32 = jnp.float32
    t1 = jnp.matmul(a.re, b.re, precision=precision, preferred_element_type=f32)
    t2 = jnp.matmul(a.im, b.im, precision=precision, preferred_element_type=f32)
    t3 = jnp.matmul(a.re + a.im, b.re + b.im, precision=precision,
                    preferred_element_type=f32)
    return C(t1 - t2, t3 - t1 - t2)


def matmul_rc(a_real: jnp.ndarray, b: C, precision=None) -> C:
    """Real @ complex."""
    f32 = jnp.float32
    return C(jnp.matmul(a_real, b.re, precision=precision, preferred_element_type=f32),
             jnp.matmul(a_real, b.im, precision=precision, preferred_element_type=f32))


def matmul_cr(a: C, b_real: jnp.ndarray, precision=None) -> C:
    """Complex @ real."""
    f32 = jnp.float32
    return C(jnp.matmul(a.re, b_real, precision=precision, preferred_element_type=f32),
             jnp.matmul(a.im, b_real, precision=precision, preferred_element_type=f32))


def matmul_small(a: C, b: C) -> C:
    """Batched complex matmul for TINY matrices (contraction dim ≤ ~8) as a
    broadcast-multiply-sum instead of a dot.

    a (..., M, K) @ b (..., K, N) -> (..., M, N). The MIMO stack's per-
    subcarrier matrices are 1x1..4x4 batched over millions of subcarriers;
    expanding the contraction as elementwise FMAs keeps them in fused
    elementwise kernels instead of millions of tiny batched dots. Leading
    batch dims broadcast."""
    ar, ai = a.re[..., :, :, None], a.im[..., :, :, None]   # (..., M, K, 1)
    br, bi = b.re[..., None, :, :], b.im[..., None, :, :]   # (..., 1, K, N)
    re = jnp.sum(ar * br - ai * bi, axis=-2)
    im = jnp.sum(ar * bi + ai * br, axis=-2)
    return C(re, im)


def einsum(spec: str, a: C, b: C) -> C:
    rr = jnp.einsum(spec, a.re, b.re)
    ii = jnp.einsum(spec, a.im, b.im)
    ri = jnp.einsum(spec, a.re, b.im)
    ir = jnp.einsum(spec, a.im, b.re)
    return C(rr - ii, ri + ir)


def vdot(a: C, b: C, axis=-1, keepdims=False) -> C:
    """Hermitian inner product sum(conj(a)·b) along axis."""
    return (a.conj() * b).sum(axis=axis, keepdims=keepdims)


def where(mask: jnp.ndarray, a: C, b: C) -> C:
    return C(jnp.where(mask, a.re, b.re), jnp.where(mask, a.im, b.im))


def stack(xs, axis=0) -> C:
    return C(jnp.stack([x.re for x in xs], axis=axis),
             jnp.stack([x.im for x in xs], axis=axis))


def concatenate(xs, axis=0) -> C:
    return C(jnp.concatenate([x.re for x in xs], axis=axis),
             jnp.concatenate([x.im for x in xs], axis=axis))


def pad(x: C, pad_width, **kw) -> C:
    return C(jnp.pad(x.re, pad_width, **kw), jnp.pad(x.im, pad_width, **kw))


def scatter_set(base: C, idx, values: C) -> C:
    return C(base.re.at[idx].set(values.re), base.im.at[idx].set(values.im))


def scatter_add(base: C, idx, values: C) -> C:
    return C(base.re.at[idx].add(values.re), base.im.at[idx].add(values.im))


def take(x: C, idx, axis=0) -> C:
    return C(jnp.take(x.re, idx, axis=axis), jnp.take(x.im, idx, axis=axis))


def _matvec(a: C, v: C) -> C:
    """(..., m, n) @ (..., n) -> (..., m) as elementwise FMAs (tiny dims)."""
    prod = a * C(v.re[..., None, :], v.im[..., None, :])
    return prod.sum(axis=-1)


def _solve2_mat(a: C, b: C) -> C:
    """Closed-form A⁻¹B for 2x2 A and (..., 2, k) B."""
    a11 = a[..., 0:1, 0:1]
    a12 = a[..., 0:1, 1:2]
    a21 = a[..., 1:2, 0:1]
    a22 = a[..., 1:2, 1:2]
    det = a11 * a22 - a12 * a21
    top = (a22 * b[..., 0:1, :] - a12 * b[..., 1:2, :]) / det
    bot = (a11 * b[..., 1:2, :] - a21 * b[..., 0:1, :]) / det
    return concatenate([top, bot], axis=-2)


def take_along(x: C, idx: jnp.ndarray, axis: int = -1) -> C:
    """Gather one element along `axis` per batch lane; squeezes that axis."""
    ex = jnp.expand_dims(idx, axis)
    return C(jnp.squeeze(jnp.take_along_axis(x.re, ex, axis=axis), axis),
             jnp.squeeze(jnp.take_along_axis(x.im, ex, axis=axis), axis))


def solve(a: C, b: C) -> C:
    """Solve A x = b for complex A, batched over leading dims.

    For the small systems the MIMO detectors produce (n ≤ 2) a closed-form
    inverse runs as elementwise work (no LU factorization, orders of
    magnitude faster for millions of tiny batched systems). Larger n falls
    back to the real 2N×2N block embedding
    [[Ar, -Ai], [Ai, Ar]] @ [xr; xi] = [br; bi] through jnp.linalg.solve.
    (Replaces np.linalg.inv at /root/reference/core/mimo_detector.py:162.)
    """
    n = a.shape[-1]
    if n == 1:
        if b.ndim == a.ndim - 1:           # vector rhs (..., 1)
            return b / C(a.re[..., 0, :], a.im[..., 0, :])
        return b / C(a.re[..., 0:1, 0:1], a.im[..., 0:1, 0:1])
    if n == 2 and b.ndim == a.ndim - 1:
        a11 = a[..., 0, 0]
        a12 = a[..., 0, 1]
        a21 = a[..., 1, 0]
        a22 = a[..., 1, 1]
        det = a11 * a22 - a12 * a21
        x0 = (a22 * b[..., 0] - a12 * b[..., 1]) / det
        x1 = (a11 * b[..., 1] - a21 * b[..., 0]) / det
        return C(jnp.stack([x0.re, x1.re], axis=-1),
                 jnp.stack([x0.im, x1.im], axis=-1))
    if n == 3 and b.ndim == a.ndim - 1:
        # pad to 4x4 block-diagonal [[A,0],[0,1]]: solution unchanged
        pad_a = pad(a, [(0, 0)] * (a.ndim - 2) + [(0, 1), (0, 1)])
        eye_fix = C(pad_a.re.at[..., 3, 3].set(1.0), pad_a.im)
        pad_b = pad(b, [(0, 0)] * (b.ndim - 1) + [(0, 1)])
        return solve(eye_fix, pad_b)[..., :3]
    if n == 4 and b.ndim == a.ndim - 1:
        # 2x2-blockwise Schur complement, all closed form, elementwise
        A = a[..., 0:2, 0:2]
        B = a[..., 0:2, 2:4]
        Cm = a[..., 2:4, 0:2]
        D = a[..., 2:4, 2:4]
        b1 = b[..., 0:2]
        b2 = b[..., 2:4]
        Ainv_b1 = solve(A, b1)
        Ainv_B = _solve2_mat(A, B)
        S = D - matmul(Cm, Ainv_B)
        rhs2 = b2 - _matvec(Cm, Ainv_b1)
        x2 = solve(S, rhs2)
        x1 = Ainv_b1 - _matvec(Ainv_B, x2)
        return concatenate([x1, x2], axis=-1)
    top = jnp.concatenate([a.re, -a.im], axis=-1)
    bot = jnp.concatenate([a.im, a.re], axis=-1)
    areal = jnp.concatenate([top, bot], axis=-2)          # (..., 2n, 2n)
    if b.ndim == a.ndim - 1:  # vector rhs
        breal = jnp.concatenate([b.re, b.im], axis=-1)    # (..., 2n)
        x = jnp.linalg.solve(areal, breal[..., None])[..., 0]
        return C(x[..., :n], x[..., n:])
    breal = jnp.concatenate([b.re, b.im], axis=-2)        # (..., 2n, k)
    x = jnp.linalg.solve(areal, breal)
    return C(x[..., :n, :], x[..., n:, :])
