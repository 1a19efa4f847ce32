"""MIMO detectors (MMSE/IRC, ZF, SIC, MRC), batched over subcarriers.

Replaces the per-subcarrier Python loop + np.linalg.inv of
/root/reference/core/mimo_detector.py (including the debug prints inside the
hot loop, lines 117-131) with batched complex solves:

- MMSE/IRC: ŝ = (HᴴH + σ²I)⁻¹ Hᴴ y          (mimo_detector.py:135-173)
- ZF:       ŝ = pinv(H) y = (HᴴH)⁻¹ Hᴴ y    (mimo_detector.py:175-198)
- SIC:      SINR-ordered MMSE + hard decision + cancellation against the
            ORIGINAL H                        (mimo_detector.py:200-306)
- MRC:      rank-1 ŝ = hᴴy/‖h‖²              (mimo_detector.py:352-369)

All matrices are (..., sc, rx, L); the (L×L) solves run batched through the
real 2L×2L block embedding (cplx.solve). SIC's shrinking active set is
realized by masking columns + unit diagonal padding (numerically identical to
deleting columns: the linear system block-diagonalizes).
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from .. import cplx
from ..cplx import C
from ..ops import qam


def _gram(H: C) -> C:
    """HᴴH for H (..., rx, L) -> (..., L, L).

    Elementwise path: these are (≤4×≤4) matrices batched over millions of
    subcarriers (see cplx.matmul_small)."""
    Hh = C(H.re.swapaxes(-1, -2), -H.im.swapaxes(-1, -2))
    return cplx.matmul_small(Hh, H)


def _Hh_y(H: C, y: C) -> C:
    """Hᴴy for H (..., rx, L), y (..., rx) -> (..., L)."""
    return (H.conj() * C(y.re[..., None], y.im[..., None])).sum(axis=-2)


def _add_diag(A: C, d) -> C:
    """A + d·I with real scalar (or per-lane) d broadcast over the batch."""
    L = A.shape[-1]
    eye = jnp.eye(L, dtype=A.re.dtype)
    d = jnp.asarray(d, A.re.dtype)
    if d.ndim:
        d = d[..., None, None]
    return C(A.re + eye * d, A.im)


def effective_channel(H: C, W: C) -> C:
    """H_eff = H @ W (mimo_detector.py:109-114). H (..., rx, tx),
    W (tx, L) or (..., tx, L) — leading dims broadcast (elementwise path)."""
    return cplx.matmul_small(H, W)


def _mmse2_fused(y: C, H_eff: C, s2) -> C:
    """Closed-form 2-layer MMSE with no matrix temporaries: G = HᴴH + σ²I
    is [[a, b], [b̄, d]] (a, d real), ŝ = G⁻¹Hᴴy via the 2×2 adjugate —
    direct scalar formulas on the h-column planes. Agrees with the generic
    gram+solve path to ~2e-6 (inside the 1e-4 reference-parity tolerance)
    and writes none of the gram/solve chain's (batch, 2, 2) temporaries to
    device memory."""
    h0 = C(H_eff.re[..., 0], H_eff.im[..., 0])      # (..., rx)
    h1 = C(H_eff.re[..., 1], H_eff.im[..., 1])
    if jnp.ndim(s2):
        s2 = s2.reshape(s2.shape + (1,) * (h0.re.ndim - 1 - jnp.ndim(s2)))
    a = h0.abs2().sum(-1) + s2
    d = h1.abs2().sum(-1) + s2
    b = (h0.conj() * h1).sum(-1)
    z0 = (h0.conj() * y).sum(-1)
    z1 = (h1.conj() * y).sum(-1)
    inv = 1.0 / (a * d - b.abs2())
    s0 = C((d * z0.re - (b.re * z1.re - b.im * z1.im)) * inv,
           (d * z0.im - (b.re * z1.im + b.im * z1.re)) * inv)
    s1 = C((a * z1.re - (b.re * z0.re + b.im * z0.im)) * inv,
           (a * z1.im - (b.re * z0.im - b.im * z0.re)) * inv)
    return C(jnp.stack([s0.re, s1.re], -1), jnp.stack([s0.im, s1.im], -1))


def mmse2_planes(y_planes, heff_planes, sigma2):
    """Fused closed-form 2-layer MMSE on per-(rx, layer) channel PLANES.

    y_planes: list over rx of C planes (..., S, m); heff_planes: nested
    [rx][layer] effective-channel planes of the same shape. Returns
    [s0, s1] layer planes. Same math as _mmse2_fused, but with the rx and
    layer axes unrolled as separate arrays every operand keeps the large
    subcarrier axis minor — no (..., rx, L) trailing-tiny-axis layouts,
    no moveaxis transposes, no strided column slices (the measured
    hotspots of the stacked detector layout at the spatial pipeline's
    batch shape; see VALIDATION.md spatial-stage table)."""
    s2 = jnp.asarray(sigma2, jnp.float32)
    nd = y_planes[0].re.ndim
    if s2.ndim and s2.ndim < nd:
        s2 = s2.reshape(s2.shape + (1,) * (nd - s2.ndim))

    def csum(terms):
        acc = None
        for t in terms:
            acc = t if acc is None else acc + t
        return acc

    a = sum(hp[0].abs2() for hp in heff_planes) + s2
    d = sum(hp[1].abs2() for hp in heff_planes) + s2
    b = csum(hp[0].conj() * hp[1] for hp in heff_planes)
    z0 = csum(hp[0].conj() * yr for hp, yr in zip(heff_planes, y_planes))
    z1 = csum(hp[1].conj() * yr for hp, yr in zip(heff_planes, y_planes))
    inv = 1.0 / (a * d - b.abs2())
    s0 = C((d * z0.re - (b.re * z1.re - b.im * z1.im)) * inv,
           (d * z0.im - (b.re * z1.im + b.im * z1.re)) * inv)
    s1 = C((a * z1.re - (b.re * z0.re + b.im * z0.im)) * inv,
           (a * z1.im - (b.re * z0.im - b.im * z0.re)) * inv)
    return [s0, s1]


def _m2_mul(a, b):
    """2x2 complex-plane matrix product: a, b are [[C,C],[C,C]] nests of
    same-shape planes."""
    return [[a[0][0] * b[0][0] + a[0][1] * b[1][0],
             a[0][0] * b[0][1] + a[0][1] * b[1][1]],
            [a[1][0] * b[0][0] + a[1][1] * b[1][0],
             a[1][0] * b[0][1] + a[1][1] * b[1][1]]]


def _m2_vec(a, v):
    """2x2 plane matrix @ 2-vector of planes."""
    return [a[0][0] * v[0] + a[0][1] * v[1],
            a[1][0] * v[0] + a[1][1] * v[1]]


def _m2_inv(a):
    """Closed-form 2x2 plane-matrix inverse (adjugate / det)."""
    det = a[0][0] * a[1][1] - a[0][1] * a[1][0]
    inv = C(det.re / det.abs2(), -det.im / det.abs2())
    return [[a[1][1] * inv, -1.0 * (a[0][1] * inv)],
            [-1.0 * (a[1][0] * inv), a[0][0] * inv]]


def _m2_herm(a):
    """Conjugate transpose of a 2x2 plane matrix."""
    return [[a[0][0].conj(), a[1][0].conj()],
            [a[0][1].conj(), a[1][1].conj()]]


def mmse4_planes(y_planes, heff_planes, sigma2):
    """Closed-form 4-layer MMSE on per-(rx, layer) channel PLANES via the
    2x2-block Schur complement — the plane counterpart of cplx.solve's
    n=4 path, with every operand a full (..., S, m) array (subcarrier
    axis minor) instead of a (..., 4, 4) trailing-tiny layout.

    y_planes: list over rx of C planes; heff_planes: [rx][4] planes.
    Returns [s0..s3] layer planes. G = HᴴH + σ²I = [[A, B], [Bᴴ, D]],
    ŝ = G⁻¹Hᴴy with S = D − BᴴA⁻¹B."""
    L = 4
    s2 = jnp.asarray(sigma2, jnp.float32)
    nd = y_planes[0].re.ndim
    if s2.ndim and s2.ndim < nd:
        s2 = s2.reshape(s2.shape + (1,) * (nd - s2.ndim))

    def csum(terms):
        acc = None
        for t in terms:
            acc = t if acc is None else acc + t
        return acc

    def gram(i, j):
        g = csum(hp[i].conj() * hp[j] for hp in heff_planes)
        if i == j:
            g = C(g.re + s2, g.im)
        return g

    z = [csum(hp[i].conj() * yr for hp, yr in zip(heff_planes, y_planes))
         for i in range(L)]
    A = [[gram(0, 0), gram(0, 1)], [gram(1, 0), gram(1, 1)]]
    B = [[gram(0, 2), gram(0, 3)], [gram(1, 2), gram(1, 3)]]
    D = [[gram(2, 2), gram(2, 3)], [gram(3, 2), gram(3, 3)]]

    Ainv = _m2_inv(A)
    Bh = _m2_herm(B)
    BhAinv = _m2_mul(Bh, Ainv)
    BhAinvB = _m2_mul(BhAinv, B)
    S = [[D[i][j] - BhAinvB[i][j] for j in range(2)] for i in range(2)]
    rhs2 = [z[2] - _m2_vec(BhAinv, z[:2])[0],
            z[3] - _m2_vec(BhAinv, z[:2])[1]]
    s_lo = _m2_vec(_m2_inv(S), rhs2)
    rhs1 = [z[0] - _m2_vec(B, s_lo)[0], z[1] - _m2_vec(B, s_lo)[1]]
    s_hi = _m2_vec(Ainv, rhs1)
    return [s_hi[0], s_hi[1], s_lo[0], s_lo[1]]


def _plane_zeros_like(p: C) -> C:
    z = jnp.zeros_like(p.re)
    return C(z, z)


def _csum(terms):
    acc = None
    for t in terms:
        acc = t if acc is None else acc + t
    return acc


def _align_sigma_planes(sigma2, ref_plane: C):
    """Right-pad a scalar/per-lane σ² with singleton axes so it broadcasts
    against a (..., S, m) plane."""
    s2 = jnp.asarray(sigma2, jnp.float32)
    nd = ref_plane.re.ndim
    if s2.ndim and s2.ndim < nd:
        s2 = s2.reshape(s2.shape + (1,) * (nd - s2.ndim))
    return s2


def _solve2_planes(G, z):
    """Closed-form 2x2 plane-system solve: G [2][2] nest of C planes
    (general, not necessarily Hermitian), z [2] planes."""
    det = G[0][0] * G[1][1] - G[0][1] * G[1][0]
    inv = C(det.re / det.abs2(), -det.im / det.abs2())
    return [(G[1][1] * z[0] - G[0][1] * z[1]) * inv,
            (G[0][0] * z[1] - G[1][0] * z[0]) * inv]


def _solve4_planes(G, z):
    """4x4 plane-system solve via the 2x2-block Schur complement — the
    plane counterpart of cplx.solve's n=4 path (every operand a full
    (..., S, m) array, subcarrier axis minor)."""
    A = [[G[0][0], G[0][1]], [G[1][0], G[1][1]]]
    B = [[G[0][2], G[0][3]], [G[1][2], G[1][3]]]
    Cm = [[G[2][0], G[2][1]], [G[3][0], G[3][1]]]
    D = [[G[2][2], G[2][3]], [G[3][2], G[3][3]]]
    Ainv = _m2_inv(A)
    Ainv_b1 = _m2_vec(Ainv, z[:2])
    AinvB = _m2_mul(Ainv, B)
    S = [[D[i][j] - (Cm[i][0] * AinvB[0][j] + Cm[i][1] * AinvB[1][j])
          for j in range(2)] for i in range(2)]
    rhs2 = [z[2] - _m2_vec(Cm, Ainv_b1)[0],
            z[3] - _m2_vec(Cm, Ainv_b1)[1]]
    x2 = _solve2_planes(S, rhs2)
    x1 = [Ainv_b1[0] - (AinvB[0][0] * x2[0] + AinvB[0][1] * x2[1]),
          Ainv_b1[1] - (AinvB[1][0] * x2[0] + AinvB[1][1] * x2[1])]
    return [x1[0], x1[1], x2[0], x2[1]]


def _solve_planes(G, z):
    """Dispatch a plane-system solve for L in {1, 2, 3, 4}. L=3 pads to
    the 4x4 Schur path with a decoupled unit 4th equation (the plane
    counterpart of cplx.solve's n=3 padding)."""
    L = len(z)
    if L == 1:
        d = G[0][0]
        inv = C(d.re / d.abs2(), -d.im / d.abs2())
        return [z[0] * inv]
    if L == 2:
        return _solve2_planes(G, z)
    if L == 3:
        zero = _plane_zeros_like(z[0])
        one = C(jnp.ones_like(zero.re), zero.im)
        G4 = [[G[i][j] if (i < 3 and j < 3) else
               (one if i == j else zero) for j in range(4)]
              for i in range(4)]
        return _solve4_planes(G4, z + [zero])[:3]
    if L == 4:
        return _solve4_planes(G, z)
    raise ValueError(f"plane solve supports L<=4, got {L}")


def mmse_planes(y_planes, heff_planes, sigma2):
    """General plane MMSE for L in {1, 2, 3, 4} layers: dispatches to the
    fused 2-layer (mmse2_planes) / block-Schur 4-layer (mmse4_planes)
    kernels and closes the rank-1/rank-3 gaps with the same plane layout
    (VERDICT r4 task 4: rank 3 previously fell through to the stacked
    trailing-(rx, L) detector shown 5.3x slower at rank 4)."""
    L = len(heff_planes[0])
    if L == 2:
        return mmse2_planes(y_planes, heff_planes, sigma2)
    if L == 4:
        return mmse4_planes(y_planes, heff_planes, sigma2)
    s2 = _align_sigma_planes(sigma2, y_planes[0])

    def gram(i, j):
        g = _csum(hp[i].conj() * hp[j] for hp in heff_planes)
        if i == j:
            g = C(g.re + s2, g.im)
        return g

    G = [[gram(i, j) for j in range(L)] for i in range(L)]
    z = [_csum(hp[i].conj() * yr for hp, yr in zip(heff_planes, y_planes))
         for i in range(L)]
    return _solve_planes(G, z)


def sic_planes(y_planes, heff_planes, sigma2, modulation: str):
    """SIC on per-(rx, layer) channel PLANES — semantics identical to
    `sic` (mimo_detector.py:200-306: SINR order from the ORIGINAL columns,
    per-stage MMSE over the remaining set, hard decision, cancellation
    against the original H) but with every operand a full (..., S, m)
    plane. The per-stage masked MMSE reuses the 2x2-block Schur plane
    solver with the inactive columns' Gram rows/cols zeroed and their
    diagonal padded to σ²+1, exactly as the stacked path masks Hm.

    Two plane-specific algebraic shortcuts (identical math, fewer passes):
    - the masked Gram is the ORIGINAL Gram scaled by a_i·a_j — the base
      Gram planes are computed once and re-masked per stage;
    - the residual's matched filter updates in the Gram domain:
      z_i ← z_i − ŝ_hard·g_base[i][sel] (= Hᴴ(y − h_sel·ŝ_hard)), so the
      rx planes are never re-read after the initial z.
    """
    L = len(heff_planes[0])
    s2 = _align_sigma_planes(sigma2, y_planes[0])

    # base Gram (no σ², no masks) + matched filter, both stage-invariant
    g_base = [[None] * L for _ in range(L)]
    for i in range(L):
        for j in range(i, L):
            g = _csum(hp[i].conj() * hp[j] for hp in heff_planes)
            g_base[i][j] = g
            if j != i:
                g_base[j][i] = g.conj()
    z = [_csum(hp[i].conj() * yr for hp, yr in zip(heff_planes, y_planes))
         for i in range(L)]

    colp = [g_base[l][l].re for l in range(L)]
    total = _csum(colp)
    sinr = [colp[l] / (total - colp[l] + s2 + 1e-10) for l in range(L)]

    active = [jnp.ones_like(colp[0]) for _ in range(L)]
    s_hat = [_plane_zeros_like(y_planes[0]) for _ in range(L)]

    for _ in range(L):
        # stage layer = argmax of the ORIGINAL SINR among active columns
        # (iterated masked argmax == stable argsort(-sinr) order)
        masked = jnp.stack(
            [jnp.where(active[l] > 0, sinr[l], -jnp.inf) for l in range(L)],
            axis=-1)
        sel_idx = jnp.argmax(masked, axis=-1)
        sel = [(sel_idx == l).astype(jnp.float32) for l in range(L)]

        G = [[C(g_base[i][j].re * (active[i] * active[j]),
                g_base[i][j].im * (active[i] * active[j]))
              for j in range(L)] for i in range(L)]
        for i in range(L):
            G[i][i] = C(G[i][i].re + s2 + (1.0 - active[i]), G[i][i].im)
        zm = [C(z[i].re * active[i], z[i].im * active[i]) for i in range(L)]
        s_all = _solve_planes(G, zm)

        s_sel = _csum(C(s_all[l].re * sel[l], s_all[l].im * sel[l])
                      for l in range(L))
        s_hard = qam.detect(s_sel, modulation)

        for l in range(L):
            pick = sel[l] > 0
            s_hat[l] = C(jnp.where(pick, s_hard.re, s_hat[l].re),
                         jnp.where(pick, s_hard.im, s_hat[l].im))
        # cancel in the Gram domain against the ORIGINAL columns
        for i in range(L):
            gsel = _csum(C(g_base[i][l2].re * sel[l2],
                           g_base[i][l2].im * sel[l2]) for l2 in range(L))
            z[i] = z[i] - gsel * s_hard
        active = [active[l] * (1.0 - sel[l]) for l in range(L)]

    return s_hat


def mmse(y: C, H_eff: C, sigma2) -> C:
    """y (..., rx), H_eff (..., rx, L) -> ŝ (..., L)."""
    s2 = _align_sigma(sigma2, H_eff)
    if H_eff.shape[-1] == 2:
        return _mmse2_fused(y, H_eff, s2)
    G = _add_diag(_gram(H_eff), s2)
    return cplx.solve(G, _Hh_y(H_eff, y))


def zf(y: C, H_eff: C, regularization: float = 1e-9) -> C:
    G = _add_diag(_gram(H_eff), regularization)
    return cplx.solve(G, _Hh_y(H_eff, y))


def mmse_unbiased(y: C, H_eff: C, sigma2) -> C:
    """Unbiased MMSE: the reference's MMSE ŝ = (HᴴH+σ²I)⁻¹Hᴴy is BIASED —
    E[ŝ|s] = (G+σ²I)⁻¹G·s shrinks/mixes layers — and the chain hard-decides
    without compensation (mimo_detector.py:135-173), so biased MMSE can
    lose to ZF on hard decisions despite its SINR advantage. Dividing each
    layer by its bias b_i = 1 − σ²·[(G+σ²I)⁻¹]_ii restores E[ŝ_i|s] ≈ s_i
    while keeping the MMSE interference suppression; with the bias removed
    the textbook post-SINR ordering MMSE ≥ ZF translates into error-rate
    ordering. CAPABILITY EXTENSION (PARITY.md) — the reference ships only
    the biased form, preserved as detector_type="MMSE"."""
    L = H_eff.shape[-1]
    s2 = _align_sigma(sigma2, H_eff)
    G = _add_diag(_gram(H_eff), s2)
    s_hat = cplx.solve(G, _Hh_y(H_eff, y))
    # diag of (G+σ²I)⁻¹ via L unit-vector solves (L ≤ 4, closed form);
    # Hermitian PD => diagonal is real positive
    batch = H_eff.shape[:-2]
    d = []
    for i in range(L):
        e = jnp.zeros(batch + (L,), jnp.float32).at[..., i].set(1.0)
        x = cplx.solve(G, C(e, jnp.zeros_like(e)))
        d.append(x.re[..., i])
    dinv = jnp.stack(d, axis=-1)                       # (..., L)
    s2b = s2[..., None] if jnp.ndim(s2) else s2
    b = jnp.maximum(1.0 - s2b * dinv, 1e-6)            # bias per layer
    return C(s_hat.re / b, s_hat.im / b)


def mrc(y: C, H_eff: C) -> C:
    """Rank-1 only: H_eff (..., rx, 1)."""
    h = H_eff[..., 0]
    num = (h.conj() * y).sum(axis=-1)
    den = h.abs2().sum(axis=-1)
    s = C(num.re / den, num.im / den)
    return C(s.re[..., None], s.im[..., None])


def _align_sigma(sigma2, H_eff: C):
    """Left-align a scalar or per-lane σ² against H_eff's batch dims so it
    broadcasts correctly under appended matrix axes."""
    s = jnp.asarray(sigma2, jnp.float32)
    batch_rank = H_eff.ndim - 2
    if s.ndim and s.ndim < batch_rank:
        s = s.reshape(s.shape + (1,) * (batch_rank - s.ndim))
    return s


def sic(y: C, H_eff: C, sigma2, modulation: str) -> C:
    """Successive interference cancellation with hard decisions.

    Ordering: per-subcarrier SINR_i = ‖h_i‖²/(Σ_{j≠i}‖h_j‖² + σ²), strongest
    first (mimo_detector.py:328-350); each stage MMSE-detects the chosen
    layer over the REMAINING set, hard-decides against the constellation, and
    subtracts h_layer·ŝ_hard from the residual using the original H
    (mimo_detector.py:284-293).
    """
    L = H_eff.shape[-1]
    sigma2 = _align_sigma(sigma2, H_eff)
    sigma2_l = sigma2[..., None] if jnp.ndim(sigma2) else sigma2
    col_power = H_eff.abs2().sum(axis=-2)                     # (..., L)
    total = col_power.sum(axis=-1, keepdims=True)
    sinr = col_power / (total - col_power + sigma2_l + 1e-10)
    order = jnp.argsort(-sinr, axis=-1)                       # (..., L)

    y_res = y
    active = jnp.ones(H_eff.shape[:-2] + (L,), jnp.float32)
    s_hat_re = jnp.zeros(H_eff.shape[:-2] + (L,), jnp.float32)
    s_hat_im = jnp.zeros_like(s_hat_re)

    for it in range(L):
        layer = order[..., it]                                # (...,)
        # mask inactive columns of H, pad their Gram diagonal with 1
        Hm = C(H_eff.re * active[..., None, :],
               H_eff.im * active[..., None, :])
        G = _gram(Hm)
        eye = jnp.eye(L, dtype=G.re.dtype)
        s_mat = sigma2[..., None, None] if jnp.ndim(sigma2) else sigma2
        G = C(G.re + eye * s_mat + eye * (1.0 - active[..., None, :]), G.im)
        s_all = cplx.solve(G, _Hh_y(Hm, y_res))               # (..., L)
        s_l = cplx.take_along(s_all, layer)
        s_hard = qam.detect(s_l, modulation)

        s_hat_re = jnp.where(
            jax.nn.one_hot(layer, L, dtype=bool), s_hard.re[..., None],
            s_hat_re)
        s_hat_im = jnp.where(
            jax.nn.one_hot(layer, L, dtype=bool), s_hard.im[..., None],
            s_hat_im)

        # cancel against the ORIGINAL H
        h_layer = cplx.take_along(
            H_eff, jnp.broadcast_to(layer[..., None], H_eff.shape[:-1]))
        contrib = h_layer * C(s_hard.re[..., None], s_hard.im[..., None])
        y_res = y_res - contrib
        active = active * (1.0 - jax.nn.one_hot(layer, L, dtype=jnp.float32))

    return C(s_hat_re, s_hat_im)


def detect(y: C, H: C, sigma2, detector_type: str = "MMSE", W: C = None,
           modulation: str = None) -> C:
    """Dispatch like MIMODetector.detect (mimo_detector.py:55-133).

    y (..., rx), H (..., rx, tx); W optional (tx, L) / C. Returns (..., L).
    """
    H_eff = cplx.matmul_small(H, W) if W is not None else H
    dt = detector_type.upper()
    if dt in ("MMSE", "IRC"):
        return mmse(y, H_eff, sigma2)
    if dt in ("MMSE-U", "MMSE_UNBIASED"):
        return mmse_unbiased(y, H_eff, sigma2)
    if dt == "ZF":
        return zf(y, H_eff)
    if dt == "SIC":
        if modulation is None:
            return mmse(y, H_eff, sigma2)  # reference falls back to MMSE
        return sic(y, H_eff, sigma2, modulation)
    if dt == "MRC":
        if H_eff.shape[-1] != 1:
            raise ValueError("MRC only supports num_layers=1")
        return mrc(y, H_eff)
    raise ValueError(f"Detector '{detector_type}' not supported")
