"""LTE rate-1/3 turbo codec (TS 36.212 §5.1.3): QPP interleaver, scan-based
RSC encoders, batched max-log BCJR decoding.

Batched reformulation of /root/reference/core/channel_coding/
turbo_encoder.py and turbo_decoder.py:

- QPP permutation π(i) = (f1·i + f2·i²) mod K with the full 188-entry (f1,f2)
  table (turbo_encoder.py:34-73) — precomputed gather indices.
- RSC constituent encoders g0=013 (feedback), g1=015 (feedforward), 8 states,
  with the reference's convention that the SYSTEMATIC OUTPUT IS THE FEEDBACK
  BIT, not the input (turbo_encoder.py:174-189 — a spec deviation the decoder
  trellis matches, so it is preserved for parity). Encoding runs as one
  lax.scan over K with an arbitrary leading batch of code blocks.
- Decoder: max-log BCJR (the reference's default USE_MAX_LOG_MAP=True,
  turbo_decoder.py:33). The α/β recursions — triple-nested Python loops over
  (K × 8 states × 2 inputs) in the reference (turbo_decoder.py:227-245) —
  become two lax.scans whose per-step body is vectorized over
  (batch, 8 states, 2 inputs); γ is one fused elementwise computation of
  shape (batch, K, 8, 2). Tail-bit handling (K+3 extension per constituent
  decoder) follows turbo_decoder.py:379-438 exactly.
"""
from __future__ import annotations

import functools
from typing import Tuple, Optional

import numpy as np
import jax
import jax.numpy as jnp

# QPP interleaver parameters (TS 36.212 Table 5.1.3-3): K -> (f1, f2).
# Identical to turbo_encoder.py:34-73.
QPP_PARAMS = {
    40: (3, 10), 48: (7, 12), 56: (19, 42), 64: (7, 16), 72: (7, 18),
    80: (11, 20), 88: (5, 22), 96: (11, 24), 104: (7, 26), 112: (41, 84),
    120: (103, 90), 128: (15, 32), 136: (9, 34), 144: (17, 108), 152: (9, 38),
    160: (21, 120), 168: (101, 84), 176: (21, 44), 184: (57, 46), 192: (23, 48),
    200: (13, 50), 208: (27, 52), 216: (11, 36), 224: (27, 56), 232: (85, 58),
    240: (29, 60), 248: (33, 62), 256: (15, 32), 264: (17, 198), 272: (33, 68),
    280: (103, 210), 288: (19, 36), 296: (19, 74), 304: (37, 76), 312: (19, 78),
    320: (21, 120), 328: (21, 82), 336: (115, 84), 344: (193, 86), 352: (21, 44),
    360: (133, 90), 368: (81, 46), 376: (45, 94), 384: (23, 48), 392: (243, 98),
    400: (151, 40), 408: (155, 102), 416: (25, 52), 424: (51, 106), 432: (47, 72),
    440: (91, 110), 448: (29, 168), 456: (29, 114), 464: (247, 58), 472: (29, 118),
    480: (89, 180), 488: (91, 122), 496: (157, 62), 504: (55, 84), 512: (31, 64),
    528: (17, 66), 544: (35, 68), 560: (227, 420), 576: (65, 96), 592: (19, 74),
    608: (37, 76), 624: (41, 234), 640: (39, 80), 656: (185, 82), 672: (43, 252),
    688: (21, 86), 704: (155, 44), 720: (79, 120), 736: (139, 92), 752: (23, 94),
    768: (217, 48), 784: (25, 98), 800: (17, 80), 816: (127, 102), 832: (25, 52),
    848: (239, 106), 864: (17, 48), 880: (137, 110), 896: (215, 112), 912: (29, 114),
    928: (15, 58), 944: (147, 118), 960: (29, 60), 976: (59, 122), 992: (65, 124),
    1008: (55, 84), 1024: (31, 64), 1056: (17, 66), 1088: (171, 204),
    1120: (67, 140), 1152: (35, 72), 1184: (19, 74), 1216: (39, 76),
    1248: (19, 78), 1280: (199, 240), 1312: (21, 82), 1344: (211, 252),
    1376: (21, 86), 1408: (43, 88), 1440: (149, 60), 1472: (45, 92),
    1504: (49, 846), 1536: (71, 48), 1568: (13, 28), 1600: (17, 80),
    1632: (25, 102), 1664: (183, 104), 1696: (55, 954), 1728: (127, 96),
    1760: (27, 110), 1792: (29, 112), 1824: (29, 114), 1856: (57, 116),
    1888: (45, 354), 1920: (31, 120), 1952: (59, 610), 1984: (185, 124),
    2016: (113, 420), 2048: (31, 64), 2112: (17, 66), 2176: (171, 136),
    2240: (209, 420), 2304: (253, 216), 2368: (367, 444), 2432: (265, 456),
    2496: (181, 468), 2560: (39, 80), 2624: (27, 164), 2688: (127, 504),
    2752: (143, 172), 2816: (43, 88), 2880: (29, 300), 2944: (45, 92),
    3008: (157, 188), 3072: (47, 96), 3136: (13, 28), 3200: (111, 240),
    3264: (443, 204), 3328: (51, 104), 3392: (51, 212), 3456: (451, 192),
    3520: (257, 220), 3584: (57, 336), 3648: (313, 228), 3712: (271, 232),
    3776: (179, 236), 3840: (331, 120), 3904: (363, 244), 3968: (375, 248),
    4032: (127, 168), 4096: (31, 64), 4160: (33, 130), 4224: (43, 264),
    4288: (33, 134), 4352: (477, 408), 4416: (35, 138), 4480: (233, 280),
    4544: (357, 142), 4608: (337, 480), 4672: (37, 146), 4736: (71, 444),
    4800: (71, 120), 4864: (37, 152), 4928: (39, 462), 4992: (127, 234),
    5056: (39, 158), 5120: (39, 80), 5184: (31, 96), 5248: (113, 902),
    5312: (41, 166), 5376: (251, 336), 5440: (43, 170), 5504: (21, 86),
    5568: (43, 174), 5632: (45, 176), 5696: (45, 178), 5760: (161, 120),
    5824: (89, 182), 5888: (323, 184), 5952: (47, 186), 6016: (23, 94),
    6080: (47, 190), 6144: (263, 480),
}


@functools.lru_cache(maxsize=None)
def qpp_indices(K: int) -> np.ndarray:
    """π such that interleaved[i] = x[π(i)], π(i) = (f1·i + f2·i²) mod K."""
    if K not in QPP_PARAMS:
        raise ValueError(f"Invalid interleaver size K={K}")
    f1, f2 = QPP_PARAMS[K]
    i = np.arange(K, dtype=np.int64)
    return ((f1 * i + f2 * i * i) % K).astype(np.int32)


@functools.lru_cache(maxsize=None)
def qpp_inverse_indices(K: int) -> np.ndarray:
    perm = qpp_indices(K)
    inv = np.zeros(K, np.int32)
    inv[perm] = np.arange(K, dtype=np.int32)
    return inv


def qpp_interleave(x: jnp.ndarray, K: int) -> jnp.ndarray:
    return jnp.take(x, jnp.asarray(qpp_indices(K)), axis=-1)


def qpp_deinterleave(x: jnp.ndarray, K: int) -> jnp.ndarray:
    return jnp.take(x, jnp.asarray(qpp_inverse_indices(K)), axis=-1)


# ---------------------------------------------------------------------------
# Trellis (matches the reference encoder bit-for-bit)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def trellis_tables():
    """next_state (8,2), out_sys (8,2), out_par (8,2); state packed as
    (s0<<2)|(s1<<1)|s2 with s0 most recent (turbo_decoder.py:137-179)."""
    next_state = np.zeros((8, 2), np.int32)
    out_sys = np.zeros((8, 2), np.int32)
    out_par = np.zeros((8, 2), np.int32)
    for state in range(8):
        s0, s1, s2 = (state >> 2) & 1, (state >> 1) & 1, state & 1
        for bit in range(2):
            fb = (bit + s1 + s2) % 2
            out_sys[state, bit] = fb           # reference quirk: sys = feedback
            out_par[state, bit] = (fb + s0 + s2) % 2
            next_state[state, bit] = (fb << 2) | (s0 << 1) | s1
    return next_state, out_sys, out_par


@functools.lru_cache(maxsize=None)
def reverse_trellis():
    """prev_state (8,2), prev_input (8,2): the two incoming edges per state."""
    next_state, _, _ = trellis_tables()
    prev_state = np.zeros((8, 2), np.int32)
    prev_input = np.zeros((8, 2), np.int32)
    count = np.zeros(8, np.int32)
    for s in range(8):
        for b in range(2):
            ns = next_state[s, b]
            prev_state[ns, count[ns]] = s
            prev_input[ns, count[ns]] = b
            count[ns] += 1
    assert np.all(count == 2)
    return prev_state, prev_input


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------

def rsc_encode(bits: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """RSC encode with trellis termination.

    bits: (..., K) int -> (systematic (..., K+3), parity (..., K+3)),
    where 'systematic' is the feedback-bit stream (reference convention,
    turbo_encoder.py:174-189) and the 3 tail steps drive the state to zero.
    """
    b = bits.astype(jnp.int32)
    lead = b.shape[:-1]

    def step(state, bit):
        s0, s1, s2 = state
        fb = (bit + s1 + s2) % 2
        par = (fb + s0 + s2) % 2
        return (fb, s0, s1), (fb, par)

    def tail_step(state, _):
        s0, s1, s2 = state
        tail_bit = (s1 + s2) % 2
        fb = (tail_bit + s1 + s2) % 2       # == 0 always
        par = (fb + s0 + s2) % 2
        return (fb, s0, s1), (fb, par)

    from ..vma import match_vma
    zero = match_vma(jnp.zeros(lead, jnp.int32), b)   # shard_map scan carry
    state0 = (zero, zero, zero)
    bt = jnp.moveaxis(b, -1, 0)             # (K, ...)
    state, (sys, par) = jax.lax.scan(step, state0, bt)
    state, (sys_t, par_t) = jax.lax.scan(tail_step, state, None, length=3)
    sys_full = jnp.concatenate([jnp.moveaxis(sys, 0, -1),
                                jnp.moveaxis(sys_t, 0, -1)], axis=-1)
    par_full = jnp.concatenate([jnp.moveaxis(par, 0, -1),
                                jnp.moveaxis(par_t, 0, -1)], axis=-1)
    return sys_full, par_full


def turbo_encode(bits: jnp.ndarray, K: int) -> jnp.ndarray:
    """bits (..., K) -> encoded (..., 3K+12), interlaced
    [sys_k, par1_k, par2_k]*K then 12 tail bits
    [sys_tail1, par1_tail, sys_tail2, par2_tail]
    (turbo_encoder.py:271-313)."""
    sys1, par1 = rsc_encode(bits)
    inter = qpp_interleave(bits, K)
    sys2, par2 = rsc_encode(inter)

    data = jnp.stack([sys1[..., :K], par1[..., :K], par2[..., :K]], axis=-1)
    data = data.reshape(bits.shape[:-1] + (3 * K,))
    tails = jnp.concatenate([sys1[..., K:], par1[..., K:],
                             sys2[..., K:], par2[..., K:]], axis=-1)
    return jnp.concatenate([data, tails], axis=-1)


# ---------------------------------------------------------------------------
# BCJR decoder (max-log and exact log-MAP semirings)
# ---------------------------------------------------------------------------

_NEG = -1e9

# Parity with the reference's global USE_MAX_LOG_MAP switch
# (turbo_decoder.py:33-55): True = max-log (reference default), False = exact
# log-MAP (max* = log-sum-exp). Per-call `use_max_log` kwargs override it.
USE_MAX_LOG_MAP = True


def set_decoder_mode(use_max_log_map: bool = True) -> None:
    """Mirror of the reference's set_decoder_mode (turbo_decoder.py:35-55)."""
    global USE_MAX_LOG_MAP
    USE_MAX_LOG_MAP = bool(use_max_log_map)


def _reduce(x: jnp.ndarray, axis: int, use_max_log: bool) -> jnp.ndarray:
    """Semiring 'sum': max (max-log-MAP) or logsumexp (exact log-MAP)."""
    if use_max_log:
        return jnp.max(x, axis=axis)
    return jax.nn.logsumexp(x, axis=axis)


def _maxplus_mm(a: jnp.ndarray, b: jnp.ndarray,
                use_max_log: bool = True) -> jnp.ndarray:
    """Batched semiring matrix product c[i,j] = ⊕_k a[i,k] + b[k,j]
    for (..., 8, 8) operands — ⊕ = max (max-log) or LSE (log-MAP); both are
    associative, so either supports the prefix-product formulation."""
    return _reduce(a[..., :, :, None] + b[..., None, :, :], -2, use_max_log)


@functools.lru_cache(maxsize=None)
def _edge_scatter():
    """(rows, cols) such that T[rows[e], cols[e]] = gamma[s_e, i_e] builds the
    max-plus transition matrix T[s', s] from gamma (8, 2)."""
    ns, _, _ = trellis_tables()
    s = np.repeat(np.arange(8), 2)          # (16,) source states
    i = np.tile(np.arange(2), 8)            # (16,) inputs
    rows = ns[s, i]                         # target state s'
    return rows.astype(np.int32), s.astype(np.int32), i.astype(np.int32)


def _bcjr(llr_sys: jnp.ndarray, llr_par: jnp.ndarray,
          llr_apriori: jnp.ndarray, impl: str = None,
          use_max_log: bool = True) -> jnp.ndarray:
    """BCJR a-posteriori LLRs (max-log by default, exact log-MAP otherwise).

    All inputs (..., K'); returns a-posteriori LLRs (..., K'). Assumes the
    trellis starts AND ends in state 0 (termination included in K').
    use_max_log=False switches every max in the recursions/outputs to
    log-sum-exp — the reference's True-Log-MAP mode (max_star,
    turbo_decoder.py:92-115).

    impl: 'block' — blocked scan decomposition (the GPU default). The
          recursion α_{k+1} = T_k ⊗ α_k is linear over the (max,+)/(LSE,+)
          semiring but LATENCY-bound when run step-by-step: per-step work is
          a (batch, 16) gather+add+reduce, far too small to fill the device,
          so wall-clock ≈ sequential-op count × fixed per-step overhead.
          'block' cuts the sequential depth ~16×:
          (1) chunk the trellis into C blocks of L=64 steps and tree-reduce
          each block's 8×8 max-plus transition-matrix product in log2(L)
          fully parallel levels; (2) propagate block-boundary α/β VECTORS
          through the C chunk matrices (the only sequential part, C ≈ K'/64
          tiny steps; β reuses the same chunk products transposed — reversed
          (max,+) products transpose like ordinary matrix products); (3)
          re-run the within-block vector recursions for all C blocks AT ONCE
          (L steps of (C, batch, 16) gather+add+reduce, each step batched
          C× wider than 'scan'). Differs from the sequential impls only by
          float reassociation of the per-path metric sums (same class of
          difference as 'assoc'; hard outputs agree on real codewords —
          parity-tested vs the reference at K=40 and K=6144).
          'scan' — α/β as two sequential lax.scans (O(K') depth, minimal
          work, float-faithful to the reference's recursion order).
          'assoc' — α/β as full max-plus matrix prefix products via
          jax.lax.associative_scan (O(log K') depth). ~32× the arithmetic of
          'scan'; kept as a reference kernel for the prefix-product algebra.
    Defaults from OFDM_LTE_TPU_BCJR, else 'block' on the GPU and 'scan'
    elsewhere (identical hard decisions across all three on realistic
    inputs; 'scan' is the float-faithful arbiter). On CPU the sequential
    scans are compact HLO and XLA:CPU runs them well, while 'block''s
    unrolled phase-2/3 loops cost real compile time; PERF.md holds the card
    A/B behind the GPU default.
    """
    if impl is None:
        import os
        impl = os.environ.get("OFDM_LTE_TPU_BCJR")
        if impl is None:
            impl = "block" if jax.default_backend() == "gpu" else "scan"
    ns_t, sys_t, par_t = trellis_tables()
    ps_t, pi_t = reverse_trellis()
    ns = jnp.asarray(ns_t)
    sys_sign = jnp.asarray(1.0 - 2.0 * sys_t, jnp.float32)   # (8,2): +1 if 0
    par_sign = jnp.asarray(1.0 - 2.0 * par_t, jnp.float32)
    in_sign = jnp.asarray(
        1.0 - 2.0 * np.arange(2, dtype=np.float32))          # (2,)

    lead = llr_sys.shape[:-1]
    Kp = llr_sys.shape[-1]

    # gamma (..., K', 8, 2), branch metric = Σ ±L/2 (turbo_decoder.py:302-335)
    g = (llr_sys[..., None, None] * sys_sign
         + llr_par[..., None, None] * par_sign
         + llr_apriori[..., None, None] * in_sign[None, :]) * 0.5

    gt = jnp.moveaxis(g, -3, 0)                              # (K', ..., 8, 2)

    from ..vma import match_vma
    a0 = jnp.full(lead + (8,), _NEG, jnp.float32).at[..., 0].set(0.0)
    bK = jnp.full(lead + (8,), _NEG, jnp.float32).at[..., 0].set(0.0)
    a0 = match_vma(a0, llr_sys)                       # shard_map scan carries
    bK = match_vma(bK, llr_sys)

    if impl == "assoc":
        rows, srcs, ins = _edge_scatter()
        g_edges = gt[..., jnp.asarray(srcs), jnp.asarray(ins)]  # (K', ..., 16)
        T = jnp.full(gt.shape[:-2] + (8, 8), _NEG, jnp.float32)
        T = T.at[..., jnp.asarray(rows), jnp.asarray(srcs)].set(g_edges)

        # α_k = (T_{k-1} ⊗ … ⊗ T_0) ⊗ α_0 = P_{k-1}[:, 0]  (α_0 one-hot at 0)
        P = jax.lax.associative_scan(
            lambda a, b: _maxplus_mm(b, a, use_max_log), T, axis=0)
        alphas = jnp.concatenate([a0[None], P[:-1][..., :, 0]], axis=0)

        # β_k = (U_k ⊗ … ⊗ U_{K'-1}) ⊗ β_{K'} = Q_k[:, 0], U = Tᵀ.
        # Under reverse=True the first combine argument is the suffix
        # accumulated from the END, so here too the new element multiplies
        # on the left: fn(acc, elem) = elem ⊗ acc.
        U = T.swapaxes(-1, -2)
        Q = jax.lax.associative_scan(
            lambda a, b: _maxplus_mm(b, a, use_max_log), U,
            axis=0, reverse=True)
        betas_rev = jnp.concatenate([Q[1:][..., :, 0], bK[None]], axis=0)
    elif impl == "block":
        import os
        L = int(os.environ.get("OFDM_LTE_TPU_BCJR_BLOCK", "64"))
        rows, srcs, ins = _edge_scatter()
        ps_flat = jnp.asarray(ps_t.reshape(-1))              # (16,) prev state
        pi_flat = jnp.asarray(pi_t.reshape(-1))              # (16,) prev input
        ns_flat = ns.reshape(-1)                             # (16,) next state

        if L & (L - 1):
            raise ValueError(f"OFDM_LTE_TPU_BCJR_BLOCK={L} not a power of 2")
        nC = -(-Kp // L)                                     # chunk count
        pad = nC * L - Kp
        if pad:
            # identity steps in the semiring: T = I (0 diag, -1e9 off-diag)
            # leave both recursions fixed through the padded tail
            zpad = jnp.zeros((pad,) + gt.shape[1:], gt.dtype)
            gt_p = jnp.concatenate([gt, zpad], axis=0)
        else:
            gt_p = gt

        # per-step transition matrices T_k[s', s] (pad steps = identity)
        g_edges = gt_p[..., jnp.asarray(srcs), jnp.asarray(ins)]  # (CL,...,16)
        T = jnp.full(gt_p.shape[:-2] + (8, 8), _NEG, jnp.float32)
        T = T.at[..., jnp.asarray(rows), jnp.asarray(srcs)].set(g_edges)
        if pad:
            eye = jnp.where(jnp.eye(8, dtype=bool), 0.0, _NEG)
            T = T.at[Kp:].set(jnp.broadcast_to(eye, (pad,) + T.shape[1:]))
        Tc = T.reshape((nC, L) + T.shape[1:])                 # (C, L, ..., 8, 8)

        # (1) block products M_c = T_{(c+1)L-1} ⊗ … ⊗ T_{cL}: binary tree,
        # log2(L) levels, every level one batched semiring matmul
        M = Tc
        width = L
        while width > 1:
            M = _maxplus_mm(M[:, 1::2], M[:, 0::2], use_max_log)
            width //= 2
        M = M[:, 0]                                           # (C, ..., 8, 8)

        # (2) block-boundary vectors: α at cL, β at (c+1)L — the ONLY
        # sequential part, C ≈ K'/L steps of (…, 8) matrix-vector products.
        # β reuses M transposed: β_{cL} = M_cᵀ ⊗ β_{(c+1)L}. Deliberately a
        # trace-unrolled Python loop, NOT a lax.scan: the per-step scan
        # machinery costs far more than these tiny ops, and the one-off
        # compile cost of the unrolled HLO is paid once per shape.
        av, bv = [a0], [bK]
        for c in range(nC - 1):
            av.append(_reduce(M[c] + av[-1][..., None, :], -1, use_max_log))
            Mr = M[nC - 1 - c]
            bv.append(_reduce(Mr + bv[-1][..., :, None], -2, use_max_log))
        av = jnp.stack(av)                                    # (C, ..., 8)
        bv = jnp.stack(bv[::-1])        # bv[c] = β at (c+1)L, c = 0..C-1

        # (3) within-block recursions, ALL blocks at once: L steps over
        # (C, ..., 16)-shaped gathers — each step C× wider than 'scan'.
        ge_a = jnp.moveaxis(gt_p[..., ps_flat, pi_flat].reshape(
            (nC, L) + gt.shape[1:-2] + (16,)), 1, 0)          # (L, C, ..., 16)
        gb = jnp.moveaxis(gt_p.reshape((nC, L) + gt.shape[1:]),
                          1, 0)                               # (L, C, ..., 8, 2)
        x = av                                                # α at block starts
        y = bv                                                # β at block ends
        a_em, b_em = [None] * L, [None] * L
        for l in range(L):                                    # trace-unrolled
            a_em[l] = x
            cand = jnp.take(x, ps_flat, axis=-1) + ge_a[l]
            x = _reduce(cand.reshape(cand.shape[:-1] + (8, 2)), -1,
                        use_max_log)
            lb = L - 1 - l
            b_em[lb] = y                                      # β_{cL+lb+1}
            cand = jnp.take(y, ns_flat, axis=-1).reshape(
                y.shape[:-1] + (8, 2)) + gb[lb]
            y_new = _reduce(cand, -1, use_max_log)
            if (nC - 1) * L + lb < Kp:    # static: no chunk is in its pad
                y = y_new
            else:
                # position cL+lb is padding for the LAST chunk: its β step
                # must be the identity (match phases 1-2), so hold y there
                valid = jnp.asarray(np.arange(nC) * L + lb < Kp)
                y = jnp.where(valid.reshape((nC,) + (1,) * (y.ndim - 1)),
                              y_new, y)
        # (L, C, ..., 8) -> (C, L, ...) -> (CL, ...), trim the pad
        alphas = jnp.stack(a_em).swapaxes(0, 1).reshape(
            (nC * L,) + gt.shape[1:-2] + (8,))[:Kp]
        betas_rev = jnp.stack(b_em).swapaxes(0, 1).reshape(
            (nC * L,) + gt.shape[1:-2] + (8,))[:Kp]
    elif impl == "scan":
        # flat edge tables: for target state s', edge e in {0,1}: source state
        # ps_flat[2s'+e] emitting input pi_flat[2s'+e]
        ps_flat = jnp.asarray(ps_t.reshape(-1))              # (16,) prev state
        pi_flat = jnp.asarray(pi_t.reshape(-1))              # (16,) prev input

        def alpha_step(a, gk):
            # a: (..., 8); gk: (..., 8, 2)
            g_edges = gk[..., ps_flat, pi_flat]              # (..., 16)
            cand = jnp.take(a, ps_flat, axis=-1) + g_edges
            cand = cand.reshape(cand.shape[:-1] + (8, 2))
            a_new = _reduce(cand, -1, use_max_log)
            return a_new, a

        aK, alphas = jax.lax.scan(alpha_step, a0, gt)        # alphas: pre-step
        # alphas[k] = alpha at time k (before consuming bit k)

        def beta_step(bnext, gk):
            # beta[s] = max_i bnext[ns[s,i]] + g[s,i]
            cand = jnp.take(bnext, ns.reshape(-1), axis=-1).reshape(
                bnext.shape[:-1] + (8, 2)) + gk
            b_new = _reduce(cand, -1, use_max_log)
            return b_new, bnext

        b0, betas_rev = jax.lax.scan(beta_step, bK, gt, reverse=True)
        # betas_rev[k] = beta at time k+1 (after consuming bit k)
    else:
        raise ValueError(f"unknown BCJR impl {impl!r}; "
                         "pick from 'block', 'scan', 'assoc'")

    # LLR_k = max_{(s,i=0)}(α_k[s]+γ_k[s,i]+β_{k+1}[ns]) − max_{(s,i=1)}(…)
    alphas_b = jnp.moveaxis(alphas, 0, -2)                   # (..., K', 8)
    betas_b = jnp.moveaxis(betas_rev, 0, -2)                 # (..., K', 8)
    bnext = jnp.take(betas_b, ns.reshape(-1), axis=-1).reshape(
        betas_b.shape[:-1] + (8, 2))
    val = alphas_b[..., :, None] + g + bnext                 # (..., K', 8, 2)
    llr0 = _reduce(val[..., 0], -1, use_max_log)
    llr1 = _reduce(val[..., 1], -1, use_max_log)
    return llr0 - llr1


def turbo_decode(llr_encoded: jnp.ndarray, K: int,
                 num_iterations: int = 5,
                 use_max_log: Optional[bool] = None) -> jnp.ndarray:
    """Iterative turbo decode (max-log by default; exact log-MAP with
    use_max_log=False, or globally via set_decoder_mode).

    llr_encoded: (..., 3K+12) in the encoder's interlaced order (LLR>0 ->
    bit 0). Returns hard decisions (..., K). Matches turbo_decode at
    turbo_decoder.py:338-450: extrinsic = APP − apriori − systematic, tails
    appended per constituent decoder, final pass on decoder 1's APP.
    """
    if use_max_log is None:
        use_max_log = USE_MAX_LOG_MAP
    lead = llr_encoded.shape[:-1]
    data = llr_encoded[..., :3 * K].reshape(lead + (K, 3))
    l_sys = data[..., 0]
    l_par1 = data[..., 1]
    l_par2 = data[..., 2]
    t = llr_encoded[..., 3 * K:]
    sys1_tail, par1_tail = t[..., 0:3], t[..., 3:6]
    sys2_tail, par2_tail = t[..., 6:9], t[..., 9:12]

    l_sys1 = jnp.concatenate([l_sys, sys1_tail], axis=-1)      # (..., K+3)
    l_par1e = jnp.concatenate([l_par1, par1_tail], axis=-1)
    l_sys2 = jnp.concatenate([qpp_interleave(l_sys, K), sys2_tail], axis=-1)
    l_par2e = jnp.concatenate([l_par2, par2_tail], axis=-1)

    zeros3 = jnp.zeros(lead + (3,), jnp.float32)
    ext21 = jnp.zeros(lead + (K,), jnp.float32)

    def half_iteration(ext21):
        apr1 = jnp.concatenate([ext21, zeros3], axis=-1)
        app1 = _bcjr(l_sys1, l_par1e, apr1, use_max_log=use_max_log)
        ext12 = (app1 - apr1 - l_sys1)[..., :K]

        apr2 = jnp.concatenate([qpp_interleave(ext12, K), zeros3], axis=-1)
        app2 = _bcjr(l_sys2, l_par2e, apr2, use_max_log=use_max_log)
        return qpp_deinterleave((app2 - apr2 - l_sys2)[..., :K], K)

    if num_iterations:
        # lax.scan over iterations: the BCJR body (large HLO, esp. the
        # 'block' impl's unrolled phases) is traced ONCE, not
        # num_iterations times — ~8× smaller programs and compile times
        # with no runtime cost (the iterations are sequential either way)
        from ..vma import match_vma
        ext21 = jax.lax.scan(
            lambda c, _: (half_iteration(c), None),
            match_vma(ext21, llr_encoded), None,
            length=num_iterations)[0]

    apr1 = jnp.concatenate([ext21, zeros3], axis=-1)
    app = _bcjr(l_sys1, l_par1e, apr1, use_max_log=use_max_log)
    return (app[..., :K] < 0).astype(jnp.int32)
