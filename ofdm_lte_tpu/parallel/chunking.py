"""Lane-chunked execution: run a batched sim over lane chunks inside one
XLA program — either UNROLLED (independent chunk subgraphs the compiler
schedules freely) or SEQUENTIALLY (lax.map).

Why: a pipeline can have a lane-scaling knee — past some batch size the
per-lane throughput drops because the big-batch program crosses a
compiler threshold on one op and every op then pays. Chunking keeps each
chunk's ops at knee-sized shapes:

- mode="unroll" (default): a trace-time Python loop emits each chunk as
  an independent subgraph the compiler can interleave.
- mode="scan": lax.map chains chunks sequentially — one copy of the
  chunk program, linear cost in chunks, but a hard serialization
  barrier between chunks. Use for many-chunk cases where unrolling
  would blow up program size.

`lane_chunked(sim_fn, chunk)` wraps any sim whose first three arguments
are (key, bits, snr) with leading lane axes on bits/snr; extra
args/kwargs pass through as trace-time constants. Outputs (pytrees with
the lane axis leading) are re-concatenated, and each chunk gets an
independent fold of the key — results are NOT bit-identical to the
unchunked call (different key split structure), but are draws from the
identical distribution (the unchunked call's lanes are independent too).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

# Measured chunk policy per pipeline: {pipeline: (knee_lanes, mode)}, with
# knees in lanes of 14-OFDM-symbol frames ("coded" lanes are transport
# blocks, symbol-count-independent). Empty until a knee is measured on the
# card (ROADMAP 1.9): every pipeline runs flat.
MEASURED_KNEES = {}

# Unrolling emits one subgraph copy per chunk; cap the copies so program
# size stays bounded.
_MAX_UNROLL_CHUNKS = 8


def auto_chunk(pipeline: str, lanes, num_ofdm_symbols: int = 14,
               knees=None):
    """Measured-knee chunk geometry for a batched pipeline: returns
    (chunk_size, mode) to pass to `lane_chunked` / sweep `frame_chunk`,
    or (None, None) when flat execution is the measured optimum.

    `lanes` is the total leading batch; `num_ofdm_symbols` scales the
    per-lane work relative to the 14-symbol frames the knees were
    measured at (a 28-symbol frame costs ~2x, so the knee halves).
    Unknown pipelines get (None, None) — flat is the safe default.
    `knees` overrides the MEASURED_KNEES table.
    """
    table = MEASURED_KNEES if knees is None else knees
    knee, mode = table.get(pipeline, (None, None))
    if knee is None or not lanes:
        return None, None
    if pipeline != "coded":
        knee = max(1, knee * 14 // max(1, int(num_ofdm_symbols)))
    lanes = int(lanes)
    if lanes <= knee:
        return None, None
    # largest divisor of the lane count that keeps chunks at/below the knee
    chunk = max((d for d in range(1, knee + 1) if lanes % d == 0))
    if chunk == 1 and lanes > 1:
        return None, None          # prime-ish lane count: nothing divides
    if mode == "unroll" and lanes // chunk > _MAX_UNROLL_CHUNKS:
        if lanes % _MAX_UNROLL_CHUNKS == 0:
            chunk = lanes // _MAX_UNROLL_CHUNKS
        else:
            return None, None      # refuse a program-bloat unroll
    return chunk, mode


def auto_lane_chunked(sim_fn, pipeline: str, lanes,
                      num_ofdm_symbols: int = 14, knees=None):
    """`lane_chunked` with the measured `auto_chunk` geometry; returns
    sim_fn unchanged when the policy says flat execution wins."""
    chunk, mode = auto_chunk(pipeline, lanes, num_ofdm_symbols, knees)
    if chunk is None:
        return sim_fn
    return lane_chunked(sim_fn, chunk, mode=mode)


def lane_chunked(sim_fn, chunk_size: int, mode: str = "unroll"):
    """Wrap sim_fn(key, bits, snr, *args, **kw) to process leading-axis
    lanes in `chunk_size` chunks inside one program.

    mode="unroll" (default): independent per-chunk subgraphs. mode="scan": sequential lax.map (smaller program; use
    when the chunk count is large).

    Falls back to a direct call when the lane count is not a positive
    multiple of chunk_size, when it equals chunk_size, or when bits has
    no lane axis (single-frame call).
    """
    if mode not in ("unroll", "scan"):
        raise ValueError(f"lane_chunked mode must be 'unroll' or 'scan', "
                         f"got {mode!r}")

    def wrapped(key, bits, snr, *args, **kw):
        if bits.ndim < 2:
            return sim_fn(key, bits, snr, *args, **kw)
        L = bits.shape[0]
        if L <= chunk_size or L % chunk_size:
            return sim_fn(key, bits, snr, *args, **kw)
        n = L // chunk_size
        bits_c = bits.reshape((n, chunk_size) + bits.shape[1:])
        snr_arr = jnp.asarray(snr, jnp.float32)
        if snr_arr.ndim and snr_arr.shape[0] == L:
            snr_c = snr_arr.reshape((n, chunk_size) + snr_arr.shape[1:])
        else:
            snr_c = jnp.broadcast_to(snr_arr, (n,) + snr_arr.shape)
        keys = jax.random.split(key, n)

        if mode == "unroll":
            outs = [sim_fn(keys[i], bits_c[i], snr_c[i], *args, **kw)
                    for i in range(n)]
            return jax.tree.map(
                lambda *xs: jnp.concatenate(xs, axis=0)
                if (hasattr(xs[0], "ndim") and xs[0].ndim >= 1
                    and xs[0].shape[:1] == (chunk_size,))
                else xs[0], *outs)

        out = jax.lax.map(
            lambda xs: sim_fn(xs[0], xs[1], xs[2], *args, **kw),
            (keys, bits_c, snr_c))
        return jax.tree.map(
            lambda x: x.reshape((L,) + x.shape[2:])
            if (hasattr(x, "ndim") and x.ndim >= 2
                and x.shape[:2] == (n, chunk_size)) else x, out)

    return wrapped
