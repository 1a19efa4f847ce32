"""Monte-Carlo BER/PAPR sweeps sharded over a device mesh.

The reference's entire "distributed" story is a sequential Python loop over
SNR points × trials (/root/reference/core/ofdm_core.py:1795-1846) plus a
thread pool per RX antenna (core/parallel_processing.py). Replacement per
SURVEY §2.9:

- SNR points and Monte-Carlo frames are ARRAY AXES of one jitted program;
- frames shard across devices via shard_map over a 1-D 'mc' mesh;
- bit-error counters reduce with jax.lax.psum across the mesh;
- randomness is key-split per (device, snr, frame) — no global RNG.

Multi-host: build the mesh from jax.devices() after jax.distributed
initialization — the same shard_map program then spans hosts. DP is the
only parallelism dimension this workload needs (no TP/PP/EP — there are no
weights). The mesh is 1-D ('mc') by default; `make_mesh_2d` gives a
('snr', 'mc') mesh that also shards SNR points across devices (each device
then simulates only its SNR block). The GPUs of one host are joined all to
all, so the mesh shape follows the algorithm alone.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from jax import shard_map

from ..config import LTEConfig
from ..sim import siso


def bits_per_frame(config, num_ofdm_symbols, mode, pipeline,
                   coded_tb_bits=6000):
    if pipeline in ("siso", "simo"):
        return siso.bits_per_frame(config, num_ofdm_symbols, mode)
    if pipeline == "sfbc":
        from ..sim import diversity
        return diversity.sfbc_bits_per_frame(config, num_ofdm_symbols)
    if pipeline == "spatial":
        from ..sim import spatial
        return spatial.bits_per_frame(config, num_ofdm_symbols)
    if pipeline == "coded":
        return coded_tb_bits   # one transport block per Monte-Carlo frame
    if pipeline == "beamforming":
        from ..sim import beamforming
        return beamforming.bits_per_frame(config, num_ofdm_symbols)
    raise ValueError(f"unknown pipeline {pipeline}")


def run_lane(k, b, snr, config, mode, channel_type, itu_profile,
             velocity_kmh, pipeline, num_tx, num_rx,
             detector_type="MMSE", rank=None):
    """Returns (bit_errors, papr_db) for one Monte-Carlo lane of a sweep."""
    if pipeline == "siso":
        r = siso.simulate_siso(k, b, snr, config, mode=mode,
                               channel_type=channel_type,
                               itu_profile=itu_profile,
                               velocity_kmh=velocity_kmh)
        return r.bit_errors, r.papr_db
    if pipeline == "simo":
        from ..sim import diversity
        r = diversity.simulate_simo(k, b, snr, config, num_rx=num_rx,
                                    channel_type=channel_type,
                                    itu_profile=itu_profile,
                                    velocity_kmh=velocity_kmh)
        return r.bit_errors, r.papr_db
    if pipeline == "sfbc":
        from ..sim import diversity
        r = diversity.simulate_sfbc(k, b, snr, config, num_rx=num_rx,
                                    channel_type=channel_type,
                                    itu_profile=itu_profile,
                                    velocity_kmh=velocity_kmh)
        return r.bit_errors, r.papr_db
    if pipeline == "spatial":
        from ..sim import spatial
        r = spatial.simulate_spatial_multiplexing(
            k, b, snr, config, num_tx=num_tx, num_rx=num_rx,
            rank=min(num_tx, num_rx) if rank is None else rank,
            detector_type=detector_type,
            channel_type=channel_type, itu_profile=itu_profile,
            velocity_kmh=velocity_kmh or 3.0)
        return r.bit_errors, r.papr_db
    if pipeline == "coded":
        from ..sim import coded
        r = coded.simulate_siso_coded_batched(
            k, b, snr, config, channel_type=channel_type,
            itu_profile=itu_profile, velocity_kmh=velocity_kmh)
        return r.bit_errors, r.papr_db
    if pipeline == "beamforming":
        from ..sim import beamforming
        # TM6 rank-1 codebook beamforming on the flat MIMO channel — the
        # reference's frequency-domain path (ofdm_core.py:2260-2477: no
        # IFFT/CP), so PAPR is not defined here; report 0.0
        r = beamforming.simulate_beamforming(k, b, snr, config,
                                             num_tx=num_tx, num_rx=num_rx)
        return r.bit_errors, jnp.zeros_like(jnp.asarray(snr, jnp.float32))
    raise ValueError(f"unknown pipeline {pipeline}")


def lane_inputs(key, device_index, num_snr: int, frames: int, n_bits: int):
    """Per-lane PRNG keys (num_snr, frames, 2) and TX bits (num_snr, frames,
    n_bits) of one device's shard — the exact derivation ber_sweep uses, so
    a caller can re-run chosen lanes of a sweep elsewhere."""
    key = jax.random.fold_in(key, device_index)
    kb, kc = jax.random.split(key)
    bits = jax.random.bernoulli(
        kb, 0.5, (num_snr, frames, n_bits)).astype(jnp.int32)
    keys = jax.random.split(kc, num_snr * frames).reshape(num_snr, frames, 2)
    return keys, bits


class SweepResult(NamedTuple):
    snr_db: jnp.ndarray        # (S,)
    ber: jnp.ndarray           # (S,)
    bit_errors: jnp.ndarray    # (S,) summed over all frames/devices
    total_bits: jnp.ndarray    # (S,)
    papr_db: jnp.ndarray       # (S,) mean over frames
    frames: int


def make_mesh(devices=None, axis_name: str = "mc") -> Mesh:
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.asarray(devices), (axis_name,))


def make_mesh_2d(num_snr_shards: int, devices=None) -> Mesh:
    """2-D ('snr', 'mc') mesh: SNR points shard across the first axis,
    Monte-Carlo frames across the second (SURVEY §2.9). Use when SNR-point
    count × frame batch exceeds what replicating every point on every
    device allows — each device then simulates only its SNR block, and the
    psum error reduction runs within an 'mc' row."""
    devices = devices if devices is not None else jax.devices()
    n = len(devices)
    if n % num_snr_shards:
        raise ValueError(f"{n} devices not divisible into "
                         f"{num_snr_shards} SNR shards")
    return Mesh(np.asarray(devices).reshape(num_snr_shards, -1),
                ("snr", "mc"))


def ber_sweep(key: jax.Array, config: LTEConfig, snr_points,
              frames_per_device: int = 8, num_ofdm_symbols: int = 28,
              mesh: Mesh = None, mode: str = "lte",
              channel_type: str = "awgn", itu_profile: str = "Pedestrian_A",
              velocity_kmh: float = None, pipeline: str = "siso",
              num_tx: int = 2, num_rx: int = 2,
              coded_tb_bits: int = 6000,
              detector_type: str = "MMSE", rank: int = None,
              frame_chunk: int = None) -> SweepResult:
    """Run a full BER sweep: (num_devices · frames_per_device) frames per SNR
    point, error counts psum-reduced across the mesh.

    pipeline: "siso" (default), "simo", "sfbc", "spatial", "coded" or
    "beamforming" — the full TX→channel→RX chain of the corresponding sim
    module runs inside the sharded program ("coded" runs one
    `coded_tb_bits` transport block through the full TS 36.212 chain per
    Monte-Carlo frame; "beamforming" is the reference's frequency-domain
    TM6 path, ofdm_core.py:2260-2477). Replaces OFDMSimulator.run_ber_sweep
    (ofdm_core.py:1795-1846) and the legacy OFDMSystem sweeps
    (ofdm_system.py:432-602).

    detector_type / rank apply to the "spatial" pipeline only — the Spatial
    GUI's detector selector (MMSE/IRC/ZF/SIC/MRC) at sweep scale
    (/root/reference/Spatial/gui/main_window.py:94-149,
    core/mimo_detector.py:200-306). rank=None uses min(num_tx, num_rx).

    frame_chunk: process each SNR point's frames_per_device in chunks of
    this size inside the one sharded program (parallel/chunking
    rationale). An int chunks with UNROLLED independent subgraphs; "auto"
    applies the measured per-pipeline policy (parallel.chunking.auto_chunk,
    flat for every pipeline until a knee is measured on the card); a
    (chunk, mode) tuple picks the geometry explicitly (mode "unroll" or
    "scan").
    None (default) keeps one flat vmap. Ignored unless it divides frames_per_device. Chunked
    and flat runs use identical per-lane keys, so results match the
    flat program up to float reassociation.
    """
    if mesh is None:
        mesh = make_mesh()
    # 1-D mesh: every device runs every SNR point on its frame shard.
    # 2-D ('snr', 'mc') mesh: SNR points shard across the 'snr' axis too.
    if len(mesh.axis_names) == 2:
        snr_axis, axis = mesh.axis_names
        n_snr_shards = mesh.shape[snr_axis]
    else:
        snr_axis, axis = None, mesh.axis_names[0]
        n_snr_shards = 1
    mc_size = mesh.shape[axis]
    snr_points = jnp.asarray(snr_points, jnp.float32)
    S = snr_points.shape[0]
    # pad the SNR axis to a multiple of its shard count (trimmed at the end)
    S_pad = (-S) % n_snr_shards
    snr_work = (jnp.concatenate([snr_points,
                                 jnp.broadcast_to(snr_points[-1:], (S_pad,))])
                if S_pad else snr_points)
    S_local = (S + S_pad) // n_snr_shards
    n_bits = bits_per_frame(config, num_ofdm_symbols, mode, pipeline,
                             coded_tb_bits)
    F = frames_per_device
    chunk_mode = "unroll"
    if frame_chunk == "auto":
        from .chunking import auto_chunk
        frame_chunk, chunk_mode = auto_chunk(pipeline, F, num_ofdm_symbols)
    elif isinstance(frame_chunk, (tuple, list)):
        frame_chunk, chunk_mode = frame_chunk    # explicit (chunk, mode)

    def per_device(key, snrs):
        # distinct stream per device, derived from a REPLICATED base key —
        # multi-process safe (no host-side key sharding needed; decorrelation
        # comes from the device's global mesh index)
        dev = jax.lax.axis_index(axis)
        if snr_axis is not None:
            dev = dev + jax.lax.axis_index(snr_axis) * mc_size
        keys, bits = lane_inputs(key, dev, S_local, F, n_bits)

        def one_lane(k, b, snr):
            return run_lane(k, b, snr, config, mode, channel_type,
                            itu_profile, velocity_kmh, pipeline,
                            num_tx, num_rx, detector_type, rank)

        if frame_chunk and frame_chunk < F and F % frame_chunk == 0:
            nch = F // frame_chunk

            if chunk_mode == "scan":
                def one_snr(ks, bs, snr):
                    # sequential lax.map over knee-sized chunks: one copy
                    # of the chunk program, linear cost
                    ksc = ks.reshape((nch, frame_chunk) + ks.shape[1:])
                    bsc = bs.reshape((nch, frame_chunk) + bs.shape[1:])
                    out = jax.lax.map(
                        lambda xs: jax.vmap(
                            lambda k, b: one_lane(k, b, snr))(xs[0], xs[1]),
                        (ksc, bsc))
                    return tuple(o.reshape((F,)) for o in out)
            else:
                def one_snr(ks, bs, snr):
                    # unrolled knee-sized chunks: independent subgraphs XLA
                    # interleaves
                    outs = [jax.vmap(lambda k, b: one_lane(k, b, snr))(
                        ks[i * frame_chunk:(i + 1) * frame_chunk],
                        bs[i * frame_chunk:(i + 1) * frame_chunk])
                        for i in range(nch)]
                    return tuple(jnp.concatenate([o[j] for o in outs])
                                 for j in range(2))

            errs, paprs = jax.vmap(one_snr)(keys, bits, snrs)
        else:
            errs, paprs = jax.vmap(
                lambda ks, bs, snr: jax.vmap(
                    lambda k, b: one_lane(k, b, snr))(ks, bs)
            )(keys, bits, snrs)

        # overflow-safe error reduction: the per-device count is bounded by
        # F·n_bits (asserted < 2^31 below), but the cross-device psum of raw
        # int32 counts overflows at ~25k frames of 20 MHz 64-QAM. Split into
        # 16-bit halves, psum each, and recombine on the host in int64.
        errs_local = jnp.sum(errs, axis=1)                    # (S_local,)
        err_lo = jax.lax.psum(errs_local % 65536, axis)
        err_hi = jax.lax.psum(errs_local // 65536, axis)
        papr = jax.lax.pmean(jnp.mean(paprs, axis=1), axis)   # (S_local,)
        return err_lo, err_hi, papr

    if F * n_bits >= 2 ** 31:
        raise ValueError(
            f"frames_per_device={F} x {n_bits} bits/frame overflows the "
            f"per-device int32 error counter; split into multiple sweeps")

    sharded = shard_map(
        per_device, mesh=mesh,
        in_specs=(P(), P(snr_axis)),
        out_specs=(P(snr_axis), P(snr_axis), P(snr_axis)),
    )
    err_lo, err_hi, papr = jax.jit(sharded)(key, snr_work)
    errors = (np.asarray(err_hi[:S], np.int64) * 65536
              + np.asarray(err_lo[:S], np.int64))
    papr = papr[:S]

    frames_per_point = F * mc_size
    total = np.full((S,), np.int64(n_bits) * frames_per_point, np.int64)
    return SweepResult(snr_points, errors / total, errors, total, papr,
                       frames_per_point)


class HarqSweepResult(NamedTuple):
    snr_db: jnp.ndarray             # (S,)
    bler: jnp.ndarray               # (S,) CRC-fail fraction after the full
    #                                 rv schedule (residual BLER)
    avg_transmissions: jnp.ndarray  # (S,) mean transmissions per TB
    bler_per_stage: jnp.ndarray     # (S, T) BLER after each combined decode
    ber: jnp.ndarray                # (S,) residual info-bit error rate
    tb_failures: jnp.ndarray        # (S,) int
    frames: int                     # TBs per SNR point
    # exact integer counters (psum-reduced, lossless under checkpoint
    # accumulation — the ratios above are derived views of these):
    stage_failures: np.ndarray      # (S, T) int — TBs failing at stage <= t
    tx_sum: np.ndarray              # (S,) int — total transmissions
    bit_errors: np.ndarray          # (S,) int — residual info-bit errors


def harq_sweep(key: jax.Array, config: LTEConfig, snr_points,
               frames_per_device: int = 4, tb_bits: int = 6000,
               rv_sequence=(0, 1, 2, 3), mesh: Mesh = None,
               channel_type: str = "awgn",
               itu_profile: str = "Pedestrian_A",
               velocity_kmh: float = None,
               num_iterations: int = 8) -> HarqSweepResult:
    """Sharded HARQ Monte-Carlo sweep: per SNR point, (num_devices ·
    frames_per_device) transport blocks each run the full in-graph HARQ
    schedule (sim.coded.simulate_siso_coded_harq_batched); BLER-per-stage,
    residual BLER/BER and mean-transmission counters psum-reduce across
    the mesh. Supports the same 1-D ('mc') and 2-D ('snr', 'mc') meshes as
    ber_sweep."""
    from ..sim import coded

    if mesh is None:
        mesh = make_mesh()
    if len(mesh.axis_names) == 2:
        snr_axis, axis = mesh.axis_names
        n_snr_shards = mesh.shape[snr_axis]
    else:
        snr_axis, axis = None, mesh.axis_names[0]
        n_snr_shards = 1
    mc_size = mesh.shape[axis]
    snr_points = jnp.asarray(snr_points, jnp.float32)
    S = snr_points.shape[0]
    S_pad = (-S) % n_snr_shards
    snr_work = (jnp.concatenate([snr_points,
                                 jnp.broadcast_to(snr_points[-1:], (S_pad,))])
                if S_pad else snr_points)
    S_local = (S + S_pad) // n_snr_shards
    F = frames_per_device
    T = len(rv_sequence)
    rvs = tuple(int(r) for r in rv_sequence)

    def per_device(key, snrs):
        dev = jax.lax.axis_index(axis)
        if snr_axis is not None:
            dev = dev + jax.lax.axis_index(snr_axis) * mc_size
        keys, bits = lane_inputs(key, dev, S_local, F, tb_bits)

        def one_lane(k, b, snr):
            r = coded.simulate_siso_coded_harq_batched(
                k, b, snr, config, rv_sequence=rvs,
                channel_type=channel_type, itu_profile=itu_profile,
                velocity_kmh=velocity_kmh, num_iterations=num_iterations)
            return (r.bit_errors, r.crc_pass, r.num_transmissions,
                    r.crc_pass_stage)

        errs, ok, ntx, ok_stage = jax.vmap(
            lambda ks, bs, snr: jax.vmap(
                lambda k, b: one_lane(k, b, snr))(ks, bs)
        )(keys, bits, snrs)

        # per-point int32 counters are tiny (≤ F·tb_bits and ≤ F·T); psum
        # across realistic mesh sizes stays far below 2^31
        errs_d = jax.lax.psum(jnp.sum(errs, axis=1), axis)
        fails_d = jax.lax.psum(
            jnp.sum((~ok).astype(jnp.int32), axis=1), axis)
        ntx_d = jax.lax.psum(jnp.sum(ntx, axis=1), axis)
        fails_stage = jax.lax.psum(
            jnp.sum((~ok_stage).astype(jnp.int32), axis=1), axis)
        return errs_d, fails_d, ntx_d, fails_stage

    sharded = shard_map(
        per_device, mesh=mesh,
        in_specs=(P(), P(snr_axis)),
        out_specs=(P(snr_axis), P(snr_axis), P(snr_axis), P(snr_axis)),
    )
    errs, fails, ntx, fails_stage = jax.jit(sharded)(key, snr_work)
    errs = np.asarray(errs[:S], np.int64)
    fails = np.asarray(fails[:S], np.int64)
    ntx = np.asarray(ntx[:S], np.int64)
    fails_stage = np.asarray(fails_stage[:S], np.int64)

    frames_per_point = F * mc_size
    total_bits = np.int64(tb_bits) * frames_per_point
    return HarqSweepResult(
        snr_points, fails / frames_per_point, ntx / frames_per_point,
        fails_stage / frames_per_point, errs / total_bits, fails,
        frames_per_point, fails_stage, ntx, errs)
