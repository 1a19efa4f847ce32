"""Lane-chunked execution (parallel/chunking.lane_chunked): shape fidelity
and distributional equivalence with the unchunked batched call, in both
execution modes (unroll = independent subgraphs, scan = lax.map)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from ofdm_lte_tpu import LTEConfig
from ofdm_lte_tpu.parallel.chunking import (lane_chunked, auto_chunk,
                                            auto_lane_chunked)
from ofdm_lte_tpu.sim import siso, diversity


@pytest.mark.parametrize("mode", ["unroll", "scan"])
def test_chunked_siso_shapes_and_stats(mode):
    cfg = LTEConfig(bandwidth=1.25, modulation="QPSK")
    lanes, chunk = 8, 4
    n = siso.bits_per_frame(cfg, 14)
    bits = jnp.asarray(np.random.default_rng(0).integers(
        0, 2, (lanes, n)).astype(np.int32))
    snr = jnp.full((lanes,), 6.0, jnp.float32)

    plain = siso.simulate_siso(jax.random.PRNGKey(0), bits, snr, cfg)
    chunked = lane_chunked(
        lambda k, b, s, c: siso.simulate_siso(k, b, s, c), chunk,
        mode=mode)(jax.random.PRNGKey(0), bits, snr, cfg)

    assert chunked.bit_errors.shape == plain.bit_errors.shape == (lanes,)
    assert chunked.bits_rx.shape == plain.bits_rx.shape
    # different key-split structure -> different draws, same distribution
    b_plain = float(jnp.sum(plain.bit_errors)) / (lanes * n)
    b_chunk = float(jnp.sum(chunked.bit_errors)) / (lanes * n)
    assert abs(b_plain - b_chunk) < 0.02, (b_plain, b_chunk)
    # per-lane SNR routing survives chunking: 60 dB lanes are error-free
    snr_mix = jnp.asarray([6.0, 60.0] * 4, jnp.float32)
    r = lane_chunked(
        lambda k, b, s, c: siso.simulate_siso(k, b, s, c), chunk,
        mode=mode)(jax.random.PRNGKey(1), bits, snr_mix, cfg)
    errs = np.asarray(r.bit_errors)
    assert np.all(errs[1::2] == 0) and np.all(errs[0::2] > 0), errs


@pytest.mark.parametrize("mode", ["unroll", "scan"])
def test_chunked_sfbc_equivalence(mode):
    cfg = LTEConfig(bandwidth=1.25, modulation="QPSK")
    lanes, chunk = 4, 2
    n = diversity.sfbc_bits_per_frame(cfg, 14)
    bits = jnp.asarray(np.random.default_rng(1).integers(
        0, 2, (lanes, n)).astype(np.int32))
    snr = jnp.full((lanes,), 60.0, jnp.float32)

    fn = lambda k, b, s, c: diversity.simulate_sfbc(   # noqa: E731
        k, b, s, c, num_rx=1)
    r = lane_chunked(fn, chunk, mode=mode)(
        jax.random.PRNGKey(2), bits, snr, cfg)
    assert r.bit_errors.shape == (lanes,)
    assert int(jnp.sum(r.bit_errors)) == 0      # 60 dB: error-free


def test_chunked_modes_agree_under_jit():
    """Both modes produce identical per-lane results for the SAME keys:
    the key-split structure is shared (split(key, n) per chunk), so
    unroll vs scan is purely an execution-strategy choice."""
    cfg = LTEConfig(bandwidth=1.25, modulation="QPSK")
    lanes, chunk = 8, 4
    n = siso.bits_per_frame(cfg, 14)
    bits = jnp.asarray(np.random.default_rng(5).integers(
        0, 2, (lanes, n)).astype(np.int32))
    snr = jnp.full((lanes,), 8.0, jnp.float32)
    fn = lambda k, b, s, c: siso.simulate_siso(k, b, s, c)  # noqa: E731
    key = jax.random.PRNGKey(9)
    r_u = jax.jit(lane_chunked(fn, chunk, mode="unroll"),
                  static_argnums=(3,))(key, bits, snr, cfg)
    r_s = jax.jit(lane_chunked(fn, chunk, mode="scan"),
                  static_argnums=(3,))(key, bits, snr, cfg)
    np.testing.assert_array_equal(np.asarray(r_u.bit_errors),
                                  np.asarray(r_s.bit_errors))


def test_chunked_fallback_paths():
    cfg = LTEConfig(bandwidth=1.25, modulation="QPSK")
    n = siso.bits_per_frame(cfg, 14)
    fn = lane_chunked(lambda k, b, s, c: siso.simulate_siso(k, b, s, c), 4)
    # lane count == chunk, not a multiple, and single-frame: direct call
    for lanes in (4, 6):
        bits = jnp.asarray(np.random.default_rng(2).integers(
            0, 2, (lanes, n)).astype(np.int32))
        r = fn(jax.random.PRNGKey(0), bits,
               jnp.full((lanes,), 60.0, jnp.float32), cfg)
        assert r.bit_errors.shape == (lanes,)
        assert int(jnp.sum(r.bit_errors)) == 0
    bits1 = jnp.asarray(np.random.default_rng(3).integers(
        0, 2, n).astype(np.int32))
    r1 = fn(jax.random.PRNGKey(0), bits1, 60.0, cfg)
    assert r1.bit_errors.shape == ()

    with pytest.raises(ValueError):
        lane_chunked(fn, 4, mode="vmap")


# An injected knee table: auto_chunk's geometry is tested against it, not
# against any measured values.
KNEES = {"sfbc": (256, "unroll"), "simo": (256, "unroll"),
         "coded": (128, "scan"), "siso": (None, None)}


def test_auto_chunk_policy():
    """Knee geometry from an injected table: unroll x256 for sfbc/simo
    past the knee, scan x128 for coded, flat for pipelines without a knee,
    with the knee scaled by per-frame symbol count."""
    assert auto_chunk("sfbc", 1024, knees=KNEES) == (256, "unroll")
    assert auto_chunk("sfbc", 512, knees=KNEES) == (256, "unroll")
    assert auto_chunk("simo", 1024, knees=KNEES) == (256, "unroll")
    assert auto_chunk("coded", 256, knees=KNEES) == (128, "scan")
    # at/below the knee: flat
    assert auto_chunk("sfbc", 256, knees=KNEES) == (None, None)
    assert auto_chunk("coded", 128, knees=KNEES) == (None, None)
    assert auto_chunk("coded", 8, knees=KNEES) == (None, None)
    # 28-symbol frames cost ~2x the 14-symbol lanes: knee halves
    assert auto_chunk("sfbc", 1024, num_ofdm_symbols=28,
                      knees=KNEES) == (128, "unroll")
    # coded lanes are transport blocks — symbol-count-independent
    assert auto_chunk("coded", 256, num_ofdm_symbols=28,
                      knees=KNEES) == (128, "scan")
    # knee-less pipelines and unknown names: always flat
    for p in ("siso", "spatial", "nonesuch"):
        assert auto_chunk(p, 4096, knees=KNEES) == (None, None)
    # unroll program-bloat cap: 4096/256 = 16 subgraphs -> grow the chunk
    # to the 8-chunk cap instead
    assert auto_chunk("sfbc", 4096, knees=KNEES) == (512, "unroll")
    # prime-ish lane count: nothing at/below the knee divides -> flat
    assert auto_chunk("sfbc", 509, knees=KNEES) == (None, None)
    assert auto_chunk("sfbc", 0, knees=KNEES) == (None, None)


@pytest.mark.parametrize("pipeline", ["siso", "simo", "sfbc", "spatial",
                                      "coded", "beamforming"])
def test_auto_chunk_flat_without_measured_knees(pipeline):
    """No knee has been measured on the card: the default table keeps
    every pipeline flat at any lane count."""
    assert auto_chunk(pipeline, 4096) == (None, None)
    fn = lambda k, b, s: b  # noqa: E731
    assert auto_lane_chunked(fn, pipeline, 4096) is fn


def test_auto_lane_chunked_wrapping():
    fn = lambda k, b, s: b  # noqa: E731
    # flat-policy pipelines return the function unchanged
    assert auto_lane_chunked(fn, "siso", 4096, knees=KNEES) is fn
    assert auto_lane_chunked(fn, "sfbc", 256, knees=KNEES) is fn
    # past the (symbol-scaled) knee: wraps and still runs correctly.
    # 14*64-symbol frames scale the sfbc knee down to 256*14//896 = 4,
    # so 8 lanes chunk as 2x4 without bench-scale compute.
    cfg = LTEConfig(bandwidth=1.25, modulation="QPSK")
    sim = lambda k, b, s: siso.simulate_siso(k, b, s, cfg)  # noqa: E731
    wrapped = auto_lane_chunked(sim, "sfbc", 8, num_ofdm_symbols=14 * 64,
                                knees=KNEES)
    assert wrapped is not sim
    n = siso.bits_per_frame(cfg, 14)
    bits = jnp.asarray(np.random.default_rng(7).integers(
        0, 2, (8, n)).astype(np.int32))
    r = wrapped(jax.random.PRNGKey(0), bits,
                jnp.full((8,), 60.0, jnp.float32))
    assert r.bit_errors.shape == (8,)
    assert int(jnp.sum(r.bit_errors)) == 0
