"""Multi-host initialization and sharded-sweep scaling helpers.

The reference has no distributed backend of any kind (SURVEY §5) — its only
concurrency is a thread pool. Here:

- `initialize(...)`: jax.distributed bring-up with retry (the only
  failure-recovery surface this workload needs — Monte-Carlo sweeps are
  stateless, so a failed host simply re-runs its shard)
- `global_mesh(...)`: a 1-D Monte-Carlo mesh over every device of every
  host; the sharded sweep in parallel.sweep then spans hosts unchanged
- `scaling_efficiency(...)`: samples/s scaling measurement across mesh sizes
  (the driver's ≥85% target, BASELINE.md)
"""
from __future__ import annotations

import time
from typing import Dict, Sequence

import numpy as np
import jax

from .sweep import make_mesh, ber_sweep


def initialize(coordinator_address: str = None, num_processes: int = None,
               process_id: int = None, retries: int = 3,
               retry_delay_s: float = 5.0) -> None:
    """jax.distributed.initialize with simple retry. No-op for single host
    (all-None arguments on a single process)."""
    if coordinator_address is None and num_processes in (None, 1):
        return
    last = None
    for _ in range(retries):
        try:
            jax.distributed.initialize(
                coordinator_address=coordinator_address,
                num_processes=num_processes, process_id=process_id)
            return
        except Exception as e:  # pragma: no cover - needs real multi-host
            last = e
            time.sleep(retry_delay_s)
    raise RuntimeError(f"jax.distributed.initialize failed: {last}")


def global_mesh(axis_name: str = "mc"):
    """Mesh over all devices visible to this process group (multi-host:
    jax.devices() already spans hosts after initialize())."""
    return make_mesh(jax.devices(), axis_name)


def scaling_efficiency(config, device_counts: Sequence[int],
                       frames_per_device: int = 8,
                       num_ofdm_symbols: int = 14,
                       snr_db: float = 10.0, n_steps: int = 3) -> Dict:
    """Measure samples/s on meshes of increasing size; efficiency is
    throughput per device normalized to the smallest mesh."""
    results = {}
    base_rate = None
    for n in device_counts:
        devs = jax.devices()[:n]
        if len(devs) < n:
            break
        mesh = make_mesh(devs)
        key = jax.random.PRNGKey(0)
        # warmup/compile
        r = ber_sweep(key, config, [snr_db],
                      frames_per_device=frames_per_device,
                      num_ofdm_symbols=num_ofdm_symbols, mesh=mesh)
        jax.block_until_ready(r.ber)
        # best-of-n steps: min dt is robust against host scheduling noise
        # (the virtual CPU mesh multiplexes devices onto few cores, so a
        # mean absorbs GC pauses and dispatch jitter into the "scaling")
        dt = float("inf")
        for i in range(n_steps):
            t0 = time.perf_counter()
            r = ber_sweep(jax.random.fold_in(key, i), config, [snr_db],
                          frames_per_device=frames_per_device,
                          num_ofdm_symbols=num_ofdm_symbols, mesh=mesh)
            jax.block_until_ready(r.ber)
            dt = min(dt, time.perf_counter() - t0)
        frames = frames_per_device * n
        rate_per_dev = frames / dt / n
        if base_rate is None:
            base_rate = rate_per_dev
        results[n] = {
            "frames_per_s": frames / dt,
            "per_device": rate_per_dev,
            "efficiency": rate_per_dev / base_rate,
        }
    return results
