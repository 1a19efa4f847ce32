"""CRC-24A / CRC-24B / CRC-16 (3GPP TS 36.212 §5.1.1).

Polynomials identical to /root/reference/core/channel_coding/crc.py:38-46.
The reference computes CRCs by big-integer long division over the whole
message (crc.py:89-134); here:

- host path: byte-table-driven CRC over packed bits (numpy) — O(n/8) table
  lookups instead of O(n) Python big-int steps;
- in-graph path: CRC is GF(2)-linear, so for a static message length n the
  checksum is (bits @ M) mod 2 with a precomputed (n, nbits) 0/1 matrix —
  one f32 matmul (exact: row sums < 2^24).
"""
from __future__ import annotations

import functools

import numpy as np
import jax.numpy as jnp

CRC24A_POLY = 0x1864CFB
CRC24B_POLY = 0x1800063
CRC16_POLY = 0x11021


@functools.lru_cache(maxsize=None)
def _byte_table(poly: int, nbits: int) -> np.ndarray:
    """256-entry table: state-update for one input byte (MSB-first)."""
    table = np.zeros(256, np.uint32)
    top = 1 << (nbits - 1)
    mask = (1 << nbits) - 1
    for b in range(256):
        reg = b << (nbits - 8)
        for _ in range(8):
            if reg & top:
                reg = ((reg << 1) ^ poly) & mask
            else:
                reg = (reg << 1) & mask
        table[b] = reg
    return table


def crc_bits(data_bits: np.ndarray, poly: int, nbits: int) -> np.ndarray:
    """CRC of a bit array (MSB-first), returns nbits bits.

    Uses the native C library when available (megabit transport blocks);
    NumPy byte-table fallback otherwise."""
    data_bits = np.asarray(data_bits, np.uint8)
    n = len(data_bits)

    try:
        from .. import native_ext
        if native_ext.available():
            reg = native_ext.crc_register(data_bits, poly, nbits)
            return _reg_to_bits(reg, nbits)
    except Exception:
        pass
    return _crc_bits_numpy(data_bits, poly, nbits)


def _reg_to_bits(reg: int, nbits: int) -> np.ndarray:
    out = np.zeros(nbits, np.uint8)
    for i in range(nbits):
        out[nbits - 1 - i] = (int(reg) >> i) & 1
    return out


def _crc_bits_numpy(data_bits: np.ndarray, poly: int, nbits: int) -> np.ndarray:
    """Byte-table NumPy CRC (fallback / ground truth for the native path)."""
    data_bits = np.asarray(data_bits, np.uint8)
    n = len(data_bits)
    # pad to byte multiple at the FRONT with zeros (leading zeros do not
    # change the CRC of an MSB-first message)
    pad = (-n) % 8
    padded = np.concatenate([np.zeros(pad, np.uint8), data_bits])
    by = np.packbits(padded)
    table = _byte_table(poly, nbits)
    reg = np.uint32(0)
    shift = nbits - 8
    mask = (1 << nbits) - 1
    for b in by:
        idx = ((reg >> shift) ^ b) & 0xFF
        reg = ((reg << 8) ^ table[idx]) & mask
    return _reg_to_bits(int(reg), nbits)


def calculate_crc24a(bits) -> np.ndarray:
    return crc_bits(bits, CRC24A_POLY, 24)


def calculate_crc24b(bits) -> np.ndarray:
    return crc_bits(bits, CRC24B_POLY, 24)


def calculate_crc16(bits) -> np.ndarray:
    return crc_bits(bits, CRC16_POLY, 16)


def attach_crc24a(bits) -> np.ndarray:
    return np.concatenate([np.asarray(bits, np.uint8), calculate_crc24a(bits)])


def attach_crc24b(bits) -> np.ndarray:
    return np.concatenate([np.asarray(bits, np.uint8), calculate_crc24b(bits)])


def attach_crc16(bits) -> np.ndarray:
    return np.concatenate([np.asarray(bits, np.uint8), calculate_crc16(bits)])


def check_crc24a(bits_with_crc) -> bool:
    b = np.asarray(bits_with_crc, np.uint8)
    return bool(np.array_equal(calculate_crc24a(b[:-24]), b[-24:]))


def check_crc24b(bits_with_crc) -> bool:
    b = np.asarray(bits_with_crc, np.uint8)
    return bool(np.array_equal(calculate_crc24b(b[:-24]), b[-24:]))


def check_crc16(bits_with_crc) -> bool:
    b = np.asarray(bits_with_crc, np.uint8)
    return bool(np.array_equal(calculate_crc16(b[:-16]), b[-16:]))


# ---------------------------------------------------------------------------
# In-graph CRC: (bits @ M) mod 2 for static n
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def crc_matrix(n: int, poly: int = CRC24A_POLY, nbits: int = 24) -> np.ndarray:
    """M (n, nbits) float32 0/1 such that crc = (bits @ M) mod 2.

    Row i is the CRC contribution of message bit i: x^(n-1-i+nbits) mod g.
    Built by one linear sweep of the shift recurrence (cached per length).
    """
    mask = (1 << nbits) - 1
    top = 1 << (nbits - 1)
    M = np.zeros((n, nbits), np.float32)
    # r = x^nbits mod g  for the last message bit, then shift upward
    r = poly & mask  # x^nbits mod g (since g = x^nbits + (poly & mask))
    for i in range(n - 1, -1, -1):
        for b in range(nbits):
            M[i, nbits - 1 - b] = (r >> b) & 1
        # r <- x·r mod g
        if r & top:
            r = ((r << 1) ^ poly) & mask
        else:
            r = (r << 1) & mask
    return M


def crc_jax(bits: jnp.ndarray, poly: int = CRC24A_POLY,
            nbits: int = 24) -> jnp.ndarray:
    """In-graph CRC for fixed-length messages: (..., n) int -> (..., nbits)."""
    n = bits.shape[-1]
    M = jnp.asarray(crc_matrix(n, poly, nbits))
    acc = jnp.matmul(bits.astype(jnp.float32), M,
                     preferred_element_type=jnp.float32)
    return jnp.mod(acc, 2.0).astype(jnp.int32)
