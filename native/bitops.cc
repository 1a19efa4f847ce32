// Native host-side data-path kernels for ofdm_lte_tpu.
//
// The device owns the compute path (JAX/XLA); this library owns the host data
// path that feeds it: bit (un)packing for the image/transport-block
// pipelines and table-driven CRC over megabit messages (the reference does
// both with per-bit Python big-int arithmetic,
// /root/reference/core/channel_coding/crc.py:89-134).
//
// Exposed as a plain C ABI consumed through ctypes (no pybind11 in this
// environment). Build: make -C native  (or ofdm_lte_tpu.native_ext builds it
// on demand).

#include <cstdint>
#include <cstring>

extern "C" {

// Pack bits (one per byte, MSB-first within each output byte) into bytes.
// n_bits need not be a multiple of 8; the tail is zero-padded.
void olt_pack_bits(const uint8_t* bits, int64_t n_bits, uint8_t* out) {
    int64_t n_bytes = (n_bits + 7) / 8;
    std::memset(out, 0, static_cast<size_t>(n_bytes));
    for (int64_t i = 0; i < n_bits; ++i) {
        out[i >> 3] = static_cast<uint8_t>(
            out[i >> 3] | ((bits[i] & 1) << (7 - (i & 7))));
    }
}

// Unpack bytes to bits (one per byte, MSB-first).
void olt_unpack_bits(const uint8_t* bytes, int64_t n_bits, uint8_t* out) {
    for (int64_t i = 0; i < n_bits; ++i) {
        out[i] = (bytes[i >> 3] >> (7 - (i & 7))) & 1;
    }
}

// Table-driven CRC over an MSB-first bit array. poly includes the leading
// x^nbits term (e.g. 0x1864CFB for CRC-24A). Returns the register value.
uint32_t olt_crc_bits(const uint8_t* bits, int64_t n_bits, uint32_t poly,
                      int nbits) {
    const uint32_t mask = (nbits >= 32) ? 0xFFFFFFFFu
                                        : ((1u << nbits) - 1u);
    const uint32_t top = 1u << (nbits - 1);

    uint32_t table[256];
    for (uint32_t b = 0; b < 256; ++b) {
        uint32_t reg = b << (nbits - 8);
        for (int k = 0; k < 8; ++k) {
            reg = (reg & top) ? (((reg << 1) ^ poly) & mask)
                              : ((reg << 1) & mask);
        }
        table[b] = reg;
    }

    // process whole bytes; leading zero-pad preserves MSB-first CRCs
    int64_t pad = (8 - (n_bits & 7)) & 7;
    uint32_t reg = 0;
    uint32_t cur = 0;
    int have = static_cast<int>(pad);
    for (int64_t i = 0; i < n_bits; ++i) {
        cur = (cur << 1) | (bits[i] & 1);
        if (++have == 8) {
            uint32_t idx = ((reg >> (nbits - 8)) ^ cur) & 0xFFu;
            reg = ((reg << 8) ^ table[idx]) & mask;
            cur = 0;
            have = 0;
        }
    }
    return reg;
}

// Bit-error count between two bit arrays.
int64_t olt_bit_errors(const uint8_t* a, const uint8_t* b, int64_t n) {
    int64_t e = 0;
    for (int64_t i = 0; i < n; ++i) e += (a[i] ^ b[i]) & 1;
    return e;
}

}  // extern "C"
