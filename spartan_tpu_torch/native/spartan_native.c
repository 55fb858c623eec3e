/* Native host-side kernels for spartan_tpu_torch.
 *
 * The GPU handles all large field/curve math; these cover the host-sequential
 * paths that pure Python makes slow at keyless scale:
 *   - keccak_f1600: the STROBE/merlin transcript permutation (thousands of
 *     calls per proof; replaces spartan_tpu_torch/ops/keccak.py's Python loop)
 *   - strobe_absorb: STROBE's absorb of a long message (the NIZK's shape
 *     digest, tens of MB) in one call instead of a Python step a block
 *   - r1cs_count / r1cs_parse: the circom .r1cs constraints section
 *     (7.1M variable-length records for the keyless circuit)
 *
 * Built by spartan_tpu_torch/native/__init__.py with the system compiler into a
 * shared library, loaded via ctypes; Python fallbacks stay in place.
 */

#include <stdint.h>
#include <string.h>

#define EXPORT __attribute__((visibility("default")))

/* ------------------------------------------------------------------ */
/* Keccak-f[1600]                                                      */
/* ------------------------------------------------------------------ */

static const uint64_t RC[24] = {
    0x0000000000000001ULL, 0x0000000000008082ULL, 0x800000000000808aULL,
    0x8000000080008000ULL, 0x000000000000808bULL, 0x0000000080000001ULL,
    0x8000000080008081ULL, 0x8000000000008009ULL, 0x000000000000008aULL,
    0x0000000000000088ULL, 0x0000000080008009ULL, 0x000000008000000aULL,
    0x000000008000808bULL, 0x800000000000008bULL, 0x8000000000008089ULL,
    0x8000000000008003ULL, 0x8000000000008002ULL, 0x8000000000000080ULL,
    0x000000000000800aULL, 0x800000008000000aULL, 0x8000000080008081ULL,
    0x8000000000008080ULL, 0x0000000080000001ULL, 0x8000000080008008ULL};

static const int ROT[5][5] = {
    {0, 36, 3, 41, 18},
    {1, 44, 10, 45, 2},
    {62, 6, 43, 15, 61},
    {28, 55, 25, 21, 56},
    {27, 20, 39, 8, 14}};

static inline uint64_t rol(uint64_t v, int n) {
    n &= 63;
    return n ? (v << n) | (v >> (64 - n)) : v;
}

/* The permutation on 25 lanes, A[x + 5y] indexing */
static inline void keccak_p(uint64_t a[25]) {
    uint64_t b[25], c[5], d[5];
    for (int round = 0; round < 24; round++) {
        for (int x = 0; x < 5; x++)
            c[x] = a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20];
        for (int x = 0; x < 5; x++)
            d[x] = c[(x + 4) % 5] ^ rol(c[(x + 1) % 5], 1);
        for (int x = 0; x < 5; x++)
            for (int y = 0; y < 5; y++)
                a[x + 5 * y] ^= d[x];
        for (int x = 0; x < 5; x++)
            for (int y = 0; y < 5; y++)
                b[y + 5 * ((2 * x + 3 * y) % 5)] = rol(a[x + 5 * y], ROT[x][y]);
        for (int x = 0; x < 5; x++)
            for (int y = 0; y < 5; y++)
                a[x + 5 * y] = b[x + 5 * y] ^ ((~b[(x + 1) % 5 + 5 * y]) & b[(x + 2) % 5 + 5 * y]);
        a[0] ^= RC[round];
    }
}

/* state: 200 bytes, little-endian lanes */
EXPORT void keccak_f1600(uint8_t *state) {
    uint64_t a[25];
    memcpy(a, state, 200);
    keccak_p(a);
    memcpy(state, a, 200);
}

/* ------------------------------------------------------------------ */
/* STROBE-128 absorb of a whole message                                */
/* ------------------------------------------------------------------ */

#define STROBE_R 166

/* utils/strobe.py's Strobe128._absorb in one call: XOR each run up to the
 * rate boundary into the state, and at the boundary run _run_f's framing
 * (state[pos] ^= pos_begin, state[pos + 1] ^= 0x04, state[R + 1] ^= 0x80),
 * permute and restart at pos = pos_begin = 0; a trailing partial block stays
 * XORed in. The state is held as lanes for the whole message. Returns the
 * new pos | pos_begin << 8 (pos < 166, pos_begin <= 166). */
EXPORT uint32_t strobe_absorb(uint8_t *state, uint32_t pos, uint32_t pos_begin,
                              const uint8_t *data, uint64_t len) {
    uint64_t a[25];
    uint8_t *st = (uint8_t *)a;
    memcpy(a, state, 200);
    while (len) {
        uint64_t take = STROBE_R - pos;
        if (take > len) take = len;
        if (pos == 0 && take == STROBE_R) {
            /* a whole block: 20 lanes and the low 6 bytes of lane 20 */
            for (int i = 0; i < 20; i++) {
                uint64_t w;
                memcpy(&w, data + 8 * i, 8);
                a[i] ^= w;
            }
            uint64_t w = 0;
            memcpy(&w, data + 160, STROBE_R - 160);
            a[20] ^= w;
        } else {
            for (uint64_t i = 0; i < take; i++) st[pos + i] ^= data[i];
        }
        pos += take;
        data += take;
        len -= take;
        if (pos == STROBE_R) {
            st[pos] ^= (uint8_t)pos_begin;
            st[pos + 1] ^= 0x04;
            st[STROBE_R + 1] ^= 0x80;
            keccak_p(a);
            pos = pos_begin = 0;
        }
    }
    memcpy(state, a, 200);
    return pos | (pos_begin << 8);
}

/* ------------------------------------------------------------------ */
/* circom .r1cs constraints section                                    */
/* ------------------------------------------------------------------ */

static inline uint32_t rd_u32(const uint8_t *p) {
    uint32_t v;
    memcpy(&v, p, 4);
    return v; /* little-endian hosts only (x86/ARM) */
}

/* First pass: count total entries across all three matrices.
 * Returns total entries, or -1 if the buffer is truncated. */
EXPORT int64_t r1cs_count(const uint8_t *data, uint64_t len, uint64_t off,
                          uint32_t num_constraints, uint32_t field_size,
                          int64_t *counts /* [3] per-matrix counts */) {
    uint64_t pos = off;
    int64_t total = 0;
    counts[0] = counts[1] = counts[2] = 0;
    for (uint32_t row = 0; row < num_constraints; row++) {
        for (int m = 0; m < 3; m++) {
            if (pos + 4 > len) return -1;
            uint32_t n = rd_u32(data + pos);
            pos += 4;
            uint64_t rec = (uint64_t)(4 + field_size) * n;
            if (pos + rec > len) return -1;
            pos += rec;
            counts[m] += n;
            total += n;
        }
    }
    return total;
}

/* Second pass: fill per-matrix (row, col) int64 arrays and raw 32-byte
 * value buffers (values copied verbatim; canonicality checked in Python
 * via vectorized numpy). Arrays must be sized from r1cs_count. */
EXPORT int64_t r1cs_parse(const uint8_t *data, uint64_t len, uint64_t off,
                          uint32_t num_constraints, uint32_t field_size,
                          int64_t *rows_a, int64_t *cols_a, uint8_t *vals_a,
                          int64_t *rows_b, int64_t *cols_b, uint8_t *vals_b,
                          int64_t *rows_c, int64_t *cols_c, uint8_t *vals_c) {
    uint64_t pos = off;
    int64_t *rows[3] = {rows_a, rows_b, rows_c};
    int64_t *cols[3] = {cols_a, cols_b, cols_c};
    uint8_t *vals[3] = {vals_a, vals_b, vals_c};
    int64_t idx[3] = {0, 0, 0};
    for (uint32_t row = 0; row < num_constraints; row++) {
        for (int m = 0; m < 3; m++) {
            if (pos + 4 > len) return -1;
            uint32_t n = rd_u32(data + pos);
            pos += 4;
            for (uint32_t k = 0; k < n; k++) {
                if (pos + 4 + field_size > len) return -1;
                rows[m][idx[m]] = row;
                cols[m][idx[m]] = rd_u32(data + pos);
                memcpy(vals[m] + idx[m] * field_size, data + pos + 4, field_size);
                idx[m]++;
                pos += 4 + field_size;
            }
        }
    }
    return idx[0] + idx[1] + idx[2];
}
