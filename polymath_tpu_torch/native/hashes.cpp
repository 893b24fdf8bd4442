// Native host primitives: Keccak-f[1600], Keccak-256, STROBE-128 (Merlin),
// BLAKE3 — the byte-exact Fiat-Shamir substrate (reference transcript/*.rs
// uses the merlin / sha3 / blake3 crates; SURVEY.md §2.2).
//
// Build: g++ -O3 -shared -fPIC -o libpolymath_native.so hashes.cpp pairing.cpp
// Exposed via ctypes (polymath_tpu/native/__init__.py), with the pure-Python
// implementations as fallback.

#include <cstdint>
#include <cstring>
#include <cstdlib>

extern "C" {

// ---------------------------------------------------------------------------
// Keccak-f[1600]
// ---------------------------------------------------------------------------

static const uint64_t KECCAK_RC[24] = {
    0x0000000000000001ULL, 0x0000000000008082ULL, 0x800000000000808AULL,
    0x8000000080008000ULL, 0x000000000000808BULL, 0x0000000080000001ULL,
    0x8000000080008081ULL, 0x8000000000008009ULL, 0x000000000000008AULL,
    0x0000000000000088ULL, 0x0000000080008009ULL, 0x000000008000000AULL,
    0x000000008000808BULL, 0x800000000000008BULL, 0x8000000000008089ULL,
    0x8000000000008003ULL, 0x8000000000008002ULL, 0x8000000000000080ULL,
    0x000000000000800AULL, 0x800000008000000AULL, 0x8000000080008081ULL,
    0x8000000000008080ULL, 0x0000000080000001ULL, 0x8000000080008008ULL,
};

static inline uint64_t rotl64(uint64_t v, unsigned n) {
    return (v << n) | (v >> (64 - n));
}

void pm_keccak_f1600(uint8_t state[200]) {
    uint64_t a[25];
    std::memcpy(a, state, 200);
    for (int rnd = 0; rnd < 24; rnd++) {
        uint64_t c[5], d[5];
        for (int x = 0; x < 5; x++)
            c[x] = a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20];
        for (int x = 0; x < 5; x++) {
            d[x] = c[(x + 4) % 5] ^ rotl64(c[(x + 1) % 5], 1);
            for (int y = 0; y < 5; y++) a[x + 5 * y] ^= d[x];
        }
        // rho + pi  (lane (x,y) at a[x + 5y]; b[y][(2x+3y)%5] = rot(a[x][y]))
        uint64_t b[25];
        static const unsigned ROT[5][5] = {
            {0, 36, 3, 41, 18}, {1, 44, 10, 45, 2}, {62, 6, 43, 15, 61},
            {28, 55, 25, 21, 56}, {27, 20, 39, 8, 14}};
        for (int x = 0; x < 5; x++)
            for (int y = 0; y < 5; y++)
                b[y + 5 * ((2 * x + 3 * y) % 5)] = rotl64(a[x + 5 * y], ROT[x][y]);
        for (int x = 0; x < 5; x++)
            for (int y = 0; y < 5; y++)
                a[x + 5 * y] =
                    b[x + 5 * y] ^ ((~b[(x + 1) % 5 + 5 * y]) & b[(x + 2) % 5 + 5 * y]);
        a[0] ^= KECCAK_RC[rnd];
    }
    std::memcpy(state, a, 200);
}

void pm_keccak256(const uint8_t* data, size_t len, uint8_t out[32]) {
    const size_t rate = 136;
    uint8_t state[200];
    std::memset(state, 0, sizeof(state));
    size_t off = 0;
    while (len - off >= rate) {
        for (size_t i = 0; i < rate; i++) state[i] ^= data[off + i];
        pm_keccak_f1600(state);
        off += rate;
    }
    // final partial block + pad (0x01 .. 0x80)
    uint8_t block[136];
    std::memset(block, 0, sizeof(block));
    std::memcpy(block, data + off, len - off);
    block[len - off] ^= 0x01;
    block[rate - 1] ^= 0x80;
    for (size_t i = 0; i < rate; i++) state[i] ^= block[i];
    pm_keccak_f1600(state);
    std::memcpy(out, state, 32);
}

// ---------------------------------------------------------------------------
// STROBE-128 (merlin flavor).  Blob layout: 200B state | pos | pos_begin |
// cur_flags | pad  (total 204 bytes).
// ---------------------------------------------------------------------------

static const uint8_t S_R = 166;
enum { F_I = 1, F_A = 2, F_C = 4, F_T = 8, F_M = 16, F_K = 32 };

struct Strobe {
    uint8_t* st;
    uint8_t* pos;
    uint8_t* pos_begin;
    uint8_t* cur_flags;
};

static inline Strobe view(uint8_t* blob) {
    return Strobe{blob, blob + 200, blob + 201, blob + 202};
}

static void s_run_f(Strobe s) {
    s.st[*s.pos] ^= *s.pos_begin;
    s.st[*s.pos + 1] ^= 0x04;
    s.st[S_R + 1] ^= 0x80;
    pm_keccak_f1600(s.st);
    *s.pos = 0;
    *s.pos_begin = 0;
}

static void s_absorb(Strobe s, const uint8_t* data, size_t len) {
    for (size_t i = 0; i < len; i++) {
        s.st[*s.pos] ^= data[i];
        (*s.pos)++;
        if (*s.pos == S_R) s_run_f(s);
    }
}

static void s_squeeze(Strobe s, uint8_t* out, size_t len) {
    for (size_t i = 0; i < len; i++) {
        out[i] = s.st[*s.pos];
        s.st[*s.pos] = 0;
        (*s.pos)++;
        if (*s.pos == S_R) s_run_f(s);
    }
}

static void s_begin_op(Strobe s, uint8_t flags, int more) {
    if (more) return;
    uint8_t old_begin = *s.pos_begin;
    *s.pos_begin = *s.pos + 1;
    *s.cur_flags = flags;
    uint8_t hdr[2] = {old_begin, flags};
    s_absorb(s, hdr, 2);
    if ((flags & (F_C | F_K)) && *s.pos != 0) s_run_f(s);
}

void pm_strobe_init(uint8_t* blob, const uint8_t* proto, size_t proto_len) {
    std::memset(blob, 0, 204);
    uint8_t* st = blob;
    const uint8_t init[18] = {1, (uint8_t)(S_R + 2), 1, 0, 1, 96,
                              'S', 'T', 'R', 'O', 'B', 'E',
                              'v', '1', '.', '0', '.', '2'};
    std::memcpy(st, init, 18);
    pm_keccak_f1600(st);
    Strobe s = view(blob);
    s_begin_op(s, F_M | F_A, 0);
    s_absorb(s, proto, proto_len);
}

void pm_strobe_meta_ad(uint8_t* blob, const uint8_t* data, size_t len, int more) {
    Strobe s = view(blob);
    s_begin_op(s, F_M | F_A, more);
    s_absorb(s, data, len);
}

void pm_strobe_ad(uint8_t* blob, const uint8_t* data, size_t len, int more) {
    Strobe s = view(blob);
    s_begin_op(s, F_A, more);
    s_absorb(s, data, len);
}

void pm_strobe_prf(uint8_t* blob, uint8_t* out, size_t len, int more) {
    Strobe s = view(blob);
    s_begin_op(s, F_I | F_A | F_C, more);
    s_squeeze(s, out, len);
}

// ---------------------------------------------------------------------------
// BLAKE3 (hash mode)
// ---------------------------------------------------------------------------

static const uint32_t B3_IV[8] = {0x6A09E667, 0xBB67AE85, 0x3C6EF372,
                                  0xA54FF53A, 0x510E527F, 0x9B05688C,
                                  0x1F83D9AB, 0x5BE0CD19};
static const int B3_PERM[16] = {2, 6, 3, 10, 7, 0, 4, 13,
                                1, 11, 12, 5, 9, 14, 15, 8};
enum { B3_CHUNK_START = 1, B3_CHUNK_END = 2, B3_PARENT = 4, B3_ROOT = 8 };

static inline uint32_t rotr32(uint32_t v, unsigned n) {
    return (v >> n) | (v << (32 - n));
}

static inline void b3_g(uint32_t* st, int a, int b, int c, int d,
                        uint32_t mx, uint32_t my) {
    st[a] = st[a] + st[b] + mx;
    st[d] = rotr32(st[d] ^ st[a], 16);
    st[c] = st[c] + st[d];
    st[b] = rotr32(st[b] ^ st[c], 12);
    st[a] = st[a] + st[b] + my;
    st[d] = rotr32(st[d] ^ st[a], 8);
    st[c] = st[c] + st[d];
    st[b] = rotr32(st[b] ^ st[c], 7);
}

static void b3_compress(const uint32_t cv[8], const uint32_t block[16],
                        uint64_t counter, uint32_t block_len, uint32_t flags,
                        uint32_t out[16]) {
    uint32_t st[16];
    for (int i = 0; i < 8; i++) st[i] = cv[i];
    for (int i = 0; i < 4; i++) st[8 + i] = B3_IV[i];
    st[12] = (uint32_t)counter;
    st[13] = (uint32_t)(counter >> 32);
    st[14] = block_len;
    st[15] = flags;
    uint32_t m[16];
    std::memcpy(m, block, 64);
    for (int r = 0; r < 7; r++) {
        b3_g(st, 0, 4, 8, 12, m[0], m[1]);
        b3_g(st, 1, 5, 9, 13, m[2], m[3]);
        b3_g(st, 2, 6, 10, 14, m[4], m[5]);
        b3_g(st, 3, 7, 11, 15, m[6], m[7]);
        b3_g(st, 0, 5, 10, 15, m[8], m[9]);
        b3_g(st, 1, 6, 11, 12, m[10], m[11]);
        b3_g(st, 2, 7, 8, 13, m[12], m[13]);
        b3_g(st, 3, 4, 9, 14, m[14], m[15]);
        if (r < 6) {
            uint32_t t[16];
            for (int i = 0; i < 16; i++) t[i] = m[B3_PERM[i]];
            std::memcpy(m, t, 64);
        }
    }
    for (int i = 0; i < 8; i++) out[i] = st[i] ^ st[i + 8];
    for (int i = 8; i < 16; i++) out[i] = st[i] ^ cv[i - 8];
}

// Process one chunk (<= 1024 B); writes the 8-word CV.  If `root_info` is
// non-null and this is the only chunk, stores (cv_in, block, block_len,
// flags) for the caller to re-run with ROOT.
struct B3Last {
    uint32_t cv[8];
    uint32_t block[16];
    uint32_t block_len;
    uint32_t flags;
};

static void b3_chunk(const uint8_t* data, size_t len, uint64_t counter,
                     uint32_t cv_out[8], B3Last* last) {
    uint32_t cv[8];
    std::memcpy(cv, B3_IV, 32);
    size_t nblocks = len == 0 ? 1 : (len + 63) / 64;
    for (size_t i = 0; i < nblocks; i++) {
        uint32_t flags = 0;
        if (i == 0) flags |= B3_CHUNK_START;
        if (i == nblocks - 1) flags |= B3_CHUNK_END;
        size_t blen = (i == nblocks - 1) ? len - 64 * i : 64;
        uint8_t buf[64];
        std::memset(buf, 0, 64);
        std::memcpy(buf, data + 64 * i, blen);
        uint32_t block[16];
        std::memcpy(block, buf, 64);
        if (last && i == nblocks - 1) {
            std::memcpy(last->cv, cv, 32);
            std::memcpy(last->block, block, 64);
            last->block_len = (uint32_t)blen;
            last->flags = flags;
        }
        uint32_t out[16];
        b3_compress(cv, block, counter, (uint32_t)blen, flags, out);
        std::memcpy(cv, out, 32);
    }
    std::memcpy(cv_out, cv, 32);
}

void pm_blake3(const uint8_t* data, size_t len, uint8_t out32[32]) {
    size_t nchunks = len == 0 ? 1 : (len + 1023) / 1024;
    if (nchunks == 1) {
        B3Last last;
        uint32_t cv[8];
        b3_chunk(data, len, 0, cv, &last);
        uint32_t out[16];
        b3_compress(last.cv, last.block, 0, last.block_len,
                    last.flags | B3_ROOT, out);
        std::memcpy(out32, out, 32);
        return;
    }
    uint32_t* cvs = (uint32_t*)std::malloc(nchunks * 32);
    for (size_t i = 0; i < nchunks; i++) {
        size_t clen = (i == nchunks - 1) ? len - 1024 * i : 1024;
        b3_chunk(data + 1024 * i, clen, (uint64_t)i, cvs + 8 * i, nullptr);
    }
    size_t cnt = nchunks;
    while (cnt > 2) {
        size_t next = 0;
        for (size_t i = 0; i + 1 < cnt; i += 2) {
            uint32_t block[16];
            std::memcpy(block, cvs + 8 * i, 32);
            std::memcpy(block + 8, cvs + 8 * (i + 1), 32);
            uint32_t out[16];
            b3_compress(B3_IV, block, 0, 64, B3_PARENT, out);
            std::memcpy(cvs + 8 * next, out, 32);
            next++;
        }
        if (cnt % 2) {
            std::memcpy(cvs + 8 * next, cvs + 8 * (cnt - 1), 32);
            next++;
        }
        cnt = next;
    }
    uint32_t block[16];
    std::memcpy(block, cvs, 32);
    std::memcpy(block + 8, cvs + 8, 32);
    uint32_t out[16];
    b3_compress(B3_IV, block, 0, 64, B3_PARENT | B3_ROOT, out);
    std::memcpy(out32, out, 32);
    std::free(cvs);
}

}  // extern "C"
