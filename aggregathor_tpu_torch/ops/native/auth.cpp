// Host-side gradient authentication: SHA-256 + HMAC-SHA256 (RFC 6234/2104).
//
// The reference authenticates worker->PS tensor pushes with libsodium ed25519
// signatures inside the patched UDP rendezvous
// (tf_patches/patches/mpi_rendezvous_mgr.patch:585-627, verification at
// 777-781, 1057-1064). In the TPU-native design the on-chip path (ICI/DCN
// collectives) is trusted hardware, so authentication moves to the host
// boundary: multi-host coordination RPCs and checkpoint blobs are tagged with
// HMAC-SHA256 under per-worker shared keys — symmetric instead of asymmetric
// because the single controller already holds every worker's identity (there
// is no third-party verification need). Off the hot path by design, exactly
// like the reference's signatures (they ride the metadata side channel).
//
// SHA-256 implemented directly from the FIPS 180-4 specification.

#include <cstdint>
#include <cstring>

namespace {

struct Sha256 {
    uint32_t state[8];
    uint64_t length;     // total bytes absorbed
    uint8_t buffer[64];
    size_t fill;

    static constexpr uint32_t K[64] = {
        0x428a2f98u, 0x71374491u, 0xb5c0fbcfu, 0xe9b5dba5u, 0x3956c25bu, 0x59f111f1u,
        0x923f82a4u, 0xab1c5ed5u, 0xd807aa98u, 0x12835b01u, 0x243185beu, 0x550c7dc3u,
        0x72be5d74u, 0x80deb1feu, 0x9bdc06a7u, 0xc19bf174u, 0xe49b69c1u, 0xefbe4786u,
        0x0fc19dc6u, 0x240ca1ccu, 0x2de92c6fu, 0x4a7484aau, 0x5cb0a9dcu, 0x76f988dau,
        0x983e5152u, 0xa831c66du, 0xb00327c8u, 0xbf597fc7u, 0xc6e00bf3u, 0xd5a79147u,
        0x06ca6351u, 0x14292967u, 0x27b70a85u, 0x2e1b2138u, 0x4d2c6dfcu, 0x53380d13u,
        0x650a7354u, 0x766a0abbu, 0x81c2c92eu, 0x92722c85u, 0xa2bfe8a1u, 0xa81a664bu,
        0xc24b8b70u, 0xc76c51a3u, 0xd192e819u, 0xd6990624u, 0xf40e3585u, 0x106aa070u,
        0x19a4c116u, 0x1e376c08u, 0x2748774cu, 0x34b0bcb5u, 0x391c0cb3u, 0x4ed8aa4au,
        0x5b9cca4fu, 0x682e6ff3u, 0x748f82eeu, 0x78a5636fu, 0x84c87814u, 0x8cc70208u,
        0x90befffau, 0xa4506cebu, 0xbef9a3f7u, 0xc67178f2u,
    };

    void init() {
        static constexpr uint32_t iv[8] = {
            0x6a09e667u, 0xbb67ae85u, 0x3c6ef372u, 0xa54ff53au,
            0x510e527fu, 0x9b05688cu, 0x1f83d9abu, 0x5be0cd19u,
        };
        std::memcpy(state, iv, sizeof(iv));
        length = 0;
        fill = 0;
    }

    static uint32_t rotr(uint32_t x, unsigned n) { return (x >> n) | (x << (32 - n)); }

    void compress(uint8_t const* block) {
        uint32_t w[64];
        for (int i = 0; i < 16; ++i) {
            w[i] = (uint32_t(block[4 * i]) << 24) | (uint32_t(block[4 * i + 1]) << 16) |
                   (uint32_t(block[4 * i + 2]) << 8) | uint32_t(block[4 * i + 3]);
        }
        for (int i = 16; i < 64; ++i) {
            uint32_t const s0 = rotr(w[i - 15], 7) ^ rotr(w[i - 15], 18) ^ (w[i - 15] >> 3);
            uint32_t const s1 = rotr(w[i - 2], 17) ^ rotr(w[i - 2], 19) ^ (w[i - 2] >> 10);
            w[i] = w[i - 16] + s0 + w[i - 7] + s1;
        }
        uint32_t a = state[0], b = state[1], c = state[2], d = state[3];
        uint32_t e = state[4], f = state[5], g = state[6], h = state[7];
        for (int i = 0; i < 64; ++i) {
            uint32_t const s1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
            uint32_t const ch = (e & f) ^ (~e & g);
            uint32_t const t1 = h + s1 + ch + K[i] + w[i];
            uint32_t const s0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
            uint32_t const maj = (a & b) ^ (a & c) ^ (b & c);
            uint32_t const t2 = s0 + maj;
            h = g; g = f; f = e; e = d + t1;
            d = c; c = b; b = a; a = t1 + t2;
        }
        state[0] += a; state[1] += b; state[2] += c; state[3] += d;
        state[4] += e; state[5] += f; state[6] += g; state[7] += h;
    }

    void update(uint8_t const* data, size_t len) {
        length += len;
        while (len > 0) {
            size_t const take = len < (64 - fill) ? len : (64 - fill);
            std::memcpy(buffer + fill, data, take);
            fill += take;
            data += take;
            len -= take;
            if (fill == 64) {
                compress(buffer);
                fill = 0;
            }
        }
    }

    void final(uint8_t out[32]) {
        uint64_t const bits = length * 8;
        uint8_t const pad = 0x80;
        update(&pad, 1);
        uint8_t const zero = 0x00;
        while (fill != 56) update(&zero, 1);
        uint8_t len_be[8];
        for (int i = 0; i < 8; ++i) len_be[i] = uint8_t(bits >> (56 - 8 * i));
        update(len_be, 8);
        for (int i = 0; i < 8; ++i) {
            out[4 * i] = uint8_t(state[i] >> 24);
            out[4 * i + 1] = uint8_t(state[i] >> 16);
            out[4 * i + 2] = uint8_t(state[i] >> 8);
            out[4 * i + 3] = uint8_t(state[i]);
        }
    }
};

constexpr uint32_t Sha256::K[64];

void hmac_sha256(uint8_t const* key, size_t keylen, uint8_t const* data, size_t len,
                 uint8_t out[32]) {
    uint8_t kblock[64] = {0};
    if (keylen > 64) {
        Sha256 kh;
        kh.init();
        kh.update(key, keylen);
        kh.final(kblock);  // first 32 bytes; rest stay zero
    } else {
        std::memcpy(kblock, key, keylen);
    }
    uint8_t ipad[64], opad[64];
    for (int i = 0; i < 64; ++i) {
        ipad[i] = kblock[i] ^ 0x36;
        opad[i] = kblock[i] ^ 0x5c;
    }
    uint8_t inner[32];
    Sha256 h;
    h.init();
    h.update(ipad, 64);
    h.update(data, len);
    h.final(inner);
    h.init();
    h.update(opad, 64);
    h.update(inner, 32);
    h.final(out);
}

}  // namespace

extern "C" {

void agtpu_sha256(uint8_t const* data, size_t len, uint8_t* out32) {
    Sha256 h;
    h.init();
    h.update(data, len);
    h.final(out32);
}

void agtpu_hmac_sha256(uint8_t const* key, size_t keylen, uint8_t const* data, size_t len,
                       uint8_t* out32) {
    hmac_sha256(key, keylen, data, len, out32);
}

// Constant-time tag comparison: 1 = match, 0 = mismatch.
int agtpu_hmac_verify(uint8_t const* key, size_t keylen, uint8_t const* data, size_t len,
                      uint8_t const* tag32) {
    uint8_t expect[32];
    hmac_sha256(key, keylen, data, len, expect);
    unsigned diff = 0;
    for (int i = 0; i < 32; ++i) diff |= unsigned(expect[i] ^ tag32[i]);
    return diff == 0 ? 1 : 0;
}

}  // extern "C"
