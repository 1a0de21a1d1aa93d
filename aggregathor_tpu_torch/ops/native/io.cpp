// Native TFRecord framing: CRC32C and record indexing/verification.
//
// The reference's input path runs multi-threaded fetchers over TFRecord
// shards inside the TF runtime (reference: experiments/cnnet.py:115-146,
// nb-fetcher-threads / nb-batcher-threads); this framework's equivalent is a
// host-native scanner: slice-by-8 CRC32C (Castagnoli, the TFRecord checksum)
// plus a framing walker that indexes every record in a memory-mapped shard
// and verifies all checksums in parallel on the shared thread pool.  The
// Python tier (models/tfrecord.py) falls back to its pure-Python
// implementation when this library cannot build.

#include <cstdint>
#include <cstring>

#include "threadpool.hpp"

namespace {

// Slice-by-8 CRC32C tables, built once at first use.
struct Crc32cTables {
  std::uint32_t t[8][256];
  Crc32cTables() {
    const std::uint32_t poly = 0x82F63B78u;  // reflected Castagnoli
    for (std::uint32_t i = 0; i < 256; ++i) {
      std::uint32_t crc = i;
      for (int k = 0; k < 8; ++k) crc = (crc >> 1) ^ ((crc & 1) ? poly : 0);
      t[0][i] = crc;
    }
    for (int s = 1; s < 8; ++s) {
      for (std::uint32_t i = 0; i < 256; ++i) {
        t[s][i] = (t[s - 1][i] >> 8) ^ t[0][t[s - 1][i] & 0xFF];
      }
    }
  }
};

const Crc32cTables& Tables() {
  static Crc32cTables tables;
  return tables;
}

std::uint32_t Crc32c(const std::uint8_t* data, std::size_t len) {
  const auto& tb = Tables();
  std::uint32_t crc = 0xFFFFFFFFu;
  while (len >= 8) {
    std::uint64_t word;
    std::memcpy(&word, data, 8);  // little-endian hosts (x86/ARM/TPU-host)
    word ^= crc;
    crc = tb.t[7][word & 0xFF] ^ tb.t[6][(word >> 8) & 0xFF] ^
          tb.t[5][(word >> 16) & 0xFF] ^ tb.t[4][(word >> 24) & 0xFF] ^
          tb.t[3][(word >> 32) & 0xFF] ^ tb.t[2][(word >> 40) & 0xFF] ^
          tb.t[1][(word >> 48) & 0xFF] ^ tb.t[0][(word >> 56) & 0xFF];
    data += 8;
    len -= 8;
  }
  while (len--) crc = tb.t[0][(crc ^ *data++) & 0xFF] ^ (crc >> 8);
  return crc ^ 0xFFFFFFFFu;
}

std::uint32_t MaskedCrc(const std::uint8_t* data, std::size_t len) {
  const std::uint32_t crc = Crc32c(data, len);
  return ((crc >> 15) | (crc << 17)) + 0xA282EAD8u;
}

std::uint32_t LoadU32(const std::uint8_t* p) {
  std::uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
}

std::uint64_t LoadU64(const std::uint8_t* p) {
  std::uint64_t v;
  std::memcpy(&v, p, 8);
  return v;
}

}  // namespace

extern "C" {

std::uint32_t agtpu_crc32c(const std::uint8_t* data, std::size_t len) {
  return Crc32c(data, len);
}

// Walk the TFRecord framing of `buf` (a whole mapped shard), writing each
// record's payload offset/length into `offsets`/`lengths` (capacity
// `max_records`).  When `verify` is nonzero, every length and payload CRC is
// checked — payload checks run in parallel on the shared pool.  Returns the
// record count, or -(1 + byte_offset) at the first framing/CRC error.
std::int64_t agtpu_tfrecord_index(const std::uint8_t* buf, std::int64_t len,
                                  std::int64_t* offsets, std::int64_t* lengths,
                                  std::int64_t max_records, int verify) {
  std::int64_t count = 0;
  std::int64_t pos = 0;
  while (pos < len) {
    if (pos + 12 > len || count >= max_records) return -(1 + pos);
    const std::uint64_t rec_len = LoadU64(buf + pos);
    if (verify && MaskedCrc(buf + pos, 8) != LoadU32(buf + pos + 8)) {
      return -(1 + pos);
    }
    const std::int64_t payload = pos + 12;
    // Unsigned bounds check: rec_len is untrusted 64-bit input, and casting
    // a huge value to int64 would overflow the naive `payload + rec_len + 4
    // > len` comparison (UB) and walk out of the buffer.
    const std::uint64_t remaining = static_cast<std::uint64_t>(len - payload);
    if (remaining < 4 || rec_len > remaining - 4) return -(1 + pos);
    offsets[count] = payload;
    lengths[count] = static_cast<std::int64_t>(rec_len);
    ++count;
    pos = payload + static_cast<std::int64_t>(rec_len) + 4;
  }
  if (verify && count > 0) {
    // Payload CRCs dominate the scan cost (the whole file is hashed once);
    // verify records in parallel, recording the first failing offset.
    std::int64_t bad = -1;
    std::mutex mu;
    agtpu::ParallelFor(0, count, [&](std::int64_t lo, std::int64_t hi) {
      for (std::int64_t i = lo; i < hi; ++i) {
        const std::uint8_t* payload = buf + offsets[i];
        const std::uint32_t want = LoadU32(payload + lengths[i]);
        if (MaskedCrc(payload, static_cast<std::size_t>(lengths[i])) != want) {
          std::lock_guard<std::mutex> lock(mu);
          if (bad < 0 || offsets[i] < bad) bad = offsets[i];
        }
      }
    });
    if (bad >= 0) return -(1 + bad);
  }
  return count;
}

}  // extern "C"
