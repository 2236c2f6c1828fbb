// Parallel BGZF decompression for BAM/TFRecord-style gzip-block files.
//
// The reference stack leans on pysam/htslib (C) for BAM I/O; this is the
// framework's native equivalent: BGZF files are sequences of independent
// gzip members, so blocks decompress in parallel across a thread pool.
// Exposed through a minimal C ABI for ctypes (no pybind11 dependency).
//
// Built at first use by native/__init__.py:
//   g++ -O3 -shared -fPIC -std=c++17 bgzf.cpp -o build/native/libdcnative-<hash>.so -lz -lpthread

#include <climits>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <atomic>
#include <thread>
#include <vector>

#include <zlib.h>

namespace {

struct Block {
  size_t in_offset;   // offset of compressed payload (past header)
  size_t in_size;     // compressed payload size (without header/footer)
  size_t out_offset;  // offset in the output buffer
  size_t out_size;    // isize from the gzip footer
  uint32_t crc;       // crc32 from the gzip footer
};

// Parses BGZF block boundaries. Returns false on malformed input.
bool scan_blocks(const uint8_t* data, size_t len, std::vector<Block>* blocks,
                 size_t* total_out) {
  size_t pos = 0;
  size_t out = 0;
  while (pos + 18 <= len) {
    if (data[pos] != 0x1f || data[pos + 1] != 0x8b) return false;
    // BGZF fixes CM=8 (deflate) and FLG=4 (FEXTRA only).  Any other
    // FLG bits change the gzip member layout, which the pure-Python
    // fallback would parse differently — reject rather than diverge.
    if (data[pos + 2] != 8) return false;
    if (data[pos + 3] != 4) return false;
    const uint16_t xlen = data[pos + 10] | (data[pos + 11] << 8);
    size_t extra = pos + 12;
    size_t extra_end = extra + xlen;
    if (extra_end > len) return false;
    int bsize = -1;
    while (extra + 4 <= extra_end) {
      const uint8_t si1 = data[extra], si2 = data[extra + 1];
      const uint16_t slen = data[extra + 2] | (data[extra + 3] << 8);
      if (si1 == 'B' && si2 == 'C' && slen == 2 &&
          extra + 6 <= extra_end) {
        bsize = (data[extra + 4] | (data[extra + 5] << 8)) + 1;
      }
      extra += 4 + slen;
    }
    if (bsize <= 0) return false;
    const size_t payload = pos + 12 + xlen;
    const size_t block_end = pos + bsize;
    if (block_end > len || block_end < payload + 8) return false;
    const uint8_t* footer = data + block_end - 8;
    const uint32_t crc = footer[0] | (footer[1] << 8) | (footer[2] << 16) |
                         ((uint32_t)footer[3] << 24);
    const uint32_t isize = footer[4] | (footer[5] << 8) | (footer[6] << 16) |
                           ((uint32_t)footer[7] << 24);
    blocks->push_back(
        Block{payload, block_end - 8 - payload, out, isize, crc});
    out += isize;
    pos = block_end;
  }
  *total_out = out;
  return pos == len;
}

bool inflate_block(const uint8_t* src, size_t src_len, uint8_t* dst,
                   size_t dst_len, uint32_t expected_crc) {
  z_stream zs;
  memset(&zs, 0, sizeof(zs));
  if (inflateInit2(&zs, -15) != Z_OK) return false;
  zs.next_in = const_cast<uint8_t*>(src);
  zs.avail_in = (uInt)src_len;
  zs.next_out = dst;
  zs.avail_out = (uInt)dst_len;
  const int ret = inflate(&zs, Z_FINISH);
  inflateEnd(&zs);
  if (ret != Z_STREAM_END || zs.total_out != dst_len) return false;
  // Raw-deflate mode (-15) skips zlib's own gzip footer handling, so
  // verify the member CRC here — Python's gzip module does, and the
  // native path must never accept bytes the fallback would reject.
  return crc32(crc32(0L, Z_NULL, 0), dst, (uInt)dst_len) == expected_crc;
}

}  // namespace

extern "C" {

// Decompresses a whole BGZF buffer with n_threads workers.
// Returns 0 on success; *out is malloc'd (caller frees via dc_free).
// max_out caps the decompressed size (0 = unlimited): the block scan
// knows the exact total before any allocation, so an oversized buffer
// is rejected (rc 6) before a byte is inflated — callers fall back to
// the streaming Python path, which holds only small buffers.
int dc_bgzf_decompress(const uint8_t* data, size_t len, int n_threads,
                       uint8_t** out, size_t* out_len, size_t max_out) {
  std::vector<Block> blocks;
  size_t total = 0;
  if (!scan_blocks(data, len, &blocks, &total)) return 1;
  if (max_out && total > max_out) return 6;
  uint8_t* buffer = (uint8_t*)malloc(total ? total : 1);
  if (!buffer) return 2;

  std::atomic<size_t> next(0);
  std::atomic<bool> failed(false);
  auto worker = [&]() {
    for (;;) {
      const size_t i = next.fetch_add(1);
      if (i >= blocks.size() || failed.load(std::memory_order_relaxed)) break;
      const Block& b = blocks[i];
      // Zero-output blocks (the BGZF EOF marker) still carry a deflate
      // payload and CRC footer; inflate them too so footer corruption
      // is rejected exactly like the pure-Python gzip path does.
      if (!inflate_block(data + b.in_offset, b.in_size,
                         buffer + b.out_offset, b.out_size, b.crc)) {
        failed.store(true, std::memory_order_relaxed);
      }
    }
  };
  if (n_threads < 1) n_threads = 1;
  std::vector<std::thread> pool;
  for (int t = 1; t < n_threads; ++t) pool.emplace_back(worker);
  worker();
  for (auto& th : pool) th.join();
  if (failed.load()) {
    free(buffer);
    return 3;
  }
  *out = buffer;
  *out_len = total;
  return 0;
}

// File-path convenience wrapper. max_out as in dc_bgzf_decompress
// (0 = unlimited; oversized output rejects with rc 6 before inflating).
int dc_bgzf_decompress_file(const char* path, int n_threads, uint8_t** out,
                            size_t* out_len, size_t max_out) {
  FILE* f = fopen(path, "rb");
  if (!f) return 10;
  fseek(f, 0, SEEK_END);
  const long size = ftell(f);
  fseek(f, 0, SEEK_SET);
  if (size < 0) {
    fclose(f);
    return 11;
  }
  uint8_t* data = (uint8_t*)malloc(size ? size : 1);
  if (!data) {
    fclose(f);
    return 12;
  }
  const size_t got = fread(data, 1, size, f);
  fclose(f);
  if (got != (size_t)size) {
    free(data);
    return 13;
  }
  const int rc =
      dc_bgzf_decompress(data, size, n_threads, out, out_len, max_out);
  free(data);
  return rc;
}

void dc_free(uint8_t* ptr) { free(ptr); }

// Whole-buffer inflate for arbitrary (possibly multi-member) gzip —
// the fallback when a shard is NOT BGZF (plain gzip from the
// pure-Python writer or the reference's TF writer has one member and
// no BC field, so the parallel block path can't apply). Serial, but
// the inflate + framing cost still moves from Python to C.
// max_out (0 = unlimited) aborts with rc 6 as soon as the output
// exceeds the cap — the only sound bound for arbitrary gzip, whose
// footer ISIZE wraps mod 2^32 and covers only the final member.
int dc_gzip_decompress(const uint8_t* data, size_t len, uint8_t** out,
                       size_t* out_len, size_t max_out) {
  // avail_in is a uInt; a >=4 GiB input would silently truncate to
  // len mod 2^32 (possibly decoding a clean prefix and returning 0).
  if (len > UINT_MAX) return 5;
  size_t cap = len * 4 + (1 << 16);
  // Clamp to max_out + 1: one byte past the cap is all the over-cap
  // check below needs, and it keeps the allocation bounded by the
  // caller's budget instead of transiently ~2x over it.
  if (max_out && cap > max_out + 1) cap = max_out + 1;
  uint8_t* buffer = (uint8_t*)malloc(cap);
  if (!buffer) return 2;
  size_t total = 0;

  z_stream zs;
  memset(&zs, 0, sizeof(zs));
  // 15+16: gzip wrapper with max window.
  if (inflateInit2(&zs, 15 + 16) != Z_OK) {
    free(buffer);
    return 4;
  }
  zs.next_in = const_cast<uint8_t*>(data);
  zs.avail_in = (uInt)len;
  for (;;) {
    if (total == cap) {
      cap *= 2;
      if (max_out && cap > max_out + 1) cap = max_out + 1;
      uint8_t* grown = (uint8_t*)realloc(buffer, cap);
      if (!grown) {
        inflateEnd(&zs);
        free(buffer);
        return 2;
      }
      buffer = grown;
    }
    zs.next_out = buffer + total;
    zs.avail_out = (uInt)(cap - total);
    const int ret = inflate(&zs, Z_NO_FLUSH);
    total = cap - zs.avail_out;
    // Cap check must follow EVERY inflate call: the Z_STREAM_END exit
    // below must not return success for an over-cap output that fit
    // the adaptive buffer in one call.
    if (max_out && total > max_out) {
      inflateEnd(&zs);
      free(buffer);
      return 6;
    }
    if (ret == Z_STREAM_END) {
      if (zs.avail_in == 0) break;
      // Concatenated member: restart on the remaining input.
      if (inflateReset2(&zs, 15 + 16) != Z_OK) {
        inflateEnd(&zs);
        free(buffer);
        return 4;
      }
      continue;
    }
    if (ret != Z_OK) {
      inflateEnd(&zs);
      free(buffer);
      return 3;
    }
  }
  inflateEnd(&zs);
  *out = buffer;
  *out_len = total;
  return 0;
}

uint32_t dc_crc32c(const uint8_t* data, size_t len, uint32_t seed);

// TFRecord masked crc (crc32c rotated + constant), as used by the
// length and payload checksums.
static uint32_t dc_masked_crc(const uint8_t* data, size_t len) {
  const uint32_t crc = dc_crc32c(data, len, 0);
  return (uint32_t)(((crc >> 15) | (crc << 17)) + 0xA282EAD8u);
}

// Parses TFRecord framing (u64 length, u32 len-crc, payload, u32
// payload-crc) over a decompressed buffer. Emits (offset, length)
// pairs of the PAYLOADS into a malloc'd u64 array (caller frees via
// dc_free). The length crc IS validated before the length is trusted
// (matching the hardened Python reader); payload crcs are not
// (matching the Python reader's check_crc=False default). Framing
// errors return nonzero.
int dc_tfrecord_index(const uint8_t* data, size_t len, uint64_t** pairs,
                      size_t* n_records) {
  size_t cap = 1024;
  uint64_t* out = (uint64_t*)malloc(cap * 2 * sizeof(uint64_t));
  if (!out) return 2;
  size_t n = 0;
  size_t pos = 0;
  while (pos < len) {
    if (pos + 12 > len) {
      free(out);
      return 1;  // truncated header
    }
    uint64_t rec_len;
    memcpy(&rec_len, data + pos, 8);  // little-endian hosts only (x86/ARM)
    uint32_t len_crc;
    memcpy(&len_crc, data + pos + 8, 4);
    if (len_crc != dc_masked_crc(data + pos, 8)) {
      free(out);
      return 1;  // corrupt length header
    }
    const size_t payload = pos + 12;
    if (rec_len > len || payload + rec_len + 4 > len) {
      free(out);
      return 1;  // truncated payload
    }
    if (n == cap) {
      cap *= 2;
      uint64_t* grown = (uint64_t*)realloc(out, cap * 2 * sizeof(uint64_t));
      if (!grown) {
        free(out);
        return 2;
      }
      out = grown;
    }
    out[2 * n] = payload;
    out[2 * n + 1] = rec_len;
    ++n;
    pos = payload + rec_len + 4;
  }
  *pairs = out;
  *n_records = n;
  return 0;
}

// crc32c (Castagnoli), software table implementation, for TFRecord
// framing without per-byte Python cost.
// Eagerly initialized: ctypes releases the GIL during calls, so a
// lazily built table would race between Python threads.
static uint32_t kCrcTable[256];

static bool crc_init() {
  for (uint32_t i = 0; i < 256; ++i) {
    uint32_t crc = i;
    for (int j = 0; j < 8; ++j) {
      crc = (crc & 1) ? (crc >> 1) ^ 0x82F63B78u : crc >> 1;
    }
    kCrcTable[i] = crc;
  }
  return true;
}
static const bool kCrcInit = crc_init();

uint32_t dc_crc32c(const uint8_t* data, size_t len, uint32_t seed) {
  (void)kCrcInit;
  uint32_t crc = seed ^ 0xFFFFFFFFu;
  for (size_t i = 0; i < len; ++i) {
    crc = kCrcTable[(crc ^ data[i]) & 0xFF] ^ (crc >> 8);
  }
  return crc ^ 0xFFFFFFFFu;
}

}  // extern "C"
