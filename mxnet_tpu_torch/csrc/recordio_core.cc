// RecordIO native core — the high-throughput scan/read path for the
// data pipeline.
//
// Reference: dmlc-core's RecordIO framing (src/io/ in the reference
// tree) re-expressed as a small standalone C++ library: the wire format
// is identical to mxnet_tpu_torch/recordio.py (magic | lrec | data | pad4,
// cflag in the top 3 bits of lrec for chunked records), so files are
// interchangeable between the native and pure-python paths.
//
// Exposed C ABI (loaded from python via ctypes, no pybind11):
//   rio_index(path, offsets, cap)            -> n_records | -errno-ish
//       Scan the file, writing each logical record's start offset.
//   rio_read_at(path, offset, buf, cap, len*, end*) -> 0 | error code
//       Read ONE logical record (reassembling continuation chunks)
//       starting at `offset` into buf; *len receives the byte count
//       and *end (nullable) the file offset just past the record —
//       callers keeping a sequential handle seek there for parity
//       with a read-through. buf may be null to query lengths only.
//
// Error codes: -1 open failed, -2 bad magic, -3 truncated,
// -4 capacity exceeded.

#ifndef _FILE_OFFSET_BITS
#define _FILE_OFFSET_BITS 64    // 64-bit ftello/fseeko on 32-bit longs
#endif

#include <sys/stat.h>

#include <cstdint>
#include <cstdio>
#include <cstring>

namespace {

constexpr uint32_t kMagic = 0xced7230a;
constexpr uint32_t kFlagBits = 29;
constexpr uint32_t kLenMask = (1u << kFlagBits) - 1u;

inline uint32_t cflag_of(uint32_t lrec) { return lrec >> kFlagBits; }
inline uint32_t len_of(uint32_t lrec) { return lrec & kLenMask; }
inline uint32_t pad4(uint32_t n) { return (4u - n % 4u) % 4u; }

struct File {
  std::FILE* f;
  long long size;
  explicit File(const char* path) : f(std::fopen(path, "rb")), size(-1) {
    if (f) {
      // fstat on the OPEN handle: a path-based stat could race a
      // rename/unlink and falsely report every record truncated
      struct stat st;
      if (::fstat(fileno(f), &st) == 0) size = (long long)st.st_size;
    }
  }
  ~File() { if (f) std::fclose(f); }
};

// Reads one frame header; returns 1 on success, 0 on clean EOF,
// negative error otherwise.
int read_header(std::FILE* f, uint32_t* magic, uint32_t* lrec) {
  unsigned char hdr[8];
  size_t got = std::fread(hdr, 1, 8, f);
  if (got == 0) return 0;
  if (got < 8) return -3;
  std::memcpy(magic, hdr, 4);     // little-endian on-disk, LE hosts only
  std::memcpy(lrec, hdr + 4, 4);
  return 1;
}

}  // namespace

extern "C" {

long long rio_index(const char* path, unsigned long long* offsets,
                    unsigned long long cap) {
  File file(path);
  if (!file.f) return -1;
  long long n = 0;
  long long pos = 0;
  bool in_record = false;
  for (;;) {
    uint32_t magic, lrec;
    int rc = read_header(file.f, &magic, &lrec);
    if (rc == 0) break;
    if (rc < 0) return rc;
    if (magic != kMagic) return -2;
    uint32_t cflag = cflag_of(lrec), len = len_of(lrec);
    // fseeko past EOF succeeds, so truncation must be caught by
    // bounds-checking against the stat'd size
    long long end = pos + 8 + (long long)len + pad4(len);
    if (end > file.size) return -3;
    if (!in_record) {           // first chunk of a logical record
      if (offsets) {
        if ((unsigned long long)n >= cap) return -4;
        offsets[n] = (unsigned long long)pos;
      }
      ++n;
    }
    // 0 = whole, 1 = begin, 2 = middle, 3 = end
    in_record = (cflag == 1 || cflag == 2);
    if (fseeko(file.f, (off_t)(len + pad4(len)), SEEK_CUR) != 0)
      return -3;
    pos = end;
  }
  if (in_record) return -3;     // EOF inside a chunked record
  return n;
}

int rio_read_at(const char* path, unsigned long long offset,
                unsigned char* buf, unsigned long long cap,
                unsigned long long* out_len,
                unsigned long long* out_end) {
  File file(path);
  if (!file.f) return -1;
  if (fseeko(file.f, (off_t)offset, SEEK_SET) != 0) return -3;
  long long pos = (long long)offset;
  unsigned long long total = 0;
  for (;;) {
    uint32_t magic, lrec;
    int rc = read_header(file.f, &magic, &lrec);
    if (rc == 0) return -3;     // EOF mid-record
    if (rc < 0) return rc;
    if (magic != kMagic) return -2;
    uint32_t cflag = cflag_of(lrec), len = len_of(lrec);
    long long end = pos + 8 + (long long)len + pad4(len);
    if (end > file.size) return -3;   // truncated payload
    bool fits = buf && total + len <= cap;
    if (fits) {
      if (std::fread(buf + total, 1, len, file.f) != len) return -3;
      if (fseeko(file.f, (off_t)pad4(len), SEEK_CUR) != 0) return -3;
    } else {
      // keep walking to compute the record's true length so the
      // caller can size an exact buffer and retry once
      if (fseeko(file.f, (off_t)(len + pad4(len)), SEEK_CUR) != 0)
        return -3;
    }
    total += len;
    pos = end;
    if (cflag == 0 || cflag == 3) break;
  }
  *out_len = total;
  if (out_end) *out_end = (unsigned long long)pos;
  return (buf == nullptr || total <= cap) ? 0 : -4;
}

}  // extern "C"
