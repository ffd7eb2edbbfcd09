// Native submission writer: prediction CSV formatting + single-file zip.
// The port's copy of ctr_recommendation_tpu/data/native/submission.cc, so
// both packages write the same CSV bytes for the same float32 probabilities.
//
// Formatting the CSV is the largest host stage of the submission pipeline.
// Here:
//
//   * floats are formatted with std::to_chars (shortest round-trip decimal
//     for the float32 value — the same contract as pandas' Ryu formatter);
//   * rows are formatted into per-thread buffers and written sequentially;
//   * the zip is a minimal single-entry container: raw-deflate (zlib,
//     windowBits -15) + CRC32, local header + central directory + EOCD.
//
// Exposed via ctypes (see __init__.py); every entry point has a pure-Python
// fallback in inference/submission.py, which writes the same bytes.
//
// Build (__init__.py does it at first use, into _build/):
//   g++ -O3 -shared -fPIC -std=c++17 -o libsubmission-<hash>.so submission.cc -lz -lpthread

#include <charconv>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <ctime>
#include <string>
#include <thread>
#include <vector>

#include <zlib.h>

namespace {

// Format rows [begin, end) as "id,prob\n" into out.
void format_rows(const float* probs, int64_t begin, int64_t end,
                 int64_t id_offset, std::string* out) {
  out->clear();
  out->reserve(static_cast<size_t>(end - begin) * 14);
  char num[64];
  for (int64_t i = begin; i < end; ++i) {
    char* p = num;
    auto id = std::to_chars(p, num + sizeof(num), id_offset + i);
    out->append(num, id.ptr - num);
    out->push_back(',');
    auto fl = std::to_chars(num, num + sizeof(num), probs[i]);
    out->append(num, fl.ptr - num);
    // pandas prints integral floats as "0.0"/"1.0"; to_chars as "0"/"1"
    bool plain_int = true;
    for (const char* c = num; c != fl.ptr; ++c) {
      if (*c == '.' || *c == 'e' || *c == 'E') {
        plain_int = false;
        break;
      }
    }
    if (plain_int) out->append(".0", 2);
    out->push_back('\n');
  }
}

}  // namespace

extern "C" {

// Write (or append, if append != 0) CSV rows "id,prob" for n probabilities,
// with IDs starting at id_offset. When append == 0 the header line
// "ID,Task2\n" is written first. Returns bytes written, or -1 on error.
int64_t submission_write_csv(const float* probs, int64_t n, int64_t id_offset,
                             const char* path, int append, int n_threads) {
  FILE* f = std::fopen(path, append ? "ab" : "wb");
  if (f == nullptr) return -1;
  int64_t written = 0;
  if (!append) {
    static const char kHeader[] = "ID,Task2\n";
    if (std::fwrite(kHeader, 1, sizeof(kHeader) - 1, f) != sizeof(kHeader) - 1) {
      std::fclose(f);
      return -1;
    }
    written += sizeof(kHeader) - 1;
  }
  if (n_threads < 1) n_threads = 1;
  if (n_threads > 16) n_threads = 16;
  int64_t chunk = (n + n_threads - 1) / n_threads;
  if (chunk < 1) chunk = 1;
  std::vector<std::string> bufs(n_threads);
  std::vector<std::thread> threads;
  threads.reserve(n_threads);
  for (int t = 0; t < n_threads; ++t) {
    int64_t b = t * chunk;
    int64_t e = b + chunk < n ? b + chunk : n;
    if (b >= e) {
      bufs[t].clear();
      continue;
    }
    threads.emplace_back(format_rows, probs, b, e, id_offset, &bufs[t]);
  }
  for (auto& th : threads) th.join();
  bool ok = true;
  for (const auto& buf : bufs) {
    if (!buf.empty() && std::fwrite(buf.data(), 1, buf.size(), f) != buf.size()) {
      ok = false;
      break;
    }
    written += static_cast<int64_t>(buf.size());
  }
  std::fclose(f);
  return ok ? written : -1;
}

// Zip a single file into a fresh archive at zip_path under the name arcname,
// raw-deflated at the given zlib level (1..9; 0 = stored). Returns the
// archive size in bytes, or -1 on error.
int64_t submission_zip_file(const char* src_path, const char* zip_path,
                            const char* arcname, int level) {
  FILE* src = std::fopen(src_path, "rb");
  if (src == nullptr) return -1;
  std::fseek(src, 0, SEEK_END);
  long ssize = std::ftell(src);
  std::fseek(src, 0, SEEK_SET);
  std::vector<unsigned char> data(static_cast<size_t>(ssize));
  if (ssize > 0 && std::fread(data.data(), 1, data.size(), src) != data.size()) {
    std::fclose(src);
    return -1;
  }
  std::fclose(src);

  uint32_t crc = crc32(0L, Z_NULL, 0);
  crc = crc32(crc, data.data(), static_cast<uInt>(data.size()));

  std::vector<unsigned char> comp;
  uint16_t method = 0;  // stored
  if (level > 0) {
    z_stream zs;
    std::memset(&zs, 0, sizeof(zs));
    // windowBits -15: raw deflate, no zlib header — the zip format's framing
    if (deflateInit2(&zs, level, Z_DEFLATED, -15, 8, Z_DEFAULT_STRATEGY) != Z_OK)
      return -1;
    comp.resize(deflateBound(&zs, static_cast<uLong>(data.size())));
    zs.next_in = data.data();
    zs.avail_in = static_cast<uInt>(data.size());
    zs.next_out = comp.data();
    zs.avail_out = static_cast<uInt>(comp.size());
    int rc = deflate(&zs, Z_FINISH);
    if (rc != Z_STREAM_END) {
      deflateEnd(&zs);
      return -1;
    }
    comp.resize(zs.total_out);
    deflateEnd(&zs);
    if (comp.size() < data.size()) {
      method = 8;  // deflated
    } else {
      comp = data;  // incompressible: store
    }
  } else {
    comp = data;
  }

  FILE* out = std::fopen(zip_path, "wb");
  if (out == nullptr) return -1;
  // every write feeds an ok flag: a short write (disk full) must yield -1,
  // never a positive byte count over a truncated archive
  bool wok = true;
  auto put16 = [&](uint16_t v) {
    unsigned char b[2] = {static_cast<unsigned char>(v),
                          static_cast<unsigned char>(v >> 8)};
    wok &= std::fwrite(b, 1, 2, out) == 2;
  };
  auto put32 = [&](uint32_t v) {
    unsigned char b[4] = {
        static_cast<unsigned char>(v), static_cast<unsigned char>(v >> 8),
        static_cast<unsigned char>(v >> 16), static_cast<unsigned char>(v >> 24)};
    wok &= std::fwrite(b, 1, 4, out) == 4;
  };
  uint16_t name_len = static_cast<uint16_t>(std::strlen(arcname));
  // DOS date/time from current local time (zipfile does the same)
  std::time_t now = std::time(nullptr);
  std::tm tmv;
  localtime_r(&now, &tmv);
  uint16_t dos_time = static_cast<uint16_t>((tmv.tm_hour << 11) |
                                            (tmv.tm_min << 5) |
                                            (tmv.tm_sec / 2));
  int year = tmv.tm_year + 1900;
  if (year < 1980) year = 1980;
  uint16_t dos_date = static_cast<uint16_t>(((year - 1980) << 9) |
                                            ((tmv.tm_mon + 1) << 5) |
                                            tmv.tm_mday);

  // local file header
  put32(0x04034b50);
  put16(20);         // version needed
  put16(0);          // flags
  put16(method);
  put16(dos_time);
  put16(dos_date);
  put32(crc);
  put32(static_cast<uint32_t>(comp.size()));
  put32(static_cast<uint32_t>(data.size()));
  put16(name_len);
  put16(0);  // extra len
  wok &= std::fwrite(arcname, 1, name_len, out) == name_len;
  wok &= std::fwrite(comp.data(), 1, comp.size(), out) == comp.size();
  long cd_offset = std::ftell(out);

  // central directory
  put32(0x02014b50);
  put16(20);  // version made by
  put16(20);  // version needed
  put16(0);
  put16(method);
  put16(dos_time);
  put16(dos_date);
  put32(crc);
  put32(static_cast<uint32_t>(comp.size()));
  put32(static_cast<uint32_t>(data.size()));
  put16(name_len);
  put16(0);  // extra
  put16(0);  // comment
  put16(0);  // disk
  put16(0);  // internal attrs
  put32(0);  // external attrs
  put32(0);  // local header offset
  wok &= std::fwrite(arcname, 1, name_len, out) == name_len;
  long cd_size = std::ftell(out) - cd_offset;

  // end of central directory
  put32(0x06054b50);
  put16(0);
  put16(0);
  put16(1);
  put16(1);
  put32(static_cast<uint32_t>(cd_size));
  put32(static_cast<uint32_t>(cd_offset));
  put16(0);
  long total = std::ftell(out);
  wok &= std::fclose(out) == 0;
  return wok ? total : -1;
}

}  // extern "C"
