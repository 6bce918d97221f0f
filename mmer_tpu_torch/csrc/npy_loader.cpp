// Bulk .npy feature loader — the framework's native data-path runtime.
//
// The training pipeline ingests ~17.8k small .npy artifacts (8.9k video
// (T,768) float32 + 8.9k audio (1024,) float16; reference artifact contract
// at video_extractor.py:176 / voice_extractor.py:95).  CPython's per-file
// overhead (np.load → open → header parse → allocation → GC) dominates that
// scan; this library does the same work with pread + a minimal header
// parser + a std::thread pool, writing rows straight into caller-provided
// (pre-pinned) buffers so Python never touches per-file objects.
//
// Exposed C ABI (ctypes-friendly):
//   mmer_load_f32_batch  — N files of shape (rows_i, cols) float32 rows
//                          into out[i*max_rows*cols]; rows_i returned.
//   mmer_load_f16_vec_batch — N files of (len,) float16 → float32 rows.
//
// Build: make -C native   (g++ -O3 -shared -fPIC)

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <unistd.h>

namespace {

struct NpyInfo {
  bool ok = false;
  bool f16 = false;          // "<f2" vs "<f4"
  long rows = 0;
  long cols = 0;             // 1 for 1-D arrays
  size_t data_offset = 0;
};

// Minimal .npy v1/v2 header parser (fortran_order must be False).
NpyInfo parse_header(int fd) {
  NpyInfo info;
  unsigned char pre[12];
  if (pread(fd, pre, 10, 0) != 10) return info;
  if (memcmp(pre, "\x93NUMPY", 6) != 0) return info;
  int major = pre[6];
  size_t header_len, header_off;
  if (major == 1) {
    header_len = pre[8] | (pre[9] << 8);
    header_off = 10;
  } else {
    unsigned char len4[4];
    if (pread(fd, len4, 4, 8) != 4) return info;
    header_len = (size_t)len4[0] | ((size_t)len4[1] << 8) |
                 ((size_t)len4[2] << 16) | ((size_t)len4[3] << 24);
    header_off = 12;
  }
  std::string header(header_len, '\0');
  if (pread(fd, header.data(), header_len, header_off) != (ssize_t)header_len)
    return info;
  info.data_offset = header_off + header_len;

  if (header.find("'fortran_order': True") != std::string::npos) return info;
  if (header.find("'<f2'") != std::string::npos) info.f16 = true;
  else if (header.find("'<f4'") == std::string::npos) return info;

  size_t sp = header.find("'shape':");
  if (sp == std::string::npos) return info;
  size_t lp = header.find('(', sp), rp = header.find(')', sp);
  if (lp == std::string::npos || rp == std::string::npos) return info;
  std::string shape = header.substr(lp + 1, rp - lp - 1);
  long dims[2] = {0, 1};
  int nd = 0;
  const char* s = shape.c_str();
  while (*s && nd < 2) {
    while (*s == ' ' || *s == ',') ++s;
    if (*s < '0' || *s > '9') break;
    dims[nd++] = strtol(s, const_cast<char**>(&s), 10);
  }
  if (nd == 0) return info;
  info.rows = dims[0];
  info.cols = (nd == 2) ? dims[1] : 1;
  info.ok = true;
  return info;
}

inline float half_to_float(uint16_t h) {
  uint32_t sign = (uint32_t)(h & 0x8000) << 16;
  uint32_t exp = (h >> 10) & 0x1F;
  uint32_t mant = h & 0x3FF;
  uint32_t bits;
  if (exp == 0) {
    if (mant == 0) {
      bits = sign;
    } else {  // subnormal: value = mant·2^-24 → normalize to 1.f·2^(-14-shift)
      int shift = 0;
      while (!(mant & 0x400)) { mant <<= 1; ++shift; }
      mant &= 0x3FF;
      bits = sign | ((uint32_t)(127 - 14 - shift) << 23) | (mant << 13);
    }
  } else if (exp == 31) {
    bits = sign | 0x7F800000 | (mant << 13);
  } else {
    bits = sign | ((exp - 15 + 127) << 23) | (mant << 13);
  }
  float f;
  memcpy(&f, &bits, 4);
  return f;
}

template <typename Fn>
void parallel_for(int n, int n_threads, Fn fn) {
  if (n_threads <= 1) {
    for (int i = 0; i < n; ++i) fn(i);
    return;
  }
  std::atomic<int> next(0);
  std::vector<std::thread> threads;
  int workers = std::min(n_threads, n);
  threads.reserve(workers);
  for (int t = 0; t < workers; ++t) {
    threads.emplace_back([&] {
      for (int i = next.fetch_add(1); i < n; i = next.fetch_add(1)) fn(i);
    });
  }
  for (auto& th : threads) th.join();
}

}  // namespace

extern "C" {

// Load N float32 matrices (rows_i, cols) into out[i * max_rows * cols].
// rows_out[i] = rows actually read (clipped to max_rows), or -1 on error.
// Returns the number of failed files.
int mmer_load_f32_batch(const char* const* paths, int n_files, long cols,
                        long max_rows, float* out, int* rows_out,
                        int n_threads) {
  std::atomic<int> failures(0);
  parallel_for(n_files, n_threads, [&](int i) {
    rows_out[i] = -1;
    int fd = open(paths[i], O_RDONLY);
    if (fd < 0) { failures++; return; }
    NpyInfo info = parse_header(fd);
    if (!info.ok || info.f16 || info.cols != cols) {
      close(fd); failures++; return;
    }
    long rows = std::min(info.rows, max_rows);
    size_t bytes = (size_t)rows * cols * 4;
    float* dst = out + (size_t)i * max_rows * cols;
    if (pread(fd, dst, bytes, info.data_offset) != (ssize_t)bytes) {
      close(fd); failures++; return;
    }
    close(fd);
    // Report the TRUE row count; callers detect rows_out[i] > max_rows and
    // re-read oversized files through the slow path.
    rows_out[i] = (int)info.rows;
  });
  return failures.load();
}

// Load N float16 vectors (len,) as float32 rows of out[i * len].
int mmer_load_f16_vec_batch(const char* const* paths, int n_files, long len,
                            float* out, int n_threads) {
  std::atomic<int> failures(0);
  parallel_for(n_files, n_threads, [&](int i) {
    int fd = open(paths[i], O_RDONLY);
    if (fd < 0) { failures++; return; }
    NpyInfo info = parse_header(fd);
    long total = info.rows * info.cols;
    // Accept (len,) and (1, len) — the artifact loader's tolerance
    // (core/artifacts.py:37-38).
    if (!info.ok || !info.f16 || total != len) {
      close(fd); failures++; return;
    }
    std::vector<uint16_t> buf(len);
    if (pread(fd, buf.data(), len * 2, info.data_offset) != (ssize_t)(len * 2)) {
      close(fd); failures++; return;
    }
    close(fd);
    float* dst = out + (size_t)i * len;
    for (long j = 0; j < len; ++j) dst[j] = half_to_float(buf[j]);
  });
  return failures.load();
}

// Probe: library version for the ctypes binding's sanity check.
int mmer_native_version() { return 1; }

}  // extern "C"
