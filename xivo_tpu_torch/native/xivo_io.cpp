// Native IO runtime for xivo_tpu_torch (a copy of the JAX package's
// native/xivo_io.cpp, kept inside the port so that it builds and loads
// without that package).
//
// The host-side analogue of the reference's C++ runtime pieces: the ASL
// csv DataLoader (src/loader.cpp), image decode (cv::imread for
// grayscale PGM/PNG), and the EstimatorProcess SPSC prefetch queue
// (common/ProducerConsumerQueue.h, folly-style lock-free ring), so that
// dataset replay does not wait on Python-side decode and parsing; a
// background prefetch thread decodes ahead of the consumer.
//
// Exposed via a plain C ABI and loaded with ctypes (native/__init__.py).

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <fstream>
#include <sstream>
#include <string>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------
// CSV parsing: "ts,gx,gy,gz,ax,ay,az" or "ts,filename" lines, '#'
// comments ignored. Returns the number of rows parsed; values written
// into out (n_cols doubles per row, timestamps in seconds).
// ---------------------------------------------------------------------
int xivo_parse_imu_csv(const char* path, double* out, int max_rows) {
  std::ifstream is(path);
  if (!is) return -1;
  std::string line;
  int n = 0;
  while (std::getline(is, line) && n < max_rows) {
    if (line.empty() || line[0] == '#') continue;
    const char* p = line.c_str();
    char* end = nullptr;
    long long ts = strtoll(p, &end, 10);
    if (end == p) continue;
    double* row = out + n * 7;
    row[0] = static_cast<double>(ts) * 1e-9;
    bool ok = true;
    for (int i = 0; i < 6; ++i) {
      while (*end == ',' || *end == ' ') ++end;
      const char* q = end;
      row[1 + i] = strtod(q, &end);
      if (end == q) { ok = false; break; }
    }
    if (ok) ++n;
  }
  return n;
}

// ---------------------------------------------------------------------
// PGM (P5, 8/16-bit) decode into a float32 buffer. Returns 0 on
// success; fills w/h. Caller provides a buffer of max_pixels floats.
// ---------------------------------------------------------------------
static int skip_ws_comments(std::ifstream& is) {
  int c;
  while ((c = is.peek()) != EOF) {
    if (c == '#') {
      std::string dummy;
      std::getline(is, dummy);
    } else if (isspace(c)) {
      is.get();
    } else {
      break;
    }
  }
  return 0;
}

int xivo_load_pgm(const char* path, float* out, int max_pixels, int* w,
                  int* h) {
  std::ifstream is(path, std::ios::binary);
  if (!is) return -1;
  std::string magic;
  is >> magic;
  if (magic != "P5") return -2;
  skip_ws_comments(is);
  int width, height, maxv;
  is >> width;
  skip_ws_comments(is);
  is >> height;
  skip_ws_comments(is);
  is >> maxv;
  is.get();  // single whitespace after header
  if (width * height > max_pixels) return -3;
  const size_t npix = static_cast<size_t>(width) * height;
  if (maxv < 256) {
    std::vector<uint8_t> buf(npix);
    is.read(reinterpret_cast<char*>(buf.data()), npix);
    for (size_t i = 0; i < npix; ++i) out[i] = buf[i];
  } else {
    // cv::IMREAD_GRAYSCALE contract: 16-bit rescales to the 0..255 range
    // (x * 255/65535 = x/257) so fixed intensity thresholds downstream
    // (FAST detection) see the same scale regardless of bit depth
    std::vector<uint8_t> buf(npix * 2);
    is.read(reinterpret_cast<char*>(buf.data()), npix * 2);
    for (size_t i = 0; i < npix; ++i)
      out[i] =
          static_cast<float>((buf[2 * i] << 8) | buf[2 * i + 1]) / 257.0f;
  }
  *w = width;
  *h = height;
  return 0;
}

// ---------------------------------------------------------------------
// PNG decode (grayscale output) via zlib inflate — covers the TUM-VI /
// EuRoC image format the reference reads through cv::imread
// (src/loader.cpp). Supports bit depth 8/16, color types 0 (gray),
// 2 (RGB), 4 (gray+alpha), 6 (RGBA) — color collapses to ITU-R BT.601
// luma like cv::IMREAD_GRAYSCALE; non-interlaced only (Adam7 -> -6).
// Filters 0..4 (None/Sub/Up/Average/Paeth) per the PNG spec.
// ---------------------------------------------------------------------
#include <zlib.h>

static inline int paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = abs(p - a), pb = abs(p - b), pc = abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  if (pb <= pc) return b;
  return c;
}

int xivo_load_png(const char* path, float* out, int max_pixels, int* w,
                  int* h) try {
  std::ifstream is(path, std::ios::binary);
  if (!is) return -1;
  uint8_t sig[8];
  is.read(reinterpret_cast<char*>(sig), 8);
  static const uint8_t kSig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a,
                                  '\n'};
  if (!is || memcmp(sig, kSig, 8) != 0) return -2;

  uint32_t width = 0, height = 0;
  int bit_depth = 0, color_type = 0, interlace = 0;
  std::vector<uint8_t> idat;

  auto rd_u32 = [&](const uint8_t* p) {
    return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
           (uint32_t(p[2]) << 8) | uint32_t(p[3]);
  };

  std::vector<uint8_t> chunk;
  for (;;) {
    uint8_t hdr[8];
    is.read(reinterpret_cast<char*>(hdr), 8);
    if (!is) return -3;
    uint32_t len = rd_u32(hdr);
    // corrupt-length guard: PNG chunks cap at 2^31-1, and nothing this
    // decoder accepts needs more than ~raw image size; a bogus length
    // must return an error code, not bad_alloc through the C ABI
    if (len > (1u << 30)) return -3;
    char type[5] = {char(hdr[4]), char(hdr[5]), char(hdr[6]), char(hdr[7]),
                    0};
    chunk.resize(len);
    if (len) is.read(reinterpret_cast<char*>(chunk.data()), len);
    is.ignore(4);  // CRC (not verified — matches stb/cv tolerance)
    if (!is) return -3;
    if (strcmp(type, "IHDR") == 0) {
      if (len < 13) return -3;
      width = rd_u32(&chunk[0]);
      height = rd_u32(&chunk[4]);
      bit_depth = chunk[8];
      color_type = chunk[9];
      interlace = chunk[12];
      if (interlace != 0) return -6;
      if (bit_depth != 8 && bit_depth != 16) return -7;
      if (color_type != 0 && color_type != 2 && color_type != 4 &&
          color_type != 6)
        return -7;
      if (int64_t(width) * height > max_pixels) return -4;
    } else if (strcmp(type, "IDAT") == 0) {
      idat.insert(idat.end(), chunk.begin(), chunk.end());
    } else if (strcmp(type, "IEND") == 0) {
      break;
    }  // PLTE/ancillary chunks ignored (palette images rejected above)
  }
  if (width == 0 || height == 0 || idat.empty()) return -3;

  const int channels =
      (color_type == 0) ? 1 : (color_type == 2) ? 3 : (color_type == 4) ? 2
                                                                        : 4;
  const int bytes_pp = channels * (bit_depth / 8);
  const size_t stride = size_t(width) * bytes_pp;
  std::vector<uint8_t> raw((stride + 1) * height);
  uLongf raw_len = raw.size();
  if (uncompress(raw.data(), &raw_len, idat.data(), idat.size()) != Z_OK ||
      raw_len != raw.size())
    return -5;

  // de-filter in place into a scanline buffer
  std::vector<uint8_t> prev(stride, 0), cur(stride);
  for (uint32_t y = 0; y < height; ++y) {
    const uint8_t* src = raw.data() + size_t(y) * (stride + 1);
    int filter = src[0];
    const uint8_t* in = src + 1;
    for (size_t i = 0; i < stride; ++i) {
      int a = (i >= size_t(bytes_pp)) ? cur[i - bytes_pp] : 0;
      int b = prev[i];
      int c = (i >= size_t(bytes_pp)) ? prev[i - bytes_pp] : 0;
      int x = in[i];
      switch (filter) {
        case 0: cur[i] = uint8_t(x); break;
        case 1: cur[i] = uint8_t(x + a); break;
        case 2: cur[i] = uint8_t(x + b); break;
        case 3: cur[i] = uint8_t(x + ((a + b) >> 1)); break;
        case 4: cur[i] = uint8_t(x + paeth(a, b, c)); break;
        default: return -8;
      }
    }
    // emit grayscale floats
    float* row = out + size_t(y) * width;
    const int bs = bit_depth / 8;
    for (uint32_t xpx = 0; xpx < width; ++xpx) {
      const uint8_t* px = cur.data() + size_t(xpx) * bytes_pp;
      auto sample = [&](int ch) -> float {
        const uint8_t* s = px + ch * bs;
        // 16-bit rescales to 0..255 (cv::IMREAD_GRAYSCALE contract; see
        // the PGM decoder above)
        return (bit_depth == 8)
                   ? float(s[0])
                   : float((s[0] << 8) | s[1]) / 257.0f;
      };
      if (channels <= 2) {
        row[xpx] = sample(0);
      } else {
        row[xpx] = 0.299f * sample(0) + 0.587f * sample(1) +
                   0.114f * sample(2);
      }
    }
    std::swap(prev, cur);
  }
  *w = int(width);
  *h = int(height);
  return 0;
} catch (...) {
  // no C++ exception may cross the ctypes boundary
  return -9;
}

// Unified decode by extension (PGM or PNG).
int xivo_load_image(const char* path, float* out, int max_pixels, int* w,
                    int* h) {
  size_t n = strlen(path);
  if (n >= 4 && (strcmp(path + n - 4, ".png") == 0 ||
                 strcmp(path + n - 4, ".PNG") == 0))
    return xivo_load_png(path, out, max_pixels, w, h);
  return xivo_load_pgm(path, out, max_pixels, w, h);
}

// ---------------------------------------------------------------------
// SPSC image prefetcher: a background thread decodes a list of PGM
// paths ahead of the consumer through a lock-free ring (the
// ProducerConsumerQueue pattern, common/ProducerConsumerQueue.h:80-180:
// single producer, single consumer, acquire/release on head/tail).
// ---------------------------------------------------------------------
struct Slot {
  std::vector<float> px;
  int w = 0, h = 0, status = -1;
};

struct Prefetcher {
  std::vector<std::string> paths;
  std::vector<Slot> ring;
  std::atomic<uint64_t> head{0};  // next to produce
  std::atomic<uint64_t> tail{0};  // next to consume
  std::thread worker;
  std::atomic<bool> stop{false};
  int capacity = 0;
  int max_pixels = 0;

  void run() {
    for (size_t i = 0; i < paths.size() && !stop.load(); ++i) {
      // wait for a free slot
      while (head.load(std::memory_order_relaxed) -
                 tail.load(std::memory_order_acquire) >=
             static_cast<uint64_t>(capacity)) {
        if (stop.load()) return;
        std::this_thread::yield();
      }
      Slot& s = ring[head.load(std::memory_order_relaxed) % capacity];
      s.px.resize(max_pixels);
      s.status =
          xivo_load_image(paths[i].c_str(), s.px.data(), max_pixels, &s.w,
                          &s.h);
      head.store(head.load(std::memory_order_relaxed) + 1,
                 std::memory_order_release);
    }
  }
};

void* xivo_prefetcher_create(const char** paths, int n_paths,
                             int capacity, int max_pixels) {
  auto* p = new Prefetcher();
  p->paths.assign(paths, paths + n_paths);
  p->ring.resize(capacity);
  p->capacity = capacity;
  p->max_pixels = max_pixels;
  p->worker = std::thread([p] { p->run(); });
  return p;
}

// Blocking pop: copies the next decoded frame into out. Returns status
// (0 ok, <0 decode error, -100 = exhausted).
int xivo_prefetcher_next(void* handle, float* out, int* w, int* h) {
  auto* p = static_cast<Prefetcher*>(handle);
  uint64_t t = p->tail.load(std::memory_order_relaxed);
  if (t >= p->paths.size()) return -100;
  while (p->head.load(std::memory_order_acquire) <= t) {
    std::this_thread::yield();
  }
  Slot& s = p->ring[t % p->capacity];
  int status = s.status;
  if (status == 0) {
    std::memcpy(out, s.px.data(),
                sizeof(float) * static_cast<size_t>(s.w) * s.h);
    *w = s.w;
    *h = s.h;
  }
  p->tail.store(t + 1, std::memory_order_release);
  return status;
}

void xivo_prefetcher_destroy(void* handle) {
  auto* p = static_cast<Prefetcher*>(handle);
  p->stop.store(true);
  if (p->worker.joinable()) p->worker.join();
  delete p;
}

}  // extern "C"
