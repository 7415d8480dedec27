// octrt_native — C++ runtime pieces for the ray tracer.
//
// The reference's native runtime surface that is NOT device compute:
//   - lodepng (PNG encode/decode, RayTrace/lodepng.cpp) -> png_encode/png_decode
//     (zlib-backed minimal RGBA8 codec)
//   - PerformanceCounter (Win32 QPC, misc/PerformanceCounter.cpp) -> now_ns
//     (CLOCK_MONOTONIC)
//   - generateImageFromPixels int->byte conversion (states/MainState.cpp:974-1045,
//     a per-pixel SDL_FillRect loop) -> fb_pack_rgba (tight clamp/convert loop)
//
// Exposed with a plain C ABI for ctypes (no pybind11 in this image).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <ctime>
#include <vector>

#include <zlib.h>

extern "C" {

// ---------------------------------------------------------------- timer ----
int64_t octrt_now_ns() {
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return static_cast<int64_t>(ts.tv_sec) * 1000000000LL + ts.tv_nsec;
}

// ----------------------------------------------------- framebuffer pack ----
// int32 RGBA (len = h*w*4) -> uint8 RGBA, clamped to [0, 255].
void octrt_fb_pack_rgba(const int32_t* src, uint8_t* dst, int64_t n) {
  for (int64_t i = 0; i < n; ++i) {
    int32_t v = src[i];
    dst[i] = static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
  }
}

// float32 variant (0..255 domain, truncating like the reference's int cast).
void octrt_fb_pack_rgba_f32(const float* src, uint8_t* dst, int64_t n) {
  for (int64_t i = 0; i < n; ++i) {
    float v = src[i];
    dst[i] = static_cast<uint8_t>(v < 0.f ? 0 : (v > 255.f ? 255 : v));
  }
}

// ------------------------------------------------------------- PNG code ----
namespace {

void put_u32(std::vector<uint8_t>& out, uint32_t v) {
  out.push_back((v >> 24) & 0xff);
  out.push_back((v >> 16) & 0xff);
  out.push_back((v >> 8) & 0xff);
  out.push_back(v & 0xff);
}

void put_chunk(std::vector<uint8_t>& out, const char type[4],
               const uint8_t* data, uint32_t len) {
  put_u32(out, len);
  size_t start = out.size();
  out.insert(out.end(), type, type + 4);
  if (len) out.insert(out.end(), data, data + len);
  uint32_t crc = crc32(0L, out.data() + start, len + 4);
  put_u32(out, crc);
}

uint32_t read_u32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
         (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

}  // namespace

// Encode RGBA8 (h*w*4 bytes) to a PNG file. Returns 0 on success.
int octrt_png_encode(const char* path, const uint8_t* rgba, uint32_t width,
                     uint32_t height) {
  // Filtered scanlines: filter byte 0 + raw row.
  const size_t stride = size_t(width) * 4;
  std::vector<uint8_t> raw((stride + 1) * height);
  for (uint32_t y = 0; y < height; ++y) {
    raw[y * (stride + 1)] = 0;
    std::memcpy(&raw[y * (stride + 1) + 1], rgba + y * stride, stride);
  }
  uLongf comp_len = compressBound(raw.size());
  std::vector<uint8_t> comp(comp_len);
  if (compress2(comp.data(), &comp_len, raw.data(), raw.size(), 6) != Z_OK)
    return 1;
  comp.resize(comp_len);

  std::vector<uint8_t> out;
  static const uint8_t sig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a, '\n'};
  out.insert(out.end(), sig, sig + 8);
  uint8_t ihdr[13];
  ihdr[0] = (width >> 24) & 0xff; ihdr[1] = (width >> 16) & 0xff;
  ihdr[2] = (width >> 8) & 0xff;  ihdr[3] = width & 0xff;
  ihdr[4] = (height >> 24) & 0xff; ihdr[5] = (height >> 16) & 0xff;
  ihdr[6] = (height >> 8) & 0xff;  ihdr[7] = height & 0xff;
  ihdr[8] = 8;   // bit depth
  ihdr[9] = 6;   // colour type RGBA
  ihdr[10] = 0; ihdr[11] = 0; ihdr[12] = 0;
  put_chunk(out, "IHDR", ihdr, 13);
  put_chunk(out, "IDAT", comp.data(), uint32_t(comp.size()));
  put_chunk(out, "IEND", nullptr, 0);

  FILE* f = std::fopen(path, "wb");
  if (!f) return 2;
  size_t w = std::fwrite(out.data(), 1, out.size(), f);
  std::fclose(f);
  return w == out.size() ? 0 : 3;
}

// Decode an RGBA8 PNG. Two-phase: call with rgba=null to get width/height,
// then with a buffer of h*w*4 bytes. Returns 0 on success.
// Supports 8-bit RGBA/RGB, filters 0-4, single IDAT stream (possibly split
// over chunks), no interlace.
int octrt_png_decode(const char* path, uint8_t* rgba, uint32_t* width,
                     uint32_t* height) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return 2;
  std::fseek(f, 0, SEEK_END);
  long sz = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  std::vector<uint8_t> buf(sz);
  if (std::fread(buf.data(), 1, sz, f) != size_t(sz)) { std::fclose(f); return 2; }
  std::fclose(f);
  if (sz < 8 || buf[1] != 'P' || buf[2] != 'N' || buf[3] != 'G') return 4;

  uint32_t w = 0, h = 0;
  int colour_type = -1, bit_depth = -1, interlace = 0;
  std::vector<uint8_t> idat;
  size_t pos = 8;
  while (pos + 8 <= buf.size()) {
    uint32_t len = read_u32(&buf[pos]);
    const char* type = reinterpret_cast<const char*>(&buf[pos + 4]);
    const uint8_t* data = &buf[pos + 8];
    if (!std::memcmp(type, "IHDR", 4) && len >= 13) {
      w = read_u32(data);
      h = read_u32(data + 4);
      bit_depth = data[8];
      colour_type = data[9];
      interlace = data[12];
    } else if (!std::memcmp(type, "IDAT", 4)) {
      idat.insert(idat.end(), data, data + len);
    } else if (!std::memcmp(type, "IEND", 4)) {
      break;
    }
    pos += 12 + len;
  }
  if (!w || !h || bit_depth != 8 || interlace != 0 ||
      (colour_type != 6 && colour_type != 2))
    return 5;
  *width = w;
  *height = h;
  if (!rgba) return 0;  // size query

  int ch = colour_type == 6 ? 4 : 3;
  size_t stride = size_t(w) * ch;
  std::vector<uint8_t> raw((stride + 1) * h);
  uLongf raw_len = raw.size();
  if (uncompress(raw.data(), &raw_len, idat.data(), idat.size()) != Z_OK)
    return 6;

  std::vector<uint8_t> prev(stride, 0);
  std::vector<uint8_t> cur(stride);
  for (uint32_t y = 0; y < h; ++y) {
    uint8_t filter = raw[y * (stride + 1)];
    const uint8_t* src = &raw[y * (stride + 1) + 1];
    for (size_t i = 0; i < stride; ++i) {
      int a = i >= size_t(ch) ? cur[i - ch] : 0;      // left
      int b = prev[i];                                // up
      int c = i >= size_t(ch) ? prev[i - ch] : 0;     // up-left
      int x = src[i];
      int val;
      switch (filter) {
        case 0: val = x; break;
        case 1: val = x + a; break;
        case 2: val = x + b; break;
        case 3: val = x + (a + b) / 2; break;
        case 4: {
          int p = a + b - c;
          int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
          int pr = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          val = x + pr;
          break;
        }
        default: return 7;
      }
      cur[i] = uint8_t(val & 0xff);
    }
    uint8_t* out_row = rgba + size_t(y) * w * 4;
    if (ch == 4) {
      std::memcpy(out_row, cur.data(), stride);
    } else {
      for (uint32_t x = 0; x < w; ++x) {
        out_row[x * 4 + 0] = cur[x * 3 + 0];
        out_row[x * 4 + 1] = cur[x * 3 + 1];
        out_row[x * 4 + 2] = cur[x * 3 + 2];
        out_row[x * 4 + 3] = 255;
      }
    }
    std::swap(prev, cur);
  }
  return 0;
}

}  // extern "C"
