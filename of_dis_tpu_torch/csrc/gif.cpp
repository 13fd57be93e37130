// Host-side pixel decoding of GIF frames for the serving pipeline and
// `load_image`, to the (C, H, W) uint8 layout the port's entry points
// take, with the values cv::imread gives (C = 1 IMREAD_GRAYSCALE, C = 3
// IMREAD_COLOR, B, G, R planes): the first image of the file on its
// logical screen.
//
// Replaces the cv2.imread fallback of of_dis_tpu/utils/io.py::load_image
// for GIF. Plain C entries, no CUDA, no codec library: Python walks the
// blocks (`utils/io.py::gif_blocks`), this file undoes the image's LZW
// and draws it. A ctypes call releases the interpreter lock, so a thread
// pool over frames runs it side by side.
//
// Which rules: OpenCV 5's own GIF reader (grfmt_gif.cpp), held to
// cv2.imread pixel for pixel by tests/test_torch_gif.py. The screen
// starts as the global table's background colour (black without a global
// table); the image's pixels are drawn in its rectangle, an index through
// the local table where it has the entry, else the global one, else
// (without any table) black for 0, white for 1 and the gray level i for
// any other i; the transparent index of the Graphic Control Extension
// before the image is not drawn. Gray is cvtColor's BGR2GRAY of that
// colour in 1/32768ths (gray.h). LZW as GIF writes it (codes LSB-first
// from the minimum code size + 1 bits, one bit more once the next free
// code reaches 2^n, at most 12, no new entry once the table holds 4096);
// a stream that OpenCV's reader would take other than by those rules (no
// End code, data after it, pixels past the image, an End code before its
// last pixel) is refused.

#include <cstddef>
#include <cstdint>
#include <new>
#include <vector>

#include "gray.h"

namespace {

enum Code {
  kOk = 0,
  kShort = -1,     // the data ends before the End code
  kLayout = -2,    // parameters the decoder does not take
  kLzw = -3,       // an undefined code, or a first code that is not a pixel
  kCount = -4,     // more or fewer pixels than the image holds
  kIndex = -5,     // an index no colour table has
  kNoMemory = -6,
};

struct Error {
  int code;
};

[[noreturn]] void fail(int code) { throw Error{code}; }

// The LZW codes of the image's data sub-blocks (from `at`, a length byte,
// to the zero length) into `npx` indices.
void lzw_decode(const uint8_t* raw, int64_t size, int64_t at, int min_size,
                int64_t npx, uint8_t* idx) {
  // the sub-blocks' bytes, one after another
  std::vector<uint8_t> data;
  for (;;) {
    if (at >= size) fail(kShort);
    const int len = raw[at++];
    if (len == 0) break;
    if (len > size - at) fail(kShort);
    data.insert(data.end(), raw + at, raw + at + len);
    at += len;
  }
  const int clear = 1 << min_size, end = clear + 1;
  std::vector<int16_t> prev(4096);
  std::vector<uint16_t> len(4096);
  std::vector<uint8_t> first(4096), last(4096);
  for (int i = 0; i < clear; ++i) {
    prev[i] = -1;
    len[i] = 1;
    first[i] = last[i] = static_cast<uint8_t>(i);
  }
  int width = min_size + 1, next = end + 1, old = -1;
  const int64_t nbits = static_cast<int64_t>(data.size()) * 8;
  int64_t bit = 0, pos = 0;
  for (;;) {
    if (bit + width > nbits) fail(kShort);  // no End code
    int code = 0;
    for (int k = 0; k < width; ++k, ++bit)
      code |= ((data[bit >> 3] >> (bit & 7)) & 1) << k;
    if (code == clear) {
      width = min_size + 1;
      next = end + 1;
      old = -1;
      continue;
    }
    if (code == end) break;
    if (pos >= npx) fail(kCount);
    if (old < 0) {
      if (code >= clear) fail(kLzw);
      idx[pos++] = static_cast<uint8_t>(code);
      old = code;
      continue;
    }
    if (code > next) fail(kLzw);  // not defined yet
    const bool known = code < next;
    if (next < 4096) {
      prev[next] = static_cast<int16_t>(old);
      len[next] = static_cast<uint16_t>(len[old] + 1);
      first[next] = first[old];
      last[next] = known ? first[code] : first[old];
      ++next;
      if (next == 1 << width && width < 12) ++width;
    }
    const int l = len[code];
    if (l > npx - pos) fail(kCount);
    int64_t o = pos + l - 1;
    for (int c = code; c >= 0; c = prev[c]) idx[o--] = last[c];
    pos += l;
    old = code;
  }
  if (pos != npx) fail(kCount);
  // nothing but the padding of the End code's last byte may follow it
  if ((bit + 7) / 8 != static_cast<int64_t>(data.size())) fail(kCount);
}

// The first image of a GIF: its data sub-blocks from byte `at` of the
// file `raw` (`size` bytes), LZW of `min_size`; its rectangle (fw x fh
// at left, top) on the logical screen W x H, interlaced or not; the
// global table (`gct`, `ngct` R, G, B entries, `bg` its background
// index) and the local one (`lct`, `nlct`); `transparent` the index not
// drawn, or -1. Into (want, H, W) uint8.
void decode(const uint8_t* raw, int64_t size, int64_t at, int min_size,
            int64_t fw, int64_t fh, int64_t left, int64_t top, int interlace,
            int64_t W, int64_t H, const uint8_t* gct, int ngct, int bg,
            const uint8_t* lct, int nlct, int transparent, int want,
            uint8_t* out) {
  if ((want != 1 && want != 3) || min_size < 2 || min_size > 8 || fw <= 0
      || fh <= 0 || left < 0 || top < 0 || left + fw > W || top + fh > H
      || (ngct > 0 && (bg < 0 || bg >= ngct)))
    fail(kLayout);
  std::vector<uint8_t> idx(static_cast<size_t>(fw * fh));
  lzw_decode(raw, size, at, min_size, fw * fh, idx.data());
  // B, G, R of each index, and what becomes of it: drawn, not drawn
  // (transparent), or an error (no table has the entry)
  enum { kDraw, kSkip, kNoEntry };
  uint8_t bgr[256][3] = {};
  uint8_t what[256];
  for (int i = 0; i < 256; ++i) {
    const uint8_t* rgb = i < nlct ? lct + 3 * i
                         : i < ngct ? gct + 3 * i : nullptr;
    what[i] = i == transparent ? kSkip
              : rgb != nullptr || (nlct == 0 && ngct == 0) ? kDraw
                                                           : kNoEntry;
    for (int c = 0; c < 3; ++c)  // no table: black, white, then i
      bgr[i][c] = rgb != nullptr ? rgb[2 - c]
                                 : static_cast<uint8_t>(i == 1 ? 255 : i);
  }
  const int64_t plane = W * H;
  const uint8_t fill[3] = {ngct ? gct[3 * bg + 2] : uint8_t{0},
                           ngct ? gct[3 * bg + 1] : uint8_t{0},
                           ngct ? gct[3 * bg] : uint8_t{0}};
  auto put = [&](int64_t o, const uint8_t* c) {
    if (want == 1) {
      out[o] = cvt_gray(c[0], c[1], c[2]);
    } else {
      out[o] = c[0];
      out[plane + o] = c[1];
      out[2 * plane + o] = c[2];
    }
  };
  for (int64_t o = 0; o < plane; ++o) put(o, fill);
  // image row k of the stream -> screen row
  std::vector<int64_t> rows;
  rows.reserve(static_cast<size_t>(fh));
  if (interlace) {
    static constexpr int kStart[4] = {0, 4, 2, 1}, kStep[4] = {8, 8, 4, 2};
    for (int pass = 0; pass < 4; ++pass)
      for (int64_t y = kStart[pass]; y < fh; y += kStep[pass])
        rows.push_back(y);
  } else {
    for (int64_t y = 0; y < fh; ++y) rows.push_back(y);
  }
  for (int64_t k = 0; k < fh; ++k) {
    const uint8_t* src = idx.data() + k * fw;
    const int64_t base = (top + rows[k]) * W + left;
    for (int64_t x = 0; x < fw; ++x) {
      const int i = src[x];
      if (what[i] == kNoEntry) fail(kIndex);
      if (what[i] == kDraw) put(base + x, bgr[i]);
    }
  }
}

}  // namespace

// See `decode`. Returns 0, or -1 for data that ends before the End code,
// -2 for parameters it does not take, -3 for corrupt LZW data, -4 for
// more or fewer pixels than the image holds, -5 for an index no colour
// table has, -6 out of memory.
extern "C" int64_t of_gif_decode(const uint8_t* raw, int64_t size,
                                 int64_t at, int min_size, int64_t fw,
                                 int64_t fh, int64_t left, int64_t top,
                                 int interlace, int64_t width,
                                 int64_t height, const uint8_t* gct,
                                 int ngct, int bg, const uint8_t* lct,
                                 int nlct, int transparent, int want,
                                 uint8_t* out) {
  try {
    decode(raw, size, at, min_size, fw, fh, left, top, interlace, width,
           height, gct, ngct, bg, lct, nlct, transparent, want, out);
    return 0;
  } catch (const Error& e) {
    return e.code;
  } catch (const std::bad_alloc&) {
    return kNoMemory;
  }
}
