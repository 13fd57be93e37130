// JPEG decoding on the host, pixel for pixel as cv::imread decodes a JPEG:
// libjpeg-turbo 3.1 with its default settings (the islow IDCT, "fancy"
// upsampling, block smoothing), output BGR or gray (or CMYK, which
// OpenCV then turns into BGR or gray itself), then the EXIF orientation
// applied as OpenCV's ApplyExifOrientation does.
//
// Reached through native/io.py (`decode_batch`) and utils/io.py
// (`load_image`); the JAX package reads the same files with cv2.imread
// (of_dis_tpu/utils/io.py::load_image, the reference's cv::imread at
// run_dense.cpp:200-210). Plain C entries, no CUDA: a ctypes call
// releases the interpreter lock, so a thread pool decodes frames side by
// side.
//
// What it reads: baseline and extended sequential (SOF0, SOF1, SOF9) and
// progressive (SOF2, SOF10) frames of 8-bit samples, Huffman or arithmetic
// coded (jdarith.c: the QM decoder, DAC conditioning), and lossless frames
// (SOF3, jdlossls.c / jdlhuff.c: predictors 1-7, point transform, sample
// precision 2-8, returned unscaled as libjpeg returns them); one component
// (gray), three (YCbCr, or RGB under an Adobe APP14 transform 0) or four
// (CMYK, or YCCK under an Adobe transform 2, then OpenCV's CMYK to BGR and
// to gray rules); any sampling factors 1-4 with integral ratios (1x1 in a
// lossless frame), any number of scans, restart markers, Motion-JPEG
// frames without DHT (libjpeg-turbo's standard tables), and, for TIFF's
// compression 7 (`of_jpeg_decode_tiff`), an abbreviated stream after the
// tables-only stream of the TIFF's JPEGTables tag.
// Damaged streams are read as libjpeg reads them with only a warning,
// where cv::imread returns the image: the file's end is followed by fake
// EOI markers (jdatasrc.c); bytes before a marker are skipped; a scan that
// runs into a marker reads zero bits, and libjpeg-turbo leaves the rest of
// its restart interval undecoded (arithmetic-coded data reads on as
// zeros); a Huffman code that is no code decodes as 0, an AC run past the
// band writes the zigzag position it lands on (63 past the block), a bad
// arithmetic code ends the interval's decoding; a wrong restart marker is
// resynchronised as jpeg_resync_to_restart does; scan parameters libjpeg
// only warns about are decoded as they stand; an unknown Adobe transform
// is YCbCr (3 components) or YCCK (4); a one-scan sequential file is
// decoded from its scan alone, whatever follows it; an unfinished
// progressive image is block-smoothed (jdcoefct.c
// decompress_smooth_data), and a component no scan reached reads 128.
// Blocks whose coefficients leave the C IDCT's range for 8-bit samples are
// computed as the AVX2 IDCT that cv2's libjpeg-turbo runs computes them
// (16-bit lanes). A JPEG strip of a TIFF (`of_jpeg_decode_tiff`) is read
// the same way, as libtiff's tif_jpeg.c has libjpeg read it.
// What it refuses, each with its own code (`of_jpeg_strerror`): what
// cv::imread fails on too (hierarchical and lossless arithmetic frames,
// 12-bit samples, 2 or more than 4 components, a lossless frame read in a
// colour space libjpeg would have to convert it to, a missing table, a
// marker segment libjpeg rejects, a progressive DC value past 32 bits, an
// invalid progression), and a lossless frame with a component
// in no scan (libjpeg leaves its samples undefined).
// Every read is bounds-checked: corrupt input returns an error code or the
// pixels libjpeg gives it.

#include <algorithm>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <new>
#include <vector>

#include "gray.h"
#include "orient.h"

namespace {

enum Code {
  kOk = 0,
  kNotJpeg = -1,
  kBadMarker = -3,
  kLosslessArith = -4,
  kLosslessColor = -5,
  kHierarchical = -6,
  kPrecision = -7,
  kComponents = -8,
  kSampling = -9,
  kNoHuffTable = -10,
  kNoQuantTable = -11,
  kBadHuffTable = -12,
  kCorrupt = -14,
  kProgression = -15,
  kSize = -18,
  kChannels = -19,
  kNoMemory = -20,
  kNoImage = -21,
  kLosslessSampling = -26,
  kLosslessRestart = -27,
  kTiffLossless = -28,
  kLosslessUnscanned = -29,
  kTiffSize = -30,
  kTiffScans = -31,
};

struct Error {
  int code;
};

[[noreturn]] void fail(int code) { throw Error{code}; }

// zigzag index -> natural (row-major) index (jutils.c jpeg_natural_order)
constexpr int kNatural[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// the same, then 16 entries of 63 (jpeg_natural_order's "extra entries for
// safety in decoder"): where corrupt data run past coefficient 63, libjpeg
// writes coefficient 63, and past the band's end the zigzag position there
constexpr int kNaturalPad[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

constexpr int kMaxDim = 65500;   // JPEG_MAX_DIMENSION
constexpr int kMaxBlocksInMcu = 10;
constexpr int kLookBits = 9;

inline int extend(int v, int s) {  // HUFF_EXTEND
  return v < (1 << (s - 1)) ? v + (-(1 << s) + 1) : v;
}

// A Huffman table as DHT gives it and its decoding form (jdhuff.c
// jpeg_make_d_derived_tbl): maxcode / valoffset per code length, and a
// table of the codes of at most kLookBits bits.
struct Huffman {
  bool defined = false;
  bool derived = false;
  uint8_t bits[17] = {};
  uint8_t vals[256] = {};
  int32_t maxcode[18] = {};
  int32_t valoffset[18] = {};
  uint16_t look[1 << kLookBits] = {};  // (length << 8) | symbol, 0 = none
  // AC tables: where a code and its magnitude bits fit in kLookBits, the
  // coefficient itself (jdhuff.c decode_mcu_fast's idea): its value, the
  // zero run before it, and the bits the pair takes (0 = none)
  struct FastAc {
    int16_t value;
    uint8_t run, len;
  } fast_ac[1 << kLookBits] = {};

  // dc: a DC table (jdhuff.c: its symbols must be 0..15, or 0..16 in a
  // lossless frame: `max_dc`), else AC
  void derive(bool dc, int max_dc) {
    if (derived) return;
    uint8_t size[257];
    uint32_t code_of[257];
    int p = 0;
    for (int l = 1; l <= 16; ++l) {
      int n = bits[l];
      if (p + n > 256) fail(kBadHuffTable);
      while (n--) size[p++] = static_cast<uint8_t>(l);
    }
    size[p] = 0;
    const int nsym = p;
    uint32_t code = 0;
    int si = size[0];
    p = 0;
    while (size[p]) {
      while (size[p] == si) code_of[p++] = code++;
      // no code may be all ones: the next code must still fit in si bits
      if (code >= (1u << si)) fail(kBadHuffTable);
      code <<= 1;
      ++si;
    }
    p = 0;
    for (int l = 1; l <= 16; ++l) {
      if (bits[l]) {
        valoffset[l] = p - static_cast<int32_t>(code_of[p]);
        p += bits[l];
        maxcode[l] = static_cast<int32_t>(code_of[p - 1]);
      } else {
        maxcode[l] = -1;
      }
    }
    valoffset[17] = 0;
    maxcode[17] = 0xFFFFF;
    std::memset(look, 0, sizeof(look));
    p = 0;
    for (int l = 1; l <= kLookBits; ++l) {
      for (int i = 1; i <= bits[l]; ++i, ++p) {
        int base = static_cast<int>(code_of[p]) << (kLookBits - l);
        for (int c = 0; c < (1 << (kLookBits - l)); ++c)
          look[base + c] = static_cast<uint16_t>((l << 8) | vals[p]);
      }
    }
    if (dc) {
      for (int i = 0; i < nsym; ++i)
        if (vals[i] > max_dc) fail(kBadHuffTable);
    }
    std::memset(fast_ac, 0, sizeof(fast_ac));
    for (int i = 0; !dc && i < (1 << kLookBits); ++i) {
      const int l = look[i] >> 8, rs = look[i] & 0xFF, sz = rs & 15;
      if (!l || !sz || l + sz > kLookBits) continue;
      const int mag = (i >> (kLookBits - l - sz)) & ((1 << sz) - 1);
      fast_ac[i] = {static_cast<int16_t>(extend(mag, sz)),
                    static_cast<uint8_t>(rs >> 4),
                    static_cast<uint8_t>(l + sz)};
    }
    derived = true;
  }
};

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int dw = 0, dh = 0;        // downsampled size (samples)
  int wb = 0, hb = 0;        // blocks that hold samples: ceil(dw / 8)...
  int stride_b = 0;          // blocks a row of the coefficient array
  int rows_b = 0;            // block rows of the coefficient array
  int16_t q[64] = {};        // latched quantisation table, natural order
  uint16_t qraw[64] = {};    // the same as DQT gave it (block smoothing)
  bool latched = false;
  bool seen = false;         // in a scan already (sequential)
  int coef_bits[64];         // progressive: -1 not yet seen, else Al
  int prev_bits[64];         // coef_bits before the component's last scan
  std::vector<int16_t> coef; // (rows_b, stride_b, 64)
  // lossless: the undifferenced samples mod 2^16 and the output samples
  // (dh, dw)
  std::vector<uint16_t> undiff;
  std::vector<uint8_t> px;
  int16_t* block(int by, int bx) {
    return coef.data() + (static_cast<size_t>(by) * stride_b + bx) * 64;
  }
};

// The input as libjpeg reads a file through jdatasrc.c's stdio source (how
// cv::imread reads it): the file's bytes, then, past its end, FF D9 (a fake
// EOI marker) at every refill, with a warning. `unread` is libjpeg's
// cinfo->unread_marker: a marker code that the entropy decoder or a
// restart check has read and the marker reader has not yet handled.
struct Source {
  const uint8_t* p = nullptr;
  const uint8_t* end = nullptr;
  int64_t past = 0;  // bytes of fake EOI markers read
  int unread = 0;

  void reset(const uint8_t* buf, int64_t len) {
    p = buf;
    end = buf + len;
    past = 0;
    unread = 0;
  }
  int byte() {
    if (p < end) return *p++;
    return past++ & 1 ? 0xD9 : 0xFF;  // JWRN_JPEG_EOF
  }
  // the next entropy-coded byte (jdhuff.c jpeg_fill_bit_buffer,
  // jdarith.c arith_decode): FF 00 is a data FF, FF fill bytes before a
  // marker code are swallowed, and a marker ends the data: its code goes
  // to `unread` and 0 is returned, as for every byte after it
  int data_byte() {
    if (unread) return 0;
    int c = byte();
    if (c != 0xFF) return c;
    do {
      c = byte();
    } while (c == 0xFF);
    if (c == 0) return 0xFF;
    unread = c;
    return 0;
  }
};

// The entropy-coded bytes of a scan, read as bits (jdhuff.c
// jpeg_fill_bit_buffer). Past a marker, zero bits are supplied and counted
// as `fake`; consuming one of them sets `insufficient` (JWRN_HIT_MARKER),
// after which libjpeg leaves the rest of the restart interval's MCUs
// undecoded.
struct BitReader {
  Source& s;
  uint64_t buf = 0;
  int n = 0;      // bits in buf (the low n bits)
  int fake = 0;   // the last `fake` of them are padding
  bool insufficient = false;

  explicit BitReader(Source& src) : s(src) {}

  void fill() {
    const uint8_t* p = s.p;
    while (n <= 56) {
      uint32_t c;
      if (!s.unread && p < s.end && *p != 0xFF) {
        c = *p++;
      } else {
        s.p = p;
        c = static_cast<uint32_t>(s.data_byte());
        p = s.p;
        if (s.unread) fake += 8;  // no data past a marker
      }
      buf = (buf << 8) | c;
      n += 8;
    }
    s.p = p;
  }

  void consume(int k) {
    n -= k;
    if (n < fake) insufficient = true;
  }

  int bits(int k) {  // k in 1..16
    if (n < k) fill();
    int v = static_cast<int>((buf >> (n - k)) & ((1u << k) - 1));
    consume(k);
    return v;
  }

  int bit() { return bits(1); }

  int peek() const {
    return static_cast<int>((buf >> (n - kLookBits)) &
                            ((1u << kLookBits) - 1));
  }

  // jdhuff.c jpeg_huff_decode: a code that is no code of the table takes
  // 17 bits and decodes as symbol 0 (JWRN_HUFF_BAD_CODE)
  int decode(const Huffman& t) {
    if (n < 17) fill();
    int look = peek();
    int e = t.look[look];
    if (e) {
      consume(e >> 8);
      return e & 0xFF;
    }
    int code = static_cast<int>((buf >> (n - 16)) & 0xFFFF);
    for (int l = kLookBits + 1; l <= 16; ++l) {
      int c = code >> (16 - l);
      if (c <= t.maxcode[l]) {
        consume(l);
        return t.vals[(c + t.valoffset[l]) & 0xFF];
      }
    }
    consume(17);  // JWRN_HUFF_BAD_CODE
    return 0;
  }

  // The bits left at the end of a scan or a restart interval are dropped
  // (jdhuff.c process_restart); a whole byte of them is data libjpeg
  // skips with a warning.
  void discard() {
    buf = 0;
    n = fake = 0;
  }
};

// T.81 Table D.2 as jaricom.c packs it: Qe << 16, Next_Index_MPS << 8,
// Switch_MPS << 7, Next_Index_LPS; entry 113 is the fixed 0.5 bin.
#define QM(qe, lps, mps, sw) \
  ((uint32_t{qe} << 16) | ((mps) << 8) | ((sw) << 7) | (lps))
constexpr uint32_t kAriTab[114] = {
    QM(0x5a1d, 1, 1, 1),      QM(0x2586, 14, 2, 0),     QM(0x1114, 16, 3, 0),
    QM(0x080b, 18, 4, 0),     QM(0x03d8, 20, 5, 0),     QM(0x01da, 23, 6, 0),
    QM(0x00e5, 25, 7, 0),     QM(0x006f, 28, 8, 0),     QM(0x0036, 30, 9, 0),
    QM(0x001a, 33, 10, 0),    QM(0x000d, 35, 11, 0),    QM(0x0006, 9, 12, 0),
    QM(0x0003, 10, 13, 0),    QM(0x0001, 12, 13, 0),    QM(0x5a7f, 15, 15, 1),
    QM(0x3f25, 36, 16, 0),    QM(0x2cf2, 38, 17, 0),    QM(0x207c, 39, 18, 0),
    QM(0x17b9, 40, 19, 0),    QM(0x1182, 42, 20, 0),    QM(0x0cef, 43, 21, 0),
    QM(0x09a1, 45, 22, 0),    QM(0x072f, 46, 23, 0),    QM(0x055c, 48, 24, 0),
    QM(0x0406, 49, 25, 0),    QM(0x0303, 51, 26, 0),    QM(0x0240, 52, 27, 0),
    QM(0x01b1, 54, 28, 0),    QM(0x0144, 56, 29, 0),    QM(0x00f5, 57, 30, 0),
    QM(0x00b7, 59, 31, 0),    QM(0x008a, 60, 32, 0),    QM(0x0068, 62, 33, 0),
    QM(0x004e, 63, 34, 0),    QM(0x003b, 32, 35, 0),    QM(0x002c, 33, 9, 0),
    QM(0x5ae1, 37, 37, 1),    QM(0x484c, 64, 38, 0),    QM(0x3a0d, 65, 39, 0),
    QM(0x2ef1, 67, 40, 0),    QM(0x261f, 68, 41, 0),    QM(0x1f33, 69, 42, 0),
    QM(0x19a8, 70, 43, 0),    QM(0x1518, 72, 44, 0),    QM(0x1177, 73, 45, 0),
    QM(0x0e74, 74, 46, 0),    QM(0x0bfb, 75, 47, 0),    QM(0x09f8, 77, 48, 0),
    QM(0x0861, 78, 49, 0),    QM(0x0706, 79, 50, 0),    QM(0x05cd, 48, 51, 0),
    QM(0x04de, 50, 52, 0),    QM(0x040f, 50, 53, 0),    QM(0x0363, 51, 54, 0),
    QM(0x02d4, 52, 55, 0),    QM(0x025c, 53, 56, 0),    QM(0x01f8, 54, 57, 0),
    QM(0x01a4, 55, 58, 0),    QM(0x0160, 56, 59, 0),    QM(0x0125, 57, 60, 0),
    QM(0x00f6, 58, 61, 0),    QM(0x00cb, 59, 62, 0),    QM(0x00ab, 61, 63, 0),
    QM(0x008f, 61, 32, 0),    QM(0x5b12, 65, 65, 1),    QM(0x4d04, 80, 66, 0),
    QM(0x412c, 81, 67, 0),    QM(0x37d8, 82, 68, 0),    QM(0x2fe8, 83, 69, 0),
    QM(0x293c, 84, 70, 0),    QM(0x2379, 86, 71, 0),    QM(0x1edf, 87, 72, 0),
    QM(0x1aa9, 87, 73, 0),    QM(0x174e, 72, 74, 0),    QM(0x1424, 72, 75, 0),
    QM(0x119c, 74, 76, 0),    QM(0x0f6b, 74, 77, 0),    QM(0x0d51, 75, 78, 0),
    QM(0x0bb6, 77, 79, 0),    QM(0x0a40, 77, 48, 0),    QM(0x5832, 80, 81, 1),
    QM(0x4d1c, 88, 82, 0),    QM(0x438e, 89, 83, 0),    QM(0x3bdd, 90, 84, 0),
    QM(0x34ee, 91, 85, 0),    QM(0x2eae, 92, 86, 0),    QM(0x299a, 93, 87, 0),
    QM(0x2516, 86, 71, 0),    QM(0x5570, 88, 89, 1),    QM(0x4ca9, 95, 90, 0),
    QM(0x44d9, 96, 91, 0),    QM(0x3e22, 97, 92, 0),    QM(0x3824, 99, 93, 0),
    QM(0x32b4, 99, 94, 0),    QM(0x2e17, 93, 86, 0),    QM(0x56a8, 95, 96, 1),
    QM(0x4f46, 101, 97, 0),   QM(0x47e5, 102, 98, 0),   QM(0x41cf, 103, 99, 0),
    QM(0x3c3d, 104, 100, 0),  QM(0x375e, 99, 93, 0),    QM(0x5231, 105, 102, 0),
    QM(0x4c0f, 106, 103, 0),  QM(0x4639, 107, 104, 0),  QM(0x415e, 103, 99, 0),
    QM(0x5627, 105, 106, 1),  QM(0x50e7, 108, 107, 0),  QM(0x4b85, 109, 103, 0),
    QM(0x5597, 110, 109, 0),  QM(0x504f, 111, 107, 0),  QM(0x5a10, 110, 111, 1),
    QM(0x5522, 112, 109, 0),  QM(0x59eb, 112, 111, 1),  QM(0x5a1d, 113, 113, 0)};
#undef QM

// The arithmetic-coded bytes of a scan, read by the QM decoder as
// jdarith.c::arith_decode reads them: a marker ends the data, after which
// zeros are supplied with no warning (the way every arithmetic-coded
// segment ends, and how data cut short, ended by the fake EOI, reads on).
struct ArithReader {
  Source& s;
  int64_t c = 0;    // C register: base of the interval and the bit buffer
  int64_t a = 0;    // A register: the interval's normalised size
  int ct = -16;     // bits left in the buffer part of C; -16: none read yet

  explicit ArithReader(Source& src) : s(src) {}

  void reset() {  // jdarith.c process_restart
    c = a = 0;
    ct = -16;
  }

  // one binary decision in the context `st` (T.81 D.2.4-D.2.6)
  int decode(uint8_t* st) {
    while (a < 0x8000) {
      if (--ct < 0) {
        c = (c << 8) | s.data_byte();
        if ((ct += 8) < 0 && ++ct == 0) a = 0x8000;  // the first 2 bytes in
      }
      a <<= 1;
    }
    int sv = *st;
    uint32_t qe = kAriTab[sv & 0x7F];
    const int nl = qe & 0xFF;
    qe >>= 8;
    const int nm = qe & 0xFF;
    qe >>= 8;
    int64_t temp = a - qe;
    a = temp;
    temp <<= ct;
    if (c >= temp) {
      c -= temp;
      if (a < qe) {  // conditional LPS exchange
        a = qe;
        *st = static_cast<uint8_t>((sv & 0x80) ^ nm);
      } else {
        a = qe;
        *st = static_cast<uint8_t>((sv & 0x80) ^ nl);
        sv ^= 0x80;
      }
    } else if (a < 0x8000) {  // conditional MPS exchange
      if (a < qe) {
        *st = static_cast<uint8_t>((sv & 0x80) ^ nl);
        sv ^= 0x80;
      } else {
        *st = static_cast<uint8_t>((sv & 0x80) ^ nm);
      }
    }
    return sv >> 7;
  }
};

// jstdhuff.c: the Huffman tables of JPEG Annex K.3 (bits per code length
// 1..16, then the symbols), DC and AC luminance, DC and AC chrominance
constexpr uint8_t kStdBitsDcL[16] = {0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
constexpr uint8_t kStdValsDcL[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
constexpr uint8_t kStdBitsAcL[16] = {0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
constexpr uint8_t kStdValsAcL[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
    0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08,
    0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
    0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9,
    0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
    0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
constexpr uint8_t kStdBitsDcC[16] = {0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
constexpr uint8_t kStdValsDcC[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
constexpr uint8_t kStdBitsAcC[16] = {0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
constexpr uint8_t kStdValsAcC[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
    0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1,
    0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26,
    0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a,
    0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7,
    0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
    0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
// DC luminance, AC luminance, DC chrominance, AC chrominance
const uint8_t* const kStdBits[4] = {kStdBitsDcL, kStdBitsAcL, kStdBitsDcC,
                                    kStdBitsAcC};
const uint8_t* const kStdVals[4] = {kStdValsDcL, kStdValsAcL, kStdValsDcC,
                                    kStdValsAcC};

struct Decoder {
  Source s;
  std::vector<uint8_t> seg;  // the payload of the marker segment last read

  int width = 0, height = 0, ncomp = 0, precision = 8;
  bool progressive = false, arithmetic = false, lossless = false;
  bool have_sof = false;
  bool jfif = false, adobe = false;
  int adobe_transform = -1;
  int orientation = 1;
  bool saw_exif = false;
  int restart_interval = 0;
  int next_restart = 0;     // jdmarker.c next_restart_num
  int max_h = 1, max_v = 1;
  int mcus_x = 0, mcus_y = 0;
  int scans = 0;            // SOS markers read (input_scan_number)
  int last_good = 0;        // jdmaster.c last_good_iMCU_row

  Component comp[4];
  Huffman dc_tab[4], ac_tab[4];
  bool qt_defined[4] = {};
  uint16_t qt[4][64] = {};
  // arithmetic conditioning per table (DAC; get_soi's defaults)
  uint8_t dc_L[16], dc_U[16], ac_K[16];

  Decoder(const uint8_t* buf, int64_t len) {
    s.reset(buf, len);
    std::memset(dc_L, 0, sizeof(dc_L));
    std::memset(dc_U, 1, sizeof(dc_U));
    std::memset(ac_K, 5, sizeof(ac_K));
  }

  int byte() { return s.byte(); }
  int u16() {
    int hi = byte();
    return (hi << 8) | byte();
  }

  // jdmarker.c first_marker: the stream starts FF D8
  void first_marker() {
    if (s.end - s.p < 2 || s.p[0] != 0xFF || s.p[1] != 0xD8) fail(kNotJpeg);
    s.p += 2;
  }

  // jdmarker.c next_marker: the next marker code; bytes before its FF,
  // and FF 00 pairs, are skipped (JWRN_EXTRANEOUS_DATA), FF fill bytes
  // swallowed
  int next_marker() {
    for (;;) {
      int c = byte();
      while (c != 0xFF) c = byte();  // JWRN_EXTRANEOUS_DATA
      do {
        c = byte();
      } while (c == 0xFF);
      if (c != 0) return c;
    }
  }

  // the marker to handle next: the one the entropy decoder stopped at, or
  // the next in the stream (jdmarker.c read_markers)
  int take_marker() {
    const int code = s.unread ? s.unread : next_marker();
    s.unread = 0;
    return code;
  }

  // a marker segment's payload into `seg`, `length - 2` bytes; `lax`: a
  // length below 2 is no error and skips nothing (skip_variable,
  // get_interesting_appn, save_marker), else JERR_BAD_LENGTH
  void segment(bool lax = false) {
    const int length = u16();
    seg.clear();
    if (length < 2) {
      if (!lax) fail(kBadMarker);
      return;
    }
    seg.resize(static_cast<size_t>(length - 2));
    const int64_t have = s.end - s.p;
    if (have >= length - 2) {
      std::memcpy(seg.data(), s.p, seg.size());
      s.p += length - 2;
    } else {
      for (uint8_t& b : seg) b = static_cast<uint8_t>(byte());
    }
  }

  // jdmarker.c get_dqt: any nonzero precision nibble reads 16-bit values
  void read_dqt() {
    segment();
    const uint8_t* s8 = seg.data();
    const int len = static_cast<int>(seg.size());
    int i = 0;
    while (i < len) {
      int pq = s8[i] >> 4, tq = s8[i] & 15;
      ++i;
      if (tq >= 4) fail(kBadMarker);
      int need = pq ? 128 : 64;
      if (len - i < need) fail(kBadMarker);
      for (int k = 0; k < 64; ++k) {
        int v = pq ? (s8[i + 2 * k] << 8) | s8[i + 2 * k + 1] : s8[i + k];
        qt[tq][kNatural[k]] = static_cast<uint16_t>(v);
      }
      qt_defined[tq] = true;
      i += need;
    }
  }

  // jdmarker.c get_dac: per arithmetic table, DC conditioning L <= U
  // (0-15 each) and the AC threshold Kx
  void read_dac() {
    segment();
    const int len = static_cast<int>(seg.size());
    if (len % 2) fail(kBadMarker);
    for (int i = 0; i < len; i += 2) {
      const int index = seg[i], val = seg[i + 1];
      if (index >= 32) fail(kBadMarker);
      if (index >= 16) {
        ac_K[index - 16] = static_cast<uint8_t>(val);
      } else {
        dc_L[index] = static_cast<uint8_t>(val & 15);
        dc_U[index] = static_cast<uint8_t>(val >> 4);
        if (dc_L[index] > dc_U[index]) fail(kBadMarker);
      }
    }
  }

  void read_dht() {  // jdmarker.c get_dht
    segment();
    const uint8_t* s8 = seg.data();
    const int len = static_cast<int>(seg.size());
    int i = 0;
    while (i < len) {
      if (len - i < 17) fail(kBadMarker);
      int index = s8[i];
      int count = 0;
      uint8_t bits[17] = {};
      for (int l = 1; l <= 16; ++l) {
        bits[l] = s8[i + l];
        count += bits[l];
      }
      i += 17;
      if (count > 256 || count > len - i) fail(kBadHuffTable);
      Huffman* t;
      if (index & 0x10) {
        index -= 0x10;
        if (index < 0 || index >= 4) fail(kBadHuffTable);
        t = &ac_tab[index];
      } else {
        if (index < 0 || index >= 4) fail(kBadHuffTable);
        t = &dc_tab[index];
      }
      *t = Huffman();
      std::memcpy(t->bits, bits, sizeof(bits));
      std::memcpy(t->vals, s8 + i, static_cast<size_t>(count));
      t->defined = true;
      i += count;
    }
  }

  // OpenCV's ExifReader (exif.cpp) on the first APP1 segment that starts
  // "Exif\0\0", before the first SOS: a TIFF header ("II" little-endian,
  // else big-endian), then IFD0's entries in order until the first 0x0112
  // tag, whose value is the u16 at entry + 8. A read out of bounds ends
  // the walk with no orientation, as ExifParsingError does: the offsets
  // that OpenCV's readers of the string and rational tags follow are
  // checked too, since they throw before a later orientation is reached.
  void read_exif(const uint8_t* s, int len) {
    if (len <= 6 || std::memcmp(s, "Exif\0\0", 6) != 0) return;
    const uint8_t* t = s + 6;
    const int64_t size = len - 6;
    const bool intel = t[0] == 'I' && size > 1 && t[1] == 'I';
    auto u16at = [&](int64_t off, int* v) {
      if (off < 0 || off + 1 >= size) return false;
      *v = intel ? t[off] | (t[off + 1] << 8) : (t[off] << 8) | t[off + 1];
      return true;
    };
    auto u32at = [&](int64_t off, uint32_t* v) {
      if (off < 0 || off + 3 >= size) return false;
      *v = intel ? static_cast<uint32_t>(t[off]) | (t[off + 1] << 8) |
                       (t[off + 2] << 16) |
                       (static_cast<uint32_t>(t[off + 3]) << 24)
                 : (static_cast<uint32_t>(t[off]) << 24) |
                       (t[off + 1] << 16) | (t[off + 2] << 8) | t[off + 3];
      return true;
    };
    auto rationals = [&](int64_t off, int n) {  // getResolution & co.
      uint32_t at, v;
      if (!u32at(off + 8, &at)) return false;
      for (int i = 0; i < n; ++i)
        if (!u32at(int64_t{at} + 8 * i, &v) ||
            !u32at(int64_t{at} + 8 * i + 4, &v))
          return false;
      return true;
    };
    int mark, count, v;
    uint32_t ifd, n, at;
    if (!u16at(2, &mark) || mark != 0x2A) return;
    if (!u32at(4, &ifd) || !u16at(ifd, &count)) return;
    int64_t off = int64_t{ifd} + 2;
    for (int e = 0; e < count; ++e, off += 12) {
      int tag;
      if (!u16at(off, &tag)) return;
      bool ok = true;
      switch (tag) {
        case 0x0112:  // ORIENTATION
          if (u16at(off + 8, &v)) orientation = v;
          return;
        case 0x010E: case 0x010F: case 0x0110: case 0x0131: case 0x0132:
        case 0x8298:  // getString
          at = 8;
          ok = u32at(off + 4, &n) && (n <= 4 || u32at(off + 8, &at)) &&
               int64_t{at} <= size && int64_t{at} + n <= size;
          break;
        case 0x011A: case 0x011B: ok = rationals(off, 1); break;
        case 0x013E: ok = rationals(off, 2); break;
        case 0x013F: case 0x0214: ok = rationals(off, 6); break;
        case 0x0211: ok = rationals(off, 3); break;
        case 0x0128: case 0x0213: ok = u16at(off + 8, &v); break;
        default: break;
      }
      if (!ok) return;
    }
  }

  void read_app(int code) {
    segment(true);
    const uint8_t* s = seg.data();
    const int len = static_cast<int>(seg.size());
    if (code == 0xE0 && len >= 14 && std::memcmp(s, "JFIF\0", 5) == 0)
      jfif = true;
    if (code == 0xEE && len >= 12 && std::memcmp(s, "Adobe", 5) == 0) {
      adobe = true;
      adobe_transform = s[11];
    }
    if (code == 0xE1 && !saw_exif && !scans && len > 6 &&
        std::memcmp(s, "Exif\0\0", 6) == 0) {
      saw_exif = true;
      read_exif(s, len);
    }
  }

  // get_sof, and what jdinput.c initial_setup and jdmaster.c then refuse
  // (hierarchical frames, lossless arithmetic, precisions that cv::imread's
  // 8-bit reads do not take) or what no colour space of libjpeg's takes
  // (2 or more than 4 components)
  void read_sof(int code) {
    if (have_sof) fail(kBadMarker);
    segment();
    const uint8_t* s = seg.data();
    const int len = static_cast<int>(seg.size());
    if (len < 6) fail(kBadMarker);
    precision = s[0];
    height = (s[1] << 8) | s[2];
    width = (s[3] << 8) | s[4];
    ncomp = s[5];
    if ((code >= 0xC5 && code <= 0xC7) || code >= 0xCD) fail(kHierarchical);
    if (code == 0xCB) fail(kLosslessArith);
    lossless = code == 0xC3;
    arithmetic = code >= 0xC9;
    progressive = code == 0xC2 || code == 0xCA;
    if (lossless ? precision < 2 || precision > 8 : precision != 8)
      fail(kPrecision);
    if (height <= 0 || width <= 0 || ncomp <= 0) fail(kSize);
    if (height > kMaxDim || width > kMaxDim) fail(kSize);
    if (ncomp != 1 && ncomp != 3 && ncomp != 4) fail(kComponents);
    if (len != 6 + 3 * ncomp) fail(kBadMarker);
    for (int c = 0; c < ncomp; ++c) {
      Component& k = comp[c];
      k.id = s[6 + 3 * c];
      k.h = s[7 + 3 * c] >> 4;
      k.v = s[7 + 3 * c] & 15;
      k.tq = s[8 + 3 * c];
      if (k.h < 1 || k.h > 4 || k.v < 1 || k.v > 4) fail(kSampling);
      max_h = k.h > max_h ? k.h : max_h;
      max_v = k.v > max_v ? k.v : max_v;
    }
    have_sof = true;
  }

  // Sizes and buffers: blocks of 8x8 coefficients, or, in a lossless
  // frame (a "block" of one sample), the samples themselves.
  void setup_components() {
    const int bs = lossless ? 1 : 8;
    mcus_x = (width + bs * max_h - 1) / (bs * max_h);
    mcus_y = (height + bs * max_v - 1) / (bs * max_v);
    for (int c = 0; c < ncomp; ++c) {
      Component& k = comp[c];
      k.dw = static_cast<int>((static_cast<int64_t>(width) * k.h + max_h - 1) / max_h);
      k.dh = static_cast<int>((static_cast<int64_t>(height) * k.v + max_v - 1) / max_v);
      if (lossless) {
        const size_t n = static_cast<size_t>(k.dw) * k.dh;
        k.undiff.assign(n, 0);
        k.px.assign(n, 0);
        continue;
      }
      k.wb = (k.dw + 7) / 8;
      k.hb = (k.dh + 7) / 8;
      k.stride_b = mcus_x * k.h;
      k.rows_b = mcus_y * k.v;
      k.coef.assign(static_cast<size_t>(k.stride_b) * k.rows_b * 64, 0);
      for (int i = 0; i < 64; ++i) k.coef_bits[i] = -1;
      for (int i = 0; i < 64; ++i) k.prev_bits[i] = -1;
    }
  }

  // The header: markers up to the first SOS (jdmarker.c read_markers, as
  // jpeg_read_header runs them). Returns with the stream after the SOS
  // code, in a sequential Huffman-coded frame the standard Huffman tables
  // installed in DC and AC slots 0 and 1 that no DHT has defined
  // (jstdhuff.c std_huff_tables, which jdhuff.c runs as it starts, and
  // the progressive and lossless decoders do not: Motion-JPEG frames carry
  // none).
  void read_header() {
    first_marker();
    for (;;) {
      int code = next_marker();
      if (code == 0xDA) {
        if (!have_sof) fail(kBadMarker);
        for (int i = 0; i < 2 && !progressive && !lossless; ++i) {
          std_table(&dc_tab[i], kStdBits[2 * i], kStdVals[2 * i]);
          std_table(&ac_tab[i], kStdBits[2 * i + 1], kStdVals[2 * i + 1]);
        }
        return;
      }
      if (code == 0xD9) fail(kNoImage);  // tables only (JERR_NO_IMAGE)
      handle_marker(code);
    }
  }

  // A tables-only ("abbreviated table specification") stream: SOI, then
  // DQT, DHT, DRI, APPn and COM segments to EOI, as jpeg_read_header
  // takes it before an abbreviated image stream (TIFF's JPEGTables).
  void read_tables() {
    first_marker();
    for (;;) {
      int code = next_marker();
      if (code == 0xD9) return;
      if (code == 0xDA || (code >= 0xC0 && code <= 0xCF && code != 0xC4))
        fail(kBadMarker);
      handle_marker(code);
    }
  }

  static void std_table(Huffman* t, const uint8_t* bits, const uint8_t* vals) {
    if (t->defined) return;
    int count = 0;
    for (int l = 1; l <= 16; ++l) {
      t->bits[l] = bits[l - 1];
      count += bits[l - 1];
    }
    std::memcpy(t->vals, vals, static_cast<size_t>(count));
    t->defined = true;
  }

  // every marker but SOI, SOS and EOI (jdmarker.c read_markers)
  void handle_marker(int code) {
    if ((code >= 0xD0 && code <= 0xD7) || code == 0x01) return;  // no payload
    if (code == 0xD8 || code == 0xD9) fail(kBadMarker);
    if (code >= 0xC0 && code <= 0xCF && code != 0xC4 && code != 0xC8 &&
        code != 0xCC) {
      read_sof(code);
    } else if (code == 0xCC) {
      read_dac();
    } else if (code == 0xC4) {
      read_dht();
    } else if (code == 0xDB) {
      read_dqt();
    } else if (code == 0xDD) {
      segment();
      if (seg.size() != 2) fail(kBadMarker);
      restart_interval = (seg[0] << 8) | seg[1];
    } else if (code >= 0xE0 && code <= 0xEF) {
      read_app(code);
    } else if (code == 0xFE || code == 0xDC) {
      segment(true);  // COM, DNL: skip_variable
    } else {
      fail(kBadMarker);  // DHP, EXP, JPGn, reserved
    }
  }

  // ---- scans ----

  struct Scan {
    int n = 0;
    int ci[4];
    int td[4], ta[4];
    int ss = 0, se = 63, ah = 0, al = 0;
  };

  // get_sos. Scan slot i takes the first component of the id at index i
  // or later (libjpeg-turbo's check against a component listed twice
  // looks at cur_comp_info[ci], the slots by component index).
  Scan read_sos() {
    segment();
    const uint8_t* s8 = seg.data();
    const int len = static_cast<int>(seg.size());
    Scan sc;
    if (len < 1) fail(kBadMarker);
    sc.n = s8[0];
    if (sc.n < 1 || sc.n > 4 || len != 2 * sc.n + 4) fail(kBadMarker);
    for (int i = 0; i < sc.n; ++i) {
      int cid = s8[1 + 2 * i], t = s8[2 + 2 * i];
      int found = -1;
      for (int c = i; c < ncomp && found < 0; ++c)
        if (comp[c].id == cid) found = c;
      if (found < 0) fail(kBadMarker);
      sc.ci[i] = found;
      sc.td[i] = t >> 4;
      sc.ta[i] = t & 15;
    }
    sc.ss = s8[1 + 2 * sc.n];
    sc.se = s8[2 + 2 * sc.n];
    sc.ah = s8[3 + 2 * sc.n] >> 4;
    sc.al = s8[3 + 2 * sc.n] & 15;
    next_restart = 0;
    ++scans;
    return sc;
  }

  Huffman& table(Huffman* tabs, int index, bool dc) {
    if (index < 0 || index >= 4 || !tabs[index].defined) fail(kNoHuffTable);
    tabs[index].derive(dc, lossless ? 16 : 15);
    return tabs[index];
  }

  void latch(Component& k) {  // jdinput.c latch_quant_tables
    if (k.latched) return;
    if (k.tq >= 4 || !qt_defined[k.tq]) fail(kNoQuantTable);
    for (int i = 0; i < 64; ++i) {
      k.qraw[i] = qt[k.tq][i];
      k.q[i] = static_cast<int16_t>(qt[k.tq][i]);  // ISLOW_MULT_TYPE
    }
    k.latched = true;
  }

  // jdhuff.c / jdphuff.c / jdarith.c start_pass: what libjpeg refuses
  // (`bad`) and what it only warns about, which is decoded as it stands
  void check_scan(const Scan& sc) {
    if (!progressive) {  // JWRN_NOT_SEQUENTIAL; decoded as sequential
      for (int i = 0; i < sc.n; ++i) comp[sc.ci[i]].seen = true;
      return;
    }
    const bool dc = sc.ss == 0;
    bool bad = false;
    if (dc) {
      if (sc.se != 0) bad = true;
    } else {
      if (sc.ss > sc.se || sc.se > 63) bad = true;
      if (sc.n != 1) bad = true;
    }
    if (sc.ah != 0 && sc.al != sc.ah - 1) bad = true;
    if (sc.al > 13) bad = true;
    if (bad) fail(kProgression);
    for (int i = 0; i < sc.n; ++i) {  // JWRN_BOGUS_PROGRESSION
      Component& k = comp[sc.ci[i]];
      int* cb = k.coef_bits;
      const int lo = sc.ss < 1 ? sc.ss : 1, hi = sc.se > 9 ? sc.se : 9;
      for (int c = lo; c <= hi; ++c) k.prev_bits[c] = scans > 1 ? cb[c] : 0;
      for (int c = sc.ss; c <= sc.se; ++c) cb[c] = sc.al;
    }
  }

  // The Huffman decoding of a scan's blocks (jdhuff.c, jdphuff.c).
  struct HuffScan {
    Decoder& d;
    const Scan& sc;
    BitReader br;
    Huffman* dct[4];
    Huffman* act[4];
    int last_dc[4] = {0, 0, 0, 0};
    int eobrun = 0;

    // decode_mcu: an MCU after the one that ran out of data is left as it
    // stands (DC refinement reads zero bits there, which change nothing)
    bool out_of_data() const { return br.insufficient; }
    bool skip() const { return br.insufficient; }
    void block(int i, int16_t* blk) {
      d.decode_block(br, sc, i, blk, dct[i], act[i], last_dc, eobrun);
    }
    void restart() {  // jdhuff.c / jdphuff.c process_restart
      br.discard();
      d.read_restart_marker();
      last_dc[0] = last_dc[1] = last_dc[2] = last_dc[3] = 0;
      eobrun = 0;
      // out of data again at once if the restart left a marker unread
      if (!d.s.unread) br.insufficient = false;
    }
    void end() { br.discard(); }
  };

  // The arithmetic decoding of a scan's blocks (jdarith.c): statistics
  // areas per table, reset with the DC predictions at the scan's start and
  // at each restart. A bad code (JWRN_ARITH_BAD_CODE) ends the MCU where it
  // is, and the MCUs up to the next restart are left as they stand.
  struct ArithScan {
    Decoder& d;
    const Scan& sc;
    ArithReader ar;
    bool dead = false;  // jdarith.c's ct == -1
    uint8_t dc_stats[16][64];
    uint8_t ac_stats[16][256];
    uint8_t fixed_bin[4] = {113, 0, 0, 0};  // probability 0.5, never moves
    int last_dc[4] = {0, 0, 0, 0};
    int dc_context[4] = {0, 0, 0, 0};

    ArithScan(Decoder& d_, const Scan& sc_) : d(d_), sc(sc_), ar(d_.s) {
      reset();
    }

    void reset() {
      for (int i = 0; i < sc.n; ++i) {
        if (!d.progressive || (sc.ss == 0 && sc.ah == 0)) {
          std::memset(dc_stats[sc.td[i]], 0, sizeof(dc_stats[0]));
          last_dc[i] = dc_context[i] = 0;
        }
        if (!d.progressive || sc.ss)
          std::memset(ac_stats[sc.ta[i]], 0, sizeof(ac_stats[0]));
      }
    }
    bool out_of_data() const { return false; }  // read on as zeros
    bool skip() const { return dead; }
    void restart() {  // jdarith.c process_restart
      d.read_restart_marker();
      reset();
      ar.reset();
      dead = false;
    }
    void end() {}
    void bad_code() { dead = true; }  // JWRN_ARITH_BAD_CODE

    // F.2.4.1: a DC difference into *out, and its conditioning category
    // for the next; false on a magnitude overflow (a bad code)
    bool dc_diff(int i, int* out) {
      const int tbl = sc.td[i];
      uint8_t* st = dc_stats[tbl] + dc_context[i];
      if (!ar.decode(st)) {
        dc_context[i] = 0;
        *out = 0;
        return true;
      }
      const int sign = ar.decode(st + 1);
      st += 2 + sign;
      int m = ar.decode(st);
      if (m) {
        st = dc_stats[tbl] + 20;
        while (ar.decode(st)) {
          if ((m <<= 1) == 0x8000) return false;
          ++st;
        }
      }
      if (m < ((1 << d.dc_L[tbl]) >> 1))
        dc_context[i] = 0;
      else if (m > ((1 << d.dc_U[tbl]) >> 1))
        dc_context[i] = 12 + sign * 4;
      else
        dc_context[i] = 4 + sign * 4;
      int v = m;
      st += 14;
      while (m >>= 1)
        if (ar.decode(st)) v |= m;
      v += 1;
      *out = sign ? -v : v;
      return true;
    }

    // F.2.4.2: the AC coefficients ss..se of a block, scaled by 2^al;
    // false on a run past se or a magnitude overflow (a bad code)
    bool ac_first(int tbl, int ss, int se, int al, int16_t* blk) {
      for (int k = ss; k <= se; ++k) {
        uint8_t* st = ac_stats[tbl] + 3 * (k - 1);
        if (ar.decode(st)) break;  // end of block
        while (!ar.decode(st + 1)) {
          st += 3;
          if (++k > se) return false;
        }
        const int sign = ar.decode(fixed_bin);
        st += 2;
        int m = ar.decode(st);
        if (m && ar.decode(st)) {
          m <<= 1;
          st = ac_stats[tbl] + (k <= d.ac_K[tbl] ? 189 : 217);
          while (ar.decode(st)) {
            if ((m <<= 1) == 0x8000) return false;
            ++st;
          }
        }
        int v = m;
        st += 14;
        while (m >>= 1)
          if (ar.decode(st)) v |= m;
        v += 1;
        if (sign) v = -v;
        blk[kNatural[k]] =
            static_cast<int16_t>(static_cast<uint32_t>(v) << al);
      }
      return true;
    }

    // decode_mcu_AC_refine: a bit more of each coefficient of ss..se;
    // false on a run past se (a bad code)
    bool ac_refine(int16_t* blk) {
      const int tbl = sc.ta[0];
      const int p1 = 1 << sc.al, m1 = -(1 << sc.al);
      int kex = sc.se;  // the previous stage's end of block
      for (; kex > 0; --kex)
        if (blk[kNatural[kex]]) break;
      for (int k = sc.ss; k <= sc.se; ++k) {
        uint8_t* st = ac_stats[tbl] + 3 * (k - 1);
        if (k > kex && ar.decode(st)) break;  // end of block
        for (;;) {
          int16_t* c = blk + kNatural[k];
          if (*c) {  // nonzero before: a correction bit
            if (ar.decode(st + 2))
              *c = static_cast<int16_t>(*c + (*c < 0 ? m1 : p1));
            break;
          }
          if (ar.decode(st + 1)) {  // newly nonzero
            *c = static_cast<int16_t>(ar.decode(fixed_bin) ? m1 : p1);
            break;
          }
          st += 3;
          if (++k > sc.se) return false;
        }
      }
      return true;
    }

    // one block of the MCU; after a bad code the MCU's other blocks are
    // left as they stand
    void block(int i, int16_t* blk) {
      if (dead) return;
      int diff;
      bool ok = true;
      if (!d.progressive) {  // decode_mcu
        ok = dc_diff(i, &diff);
        if (ok) {
          last_dc[i] = (last_dc[i] + diff) & 0xFFFF;
          blk[0] = static_cast<int16_t>(last_dc[i]);
          ok = ac_first(sc.ta[i], 1, 63, 0, blk);
        }
      } else if (sc.ss == 0 && sc.ah == 0) {  // decode_mcu_DC_first
        ok = dc_diff(i, &diff);
        if (ok) {
          last_dc[i] = (last_dc[i] + diff) & 0xFFFF;
          blk[0] = static_cast<int16_t>(
              static_cast<uint32_t>(last_dc[i]) << sc.al);
        }
      } else if (sc.ss == 0) {  // decode_mcu_DC_refine
        if (ar.decode(fixed_bin))
          blk[0] = static_cast<int16_t>(blk[0] | (1 << sc.al));
      } else if (sc.ah == 0) {  // decode_mcu_AC_first
        ok = ac_first(sc.ta[0], sc.ss, sc.se, sc.al, blk);
      } else {
        ok = ac_refine(blk);
      }
      if (!ok) bad_code();
    }
  };

  // jdmarker.c read_restart_marker: the RSTn due next, else
  // jpeg_resync_to_restart's choice by the marker found (JWRN_MUST_RESYNC):
  // any other RST but the next two or the last two, or the one due found
  // after skipping, is swallowed and decoding goes on (1); a marker below
  // SOF0 or one of the last two RSTs is skipped to the next marker, and the
  // choice made again (2); any other marker, or one of the next two RSTs,
  // is left unread, so the interval reads as out of data (3).
  void read_restart_marker() {
    if (!s.unread) s.unread = next_marker();
    const int want = next_restart;
    if (s.unread == 0xD0 + want) {
      s.unread = 0;
    } else {  // JWRN_MUST_RESYNC
      for (;;) {
        const int m = s.unread;
        int action = 1;
        if (m < 0xC0) {
          action = 2;
        } else if (m < 0xD0 || m > 0xD7) {
          action = 3;
        } else if (m == 0xD0 + ((want + 1) & 7) ||
                   m == 0xD0 + ((want + 2) & 7)) {
          action = 3;
        } else if (m == 0xD0 + ((want - 1) & 7) ||
                   m == 0xD0 + ((want - 2) & 7)) {
          action = 2;
        }
        if (action == 1) {
          s.unread = 0;
          break;
        }
        if (action == 3) break;
        s.unread = next_marker();
      }
    }
    next_restart = (next_restart + 1) & 7;
  }

  // The blocks of a scan in MCU order, restart markers between intervals
  // (jdcoefct.c consume_data: `last_good` is the iMCU row of the last MCU
  // begun with data left, before its restart is processed).
  template <class Entropy>
  void run_scan(const Scan& sc, Entropy& e) {
    int nx, ny, vrows;
    if (sc.n == 1) {
      nx = comp[sc.ci[0]].wb;
      ny = comp[sc.ci[0]].hb;
      vrows = comp[sc.ci[0]].v;
    } else {
      nx = mcus_x;
      ny = mcus_y;
      vrows = 1;
    }
    int to_go = restart_interval;
    const int total = nx * ny;
    for (int m = 0; m < total; ++m) {
      const int mx = m % nx, my = m / nx;
      if (!e.out_of_data()) last_good = my / vrows;
      if (restart_interval) {
        if (to_go == 0) {
          e.restart();
          to_go = restart_interval;
        }
        --to_go;
      }
      if (e.skip()) continue;
      if (sc.n == 1) {
        e.block(0, comp[sc.ci[0]].block(my, mx));
      } else {
        for (int i = 0; i < sc.n; ++i) {
          Component& k = comp[sc.ci[i]];
          for (int by = 0; by < k.v; ++by)
            for (int bx = 0; bx < k.h; ++bx)
              e.block(i, k.block(my * k.v + by, mx * k.h + bx));
        }
      }
    }
    e.end();
  }

  // one scan's entropy-coded data, up to the marker after it (left in
  // `s.unread` where the decoder stopped at it)
  void decode_scan(const Scan& sc) {
    if (lossless) return decode_lossless_scan(sc);
    check_scan(sc);
    Huffman* dct[4] = {};
    Huffman* act[4] = {};
    int blocks = 0;
    for (int i = 0; i < sc.n; ++i) {
      Component& k = comp[sc.ci[i]];
      latch(k);
      blocks += sc.n == 1 ? 1 : k.h * k.v;
      if (arithmetic) continue;  // tables 0-15, defined or not (jdarith.c)
      if (!progressive) {
        dct[i] = &table(dc_tab, sc.td[i], true);
        act[i] = &table(ac_tab, sc.ta[i], false);
      } else if (sc.ss == 0) {
        if (sc.ah == 0) dct[i] = &table(dc_tab, sc.td[i], true);
      } else {
        act[i] = &table(ac_tab, sc.ta[i], false);
      }
    }
    if (blocks > kMaxBlocksInMcu) fail(kSampling);
    if (arithmetic) {
      ArithScan e(*this, sc);
      return run_scan(sc, e);
    }
    HuffScan e{*this, sc, BitReader(s), {}, {}};
    for (int i = 0; i < sc.n; ++i) {
      e.dct[i] = dct[i];
      e.act[i] = act[i];
    }
    run_scan(sc, e);
  }

  // A lossless scan (jdlhuff.c, jddiffct.c, jdlossls.c): Huffman-coded
  // differences, MCU row by MCU row (an interleaved MCU holds h x v samples
  // of each component, a non-interleaved one a sample), each row then
  // undifferenced by the scan's predictor. The first row of the scan and of
  // each restart interval predicts from the left only, starting at
  // 2^(P - Pt - 1); the first column from above. Samples are kept mod 2^16
  // and returned as (uint8)(sample << Pt).
  // Where the data run out (jdlhuff.c decode_mcus), the rows after the
  // one that ran out read zero differences predicted as a first row.
  void decode_lossless_scan(const Scan& sc) {
    if (sc.ss < 1 || sc.ss > 7 || sc.se != 0 || sc.ah != 0 ||
        sc.al >= precision)
      fail(kProgression);
    const Huffman* dct[4] = {};
    int blocks = 0;
    for (int i = 0; i < sc.n; ++i) {
      Component& k = comp[sc.ci[i]];
      k.seen = true;
      dct[i] = &table(dc_tab, sc.td[i], true);
      blocks += sc.n == 1 ? 1 : k.h * k.v;
    }
    if (blocks > kMaxBlocksInMcu) fail(kSampling);
    const bool inter = sc.n > 1;
    const int nx = inter ? mcus_x : comp[sc.ci[0]].dw;
    const int ny = inter ? mcus_y : comp[sc.ci[0]].dh;
    // jddiffct.c start_input_pass (an error, not a warning)
    if (restart_interval % nx) fail(kLosslessRestart);
    // one iMCU row of differences a component: v rows
    std::vector<int32_t> diff[4];
    int dstride[4];
    bool first[4];
    for (int i = 0; i < sc.n; ++i) {
      const Component& k = comp[sc.ci[i]];
      dstride[i] = inter ? nx * k.h : nx;
      diff[i].assign(static_cast<size_t>(k.v) * dstride[i], 0);
      first[i] = true;
    }
    const int init = 1 << (precision - sc.al - 1);
    BitReader br(s);
    int rows_to_go = restart_interval / nx;
    for (int my = 0; my < ny; ++my) {
      if (restart_interval) {
        if (rows_to_go == 0) {  // jddiffct.c / jdlhuff.c process_restart
          br.discard();
          read_restart_marker();
          if (!s.unread) br.insufficient = false;
          for (int i = 0; i < sc.n; ++i) first[i] = true;
          rows_to_go = restart_interval / nx;
        }
        --rows_to_go;
      }
      const bool empty = br.insufficient;
      if (empty)
        for (int i = 0; i < sc.n; ++i) first[i] = true;
      for (int mx = 0; mx < nx; ++mx) {
        for (int i = 0; i < sc.n; ++i) {
          const Component& k = comp[sc.ci[i]];
          const int hh = inter ? k.h : 1, vv = inter ? k.v : 1;
          for (int yo = 0; yo < vv; ++yo) {
            int32_t* row = diff[i].data() +
                           static_cast<size_t>(inter ? yo : my % k.v) *
                               dstride[i] + mx * hh;
            for (int xo = 0; xo < hh; ++xo) {
              if (empty) {
                row[xo] = 0;
                continue;
              }
              const int t = br.decode(*dct[i]);
              row[xo] = t == 16 ? 32768 : (t ? extend(br.bits(t), t) : 0);
            }
          }
        }
      }
      // undifference each component's rows once its iMCU row is whole
      for (int i = 0; i < sc.n; ++i) {
        Component& k = comp[sc.ci[i]];
        int r0, r1;
        if (inter) {
          r0 = my * k.v;
          r1 = r0 + k.v;
        } else if ((my + 1) % k.v == 0 || my == ny - 1) {
          r0 = my - my % k.v;
          r1 = my + 1;
        } else {
          continue;
        }
        for (int r = r0; r < r1 && r < k.dh; ++r) {
          undifference(k, r, diff[i].data() +
                                 static_cast<size_t>(r - r0) * dstride[i],
                       sc.ss, sc.al, first[i], init);
          first[i] = false;
        }
      }
    }
    br.discard();
  }

  // jdlossls.c: row r of component k from its differences `d`
  static void undifference(Component& k, int r, const int32_t* d, int psv,
                           int al, bool first, int init) {
    const int w = k.dw;
    uint16_t* out = k.undiff.data() + static_cast<size_t>(r) * w;
    if (first) {  // jpeg_undifference_first_row
      int ra = (d[0] + init) & 0xFFFF;
      out[0] = static_cast<uint16_t>(ra);
      for (int x = 1; x < w; ++x) {
        ra = (d[x] + ra) & 0xFFFF;
        out[x] = static_cast<uint16_t>(ra);
      }
    } else {
      const uint16_t* prev = out - w;
      int rb = prev[0];
      int ra = (d[0] + rb) & 0xFFFF;
      out[0] = static_cast<uint16_t>(ra);
      for (int x = 1; x < w; ++x) {
        const int rc = rb;
        rb = prev[x];
        int pred;
        switch (psv) {
          case 1: pred = ra; break;
          case 2: pred = rb; break;
          case 3: pred = rc; break;
          case 4: pred = ra + rb - rc; break;
          case 5: pred = ra + ((rb - rc) >> 1); break;
          case 6: pred = rb + ((ra - rc) >> 1); break;
          default: pred = (ra + rb) >> 1; break;
        }
        ra = (d[x] + pred) & 0xFFFF;
        out[x] = static_cast<uint16_t>(ra);
      }
    }
    uint8_t* px = k.px.data() + static_cast<size_t>(r) * w;
    for (int x = 0; x < w; ++x)
      px[x] = static_cast<uint8_t>(out[x] << al);
  }

  void decode_block(BitReader& br, const Scan& sc, int i, int16_t* blk,
                    const Huffman* dct, const Huffman* act, int* last_dc,
                    int& eobrun) {
    if (!progressive) {  // jdhuff.c decode_mcu_slow
      int s = br.decode(*dct);
      if (s) s = extend(br.bits(s), s);
      // libjpeg sums in unsigned arithmetic and keeps a 16-bit JCOEF
      last_dc[i] = static_cast<int>(static_cast<unsigned>(s) +
                                    static_cast<unsigned>(last_dc[i]));
      blk[0] = static_cast<int16_t>(last_dc[i]);
      for (int k = 1; k < 64; ++k) {
        if (br.n < 16) br.fill();
        const Huffman::FastAc f = act->fast_ac[br.peek()];
        if (f.len) {
          br.consume(f.len);
          k += f.run;
          blk[kNaturalPad[k]] = f.value;
          continue;
        }
        int rs = br.decode(*act);
        int r = rs >> 4;
        s = rs & 15;
        if (s) {
          k += r;
          blk[kNaturalPad[k]] = static_cast<int16_t>(extend(br.bits(s), s));
        } else {
          if (r != 15) break;
          k += 15;
        }
      }
      return;
    }
    if (sc.ss == 0) {
      if (sc.ah == 0) {  // jdphuff.c decode_mcu_DC_first
        int s = br.decode(*dct);
        if (s) s = extend(br.bits(s), s);
        int64_t sum = static_cast<int64_t>(s) + last_dc[i];
        if (sum > INT32_MAX || sum < INT32_MIN) fail(kCorrupt);
        last_dc[i] = static_cast<int>(sum);
        blk[0] = static_cast<int16_t>(
            static_cast<uint32_t>(last_dc[i]) << sc.al);
      } else {  // decode_mcu_DC_refine
        if (br.bit()) blk[0] = static_cast<int16_t>(blk[0] | (1 << sc.al));
      }
      return;
    }
    if (sc.ah == 0) {  // decode_mcu_AC_first
      if (eobrun > 0) {
        --eobrun;
        return;
      }
      for (int k = sc.ss; k <= sc.se; ++k) {
        if (br.n < 16) br.fill();
        const Huffman::FastAc f = act->fast_ac[br.peek()];
        if (f.len) {
          br.consume(f.len);
          k += f.run;
          blk[kNaturalPad[k]] = static_cast<int16_t>(
              static_cast<uint32_t>(f.value) << sc.al);
          continue;
        }
        int rs = br.decode(*act);
        int r = rs >> 4, s = rs & 15;
        if (s) {
          k += r;
          int v = extend(br.bits(s), s);
          blk[kNaturalPad[k]] =
              static_cast<int16_t>(static_cast<uint32_t>(v) << sc.al);
        } else if (r == 15) {
          k += 15;
        } else {
          eobrun = 1 << r;
          if (r) eobrun += br.bits(r);
          --eobrun;
          break;
        }
      }
      return;
    }
    // decode_mcu_AC_refine
    const int p1 = 1 << sc.al;
    const int m1 = -(1 << sc.al);
    int k = sc.ss;
    auto correct = [&](int16_t* c) {
      if (br.bit() && (*c & p1) == 0)
        *c = static_cast<int16_t>(*c >= 0 ? *c + p1 : *c + m1);
    };
    if (eobrun == 0) {
      for (; k <= sc.se; ++k) {
        int rs = br.decode(*act);
        int r = rs >> 4, s = rs & 15;
        if (s) {
          s = br.bit() ? p1 : m1;  // a size other than 1 read as 1
        } else if (r != 15) {
          eobrun = 1 << r;
          if (r) eobrun += br.bits(r);
          break;
        }
        do {
          int16_t* c = blk + kNatural[k];
          if (*c != 0) {
            correct(c);
          } else {
            if (--r < 0) break;
          }
          ++k;
        } while (k <= sc.se);
        if (s) blk[kNaturalPad[k]] = static_cast<int16_t>(s);
      }
    }
    if (eobrun > 0) {
      for (; k <= sc.se; ++k) {
        int16_t* c = blk + kNatural[k];
        if (*c != 0) correct(c);
      }
      --eobrun;
    }
  }

  // The scans as jpeg_start_decompress and jpeg_read_scanlines take them:
  // a file whose first scan holds every component of a sequential frame
  // is decoded from that scan alone (what follows it, read only by
  // jpeg_finish_decompress, whose errors cv::imread ignores, changes no
  // pixel); any other is read scan by scan up to EOI, the fake one at the
  // end of the file included.
  void decode_all() {
    setup_components();
    bool multi = true;
    for (bool first = true;; first = false) {
      const Scan sc = read_sos();
      if (first) multi = progressive || sc.n < ncomp;
      decode_scan(sc);
      if (!multi) return;
      int code;
      while ((code = take_marker()) != 0xDA) {
        if (code == 0xD9) return;
        handle_marker(code);
      }
    }
  }

  // jdcoefct.c smoothing_ok: does libjpeg smooth the blocks of a
  // progressive image (some of the first nine AC coefficients of some
  // component not yet known to full precision)?
  bool smoothing() const {
    if (!progressive) return false;
    bool useful = false;
    for (int i = 0; i < ncomp; ++i) {
      const Component& k = comp[i];
      if (!k.latched) return false;
      static constexpr int kPos[10] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};
      for (int j : kPos)
        if (k.qraw[j] == 0) return false;
      if (k.coef_bits[0] < 0) return false;
      for (int j = 1; j <= 9; ++j)
        if (k.coef_bits[j] != 0) useful = true;
    }
    return useful;
  }
};

// ---- pixels ----

constexpr int kConstBits = 13;
constexpr int kPass1Bits = 2;

inline uint8_t clamp8(int v) {
  return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
}

// One 1-D islow IDCT of the 8 values x[0], x[s], ..., x[7s] (jidctint.c,
// both passes share it), the eight outputs before their descale in
// o[0..7]. T is int32_t where the inputs are within +-8191 (no sum then
// leaves 31 bits), else int64_t.
template <typename T>
inline void idct_1d(const T* x, int s, T* o) {
  T z2 = x[2 * s], z3 = x[6 * s];
  T z1 = (z2 + z3) * T{4433};                     // FIX_0_541196100
  T tmp2 = z1 + z3 * T{-15137};                   // -FIX_1_847759065
  T tmp3 = z1 + z2 * T{6270};                     // FIX_0_765366865
  T tmp0 = (x[0] + x[4 * s]) * T{1 << kConstBits};
  T tmp1 = (x[0] - x[4 * s]) * T{1 << kConstBits};
  T tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
  T tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
  tmp0 = x[7 * s];
  tmp1 = x[5 * s];
  tmp2 = x[3 * s];
  tmp3 = x[s];
  z1 = tmp0 + tmp3;
  z2 = tmp1 + tmp2;
  z3 = tmp0 + tmp2;
  T z4 = tmp1 + tmp3;
  T z5 = (z3 + z4) * T{9633};                     // FIX_1_175875602
  tmp0 *= T{2446};                                // FIX_0_298631336
  tmp1 *= T{16819};                               // FIX_2_053119869
  tmp2 *= T{25172};                               // FIX_3_072711026
  tmp3 *= T{12299};                               // FIX_1_501321110
  z1 *= T{-7373};                                 // -FIX_0_899976223
  z2 *= T{-20995};                                // -FIX_2_562915447
  z3 = z3 * T{-16069} + z5;                       // -FIX_1_961570560
  z4 = z4 * T{-3196} + z5;                        // -FIX_0_390180644
  tmp0 += z1 + z3;
  tmp1 += z2 + z4;
  tmp2 += z2 + z3;
  tmp3 += z1 + z4;
  o[0] = tmp10 + tmp3;
  o[7] = tmp10 - tmp3;
  o[1] = tmp11 + tmp2;
  o[6] = tmp11 - tmp2;
  o[2] = tmp12 + tmp1;
  o[5] = tmp12 - tmp1;
  o[3] = tmp13 + tmp0;
  o[4] = tmp13 - tmp0;
}

// Pass 1 (columns) of dequantised `d` into `ws`, scaled by 2^PASS1_BITS;
// a column whose AC terms are all zero is its DC shifted, as in
// jidctint.c (the full formula gives the same).
template <typename T>
void idct_pass1(const int32_t* d, int32_t* ws) {
  for (int c = 0; c < 8; ++c) {
    const int32_t* x = d + c;
    if (!(x[8] | x[16] | x[24] | x[32] | x[40] | x[48] | x[56])) {
      for (int r = 0; r < 8; ++r) ws[8 * r + c] = x[0] * (1 << kPass1Bits);
      continue;
    }
    T xv[8], o[8];
    for (int r = 0; r < 8; ++r) xv[r] = x[8 * r];
    idct_1d<T>(xv, 1, o);
    const int sh = kConstBits - kPass1Bits;
    for (int r = 0; r < 8; ++r)
      ws[8 * r + c] = static_cast<int32_t>((o[r] + (T{1} << (sh - 1))) >> sh);
  }
}

// Pass 2 (rows) of `ws` into 8-bit samples, +128 and clamped.
template <typename T>
void idct_pass2(const int32_t* ws, uint8_t* out, int stride) {
  const int sh = kConstBits + kPass1Bits + 3;
  for (int r = 0; r < 8; ++r) {
    const int32_t* w = ws + 8 * r;
    uint8_t* op = out + static_cast<ptrdiff_t>(r) * stride;
    if (!(w[1] | w[2] | w[3] | w[4] | w[5] | w[6] | w[7])) {
      const int sh0 = kPass1Bits + 3;
      uint8_t v = clamp8(((w[0] + (1 << (sh0 - 1))) >> sh0) + 128);
      for (int c = 0; c < 8; ++c) op[c] = v;
      continue;
    }
    T xv[8], o[8];
    for (int c = 0; c < 8; ++c) xv[c] = w[c];
    idct_1d<T>(xv, 1, o);
    for (int c = 0; c < 8; ++c)
      op[c] = clamp8(
          static_cast<int>((o[c] + (T{1} << (sh - 1))) >> sh) + 128);
  }
}

// libjpeg-turbo's AVX2 islow IDCT (jidctint-avx2.asm, which cv2's build
// runs) where its 16-bit lanes wrap or saturate: dequantisation keeps the
// low 16 bits of each product; a block whose rows 1-7 are all zero takes
// each column's DC << 2 in 16 bits; in both passes in0 +- in4, in7 + in3
// and in5 + in1 are 16-bit sums, the products are exact 32-bit pairs
// (pmaddwd), their sums wrap at 32 bits, each pass ends in a saturating
// pack to 16 bits, and the output in one to 8 bits (then + 128).
inline int16_t wrap16(int64_t v) {
  return static_cast<int16_t>(static_cast<uint16_t>(v & 0xFFFF));
}
inline int16_t sat16(int64_t v) {
  return static_cast<int16_t>(v < -32768 ? -32768 : (v > 32767 ? 32767 : v));
}
inline int32_t wrap32(int64_t v) {
  return static_cast<int32_t>(static_cast<uint32_t>(v & 0xFFFFFFFF));
}

void idct_1d_simd(const int16_t* x, int64_t* o) {
  const int64_t in0 = x[0], in1 = x[1], in2 = x[2], in3 = x[3];
  const int64_t in4 = x[4], in5 = x[5], in6 = x[6], in7 = x[7];
  const int64_t tmp3 = in2 * (4433 + 6270) + in6 * 4433;
  const int64_t tmp2 = in2 * 4433 + in6 * (4433 - 15137);
  const int64_t tmp0 = int64_t{wrap16(in0 + in4)} * (1 << kConstBits);
  const int64_t tmp1 = int64_t{wrap16(in0 - in4)} * (1 << kConstBits);
  const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
  const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
  const int64_t z3 = wrap16(in7 + in3), z4 = wrap16(in5 + in1);
  const int64_t z3m = z3 * (9633 - 16069) + z4 * 9633;
  const int64_t z4m = z3 * 9633 + z4 * (9633 - 3196);
  const int64_t t0 = in7 * (2446 - 7373) + in1 * -7373 + z3m;
  const int64_t t3 = in7 * -7373 + in1 * (12299 - 7373) + z4m;
  const int64_t t1 = in5 * (16819 - 20995) + in3 * -20995 + z4m;
  const int64_t t2 = in5 * -20995 + in3 * (25172 - 20995) + z3m;
  o[0] = tmp10 + t3;
  o[7] = tmp10 - t3;
  o[1] = tmp11 + t2;
  o[6] = tmp11 - t2;
  o[2] = tmp12 + t1;
  o[5] = tmp12 - t1;
  o[3] = tmp13 + t0;
  o[4] = tmp13 - t0;
}

void idct_islow_simd(const int16_t* in, const int16_t* q, uint8_t* out,
                     int stride) {
  int16_t ws[64], x[8];
  int64_t o[8];
  bool ac = false;
  for (int i = 8; i < 64; ++i) ac = ac || in[i];
  for (int c = 0; c < 8; ++c) {
    if (!ac) {
      const int16_t v = wrap16(int64_t{wrap16(int32_t{in[c]} * q[c])} * 4);
      for (int r = 0; r < 8; ++r) ws[8 * r + c] = v;
      continue;
    }
    for (int r = 0; r < 8; ++r)
      x[r] = wrap16(int32_t{in[8 * r + c]} * q[8 * r + c]);
    idct_1d_simd(x, o);
    const int sh = kConstBits - kPass1Bits;
    for (int r = 0; r < 8; ++r)
      ws[8 * r + c] = sat16(wrap32(o[r] + (1 << (sh - 1))) >> sh);
  }
  const int sh = kConstBits + kPass1Bits + 3;
  for (int r = 0; r < 8; ++r) {
    idct_1d_simd(ws + 8 * r, o);
    uint8_t* op = out + static_cast<ptrdiff_t>(r) * stride;
    for (int c = 0; c < 8; ++c) {
      const int v = sat16(wrap32(o[c] + (1 << (sh - 1))) >> sh);
      op[c] = static_cast<uint8_t>(
          (v < -128 ? -128 : (v > 127 ? 127 : v)) + 128);
    }
  }
}

// jidctint.c jpeg_idct_islow on one block into `out` (row stride
// `stride`). The output is clamped to 0..255 as the SIMD build's saturating
// packs do (the C build's range-limit table agrees inside +-384). Where a
// dequantised value or a first-pass output leaves +-16383 the SIMD build's
// 16-bit lanes part from the C code, and the block is computed as they
// compute it.
void idct_islow(const int16_t* in, const int16_t* q, uint8_t* out,
                int stride) {
  int32_t d[64], ws[64];
  int32_t lo = 0, hi = 0;
  for (int i = 0; i < 64; ++i) {
    d[i] = static_cast<int32_t>(in[i]) * q[i];
    lo = d[i] < lo ? d[i] : lo;
    hi = d[i] > hi ? d[i] : hi;
  }
  if (lo < -16383 || hi > 16383) return idct_islow_simd(in, q, out, stride);
  if (lo >= -8191 && hi <= 8191)
    idct_pass1<int32_t>(d, ws);
  else
    idct_pass1<int64_t>(d, ws);
  lo = hi = 0;
  for (int i = 0; i < 64; ++i) {
    lo = ws[i] < lo ? ws[i] : lo;
    hi = ws[i] > hi ? ws[i] : hi;
  }
  if (lo < -16383 || hi > 16383) return idct_islow_simd(in, q, out, stride);
  if (lo >= -8191 && hi <= 8191)
    idct_pass2<int32_t>(ws, out, stride);
  else
    idct_pass2<int64_t>(ws, out, stride);
}

// A component's samples: (hb * 8, wb * 8), stride wb * 8.
struct Plane {
  std::vector<uint8_t> px;
  int w = 0, h = 0, stride = 0;
  const uint8_t* row(int y) const {
    return px.data() + static_cast<size_t>(y) * stride;
  }
};

// Block smoothing (jdcoefct.c decompress_smooth_data, libjpeg-turbo 2.1
// and later): in a progressive image whose scans leave some of the first
// nine AC coefficients unrefined, each block's coefficients 1-9 (zigzag)
// that are still 0 and not known to full precision are estimated from the
// DC values of the 5x5 blocks around it; where no AC coefficient of the
// first nine has any data, the DC value is re-estimated too and four more
// AC coefficients with it. The weights, rows -2..2 by columns -2..2:
// [0] where DC is kept, [1] where it is re-estimated, for zigzag
// coefficients 1-9 (natural positions kSmoothPos), then the DC's.
constexpr int kSmoothPos[9] = {1, 8, 16, 9, 2, 3, 10, 17, 24};
constexpr int16_t kSmoothAc[2][9][25] = {
    {{0, 0, 0, 0, 0, 0, 0, 0, 0, 0, -7, 50, 0, -50, 7,
      0, 0, 0, 0, 0, 0, 0, 0, 0, 0},
     {0, 0, -7, 0, 0, 0, 0, 50, 0, 0, 0, 0, 0, 0, 0,
      0, 0, -50, 0, 0, 0, 0, 7, 0, 0},
     {0, 0, -1, 0, 0, 0, 0, 13, 0, 0, 0, 0, -24, 0, 0,
      0, 0, 13, 0, 0, 0, 0, -1, 0, 0},
     {0, -1, 0, 1, 0, -1, 10, 0, -10, 1, 0, 0, 0, 0, 0,
      1, -10, 0, 10, -1, 0, 1, 0, -1, 0},
     {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, -1, 13, -24, 13, -1,
      0, 0, 0, 0, 0, 0, 0, 0, 0, 0},
     {}, {}, {}, {}},
    {{-1, -1, 0, 1, 1, -3, 13, 0, -13, 3, -3, 38, 0, -38, 3,
      -3, 13, 0, -13, 3, -1, -1, 0, 1, 1},
     {-1, -3, -3, -3, -1, -1, 13, 38, 13, -1, 0, 0, 0, 0, 0,
      1, -13, -38, -13, 1, 1, 3, 3, 3, 1},
     {0, 0, 1, 0, 0, 0, 2, 7, 2, 0, 0, -5, -14, -5, 0,
      0, 2, 7, 2, 0, 0, 0, 1, 0, 0},
     {-1, 0, 0, 0, 1, 0, 9, 0, -9, 0, 0, 0, 0, 0, 0,
      0, -9, 0, 9, 0, 1, 0, 0, 0, -1},
     {0, 0, 0, 0, 0, 0, 2, -5, 2, 0, 1, 7, -14, 7, 1,
      0, 2, -5, 2, 0, 0, 0, 0, 0, 0},
     {0, 0, 0, 0, 0, 0, 1, 0, -1, 0, 0, 2, 0, -2, 0,
      0, 1, 0, -1, 0, 0, 0, 0, 0, 0},
     {0, 0, 0, 0, 0, 0, 1, -3, 1, 0, 0, 0, 0, 0, 0,
      0, -1, 3, -1, 0, 0, 0, 0, 0, 0},
     {0, 0, 0, 0, 0, 0, 1, 0, -1, 0, 0, -3, 0, 3, 0,
      0, 1, 0, -1, 0, 0, 0, 0, 0, 0},
     {0, 0, 0, 0, 0, 0, 1, 2, 1, 0, 0, 0, 0, 0, 0,
      0, -1, -2, -1, 0, 0, 0, 0, 0, 0}}};
constexpr int16_t kSmoothDc[25] = {
    -2, -6, -8, -6, -2, -6, 6, 42, 6, -6, -8, 42, 152, 42, -8,
    -6, 6, 42, 6, -6, -2, -6, -8, -6, -2};

// the estimate Q00 * sum / Q, rounded, its magnitude held below 2^al where
// al > 0 (the bits a refinement scan would still add)
inline int16_t smooth_estimate(int64_t num, int64_t q, int al) {
  int pred = static_cast<int>(((q << 7) + (num < 0 ? -num : num)) / (q << 8));
  if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
  return static_cast<int16_t>(num < 0 ? -pred : pred);
}

// What smoothing needs of the image: its iMCU rows, the last one decoded
// with data left (rows after it use the coefficient states from before
// the last scan), and a component's coef_bits 0-9 now and before its
// last scan (-1 for a one-scan file).
struct Smooth {
  int imcu_rows, last_good;
  const int* bits;
  int prev[10];
};

// A component's samples after the IDCT, smoothed where `sm` is given.
Plane inverse_dct(Component& k, const Smooth* sm) {
  Plane pl;
  pl.stride = k.wb * 8;
  pl.w = k.dw;
  pl.h = k.dh;
  pl.px.resize(static_cast<size_t>(k.hb) * 8 * pl.stride);
  int16_t ws[64];
  for (int by = 0; by < k.hb; ++by) {
    uint8_t* out = pl.px.data() + static_cast<size_t>(by) * 8 * pl.stride;
    if (!sm) {
      for (int bx = 0; bx < k.wb; ++bx)
        idct_islow(k.block(by, bx), k.q, out + bx * 8, pl.stride);
      continue;
    }
    // the rows around, an edge row repeated, where "edge" is judged by
    // libjpeg-turbo's image_block_row(s): the iMCU row times the block
    // rows of this iMCU row, which in the last one can be fewer than v (and
    // so a row past the image's last can be read, or a real one repeated)
    const int last = sm->imcu_rows - 1, r = by / k.v, b = by % k.v;
    const int brows = r < last ? k.v : (k.hb % k.v ? k.hb % k.v : k.v);
    const int at = r * brows + b, rows = brows * sm->imcu_rows;
    int row[5];
    row[2] = by;
    row[1] = at > 0 ? by - 1 : by;
    row[0] = at > 1 ? by - 2 : row[1];
    row[3] = at < rows - 1 ? by + 1 : by;
    row[4] = at < rows - 2 ? by + 2 : row[3];
    const int* bits = r > sm->last_good ? sm->prev : sm->bits;
    bool change_dc = true;
    for (int j = 1; j <= 9; ++j) change_dc = change_dc && bits[j] == -1;
    const int64_t q00 = k.qraw[0];
    for (int bx = 0; bx < k.wb; ++bx) {
      int dc[25];
      for (int i = 0; i < 5; ++i)
        for (int j = 0; j < 5; ++j) {
          int x = bx + j - 2;
          x = x < 0 ? 0 : (x > k.wb - 1 ? k.wb - 1 : x);
          dc[5 * i + j] = k.block(row[i], x)[0];
        }
      std::memcpy(ws, k.block(by, bx), sizeof(ws));
      for (int j = 1; j <= (change_dc ? 9 : 5); ++j) {
        const int pos = kSmoothPos[j - 1];
        if (bits[j] == 0 || ws[pos] != 0) continue;
        const int16_t* w = kSmoothAc[change_dc][j - 1];
        int64_t sum = 0;
        for (int t = 0; t < 25; ++t) sum += w[t] * dc[t];
        ws[pos] = smooth_estimate(q00 * sum, k.qraw[pos], bits[j]);
      }
      if (change_dc) {
        int64_t sum = 0;
        for (int t = 0; t < 25; ++t) sum += kSmoothDc[t] * dc[t];
        ws[0] = smooth_estimate(q00 * sum, q00, 0);
      }
      idct_islow(ws, k.q, out + bx * 8, pl.stride);
    }
  }
  return pl;
}

// jdsample.c, one output row at a time: with fancy upsampling on, h2v1
// and h2v2 triangle filters where the component is more than 2 samples
// wide, h1v2 (libjpeg-turbo >= 2.1) always; every other ratio, and h2 at
// 1-2 samples wide, replicates. Edge samples and rows repeat (jdmainct.c's
// context rows).
class Upsampler {
 public:
  Upsampler(const Plane& in, int hx, int vx, int width)
      : in_(in), hx_(hx), vx_(vx), width_(width),
        colsum_(static_cast<size_t>(in.w)),
        line_(static_cast<size_t>(2 * in.w + 2 > width ? 2 * in.w + 2
                                                       : width)) {}

  // output row y (`width` samples), in the plane itself where the
  // component is full size
  const uint8_t* row(int y) {
    const int dw = in_.w;
    uint8_t* l = line_.data();
    if (hx_ == 1 && vx_ == 1) return in_.row(y);  // fullsize_upsample
    if (hx_ == 2 && vx_ == 1 && dw > 2) {         // h2v1_fancy_upsample
      const uint8_t* r = in_.row(y);
      l[0] = r[0];
      l[1] = static_cast<uint8_t>((3 * r[0] + r[1] + 2) >> 2);
      for (int i = 1; i < dw - 1; ++i) {
        int v = 3 * r[i];
        l[2 * i] = static_cast<uint8_t>((v + r[i - 1] + 1) >> 2);
        l[2 * i + 1] = static_cast<uint8_t>((v + r[i + 1] + 2) >> 2);
      }
      l[2 * dw - 2] = static_cast<uint8_t>((3 * r[dw - 1] + r[dw - 2] + 1) >> 2);
      l[2 * dw - 1] = r[dw - 1];
    } else if (hx_ == 2 && vx_ == 2 && dw > 2) {  // h2v2_fancy_upsample
      const int iy = y >> 1;
      const uint8_t* r0 = in_.row(iy);
      const uint8_t* r1 = in_.row(clampy((y & 1) ? iy + 1 : iy - 1));
      int* cs = colsum_.data();
      for (int i = 0; i < dw; ++i) cs[i] = 3 * r0[i] + r1[i];
      l[0] = static_cast<uint8_t>((4 * cs[0] + 8) >> 4);
      l[1] = static_cast<uint8_t>((3 * cs[0] + cs[1] + 7) >> 4);
      for (int i = 1; i < dw - 1; ++i) {
        int v = 3 * cs[i];
        l[2 * i] = static_cast<uint8_t>((v + cs[i - 1] + 8) >> 4);
        l[2 * i + 1] = static_cast<uint8_t>((v + cs[i + 1] + 7) >> 4);
      }
      l[2 * dw - 2] = static_cast<uint8_t>((3 * cs[dw - 1] + cs[dw - 2] + 8) >> 4);
      l[2 * dw - 1] = static_cast<uint8_t>((4 * cs[dw - 1] + 7) >> 4);
    } else if (hx_ == 1 && vx_ == 2) {  // h1v2_fancy_upsample
      const int iy = y >> 1;
      const uint8_t* r0 = in_.row(iy);
      const bool lower = y & 1;
      const uint8_t* r1 = in_.row(clampy(lower ? iy + 1 : iy - 1));
      const int bias = lower ? 2 : 1;
      for (int x = 0; x < width_; ++x)
        l[x] = static_cast<uint8_t>((3 * r0[x] + r1[x] + bias) >> 2);
    } else {  // int_upsample, h2v1_upsample, h2v2_upsample
      const uint8_t* r = in_.row(y / vx_);
      for (int x = 0; x < width_; ++x) l[x] = r[x / hx_];
    }
    return l;
  }

 private:
  int clampy(int y) const { return y < 0 ? 0 : (y >= in_.h ? in_.h - 1 : y); }

  const Plane& in_;
  int hx_, vx_, width_;
  std::vector<int> colsum_;
  std::vector<uint8_t> line_;
};

struct ColorTables {  // jdcolor.c build_ycc_rgb_table, build_rgb_y_table
  int cr_r[256], cb_b[256];
  int32_t cr_g[256], cb_g[256];
  int32_t r_y[256], g_y[256], b_y[256];
  ColorTables() {
    for (int i = 0; i < 256; ++i) {
      int x = i - 128;
      cr_r[i] = static_cast<int>((91881 * x + 32768) >> 16);    // FIX(1.40200)
      cb_b[i] = static_cast<int>((116130 * x + 32768) >> 16);   // FIX(1.77200)
      cr_g[i] = -46802 * x;                                     // -FIX(0.71414)
      cb_g[i] = -22554 * x + 32768;                             // -FIX(0.34414)
      r_y[i] = 19595 * i;                                       // FIX(0.29900)
      g_y[i] = 38470 * i;                                       // FIX(0.58700)
      b_y[i] = 7471 * i + 32768;                                // FIX(0.11400)
    }
  }
};

const ColorTables& color_tables() {
  static const ColorTables t;
  return t;
}

// The first `n` components' samples after the IDCT (a lossless frame's
// samples as decoded), and an upsampler of each to the image's size.
// `planes` is reserved first: each upsampler holds a reference to its plane.
void upsampled(Decoder& d, int n, std::vector<Plane>* planes,
               std::vector<Upsampler>* ups) {
  const bool smooth = d.smoothing();
  planes->reserve(n);
  ups->reserve(n);
  for (int c = 0; c < n; ++c) {
    Component& k = d.comp[c];
    if (d.max_h % k.h || d.max_v % k.v) fail(kSampling);
    if (d.lossless) {
      if (!k.seen) fail(kLosslessUnscanned);
      Plane pl;
      pl.px.swap(k.px);
      pl.w = pl.stride = k.dw;
      pl.h = k.dh;
      planes->push_back(std::move(pl));
    } else if (smooth) {
      Smooth sm{d.mcus_y, d.last_good, k.coef_bits, {}};
      for (int j = 0; j < 10; ++j)
        sm.prev[j] = d.scans > 1 ? k.prev_bits[j] : -1;
      planes->push_back(inverse_dct(k, &sm));
    } else {
      // a component in no scan has no quantisation table: its
      // coefficients count as 0 (jddctmgr.c), its samples 128
      planes->push_back(inverse_dct(k, nullptr));
    }
    ups->emplace_back(planes->back(), d.max_h / k.h, d.max_v / k.v,
                      d.width);
  }
}

void oriented_size(const Decoder& d, int* w, int* h) {
  bool swap = d.orientation >= 5 && d.orientation <= 8;
  *w = swap ? d.height : d.width;
  *h = swap ? d.width : d.height;
}

enum Space { kGray, kYcc, kRgb, kCmyk, kYcck };

// jdapimin.c default_decompress_parms: the colour space of the components
// (an Adobe transform it does not know is a warning: YCbCr is assumed for
// three components, YCCK for four)
Space color_space(Decoder& d) {
  if (d.ncomp == 1) return kGray;
  if (d.ncomp == 4) {
    if (!d.adobe) return kCmyk;
    if (d.adobe_transform == 0) return kCmyk;
    return kYcck;
  }
  if (d.jfif) return kYcc;
  if (d.adobe) {
    if (d.adobe_transform == 0) return kRgb;
    return kYcc;
  }
  if (d.comp[0].id == 'R' && d.comp[1].id == 'G' && d.comp[2].id == 'B')
    return kRgb;
  return d.lossless ? kRgb : kYcc;  // lossless: "assume RGB w/out marker"
}

// cv::imread's JPEG signature, FF D8 FF (libjpeg itself needs FF D8 only)
void check_signature(const uint8_t* buf, int64_t len) {
  if (len < 3 || buf[0] != 0xFF || buf[1] != 0xD8 || buf[2] != 0xFF)
    fail(kNotJpeg);
}

void decode(const uint8_t* buf, int64_t len, int channels, uint8_t* out) {
  if (channels != 1 && channels != 3) fail(kChannels);
  check_signature(buf, len);
  Decoder d(buf, len);
  d.read_header();
  const Space cs = color_space(d);
  // cv::imread asks libjpeg for gray, BGR, or CMYK from 4 components;
  // jdcolor.c allows no conversion that changes sample values in a
  // lossless frame (JERR_CONVERSION_NOTIMPL)
  if (d.lossless && (cs == kYcc || cs == kYcck ||
                     (cs == kGray && channels == 3) ||
                     (cs == kRgb && channels == 1)))
    fail(kLosslessColor);
  if (d.lossless)
    for (int c = 0; c < d.ncomp; ++c)
      if (d.comp[c].h != 1 || d.comp[c].v != 1) fail(kLosslessSampling);
  d.decode_all();

  // components the output needs (jdcolor.c: YCbCr to gray reads Y only)
  const int need = cs == kGray || (cs == kYcc && channels == 1) ? 1
                   : d.ncomp;
  const int W = d.width, H = d.height;
  std::vector<Plane> planes;
  std::vector<Upsampler> ups;
  upsampled(d, need, &planes, &ups);
  // rows are written in place where the orientation is the identity, else
  // into `tmp` and then turned
  const size_t npx = static_cast<size_t>(W) * H;
  const int o = d.orientation >= 1 && d.orientation <= 8 ? d.orientation : 1;
  std::vector<uint8_t> tmp(o == 1 ? 0 : npx * channels);
  uint8_t* dst = o == 1 ? out : tmp.data();
  const ColorTables& t = color_tables();
  for (int y = 0; y < H; ++y) {
    const size_t at = static_cast<size_t>(y) * W;
    const uint8_t* c0 = ups[0].row(y);
    if (need == 1) {  // grayscale_convert, gray_rgb_convert
      for (int ch = 0; ch < channels; ++ch)
        std::memcpy(dst + ch * npx + at, c0, static_cast<size_t>(W));
      continue;
    }
    const uint8_t* c1 = ups[1].row(y);
    const uint8_t* c2 = ups[2].row(y);
    uint8_t* b = dst + at;
    uint8_t* g = dst + npx + at;
    uint8_t* r = dst + 2 * npx + at;
    if (need == 4) {
      // ycck_cmyk_convert or null_convert, then OpenCV's
      // icvCvt_CMYK2BGR_8u_C4C3R / icvCvt_CMYK2Gray_8u_C4C1R
      const uint8_t* c3 = ups[3].row(y);
      for (int x = 0; x < W; ++x) {
        int cc = c0[x], mm = c1[x], yy = c2[x];
        const int k = c3[x];
        if (cs == kYcck) {
          const int lum = c0[x], cb = c1[x], cr = c2[x];
          cc = clamp8(255 - (lum + t.cr_r[cr]));
          mm = clamp8(255 - (lum + ((t.cb_g[cb] + t.cr_g[cr]) >> 16)));
          yy = clamp8(255 - (lum + t.cb_b[cb]));
        }
        cc = cmyk_channel(cc, k);
        mm = cmyk_channel(mm, k);
        yy = cmyk_channel(yy, k);
        if (channels == 1) {
          b[x] = bgr2gray(yy, mm, cc);
        } else {
          b[x] = static_cast<uint8_t>(yy);
          g[x] = static_cast<uint8_t>(mm);
          r[x] = static_cast<uint8_t>(cc);
        }
      }
    } else if (channels == 1) {  // rgb_gray_convert
      for (int x = 0; x < W; ++x)
        b[x] = static_cast<uint8_t>(
            (t.r_y[c0[x]] + t.g_y[c1[x]] + t.b_y[c2[x]]) >> 16);
    } else if (cs == kRgb) {  // rgb_rgb_convert, to BGR
      std::memcpy(b, c2, static_cast<size_t>(W));
      std::memcpy(g, c1, static_cast<size_t>(W));
      std::memcpy(r, c0, static_cast<size_t>(W));
    } else {  // ycc_rgb_convert, to BGR
      for (int x = 0; x < W; ++x) {
        int yy = c0[x], cb = c1[x], cr = c2[x];
        r[x] = clamp8(yy + t.cr_r[cr]);
        g[x] = clamp8(yy + ((t.cb_g[cb] + t.cr_g[cr]) >> 16));
        b[x] = clamp8(yy + t.cb_b[cb]);
      }
    }
  }
  if (o != 1) {
    for (int ch = 0; ch < channels; ++ch)
      orient_copy(tmp.data() + ch * npx, W, W, H, o, out + ch * npx);
  }
}

// One strip or tile of a JPEG-compressed TIFF, as libtiff's JPEG codec
// (tif_jpeg.c) has libjpeg decode it for TIFFReadRGBA*: the tables of the
// JPEGTables stream first (`tables`, may be empty), then the strip's own
// stream, read as cv::imread reads a JPEG file (tif_jpeg.c's source
// manager also ends the data with fake EOI markers, and its warning
// handler only warns; block smoothing stays on), so that what libjpeg
// decodes with a warning reads as in `decode`. Its component count and
// sampling factors as the TIFF's (component 0 `h0` x `v0`, the others
// 1 x 1), else JPEGPreDecode fails; a JPEG wider or taller than the
// chunk's `width` x `height` fails too, but for the last strip of the
// image (`taller_ok`) of the chunk's width and more rows, of which the
// chunk's are read; a smaller one fills its own rows and columns of the
// chunk, the rest left 0 ("Improper JPEG strip/tile size", a warning);
// a stream of 100 scans or more fails (libtiff's progress monitor).
// The components upsampled as ever, then, with `ycc`, YCbCr to RGB
// (JPEGCOLORMODE_RGB), else left as they are (jpeg_color_space
// JCS_UNKNOWN: no Adobe transform either, which is how libtiff reads a
// 4-sample RGB + alpha or CMYK strip). Into `out`, (height, width,
// ncomp) interleaved.
void decode_tiff_strip(const uint8_t* tables, int64_t tlen, const uint8_t* buf,
                       int64_t len, int ycc, int width, int height, int ncomp,
                       int h0, int v0, int taller_ok, uint8_t* out) {
  Decoder d(buf, len);
  if (tlen > 0) {
    d.s.reset(tables, tlen);
    d.read_tables();
    d.s.reset(buf, len);
    d.restart_interval = 0;  // get_soi resets it; the tables persist
  }
  d.read_header();
  if (d.lossless) fail(kTiffLossless);
  if ((d.width > width || d.height > height)
      && !(taller_ok && d.width == width))
    fail(kTiffSize);
  if (d.ncomp != ncomp || (ycc && ncomp != 3)) fail(kComponents);
  if (ncomp == 2 || ncomp > 4) fail(kComponents);
  for (int c = 0; c < d.ncomp; ++c)
    if (d.comp[c].h != (c ? 1 : h0) || d.comp[c].v != (c ? 1 : v0))
      fail(kSampling);
  d.decode_all();
  // TIFFjpeg_progress_monitor: libtiff fails a stream from its 100th scan
  if (d.scans >= 100) fail(kTiffScans);
  const int W = d.width, H = std::min(d.height, height);
  std::vector<Plane> planes;
  std::vector<Upsampler> ups;
  upsampled(d, ncomp, &planes, &ups);
  const ColorTables& t = color_tables();
  std::memset(out, 0, static_cast<size_t>(width) * height * ncomp);
  for (int y = 0; y < H; ++y) {
    uint8_t* o = out + static_cast<size_t>(y) * width * ncomp;
    if (ncomp != 3) {  // null_convert of 1 or 4 components
      for (int c = 0; c < ncomp; ++c) {
        const uint8_t* s = ups[c].row(y);
        for (int x = 0; x < W; ++x) o[x * ncomp + c] = s[x];
      }
      continue;
    }
    const uint8_t* c0 = ups[0].row(y);
    const uint8_t* c1 = ups[1].row(y);
    const uint8_t* c2 = ups[2].row(y);
    for (int x = 0; x < W; ++x, o += 3) {
      if (ycc) {  // ycc_rgb_convert
        int yy = c0[x], cb = c1[x], cr = c2[x];
        o[0] = clamp8(yy + t.cr_r[cr]);
        o[1] = clamp8(yy + ((t.cb_g[cb] + t.cr_g[cr]) >> 16));
        o[2] = clamp8(yy + t.cb_b[cb]);
      } else {  // null_convert
        o[0] = c0[x];
        o[1] = c1[x];
        o[2] = c2[x];
      }
    }
  }
}

}  // namespace

extern "C" {

// decode_tiff_strip: 0, or a negative code (of_jpeg_strerror).
int of_jpeg_decode_tiff(const uint8_t* tables, int64_t tlen,
                        const uint8_t* buf, int64_t len, int ycc, int width,
                        int height, int ncomp, int h0, int v0, int taller_ok,
                        uint8_t* out) {
  try {
    decode_tiff_strip(tables, tlen, buf, len, ycc, width, height, ncomp, h0,
                      v0, taller_ok, out);
    return 0;
  } catch (const Error& e) {
    return e.code;
  } catch (const std::bad_alloc&) {
    return kNoMemory;
  }
}

// The oriented size and component count of a JPEG: 0, or a negative code.
int of_jpeg_info(const uint8_t* buf, int64_t len, int* width, int* height,
                 int* ncomp) {
  try {
    check_signature(buf, len);
    Decoder d(buf, len);
    d.read_header();
    oriented_size(d, width, height);
    *ncomp = d.ncomp;
    return 0;
  } catch (const Error& e) {
    return e.code;
  } catch (const std::bad_alloc&) {
    return kNoMemory;
  }
}

// Decode into `out`, a C-contiguous (channels, height, width) uint8 array
// of of_jpeg_info's size: channels 1 gray (the Y plane of a YCbCr image,
// OpenCV's gray of a CMYK one), 3 BGR. Returns 0, or a negative code
// (of_jpeg_strerror).
int of_jpeg_decode(const uint8_t* buf, int64_t len, int channels,
                   uint8_t* out) {
  try {
    decode(buf, len, channels, out);
    return 0;
  } catch (const Error& e) {
    return e.code;
  } catch (const std::bad_alloc&) {
    return kNoMemory;
  }
}

const char* of_jpeg_strerror(int code) {
  switch (code) {
    case kOk: return "no error";
    case kNotJpeg: return "not a JPEG (no SOI marker and marker after it)";
    case kBadMarker: return "corrupt or unsupported JPEG marker segment";
    case kLosslessArith: return "lossless arithmetic-coded JPEG (SOF11): "
                                "cv::imread fails on it too";
    case kLosslessColor: return "lossless JPEG read in a colour space "
                                "libjpeg would have to convert it to (gray "
                                "read as colour, RGB read as gray, YCbCr or "
                                "YCCK): cv::imread fails on it too";
    case kHierarchical: return "hierarchical JPEG (SOF5-7, SOF13-15): "
                               "cv::imread fails on it too";
    case kPrecision: return "JPEG sample precision other than 8 bits "
                            "(12-bit), or lossless precision outside 2-8: "
                            "cv::imread fails on it too";
    case kComponents: return "JPEG with 2 or more than 4 components: "
                             "cv::imread fails on it too";
    case kSampling: return "unsupported JPEG sampling factors";
    case kNoHuffTable: return "JPEG scan uses a Huffman table that is not "
                              "defined";
    case kNoQuantTable: return "JPEG component uses a quantization table "
                               "that is not defined";
    case kBadHuffTable: return "corrupt JPEG Huffman table";
    case kCorrupt: return "corrupt JPEG data";
    case kProgression: return "corrupt JPEG data: invalid scan or "
                              "progression parameters";
    case kSize: return "JPEG image size is empty or too large";
    case kChannels: return "channels must be 1 or 3";
    case kNoMemory: return "out of memory decoding JPEG";
    case kNoImage: return "JPEG has no image (no scan)";
    case kLosslessSampling: return "lossless JPEG with subsampled components "
                                   "is not supported";
    case kLosslessRestart: return "lossless JPEG whose restart interval is "
                                  "not a whole number of MCU rows: "
                                  "cv::imread fails on it too";
    case kTiffLossless: return "lossless JPEG inside a TIFF is not "
                               "supported";
    case kTiffSize: return "JPEG strip or tile larger than the TIFF's "
                           "(libtiff's JPEGPreDecode fails): cv::imread "
                           "fails on it too";
    case kTiffScans: return "JPEG strip or tile of 100 scans or more "
                            "(libtiff's scan limit): cv::imread fails on "
                            "it too";
    case kLosslessUnscanned: return "lossless JPEG with a component in no "
                                    "scan (libjpeg leaves its samples "
                                    "undefined)";
    default: return "unknown JPEG error";
  }
}

}  // extern "C"
