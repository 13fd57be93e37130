// Host-side pixel decoding of TIFF frames for the serving pipeline and
// `load_image`, to the (C, H, W) uint8 layout the port's entry points
// take, with the values cv::imread gives (C = 1 IMREAD_GRAYSCALE, C = 3
// IMREAD_COLOR, B, G, R planes).
//
// Replaces the cv2.imread fallback of of_dis_tpu/utils/io.py::load_image
// for TIFF. Plain C entries, no CUDA, no codec library: Python parses the
// IFD (`utils/io.py::tiff_ifd`), inflates Deflate chunks with zlib (as
// PNG's image data) and has csrc/jpeg.cpp decode JPEG chunks; this file
// undoes LZW, PackBits and CCITT fax (Modified Huffman, Group 3 1-D and
// 2-D, Group 4, as libtiff 4.7's tif_fax3.c decodes them), the fill order
// and predictor 2, unpacks the samples and converts them. A ctypes call
// releases the interpreter lock, so a thread pool over frames runs it
// side by side.
//
// Which rules: cv::imread reads an 8-bit TIFF through libtiff's
// TIFFReadRGBAStrip / TIFFReadRGBATile (OpenCV 5's grfmt_tiff.cpp, libtiff
// 4.7's tif_getimage.c), then takes B, G, R of the RGBA raster or its
// gray by the readers' BGR2GRAY in 1/16384ths (gray.h). So: gray samples
// through libtiff's map (1 bit 0 / 255, 16 bits the high byte, MINISWHITE
// inverted), palette entries shifted down 8 bits unless every entry is
// below 256, 16-bit colour samples (v + 128) / 257, unassociated alpha
// premultiplied (v * a + 127) / 255, CMYK as (255 - K) * (255 - C) / 255;
// planar gray goes through libtiff's planar RGB route (no inversion, 16
// bits by (v + 128) / 257, alpha premultiplied); YCbCr (not JPEG) by
// tif_color.c's fixed-point tables over the file's coefficients and
// reference black and white, each subsampling block's chroma replicated
// over its luma (tif_getimage.c's putcontig8bitYCbCr*tile). The
// orientation tag flips as libtiff's raster and OpenCV's strip placement
// do: 2 mirrors each strip or tile in place, 4 flips the image upside
// down, 3 both. Damaged data: the RGBA reader ignores a codec's error and
// shows the chunk's buffer as the codec left it (zeroed before the call,
// so what was decoded and zeros after it), neither swabbed nor with its
// predictor undone; each codec here stops where libtiff's does (LZW at an
// undefined code, a full table or the data's end; PackBits and
// uncompressed data short; CCITT rows as tif_fax3.c recovers them). Held
// to cv2.imread pixel for pixel by tests/test_torch_tiff.py,
// test_torch_tiff_fax.py, test_torch_tiff_ycbcr.py and
// test_torch_tiff_damaged.py.

#include <cstdint>
#include <algorithm>
#include <cstring>
#include <memory>
#include <new>
#include <vector>

#include "gray.h"

namespace {

enum Param {
  kWidth, kHeight, kBits, kSpp, kCompression, kPhotometric, kPlanar,
  kPredictor, kFillOrder, kAlpha, kBigEndian, kTiled, kChunkW, kChunkH,
  kOrientation, kFaxOptions, kSubH, kSubV
};

enum Code {
  kOk = 0,
  kLayout = -2,       // parameters the decoder does not take
  kNoMemory = -4,
  kOldLzw = -5,       // old-style (TIFF 5.0) LZW, LSB-first
  kFaxMemory = -6,    // CCITT data that make libtiff read before its run
                      // arrays, memory that is not its own
};

struct Error {
  int code;
};

[[noreturn]] void fail(int code) { throw Error{code}; }

// TIFF LZW (tif_lzw.c LZWDecode, new style): codes MSB-first from 9 bits,
// one bit more once the next free entry reaches 2^n - 1 (early change),
// up to 12; Clear (256) first, End (257) or the end of the data last.
// Fills `out` with `need` bytes, the last string cut where it overruns.
// As libtiff: an undefined code, a regular code while the table is full
// (5119 entries, libtiff's CSIZE, and before the first Clear: LZWPreDecode
// starts with the table full) and data that end before `need` bytes (at
// End or at a code the bits do not complete) stop the decoding, the rest
// of `out` left zero. Returns whether all `need` bytes came.
bool lzw_decode(const uint8_t* in, int64_t n, uint8_t* out, int64_t need) {
  constexpr int kClear = 256, kEnd = 257, kFirst = 258;
  constexpr int kSize = 4095 + 1024;   // libtiff's CSIZE
  std::vector<int32_t> prev(kSize), len(kSize);
  std::vector<uint8_t> first(kSize), last(kSize);
  for (int i = 0; i < 256; ++i) {
    prev[i] = -1;
    len[i] = 1;
    first[i] = last[i] = static_cast<uint8_t>(i);
  }
  int64_t pos = 0, bitpos = 0;
  const int64_t nbits_total = n * 8;
  int nbits = 9;
  int free_ent = kSize;  // full until the first Clear
  int old = 0;
  auto next = [&]() -> int {
    if (bitpos + nbits > nbits_total) return kEnd;  // out of data: End
    int64_t v = 0;
    for (int k = 0; k < nbits; ++k, ++bitpos)
      v = (v << 1) | ((in[bitpos >> 3] >> (7 - (bitpos & 7))) & 1);
    return static_cast<int>(v);
  };
  auto emit = [&](int code) {  // the string of `code`, cut at `need`
    const int64_t l = len[code];
    int64_t at = pos + l - 1;
    for (int c = code; c >= 0; c = prev[c], --at)
      if (at < need) out[at] = last[c];
    pos += l;
  };
  while (pos < need) {
    int code = next();
    if (code == kClear) {
      do {
        free_ent = kFirst;
        nbits = 9;
        code = next();
      } while (code == kClear);
      if (code == kEnd || code > kClear) break;
      out[pos++] = static_cast<uint8_t>(code);
      old = code;
      continue;
    }
    if (code == kEnd) break;
    // the new entry: the previous string and the first byte of this one
    // (of the new entry itself where the code is the one being defined)
    const bool known = code < free_ent;
    if (free_ent >= kSize || (!known && code != free_ent)) break;
    prev[free_ent] = old;
    len[free_ent] = len[old] + 1;
    first[free_ent] = first[old];
    last[free_ent] = known ? first[code] : first[old];
    if (++free_ent > (1 << nbits) - 2 && nbits < 12) ++nbits;
    emit(code);
    old = code;
  }
  return pos >= need;
}

// PackBits (tif_packbits.c PackBitsDecode): a run or a literal that
// overruns `need` is cut; a literal the data do not hold, or a run
// without its byte, ends the decoding. Returns whether `need` bytes came
// (the rest of `out` left zero).
bool packbits_decode(const uint8_t* in, int64_t n, uint8_t* out,
                     int64_t need) {
  int64_t i = 0, o = 0;
  while (i < n && o < need) {
    int c = in[i++];
    if (c >= 128) c -= 256;
    if (c < 0) {
      if (c == -128) continue;
      int64_t run = 1 - c;
      if (run > need - o) run = need - o;
      if (i >= n) break;
      std::memset(out + o, in[i++], static_cast<size_t>(run));
      o += run;
    } else {
      int64_t lit = c + 1;
      if (lit > need - o) lit = need - o;
      if (n - i < lit) break;
      std::memcpy(out + o, in + i, static_cast<size_t>(lit));
      o += lit;
      i += lit;
    }
  }
  return o >= need;
}

inline uint8_t reverse_bits(uint8_t v) {
  v = static_cast<uint8_t>((v & 0xF0) >> 4 | (v & 0x0F) << 4);
  v = static_cast<uint8_t>((v & 0xCC) >> 2 | (v & 0x33) << 2);
  return static_cast<uint8_t>((v & 0xAA) >> 1 | (v & 0x55) << 1);
}

// ------------------------------------------------------------ CCITT fax
//
// libtiff 4.7's tif_fax3.c decoders (Fax3DecodeRLE, Fax3Decode1D,
// Fax3Decode2D, Fax4Decode) with its run arrays and its EXPAND1D /
// EXPAND2D state machines, on a row of `width` pixels: white runs leave
// bits 0, black runs set them to 1 (_TIFFFax3fillruns); the photometric
// interpretation maps them afterwards, as for any 1-bit gray strip.
// Corrupt data decode as libtiff decodes them, for it only warns and
// reads on: a bad code word or an EOL inside a row ends the row, which
// CLEANUP_RUNS makes its width (the rest white, or in 2-D after an EOL
// the colour the row was in); a Group 3 row then looks for the next EOL
// bit by bit, a Modified Huffman row starts on the next byte, a Group 4
// strip stops at an EOL; data that end inside a row end the chunk after
// that row, the rows below left 0; a run that would overflow the run
// arrays ends the chunk before its row is filled. The run arrays outlive
// a chunk (libtiff sets them up once per image), so a 2-D row that reads
// its reference line past the line's own runs reads what an earlier row
// or chunk left there, as here.

// ITU-T T.4's code words: {bits, value}, the run lengths 0-63
// (terminating), 64-1728 (make-up), 1792-2560 (extended make-up, both
// colours), the end of line, and the 2-D modes (T.4 Table 4).
struct CodeWord {
  const char* bits;
  int value;
};

constexpr CodeWord kWhiteCodes[] = {
    {"00110101", 0}, {"000111", 1}, {"0111", 2}, {"1000", 3}, {"1011", 4},
    {"1100", 5}, {"1110", 6}, {"1111", 7}, {"10011", 8}, {"10100", 9},
    {"00111", 10}, {"01000", 11}, {"001000", 12}, {"000011", 13},
    {"110100", 14}, {"110101", 15}, {"101010", 16}, {"101011", 17},
    {"0100111", 18}, {"0001100", 19}, {"0001000", 20}, {"0010111", 21},
    {"0000011", 22}, {"0000100", 23}, {"0101000", 24}, {"0101011", 25},
    {"0010011", 26}, {"0100100", 27}, {"0011000", 28}, {"00000010", 29},
    {"00000011", 30}, {"00011010", 31}, {"00011011", 32}, {"00010010", 33},
    {"00010011", 34}, {"00010100", 35}, {"00010101", 36}, {"00010110", 37},
    {"00010111", 38}, {"00101000", 39}, {"00101001", 40}, {"00101010", 41},
    {"00101011", 42}, {"00101100", 43}, {"00101101", 44}, {"00000100", 45},
    {"00000101", 46}, {"00001010", 47}, {"00001011", 48}, {"01010010", 49},
    {"01010011", 50}, {"01010100", 51}, {"01010101", 52}, {"00100100", 53},
    {"00100101", 54}, {"01011000", 55}, {"01011001", 56}, {"01011010", 57},
    {"01011011", 58}, {"01001010", 59}, {"01001011", 60}, {"00110010", 61},
    {"00110011", 62}, {"00110100", 63},
    {"11011", 64}, {"10010", 128}, {"010111", 192}, {"0110111", 256},
    {"00110110", 320}, {"00110111", 384}, {"01100100", 448},
    {"01100101", 512}, {"01101000", 576}, {"01100111", 640},
    {"011001100", 704}, {"011001101", 768}, {"011010010", 832},
    {"011010011", 896}, {"011010100", 960}, {"011010101", 1024},
    {"011010110", 1088}, {"011010111", 1152}, {"011011000", 1216},
    {"011011001", 1280}, {"011011010", 1344}, {"011011011", 1408},
    {"010011000", 1472}, {"010011001", 1536}, {"010011010", 1600},
    {"011000", 1664}, {"010011011", 1728},
};

constexpr CodeWord kBlackCodes[] = {
    {"0000110111", 0}, {"010", 1}, {"11", 2}, {"10", 3}, {"011", 4},
    {"0011", 5}, {"0010", 6}, {"00011", 7}, {"000101", 8}, {"000100", 9},
    {"0000100", 10}, {"0000101", 11}, {"0000111", 12}, {"00000100", 13},
    {"00000111", 14}, {"000011000", 15}, {"0000010111", 16},
    {"0000011000", 17}, {"0000001000", 18}, {"00001100111", 19},
    {"00001101000", 20}, {"00001101100", 21}, {"00000110111", 22},
    {"00000101000", 23}, {"00000010111", 24}, {"00000011000", 25},
    {"000011001010", 26}, {"000011001011", 27}, {"000011001100", 28},
    {"000011001101", 29}, {"000001101000", 30}, {"000001101001", 31},
    {"000001101010", 32}, {"000001101011", 33}, {"000011010010", 34},
    {"000011010011", 35}, {"000011010100", 36}, {"000011010101", 37},
    {"000011010110", 38}, {"000011010111", 39}, {"000001101100", 40},
    {"000001101101", 41}, {"000011011010", 42}, {"000011011011", 43},
    {"000001010100", 44}, {"000001010101", 45}, {"000001010110", 46},
    {"000001010111", 47}, {"000001100100", 48}, {"000001100101", 49},
    {"000001010010", 50}, {"000001010011", 51}, {"000000100100", 52},
    {"000000110111", 53}, {"000000111000", 54}, {"000000100111", 55},
    {"000000101000", 56}, {"000001011000", 57}, {"000001011001", 58},
    {"000000101011", 59}, {"000000101100", 60}, {"000001011010", 61},
    {"000001100110", 62}, {"000001100111", 63},
    {"0000001111", 64}, {"000011001000", 128}, {"000011001001", 192},
    {"000001011011", 256}, {"000000110011", 320}, {"000000110100", 384},
    {"000000110101", 448}, {"0000001101100", 512}, {"0000001101101", 576},
    {"0000001001010", 640}, {"0000001001011", 704}, {"0000001001100", 768},
    {"0000001001101", 832}, {"0000001110010", 896}, {"0000001110011", 960},
    {"0000001110100", 1024}, {"0000001110101", 1088},
    {"0000001110110", 1152}, {"0000001110111", 1216},
    {"0000001010010", 1280}, {"0000001010011", 1344},
    {"0000001010100", 1408}, {"0000001010101", 1472},
    {"0000001011010", 1536}, {"0000001011011", 1600},
    {"0000001100100", 1664}, {"0000001100101", 1728},
};

constexpr CodeWord kExtendedCodes[] = {
    {"00000001000", 1792}, {"00000001100", 1856}, {"00000001101", 1920},
    {"000000010010", 1984}, {"000000010011", 2048}, {"000000010100", 2112},
    {"000000010101", 2176}, {"000000010110", 2240}, {"000000010111", 2304},
    {"000000011100", 2368}, {"000000011101", 2432}, {"000000011110", 2496},
    {"000000011111", 2560},
};

enum FaxKind : uint8_t {  // tif_fax3.h's states
  kNull = 0, kTerm, kMakeUp, kEol, kPass, kHoriz, kV0, kVR, kVL, kExt
};

constexpr CodeWord kVerticalCodes[] = {  // the vertical modes, |a1 - b1|
    {"1", 0}, {"011", 1}, {"000011", 2}, {"0000011", 3},
};
constexpr CodeWord kVerticalLeftCodes[] = {
    {"010", 1}, {"000010", 2}, {"0000010", 3},
};

constexpr int kPeek = 13;  // the longest lookup (black runs)

struct FaxEntry {
  uint8_t len = 0;  // bits the lookup takes (0 for kNull, as libtiff)
  uint8_t kind = kNull;
  int16_t value = 0;
};

// mkg3states.c's tables, indexed by the next 13 bits, the first in bit 0
// (as libtiff's bit accumulator holds them): white runs (12-bit lookups),
// black runs (13) and the 2-D modes (7). libtiff's EOL entries are 11
// zeros in the run tables and 7 in the mode table, its one extension the
// 2-D "0000001"; any other pattern that no code word starts is kNull.
struct FaxTables {
  FaxEntry white[1 << kPeek], black[1 << kPeek], mode[1 << kPeek];

  static void put(FaxEntry* t, const char* bits, uint8_t kind, int value) {
    const int len = static_cast<int>(std::strlen(bits));
    int code = 0;
    for (int i = 0; i < len; ++i) code |= (bits[i] - '0') << i;
    for (int s = 0; s < 1 << (kPeek - len); ++s) {
      FaxEntry& e = t[code | s << len];
      e.len = static_cast<uint8_t>(len);
      e.kind = kind;
      e.value = static_cast<int16_t>(value);
    }
  }

  FaxTables() {
    for (FaxEntry* t : {white, black}) {
      for (const CodeWord& c : (t == white ? kWhiteCodes : kBlackCodes))
        put(t, c.bits, c.value < 64 ? kTerm : kMakeUp, c.value);
      for (const CodeWord& c : kExtendedCodes)
        put(t, c.bits, kMakeUp, c.value);
      put(t, "00000000000", kEol, 0);
    }
    for (const CodeWord& c : kVerticalCodes)
      put(mode, c.bits, c.value == 0 ? kV0 : kVR, c.value);
    for (const CodeWord& c : kVerticalLeftCodes)
      put(mode, c.bits, kVL, c.value);
    put(mode, "0001", kPass, 0);
    put(mode, "001", kHoriz, 0);
    put(mode, "0000001", kExt, 0);
    put(mode, "0000000", kEol, 0);
  }
};

const FaxTables& fax_tables() {
  static const FaxTables t;
  return t;
}

// libtiff's int arithmetic, wrapping where a corrupt row overflows it
inline int32_t wrap(int64_t v) {
  return static_cast<int32_t>(static_cast<uint32_t>(v));
}

// The CCITT decoder of one image (compression 2, 3 or 4; `two_d`: Group
// 3 with T4Options bit 0), rows `width` pixels wide, its chunks decoded
// in the order cv::imread reads them. The bits are read as libtiff's
// NeedBits8 / NeedBits16 read them, at its lookups' widths (7 bits for a
// mode, 12 for a white run, 13 for a black one): past the last byte they
// count as zeros, up to the width asked for, and only a reader that has
// no bit left is at the end. That count sets where a Modified Huffman
// row's byte alignment lands near the end of the data.
class FaxDecoder {
 public:
  FaxDecoder(int64_t width, int compression, bool two_d)
      : lastx_(static_cast<int32_t>(width)), comp_(compression),
        ref_line_(compression == 4 || two_d), t_(fax_tables()) {
    // Fax3SetupState: nruns the width plus one rounded up to 32, twice
    // that where a reference line is kept; two arrays of nruns, zeroed
    nruns_ = (width + 32) / 32 * 32 * (ref_line_ ? 2 : 1);
    runs_.assign(static_cast<size_t>(2 * nruns_), 0);
  }

  // One chunk of `size` bytes: `rows` rows into `out`, `rb` bytes a row
  // (zeros on entry).
  void decode(const uint8_t* src, int64_t size, int64_t rows, int64_t rb,
              uint8_t* out) {
    // Fax3PreDecode
    cur_ = 0;
    if (ref_line_) {
      ref_ = nruns_;
      runs_[ref_] = static_cast<uint32_t>(lastx_);
      runs_[ref_ + 1] = 0;
    }
    start(src, size);
    try {
      for (int64_t r = 0; r < rows;) {
        const Row next = row(out + r * rb);
        if (next == kStop) return;
        if (next == kRetry) {
          // RETRY_WITHOUT_EOL: CACHE_STATE takes the chunk's state as the
          // call began, so the data are read again from their start, into
          // this row and the ones below, without EOLs from now on
          start(src, size);
          continue;
        }
        ++r;
      }
    } catch (const Overflow&) {
      // "Buffer overflow": the decoder returns before it fills the row
    }
  }

 private:
  struct Overflow {};
  enum End { kDone, kEof };
  enum Row { kNext, kStop, kRetry };

  void start(const uint8_t* src, int64_t size) {
    cp_ = src;
    ep_ = src + size;
    acc_ = 0;
    avail_ = 0;
    eolcnt_ = 0;
  }

  // One row into `row`.
  Row row(uint8_t* row) {
    a0_ = 0;
    run_ = 0;
    pa_ = 0;
    if (comp_ == 2) {  // Fax3DecodeRLE
      const End e = expand_1d();
      fill(row);
      if (e == kEof) return kStop;
      clear(avail_ & 7);  // rows start on a byte
      return kNext;
    }
    if (comp_ == 4) {  // Fax4Decode
      pb_ = 0;
      b1_ = wrap(ref(pb_++));
      const End e = expand_2d();
      if (e == kEof || eolcnt_) {  // EOFG4: the strip ends here
        fill(row);
        return kStop;
      }
      fill(row);
      set(0);  // the imaginary change that ends the reference line
      std::swap(cur_, ref_);
      return kNext;
    }
    // Fax3Decode1D / Fax3Decode2D
    if (!noeol_) {
      const int sync = sync_eol();
      if (sync == 2) {  // noEOLFound: FAXMODE_NOEOL, for good
        noeol_ = true;
        return kRetry;
      }
      if (sync == 0) {  // EOF1D / EOF2D
        cleanup();
        fill(row);
        return kStop;
      }
    }
    bool one_d = true;
    if (ref_line_) {  // the tag bit
      if (!need8(1)) {
        cleanup();
        fill(row);
        return kStop;
      }
      one_d = bits(1) != 0;
      clear(1);
      pb_ = 0;
      b1_ = wrap(ref(pb_++));
    }
    const End e = one_d ? expand_1d() : expand_2d();
    fill(row);
    if (e == kEof) return kStop;
    if (!ref_line_) return kNext;
    if (pa_ < nruns_) set(0);
    std::swap(cur_, ref_);
    return kNext;
  }

  // NeedBits8 / NeedBits16: at least n bits in the accumulator, the bytes
  // bit-reversed into it (the first bit in bit 0); past the end, zeros.
  // False at the end of the data.
  bool need8(int n) {
    if (avail_ >= n) return true;
    if (cp_ >= ep_) {
      if (avail_ == 0) return false;
      avail_ = n;
      return true;
    }
    acc_ |= static_cast<uint32_t>(reverse_bits(*cp_++)) << avail_;
    avail_ += 8;
    return true;
  }

  bool need16(int n) {
    if (avail_ >= n) return true;
    if (cp_ >= ep_) {
      if (avail_ == 0) return false;
      avail_ = n;
      return true;
    }
    acc_ |= static_cast<uint32_t>(reverse_bits(*cp_++)) << avail_;
    if ((avail_ += 8) >= n) return true;
    if (cp_ >= ep_) {
      avail_ = n;
      return true;
    }
    acc_ |= static_cast<uint32_t>(reverse_bits(*cp_++)) << avail_;
    avail_ += 8;
    return true;
  }

  uint32_t bits(int n) const { return acc_ & ((1u << n) - 1); }

  void clear(int n) {
    avail_ -= n;
    acc_ >>= n;
  }

  // LOOKUP8 (modes, 7 bits) / LOOKUP16 (white 12, black 13): the entry,
  // its bits taken; null at the end of the data
  const FaxEntry* look(const FaxEntry* t) {
    if (!(t == t_.mode ? need8(7) : need16(t == t_.white ? 12 : 13)))
      return nullptr;
    const FaxEntry& e = t[bits(kPeek)];
    clear(e.len);
    return &e;
  }

  // A reference-line entry, wherever in the two arrays it lies (a row
  // that walks its reference line back past the start reads the other
  // array); before them, libtiff reads memory that is not its own
  uint32_t ref(int64_t i) const {
    const int64_t at = ref_ + i;
    if (at < 0) throw Error{kFaxMemory};
    return runs_[static_cast<size_t>(at)];
  }

  // SETVALUE
  void set(int32_t x) {
    if (pa_ >= nruns_) throw Overflow{};
    runs_[static_cast<size_t>(cur_ + pa_++)] =
        static_cast<uint32_t>(wrap(static_cast<int64_t>(run_) + x));
    a0_ = wrap(static_cast<int64_t>(a0_) + x);
    run_ = 0;
  }

  uint32_t& at(int64_t i) { return runs_[static_cast<size_t>(cur_ + i)]; }

  // CLEANUP_RUNS: the row made `lastx` wide
  void cleanup() {
    if (run_) set(0);
    if (a0_ == lastx_) return;
    while (a0_ > lastx_ && pa_ > 0)
      a0_ = wrap(static_cast<int64_t>(a0_) - at(--pa_));
    if (a0_ < lastx_) {
      if (a0_ < 0) a0_ = 0;
      if (pa_ & 1) set(0);
      set(wrap(static_cast<int64_t>(lastx_) - a0_));
    } else if (a0_ > lastx_) {
      set(lastx_);
      set(0);
    }
  }

  // SYNC_EOL: where no EOL was just read, skip bits up to 11 zeros; then
  // zero bytes (fill) and zero bits up to the EOL's 1. 1 found, 0 the data
  // end in the search for the zeros, 2 they end before the 1 (libtiff's
  // noEOLFound).
  int sync_eol() {
    if (eolcnt_ == 0) {
      for (;;) {
        if (!need16(11)) return 0;
        if (bits(11) == 0) break;
        clear(1);
      }
    }
    for (;;) {
      if (!need8(8)) return 2;
      if (bits(8)) break;
      clear(8);
    }
    while (bits(1) == 0) clear(1);
    clear(1);
    eolcnt_ = 0;
    return 1;
  }

  // one run of the colour of table `t`, make-up codes then a terminating
  // code (SETVALUE): 1 done, 0 a bad code or an EOL (in `eol`), -1 the
  // end of the data
  int expand_run(const FaxEntry* t, bool* eol) {
    for (;;) {
      const FaxEntry* e = look(t);
      if (e == nullptr) return -1;
      switch (e->kind) {
        case kTerm:
          set(e->value);
          return 1;
        case kMakeUp:
          a0_ = wrap(static_cast<int64_t>(a0_) + e->value);
          run_ = wrap(static_cast<int64_t>(run_) + e->value);
          break;
        case kEol:
          *eol = true;
          return 0;
        default:  // "unexpected"
          return 0;
      }
    }
  }

  // EXPAND1D
  End expand_1d() {
    for (;;) {
      bool eol = false;
      int k = expand_run(t_.white, &eol);
      if (k == 1 && a0_ < lastx_) k = expand_run(t_.black, &eol);
      if (eol) eolcnt_ = 1;
      if (k < 0) {
        cleanup();
        return kEof;
      }
      if (k == 0 || a0_ >= lastx_) break;
      if (at(pa_ - 1) == 0 && at(pa_ - 2) == 0) pa_ -= 2;
    }
    cleanup();
    return kDone;
  }

  // CHECK_b1: b1 the first changing element of the reference line right
  // of a0 (once the row has a run)
  void check_b1() {
    if (pa_ == 0) return;
    while (b1_ <= a0_ && b1_ < lastx_) {
      if (pb_ + 1 >= nruns_) throw Overflow{};
      b1_ = wrap(static_cast<int64_t>(b1_)
                 + static_cast<uint32_t>(ref(pb_) + ref(pb_ + 1)));
      pb_ += 2;
    }
  }

  // EXPAND2D
  End expand_2d() {
    while (a0_ < lastx_) {
      if (pa_ >= nruns_) throw Overflow{};
      const FaxEntry* e = look(t_.mode);
      if (e == nullptr) {
        cleanup();
        return kEof;
      }
      switch (e->kind) {
        case kPass:
          check_b1();
          if (pb_ + 1 >= nruns_) throw Overflow{};
          b1_ = wrap(static_cast<int64_t>(b1_) + ref(pb_++));
          run_ = wrap(static_cast<int64_t>(run_) + b1_ - a0_);
          a0_ = b1_;
          b1_ = wrap(static_cast<int64_t>(b1_) + ref(pb_++));
          break;
        case kHoriz: {
          bool eol = false;
          const FaxEntry* first = pa_ & 1 ? t_.black : t_.white;
          const FaxEntry* second = pa_ & 1 ? t_.white : t_.black;
          int k = expand_run(first, &eol);
          if (k == 1) k = expand_run(second, &eol);
          if (k < 0) {
            cleanup();
            return kEof;
          }
          if (k == 0) {  // badBlack2d / badWhite2d, an EOL among them
            cleanup();
            return kDone;
          }
          check_b1();
          break;
        }
        case kV0:
        case kVR:
          check_b1();
          set(wrap(static_cast<int64_t>(b1_) - a0_ + e->value));
          if (pb_ >= nruns_) throw Overflow{};
          b1_ = wrap(static_cast<int64_t>(b1_) + ref(pb_++));
          break;
        case kVL:
          check_b1();
          if (b1_ < wrap(static_cast<int64_t>(a0_) + e->value)) {
            cleanup();  // "unexpected"
            return kDone;
          }
          set(wrap(static_cast<int64_t>(b1_) - a0_ - e->value));
          --pb_;
          b1_ = wrap(static_cast<int64_t>(b1_) - ref(pb_));
          break;
        case kExt:  // uncompressed mode: not supported, the row ends
          at(pa_++) = static_cast<uint32_t>(wrap(
              static_cast<int64_t>(lastx_) - a0_));
          cleanup();
          return kDone;
        default:  // kEol: 11 zeros in all
          at(pa_++) = static_cast<uint32_t>(wrap(
              static_cast<int64_t>(lastx_) - a0_));
          if (!need8(4)) {
            cleanup();
            return kEof;
          }
          clear(4);
          eolcnt_ = 1;
          cleanup();
          return kDone;
      }
    }
    if (run_) {
      if (static_cast<int64_t>(run_) + a0_ < lastx_) {  // a final V0
        if (!need8(1)) {
          cleanup();
          return kEof;
        }
        if (bits(1) == 0) {  // badMain2d
          cleanup();
          return kDone;
        }
        clear(1);
      }
      set(0);
    }
    cleanup();
    return kDone;
  }

  // _TIFFFax3fillruns: the row's runs, white as 0 bits and black as 1,
  // each cut to the row (in the array too, as libtiff cuts them there).
  // A row is filled once, on zeros, so only its black runs are written.
  void fill(uint8_t* row) {
    int64_t end = pa_;
    if (end & 1) at(end++) = 0;
    const uint32_t lastx = static_cast<uint32_t>(lastx_);
    uint32_t x = 0;
    for (int64_t i = 0; i < end; ++i) {
      uint32_t& r = at(i);
      if (x + r > lastx || r > lastx) r = lastx - x;
      if (i & 1) black(row, x, x + r);
      x += r;
    }
  }

  // bits [from, to) of `row` set
  static void black(uint8_t* row, uint32_t from, uint32_t to) {
    auto one = [row](uint32_t k) {
      row[k >> 3] = static_cast<uint8_t>(row[k >> 3] | 0x80 >> (k & 7));
    };
    for (; from < to && (from & 7); ++from) one(from);
    for (; from + 8 <= to; from += 8) row[from >> 3] = 0xFF;
    for (; from < to; ++from) one(from);
  }

  const uint8_t* cp_ = nullptr;
  const uint8_t* ep_ = nullptr;
  uint32_t acc_ = 0;  // BitAcc
  int avail_ = 0;     // BitsAvail
  int eolcnt_ = 0;    // EOLcnt
  bool noeol_ = false;  // FAXMODE_NOEOL: set once, kept for the image
  int32_t lastx_;
  int comp_;
  bool ref_line_;
  const FaxTables& t_;
  std::vector<uint32_t> runs_;  // the two run arrays, back to back
  int64_t nruns_;
  int64_t cur_ = 0, ref_ = 0;   // where thisrun and refruns start
  int32_t a0_ = 0, run_ = 0, b1_ = 0;
  int64_t pa_ = 0, pb_ = 0;
};

// --------------------------------------------------------------- YCbCr

// tif_color.c's TIFFYCbCrToRGBInit for YCbCrCoefficients `luma` and
// ReferenceBlackWhite `rbw` (C floats, as libtiff keeps them), and its
// TIFFYCbCrtoRGB: fixed point in 2^-16, tables over the 8-bit codes.
class YccToRgb {
 public:
  YccToRgb(const float* luma, const float* rbw) {
    const float f1 = 2 - 2 * luma[0];
    const float f2 = luma[0] * f1 / luma[1];
    const float f3 = 2 - 2 * luma[2];
    const float f4 = luma[2] * f3 / luma[1];
    const int32_t d1 = fix(clamp(f1)), d2 = -fix(clamp(f2));
    const int32_t d3 = fix(clamp(f3)), d4 = -fix(clamp(f4));
    for (int i = 0, x = -128; i < 256; ++i, ++x) {
      const int32_t cr = clampw(code2v(x, rbw[4] - 128.0F, rbw[5] - 128.0F,
                                       127));
      const int32_t cb = clampw(code2v(x, rbw[2] - 128.0F, rbw[3] - 128.0F,
                                       127));
      cr_r_[i] = (d1 * cr + kHalf) >> kShift;
      cb_b_[i] = (d3 * cb + kHalf) >> kShift;
      cr_g_[i] = d2 * cr;
      cb_g_[i] = d4 * cb + kHalf;
      y_[i] = clampw(code2v(x + 128, rbw[0], rbw[1], 255));
    }
  }

  void rgb(int y, int cb, int cr, int* r, int* g, int* b) const {
    *r = clamp8(y_[y] + cr_r_[cr]);
    *g = clamp8(y_[y] + ((cb_g_[cb] + cr_g_[cr]) >> kShift));
    *b = clamp8(y_[y] + cb_b_[cb]);
  }

 private:
  static constexpr int kShift = 16;
  static constexpr int32_t kHalf = 1 << (kShift - 1);

  // FIX: the float times 2^16, plus the double 0.5, truncated
  static int32_t fix(float x) {
    return static_cast<int32_t>(x * (1L << kShift) + 0.5);
  }
  static float clamp(float f) { return f < 0.0F ? 0.0F : f > 2.0F ? 2.0F : f; }
  // Code2V in C float arithmetic
  static float code2v(int c, float rb, float rw, int cr) {
    const float range = rw - rb != 0 ? rw - rb : 1;
    return (c - static_cast<int32_t>(rb)) * static_cast<float>(cr) / range;
  }
  // CLAMPw to +-128 * 32, then the int32 cast
  static int32_t clampw(float f) {
    return static_cast<int32_t>(f < -4096.0F ? -4096.0F
                                : f > 4096.0F ? 4096.0F : f);
  }
  static int clamp8(int v) { return v < 0 ? 0 : v > 255 ? 255 : v; }

  int32_t cr_r_[256], cb_b_[256], cr_g_[256], cb_g_[256], y_[256];
};

// The byte-offset step of libtiff's putcontig8bitYCbCr<h><v>tile over a
// clipped tile's skipped blocks: (fromskew / h) times this (its 4x4
// routine steps by 10 bytes a block, as its 4x2 one does).
int ycc_skew_bytes(int h, int v) {
  switch (h * 10 + v) {
    case 44: case 42: return 10;
    case 41: case 22: return 6;
    case 21: case 12: return 4;
    case 11: return 3;
    default: fail(kLayout);
  }
}

struct Tiff {
  const int64_t* p;
  const uint8_t* pal;  // 256 R, G, B entries (8-bit), for a palette

  // One chunk (strip or tile of one plane) decoded: `rows` rows of `rb`
  // bytes (`need` bytes in all, in a buffer of `full` bytes, zeros past
  // `need`: both rows * rb but for subsampled YCbCr), the fill order
  // undone, 16-bit samples little-endian, the predictor undone. `state`
  // 0 decodes the stored bytes; 1 takes them as a codec's output that
  // stopped short (a Deflate or JPEG chunk decoded before the call, or
  // none for a chunk libtiff could not read). A codec that stops short
  // leaves what it decoded and zeros after it, and libtiff then neither
  // swabs the chunk nor undoes its predictor (TIFFReadEncodedStrip /
  // TIFFReadEncodedTile skip tif_postdecode, PredictorDecodeTile its
  // accumulation), as here.
  void chunk(const uint8_t* src, int64_t size, int state, int64_t rows,
             int64_t rb, int64_t spc, int64_t need, int64_t full,
             FaxDecoder* fax, std::vector<uint8_t>* buf) const {
    buf->assign(static_cast<size_t>(full), 0);
    if (state != 0) {
      std::memcpy(buf->data(), src,
                  static_cast<size_t>(std::min(size, need)));
      return;
    }
    std::vector<uint8_t> rev;
    if (p[kFillOrder] == 2) {
      rev.resize(static_cast<size_t>(size));
      for (int64_t i = 0; i < size; ++i) rev[i] = reverse_bits(src[i]);
      src = rev.data();
    }
    bool ok = true;
    switch (p[kCompression]) {
      case 1:  // DumpModeDecode copies nothing from a short chunk
        ok = size >= need;
        if (ok) std::memcpy(buf->data(), src, static_cast<size_t>(need));
        break;
      case 2: case 3: case 4:
        fax->decode(src, size, rows, rb, buf->data());
        break;
      case 5:
        // libtiff's test for the old, bit-reversed LZW (LZWPreDecode)
        if (size >= 2 && src[0] == 0 && (src[1] & 1)) fail(kOldLzw);
        ok = lzw_decode(src, size, buf->data(), need);
        break;
      case 32773: ok = packbits_decode(src, size, buf->data(), need); break;
      default: fail(kLayout);
    }
    if (!ok) return;
    uint8_t* d = buf->data();
    const bool wide = p[kBits] == 16;
    if (wide && p[kBigEndian]) {  // libtiff swabs 16-bit data to native
      for (int64_t i = 0; i + 1 < need; i += 2) {
        const uint8_t hi = d[i];
        d[i] = d[i + 1];
        d[i + 1] = hi;
      }
    }
    if (p[kPredictor] != 2) return;
    const int64_t n = rb / (wide ? 2 : 1);  // samples a row
    for (int64_t r = 0; r < rows; ++r) {
      uint8_t* row = d + r * rb;
      if (!wide) {
        for (int64_t i = spc; i < n; ++i)
          row[i] = static_cast<uint8_t>(row[i] + row[i - spc]);
        continue;
      }
      for (int64_t i = spc; i < n; ++i) {
        uint8_t* a = row + 2 * i;
        const uint8_t* b = row + 2 * (i - spc);
        const int v = ((a[0] | (a[1] << 8)) + (b[0] | (b[1] << 8))) & 0xFFFF;
        a[0] = static_cast<uint8_t>(v);
        a[1] = static_cast<uint8_t>(v >> 8);
      }
    }
  }

  // sample `s` of pixel `x` in a row of `spc` samples a pixel
  int sample(const uint8_t* row, int64_t x, int64_t spc, int s) const {
    const int64_t i = x * spc + s;
    switch (p[kBits]) {
      case 1: return (row[i >> 3] >> (7 - (i & 7))) & 1;
      case 4: return (row[i >> 1] >> (i & 1 ? 0 : 4)) & 15;
      case 8: return row[i];
      default: return row[2 * i] | (row[2 * i + 1] << 8);  // swabbed
    }
  }
};

inline int to8(int v) { return (v + 128) / 257; }  // Bitdepth16To8
inline int premul(int v, int a) { return (v * a + 127) / 255; }  // UaToAa

// The TIFF's pixels from its chunks (`chunks[i]`, `sizes[i]` bytes: as
// stored for compression 1-5 and 32773, else already inflated or decoded
// and given as compression 1), `p` the parameters of enum Param
// (photometric 0 MINISWHITE, 1 MINISBLACK, 2 RGB, 3 PALETTE, 5 CMYK, 6
// YCbCr; alpha 0 none, 1 associated, 2 unassociated; tiled 0 or 1; chunk
// width and height the tile's, or the width and rows per strip; fax
// options T4Options or T6Options; YCbCr subsampling h x v), `pal` 256 R,
// G, B triples for a palette, `ycc` the YCbCrCoefficients and
// ReferenceBlackWhite of a YCbCr image (9 floats), into (want, height,
// width) uint8.
void decode(const uint8_t* const* chunks, const int64_t* sizes,
            const uint8_t* states, int64_t nchunks, const int64_t* p,
            const uint8_t* pal, const float* ycc, int want, uint8_t* out) {
  const int64_t W = p[kWidth], H = p[kHeight], bits = p[kBits];
  const int64_t spp = p[kSpp], cw = p[kChunkW], ch = p[kChunkH];
  const int phot = static_cast<int>(p[kPhotometric]);
  const bool planar = p[kPlanar] == 2 && spp > 1;
  const int alpha = static_cast<int>(p[kAlpha]);
  const int orient = static_cast<int>(p[kOrientation]);
  if ((want != 1 && want != 3) || W <= 0 || H <= 0 || cw <= 0 || ch <= 0
      || spp < 1 || spp > 4 || orient < 1 || orient > 4)
    fail(kLayout);
  const int64_t across = (W + cw - 1) / cw, down = (H + ch - 1) / ch;
  const int64_t per_plane = across * down;
  if (nchunks != per_plane * (planar ? spp : 1)) fail(kLayout);
  const int64_t spc = planar ? 1 : spp;  // samples a pixel in a chunk
  const int64_t rb = (cw * spc * bits + 7) / 8;
  const bool gray = phot == 0 || phot == 1;
  // the planes a planar image reads: gray (+ alpha), R, G, B (+ alpha),
  // C, M, Y, K
  const int nplanes = !planar ? 1
                      : phot == 5 ? 4
                      : (gray ? 1 : 3) + (alpha ? 1 : 0);
  if (planar && nplanes > spp) fail(kLayout);
  const bool tiled = p[kTiled] != 0;
  const bool flip_x = orient == 2 || orient == 3;
  const bool flip_y = orient == 3 || orient == 4;
  const int64_t plane = W * H;
  // YCbCr: blocks of sub_h x sub_v luma samples, then Cb and Cr
  const bool ycbcr = phot == 6;
  const int sub_h = ycbcr ? static_cast<int>(p[kSubH]) : 1;
  const int sub_v = ycbcr ? static_cast<int>(p[kSubV]) : 1;
  const int64_t block = sub_h * sub_v + 2;
  int skew = 0;
  std::unique_ptr<YccToRgb> to_rgb;
  if (ycbcr) {
    if (planar || spp != 3 || bits != 8 || ycc == nullptr) fail(kLayout);
    skew = ycc_skew_bytes(sub_h, sub_v);
    to_rgb = std::make_unique<YccToRgb>(ycc, ycc + 3);
  }
  Tiff t{p, pal};
  std::vector<uint8_t> buf[4];
  std::unique_ptr<FaxDecoder> fax;
  if (p[kCompression] >= 2 && p[kCompression] <= 4)
    fax = std::make_unique<FaxDecoder>(
        cw, static_cast<int>(p[kCompression]),
        p[kCompression] == 3 && (p[kFaxOptions] & 1));
  for (int64_t gy = 0; gy < down; ++gy) {
    const int64_t y0 = gy * ch;
    const int64_t vh = H - y0 < ch ? H - y0 : ch;
    // a strip holds only the rows inside the image; a tile is whole
    const int64_t rows = tiled ? ch : vh;
    for (int64_t gx = 0; gx < across; ++gx) {
      const int64_t x0 = gx * cw;
      const int64_t vw = W - x0 < cw ? W - x0 : cw;
      // the bytes libtiff decodes, and its buffer's size: for YCbCr,
      // TIFFVStripSize / TIFFVTileSize, a strip cut to its rows rounded up
      // to whole blocks times TIFFScanlineSize (a block row over sub_v,
      // rounded down)
      int64_t need = rows * rb, full = need, stride = rb;
      if (ycbcr) {
        const int64_t block_row = (cw + sub_h - 1) / sub_h * block;
        const int64_t block_rows = (rows + sub_v - 1) / sub_v;
        full = block_row * block_rows;
        need = tiled ? full : std::min(full, block_rows * sub_v
                                                 * (block_row / sub_v));
        // the put routine's step from one block row to the next
        stride = (vw + sub_h - 1) / sub_h * block
                 + (cw - vw) / sub_h * skew;
      }
      for (int k = 0; k < nplanes; ++k) {
        const int64_t i = k * per_plane + gy * across + gx;
        if (chunks[i] == nullptr) fail(kLayout);
        t.chunk(chunks[i], sizes[i], states == nullptr ? 0 : states[i],
                rows, rb, spc, need, full, fax.get(), &buf[k]);
      }
      // libtiff's putgreytile, put16bitbwtile and put8bitcmaptile step
      // past a clipped tile's right part by its width in pixels, not in
      // bytes: where a pixel is more than one byte, they read each row of
      // a tile the image cuts from there on
      const int64_t px_bytes = spc * bits / 8;
      if (tiled && !planar && vw < cw && px_bytes > 1
          && (gray || (phot == 3 && bits == 8)))
        stride = vw * px_bytes + (cw - vw);
      for (int64_t r = 0; r < vh; ++r) {
        const uint8_t* row[4];
        for (int k = 0; k < nplanes && !ycbcr; ++k)
          row[k] = buf[k].data() + r * stride;
        const int64_t oy = flip_y ? H - 1 - (y0 + r) : y0 + r;
        for (int64_t c = 0; c < vw; ++c) {
          int R, G, B;
          if (ycbcr) {
            const uint8_t* b = buf[0].data() + r / sub_v * stride
                               + c / sub_h * block;
            to_rgb->rgb(b[r % sub_v * sub_h + c % sub_h], b[block - 2],
                        b[block - 1], &R, &G, &B);
          } else if (planar) {
            if (phot == 5) {
              const int K = 255 - row[3][c];
              R = K * (255 - row[0][c]) / 255;
              G = K * (255 - row[1][c]) / 255;
              B = K * (255 - row[2][c]) / 255;
            } else {
              const int nc = gray ? 1 : 3;
              int v[3];
              for (int k = 0; k < nc; ++k) {
                v[k] = t.sample(row[k], c, 1, 0);
                if (bits == 16) v[k] = to8(v[k]);
              }
              if (gray) v[1] = v[2] = v[0];
              if (alpha == 2) {
                int a = t.sample(row[nc], c, 1, 0);
                if (bits == 16) a = to8(a);
                for (int k = 0; k < 3; ++k) v[k] = premul(v[k], a);
              }
              R = v[0];
              G = v[1];
              B = v[2];
            }
          } else if (gray) {
            int v = t.sample(row[0], c, spc, 0);
            v = bits == 1 ? (v ? 255 : 0) : bits == 16 ? v >> 8 : v;
            R = G = B = phot == 0 ? 255 - v : v;
          } else if (phot == 3) {
            const int idx = t.sample(row[0], c, spc, 0);
            R = pal[3 * idx];
            G = pal[3 * idx + 1];
            B = pal[3 * idx + 2];
          } else if (phot == 5) {
            const uint8_t* s = row[0] + c * spc;
            const int K = 255 - s[3];
            R = K * (255 - s[0]) / 255;
            G = K * (255 - s[1]) / 255;
            B = K * (255 - s[2]) / 255;
          } else {
            int v[3];
            for (int k = 0; k < 3; ++k) {
              v[k] = t.sample(row[0], c, spc, k);
              if (bits == 16) v[k] = to8(v[k]);
            }
            if (alpha == 2) {
              int a = t.sample(row[0], c, spc, 3);
              if (bits == 16) a = to8(a);
              for (int k = 0; k < 3; ++k) v[k] = premul(v[k], a);
            }
            R = v[0];
            G = v[1];
            B = v[2];
          }
          const int64_t ox = flip_x ? x0 + vw - 1 - c : x0 + c;
          const int64_t o = oy * W + ox;
          if (want == 1) {
            out[o] = bgr2gray(B, G, R);
          } else {
            out[o] = static_cast<uint8_t>(B);
            out[plane + o] = static_cast<uint8_t>(G);
            out[2 * plane + o] = static_cast<uint8_t>(R);
          }
        }
      }
    }
  }
}

}  // namespace

// See `decode`; `states[i]` (null: all 0) how chunk i is taken (Tiff::
// chunk). Returns 0, -2 for parameters it does not take, -4 out of
// memory, -5 for old-style LZW, -6 for CCITT data on which libtiff reads
// memory that is not its own (enum Code).
extern "C" int64_t of_tiff_decode(const uint8_t* const* chunks,
                                  const int64_t* sizes,
                                  const uint8_t* states, int64_t nchunks,
                                  const int64_t* params, const uint8_t* pal,
                                  const float* ycc, int want, uint8_t* out) {
  try {
    decode(chunks, sizes, states, nchunks, params, pal, ycc, want, out);
    return 0;
  } catch (const Error& e) {
    return e.code;
  } catch (const std::bad_alloc&) {
    return kNoMemory;
  }
}
