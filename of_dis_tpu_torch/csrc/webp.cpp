// WebP decoding on the host, pixel for pixel as cv::imread reads a WebP:
// OpenCV's WebP reader over libwebp, which gives BGR (or BGRA, whose alpha
// cv::imread drops) through WebPDecodeBGRInto, frame 0 of an animation
// through WebPAnimDecoder, and gray as OpenCV's cvtColor BGR2GRAY of those
// BGR pixels; the EXIF orientation of an extended file is applied.
//
// Reached through native/io.py (`decode_batch`, `decode_image`) and
// utils/io.py (`load_image`), which parse the RIFF container
// (`utils.io.webp_chunks`) and pass the image's bitstream here; the JAX
// package reads the same files with cv2.imread (of_dis_tpu/utils/io.py::
// load_image and the cv2 fallback of of_dis_tpu/pipeline.py::
// _decode_batch). Plain C entries, no CUDA, no libwebp: a ctypes call
// releases the interpreter lock, so a thread pool decodes frames side by
// side.
//
// Written from RFC 6386 (VP8) and RFC 9649 (the WebP container and the
// lossless format), with the rules of libwebp that decide the pixels where
// the RFCs leave a choice or where libwebp's output is what cv2 returns:
//   - VP8 (lossy): the boolean decoder and its end-of-data rule, segments,
//     both loop filters, intra prediction over unfiltered neighbours with
//     libwebp's 127 / 129 borders and top-right replication, the inverse
//     transforms as the x86 build runs them (the full 4x4 transform in
//     16-bit lanes as its SSE2 version, the DC and three-coefficient
//     shortcuts in int), then the "fancy" 4:2:0 upsampling and libwebp's
//     14-bit YUV to RGB.
//   - VP8L (lossless): prefix codes (simple and normal, built into
//     libwebp's two-level tables under its completeness rules), the meta
//     prefix image, the colour cache, LZ77 references, the four
//     transforms, and libwebp's end-of-stream rule on the bit reader.
//   - ALPH: decoded as libwebp decodes it alongside the colour (a corrupt
//     alpha plane fails the read as it fails libwebp's), its values
//     dropped: cv::imread's BGR and gray ignore alpha.
// Every read is bounds-checked: a corrupt stream returns an error code
// (`of_webp_strerror`), never an image of other pixels.

#include <algorithm>
#include <cstddef>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <new>
#include <vector>

#include "gray.h"
#include "orient.h"

namespace {

enum Code {
  kOk = 0,
  kBadVp8Header = -1,
  kNotKeyFrame = -2,
  kVp8Truncated = -3,
  kVp8Partitions = -4,
  kVp8Header = -5,
  kVp8Data = -6,
  kBadVp8lHeader = -7,
  kVp8lData = -8,
  kVp8lTruncated = -9,
  kAlpha = -10,
  kSize = -11,
  kChannels = -12,
  kNoMemory = -13,
  kPlacement = -14,
};

struct Error {
  int code;
};

[[noreturn]] void fail(int code) { throw Error{code}; }

inline uint8_t clip8(int v) {
  return static_cast<uint8_t>(v < 0 ? 0 : v > 255 ? 255 : v);
}

// ------------------------------------------------------- RFC 6386 tables

constexpr uint8_t kDcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14,
    15, 16, 17, 17, 18, 19, 20, 20, 21, 21, 22, 22,
    23, 23, 24, 25, 25, 26, 27, 28, 29, 30, 31, 32,
    33, 34, 35, 36, 37, 37, 38, 39, 40, 41, 42, 43,
    44, 45, 46, 46, 47, 48, 49, 50, 51, 52, 53, 54,
    55, 56, 57, 58, 59, 60, 61, 62, 63, 64, 65, 66,
    67, 68, 69, 70, 71, 72, 73, 74, 75, 76, 76, 77,
    78, 79, 80, 81, 82, 83, 84, 85, 86, 87, 88, 89,
    91, 93, 95, 96, 98, 100, 101, 102, 104, 106, 108, 110,
    112, 114, 116, 118, 122, 124, 126, 128, 130, 132, 134, 136,
    138, 140, 143, 145, 148, 151, 154, 157,
};
constexpr uint16_t kAcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15,
    16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27,
    28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 38, 39,
    40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51,
    52, 53, 54, 55, 56, 57, 58, 60, 62, 64, 66, 68,
    70, 72, 74, 76, 78, 80, 82, 84, 86, 88, 90, 92,
    94, 96, 98, 100, 102, 104, 106, 108, 110, 112, 114, 116,
    119, 122, 125, 128, 131, 134, 137, 140, 143, 146, 149, 152,
    155, 158, 161, 164, 167, 170, 173, 177, 181, 185, 189, 193,
    197, 201, 205, 209, 213, 217, 221, 225, 229, 234, 239, 245,
    249, 254, 259, 264, 269, 274, 279, 284,
};
constexpr uint8_t kCoeffsProba0[4 * 8 * 3 * 11] = {
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    253, 136, 254, 255, 228, 219, 128, 128, 128, 128, 128,
    189, 129, 242, 255, 227, 213, 255, 219, 128, 128, 128,
    106, 126, 227, 252, 214, 209, 255, 255, 128, 128, 128,
    1, 98, 248, 255, 236, 226, 255, 255, 128, 128, 128,
    181, 133, 238, 254, 221, 234, 255, 154, 128, 128, 128,
    78, 134, 202, 247, 198, 180, 255, 219, 128, 128, 128,
    1, 185, 249, 255, 243, 255, 128, 128, 128, 128, 128,
    184, 150, 247, 255, 236, 224, 128, 128, 128, 128, 128,
    77, 110, 216, 255, 236, 230, 128, 128, 128, 128, 128,
    1, 101, 251, 255, 241, 255, 128, 128, 128, 128, 128,
    170, 139, 241, 252, 236, 209, 255, 255, 128, 128, 128,
    37, 116, 196, 243, 228, 255, 255, 255, 128, 128, 128,
    1, 204, 254, 255, 245, 255, 128, 128, 128, 128, 128,
    207, 160, 250, 255, 238, 128, 128, 128, 128, 128, 128,
    102, 103, 231, 255, 211, 171, 128, 128, 128, 128, 128,
    1, 152, 252, 255, 240, 255, 128, 128, 128, 128, 128,
    177, 135, 243, 255, 234, 225, 128, 128, 128, 128, 128,
    80, 129, 211, 255, 194, 224, 128, 128, 128, 128, 128,
    1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    246, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    198, 35, 237, 223, 193, 187, 162, 160, 145, 155, 62,
    131, 45, 198, 221, 172, 176, 220, 157, 252, 221, 1,
    68, 47, 146, 208, 149, 167, 221, 162, 255, 223, 128,
    1, 149, 241, 255, 221, 224, 255, 255, 128, 128, 128,
    184, 141, 234, 253, 222, 220, 255, 199, 128, 128, 128,
    81, 99, 181, 242, 176, 190, 249, 202, 255, 255, 128,
    1, 129, 232, 253, 214, 197, 242, 196, 255, 255, 128,
    99, 121, 210, 250, 201, 198, 255, 202, 128, 128, 128,
    23, 91, 163, 242, 170, 187, 247, 210, 255, 255, 128,
    1, 200, 246, 255, 234, 255, 128, 128, 128, 128, 128,
    109, 178, 241, 255, 231, 245, 255, 255, 128, 128, 128,
    44, 130, 201, 253, 205, 192, 255, 255, 128, 128, 128,
    1, 132, 239, 251, 219, 209, 255, 165, 128, 128, 128,
    94, 136, 225, 251, 218, 190, 255, 255, 128, 128, 128,
    22, 100, 174, 245, 186, 161, 255, 199, 128, 128, 128,
    1, 182, 249, 255, 232, 235, 128, 128, 128, 128, 128,
    124, 143, 241, 255, 227, 234, 128, 128, 128, 128, 128,
    35, 77, 181, 251, 193, 211, 255, 205, 128, 128, 128,
    1, 157, 247, 255, 236, 231, 255, 255, 128, 128, 128,
    121, 141, 235, 255, 225, 227, 255, 255, 128, 128, 128,
    45, 99, 188, 251, 195, 217, 255, 224, 128, 128, 128,
    1, 1, 251, 255, 213, 255, 128, 128, 128, 128, 128,
    203, 1, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    137, 1, 177, 255, 224, 255, 128, 128, 128, 128, 128,
    253, 9, 248, 251, 207, 208, 255, 192, 128, 128, 128,
    175, 13, 224, 243, 193, 185, 249, 198, 255, 255, 128,
    73, 17, 171, 221, 161, 179, 236, 167, 255, 234, 128,
    1, 95, 247, 253, 212, 183, 255, 255, 128, 128, 128,
    239, 90, 244, 250, 211, 209, 255, 255, 128, 128, 128,
    155, 77, 195, 248, 188, 195, 255, 255, 128, 128, 128,
    1, 24, 239, 251, 218, 219, 255, 205, 128, 128, 128,
    201, 51, 219, 255, 196, 186, 128, 128, 128, 128, 128,
    69, 46, 190, 239, 201, 218, 255, 228, 128, 128, 128,
    1, 191, 251, 255, 255, 128, 128, 128, 128, 128, 128,
    223, 165, 249, 255, 213, 255, 128, 128, 128, 128, 128,
    141, 124, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    1, 16, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    190, 36, 230, 255, 236, 255, 128, 128, 128, 128, 128,
    149, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    1, 226, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    247, 192, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    240, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    1, 134, 252, 255, 255, 128, 128, 128, 128, 128, 128,
    213, 62, 250, 255, 255, 128, 128, 128, 128, 128, 128,
    55, 93, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    202, 24, 213, 235, 186, 191, 220, 160, 240, 175, 255,
    126, 38, 182, 232, 169, 184, 228, 174, 255, 187, 128,
    61, 46, 138, 219, 151, 178, 240, 170, 255, 216, 128,
    1, 112, 230, 250, 199, 191, 247, 159, 255, 255, 128,
    166, 109, 228, 252, 211, 215, 255, 174, 128, 128, 128,
    39, 77, 162, 232, 172, 180, 245, 178, 255, 255, 128,
    1, 52, 220, 246, 198, 199, 249, 220, 255, 255, 128,
    124, 74, 191, 243, 183, 193, 250, 221, 255, 255, 128,
    24, 71, 130, 219, 154, 170, 243, 182, 255, 255, 128,
    1, 182, 225, 249, 219, 240, 255, 224, 128, 128, 128,
    149, 150, 226, 252, 216, 205, 255, 171, 128, 128, 128,
    28, 108, 170, 242, 183, 194, 254, 223, 255, 255, 128,
    1, 81, 230, 252, 204, 203, 255, 192, 128, 128, 128,
    123, 102, 209, 247, 188, 196, 255, 233, 128, 128, 128,
    20, 95, 153, 243, 164, 173, 255, 203, 128, 128, 128,
    1, 222, 248, 255, 216, 213, 128, 128, 128, 128, 128,
    168, 175, 246, 252, 235, 205, 255, 255, 128, 128, 128,
    47, 116, 215, 255, 211, 212, 255, 255, 128, 128, 128,
    1, 121, 236, 253, 212, 214, 255, 255, 128, 128, 128,
    141, 84, 213, 252, 201, 202, 255, 219, 128, 128, 128,
    42, 80, 160, 240, 162, 185, 255, 205, 128, 128, 128,
    1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    244, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    238, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
};
constexpr uint8_t kCoeffsUpdateProba[4 * 8 * 3 * 11] = {
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    176, 246, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 241, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 244, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    234, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 246, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    239, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 254, 255, 255, 255, 255, 255, 255,
    250, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    217, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    225, 252, 241, 253, 255, 255, 254, 255, 255, 255, 255,
    234, 250, 241, 250, 253, 255, 253, 254, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    238, 253, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    247, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    186, 251, 250, 255, 255, 255, 255, 255, 255, 255, 255,
    234, 251, 244, 254, 255, 255, 255, 255, 255, 255, 255,
    251, 251, 243, 253, 254, 255, 254, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    236, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 253, 253, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    248, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 254, 252, 254, 255, 255, 255, 255, 255, 255, 255,
    248, 254, 249, 253, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    246, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 254, 251, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    248, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    245, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 251, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
};
constexpr uint8_t kBModesProba[10 * 10 * 9] = {
    231, 120, 48, 89, 115, 113, 120, 152, 112,
    152, 179, 64, 126, 170, 118, 46, 70, 95,
    175, 69, 143, 80, 85, 82, 72, 155, 103,
    56, 58, 10, 171, 218, 189, 17, 13, 152,
    114, 26, 17, 163, 44, 195, 21, 10, 173,
    121, 24, 80, 195, 26, 62, 44, 64, 85,
    144, 71, 10, 38, 171, 213, 144, 34, 26,
    170, 46, 55, 19, 136, 160, 33, 206, 71,
    63, 20, 8, 114, 114, 208, 12, 9, 226,
    81, 40, 11, 96, 182, 84, 29, 16, 36,
    134, 183, 89, 137, 98, 101, 106, 165, 148,
    72, 187, 100, 130, 157, 111, 32, 75, 80,
    66, 102, 167, 99, 74, 62, 40, 234, 128,
    41, 53, 9, 178, 241, 141, 26, 8, 107,
    74, 43, 26, 146, 73, 166, 49, 23, 157,
    65, 38, 105, 160, 51, 52, 31, 115, 128,
    104, 79, 12, 27, 217, 255, 87, 17, 7,
    87, 68, 71, 44, 114, 51, 15, 186, 23,
    47, 41, 14, 110, 182, 183, 21, 17, 194,
    66, 45, 25, 102, 197, 189, 23, 18, 22,
    88, 88, 147, 150, 42, 46, 45, 196, 205,
    43, 97, 183, 117, 85, 38, 35, 179, 61,
    39, 53, 200, 87, 26, 21, 43, 232, 171,
    56, 34, 51, 104, 114, 102, 29, 93, 77,
    39, 28, 85, 171, 58, 165, 90, 98, 64,
    34, 22, 116, 206, 23, 34, 43, 166, 73,
    107, 54, 32, 26, 51, 1, 81, 43, 31,
    68, 25, 106, 22, 64, 171, 36, 225, 114,
    34, 19, 21, 102, 132, 188, 16, 76, 124,
    62, 18, 78, 95, 85, 57, 50, 48, 51,
    193, 101, 35, 159, 215, 111, 89, 46, 111,
    60, 148, 31, 172, 219, 228, 21, 18, 111,
    112, 113, 77, 85, 179, 255, 38, 120, 114,
    40, 42, 1, 196, 245, 209, 10, 25, 109,
    88, 43, 29, 140, 166, 213, 37, 43, 154,
    61, 63, 30, 155, 67, 45, 68, 1, 209,
    100, 80, 8, 43, 154, 1, 51, 26, 71,
    142, 78, 78, 16, 255, 128, 34, 197, 171,
    41, 40, 5, 102, 211, 183, 4, 1, 221,
    51, 50, 17, 168, 209, 192, 23, 25, 82,
    138, 31, 36, 171, 27, 166, 38, 44, 229,
    67, 87, 58, 169, 82, 115, 26, 59, 179,
    63, 59, 90, 180, 59, 166, 93, 73, 154,
    40, 40, 21, 116, 143, 209, 34, 39, 175,
    47, 15, 16, 183, 34, 223, 49, 45, 183,
    46, 17, 33, 183, 6, 98, 15, 32, 183,
    57, 46, 22, 24, 128, 1, 54, 17, 37,
    65, 32, 73, 115, 28, 128, 23, 128, 205,
    40, 3, 9, 115, 51, 192, 18, 6, 223,
    87, 37, 9, 115, 59, 77, 64, 21, 47,
    104, 55, 44, 218, 9, 54, 53, 130, 226,
    64, 90, 70, 205, 40, 41, 23, 26, 57,
    54, 57, 112, 184, 5, 41, 38, 166, 213,
    30, 34, 26, 133, 152, 116, 10, 32, 134,
    39, 19, 53, 221, 26, 114, 32, 73, 255,
    31, 9, 65, 234, 2, 15, 1, 118, 73,
    75, 32, 12, 51, 192, 255, 160, 43, 51,
    88, 31, 35, 67, 102, 85, 55, 186, 85,
    56, 21, 23, 111, 59, 205, 45, 37, 192,
    55, 38, 70, 124, 73, 102, 1, 34, 98,
    125, 98, 42, 88, 104, 85, 117, 175, 82,
    95, 84, 53, 89, 128, 100, 113, 101, 45,
    75, 79, 123, 47, 51, 128, 81, 171, 1,
    57, 17, 5, 71, 102, 57, 53, 41, 49,
    38, 33, 13, 121, 57, 73, 26, 1, 85,
    41, 10, 67, 138, 77, 110, 90, 47, 114,
    115, 21, 2, 10, 102, 255, 166, 23, 6,
    101, 29, 16, 10, 85, 128, 101, 196, 26,
    57, 18, 10, 102, 102, 213, 34, 20, 43,
    117, 20, 15, 36, 163, 128, 68, 1, 26,
    102, 61, 71, 37, 34, 53, 31, 243, 192,
    69, 60, 71, 38, 73, 119, 28, 222, 37,
    68, 45, 128, 34, 1, 47, 11, 245, 171,
    62, 17, 19, 70, 146, 85, 55, 62, 70,
    37, 43, 37, 154, 100, 163, 85, 160, 1,
    63, 9, 92, 136, 28, 64, 32, 201, 85,
    75, 15, 9, 9, 64, 255, 184, 119, 16,
    86, 6, 28, 5, 64, 255, 25, 248, 1,
    56, 8, 17, 132, 137, 255, 55, 116, 128,
    58, 15, 20, 82, 135, 57, 26, 121, 40,
    164, 50, 31, 137, 154, 133, 25, 35, 218,
    51, 103, 44, 131, 131, 123, 31, 6, 158,
    86, 40, 64, 135, 148, 224, 45, 183, 128,
    22, 26, 17, 131, 240, 154, 14, 1, 209,
    45, 16, 21, 91, 64, 222, 7, 1, 197,
    56, 21, 39, 155, 60, 138, 23, 102, 213,
    83, 12, 13, 54, 192, 255, 68, 47, 28,
    85, 26, 85, 85, 128, 128, 32, 146, 171,
    18, 11, 7, 63, 144, 171, 4, 4, 246,
    35, 27, 10, 146, 174, 171, 12, 26, 128,
    190, 80, 35, 99, 180, 80, 126, 54, 45,
    85, 126, 47, 87, 176, 51, 41, 20, 32,
    101, 75, 128, 139, 118, 146, 116, 128, 85,
    56, 41, 15, 176, 236, 85, 37, 9, 62,
    71, 30, 17, 119, 118, 255, 17, 18, 138,
    101, 38, 60, 138, 55, 70, 43, 26, 142,
    146, 36, 19, 30, 171, 255, 97, 27, 20,
    138, 45, 61, 62, 219, 1, 81, 188, 64,
    32, 41, 20, 117, 151, 142, 20, 21, 163,
    112, 19, 12, 61, 195, 128, 48, 4, 24,
};
constexpr uint8_t kCodeToPlane[120] = {
    24, 7, 23, 25, 40, 6, 39, 41, 22, 26, 38, 42,
    56, 5, 55, 57, 21, 27, 54, 58, 37, 43, 72, 4,
    71, 73, 20, 28, 53, 59, 70, 74, 36, 44, 88, 69,
    75, 52, 60, 3, 87, 89, 19, 29, 86, 90, 35, 45,
    68, 76, 85, 91, 51, 61, 104, 2, 103, 105, 18, 30,
    102, 106, 34, 46, 84, 92, 67, 77, 101, 107, 50, 62,
    120, 1, 119, 121, 83, 93, 17, 31, 100, 108, 66, 78,
    118, 122, 33, 47, 117, 123, 49, 63, 99, 109, 82, 94,
    0, 116, 124, 65, 79, 16, 32, 98, 110, 48, 115, 125,
    81, 95, 64, 114, 126, 97, 111, 80, 113, 127, 96, 112,
};

constexpr uint8_t kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6,
                                 9, 12, 13, 10, 7, 11, 14, 15};
// coefficient position -> band; entry 16 is a sentinel, as in libwebp
constexpr uint8_t kBands[17] = {0, 1, 2, 3, 6, 4, 5, 6, 6,
                                6, 6, 6, 6, 6, 6, 7, 0};
constexpr uint8_t kCat3[] = {173, 148, 140, 0};
constexpr uint8_t kCat4[] = {176, 155, 140, 135, 0};
constexpr uint8_t kCat5[] = {180, 157, 141, 134, 130, 0};
constexpr uint8_t kCat6[] = {254, 254, 243, 230, 196, 177, 153, 140, 133, 130,
                             129, 0};
const uint8_t* const kCat3456[4] = {kCat3, kCat4, kCat5, kCat6};

// intra modes, numbered as libwebp numbers them (kBModesProba's order)
enum {
  B_DC_PRED = 0, B_TM_PRED, B_VE_PRED, B_HE_PRED, B_RD_PRED, B_VR_PRED,
  B_LD_PRED, B_VL_PRED, B_HD_PRED, B_HU_PRED, kNumBModes,
  DC_PRED = B_DC_PRED, V_PRED = B_VE_PRED, H_PRED = B_HE_PRED,
  TM_PRED = B_TM_PRED,
  B_DC_PRED_NOTOP = kNumBModes, B_DC_PRED_NOLEFT, B_DC_PRED_NOTOPLEFT
};

// the 4x4 mode tree (RFC 6386 section 11.2), node i's probability prob[i]
constexpr int8_t kYModesIntra4[18] = {
    -B_DC_PRED, 1, -B_TM_PRED, 2, -B_VE_PRED, 3, 4, 6, -B_HE_PRED, 5,
    -B_RD_PRED, -B_VR_PRED, -B_LD_PRED, 7, -B_VL_PRED, 8, -B_HD_PRED,
    -B_HU_PRED};

// ------------------------------------------------------ boolean decoder

// RFC 6386 section 7 as libwebp reads it: `range_` holds the range minus
// one, `value_` the unread bits with `bits_` + 8 of them in the window.
// Past the end of its data the reader shifts in one byte of zeros and
// sets eof, which the decoder checks where libwebp checks it.
class BoolReader {
 public:
  void init(const uint8_t* p, size_t n) {
    buf_ = p;
    end_ = p + n;
    value_ = 0;
    bits_ = -8;
    range_ = 254;
    eof_ = false;
    load();
  }

  bool eof() const { return eof_; }

  int bit(int prob) {
    if (bits_ < 0) load();
    const int pos = bits_;
    uint32_t range = range_;
    const uint32_t split = (range * static_cast<uint32_t>(prob)) >> 8;
    const uint32_t value = static_cast<uint32_t>(value_ >> pos);
    int bit;
    if (value > split) {
      range -= split;
      value_ -= static_cast<uint64_t>(split + 1) << pos;
      bit = 1;
    } else {
      range = split + 1;
      bit = 0;
    }
    const int shift = 7 ^ (31 ^ __builtin_clz(range));
    range <<= shift;
    bits_ -= shift;
    range_ = range - 1;
    return bit;
  }

  uint32_t value(int nbits) {
    uint32_t v = 0;
    while (nbits-- > 0) v |= static_cast<uint32_t>(bit(0x80)) << nbits;
    return v;
  }

  int signed_value(int nbits) {
    const int v = static_cast<int>(value(nbits));
    return bit(0x80) ? -v : v;
  }

 private:
  void load() {
    if (end_ - buf_ >= 8) {  // 56 bits at a time
      uint64_t in = 0;
      for (int i = 0; i < 7; ++i) in = (in << 8) | buf_[i];
      buf_ += 7;
      value_ = (value_ << 56) | in;
      bits_ += 56;
    } else if (buf_ < end_) {
      bits_ += 8;
      value_ = (value_ << 8) | *buf_++;
    } else if (!eof_) {
      value_ <<= 8;
      bits_ += 8;
      eof_ = true;
    } else {
      bits_ = 0;
    }
  }

  const uint8_t* buf_ = nullptr;
  const uint8_t* end_ = nullptr;
  uint64_t value_ = 0;
  int bits_ = 0;
  uint32_t range_ = 0;
  bool eof_ = false;
};

// ----------------------------------------------- VP8 transforms (x86)

constexpr int kBps = 32;  // stride of the reconstruction buffer

inline uint8_t clip_8b(int v) {
  return static_cast<uint8_t>(!(v & ~0xff) ? v : v < 0 ? 0 : 255);
}

inline int mul1(int a) { return ((a * 20091) >> 16) + a; }
inline int mul2(int a) { return (a * 35468) >> 16; }

inline int16_t w16(int v) { return static_cast<int16_t>(v); }
inline int16_t mulhi16(int16_t a, int k) {
  return static_cast<int16_t>((static_cast<int32_t>(a) * k) >> 16);
}

// The full inverse transform of one 4x4 block added to `dst`, as
// libwebp's Transform_SSE2 computes it: every sum in 16-bit lanes that
// wrap, the multiplies as _mm_mulhi_epi16 with 20091 and -30068 (35468
// less 2^16) plus the input, the sum with the prediction wrapped to 16
// bits and saturated to 8. On the values an encoder produces this equals
// the C transform of RFC 6386 section 14.3; on corrupt streams it stays
// what cv2's libwebp returns.
void transform_full(const int16_t* in, uint8_t* dst) {
  int16_t tmp[4][4];  // [output of the pass][lane]
  for (int i = 0; i < 4; ++i) {
    const int16_t in0 = in[i], in1 = in[4 + i], in2 = in[8 + i],
                  in3 = in[12 + i];
    const int16_t a = w16(in0 + in2), b = w16(in0 - in2);
    const int16_t c = w16(w16(in1 - in3)
                          + w16(mulhi16(in1, -30068) - mulhi16(in3, 20091)));
    const int16_t d = w16(w16(in1 + in3)
                          + w16(mulhi16(in1, 20091) + mulhi16(in3, -30068)));
    tmp[0][i] = w16(a + d);
    tmp[1][i] = w16(b + c);
    tmp[2][i] = w16(b - c);
    tmp[3][i] = w16(a - d);
  }
  for (int i = 0; i < 4; ++i) {  // lane i: output row i
    const int16_t t0 = tmp[i][0], t1 = tmp[i][1], t2 = tmp[i][2],
                  t3 = tmp[i][3];
    const int16_t dc = w16(t0 + 4);
    const int16_t a = w16(dc + t2), b = w16(dc - t2);
    const int16_t c = w16(w16(t1 - t3)
                          + w16(mulhi16(t1, -30068) - mulhi16(t3, 20091)));
    const int16_t d = w16(w16(t1 + t3)
                          + w16(mulhi16(t1, 20091) + mulhi16(t3, -30068)));
    const int16_t o[4] = {static_cast<int16_t>(w16(a + d) >> 3),
                          static_cast<int16_t>(w16(b + c) >> 3),
                          static_cast<int16_t>(w16(b - c) >> 3),
                          static_cast<int16_t>(w16(a - d) >> 3)};
    uint8_t* row = dst + i * kBps;
    for (int x = 0; x < 4; ++x) {
      const int16_t s = w16(row[x] + o[x]);
      row[x] = static_cast<uint8_t>(s < 0 ? 0 : s > 255 ? 255 : s);
    }
  }
}

// libwebp's TransformAC3_C: coefficients 0, 1 and 4 only, in int.
void transform_ac3(const int16_t* in, uint8_t* dst) {
  const int a = in[0] + 4;
  const int c4 = mul2(in[4]), d4 = mul1(in[4]);
  const int c1 = mul2(in[1]), d1 = mul1(in[1]);
  const int rows[4] = {a + d4, a + c4, a - c4, a - d4};
  for (int y = 0; y < 4; ++y) {
    uint8_t* row = dst + y * kBps;
    const int dc = rows[y];
    row[0] = clip_8b(row[0] + ((dc + d1) >> 3));
    row[1] = clip_8b(row[1] + ((dc + c1) >> 3));
    row[2] = clip_8b(row[2] + ((dc - c1) >> 3));
    row[3] = clip_8b(row[3] + ((dc - d1) >> 3));
  }
}

// libwebp's TransformDC_C: the DC coefficient only, in int.
void transform_dc(const int16_t* in, uint8_t* dst) {
  const int dc = (in[0] + 4) >> 3;
  for (int y = 0; y < 4; ++y)
    for (int x = 0; x < 4; ++x)
      dst[y * kBps + x] = clip_8b(dst[y * kBps + x] + dc);
}

// The inverse Walsh-Hadamard transform of the Y2 block into the DC of the
// 16 luma blocks (`out` stride 16 coefficients), stored as int16_t.
void transform_wht(const int16_t* in, int16_t* out) {
  int tmp[16];
  for (int i = 0; i < 4; ++i) {
    const int a0 = in[0 + i] + in[12 + i];
    const int a1 = in[4 + i] + in[8 + i];
    const int a2 = in[4 + i] - in[8 + i];
    const int a3 = in[0 + i] - in[12 + i];
    tmp[0 + i] = a0 + a1;
    tmp[8 + i] = a0 - a1;
    tmp[4 + i] = a3 + a2;
    tmp[12 + i] = a3 - a2;
  }
  for (int i = 0; i < 4; ++i) {
    const int dc = tmp[0 + i * 4] + 3;
    const int a0 = dc + tmp[3 + i * 4];
    const int a1 = tmp[1 + i * 4] + tmp[2 + i * 4];
    const int a2 = tmp[1 + i * 4] - tmp[2 + i * 4];
    const int a3 = dc - tmp[3 + i * 4];
    out[0] = static_cast<int16_t>((a0 + a1) >> 3);
    out[16] = static_cast<int16_t>((a3 + a2) >> 3);
    out[32] = static_cast<int16_t>((a0 - a1) >> 3);
    out[48] = static_cast<int16_t>((a3 - a2) >> 3);
    out += 64;
  }
}

// One luma block's residual by its two-bit code (libwebp's DoTransform):
// 3 full, 2 coefficients 0, 1, 4 only, 1 DC only, 0 none.
void do_transform(uint32_t bits, const int16_t* src, uint8_t* dst) {
  switch (bits >> 30) {
    case 3: transform_full(src, dst); break;
    case 2: transform_ac3(src, dst); break;
    case 1: transform_dc(src, dst); break;
    default: break;
  }
}

// One chroma plane's four blocks (libwebp's DoUVTransform).
void do_uv_transform(uint32_t bits, const int16_t* src, uint8_t* dst) {
  if (!(bits & 0xff)) return;
  const int offsets[4] = {0, 4, 4 * kBps, 4 * kBps + 4};
  for (int k = 0; k < 4; ++k) {
    if (bits & 0xaa)
      transform_full(src + 16 * k, dst + offsets[k]);
    else if (src[16 * k])
      transform_dc(src + 16 * k, dst + offsets[k]);
  }
}

// ------------------------------------------------ VP8 intra prediction

inline uint8_t avg3(int a, int b, int c) {
  return static_cast<uint8_t>((a + 2 * b + c + 2) >> 2);
}
inline uint8_t avg2(int a, int b) {
  return static_cast<uint8_t>((a + b + 1) >> 1);
}

void true_motion(uint8_t* dst, int size) {
  const uint8_t* top = dst - kBps;
  const int tl = top[-1];
  for (int y = 0; y < size; ++y) {
    const int left = dst[-1];
    for (int x = 0; x < size; ++x) dst[x] = clip8(top[x] + left - tl);
    dst += kBps;
  }
}

void fill(uint8_t* dst, int size, int v) {
  for (int y = 0; y < size; ++y) std::memset(dst + y * kBps, v, size);
}

// 16x16 luma (size 16) and 8x8 chroma (size 8) by mode, the DC mode
// already narrowed to the borders that exist (libwebp's CheckMode).
void predict_block(uint8_t* dst, int size, int mode) {
  const int log2 = size == 16 ? 4 : 3;
  switch (mode) {
    case DC_PRED: {
      int dc = size;
      for (int j = 0; j < size; ++j) dc += dst[j - kBps] + dst[-1 + j * kBps];
      fill(dst, size, dc >> (log2 + 1));
      break;
    }
    case B_DC_PRED_NOTOP: {
      int dc = size >> 1;
      for (int j = 0; j < size; ++j) dc += dst[-1 + j * kBps];
      fill(dst, size, dc >> log2);
      break;
    }
    case B_DC_PRED_NOLEFT: {
      int dc = size >> 1;
      for (int j = 0; j < size; ++j) dc += dst[j - kBps];
      fill(dst, size, dc >> log2);
      break;
    }
    case B_DC_PRED_NOTOPLEFT:
      fill(dst, size, 0x80);
      break;
    case TM_PRED:
      true_motion(dst, size);
      break;
    case V_PRED:
      for (int j = 0; j < size; ++j)
        std::memcpy(dst + j * kBps, dst - kBps, size);
      break;
    case H_PRED:
      for (int j = 0; j < size; ++j)
        std::memset(dst + j * kBps, dst[j * kBps - 1], size);
      break;
    default:
      fail(kVp8Data);
  }
}

#define DST(x, y) dst[(x) + (y) * kBps]

// The ten 4x4 luma modes of RFC 6386 section 12.3, as libwebp's dec.c.
void predict4(uint8_t* dst, int mode) {
  const uint8_t* top = dst - kBps;
  switch (mode) {
    case B_DC_PRED: {
      int dc = 4;
      for (int i = 0; i < 4; ++i) dc += top[i] + dst[-1 + i * kBps];
      fill(dst, 4, dc >> 3);
      break;
    }
    case B_TM_PRED:
      true_motion(dst, 4);
      break;
    case B_VE_PRED: {
      const uint8_t vals[4] = {avg3(top[-1], top[0], top[1]),
                               avg3(top[0], top[1], top[2]),
                               avg3(top[1], top[2], top[3]),
                               avg3(top[2], top[3], top[4])};
      for (int i = 0; i < 4; ++i) std::memcpy(dst + i * kBps, vals, 4);
      break;
    }
    case B_HE_PRED: {
      const int A = dst[-1 - kBps], B = dst[-1], C = dst[-1 + kBps],
                D = dst[-1 + 2 * kBps], E = dst[-1 + 3 * kBps];
      std::memset(dst, avg3(A, B, C), 4);
      std::memset(dst + kBps, avg3(B, C, D), 4);
      std::memset(dst + 2 * kBps, avg3(C, D, E), 4);
      std::memset(dst + 3 * kBps, avg3(D, E, E), 4);
      break;
    }
    case B_RD_PRED: {
      const int I = dst[-1], J = dst[-1 + kBps], K = dst[-1 + 2 * kBps],
                L = dst[-1 + 3 * kBps], X = top[-1], A = top[0], B = top[1],
                C = top[2], D = top[3];
      DST(0, 3) = avg3(J, K, L);
      DST(1, 3) = DST(0, 2) = avg3(I, J, K);
      DST(2, 3) = DST(1, 2) = DST(0, 1) = avg3(X, I, J);
      DST(3, 3) = DST(2, 2) = DST(1, 1) = DST(0, 0) = avg3(A, X, I);
      DST(3, 2) = DST(2, 1) = DST(1, 0) = avg3(B, A, X);
      DST(3, 1) = DST(2, 0) = avg3(C, B, A);
      DST(3, 0) = avg3(D, C, B);
      break;
    }
    case B_LD_PRED: {
      const int A = top[0], B = top[1], C = top[2], D = top[3], E = top[4],
                F = top[5], G = top[6], H = top[7];
      DST(0, 0) = avg3(A, B, C);
      DST(1, 0) = DST(0, 1) = avg3(B, C, D);
      DST(2, 0) = DST(1, 1) = DST(0, 2) = avg3(C, D, E);
      DST(3, 0) = DST(2, 1) = DST(1, 2) = DST(0, 3) = avg3(D, E, F);
      DST(3, 1) = DST(2, 2) = DST(1, 3) = avg3(E, F, G);
      DST(3, 2) = DST(2, 3) = avg3(F, G, H);
      DST(3, 3) = avg3(G, H, H);
      break;
    }
    case B_VR_PRED: {
      const int I = dst[-1], J = dst[-1 + kBps], K = dst[-1 + 2 * kBps],
                X = top[-1], A = top[0], B = top[1], C = top[2], D = top[3];
      DST(0, 0) = DST(1, 2) = avg2(X, A);
      DST(1, 0) = DST(2, 2) = avg2(A, B);
      DST(2, 0) = DST(3, 2) = avg2(B, C);
      DST(3, 0) = avg2(C, D);
      DST(0, 3) = avg3(K, J, I);
      DST(0, 2) = avg3(J, I, X);
      DST(0, 1) = DST(1, 3) = avg3(I, X, A);
      DST(1, 1) = DST(2, 3) = avg3(X, A, B);
      DST(2, 1) = DST(3, 3) = avg3(A, B, C);
      DST(3, 1) = avg3(B, C, D);
      break;
    }
    case B_VL_PRED: {
      const int A = top[0], B = top[1], C = top[2], D = top[3], E = top[4],
                F = top[5], G = top[6], H = top[7];
      DST(0, 0) = avg2(A, B);
      DST(1, 0) = DST(0, 2) = avg2(B, C);
      DST(2, 0) = DST(1, 2) = avg2(C, D);
      DST(3, 0) = DST(2, 2) = avg2(D, E);
      DST(0, 1) = avg3(A, B, C);
      DST(1, 1) = DST(0, 3) = avg3(B, C, D);
      DST(2, 1) = DST(1, 3) = avg3(C, D, E);
      DST(3, 1) = DST(2, 3) = avg3(D, E, F);
      DST(3, 2) = avg3(E, F, G);
      DST(3, 3) = avg3(F, G, H);
      break;
    }
    case B_HU_PRED: {
      const int I = dst[-1], J = dst[-1 + kBps], K = dst[-1 + 2 * kBps],
                L = dst[-1 + 3 * kBps];
      DST(0, 0) = avg2(I, J);
      DST(2, 0) = DST(0, 1) = avg2(J, K);
      DST(2, 1) = DST(0, 2) = avg2(K, L);
      DST(1, 0) = avg3(I, J, K);
      DST(3, 0) = DST(1, 1) = avg3(J, K, L);
      DST(3, 1) = DST(1, 2) = avg3(K, L, L);
      DST(3, 2) = DST(2, 2) = DST(0, 3) = DST(1, 3) = DST(2, 3) =
          DST(3, 3) = static_cast<uint8_t>(L);
      break;
    }
    case B_HD_PRED: {
      const int I = dst[-1], J = dst[-1 + kBps], K = dst[-1 + 2 * kBps],
                L = dst[-1 + 3 * kBps], X = top[-1], A = top[0], B = top[1],
                C = top[2];
      DST(0, 0) = DST(2, 1) = avg2(I, X);
      DST(0, 1) = DST(2, 2) = avg2(J, I);
      DST(0, 2) = DST(2, 3) = avg2(K, J);
      DST(0, 3) = avg2(L, K);
      DST(3, 0) = avg3(A, B, C);
      DST(2, 0) = avg3(X, A, B);
      DST(1, 0) = DST(3, 1) = avg3(I, X, A);
      DST(1, 1) = DST(3, 2) = avg3(J, I, X);
      DST(1, 2) = DST(3, 3) = avg3(K, J, I);
      DST(1, 3) = avg3(L, K, J);
      break;
    }
    default:
      fail(kVp8Data);
  }
}

#undef DST

// ---------------------------------------------------- VP8 loop filters

inline int sclip1(int v) { return v < -128 ? -128 : v > 127 ? 127 : v; }
inline int sclip2(int v) { return v < -16 ? -16 : v > 15 ? 15 : v; }

// 4 pixels in, 2 out
inline void do_filter2(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0) + sclip1(p1 - q1);
  const int a1 = sclip2((a + 4) >> 3);
  const int a2 = sclip2((a + 3) >> 3);
  p[-step] = clip8(p0 + a2);
  p[0] = clip8(q0 - a1);
}

// 4 pixels in, 4 out
inline void do_filter4(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0);
  const int a1 = sclip2((a + 4) >> 3);
  const int a2 = sclip2((a + 3) >> 3);
  const int a3 = (a1 + 1) >> 1;
  p[-2 * step] = clip8(p1 + a3);
  p[-step] = clip8(p0 + a2);
  p[0] = clip8(q0 - a1);
  p[step] = clip8(q1 - a3);
}

// 6 pixels in, 6 out
inline void do_filter6(uint8_t* p, int step) {
  const int p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  const int q0 = p[0], q1 = p[step], q2 = p[2 * step];
  const int a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
  const int a1 = (27 * a + 63) >> 7;
  const int a2 = (18 * a + 63) >> 7;
  const int a3 = (9 * a + 63) >> 7;
  p[-3 * step] = clip8(p2 + a3);
  p[-2 * step] = clip8(p1 + a2);
  p[-step] = clip8(p0 + a1);
  p[0] = clip8(q0 - a1);
  p[step] = clip8(q1 - a2);
  p[2 * step] = clip8(q2 - a3);
}

inline bool hev(const uint8_t* p, int step, int thresh) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return std::abs(p1 - p0) > thresh || std::abs(q1 - q0) > thresh;
}

inline bool needs_filter(const uint8_t* p, int step, int t) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return 4 * std::abs(p0 - q0) + std::abs(p1 - q1) <= t;
}

inline bool needs_filter2(const uint8_t* p, int step, int t, int it) {
  const int p3 = p[-4 * step], p2 = p[-3 * step], p1 = p[-2 * step];
  const int p0 = p[-step], q0 = p[0];
  const int q1 = p[step], q2 = p[2 * step], q3 = p[3 * step];
  if (4 * std::abs(p0 - q0) + std::abs(p1 - q1) > t) return false;
  return std::abs(p3 - p2) <= it && std::abs(p2 - p1) <= it
         && std::abs(p1 - p0) <= it && std::abs(q3 - q2) <= it
         && std::abs(q2 - q1) <= it && std::abs(q1 - q0) <= it;
}

// The simple filter across one edge of 16 pixels (RFC 6386 section 15.2).
void simple_filter16(uint8_t* p, int hstride, int vstride, int thresh) {
  const int thresh2 = 2 * thresh + 1;
  for (int i = 0; i < 16; ++i, p += vstride)
    if (needs_filter(p, hstride, thresh2)) do_filter2(p, hstride);
}

// The normal filter across one edge of `size` pixels (section 15.3):
// macroblock edges (`inner` false) filter 6 pixels, inner edges 4.
void filter_loop(uint8_t* p, int hstride, int vstride, int size, int thresh,
                 int ithresh, int hev_thresh, bool inner) {
  const int thresh2 = 2 * thresh + 1;
  for (; size-- > 0; p += vstride) {
    if (!needs_filter2(p, hstride, thresh2, ithresh)) continue;
    if (hev(p, hstride, hev_thresh))
      do_filter2(p, hstride);
    else if (inner)
      do_filter4(p, hstride);
    else
      do_filter6(p, hstride);
  }
}

// ----------------------------------------------------------- VP8 frame

// The work buffer of one macroblock with its borders (libwebp's yuv_b_):
// luma at row 1, column 8 (left column 7, top row 0, top-right columns
// 24-27), the chroma planes below it side by side.
constexpr int kYOff = kBps * 1 + 8;
constexpr int kUOff = kYOff + kBps * 16 + kBps;
constexpr int kVOff = kUOff + 16;
constexpr int kYuvSize = kBps * 17 + kBps * 9;

struct FilterInfo {
  int limit = 0;       // 2 * level + ilevel, 0: no filtering
  int ilevel = 0;
  int hev_thresh = 0;
  bool inner = false;
};

struct MacroBlock {
  int16_t coeffs[384];
  uint8_t imodes[16];  // 4x4 modes, or the 16x16 mode in imodes[0]
  bool is_i4x4;
  uint8_t uvmode;
  uint8_t segment;
  bool skip;
  uint32_t non_zero_y, non_zero_uv;
};

class Vp8Decoder {
 public:
  // `data`: the VP8 chunk's payload and every byte after it in the file,
  // as libwebp's WebPDecode hands them to its VP8 decoder.
  Vp8Decoder(const uint8_t* data, size_t size) : data_(data), size_(size) {}

  void read_headers();
  void decode();  // every macroblock row into the planes, filtered

  int width = 0, height = 0, mb_w = 0, mb_h = 0;
  std::vector<uint8_t> y, u, v;  // (16 mb_h, 16 mb_w), (8 mb_h, 8 mb_w)

 private:
  void parse_segment_header();
  void parse_filter_header();
  void parse_partitions(const uint8_t* buf, size_t size);
  void parse_quant();
  void parse_proba();
  void parse_intra_mode(int mb_x);
  int get_coeffs(BoolReader& br, int type, int ctx, const int dq[2], int n,
                 int16_t* out);
  int get_large_value(BoolReader& br, const uint8_t* p);
  bool parse_residuals(int mb_x, BoolReader& br);
  void reconstruct_row(int mb_y);
  void filter_row(int mb_y);
  void precompute_filter_strengths();

  const uint8_t* data_;
  size_t size_;
  BoolReader br_;
  BoolReader parts_[8];
  int num_parts_minus_one_ = 0;

  // segment header
  bool use_segment_ = false, update_map_ = false, absolute_delta_ = true;
  int8_t quantizer_[4] = {0, 0, 0, 0}, filter_strength_[4] = {0, 0, 0, 0};
  uint8_t segment_proba_[3] = {255, 255, 255};
  // filter header
  bool simple_ = false, use_lf_delta_ = false;
  int level_ = 0, sharpness_ = 0;
  int ref_lf_delta_[4] = {0, 0, 0, 0}, mode_lf_delta_[4] = {0, 0, 0, 0};
  int filter_type_ = 0;  // 0 off, 1 simple, 2 normal
  FilterInfo fstrengths_[4][2];
  // quantisers: y1 (dc, ac), y2, uv per segment
  int y1_mat_[4][2], y2_mat_[4][2], uv_mat_[4][2];
  // probabilities
  uint8_t proba_[4][8][3][11];
  bool use_skip_proba_ = false;
  int skip_p_ = 0;

  // per-row state
  std::vector<MacroBlock> mbs_;        // the row's macroblocks
  std::vector<FilterInfo> finfo_;      // the row's filter parameters
  std::vector<uint8_t> intra_t_;       // 4 modes a column, above
  uint8_t intra_l_[4];                 // 4 modes, left
  std::vector<uint8_t> nz_t_, nz_dc_t_;  // non-zero context above
  uint8_t nz_l_ = 0, nz_dc_l_ = 0;     // and left
  std::vector<uint8_t> top_y_, top_u_, top_v_;  // unfiltered bottom rows
  uint8_t yuv_b_[kYuvSize];
};

void Vp8Decoder::read_headers() {
  const uint8_t* buf = data_;
  size_t buf_size = size_;
  // frame tag, start code and size (RFC 6386 sections 9.1, 9.2), checked
  // as libwebp's VP8GetInfo and VP8GetHeaders check them
  if (buf_size < 10) fail(kVp8Truncated);
  const uint32_t bits = buf[0] | (buf[1] << 8) | (buf[2] << 16);
  const bool key_frame = !(bits & 1);
  const int profile = (bits >> 1) & 7;
  const bool show = (bits >> 4) & 1;
  const uint32_t partition_length = bits >> 5;
  if (!key_frame) fail(kNotKeyFrame);
  if (profile > 3 || !show) fail(kBadVp8Header);
  if (buf[3] != 0x9d || buf[4] != 0x01 || buf[5] != 0x2a)
    fail(kBadVp8Header);
  width = ((buf[7] << 8) | buf[6]) & 0x3fff;
  height = ((buf[9] << 8) | buf[8]) & 0x3fff;
  if (width == 0 || height == 0) fail(kBadVp8Header);
  buf += 10;
  buf_size -= 10;
  mb_w = (width + 15) >> 4;
  mb_h = (height + 15) >> 4;
  if (partition_length > buf_size) fail(kVp8Truncated);
  br_.init(buf, partition_length);
  buf += partition_length;
  buf_size -= partition_length;
  br_.bit(0x80);  // colour space
  br_.bit(0x80);  // clamping type
  parse_segment_header();
  if (br_.eof()) fail(kVp8Header);
  parse_filter_header();
  if (br_.eof()) fail(kVp8Header);
  parse_partitions(buf, buf_size);
  parse_quant();
  br_.bit(0x80);  // refresh entropy probs: ignored on a key frame
  parse_proba();
}

void Vp8Decoder::parse_segment_header() {
  use_segment_ = br_.bit(0x80);
  if (use_segment_) {
    update_map_ = br_.bit(0x80);
    if (br_.bit(0x80)) {  // update data
      absolute_delta_ = br_.bit(0x80);
      for (int s = 0; s < 4; ++s)
        quantizer_[s] = static_cast<int8_t>(
            br_.bit(0x80) ? br_.signed_value(7) : 0);
      for (int s = 0; s < 4; ++s)
        filter_strength_[s] = static_cast<int8_t>(
            br_.bit(0x80) ? br_.signed_value(6) : 0);
    }
    if (update_map_)
      for (int s = 0; s < 3; ++s)
        segment_proba_[s] = static_cast<uint8_t>(
            br_.bit(0x80) ? br_.value(8) : 255u);
  } else {
    update_map_ = false;
  }
}

void Vp8Decoder::parse_filter_header() {
  simple_ = br_.bit(0x80);
  level_ = static_cast<int>(br_.value(6));
  sharpness_ = static_cast<int>(br_.value(3));
  use_lf_delta_ = br_.bit(0x80);
  if (use_lf_delta_ && br_.bit(0x80)) {
    for (int i = 0; i < 4; ++i)
      if (br_.bit(0x80)) ref_lf_delta_[i] = br_.signed_value(6);
    for (int i = 0; i < 4; ++i)
      if (br_.bit(0x80)) mode_lf_delta_[i] = br_.signed_value(6);
  }
  filter_type_ = level_ == 0 ? 0 : simple_ ? 1 : 2;
}

void Vp8Decoder::parse_partitions(const uint8_t* buf, size_t size) {
  num_parts_minus_one_ = (1 << br_.value(2)) - 1;
  const size_t last_part = static_cast<size_t>(num_parts_minus_one_);
  if (size < 3 * last_part) fail(kVp8Partitions);
  const uint8_t* sz = buf;
  const uint8_t* part_start = buf + last_part * 3;
  size_t size_left = size - last_part * 3;
  for (size_t p = 0; p < last_part; ++p) {
    size_t psize = sz[0] | (sz[1] << 8) | (sz[2] << 16);
    if (psize > size_left) psize = size_left;
    parts_[p].init(part_start, psize);
    part_start += psize;
    size_left -= psize;
    sz += 3;
  }
  parts_[last_part].init(part_start, size_left);
  if (part_start >= buf + size) fail(kVp8Partitions);  // no last partition
}

void Vp8Decoder::parse_quant() {
  const int base_q0 = static_cast<int>(br_.value(7));
  const int dqy1_dc = br_.bit(0x80) ? br_.signed_value(4) : 0;
  const int dqy2_dc = br_.bit(0x80) ? br_.signed_value(4) : 0;
  const int dqy2_ac = br_.bit(0x80) ? br_.signed_value(4) : 0;
  const int dquv_dc = br_.bit(0x80) ? br_.signed_value(4) : 0;
  const int dquv_ac = br_.bit(0x80) ? br_.signed_value(4) : 0;
  auto clip = [](int v, int m) { return v < 0 ? 0 : v > m ? m : v; };
  for (int i = 0; i < 4; ++i) {
    int q;
    if (use_segment_) {
      q = quantizer_[i];
      if (!absolute_delta_) q += base_q0;
    } else if (i > 0) {
      for (int k = 0; k < 2; ++k) {
        y1_mat_[i][k] = y1_mat_[0][k];
        y2_mat_[i][k] = y2_mat_[0][k];
        uv_mat_[i][k] = uv_mat_[0][k];
      }
      continue;
    } else {
      q = base_q0;
    }
    y1_mat_[i][0] = kDcTable[clip(q + dqy1_dc, 127)];
    y1_mat_[i][1] = kAcTable[clip(q, 127)];
    y2_mat_[i][0] = kDcTable[clip(q + dqy2_dc, 127)] * 2;
    // x * 155 / 100 as (x * 101581) >> 16, at least 8
    y2_mat_[i][1] = (kAcTable[clip(q + dqy2_ac, 127)] * 101581) >> 16;
    if (y2_mat_[i][1] < 8) y2_mat_[i][1] = 8;
    uv_mat_[i][0] = kDcTable[clip(q + dquv_dc, 117)];
    uv_mat_[i][1] = kAcTable[clip(q + dquv_ac, 127)];
  }
}

void Vp8Decoder::parse_proba() {
  for (int t = 0; t < 4; ++t)
    for (int b = 0; b < 8; ++b)
      for (int c = 0; c < 3; ++c)
        for (int p = 0; p < 11; ++p) {
          const int k = ((t * 8 + b) * 3 + c) * 11 + p;
          proba_[t][b][c][p] = static_cast<uint8_t>(
              br_.bit(kCoeffsUpdateProba[k]) ? br_.value(8)
                                             : kCoeffsProba0[k]);
        }
  use_skip_proba_ = br_.bit(0x80);
  if (use_skip_proba_) skip_p_ = static_cast<int>(br_.value(8));
}

void Vp8Decoder::parse_intra_mode(int mb_x) {
  uint8_t* const top = intra_t_.data() + 4 * mb_x;
  uint8_t* const left = intra_l_;
  MacroBlock& block = mbs_[mb_x];
  if (update_map_) {
    block.segment = static_cast<uint8_t>(
        !br_.bit(segment_proba_[0]) ? br_.bit(segment_proba_[1])
                                    : br_.bit(segment_proba_[2]) + 2);
  } else {
    block.segment = 0;
  }
  block.skip = use_skip_proba_ ? br_.bit(skip_p_) : false;
  block.is_i4x4 = !br_.bit(145);
  if (!block.is_i4x4) {
    const int ymode = br_.bit(156) ? (br_.bit(128) ? TM_PRED : H_PRED)
                                   : (br_.bit(163) ? V_PRED : DC_PRED);
    block.imodes[0] = static_cast<uint8_t>(ymode);
    std::memset(top, ymode, 4);
    std::memset(left, ymode, 4);
  } else {
    uint8_t* modes = block.imodes;
    for (int yy = 0; yy < 4; ++yy) {
      int ymode = left[yy];
      for (int x = 0; x < 4; ++x) {
        const uint8_t* prob = kBModesProba + (top[x] * kNumBModes + ymode) * 9;
        int i = kYModesIntra4[br_.bit(prob[0])];
        while (i > 0) i = kYModesIntra4[2 * i + br_.bit(prob[i])];
        ymode = -i;
        top[x] = static_cast<uint8_t>(ymode);
      }
      std::memcpy(modes, top, 4);
      modes += 4;
      left[yy] = static_cast<uint8_t>(ymode);
    }
  }
  block.uvmode = static_cast<uint8_t>(
      !br_.bit(142) ? DC_PRED
                    : !br_.bit(114) ? V_PRED
                                    : br_.bit(183) ? TM_PRED : H_PRED);
}

int Vp8Decoder::get_large_value(BoolReader& br, const uint8_t* p) {
  int v;
  if (!br.bit(p[3])) {
    v = !br.bit(p[4]) ? 2 : 3 + br.bit(p[5]);
  } else if (!br.bit(p[6])) {
    if (!br.bit(p[7])) {
      v = 5 + br.bit(159);
    } else {
      v = 7 + 2 * br.bit(165);
      v += br.bit(145);
    }
  } else {
    const int bit1 = br.bit(p[8]);
    const int bit0 = br.bit(p[9 + bit1]);
    const int cat = 2 * bit1 + bit0;
    v = 0;
    for (const uint8_t* tab = kCat3456[cat]; *tab; ++tab) v += v + br.bit(*tab);
    v += 3 + (8 << cat);
  }
  return v;
}

// The coefficients of one block from position n (RFC 6386 section 13),
// dequantised into `out` (natural order) as int16_t; returns the position
// after the last non-zero one, as libwebp's GetCoeffs.
int Vp8Decoder::get_coeffs(BoolReader& br, int type, int ctx,
                           const int dq[2], int n, int16_t* out) {
  const uint8_t* p = proba_[type][kBands[n]][ctx];
  for (; n < 16; ++n) {
    if (!br.bit(p[0])) return n;
    while (!br.bit(p[1])) {
      p = proba_[type][kBands[++n]][0];
      if (n == 16) return 16;
    }
    int v;
    if (!br.bit(p[2])) {
      v = 1;
      p = proba_[type][kBands[n + 1]][1];
    } else {
      v = get_large_value(br, p);
      p = proba_[type][kBands[n + 1]][2];
    }
    const int sv = br.bit(0x80) ? -v : v;
    out[kZigzag[n]] = static_cast<int16_t>(sv * dq[n > 0]);
  }
  return 16;
}

inline uint32_t nz_code_bits(uint32_t nz_coeffs, int nz, int dc_nz) {
  nz_coeffs <<= 2;
  nz_coeffs |= (nz > 3) ? 3 : (nz > 1) ? 2 : dc_nz;
  return nz_coeffs;
}

// libwebp's ParseResiduals; returns whether the macroblock has no
// non-zero coefficient at all.
bool Vp8Decoder::parse_residuals(int mb_x, BoolReader& br) {
  MacroBlock& block = mbs_[mb_x];
  const int seg = block.segment;
  int16_t* dst = block.coeffs;
  std::memset(dst, 0, sizeof(block.coeffs));
  uint8_t& mb_nz = nz_t_[mb_x];
  uint8_t& mb_nz_dc = nz_dc_t_[mb_x];
  uint32_t non_zero_y = 0, non_zero_uv = 0;
  int first, ac_type;
  if (!block.is_i4x4) {  // the Y2 block
    int16_t dc[16] = {0};
    const int ctx = mb_nz_dc + nz_dc_l_;
    const int nz = get_coeffs(br, 1, ctx, y2_mat_[seg], 0, dc);
    mb_nz_dc = nz_dc_l_ = nz > 0;
    if (nz > 1) {
      transform_wht(dc, dst);
    } else {
      const int dc0 = (dc[0] + 3) >> 3;
      for (int i = 0; i < 16 * 16; i += 16) dst[i] = static_cast<int16_t>(dc0);
    }
    first = 1;
    ac_type = 0;
  } else {
    first = 0;
    ac_type = 3;
  }
  uint8_t tnz = mb_nz & 0x0f;
  uint8_t lnz = nz_l_ & 0x0f;
  for (int yy = 0; yy < 4; ++yy) {
    int l = lnz & 1;
    uint32_t nz_coeffs = 0;
    for (int x = 0; x < 4; ++x) {
      const int ctx = l + (tnz & 1);
      const int nz = get_coeffs(br, ac_type, ctx, y1_mat_[seg], first, dst);
      l = nz > first;
      tnz = static_cast<uint8_t>((tnz >> 1) | (l << 7));
      nz_coeffs = nz_code_bits(nz_coeffs, nz, dst[0] != 0);
      dst += 16;
    }
    tnz >>= 4;
    lnz = static_cast<uint8_t>((lnz >> 1) | (l << 7));
    non_zero_y = (non_zero_y << 8) | nz_coeffs;
  }
  uint32_t out_t_nz = tnz;
  uint32_t out_l_nz = lnz >> 4;
  for (int ch = 0; ch < 4; ch += 2) {
    uint32_t nz_coeffs = 0;
    tnz = static_cast<uint8_t>(mb_nz >> (4 + ch));
    lnz = static_cast<uint8_t>(nz_l_ >> (4 + ch));
    for (int yy = 0; yy < 2; ++yy) {
      int l = lnz & 1;
      for (int x = 0; x < 2; ++x) {
        const int ctx = l + (tnz & 1);
        const int nz = get_coeffs(br, 2, ctx, uv_mat_[seg], 0, dst);
        l = nz > 0;
        tnz = static_cast<uint8_t>((tnz >> 1) | (l << 3));
        nz_coeffs = nz_code_bits(nz_coeffs, nz, dst[0] != 0);
        dst += 16;
      }
      tnz >>= 2;
      lnz = static_cast<uint8_t>((lnz >> 1) | (l << 5));
    }
    non_zero_uv |= nz_coeffs << (4 * ch);
    out_t_nz |= (static_cast<uint32_t>(tnz) << 4) << ch;
    out_l_nz |= (lnz & 0xf0u) << ch;
  }
  mb_nz = static_cast<uint8_t>(out_t_nz);
  nz_l_ = static_cast<uint8_t>(out_l_nz);
  block.non_zero_y = non_zero_y;
  block.non_zero_uv = non_zero_uv;
  return !(non_zero_y | non_zero_uv);
}

void Vp8Decoder::precompute_filter_strengths() {
  if (filter_type_ == 0) return;
  for (int s = 0; s < 4; ++s) {
    int base_level;
    if (use_segment_) {
      base_level = filter_strength_[s];
      if (!absolute_delta_) base_level += level_;
    } else {
      base_level = level_;
    }
    for (int i4x4 = 0; i4x4 <= 1; ++i4x4) {
      FilterInfo& info = fstrengths_[s][i4x4];
      int level = base_level;
      if (use_lf_delta_) {
        level += ref_lf_delta_[0];
        if (i4x4) level += mode_lf_delta_[0];
      }
      level = level < 0 ? 0 : level > 63 ? 63 : level;
      if (level > 0) {
        int ilevel = level;
        if (sharpness_ > 0) {
          ilevel >>= sharpness_ > 4 ? 2 : 1;
          if (ilevel > 9 - sharpness_) ilevel = 9 - sharpness_;
        }
        if (ilevel < 1) ilevel = 1;
        info.ilevel = ilevel;
        info.limit = 2 * level + ilevel;
        info.hev_thresh = level >= 40 ? 2 : level >= 15 ? 1 : 0;
      } else {
        info.limit = 0;
      }
      info.inner = i4x4 != 0;
    }
  }
}

// libwebp's ReconstructRow: predict and add the residuals of each
// macroblock of row mb_y in the work buffer, whose borders carry the
// unfiltered neighbours (127 above the first row, 129 left of the first
// column), and copy it into the planes.
void Vp8Decoder::reconstruct_row(int mb_y) {
  uint8_t* const y_dst = yuv_b_ + kYOff;
  uint8_t* const u_dst = yuv_b_ + kUOff;
  uint8_t* const v_dst = yuv_b_ + kVOff;
  const int ys = 16 * mb_w, uvs = 8 * mb_w;
  for (int j = 0; j < 16; ++j) y_dst[j * kBps - 1] = 129;
  for (int j = 0; j < 8; ++j) {
    u_dst[j * kBps - 1] = 129;
    v_dst[j * kBps - 1] = 129;
  }
  if (mb_y > 0) {
    y_dst[-1 - kBps] = u_dst[-1 - kBps] = v_dst[-1 - kBps] = 129;
  } else {
    std::memset(y_dst - kBps - 1, 127, 16 + 4 + 1);
    std::memset(u_dst - kBps - 1, 127, 8 + 1);
    std::memset(v_dst - kBps - 1, 127, 8 + 1);
  }
  for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
    const MacroBlock& block = mbs_[mb_x];
    if (mb_x > 0) {  // the left samples: the previous block's last columns
      for (int j = -1; j < 16; ++j)
        std::memcpy(y_dst + j * kBps - 4, y_dst + j * kBps + 12, 4);
      for (int j = -1; j < 8; ++j) {
        std::memcpy(u_dst + j * kBps - 4, u_dst + j * kBps + 4, 4);
        std::memcpy(v_dst + j * kBps - 4, v_dst + j * kBps + 4, 4);
      }
    }
    uint8_t* const ty = top_y_.data() + 16 * mb_x;
    uint8_t* const tu = top_u_.data() + 8 * mb_x;
    uint8_t* const tv = top_v_.data() + 8 * mb_x;
    if (mb_y > 0) {
      std::memcpy(y_dst - kBps, ty, 16);
      std::memcpy(u_dst - kBps, tu, 8);
      std::memcpy(v_dst - kBps, tv, 8);
    }
    const int16_t* coeffs = block.coeffs;
    uint32_t bits = block.non_zero_y;
    if (block.is_i4x4) {
      uint8_t* const top_right = y_dst - kBps + 16;
      if (mb_y > 0) {
        if (mb_x >= mb_w - 1)
          std::memset(top_right, ty[15], 4);
        else
          std::memcpy(top_right, ty + 16, 4);
      }
      // the top-right pixels repeated down the right edge
      for (int k = 1; k <= 3; ++k)
        std::memcpy(top_right + 4 * k * kBps, top_right, 4);
      for (int n = 0; n < 16; ++n, bits <<= 2) {
        uint8_t* const dst = y_dst + (n & 3) * 4 + (n >> 2) * 4 * kBps;
        predict4(dst, block.imodes[n]);
        do_transform(bits, coeffs + n * 16, dst);
      }
    } else {
      int mode = block.imodes[0];
      if (mode == B_DC_PRED)
        mode = mb_x == 0 ? (mb_y == 0 ? B_DC_PRED_NOTOPLEFT : B_DC_PRED_NOLEFT)
                         : (mb_y == 0 ? B_DC_PRED_NOTOP : B_DC_PRED);
      predict_block(y_dst, 16, mode);
      if (bits != 0)
        for (int n = 0; n < 16; ++n, bits <<= 2)
          do_transform(bits, coeffs + n * 16,
                       y_dst + (n & 3) * 4 + (n >> 2) * 4 * kBps);
    }
    int uvmode = block.uvmode;
    if (uvmode == B_DC_PRED)
      uvmode = mb_x == 0 ? (mb_y == 0 ? B_DC_PRED_NOTOPLEFT : B_DC_PRED_NOLEFT)
                         : (mb_y == 0 ? B_DC_PRED_NOTOP : B_DC_PRED);
    predict_block(u_dst, 8, uvmode);
    predict_block(v_dst, 8, uvmode);
    do_uv_transform(block.non_zero_uv >> 0, coeffs + 16 * 16, u_dst);
    do_uv_transform(block.non_zero_uv >> 8, coeffs + 20 * 16, v_dst);
    if (mb_y < mb_h - 1) {  // unfiltered bottom rows for the next row
      std::memcpy(ty, y_dst + 15 * kBps, 16);
      std::memcpy(tu, u_dst + 7 * kBps, 8);
      std::memcpy(tv, v_dst + 7 * kBps, 8);
    }
    uint8_t* const yo = y.data() + static_cast<size_t>(mb_y) * 16 * ys
                        + mb_x * 16;
    uint8_t* const uo = u.data() + static_cast<size_t>(mb_y) * 8 * uvs
                        + mb_x * 8;
    uint8_t* const vo = v.data() + static_cast<size_t>(mb_y) * 8 * uvs
                        + mb_x * 8;
    for (int j = 0; j < 16; ++j)
      std::memcpy(yo + j * ys, y_dst + j * kBps, 16);
    for (int j = 0; j < 8; ++j) {
      std::memcpy(uo + j * uvs, u_dst + j * kBps, 8);
      std::memcpy(vo + j * uvs, v_dst + j * kBps, 8);
    }
  }
}

// libwebp's DoFilter over row mb_y, in the planes: each macroblock's left
// edge, inner vertical edges, top edge, inner horizontal edges.
void Vp8Decoder::filter_row(int mb_y) {
  const int ys = 16 * mb_w, uvs = 8 * mb_w;
  for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
    const FilterInfo& f = finfo_[mb_x];
    const int limit = f.limit;
    if (limit == 0) continue;
    uint8_t* const yd = y.data() + static_cast<size_t>(mb_y) * 16 * ys
                        + mb_x * 16;
    if (filter_type_ == 1) {
      if (mb_x > 0) simple_filter16(yd, 1, ys, limit + 4);
      if (f.inner)
        for (int k = 1; k <= 3; ++k) simple_filter16(yd + 4 * k, 1, ys, limit);
      if (mb_y > 0) simple_filter16(yd, ys, 1, limit + 4);
      if (f.inner)
        for (int k = 1; k <= 3; ++k)
          simple_filter16(yd + 4 * k * ys, ys, 1, limit);
      continue;
    }
    uint8_t* const ud = u.data() + static_cast<size_t>(mb_y) * 8 * uvs
                        + mb_x * 8;
    uint8_t* const vd = v.data() + static_cast<size_t>(mb_y) * 8 * uvs
                        + mb_x * 8;
    const int il = f.ilevel, hev_t = f.hev_thresh;
    if (mb_x > 0) {
      filter_loop(yd, 1, ys, 16, limit + 4, il, hev_t, false);
      filter_loop(ud, 1, uvs, 8, limit + 4, il, hev_t, false);
      filter_loop(vd, 1, uvs, 8, limit + 4, il, hev_t, false);
    }
    if (f.inner) {
      for (int k = 1; k <= 3; ++k)
        filter_loop(yd + 4 * k, 1, ys, 16, limit, il, hev_t, true);
      filter_loop(ud + 4, 1, uvs, 8, limit, il, hev_t, true);
      filter_loop(vd + 4, 1, uvs, 8, limit, il, hev_t, true);
    }
    if (mb_y > 0) {
      filter_loop(yd, ys, 1, 16, limit + 4, il, hev_t, false);
      filter_loop(ud, uvs, 1, 8, limit + 4, il, hev_t, false);
      filter_loop(vd, uvs, 1, 8, limit + 4, il, hev_t, false);
    }
    if (f.inner) {
      for (int k = 1; k <= 3; ++k)
        filter_loop(yd + 4 * k * ys, ys, 1, 16, limit, il, hev_t, true);
      filter_loop(ud + 4 * uvs, uvs, 1, 8, limit, il, hev_t, true);
      filter_loop(vd + 4 * uvs, uvs, 1, 8, limit, il, hev_t, true);
    }
  }
}

void Vp8Decoder::decode() {
  precompute_filter_strengths();
  const size_t ys = 16 * static_cast<size_t>(mb_w);
  y.assign(ys * 16 * mb_h, 0);
  u.assign(ys / 2 * 8 * mb_h, 0);
  v.assign(ys / 2 * 8 * mb_h, 0);
  mbs_.resize(mb_w);
  finfo_.resize(mb_w);
  intra_t_.assign(4 * static_cast<size_t>(mb_w), B_DC_PRED);
  nz_t_.assign(mb_w, 0);
  nz_dc_t_.assign(mb_w, 0);
  top_y_.assign(16 * static_cast<size_t>(mb_w), 0);
  top_u_.assign(8 * static_cast<size_t>(mb_w), 0);
  top_v_.assign(8 * static_cast<size_t>(mb_w), 0);
  std::memset(yuv_b_, 0, sizeof(yuv_b_));
  for (int mb_y = 0; mb_y < mb_h; ++mb_y) {
    std::memset(intra_l_, B_DC_PRED, 4);
    nz_l_ = nz_dc_l_ = 0;
    for (int mb_x = 0; mb_x < mb_w; ++mb_x) parse_intra_mode(mb_x);
    if (br_.eof()) fail(kVp8Truncated);
    BoolReader& token_br = parts_[mb_y & num_parts_minus_one_];
    for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
      MacroBlock& block = mbs_[mb_x];
      bool skip = use_skip_proba_ ? block.skip : false;
      if (!skip) {
        skip = parse_residuals(mb_x, token_br);
      } else {
        nz_l_ = nz_t_[mb_x] = 0;
        if (!block.is_i4x4) nz_dc_l_ = nz_dc_t_[mb_x] = 0;
        block.non_zero_y = block.non_zero_uv = 0;
      }
      if (filter_type_ > 0) {
        finfo_[mb_x] = fstrengths_[block.segment][block.is_i4x4];
        finfo_[mb_x].inner = finfo_[mb_x].inner || !skip;
      }
      if (token_br.eof()) fail(kVp8Truncated);
    }
    reconstruct_row(mb_y);
    if (filter_type_ > 0) filter_row(mb_y);
  }
}

// ----------------------------------------------------- YUV 4:2:0 to BGR

// libwebp's 14-bit fixed-point conversion (yuv.h: VP8YUVToR / G / B).
inline int mult_hi(int v, int coeff) { return (v * coeff) >> 8; }
inline uint8_t yuv_clip8(int v) {
  return static_cast<uint8_t>((v & ~16383) == 0 ? v >> 6 : v < 0 ? 0 : 255);
}
inline void yuv_to_bgr(int y, int u, int v, uint8_t* b, uint8_t* g,
                       uint8_t* r) {
  const int yy = mult_hi(y, 19077);
  *r = yuv_clip8(yy + mult_hi(v, 26149) - 14234);
  *g = yuv_clip8(yy - mult_hi(u, 6419) - mult_hi(v, 13320) + 8708);
  *b = yuv_clip8(yy + mult_hi(u, 33050) - 17685);
}

// One output row's chroma, upsampled as libwebp's "fancy" upsampler
// (UpsampleBgrLinePair): `near` the chroma row closer to the luma row,
// `far` the other (the same row on the first row and on the last row of
// an image of even height); each output sample weighs its 2x2 chroma
// neighbours 9-3-3-1, through the upsampler's two roundings.
void upsample_row(const uint8_t* near, const uint8_t* far, int len,
                  uint8_t* out) {
  const int last_pair = (len - 1) >> 1;
  int n0 = near[0], f0 = far[0];
  out[0] = static_cast<uint8_t>((3 * n0 + f0 + 2) >> 2);
  for (int x = 1; x <= last_pair; ++x) {
    const int n1 = near[x], f1 = far[x];
    const int avg = n0 + n1 + f0 + f1 + 8;
    out[2 * x - 1] =
        static_cast<uint8_t>((((avg + 2 * (n1 + f0)) >> 3) + n0) >> 1);
    out[2 * x] = static_cast<uint8_t>((((avg + 2 * (n0 + f1)) >> 3) + n1) >> 1);
    n0 = n1;
    f0 = f1;
  }
  if (!(len & 1))
    out[len - 1] = static_cast<uint8_t>((3 * n0 + f0 + 2) >> 2);
}

// The decoded frame, cropped to (height, width), as B, G, R planes.
void vp8_to_bgr(const Vp8Decoder& d, uint8_t* bgr) {
  const int W = d.width, H = d.height;
  const int ys = 16 * d.mb_w, uvs = 8 * d.mb_w;
  const int uv_h = (H + 1) / 2;
  const size_t npx = static_cast<size_t>(W) * H;
  std::vector<uint8_t> urow(W), vrow(W);
  for (int yy = 0; yy < H; ++yy) {
    int near, far;
    if (yy == 0) {
      near = far = 0;
    } else if (yy & 1) {
      near = (yy - 1) / 2;
      far = (yy + 1) / 2 < uv_h ? (yy + 1) / 2 : near;
    } else {
      near = yy / 2;
      far = near - 1;
    }
    upsample_row(d.u.data() + static_cast<size_t>(near) * uvs,
                 d.u.data() + static_cast<size_t>(far) * uvs, W, urow.data());
    upsample_row(d.v.data() + static_cast<size_t>(near) * uvs,
                 d.v.data() + static_cast<size_t>(far) * uvs, W, vrow.data());
    const uint8_t* yr = d.y.data() + static_cast<size_t>(yy) * ys;
    const size_t at = static_cast<size_t>(yy) * W;
    for (int x = 0; x < W; ++x)
      yuv_to_bgr(yr[x], urow[x], vrow[x], bgr + at + x, bgr + npx + at + x,
                 bgr + 2 * npx + at + x);
  }
}

// ------------------------------------------------------ VP8L bit reader

// libwebp's VP8LBitReader: a 64-bit window, filled four bytes at a time
// while eight more remain, then byte by byte. End of stream is set once
// more bits have been taken than the window and the data hold; reads past
// the data see zeros, and a decode that ends in that state fails.
class LReader {
 public:
  void init(const uint8_t* start, size_t length) {
    len_ = length;
    val_ = 0;
    bit_pos_ = 0;
    eos_ = false;
    const size_t n = length < 8 ? length : 8;
    for (size_t i = 0; i < n; ++i)
      val_ |= static_cast<uint64_t>(start[i]) << (8 * i);
    pos_ = n;
    buf_ = start;
  }

  bool eos() const { return eos_; }
  bool at_end() const { return eos_ || (pos_ == len_ && bit_pos_ > 64); }
  void update_eos() { eos_ = at_end(); }

  uint32_t prefetch() const {
    return static_cast<uint32_t>(val_ >> (bit_pos_ & 63));
  }
  void skip(int n) { bit_pos_ += n; }  // no end-of-stream check

  void fill() {
    if (bit_pos_ < 32) return;
    if (pos_ + 8 < len_) {
      val_ >>= 32;
      bit_pos_ -= 32;
      uint32_t w;
      std::memcpy(&w, buf_ + pos_, 4);
#if defined(__BYTE_ORDER__) && __BYTE_ORDER__ == __ORDER_BIG_ENDIAN__
      w = __builtin_bswap32(w);
#endif
      val_ |= static_cast<uint64_t>(w) << 32;
      pos_ += 4;
      return;
    }
    shift_bytes();
  }

  uint32_t read(int n) {
    if (!eos_ && n <= 24) {
      const uint32_t v = prefetch() & ((1u << n) - 1);
      bit_pos_ += n;
      shift_bytes();
      return v;
    }
    set_eos();
    return 0;
  }

 private:
  void set_eos() {
    eos_ = true;
    bit_pos_ = 0;
  }
  void shift_bytes() {
    while (bit_pos_ >= 8 && pos_ < len_) {
      val_ >>= 8;
      val_ |= static_cast<uint64_t>(buf_[pos_]) << 56;
      ++pos_;
      bit_pos_ -= 8;
    }
    if (at_end()) set_eos();
  }

  const uint8_t* buf_ = nullptr;
  size_t len_ = 0, pos_ = 0;
  uint64_t val_ = 0;
  int bit_pos_ = 0;
  bool eos_ = false;
};

// ------------------------------------------------------- prefix codes

constexpr int kMaxCodeLength = 15;
constexpr int kTableBits = 8;  // first-level table of a prefix code
constexpr int kLengthsTableBits = 7;
constexpr int kNumLiteralCodes = 256, kNumLengthCodes = 24;
constexpr int kNumDistanceCodes = 40;
constexpr int kMaxCacheBits = 11;
constexpr int kCodeLengthCodes = 19;
constexpr uint8_t kCodeLengthCodeOrder[kCodeLengthCodes] = {
    17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15};
enum { GREEN = 0, RED = 1, BLUE = 2, ALPHA = 3, DIST = 4 };
constexpr int kAlphabetSize[5] = {kNumLiteralCodes + kNumLengthCodes,
                                  kNumLiteralCodes, kNumLiteralCodes,
                                  kNumLiteralCodes, kNumDistanceCodes};

struct HCode {
  uint8_t bits;    // code length, or first-level: table bits + kTableBits
  uint16_t value;  // symbol, or first-level: offset of the second level
};

inline uint32_t next_key(uint32_t key, int len) {
  uint32_t step = 1u << (len - 1);
  while (key & step) step >>= 1;
  return step ? (key & (step - 1)) + step : key;
}

inline void replicate(HCode* table, int step, int end, HCode code) {
  do {
    end -= step;
    table[end] = code;
  } while (end > 0);
}

inline int next_table_bits(const int* count, int len, int root_bits) {
  int left = 1 << (len - root_bits);
  while (len < kMaxCodeLength) {
    left -= count[len];
    if (left <= 0) break;
    ++len;
    left <<= 1;
  }
  return len - root_bits;
}

// libwebp's BuildHuffmanTable: the two-level lookup table of a canonical
// prefix code from its code lengths, appended to `out`; the size of the
// table, or 0 for a code libwebp refuses (a length above 15, no symbol,
// an over-subscribed or incomplete code; one symbol of any length is a
// code of 0 bits).
int build_table(std::vector<HCode>* out, int root_bits, const int* lengths,
                int n) {
  int count[kMaxCodeLength + 1] = {0};
  int offset[kMaxCodeLength + 1];
  for (int s = 0; s < n; ++s) {
    if (lengths[s] > kMaxCodeLength) return 0;
    ++count[lengths[s]];
  }
  if (count[0] == n) return 0;
  offset[1] = 0;
  for (int len = 1; len < kMaxCodeLength; ++len) {
    if (count[len] > (1 << len)) return 0;
    offset[len + 1] = offset[len] + count[len];
  }
  std::vector<uint16_t> sorted(n);
  for (int s = 0; s < n; ++s)
    if (lengths[s] > 0) sorted[offset[lengths[s]]++] = static_cast<uint16_t>(s);
  int total_size = 1 << root_bits;
  const size_t base = out->size();
  if (offset[kMaxCodeLength] == 1) {  // one symbol: a code of 0 bits
    out->resize(base + total_size);
    replicate(out->data() + base, 1, total_size, HCode{0, sorted[0]});
    return total_size;
  }
  // a dry run for the size, as libwebp's, with the same failures
  {
    int num_nodes = 1, num_open = 1;
    int cnt[kMaxCodeLength + 1];
    std::memcpy(cnt, count, sizeof(cnt));
    uint32_t key = 0, low = 0xffffffffu;
    const uint32_t mask = static_cast<uint32_t>(total_size - 1);
    for (int len = 1; len <= root_bits; ++len) {
      num_open <<= 1;
      num_nodes += num_open;
      num_open -= cnt[len];
      if (num_open < 0) return 0;
      for (; cnt[len] > 0; --cnt[len]) key = next_key(key, len);
    }
    for (int len = root_bits + 1; len <= kMaxCodeLength; ++len) {
      num_open <<= 1;
      num_nodes += num_open;
      num_open -= cnt[len];
      if (num_open < 0) return 0;
      for (; cnt[len] > 0; --cnt[len]) {
        if ((key & mask) != low) {
          total_size += 1 << next_table_bits(cnt, len, root_bits);
          low = key & mask;
        }
        key = next_key(key, len);
      }
    }
    if (num_nodes != 2 * offset[kMaxCodeLength] - 1) return 0;
  }
  out->resize(base + total_size);
  HCode* root = out->data() + base;
  HCode* table = root;
  int table_bits = root_bits;
  int table_size = 1 << table_bits;
  int symbol = 0;
  uint32_t key = 0, low = 0xffffffffu;
  const uint32_t mask = static_cast<uint32_t>((1 << root_bits) - 1);
  int step = 2;
  for (int len = 1; len <= root_bits; ++len, step <<= 1)
    for (; count[len] > 0; --count[len]) {
      replicate(&table[key], step, table_size,
                HCode{static_cast<uint8_t>(len), sorted[symbol++]});
      key = next_key(key, len);
    }
  step = 2;
  for (int len = root_bits + 1; len <= kMaxCodeLength; ++len, step <<= 1)
    for (; count[len] > 0; --count[len]) {
      if ((key & mask) != low) {
        table += table_size;
        table_bits = next_table_bits(count, len, root_bits);
        table_size = 1 << table_bits;
        low = key & mask;
        root[low].bits = static_cast<uint8_t>(table_bits + root_bits);
        root[low].value = static_cast<uint16_t>((table - root) - low);
      }
      replicate(&table[key >> root_bits], step, table_size,
                HCode{static_cast<uint8_t>(len - root_bits),
                      sorted[symbol++]});
      key = next_key(key, len);
    }
  return total_size;
}

inline int read_symbol(const HCode* table, LReader& br) {
  uint32_t val = br.prefetch();
  table += val & ((1u << kTableBits) - 1);
  const int nbits = table->bits - kTableBits;
  if (nbits > 0) {
    br.skip(kTableBits);
    val = br.prefetch();
    table += table->value;
    table += val & ((1u << nbits) - 1);
  }
  br.skip(table->bits);
  return table->value;
}

// ----------------------------------------------------------- VP8L image

struct HTreeGroup {
  size_t htrees[5];  // offsets in the level's table vector
};

struct Metadata {
  int color_cache_bits = 0;
  int huffman_bits = 0;  // meta prefix image subsampling, 0 for none
  int huffman_xsize = 0;
  std::vector<uint32_t> huffman_image;  // group index a tile
  std::vector<HTreeGroup> groups;
  std::vector<HCode> tables;
};

struct Transform {
  int type;
  int bits;
  int xsize, ysize;
  std::vector<uint32_t> data;
};

enum {
  kPredictor = 0,
  kCrossColor = 1,
  kSubtractGreen = 2,
  kColorIndexing = 3
};

inline int sub_sample(int size, int bits) {
  return (size + (1 << bits) - 1) >> bits;
}

class Vp8lDecoder {
 public:
  Vp8lDecoder(const uint8_t* data, size_t size) { br_.init(data, size); }

  // The image header (RFC 9649 section 3.2) of a VP8L bitstream.
  void read_header() {
    if (br_.read(8) != 0x2f) fail(kBadVp8lHeader);
    width = static_cast<int>(br_.read(14)) + 1;
    height = static_cast<int>(br_.read(14)) + 1;
    br_.read(1);  // alpha_is_used: a hint
    if (br_.read(3) != 0) fail(kBadVp8lHeader);
    if (br_.eos()) fail(kVp8lTruncated);
  }

  // The ARGB pixels of the whole image, transforms undone.
  void decode(std::vector<uint32_t>* argb) {
    int xsize = width;
    Metadata hdr;
    read_level0(&xsize, &hdr);
    std::vector<uint32_t> data(static_cast<size_t>(xsize) * height);
    decode_pixels(hdr, xsize, height, data.data(), false);
    for (int n = static_cast<int>(transforms_.size()) - 1; n >= 0; --n)
      inverse_transform(transforms_[n], &data);
    argb->swap(data);
  }

  // An ALPH chunk's lossless stream: the image stream of `w` x `h`
  // without the header, decoded as libwebp decodes alpha (only to check
  // that it decodes: cv::imread drops alpha).
  void decode_alpha(int w, int h) {
    width = w;
    height = h;
    int xsize = width;
    Metadata hdr;
    read_level0(&xsize, &hdr);
    // libwebp's 8-bit path: one transform, colour indexing, no colour
    // cache, and red, blue and alpha codes of one symbol each; there an
    // end of stream exactly at the last pixel is no error
    bool eight_bit = transforms_.size() == 1
                     && transforms_[0].type == kColorIndexing
                     && hdr.color_cache_bits == 0;
    for (const HTreeGroup& g : hdr.groups)
      for (int k : {RED, BLUE, ALPHA})
        if (hdr.tables[g.htrees[k]].bits > 0) eight_bit = false;
    std::vector<uint32_t> data(static_cast<size_t>(xsize) * height);
    decode_pixels(hdr, xsize, height, data.data(), eight_bit);
  }

  int width = 0, height = 0;

 private:
  void read_level0(int* xsize, Metadata* hdr) {
    int ysize = height;
    unsigned seen = 0;
    while (br_.read(1)) {
      const int type = static_cast<int>(br_.read(2));
      if (seen & (1u << type)) fail(kVp8lData);
      seen |= 1u << type;
      read_transform(type, xsize, ysize);
    }
    read_stream_header(*xsize, ysize, true, hdr);
  }

  void read_transform(int type, int* xsize, int ysize) {
    Transform t;
    t.type = type;
    t.xsize = *xsize;
    t.ysize = ysize;
    t.bits = 0;
    switch (type) {
      case kPredictor:
      case kCrossColor:
        t.bits = static_cast<int>(br_.read(3)) + 2;
        decode_sub_image(sub_sample(t.xsize, t.bits),
                         sub_sample(t.ysize, t.bits), &t.data);
        break;
      case kColorIndexing: {
        const int num_colors = static_cast<int>(br_.read(8)) + 1;
        t.bits = num_colors > 16 ? 0 : num_colors > 4 ? 1
                                     : num_colors > 2 ? 2 : 3;
        *xsize = sub_sample(t.xsize, t.bits);
        std::vector<uint32_t> palette;
        decode_sub_image(num_colors, 1, &palette);
        // delta-coded entries, then transparent black up to 2^(8 >> bits)
        const int final_num = 1 << (8 >> t.bits);
        t.data.assign(final_num, 0);
        uint8_t* nd = reinterpret_cast<uint8_t*>(t.data.data());
        const uint8_t* od = reinterpret_cast<const uint8_t*>(palette.data());
        std::memcpy(nd, od, 4);
        for (int i = 4; i < 4 * num_colors; ++i)
          nd[i] = static_cast<uint8_t>(od[i] + nd[i - 4]);
        break;
      }
      default:  // subtract green: no data
        break;
    }
    transforms_.push_back(std::move(t));
  }

  void decode_sub_image(int xsize, int ysize, std::vector<uint32_t>* out) {
    Metadata hdr;
    read_stream_header(xsize, ysize, false, &hdr);
    out->assign(static_cast<size_t>(xsize) * ysize, 0);
    decode_pixels(hdr, xsize, ysize, out->data(), false);
  }

  // The colour cache and the prefix codes of an image stream (RFC 9649
  // section 3.7), with its meta prefix image at level 0.
  void read_stream_header(int xsize, int ysize, bool level0, Metadata* hdr) {
    if (br_.read(1)) {
      hdr->color_cache_bits = static_cast<int>(br_.read(4));
      if (hdr->color_cache_bits < 1 || hdr->color_cache_bits > kMaxCacheBits)
        fail(kVp8lData);
    }
    int num_groups_max = 1;
    std::vector<int> mapping;
    if (level0 && br_.read(1)) {
      const int bits = static_cast<int>(br_.read(3)) + 2;
      const int hx = sub_sample(xsize, bits), hy = sub_sample(ysize, bits);
      std::vector<uint32_t> image;
      decode_sub_image(hx, hy, &image);
      hdr->huffman_bits = bits;
      hdr->huffman_xsize = hx;
      for (uint32_t& p : image) {
        p = (p >> 8) & 0xffff;
        if (static_cast<int>(p) >= num_groups_max) num_groups_max = p + 1;
      }
      // as libwebp: with many groups, only those the image uses are kept
      if (num_groups_max > 1000 || num_groups_max > xsize * ysize) {
        mapping.assign(num_groups_max, -1);
        int next = 0;
        for (uint32_t& p : image) {
          if (mapping[p] == -1) mapping[p] = next++;
          p = static_cast<uint32_t>(mapping[p]);
        }
      }
      hdr->huffman_image.swap(image);
    }
    if (br_.eos()) fail(kVp8lTruncated);
    const int cache_size = hdr->color_cache_bits > 0
                           ? 1 << hdr->color_cache_bits : 0;
    std::vector<int> lengths(kAlphabetSize[GREEN] + (1 << kMaxCacheBits));
    for (int i = 0; i < num_groups_max; ++i) {
      const bool keep = mapping.empty() || mapping[i] != -1;
      HTreeGroup g;
      for (int j = 0; j < 5; ++j) {
        const int alphabet = kAlphabetSize[j] + (j == 0 ? cache_size : 0);
        const size_t at = hdr->tables.size();
        read_code(alphabet, lengths.data(), &hdr->tables);
        g.htrees[j] = at;
        if (!keep) hdr->tables.resize(at);
      }
      if (keep) hdr->groups.push_back(g);
    }
  }

  // One prefix code (RFC 9649 section 3.7.2.1), its table appended.
  void read_code(int alphabet, int* lengths, std::vector<HCode>* tables) {
    std::fill(lengths, lengths + kAlphabetSize[GREEN] + (1 << kMaxCacheBits),
              0);
    if (br_.read(1)) {  // simple code: one or two symbols of length 1
      const int num_symbols = static_cast<int>(br_.read(1)) + 1;
      const int first_bits = br_.read(1) ? 8 : 1;
      lengths[br_.read(first_bits)] = 1;
      if (num_symbols == 2) lengths[br_.read(8)] = 1;
    } else {
      int cl_lengths[kCodeLengthCodes] = {0};
      const int num_codes = static_cast<int>(br_.read(4)) + 4;
      for (int i = 0; i < num_codes; ++i)
        cl_lengths[kCodeLengthCodeOrder[i]] = static_cast<int>(br_.read(3));
      read_code_lengths(cl_lengths, alphabet, lengths);
    }
    if (br_.eos()) fail(kVp8lTruncated);
    if (build_table(tables, kTableBits, lengths, alphabet) == 0)
      fail(kVp8lData);
  }

  void read_code_lengths(const int* cl_lengths, int num_symbols,
                         int* lengths) {
    std::vector<HCode> table;
    if (build_table(&table, kLengthsTableBits, cl_lengths, kCodeLengthCodes)
        == 0)
      fail(kVp8lData);
    int max_symbol;
    if (br_.read(1)) {
      const int length_nbits = 2 + 2 * static_cast<int>(br_.read(3));
      max_symbol = 2 + static_cast<int>(br_.read(length_nbits));
      if (max_symbol > num_symbols) fail(kVp8lData);
    } else {
      max_symbol = num_symbols;
    }
    int symbol = 0, prev_len = 8;
    while (symbol < num_symbols) {
      if (max_symbol-- == 0) break;
      br_.fill();
      const HCode& p = table[br_.prefetch() & ((1u << kLengthsTableBits) - 1)];
      br_.skip(p.bits);
      const int code_len = p.value;
      if (code_len < 16) {
        lengths[symbol++] = code_len;
        if (code_len != 0) prev_len = code_len;
      } else {
        static const int kExtraBits[3] = {2, 3, 7};
        static const int kRepeatOffsets[3] = {3, 3, 11};
        const int slot = code_len - 16;
        int repeat = static_cast<int>(br_.read(kExtraBits[slot]))
                     + kRepeatOffsets[slot];
        if (symbol + repeat > num_symbols) fail(kVp8lData);
        const int len = code_len == 16 ? prev_len : 0;
        while (repeat-- > 0) lengths[symbol++] = len;
      }
    }
  }

  int copy_value(int symbol) {
    if (symbol < 4) return symbol + 1;
    const int extra_bits = (symbol - 2) >> 1;
    const int offset = (2 + (symbol & 1)) << extra_bits;
    return offset + static_cast<int>(br_.read(extra_bits)) + 1;
  }

  static int plane_code_to_distance(int xsize, int plane_code) {
    if (plane_code > 120) return plane_code - 120;
    const int dist_code = kCodeToPlane[plane_code - 1];
    const int yoffset = dist_code >> 4;
    const int xoffset = 8 - (dist_code & 0xf);
    const int dist = yoffset * xsize + xoffset;
    return dist >= 1 ? dist : 1;
  }

  // The entropy-coded pixels of one image stream (libwebp's
  // DecodeImageData, or DecodeAlphaData where `eight_bit`).
  void decode_pixels(const Metadata& hdr, int width, int height,
                     uint32_t* data, bool eight_bit) {
    const int mask = hdr.huffman_bits == 0 ? -1 : (1 << hdr.huffman_bits) - 1;
    const int cache_bits = hdr.color_cache_bits;
    std::vector<uint32_t> cache(cache_bits > 0 ? 1u << cache_bits : 0);
    const int len_code_limit = kNumLiteralCodes + kNumLengthCodes;
    const int cache_limit = len_code_limit + static_cast<int>(cache.size());
    const size_t total = static_cast<size_t>(width) * height;
    size_t pos = 0;
    int col = 0, row = 0;
    const HTreeGroup* group = nullptr;
    size_t last_cached = 0;
    const HCode* tables = hdr.tables.data();
    auto group_at = [&](int x, int yy) -> const HTreeGroup* {
      if (hdr.huffman_bits == 0) return &hdr.groups[0];
      const uint32_t idx = hdr.huffman_image[
          static_cast<size_t>(hdr.huffman_xsize) * (yy >> hdr.huffman_bits)
          + (x >> hdr.huffman_bits)];
      return &hdr.groups[idx];
    };
    auto insert_cached = [&]() {
      for (; last_cached < pos; ++last_cached)
        cache[(0x1e35a7bdu * data[last_cached]) >> (32 - cache_bits)] =
            data[last_cached];
    };
    while (pos < total) {
      if ((col & mask) == 0) group = group_at(col, row);
      br_.fill();
      const int code = read_symbol(tables + group->htrees[GREEN], br_);
      if (!eight_bit && br_.at_end()) break;
      if (code < kNumLiteralCodes) {
        const int red = read_symbol(tables + group->htrees[RED], br_);
        br_.fill();
        const int blue = read_symbol(tables + group->htrees[BLUE], br_);
        const int alpha = read_symbol(tables + group->htrees[ALPHA], br_);
        if (!eight_bit && br_.at_end()) break;
        data[pos++] = (static_cast<uint32_t>(alpha) << 24)
                      | (static_cast<uint32_t>(red) << 16)
                      | (static_cast<uint32_t>(code) << 8)
                      | static_cast<uint32_t>(blue);
        if (++col >= width) {
          col = 0;
          ++row;
          if (cache_bits > 0) insert_cached();
        }
      } else if (code < len_code_limit) {
        const int length = copy_value(code - kNumLiteralCodes);
        const int dist_symbol = read_symbol(tables + group->htrees[DIST], br_);
        br_.fill();
        const int dist_code = copy_value(dist_symbol);
        const int dist = plane_code_to_distance(width, dist_code);
        if (!eight_bit && br_.at_end()) break;
        if (pos < static_cast<size_t>(dist)
            || total - pos < static_cast<size_t>(length))
          fail(kVp8lData);
        for (int k = 0; k < length; ++k, ++pos) data[pos] = data[pos - dist];
        col += length;
        while (col >= width) {
          col -= width;
          ++row;
        }
        if (pos < total && (col & mask)) group = group_at(col, row);
        if (cache_bits > 0) insert_cached();
      } else if (code < cache_limit) {
        insert_cached();
        data[pos] = cache[code - len_code_limit];
        ++pos;
        if (++col >= width) {
          col = 0;
          ++row;
          insert_cached();
        }
      } else {
        fail(kVp8lData);
      }
      if (eight_bit) {
        br_.update_eos();
        if (br_.eos()) break;
      }
    }
    br_.update_eos();
    // a lossless image fails if the stream ended before its last bit was
    // read; libwebp's 8-bit alpha path only if pixels are missing
    if (eight_bit ? (br_.eos() && pos < total) : br_.eos())
      fail(kVp8lTruncated);
  }

  void inverse_transform(const Transform& t, std::vector<uint32_t>* data);

  LReader br_;
  std::vector<Transform> transforms_;
};

inline uint32_t add_pixels(uint32_t a, uint32_t b) {
  const uint32_t ag = (a & 0xff00ff00u) + (b & 0xff00ff00u);
  const uint32_t rb = (a & 0x00ff00ffu) + (b & 0x00ff00ffu);
  return (ag & 0xff00ff00u) | (rb & 0x00ff00ffu);
}

inline uint32_t average2(uint32_t a, uint32_t b) {
  return (((a ^ b) & 0xfefefefeu) >> 1) + (a & b);
}

inline uint32_t clip255(uint32_t a) { return a < 256 ? a : ~a >> 24; }

inline int add_sub_full(int a, int b, int c) {
  return static_cast<int>(clip255(static_cast<uint32_t>(a + b - c)));
}

inline int add_sub_half(int a, int b) {
  return static_cast<int>(clip255(static_cast<uint32_t>(a + (a - b) / 2)));
}

inline uint32_t select(uint32_t a, uint32_t b, uint32_t c) {  // a T, b L
  int pa_minus_pb = 0;
  for (int s = 0; s < 32; s += 8) {
    const int ac = (a >> s) & 0xff, bc = (b >> s) & 0xff, cc = (c >> s) & 0xff;
    pa_minus_pb += std::abs(bc - cc) - std::abs(ac - cc);
  }
  return pa_minus_pb <= 0 ? a : b;
}

// The predictor of mode m (RFC 9649 section 4.1) for pixel `left` and
// the row above from `top` (top[-1] top-left, top[1] top-right).
inline uint32_t predict(int m, uint32_t left, const uint32_t* top) {
  switch (m) {
    case 1: return left;
    case 2: return top[0];
    case 3: return top[1];
    case 4: return top[-1];
    case 5: return average2(average2(left, top[1]), top[0]);
    case 6: return average2(left, top[-1]);
    case 7: return average2(left, top[0]);
    case 8: return average2(top[-1], top[0]);
    case 9: return average2(top[0], top[1]);
    case 10: return average2(average2(left, top[-1]), average2(top[0], top[1]));
    case 11: return select(top[0], left, top[-1]);
    case 12: {
      uint32_t out = 0;
      for (int s = 0; s < 32; s += 8)
        out |= static_cast<uint32_t>(add_sub_full((left >> s) & 0xff,
                                                  (top[0] >> s) & 0xff,
                                                  (top[-1] >> s) & 0xff)) << s;
      return out;
    }
    case 13: {
      const uint32_t ave = average2(left, top[0]);
      uint32_t out = 0;
      for (int s = 0; s < 32; s += 8)
        out |= static_cast<uint32_t>(add_sub_half((ave >> s) & 0xff,
                                                  (top[-1] >> s) & 0xff)) << s;
      return out;
    }
    default: return 0xff000000u;  // 0, and 14 and 15 as libwebp
  }
}

inline int color_delta(int8_t pred, int8_t color) {
  return (static_cast<int>(pred) * color) >> 5;
}

void Vp8lDecoder::inverse_transform(const Transform& t,
                                    std::vector<uint32_t>* data) {
  const int width = t.xsize, height = t.ysize;
  uint32_t* px = data->data();
  switch (t.type) {
    case kSubtractGreen:
      for (size_t i = 0, n = static_cast<size_t>(width) * height; i < n; ++i) {
        const uint32_t green = (px[i] >> 8) & 0xff;
        uint32_t rb = px[i] & 0x00ff00ffu;
        rb += (green << 16) | green;
        px[i] = (px[i] & 0xff00ff00u) | (rb & 0x00ff00ffu);
      }
      break;
    case kPredictor: {
      // row 0: black for the first pixel, then the left pixel
      px[0] = add_pixels(px[0], 0xff000000u);
      for (int x = 1; x < width; ++x) px[x] = add_pixels(px[x], px[x - 1]);
      const int tiles_per_row = sub_sample(width, t.bits);
      for (int yy = 1; yy < height; ++yy) {
        uint32_t* row = px + static_cast<size_t>(yy) * width;
        const uint32_t* top = row - width;
        const uint32_t* modes = t.data.data()
            + static_cast<size_t>(yy >> t.bits) * tiles_per_row;
        row[0] = add_pixels(row[0], top[0]);
        for (int x = 1; x < width; ++x) {
          const int m = (modes[x >> t.bits] >> 8) & 0xf;
          row[x] = add_pixels(row[x], predict(m, row[x - 1], top + x));
        }
      }
      break;
    }
    case kCrossColor: {
      const int tiles_per_row = sub_sample(width, t.bits);
      for (int yy = 0; yy < height; ++yy) {
        uint32_t* row = px + static_cast<size_t>(yy) * width;
        const uint32_t* codes = t.data.data()
            + static_cast<size_t>(yy >> t.bits) * tiles_per_row;
        for (int x = 0; x < width; ++x) {
          const uint32_t code = codes[x >> t.bits];
          const int8_t g2r = static_cast<int8_t>(code & 0xff);
          const int8_t g2b = static_cast<int8_t>((code >> 8) & 0xff);
          const int8_t r2b = static_cast<int8_t>((code >> 16) & 0xff);
          const uint32_t argb = row[x];
          const int8_t green = static_cast<int8_t>(argb >> 8);
          int new_red = (argb >> 16) & 0xff;
          int new_blue = argb & 0xff;
          new_red += color_delta(g2r, green);
          new_red &= 0xff;
          new_blue += color_delta(g2b, green);
          new_blue += color_delta(r2b, static_cast<int8_t>(new_red));
          new_blue &= 0xff;
          row[x] = (argb & 0xff00ff00u) | (static_cast<uint32_t>(new_red) << 16)
                   | static_cast<uint32_t>(new_blue);
        }
      }
      break;
    }
    case kColorIndexing: {
      const uint32_t* map = t.data.data();
      const int packed_w = sub_sample(width, t.bits);
      std::vector<uint32_t> out(static_cast<size_t>(width) * height);
      if (t.bits > 0) {
        const int bits_per_pixel = 8 >> t.bits;
        const int count_mask = (1 << t.bits) - 1;
        const uint32_t bit_mask = (1u << bits_per_pixel) - 1;
        for (int yy = 0; yy < height; ++yy) {
          const uint32_t* src = px + static_cast<size_t>(yy) * packed_w;
          uint32_t* dst = out.data() + static_cast<size_t>(yy) * width;
          uint32_t packed = 0;
          for (int x = 0; x < width; ++x) {
            if ((x & count_mask) == 0) packed = (*src++ >> 8) & 0xff;
            dst[x] = map[packed & bit_mask];
            packed >>= bits_per_pixel;
          }
        }
      } else {
        for (size_t i = 0, n = out.size(); i < n; ++i)
          out[i] = map[(px[i] >> 8) & 0xff];
      }
      data->swap(out);
      break;
    }
  }
}

// ------------------------------------------------------------- ALPH

// An ALPH chunk checked as libwebp decodes it beside a lossy image of
// `w` x `h` (its ALPHInit and ALPHDecode): the header byte's fields, raw
// data of at least w * h bytes, or a lossless stream that decodes.
void check_alpha(const uint8_t* data, size_t size, int w, int h) {
  if (size <= 1) fail(kAlpha);
  const int method = data[0] & 3;
  const int pre_processing = (data[0] >> 4) & 3;
  const int reserved = (data[0] >> 6) & 3;
  if (method > 1 || pre_processing > 1 || reserved != 0) fail(kAlpha);
  if (method == 0) {
    if (size - 1 < static_cast<size_t>(w) * h) fail(kAlpha);
    return;
  }
  try {
    Vp8lDecoder alpha(data + 1, size - 1);
    alpha.decode_alpha(w, h);
  } catch (const Error&) {
    fail(kAlpha);
  }
}

// ------------------------------------------------------------ the image

// Frame 0 decoded into B, G, R planes of `bgr` (3 x h x w).
void decode_frame(const uint8_t* data, size_t size, bool lossless,
                  const uint8_t* alpha, size_t alpha_size, int w, int h,
                  std::vector<uint8_t>* bgr) {
  const size_t npx = static_cast<size_t>(w) * h;
  bgr->resize(3 * npx);
  if (lossless) {
    Vp8lDecoder d(data, size);
    d.read_header();
    if (d.width != w || d.height != h) fail(kSize);
    std::vector<uint32_t> argb;
    d.decode(&argb);
    uint8_t* b = bgr->data();
    for (size_t i = 0; i < npx; ++i) {
      const uint32_t p = argb[i];
      b[i] = static_cast<uint8_t>(p);
      b[npx + i] = static_cast<uint8_t>(p >> 8);
      b[2 * npx + i] = static_cast<uint8_t>(p >> 16);
    }
    return;
  }
  Vp8Decoder d(data, size);
  d.read_headers();
  if (d.width != w || d.height != h) fail(kSize);
  d.decode();
  if (alpha != nullptr) check_alpha(alpha, alpha_size, w, h);
  vp8_to_bgr(d, bgr->data());
}

void decode(const uint8_t* data, int64_t size, int lossless,
            const uint8_t* alpha, int64_t alpha_size, int width, int height,
            int canvas_w, int canvas_h, int x0, int y0, int orientation,
            int channels, uint8_t* out) {
  if (channels != 1 && channels != 3) fail(kChannels);
  if (size < 0 || alpha_size < 0 || width <= 0 || height <= 0) fail(kSize);
  if (x0 < 0 || y0 < 0 || canvas_w < x0 + width || canvas_h < y0 + height)
    fail(kPlacement);
  std::vector<uint8_t> bgr;
  decode_frame(data, static_cast<size_t>(size), lossless != 0, alpha,
               static_cast<size_t>(alpha_size), width, height, &bgr);
  const size_t npx = static_cast<size_t>(width) * height;
  if (channels == 1) {  // cv::imread's cvtColor of the BGR pixels (gray.h)
    for (size_t i = 0; i < npx; ++i)
      bgr[i] = cvt_gray(bgr[i], bgr[npx + i], bgr[2 * npx + i]);
  }
  // frame 0 on a canvas of zeros (WebPAnimDecoder's first frame), then
  // the EXIF orientation
  const size_t cpx = static_cast<size_t>(canvas_w) * canvas_h;
  const bool placed = canvas_w != width || canvas_h != height;
  const int o = orientation >= 1 && orientation <= 8 ? orientation : 1;
  std::vector<uint8_t> canvas;
  if (placed) {
    canvas.assign(channels * cpx, 0);
    for (int c = 0; c < channels; ++c)
      for (int yy = 0; yy < height; ++yy)
        std::memcpy(canvas.data() + c * cpx
                        + static_cast<size_t>(y0 + yy) * canvas_w + x0,
                    bgr.data() + c * npx + static_cast<size_t>(yy) * width,
                    width);
  }
  const uint8_t* src = placed ? canvas.data() : bgr.data();
  for (int c = 0; c < channels; ++c) {
    if (o == 1)
      std::memcpy(out + c * cpx, src + c * cpx, cpx);
    else
      orient_copy(src + c * cpx, canvas_w, canvas_w, canvas_h, o,
                  out + c * cpx);
  }
}

}  // namespace

extern "C" {

// A WebP image's bitstream to (channels, H, W) uint8 as cv::imread gives
// it: channels 1 gray (OpenCV's BGR2GRAY of the BGR pixels), 3 B, G, R.
// `data` / `size`: the VP8 (lossy, `lossless` 0) or VP8L payload and what
// follows it in the file (in an animation, up to the frame's image chunk
// end); `alpha`: the ALPH payload of a lossy image, or null. The image is
// `width` x `height`, placed at (x0, y0) on a `canvas_w` x `canvas_h`
// canvas of zeros (the whole canvas for a still image), then turned by
// the EXIF `orientation` (1-8): H, W are the turned canvas's. Returns 0,
// or a negative code (of_webp_strerror).
int of_webp_decode(const uint8_t* data, int64_t size, int lossless,
                   const uint8_t* alpha, int64_t alpha_size, int width,
                   int height, int canvas_w, int canvas_h, int x0, int y0,
                   int orientation, int channels, uint8_t* out) {
  try {
    decode(data, size, lossless, alpha, alpha_size, width, height, canvas_w,
           canvas_h, x0, y0, orientation, channels, out);
    return 0;
  } catch (const Error& e) {
    return e.code;
  } catch (const std::bad_alloc&) {
    return kNoMemory;
  }
}

const char* of_webp_strerror(int code) {
  switch (code) {
    case kOk: return "no error";
    case kBadVp8Header: return "corrupt WebP VP8 frame header";
    case kNotKeyFrame: return "WebP VP8 frame is not a key frame";
    case kVp8Truncated: return "truncated WebP VP8 data";
    case kVp8Partitions: return "corrupt WebP VP8 token partitions";
    case kVp8Header: return "corrupt WebP VP8 segment or filter header";
    case kVp8Data: return "corrupt WebP VP8 data";
    case kBadVp8lHeader: return "corrupt WebP VP8L header";
    case kVp8lData: return "corrupt WebP VP8L data";
    case kVp8lTruncated: return "truncated WebP VP8L data";
    case kAlpha: return "corrupt WebP ALPH chunk (libwebp fails on it)";
    case kSize: return "WebP bitstream size differs from its container's";
    case kChannels: return "channels must be 1 or 3";
    case kNoMemory: return "out of memory decoding WebP";
    case kPlacement: return "WebP frame does not fit its canvas";
    default: return "unknown WebP error";
  }
}

}  // extern "C"
