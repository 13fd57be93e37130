/* A JPEG writer for the fixtures of tests/test_torch_jpeg_arith.py: the
 * streams that cv2 and PIL cannot write (arithmetic coding, lossless
 * SOF3, CMYK and YCCK with libjpeg's own markers, custom scan scripts,
 * DAC conditioning), written by libjpeg-turbo itself.
 *
 * Built by make_fixtures.py (`build_writer`) against the libjpeg-turbo 3
 * that Pillow bundles, with the libjpeg 6.2 headers of the system; it is a
 * tool for making fixtures only and no part of the port.
 *
 *   jpeg_writer IN.raw OUT.jpg key=value ...
 *
 * IN.raw holds height x width x components samples, interleaved: bytes,
 * or little-endian 16-bit words where precision > 8. Keys:
 *   w, h, comps     size and input components (1 gray, 3 RGB, 4 CMYK,
 *                   any other count of unknown meaning)
 *   space           JPEG colour space: gray, ycc, rgb, cmyk, ycck
 *   q               quality (default 90)
 *   samp            sampling factors "h,v;h,v;..." per component
 *   arith           1: arithmetic coding
 *   prog            1: jpeg_simple_progression
 *   scans           a scan script "c,c:Ss:Se:Ah:Al/..." (components of a
 *                   scan, then its spectral selection and successive
 *                   approximation)
 *   rst, rstrows    restart interval in MCUs, or in MCU rows
 *   dac             "L,U,K" of arithmetic tables 0 and 1
 *   lossless        "psv,pt": lossless (SOF3) with predictor psv, point
 *                   transform pt
 *   prec            sample precision (lossless 2-16, else 8 or 12)
 *   jfif, adobe     0 / 1: write the JFIF APP0 / Adobe APP14 marker
 */
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include <jpeglib.h>

/* libjpeg-turbo 3 entries that the 6.2 headers do not declare */
void jpeg_enable_lossless(j_compress_ptr cinfo, int psv, int pt);
JDIMENSION jpeg12_write_scanlines(j_compress_ptr cinfo, short **rows,
                                  JDIMENSION n);
JDIMENSION jpeg16_write_scanlines(j_compress_ptr cinfo, unsigned short **rows,
                                  JDIMENSION n);

static const char *arg(int argc, char **argv, const char *key) {
  size_t n = strlen(key);
  for (int i = 3; i < argc; ++i)
    if (!strncmp(argv[i], key, n) && argv[i][n] == '=') return argv[i] + n + 1;
  return NULL;
}

static int iarg(int argc, char **argv, const char *key, int dflt) {
  const char *v = arg(argc, argv, key);
  return v ? atoi(v) : dflt;
}

static J_COLOR_SPACE space_of(const char *s) {
  if (!strcmp(s, "gray")) return JCS_GRAYSCALE;
  if (!strcmp(s, "ycc")) return JCS_YCbCr;
  if (!strcmp(s, "rgb")) return JCS_RGB;
  if (!strcmp(s, "cmyk")) return JCS_CMYK;
  if (!strcmp(s, "ycck")) return JCS_YCCK;
  fprintf(stderr, "unknown colour space %s\n", s);
  exit(2);
}

int main(int argc, char **argv) {
  if (argc < 3) {
    fprintf(stderr, "usage: %s IN.raw OUT.jpg key=value ...\n", argv[0]);
    return 2;
  }
  const int w = iarg(argc, argv, "w", 0), h = iarg(argc, argv, "h", 0);
  const int comps = iarg(argc, argv, "comps", 3);
  const int prec = iarg(argc, argv, "prec", 8);
  const int wide = prec > 8;
  const size_t row_bytes = (size_t)w * comps * (wide ? 2 : 1);
  unsigned char *pix = malloc(row_bytes * h);
  FILE *in = fopen(argv[1], "rb");
  if (!in || fread(pix, 1, row_bytes * h, in) != row_bytes * h) {
    fprintf(stderr, "cannot read %s\n", argv[1]);
    return 2;
  }
  fclose(in);

  struct jpeg_compress_struct c;
  struct jpeg_error_mgr err;
  c.err = jpeg_std_error(&err);
  jpeg_create_compress(&c);
  FILE *out = fopen(argv[2], "wb");
  if (!out) return 2;
  jpeg_stdio_dest(&c, out);
  c.image_width = w;
  c.image_height = h;
  c.input_components = comps;
  c.in_color_space = comps == 1   ? JCS_GRAYSCALE
                     : comps == 3 ? JCS_RGB
                     : comps == 4 ? JCS_CMYK
                                  : JCS_UNKNOWN;
  c.data_precision = prec;
  jpeg_set_defaults(&c);
  c.data_precision = prec;
  /* before the colour space and the sampling factors, which
   * jpeg_enable_lossless would reset to the input's and 1x1 */
  const char *ll = arg(argc, argv, "lossless");
  if (ll) {
    int psv, pt;
    if (sscanf(ll, "%d,%d", &psv, &pt) == 2) jpeg_enable_lossless(&c, psv, pt);
  }
  const char *space = arg(argc, argv, "space");
  if (space) jpeg_set_colorspace(&c, space_of(space));
  jpeg_set_quality(&c, iarg(argc, argv, "q", 90), TRUE);
  const char *samp = arg(argc, argv, "samp");
  for (int i = 0; samp && i < c.num_components; ++i) {
    int hs, vs, used;
    if (sscanf(samp, "%d,%d%n", &hs, &vs, &used) != 2) break;
    c.comp_info[i].h_samp_factor = hs;
    c.comp_info[i].v_samp_factor = vs;
    samp += used;
    if (*samp == ';') ++samp;
  }
  c.arith_code = iarg(argc, argv, "arith", 0);
  c.restart_interval = iarg(argc, argv, "rst", 0);
  c.restart_in_rows = iarg(argc, argv, "rstrows", 0);
  const char *dac = arg(argc, argv, "dac");
  if (dac) {
    int l, u, k;
    if (sscanf(dac, "%d,%d,%d", &l, &u, &k) == 3)
      for (int t = 0; t < 2; ++t) {
        c.arith_dc_L[t] = l;
        c.arith_dc_U[t] = u;
        c.arith_ac_K[t] = k;
      }
  }
  if (iarg(argc, argv, "prog", 0)) jpeg_simple_progression(&c);
  static jpeg_scan_info script[64];
  const char *scans = arg(argc, argv, "scans");
  if (scans) {
    int n = 0;
    while (*scans && n < 64) {
      jpeg_scan_info *s = &script[n++];
      s->comps_in_scan = 0;
      int v, used;
      while (sscanf(scans, "%d%n", &v, &used) == 1) {
        s->component_index[s->comps_in_scan++] = v;
        scans += used;
        if (*scans != ',') break;
        ++scans;
      }
      if (sscanf(scans, ":%d:%d:%d:%d%n", &s->Ss, &s->Se, &s->Ah, &s->Al,
                 &used) != 4) {
        fprintf(stderr, "bad scan script\n");
        return 2;
      }
      scans += used;
      if (*scans == '/') ++scans;
    }
    c.scan_info = script;
    c.num_scans = n;
  }
  c.write_JFIF_header = iarg(argc, argv, "jfif", c.write_JFIF_header);
  c.write_Adobe_marker = iarg(argc, argv, "adobe", c.write_Adobe_marker);

  jpeg_start_compress(&c, TRUE);
  while (c.next_scanline < c.image_height) {
    unsigned char *row = pix + row_bytes * c.next_scanline;
    if (prec <= 8) {
      jpeg_write_scanlines(&c, &row, 1);
    } else if (prec <= 12) {
      short *r = (short *)row;
      jpeg12_write_scanlines(&c, &r, 1);
    } else {
      unsigned short *r = (unsigned short *)row;
      jpeg16_write_scanlines(&c, &r, 1);
    }
  }
  jpeg_finish_compress(&c);
  jpeg_destroy_compress(&c);
  fclose(out);
  free(pix);
  return 0;
}
