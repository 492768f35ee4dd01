/* Host image decoding for the data path: baseline JPEG and PNG unfiltering.
 *
 * A plain C library with no dependencies, loaded with ctypes by
 * pasta_gan_tpu_torch/data/image_io.py (ctypes releases the interpreter lock
 * for the call, so loader threads decode in parallel).  The JPEG decoder
 * follows libjpeg(-turbo)'s integer arithmetic so that its output equals
 * theirs bit for bit:
 *   - jidctint.c jpeg_idct_islow (CONST_BITS 13, PASS1_BITS 2) and the
 *     post-IDCT range-limit table of jdmaster.c;
 *   - jdsample.c's h2v1 and h2v2 "fancy" (triangle) upsampling, with its
 *     rounding biases and its edge replication at the downsampled size
 *     (plain replication for downsampled widths of 2 or less);
 *   - jdcolor.c's fixed-point YCbCr -> RGB tables (SCALEBITS 16).
 * Supported: SOF0/SOF1 at 8 bits, 1 or 3 components, chroma sampled 1x1,
 * 2x1 or 2x2 against luma, interleaved or single-component scans, DRI/RSTn.
 * Everything else returns an error naming the marker or the reason.
 */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>
#include <stdio.h>

#define ERR(...) (snprintf(err, errlen, __VA_ARGS__), -1)

/* ------------------------------------------------------------ JPEG tables */

static const int kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

#define LOOKAHEAD 9

typedef struct {
  int present;
  uint8_t look_len[1 << LOOKAHEAD]; /* 0: code longer than LOOKAHEAD bits */
  uint8_t look_sym[1 << LOOKAHEAD];
  int32_t maxcode[18]; /* largest code of each length, -1 if none */
  int32_t valoffset[18];
  uint8_t vals[256];
} Huff;

typedef struct {
  int id, h, v, tq;
  int td, ta;               /* table selectors of the current scan */
  int bw, bh;               /* allocated blocks (MCU-padded) */
  int wib, hib;             /* width/height in blocks (jdinput.c) */
  int dw, dh;               /* downsampled width/height */
  int16_t* coef;            /* bw*bh blocks of 64 coefficients, natural order */
  int pred;                 /* DC predictor */
} Comp;

typedef struct {
  const uint8_t* p;
  size_t n, pos;
  uint64_t buf;
  int bits;
  int marker; /* a marker (or the end of data) stops the entropy bytes */
} Bits;

static void fill(Bits* b) {
  while (b->bits <= 56) {
    int byte = 0;
    if (!b->marker) {
      if (b->pos >= b->n) {
        b->marker = 1;
      } else {
        byte = b->p[b->pos++];
        if (byte == 0xFF) {
          if (b->pos < b->n && b->p[b->pos] == 0x00) {
            b->pos++; /* stuffed 0xFF00 */
          } else {
            b->pos--; /* a marker: leave it for the parser, feed zeros */
            b->marker = 1;
            byte = 0;
          }
        }
      }
    }
    b->buf = (b->buf << 8) | (uint64_t)byte;
    b->bits += 8;
  }
}

static inline int getbits(Bits* b, int n) {
  if (n == 0) return 0;
  if (b->bits < n) fill(b);
  b->bits -= n;
  return (int)((b->buf >> b->bits) & ((1u << n) - 1));
}

static inline int extend(int v, int s) { /* HUFF_EXTEND */
  return v < (1 << (s - 1)) ? v + (int)(((unsigned)-1) << s) + 1 : v;
}

static int decode_sym(Bits* b, const Huff* h) {
  if (b->bits < 16) fill(b);
  int peek = (int)((b->buf >> (b->bits - LOOKAHEAD)) & ((1 << LOOKAHEAD) - 1));
  int len = h->look_len[peek];
  if (len) {
    b->bits -= len;
    return h->look_sym[peek];
  }
  int code16 = (int)((b->buf >> (b->bits - 16)) & 0xFFFF);
  for (int l = LOOKAHEAD + 1; l <= 16; l++) {
    int code = code16 >> (16 - l);
    if (code <= h->maxcode[l]) {
      b->bits -= l;
      return h->vals[code + h->valoffset[l]];
    }
  }
  return -1; /* no code of 16 bits or fewer */
}

static int build_huff(Huff* h, const uint8_t* counts, const uint8_t* vals, int nvals) {
  memset(h, 0, sizeof(*h));
  memcpy(h->vals, vals, nvals);
  int code = 0, k = 0;
  for (int l = 1; l <= 16; l++) {
    h->valoffset[l] = k - code;
    for (int i = 0; i < counts[l - 1]; i++, k++, code++) {
      if (l <= LOOKAHEAD) {
        int span = 1 << (LOOKAHEAD - l);
        for (int j = 0; j < span; j++) {
          h->look_len[(code << (LOOKAHEAD - l)) + j] = (uint8_t)l;
          h->look_sym[(code << (LOOKAHEAD - l)) + j] = vals[k];
        }
      }
    }
    h->maxcode[l] = counts[l - 1] ? code - 1 : -1;
    if (code > (1 << l)) return -1; /* over-subscribed code lengths */
    code <<= 1;
  }
  h->maxcode[17] = 0x7FFFFFFF;
  h->present = 1;
  return 0;
}

/* ------------------------------------------------------------ IDCT (jidctint.c) */

#define CONST_BITS 13
#define PASS1_BITS 2
#define FIX_0_298631336 ((int64_t)2446)
#define FIX_0_390180644 ((int64_t)3196)
#define FIX_0_541196100 ((int64_t)4433)
#define FIX_0_765366865 ((int64_t)6270)
#define FIX_0_899976223 ((int64_t)7373)
#define FIX_1_175875602 ((int64_t)9633)
#define FIX_1_501321110 ((int64_t)12299)
#define FIX_1_847759065 ((int64_t)15137)
#define FIX_1_961570560 ((int64_t)16069)
#define FIX_2_053119869 ((int64_t)16819)
#define FIX_2_562915447 ((int64_t)20995)
#define FIX_3_072711026 ((int64_t)25172)
#define DESCALE(x, n) (((x) + ((int64_t)1 << ((n)-1))) >> (n))

static uint8_t idct_limit[1024]; /* jdmaster.c's table as the IDCT indexes it */

static void init_tables(void) {
  static int done = 0;
  if (done) return;
  for (int v = 0; v < 1024; v++) {
    /* index v = x & 1023 of the centered IDCT output x */
    int out;
    if (v < 128) out = v + 128;
    else if (v < 512) out = 255;
    else if (v < 896) out = 0;
    else out = v - 896;
    idct_limit[v] = (uint8_t)out;
  }
  done = 1;
}

static void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out, int stride) {
  int ws[64];
  for (int c = 0; c < 8; c++) {
    const int16_t* ip = in + c;
    const uint16_t* qp = q + c;
    if (ip[8] == 0 && ip[16] == 0 && ip[24] == 0 && ip[32] == 0 && ip[40] == 0 && ip[48] == 0 &&
        ip[56] == 0) {
      int dc = (int)ip[0] * qp[0] * (1 << PASS1_BITS);
      for (int r = 0; r < 8; r++) ws[r * 8 + c] = dc;
      continue;
    }
    int64_t z2 = (int64_t)ip[16] * qp[16], z3 = (int64_t)ip[48] * qp[48];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * (-FIX_1_847759065);
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = (int64_t)ip[0] * qp[0];
    z3 = (int64_t)ip[32] * qp[32];
    int64_t tmp0 = (z2 + z3) * (1 << CONST_BITS);
    int64_t tmp1 = (z2 - z3) * (1 << CONST_BITS);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = (int64_t)ip[56] * qp[56];
    tmp1 = (int64_t)ip[40] * qp[40];
    tmp2 = (int64_t)ip[24] * qp[24];
    tmp3 = (int64_t)ip[8] * qp[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 = tmp0 * FIX_0_298631336;
    tmp1 = tmp1 * FIX_2_053119869;
    tmp2 = tmp2 * FIX_3_072711026;
    tmp3 = tmp3 * FIX_1_501321110;
    z1 = z1 * (-FIX_0_899976223);
    z2 = z2 * (-FIX_2_562915447);
    z3 = z3 * (-FIX_1_961570560);
    z4 = z4 * (-FIX_0_390180644);
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    ws[0 * 8 + c] = (int)DESCALE(tmp10 + tmp3, CONST_BITS - PASS1_BITS);
    ws[7 * 8 + c] = (int)DESCALE(tmp10 - tmp3, CONST_BITS - PASS1_BITS);
    ws[1 * 8 + c] = (int)DESCALE(tmp11 + tmp2, CONST_BITS - PASS1_BITS);
    ws[6 * 8 + c] = (int)DESCALE(tmp11 - tmp2, CONST_BITS - PASS1_BITS);
    ws[2 * 8 + c] = (int)DESCALE(tmp12 + tmp1, CONST_BITS - PASS1_BITS);
    ws[5 * 8 + c] = (int)DESCALE(tmp12 - tmp1, CONST_BITS - PASS1_BITS);
    ws[3 * 8 + c] = (int)DESCALE(tmp13 + tmp0, CONST_BITS - PASS1_BITS);
    ws[4 * 8 + c] = (int)DESCALE(tmp13 - tmp0, CONST_BITS - PASS1_BITS);
  }
  for (int r = 0; r < 8; r++) {
    const int* w = ws + r * 8;
    uint8_t* o = out + r * stride;
    if (w[1] == 0 && w[2] == 0 && w[3] == 0 && w[4] == 0 && w[5] == 0 && w[6] == 0 && w[7] == 0) {
      uint8_t dc = idct_limit[(int)DESCALE((int64_t)w[0], PASS1_BITS + 3) & 1023];
      for (int c = 0; c < 8; c++) o[c] = dc;
      continue;
    }
    int64_t z2 = w[2], z3 = w[6];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * (-FIX_1_847759065);
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    int64_t tmp0 = ((int64_t)w[0] + w[4]) * (1 << CONST_BITS);
    int64_t tmp1 = ((int64_t)w[0] - w[4]) * (1 << CONST_BITS);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = w[7];
    tmp1 = w[5];
    tmp2 = w[3];
    tmp3 = w[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 = tmp0 * FIX_0_298631336;
    tmp1 = tmp1 * FIX_2_053119869;
    tmp2 = tmp2 * FIX_3_072711026;
    tmp3 = tmp3 * FIX_1_501321110;
    z1 = z1 * (-FIX_0_899976223);
    z2 = z2 * (-FIX_2_562915447);
    z3 = z3 * (-FIX_1_961570560);
    z4 = z4 * (-FIX_0_390180644);
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int n = CONST_BITS + PASS1_BITS + 3;
    o[0] = idct_limit[(int)DESCALE(tmp10 + tmp3, n) & 1023];
    o[7] = idct_limit[(int)DESCALE(tmp10 - tmp3, n) & 1023];
    o[1] = idct_limit[(int)DESCALE(tmp11 + tmp2, n) & 1023];
    o[6] = idct_limit[(int)DESCALE(tmp11 - tmp2, n) & 1023];
    o[2] = idct_limit[(int)DESCALE(tmp12 + tmp1, n) & 1023];
    o[5] = idct_limit[(int)DESCALE(tmp12 - tmp1, n) & 1023];
    o[3] = idct_limit[(int)DESCALE(tmp13 + tmp0, n) & 1023];
    o[4] = idct_limit[(int)DESCALE(tmp13 - tmp0, n) & 1023];
  }
}

/* ------------------------------------------------------------ JPEG parser */

typedef struct {
  int w, h, ncomp, hmax, vmax, restart, adobe, adobe_transform, jfif;
  int seen_sof;
  uint16_t q[4][64]; /* natural order */
  int q_present[4];
  Huff dc[4], ac[4];
  Comp comp[3];
  int mcux, mcuy;
} Jpeg;

static int rd16(const uint8_t* p) { return (p[0] << 8) | p[1]; }

static const char* sof_name(int m) {
  switch (m) {
    case 0xC2: return "SOF2 (progressive)";
    case 0xC3: return "SOF3 (lossless)";
    case 0xC5: return "SOF5 (differential sequential)";
    case 0xC6: return "SOF6 (differential progressive)";
    case 0xC7: return "SOF7 (differential lossless)";
    case 0xC9: return "SOF9 (arithmetic sequential)";
    case 0xCA: return "SOF10 (arithmetic progressive)";
    case 0xCB: return "SOF11 (arithmetic lossless)";
    case 0xCD: return "SOF13 (arithmetic differential sequential)";
    case 0xCE: return "SOF14 (arithmetic differential progressive)";
    case 0xCF: return "SOF15 (arithmetic differential lossless)";
    default: return "SOF";
  }
}

static int parse_sof(Jpeg* j, const uint8_t* s, int len, char* err, int errlen) {
  if (len < 6) return ERR("SOF segment too short");
  if (s[0] != 8) return ERR("SOF0/1 with %d-bit precision (only 8-bit is supported)", s[0]);
  j->h = rd16(s + 1);
  j->w = rd16(s + 3);
  j->ncomp = s[5];
  if (j->w <= 0 || j->h <= 0) return ERR("SOF with an image size of %dx%d (DNL is not supported)", j->w, j->h);
  if (j->ncomp != 1 && j->ncomp != 3)
    return ERR("SOF with %d components (only 1 and 3 are supported)", j->ncomp);
  if (len < 6 + 3 * j->ncomp) return ERR("SOF segment too short");
  j->hmax = j->vmax = 1;
  for (int i = 0; i < j->ncomp; i++) {
    Comp* c = &j->comp[i];
    c->id = s[6 + 3 * i];
    c->h = s[7 + 3 * i] >> 4;
    c->v = s[7 + 3 * i] & 15;
    c->tq = s[8 + 3 * i];
    if (c->h < 1 || c->h > 4 || c->v < 1 || c->v > 4 || c->tq > 3) return ERR("bad SOF component");
    if (c->h > j->hmax) j->hmax = c->h;
    if (c->v > j->vmax) j->vmax = c->v;
  }
  if (j->ncomp == 1) j->comp[0].h = j->comp[0].v = j->hmax = j->vmax = 1;
  for (int i = 0; i < j->ncomp; i++) {
    Comp* c = &j->comp[i];
    int fh = j->hmax / c->h, fv = j->vmax / c->v;
    if (fh * c->h != j->hmax || fv * c->v != j->vmax || !((fh == 1 && fv == 1) || (fh == 2 && fv == 1) || (fh == 2 && fv == 2)))
      return ERR("component %d sampled %dx%d against %dx%d (only 1x1, 2x1 and 2x2 upsampling are supported)",
                 i, c->h, c->v, j->hmax, j->vmax);
  }
  j->mcux = (j->w + 8 * j->hmax - 1) / (8 * j->hmax);
  j->mcuy = (j->h + 8 * j->vmax - 1) / (8 * j->vmax);
  for (int i = 0; i < j->ncomp; i++) {
    Comp* c = &j->comp[i];
    c->wib = (int)(((int64_t)j->w * c->h + 8 * j->hmax - 1) / (8 * j->hmax));
    c->hib = (int)(((int64_t)j->h * c->v + 8 * j->vmax - 1) / (8 * j->vmax));
    c->dw = (int)(((int64_t)j->w * c->h + j->hmax - 1) / j->hmax);
    c->dh = (int)(((int64_t)j->h * c->v + j->vmax - 1) / j->vmax);
    c->bw = j->mcux * c->h;
    c->bh = j->mcuy * c->v;
  }
  j->seen_sof = 1;
  return 0;
}

static int decode_block(Bits* b, Comp* c, const Jpeg* j, int16_t* blk, char* err, int errlen) {
  int s = decode_sym(b, &j->dc[c->td]);
  if (s < 0 || s > 11) return ERR("bad Huffman code in a DC coefficient");
  int diff = s ? extend(getbits(b, s), s) : 0;
  c->pred += diff;
  blk[0] = (int16_t)c->pred;
  for (int k = 1; k < 64;) {
    int rs = decode_sym(b, &j->ac[c->ta]);
    if (rs < 0) return ERR("bad Huffman code in an AC coefficient");
    int r = rs >> 4, sz = rs & 15;
    if (sz == 0) {
      if (r != 15) break; /* EOB */
      k += 16;            /* ZRL */
      continue;
    }
    k += r;
    if (k > 63) return ERR("AC coefficient index past 63");
    blk[kZigzag[k]] = (int16_t)extend(getbits(b, sz), sz);
    k++;
  }
  return 0;
}

/* Find the next marker at or after `pos`; returns its position (of the 0xFF) or n. */
static size_t next_marker(const uint8_t* p, size_t n, size_t pos) {
  while (pos + 1 < n) {
    if (p[pos] == 0xFF && p[pos + 1] != 0x00 && p[pos + 1] != 0xFF) return pos;
    pos++;
  }
  return n;
}

static int decode_scan(Jpeg* j, const uint8_t* data, size_t n, size_t* pos, const uint8_t* s, int len,
                       char* err, int errlen) {
  if (!j->seen_sof) return ERR("SOS before SOF");
  int ns = s[0];
  if (ns < 1 || ns > j->ncomp || len < 1 + 2 * ns + 3) return ERR("bad SOS segment");
  Comp* sc[3];
  for (int i = 0; i < ns; i++) {
    int id = s[1 + 2 * i], k;
    for (k = 0; k < j->ncomp && j->comp[k].id != id; k++) {}
    if (k == j->ncomp) return ERR("SOS names an unknown component %d", id);
    sc[i] = &j->comp[k];
    sc[i]->td = s[2 + 2 * i] >> 4;
    sc[i]->ta = s[2 + 2 * i] & 15;
    if (sc[i]->td > 3 || sc[i]->ta > 3 || !j->dc[sc[i]->td].present || !j->ac[sc[i]->ta].present)
      return ERR("SOS uses a Huffman table that was not defined");
    if (!j->q_present[sc[i]->tq]) return ERR("a component uses a quantization table that was not defined");
    sc[i]->pred = 0;
  }
  int ss = s[1 + 2 * ns], se = s[2 + 2 * ns], ahal = s[3 + 2 * ns];
  if (ss != 0 || se != 63 || ahal != 0) return ERR("SOS with spectral selection %d..%d (not a sequential scan)", ss, se);

  Bits b = {data, n, *pos, 0, 0, 0};
  int nx, ny;
  if (ns == 1) { /* non-interleaved: one block per MCU over the component's own blocks */
    nx = sc[0]->wib;
    ny = sc[0]->hib;
  } else {
    nx = j->mcux;
    ny = j->mcuy;
  }
  int total = nx * ny, left = j->restart, next_rst = 0;
  for (int m = 0; m < total; m++) {
    if (j->restart && left == 0) {
      /* byte-align, find RSTn, reset the DC predictors */
      size_t at = next_marker(data, n, b.pos);
      if (at + 1 >= n || data[at + 1] != 0xD0 + next_rst)
        return ERR("expected RST%d after %d MCUs", next_rst, j->restart);
      b.pos = at + 2;
      b.buf = 0;
      b.bits = 0;
      b.marker = 0;
      next_rst = (next_rst + 1) & 7;
      for (int i = 0; i < ns; i++) sc[i]->pred = 0;
      left = j->restart;
    }
    int mx = m % nx, my = m / nx;
    if (ns == 1) {
      if (decode_block(&b, sc[0], j, sc[0]->coef + ((size_t)my * sc[0]->bw + mx) * 64, err, errlen)) return -1;
    } else {
      for (int i = 0; i < ns; i++) {
        Comp* c = sc[i];
        for (int v = 0; v < c->v; v++)
          for (int h = 0; h < c->h; h++) {
            size_t bi = (size_t)(my * c->v + v) * c->bw + (mx * c->h + h);
            if (decode_block(&b, c, j, c->coef + bi * 64, err, errlen)) return -1;
          }
      }
    }
    if (j->restart) left--;
  }
  *pos = next_marker(data, n, b.pos);
  return 0;
}

/* Parse the whole stream; decodes coefficients when `decode` is set. */
static int parse(Jpeg* j, const uint8_t* data, size_t n, int decode, char* err, int errlen) {
  memset(j, 0, sizeof(*j));
  if (n < 4 || data[0] != 0xFF || data[1] != 0xD8) return ERR("not a JPEG file (no SOI marker)");
  size_t pos = 2;
  int scans = 0;
  for (;;) {
    while (pos < n && data[pos] != 0xFF) pos++; /* garbage between segments */
    while (pos < n && data[pos] == 0xFF) pos++; /* fill bytes */
    if (pos >= n) return ERR("no EOI marker before the end of the file");
    int m = data[pos++];
    if (m == 0xD9) return scans ? 0 : ERR("no SOF or SOS marker before EOI");
    if (m >= 0xD0 && m <= 0xD7) continue; /* stray RSTn */
    if (m == 0x01) continue;              /* TEM */
    if (pos + 2 > n) return ERR("truncated marker segment");
    int len = rd16(data + pos);
    if (len < 2 || pos + len > n) return ERR("truncated marker segment 0x%02X", m);
    const uint8_t* s = data + pos + 2;
    int sl = len - 2;
    pos += len;
    if (m == 0xC0 || m == 0xC1) {
      if (j->seen_sof) return ERR("a second SOF marker");
      if (parse_sof(j, s, sl, err, errlen)) return -1;
      if (!decode) return 0;
      for (int i = 0; i < j->ncomp; i++) {
        j->comp[i].coef = (int16_t*)calloc((size_t)j->comp[i].bw * j->comp[i].bh * 64, sizeof(int16_t));
        if (!j->comp[i].coef) return ERR("out of memory");
      }
    } else if ((m >= 0xC2 && m <= 0xCF && m != 0xC4 && m != 0xC8 && m != 0xCC)) {
      return ERR("%s marker 0x%02X: only baseline and extended sequential Huffman JPEG is supported", sof_name(m), m);
    } else if (m == 0xCC) {
      return ERR("DAC marker 0xCC: arithmetic coding is not supported");
    } else if (m == 0xC4) { /* DHT */
      int o = 0;
      while (o < sl) {
        if (o + 17 > sl) return ERR("bad DHT segment");
        int tc = s[o] >> 4, th = s[o] & 15, cnt = 0;
        for (int i = 0; i < 16; i++) cnt += s[o + 1 + i];
        if (tc > 1 || th > 3 || cnt > 256 || o + 17 + cnt > sl) return ERR("bad DHT segment");
        Huff* h = tc ? &j->ac[th] : &j->dc[th];
        if (build_huff(h, s + o + 1, s + o + 17, cnt)) return ERR("bad Huffman table");
        o += 17 + cnt;
      }
    } else if (m == 0xDB) { /* DQT */
      int o = 0;
      while (o < sl) {
        int pq = s[o] >> 4, tq = s[o] & 15;
        if (tq > 3 || pq > 1 || o + 1 + 64 * (pq + 1) > sl) return ERR("bad DQT segment");
        for (int k = 0; k < 64; k++)
          j->q[tq][kZigzag[k]] = pq ? (uint16_t)rd16(s + o + 1 + 2 * k) : s[o + 1 + k];
        j->q_present[tq] = 1;
        o += 1 + 64 * (pq + 1);
      }
    } else if (m == 0xDD) { /* DRI */
      if (sl < 2) return ERR("bad DRI segment");
      j->restart = rd16(s);
    } else if (m == 0xDA) { /* SOS */
      if (decode_scan(j, data, n, &pos, s, sl, err, errlen)) return -1;
      scans++;
    } else if (m == 0xEE) { /* APP14: Adobe */
      if (sl >= 12 && memcmp(s, "Adobe", 5) == 0) {
        j->adobe = 1;
        j->adobe_transform = s[11];
      }
    } else if (m == 0xE0) { /* APP0: JFIF */
      if (sl >= 5 && memcmp(s, "JFIF\0", 5) == 0) j->jfif = 1;
    } else if (m == 0xDC) {
      return ERR("DNL marker 0xDC is not supported");
    }
    /* other APPn, COM, JPG extensions: skipped */
  }
}

static void free_jpeg(Jpeg* j) {
  for (int i = 0; i < 3; i++) {
    free(j->comp[i].coef);
    j->comp[i].coef = NULL;
  }
}

/* jdcolor.c: the colour space the file is in (1: YCbCr, 0: RGB as stored). */
static int is_ycc(const Jpeg* j) {
  if (j->jfif) return 1;
  if (j->adobe) return j->adobe_transform != 0;
  if (j->comp[0].id == 'R' && j->comp[1].id == 'G' && j->comp[2].id == 'B') return 0;
  return 1;
}

/* Header only: size and output channels (1 grey, 3 RGB). */
int pasta_jpeg_info(const uint8_t* data, size_t n, int* w, int* h, int* channels, char* err, int errlen) {
  Jpeg j;
  int rc = parse(&j, data, n, 0, err, errlen);
  if (rc) return rc;
  *w = j.w;
  *h = j.h;
  *channels = j.ncomp;
  return 0;
}

/* jdsample.c upsampling of one component plane (stride ps) into a full-size
 * plane (stride os) of at least (fh*dw) x (fv*dh) samples: "fancy" (triangle)
 * upsampling, or plain replication where the downsampled width is 2 or less
 * (jinit_upsampler's rule). */
static void upsample(const uint8_t* in, int ps, int dw, int dh, int fh, int fv, uint8_t* out, int os) {
  if ((fh == 1 && fv == 1) || dw <= 2) {
    for (int y = 0; y < dh * fv; y++) {
      const uint8_t* ip = in + (size_t)(y / fv) * ps;
      uint8_t* op = out + (size_t)y * os;
      for (int x = 0; x < dw * fh; x++) op[x] = ip[x / fh];
    }
    return;
  }
  if (fv == 1) { /* h2v1 */
    for (int y = 0; y < dh; y++) {
      const uint8_t* ip = in + (size_t)y * ps;
      uint8_t* op = out + (size_t)y * os;
      int v = ip[0];
      op[0] = (uint8_t)v;
      op[1] = (uint8_t)((v * 3 + ip[1] + 2) >> 2);
      for (int x = 1; x < dw - 1; x++) {
        v = ip[x] * 3;
        op[2 * x] = (uint8_t)((v + ip[x - 1] + 1) >> 2);
        op[2 * x + 1] = (uint8_t)((v + ip[x + 1] + 2) >> 2);
      }
      v = ip[dw - 1];
      op[2 * dw - 2] = (uint8_t)((v * 3 + ip[dw - 2] + 1) >> 2);
      op[2 * dw - 1] = (uint8_t)v;
    }
    return;
  }
  /* h2v2: each input row gives two output rows, mixed with the row above
   * and the row below; rows outside [0, dh) repeat the edge row */
  for (int y = 0; y < dh; y++) {
    for (int half = 0; half < 2; half++) {
      int yn = half ? (y + 1 < dh ? y + 1 : dh - 1) : (y > 0 ? y - 1 : 0);
      const uint8_t* i0 = in + (size_t)y * ps;
      const uint8_t* i1 = in + (size_t)yn * ps;
      uint8_t* op = out + (size_t)(2 * y + half) * os;
      int this_sum = i0[0] * 3 + i1[0];
      int next_sum = i0[1] * 3 + i1[1];
      op[0] = (uint8_t)((this_sum * 4 + 8) >> 4);
      op[1] = (uint8_t)((this_sum * 3 + next_sum + 7) >> 4);
      int last_sum = this_sum;
      this_sum = next_sum;
      for (int x = 1; x < dw - 1; x++) {
        next_sum = i0[x + 1] * 3 + i1[x + 1];
        op[2 * x] = (uint8_t)((this_sum * 3 + last_sum + 8) >> 4);
        op[2 * x + 1] = (uint8_t)((this_sum * 3 + next_sum + 7) >> 4);
        last_sum = this_sum;
        this_sum = next_sum;
      }
      op[2 * dw - 2] = (uint8_t)((this_sum * 3 + last_sum + 8) >> 4);
      op[2 * dw - 1] = (uint8_t)((this_sum * 4 + 7) >> 4);
    }
  }
}

/* Decode into out [h, w, channels] (channels as pasta_jpeg_info gives). */
int pasta_jpeg_decode(const uint8_t* data, size_t n, uint8_t* out, char* err, int errlen) {
  Jpeg j;
  init_tables();
  int rc = parse(&j, data, n, 1, err, errlen);
  if (rc) {
    free_jpeg(&j);
    return rc;
  }
  uint8_t* planes[3] = {NULL, NULL, NULL};
  int full_w = j.mcux * j.hmax * 8, full_h = j.mcuy * j.vmax * 8;
  for (int i = 0; i < j.ncomp; i++) {
    Comp* c = &j.comp[i];
    int pw = c->bw * 8;
    uint8_t* plane = (uint8_t*)malloc((size_t)pw * c->bh * 8);
    planes[i] = (uint8_t*)malloc((size_t)full_w * full_h);
    if (!plane || !planes[i]) {
      free(plane);
      for (int k = 0; k < 3; k++) free(planes[k]);
      free_jpeg(&j);
      return ERR("out of memory");
    }
    const uint16_t* q = j.q[c->tq];
    for (int by = 0; by < c->bh; by++)
      for (int bx = 0; bx < c->bw; bx++)
        idct_islow(c->coef + ((size_t)by * c->bw + bx) * 64, q, plane + (size_t)by * 8 * pw + bx * 8, pw);
    upsample(plane, pw, c->dw, c->dh, j.hmax / c->h, j.vmax / c->v, planes[i], full_w);
    free(plane);
  }
  if (j.ncomp == 1) {
    for (int y = 0; y < j.h; y++) memcpy(out + (size_t)y * j.w, planes[0] + (size_t)y * full_w, j.w);
  } else if (!is_ycc(&j)) {
    for (int y = 0; y < j.h; y++)
      for (int x = 0; x < j.w; x++)
        for (int k = 0; k < 3; k++) out[((size_t)y * j.w + x) * 3 + k] = planes[k][(size_t)y * full_w + x];
  } else {
    /* jdcolor.c build_ycc_rgb_table, ycc_rgb_convert */
    static int cr_r[256], cb_b[256];
    static int64_t cr_g[256], cb_g[256];
    static int tables = 0;
    const int64_t one_half = (int64_t)1 << 15;
    if (!tables) {
      for (int i = 0, x = -128; i < 256; i++, x++) {
        cr_r[i] = (int)((91881 * (int64_t)x + one_half) >> 16);  /* FIX(1.40200) */
        cb_b[i] = (int)((116130 * (int64_t)x + one_half) >> 16); /* FIX(1.77200) */
        cr_g[i] = -46802 * (int64_t)x;                           /* -FIX(0.71414) */
        cb_g[i] = -22554 * (int64_t)x + one_half;                /* -FIX(0.34414) */
      }
      tables = 1;
    }
    for (int y = 0; y < j.h; y++) {
      const uint8_t *py = planes[0] + (size_t)y * full_w, *pb = planes[1] + (size_t)y * full_w,
                    *pr = planes[2] + (size_t)y * full_w;
      uint8_t* o = out + (size_t)y * j.w * 3;
      for (int x = 0; x < j.w; x++) {
        int Y = py[x], cb = pb[x], cr = pr[x];
        int r = Y + cr_r[cr], g = Y + (int)((cb_g[cb] + cr_g[cr]) >> 16), bl = Y + cb_b[cb];
        o[3 * x] = (uint8_t)(r < 0 ? 0 : r > 255 ? 255 : r);
        o[3 * x + 1] = (uint8_t)(g < 0 ? 0 : g > 255 ? 255 : g);
        o[3 * x + 2] = (uint8_t)(bl < 0 ? 0 : bl > 255 ? 255 : bl);
      }
    }
  }
  for (int k = 0; k < 3; k++) free(planes[k]);
  free_jpeg(&j);
  return 0;
}

/* ------------------------------------------------------------ PNG unfiltering */

/* raw: h rows of (1 filter byte + rowbytes); out: h * rowbytes.  bpp is the
 * filter's byte distance (bytes per complete pixel, at least 1). */
int pasta_png_unfilter(const uint8_t* raw, int h, int rowbytes, int bpp, uint8_t* out, char* err, int errlen) {
  const uint8_t* prev = NULL;
  for (int y = 0; y < h; y++) {
    const uint8_t* in = raw + (size_t)y * (rowbytes + 1);
    uint8_t* o = out + (size_t)y * rowbytes;
    int f = *in++;
    for (int x = 0; x < rowbytes; x++) {
      int a = x >= bpp ? o[x - bpp] : 0;
      int b = prev ? prev[x] : 0;
      int c = (prev && x >= bpp) ? prev[x - bpp] : 0;
      int v;
      switch (f) {
        case 0: v = 0; break;
        case 1: v = a; break;
        case 2: v = b; break;
        case 3: v = (a + b) >> 1; break;
        case 4: {
          int p = a + b - c, pa = abs(p - a), pb = abs(p - b), pc = abs(p - c);
          v = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          break;
        }
        default: return ERR("PNG row %d has filter type %d (0-4 are defined)", y, f);
      }
      o[x] = (uint8_t)(in[x] + v);
    }
    prev = o;
  }
  return 0;
}
