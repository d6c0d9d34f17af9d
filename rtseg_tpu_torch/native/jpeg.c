/* A JPEG decoder that gives, integer for integer, what libjpeg(-turbo)'s
 * default decompression gives (the decode behind PIL's
 * Image.open(f).convert('RGB')), called through ctypes from data/jpeg.py.
 *
 *   frames      SOF0 (baseline), SOF1 (extended sequential) and SOF2
 *               (progressive) Huffman frames of 8-bit samples with 1 (gray)
 *               or 3 components; DQT with 8- and 16-bit tables, DHT, DRI,
 *               SOS, RST0-7, APPn and COM (skipped, but APP0 "JFIF" and
 *               APP14 "Adobe" are read for the colour space), EOI
 *   entropy     sequential Huffman; progressive DC first / refine and AC
 *               first / refine with EOB runs; every coefficient of the image
 *               is kept, then goes through the IDCT once
 *   restarts    the DC predictors and the EOB run are reset at each RSTn
 *   IDCT        dequantize + libjpeg's JDCT_ISLOW (jidctint.c: CONST_BITS
 *               13, PASS1_BITS 2, its descale rounding, its range-limit
 *               table, wraparound included)
 *   upsampling  jdsample.c's fancy (triangle) upsampling for a component
 *               whose factors are 1 or 2 times smaller than the largest:
 *               h2v1 and h2v2 when its downsampled width is above 2 (else
 *               the box filter), h1v2 always; edge samples replicated at
 *               the component's own downsampled width and height
 *   colour      jdcolor.c's fixed-point YCbCr -> RGB tables; RGB-coded
 *               frames (Adobe transform 0, or ids 'R','G','B') are copied;
 *               gray is replicated to RGB
 *
 * Errors: a truncated or corrupt stream returns JPEG_CORRUPT; arithmetic
 * coding, lossless and hierarchical frames, 12-bit samples, 2- and
 * 4-component frames and other sampling factors return JPEG_UNSUPPORTED.
 * Each entry point writes a message into `err`.
 *
 * The pixel stages are exported one by one (jpeg_idct_islow_blocks,
 * jpeg_upsample, jpeg_color) and the whole decode is made of them, so that
 * their numpy versions in data/jpeg.py hold them bit for bit.
 */

#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#define JPEG_OK 0
#define JPEG_CORRUPT -1
#define JPEG_UNSUPPORTED -2
#define JPEG_NOMEM -3

/* zigzag index -> natural index; entries past 63 catch a run that overshoots
 * the block in a corrupt stream (jpeg_natural_order of jutils.c) */
static const int natural_order[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

/* ------------------------------------------------------------ pixel stages */

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
#define DESCALE(x, n) (((x) + ((int64_t)1 << ((n) - 1))) >> (n))

/* libjpeg's post-IDCT range limit: the descaled value v (centred on 0)
 * indexes a 1024-entry table by v & 1023 */
static uint8_t idct_limit[1024];
static int limit_ready = 0;

static void init_limit(void) {
    if (limit_ready)
        return;
    for (int i = 0; i < 1024; ++i) {
        int v;
        if (i < 128)
            v = i + 128;
        else if (i < 512)
            v = 255;
        else if (i < 896)
            v = 0;
        else
            v = i - 896;
        idct_limit[i] = (uint8_t)v;
    }
    limit_ready = 1;
}

static void idct_islow(const int16_t *in, const uint16_t *q, uint8_t *out,
                       long stride) {
    int ws[64];
    for (int c = 0; c < 8; ++c) {
        const int16_t *ip = in + c;
        const uint16_t *qp = q + c;
        int *wp = ws + c;
        if (ip[8] == 0 && ip[16] == 0 && ip[24] == 0 && ip[32] == 0 &&
            ip[40] == 0 && ip[48] == 0 && ip[56] == 0) {
            int dc = (int)((int64_t)ip[0] * qp[0] * (1 << PASS1_BITS));
            for (int r = 0; r < 8; ++r)
                wp[8 * r] = dc;
            continue;
        }
        int64_t z1, z2, z3, z4, z5, t0, t1, t2, t3, t10, t11, t12, t13;
        z2 = (int64_t)ip[16] * qp[16];
        z3 = (int64_t)ip[48] * qp[48];
        z1 = (z2 + z3) * FIX_0_541196100;
        t2 = z1 + z3 * (-FIX_1_847759065);
        t3 = z1 + z2 * FIX_0_765366865;
        z2 = (int64_t)ip[0] * qp[0];
        z3 = (int64_t)ip[32] * qp[32];
        t0 = (z2 + z3) * (1 << CONST_BITS);
        t1 = (z2 - z3) * (1 << CONST_BITS);
        t10 = t0 + t3;
        t13 = t0 - t3;
        t11 = t1 + t2;
        t12 = t1 - t2;
        t0 = (int64_t)ip[56] * qp[56];
        t1 = (int64_t)ip[40] * qp[40];
        t2 = (int64_t)ip[24] * qp[24];
        t3 = (int64_t)ip[8] * qp[8];
        z1 = t0 + t3;
        z2 = t1 + t2;
        z3 = t0 + t2;
        z4 = t1 + t3;
        z5 = (z3 + z4) * FIX_1_175875602;
        t0 = t0 * FIX_0_298631336;
        t1 = t1 * FIX_2_053119869;
        t2 = t2 * FIX_3_072711026;
        t3 = t3 * FIX_1_501321110;
        z1 = z1 * (-FIX_0_899976223);
        z2 = z2 * (-FIX_2_562915447);
        z3 = z3 * (-FIX_1_961570560);
        z4 = z4 * (-FIX_0_390180644);
        z3 += z5;
        z4 += z5;
        t0 += z1 + z3;
        t1 += z2 + z4;
        t2 += z2 + z3;
        t3 += z1 + z4;
        wp[0] = (int)DESCALE(t10 + t3, CONST_BITS - PASS1_BITS);
        wp[56] = (int)DESCALE(t10 - t3, CONST_BITS - PASS1_BITS);
        wp[8] = (int)DESCALE(t11 + t2, CONST_BITS - PASS1_BITS);
        wp[48] = (int)DESCALE(t11 - t2, CONST_BITS - PASS1_BITS);
        wp[16] = (int)DESCALE(t12 + t1, CONST_BITS - PASS1_BITS);
        wp[40] = (int)DESCALE(t12 - t1, CONST_BITS - PASS1_BITS);
        wp[24] = (int)DESCALE(t13 + t0, CONST_BITS - PASS1_BITS);
        wp[32] = (int)DESCALE(t13 - t0, CONST_BITS - PASS1_BITS);
    }
    for (int r = 0; r < 8; ++r) {
        const int *wp = ws + 8 * r;
        uint8_t *op = out + r * stride;
        if (wp[1] == 0 && wp[2] == 0 && wp[3] == 0 && wp[4] == 0 &&
            wp[5] == 0 && wp[6] == 0 && wp[7] == 0) {
            uint8_t v = idct_limit[(int)DESCALE((int64_t)wp[0],
                                                PASS1_BITS + 3) & 1023];
            memset(op, v, 8);
            continue;
        }
        int64_t z1, z2, z3, z4, z5, t0, t1, t2, t3, t10, t11, t12, t13;
        z2 = wp[2];
        z3 = wp[6];
        z1 = (z2 + z3) * FIX_0_541196100;
        t2 = z1 + z3 * (-FIX_1_847759065);
        t3 = z1 + z2 * FIX_0_765366865;
        t0 = ((int64_t)wp[0] + wp[4]) * (1 << CONST_BITS);
        t1 = ((int64_t)wp[0] - wp[4]) * (1 << CONST_BITS);
        t10 = t0 + t3;
        t13 = t0 - t3;
        t11 = t1 + t2;
        t12 = t1 - t2;
        t0 = wp[7];
        t1 = wp[5];
        t2 = wp[3];
        t3 = wp[1];
        z1 = t0 + t3;
        z2 = t1 + t2;
        z3 = t0 + t2;
        z4 = t1 + t3;
        z5 = (z3 + z4) * FIX_1_175875602;
        t0 = t0 * FIX_0_298631336;
        t1 = t1 * FIX_2_053119869;
        t2 = t2 * FIX_3_072711026;
        t3 = t3 * FIX_1_501321110;
        z1 = z1 * (-FIX_0_899976223);
        z2 = z2 * (-FIX_2_562915447);
        z3 = z3 * (-FIX_1_961570560);
        z4 = z4 * (-FIX_0_390180644);
        z3 += z5;
        z4 += z5;
        t0 += z1 + z3;
        t1 += z2 + z4;
        t2 += z2 + z3;
        t3 += z1 + z4;
#define OUT(x) idct_limit[(int)DESCALE(x, CONST_BITS + PASS1_BITS + 3) & 1023]
        op[0] = OUT(t10 + t3);
        op[7] = OUT(t10 - t3);
        op[1] = OUT(t11 + t2);
        op[6] = OUT(t11 - t2);
        op[2] = OUT(t12 + t1);
        op[5] = OUT(t12 - t1);
        op[3] = OUT(t13 + t0);
        op[4] = OUT(t13 - t0);
#undef OUT
    }
}

/* (bh*8, bw*8) samples from bh*bw blocks of 64 quantized coefficients in
 * natural order and their 64-entry quantization table */
void jpeg_idct_islow_blocks(const int16_t *coef, const uint16_t *qt, long bh,
                            long bw, uint8_t *plane) {
    init_limit();
    long stride = bw * 8;
    for (long by = 0; by < bh; ++by)
        for (long bx = 0; bx < bw; ++bx)
            idct_islow(coef + (by * bw + bx) * 64, qt,
                       plane + by * 8 * stride + bx * 8, stride);
}

/* The (oh, ow) top-left of a (dh, dw) plane upsampled by (hr, vr) in
 * {1, 2}^2, the way jdsample.c does it: h2v1 and h2v2 fancy when dw > 2
 * (box otherwise), h1v2 fancy always. `in` rows are `in_stride` apart;
 * oh <= dh * vr and ow <= dw * hr. `sums` holds dw ints. */
static void upsample(const uint8_t *in, long in_stride, long dh, long dw,
                     int hr, int vr, uint8_t *out, long oh, long ow,
                     int *sums) {
    int fancy_h = dw > 2;
    for (long y = 0; y < oh; ++y) {
        long r = y / vr;
        const uint8_t *row = in + r * in_stride;
        uint8_t *o = out + y * ow;
        if (hr == 1 && vr == 1) {
            memcpy(o, row, (size_t)ow);
            continue;
        }
        if (hr == 1) {                 /* h1v2: fancy always */
            int odd = (int)(y & 1);
            long other = odd ? (r + 1 < dh ? r + 1 : dh - 1)
                             : (r > 0 ? r - 1 : 0);
            const uint8_t *orow = in + other * in_stride;
            int bias = odd ? 2 : 1;
            for (long x = 0; x < ow; ++x)
                o[x] = (uint8_t)((row[x] * 3 + orow[x] + bias) >> 2);
            continue;
        }
        if (!fancy_h) {                /* box filter, both directions */
            for (long x = 0; x < ow; ++x)
                o[x] = row[x >> 1];
            continue;
        }
        if (vr == 1) {                 /* h2v1 */
            for (long x = 0; x < ow; ++x) {
                long c = x >> 1;
                int t = row[c] * 3;
                if (x & 1)
                    o[x] = (uint8_t)((t + row[c + 1 < dw ? c + 1 : c] + 2) >> 2);
                else
                    o[x] = (uint8_t)((t + row[c > 0 ? c - 1 : 0] + 1) >> 2);
            }
            continue;
        }
        /* h2v2: column sums with the nearer row 3x, then across */
        int odd = (int)(y & 1);
        long other = odd ? (r + 1 < dh ? r + 1 : dh - 1) : (r > 0 ? r - 1 : 0);
        const uint8_t *orow = in + other * in_stride;
        for (long c = 0; c < dw; ++c)
            sums[c] = row[c] * 3 + orow[c];
        for (long x = 0; x < ow; ++x) {
            long c = x >> 1;
            int t = sums[c] * 3;
            if (x & 1)
                o[x] = (uint8_t)((t + sums[c + 1 < dw ? c + 1 : c] + 7) >> 4);
            else
                o[x] = (uint8_t)((t + sums[c > 0 ? c - 1 : 0] + 8) >> 4);
        }
    }
}

/* Exported form of the upsampler; returns JPEG_UNSUPPORTED for factors
 * outside {1, 2}, JPEG_NOMEM if the row of sums cannot be had. */
int jpeg_upsample(const uint8_t *in, long in_stride, long dh, long dw, int hr,
                  int vr, uint8_t *out, long oh, long ow) {
    if (hr < 1 || hr > 2 || vr < 1 || vr > 2)
        return JPEG_UNSUPPORTED;
    int *sums = malloc(sizeof(int) * (size_t)(dw > 0 ? dw : 1));
    if (!sums)
        return JPEG_NOMEM;
    upsample(in, in_stride, dh, dw, hr, vr, out, oh, ow, sums);
    free(sums);
    return JPEG_OK;
}

#define SCALEBITS 16
#define ONE_HALF ((int64_t)1 << (SCALEBITS - 1))
#define FIX(x) ((int64_t)((x) * (1L << SCALEBITS) + 0.5))

static int cr_r[256], cb_b[256];
static int64_t cr_g[256], cb_g[256];
static int ycc_ready = 0;

static void init_ycc(void) {
    if (ycc_ready)
        return;
    for (int i = 0; i < 256; ++i) {
        int64_t x = i - 128;
        cr_r[i] = (int)((FIX(1.40200) * x + ONE_HALF) >> SCALEBITS);
        cb_b[i] = (int)((FIX(1.77200) * x + ONE_HALF) >> SCALEBITS);
        cr_g[i] = (-FIX(0.71414)) * x;
        cb_g[i] = (-FIX(0.34414)) * x + ONE_HALF;
    }
    ycc_ready = 1;
}

static inline uint8_t clamp255(int v) {
    return (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v));
}

/* n pixels of three planes -> interleaved RGB: `space` 1 YCbCr (jdcolor.c's
 * ycc_rgb_convert), 2 RGB (copied); one plane (c1 = c2 = NULL) is gray,
 * replicated */
void jpeg_color(const uint8_t *c0, const uint8_t *c1, const uint8_t *c2,
                int space, uint8_t *rgb, long n) {
    if (c1 == NULL) {
        for (long i = 0; i < n; ++i)
            rgb[3 * i] = rgb[3 * i + 1] = rgb[3 * i + 2] = c0[i];
        return;
    }
    if (space == 2) {
        for (long i = 0; i < n; ++i) {
            rgb[3 * i] = c0[i];
            rgb[3 * i + 1] = c1[i];
            rgb[3 * i + 2] = c2[i];
        }
        return;
    }
    init_ycc();
    for (long i = 0; i < n; ++i) {
        int y = c0[i], cb = c1[i], cr = c2[i];
        rgb[3 * i] = clamp255(y + cr_r[cr]);
        rgb[3 * i + 1] = clamp255(y + (int)((cb_g[cb] + cr_g[cr]) >> SCALEBITS));
        rgb[3 * i + 2] = clamp255(y + cb_b[cb]);
    }
}

/* ---------------------------------------------------------------- parsing */

typedef struct {
    int ok;
    uint8_t look_len[512];      /* 9-bit lookahead: code length, 0 = slow */
    uint8_t look_sym[512];
    int32_t maxcode[18];        /* jdhuff.c's derived table */
    int32_t valoffset[18];
    uint8_t vals[256];
} huff_t;

typedef struct {
    int id, h, v, tq;
    long bw, bh;                /* width_in_blocks, height_in_blocks */
    long pw, ph;                /* blocks held: whole MCUs */
    long dw, dh;                /* downsampled width and height */
    int16_t *coef;
    uint16_t qt[64];            /* latched at the component's first scan */
    int latched;
    int dc_pred;
} comp_t;

typedef struct {
    const uint8_t *data;
    long n, pos;
    char *err;
    long errlen;
    int width, height, ncomp, progressive, frame;
    int hmax, vmax;
    long mcux, mcuy;
    comp_t comp[3];
    uint16_t qt[4][64];
    int qt_set[4];
    huff_t dc[4], ac[4];
    long restart;
    int jfif, adobe, adobe_transform;
    int eobrun;
    /* bit reader over the current entropy-coded segment */
    long bp;
    uint64_t buf;
    int bits, pad, marker;
} dec_t;

static int fail(dec_t *d, int code, const char *msg) {
    if (d->err && d->errlen > 0)
        snprintf(d->err, (size_t)d->errlen, "%s", msg);
    return code;
}

static int failf(dec_t *d, int code, const char *fmt, int a) {
    if (d->err && d->errlen > 0)
        snprintf(d->err, (size_t)d->errlen, fmt, a);
    return code;
}

static int u16(dec_t *d, long at) {
    return (d->data[at] << 8) | d->data[at + 1];
}

static int build_huff(huff_t *t, const uint8_t *counts, const uint8_t *vals,
                      int nvals) {
    memset(t, 0, sizeof(*t));
    memcpy(t->vals, vals, (size_t)nvals);
    int code = 0, k = 0;
    for (int l = 1; l <= 16; ++l) {
        t->valoffset[l] = k - code;
        if (counts[l - 1]) {
            for (int i = 0; i < counts[l - 1]; ++i, ++k, ++code) {
                if (l <= 9) {
                    int shift = 9 - l;
                    for (int f = 0; f < (1 << shift); ++f) {
                        t->look_len[(code << shift) | f] = (uint8_t)l;
                        t->look_sym[(code << shift) | f] = vals[k];
                    }
                }
            }
            t->maxcode[l] = code - 1;
        } else {
            t->maxcode[l] = -1;
        }
        if (code > (1 << l))
            return -1;          /* more codes than the length can hold */
        code <<= 1;
    }
    t->maxcode[17] = 0x7fffffff;
    t->ok = 1;
    return 0;
}

/* ------------------------------------------------------------ bit reading */

static void br_start(dec_t *d) {
    d->bp = d->pos;
    d->buf = 0;
    d->bits = d->pad = d->marker = 0;
}

static void br_fill(dec_t *d) {
    while (d->bits <= 56) {
        uint8_t b = 0;
        if (!d->marker) {
            if (d->bp >= d->n) {
                d->marker = 1;          /* the file ends inside the scan */
            } else if (d->data[d->bp] == 0xFF) {
                if (d->bp + 1 < d->n && d->data[d->bp + 1] == 0x00) {
                    b = 0xFF;
                    d->bp += 2;
                } else {
                    d->marker = 1;      /* a marker ends the segment */
                }
            } else {
                b = d->data[d->bp++];
            }
        }
        if (d->marker)
            d->pad += 8;
        d->buf = (d->buf << 8) | b;
        d->bits += 8;
    }
}

/* consume n bits; -1 if they run into the zeros past the segment's end */
static inline int br_get(dec_t *d, int n, int *v) {
    if (n == 0) {
        *v = 0;
        return 0;
    }
    if (d->bits < n)
        br_fill(d);
    if (n > d->bits - d->pad)
        return -1;
    d->bits -= n;
    *v = (int)((d->buf >> d->bits) & ((1u << n) - 1));
    return 0;
}

static inline int huff_decode(dec_t *d, const huff_t *t, int *sym) {
    if (d->bits < 16)
        br_fill(d);
    int look = (int)((d->buf >> (d->bits - 9)) & 511);
    int l = t->look_len[look];
    if (l) {
        if (l > d->bits - d->pad)
            return -1;
        d->bits -= l;
        *sym = t->look_sym[look];
        return 0;
    }
    for (l = 10; l <= 16; ++l) {
        int code = (int)((d->buf >> (d->bits - l)) & ((1u << l) - 1));
        if (code <= t->maxcode[l]) {
            if (l > d->bits - d->pad)
                return -1;
            d->bits -= l;
            *sym = t->vals[t->valoffset[l] + code];
            return 0;
        }
    }
    return -1;
}

static inline int extend(int r, int s) {
    return r < (1 << (s - 1)) ? r + (int)((unsigned)-1 << s) + 1 : r;
}

/* ----------------------------------------------------------- block decoders */

#define GET(n, v)                                                          \
    do {                                                                   \
        if (br_get(d, (n), &(v)))                                          \
            return -1;                                                     \
    } while (0)
#define HUFF(t, s)                                                         \
    do {                                                                   \
        if (huff_decode(d, (t), &(s)))                                     \
            return -1;                                                     \
    } while (0)

static int block_sequential(dec_t *d, comp_t *c, int16_t *blk,
                            const huff_t *dc, const huff_t *ac) {
    int s, r;
    HUFF(dc, s);
    if (s > 15)
        return -1;
    if (s) {
        GET(s, r);
        s = extend(r, s);
    }
    c->dc_pred += s;
    blk[0] = (int16_t)c->dc_pred;
    for (int k = 1; k < 64; ++k) {
        HUFF(ac, s);
        r = s >> 4;
        s &= 15;
        if (s) {
            k += r;
            int v;
            GET(s, v);
            blk[natural_order[k]] = (int16_t)extend(v, s);
        } else {
            if (r != 15)
                break;
            k += 15;
        }
    }
    return 0;
}

static int block_dc_first(dec_t *d, comp_t *c, int16_t *blk,
                          const huff_t *dc, int al) {
    int s, r;
    HUFF(dc, s);
    if (s > 15)
        return -1;
    if (s) {
        GET(s, r);
        s = extend(r, s);
    }
    c->dc_pred += s;
    blk[0] = (int16_t)((unsigned)c->dc_pred << al);
    return 0;
}

static int block_dc_refine(dec_t *d, int16_t *blk, int al) {
    int b;
    GET(1, b);
    if (b)
        blk[0] = (int16_t)(blk[0] | (1 << al));
    return 0;
}

static int block_ac_first(dec_t *d, int16_t *blk, const huff_t *ac, int ss,
                          int se, int al) {
    if (d->eobrun > 0) {
        d->eobrun--;
        return 0;
    }
    for (int k = ss; k <= se; ++k) {
        int s, r;
        HUFF(ac, s);
        r = s >> 4;
        s &= 15;
        if (s) {
            k += r;
            int v;
            GET(s, v);
            blk[natural_order[k]] = (int16_t)((unsigned)extend(v, s) << al);
        } else {
            if (r == 15) {
                k += 15;
            } else {
                d->eobrun = 1 << r;
                if (r) {
                    int v;
                    GET(r, v);
                    d->eobrun += v;
                }
                d->eobrun--;
                break;
            }
        }
    }
    return 0;
}

static int block_ac_refine(dec_t *d, int16_t *blk, const huff_t *ac, int ss,
                           int se, int al) {
    int p1 = 1 << al, m1 = (int)((unsigned)-1 << al);
    int k = ss;
    if (d->eobrun == 0) {
        for (; k <= se; ++k) {
            int s, r, b;
            HUFF(ac, s);
            r = s >> 4;
            s &= 15;
            if (s) {
                GET(1, b);
                s = b ? p1 : m1;
            } else if (r != 15) {
                d->eobrun = 1 << r;
                if (r) {
                    int v;
                    GET(r, v);
                    d->eobrun += v;
                }
                break;
            }
            do {
                int16_t *co = blk + natural_order[k];
                if (*co != 0) {
                    GET(1, b);
                    if (b && (*co & p1) == 0)
                        *co = (int16_t)(*co >= 0 ? *co + p1 : *co + m1);
                } else if (--r < 0) {
                    break;
                }
                k++;
            } while (k <= se);
            if (s)
                blk[natural_order[k]] = (int16_t)s;
        }
    }
    if (d->eobrun > 0) {
        for (; k <= se; ++k) {
            int16_t *co = blk + natural_order[k];
            if (*co != 0) {
                int b;
                GET(1, b);
                if (b && (*co & p1) == 0)
                    *co = (int16_t)(*co >= 0 ? *co + p1 : *co + m1);
            }
        }
        d->eobrun--;
    }
    return 0;
}

#undef GET
#undef HUFF

/* ------------------------------------------------------------------ scans */

static int read_restart(dec_t *d, int num) {
    /* the encoder pads to a byte with ones: drop the rest of the buffer,
     * then the marker must follow (after any fill bytes 0xFF) */
    d->bits = d->pad = 0;
    d->buf = 0;
    d->marker = 0;
    long p = d->bp;
    while (p + 1 < d->n && d->data[p] == 0xFF && d->data[p + 1] == 0xFF)
        p++;
    if (p + 1 >= d->n || d->data[p] != 0xFF || d->data[p + 1] != 0xD0 + num)
        return fail(d, JPEG_CORRUPT, "corrupt JPEG data: restart marker "
                                     "missing or out of sequence");
    d->bp = p + 2;
    for (int i = 0; i < d->ncomp; ++i)
        d->comp[i].dc_pred = 0;
    d->eobrun = 0;
    return 0;
}

static int scan(dec_t *d, long at, long len) {
    if (len < 1)
        return fail(d, JPEG_CORRUPT, "corrupt JPEG data: bad SOS length");
    int ns = d->data[at];
    if (ns < 1 || ns > 4 || len != 4 + 2 * ns)
        return fail(d, JPEG_CORRUPT, "corrupt JPEG data: bad SOS length");
    if (!d->frame)
        return fail(d, JPEG_CORRUPT, "corrupt JPEG data: SOS before SOF");
    comp_t *cs[4];
    int td[4], ta[4];
    for (int i = 0; i < ns; ++i) {
        int id = d->data[at + 1 + 2 * i], t = d->data[at + 2 + 2 * i];
        cs[i] = NULL;
        for (int j = 0; j < d->ncomp; ++j)
            if (d->comp[j].id == id)
                cs[i] = &d->comp[j];
        if (!cs[i])
            return fail(d, JPEG_CORRUPT, "corrupt JPEG data: SOS names an "
                                         "unknown component");
        td[i] = t >> 4;
        ta[i] = t & 15;
        if (td[i] > 3 || ta[i] > 3)
            return fail(d, JPEG_CORRUPT, "corrupt JPEG data: bad Huffman "
                                         "table index");
    }
    long q = at + 1 + 2 * ns;
    int ss = d->data[q], se = d->data[q + 1], ah = d->data[q + 2] >> 4,
        al = d->data[q + 2] & 15;
    if (d->progressive) {
        if (ss > se || se > 63 || (ss == 0 && se != 0) ||
            (ss > 0 && ns != 1) || al > 13 || ah > 13)
            return fail(d, JPEG_CORRUPT, "corrupt JPEG data: bad progressive "
                                         "scan parameters");
    } else if (ss != 0 || se != 63 || ah != 0 || al != 0) {
        return fail(d, JPEG_CORRUPT, "corrupt JPEG data: bad sequential scan "
                                     "parameters");
    }
    for (int i = 0; i < ns; ++i) {
        comp_t *c = cs[i];
        if (!c->latched) {
            if (!d->qt_set[c->tq])
                return fail(d, JPEG_CORRUPT, "corrupt JPEG data: a component's "
                                             "quantization table is not "
                                             "defined");
            memcpy(c->qt, d->qt[c->tq], sizeof(c->qt));
            c->latched = 1;
        }
        int need_dc = !d->progressive || (ss == 0 && ah == 0);
        int need_ac = !d->progressive || ss > 0;
        if ((need_dc && !d->dc[td[i]].ok) || (need_ac && !d->ac[ta[i]].ok))
            return fail(d, JPEG_CORRUPT, "corrupt JPEG data: a Huffman table "
                                         "the scan uses is not defined");
        c->dc_pred = 0;
    }
    d->eobrun = 0;
    d->pos = at + len;
    br_start(d);

    long mx, my;
    int bpm;        /* blocks a MCU */
    if (ns == 1) {
        mx = cs[0]->bw;
        my = cs[0]->bh;
        bpm = 1;
    } else {
        mx = d->mcux;
        my = d->mcuy;
        bpm = 0;
        for (int i = 0; i < ns; ++i)
            bpm += cs[i]->h * cs[i]->v;
        if (bpm > 10)
            return fail(d, JPEG_CORRUPT, "corrupt JPEG data: too many blocks "
                                         "in a MCU");
    }
    long total = mx * my, todo = d->restart;
    int next_rst = 0;
    for (long m = 0; m < total; ++m) {
        if (d->restart && todo == 0) {
            if (read_restart(d, next_rst))
                return JPEG_CORRUPT;
            next_rst = (next_rst + 1) & 7;
            todo = d->restart;
        }
        long mcol = m % mx, mrow = m / mx;
        for (int i = 0; i < ns; ++i) {
            comp_t *c = cs[i];
            int hb = ns == 1 ? 1 : c->h, vb = ns == 1 ? 1 : c->v;
            for (int by = 0; by < vb; ++by) {
                for (int bx = 0; bx < hb; ++bx) {
                    long row = mrow * vb + by, col = mcol * hb + bx;
                    int16_t *blk = c->coef + (row * c->pw + col) * 64;
                    int rc;
                    if (!d->progressive)
                        rc = block_sequential(d, c, blk, &d->dc[td[i]],
                                              &d->ac[ta[i]]);
                    else if (ss == 0 && ah == 0)
                        rc = block_dc_first(d, c, blk, &d->dc[td[i]], al);
                    else if (ss == 0)
                        rc = block_dc_refine(d, blk, al);
                    else if (ah == 0)
                        rc = block_ac_first(d, blk, &d->ac[ta[i]], ss, se, al);
                    else
                        rc = block_ac_refine(d, blk, &d->ac[ta[i]], ss, se,
                                             al);
                    if (rc)
                        return fail(d, JPEG_CORRUPT,
                                    d->marker && d->bp >= d->n
                                        ? "image file is truncated"
                                        : "corrupt JPEG data: bad Huffman "
                                          "code or premature end of data "
                                          "segment");
                }
            }
        }
        todo--;
    }
    /* the segment ends at the next marker (libjpeg skips stray bytes) */
    long p = d->bp;
    while (p + 1 < d->n && !(d->data[p] == 0xFF && d->data[p + 1] != 0x00 &&
                             d->data[p + 1] != 0xFF))
        p++;
    d->pos = p;
    return 0;
}

static long div_up(long a, long b) { return (a + b - 1) / b; }

static int frame(dec_t *d, long at, long len, int sof) {
    if (d->frame)
        return fail(d, JPEG_CORRUPT, "corrupt JPEG data: two SOF markers");
    if (len < 6)
        return fail(d, JPEG_CORRUPT, "corrupt JPEG data: short SOF");
    int prec = d->data[at];
    d->height = u16(d, at + 1);
    d->width = u16(d, at + 3);
    d->ncomp = d->data[at + 5];
    d->progressive = sof == 2;
    if (prec != 8)
        return failf(d, JPEG_UNSUPPORTED, "JPEG samples of %d bits are not "
                                          "supported (8 only)", prec);
    if (d->ncomp != 1 && d->ncomp != 3)
        return failf(d, JPEG_UNSUPPORTED, "JPEG frames of %d components are "
                                          "not supported (gray or 3 only)",
                     d->ncomp);
    if (len != 6 + 3 * d->ncomp)
        return fail(d, JPEG_CORRUPT, "corrupt JPEG data: bad SOF length");
    if (d->height == 0 || d->width == 0)
        return fail(d, JPEG_CORRUPT, "corrupt JPEG data: empty image (a DNL "
                                     "height is not supported)");
    d->hmax = d->vmax = 1;
    for (int i = 0; i < d->ncomp; ++i) {
        comp_t *c = &d->comp[i];
        c->id = d->data[at + 6 + 3 * i];
        c->h = d->data[at + 7 + 3 * i] >> 4;
        c->v = d->data[at + 7 + 3 * i] & 15;
        c->tq = d->data[at + 8 + 3 * i];
        if (c->h < 1 || c->h > 4 || c->v < 1 || c->v > 4 || c->tq > 3)
            return fail(d, JPEG_CORRUPT, "corrupt JPEG data: bad sampling "
                                         "factor or table index");
        if (c->h > d->hmax)
            d->hmax = c->h;
        if (c->v > d->vmax)
            d->vmax = c->v;
    }
    for (int i = 0; i < d->ncomp; ++i) {
        comp_t *c = &d->comp[i];
        int hr = d->hmax / c->h, vr = d->vmax / c->v;
        if (d->ncomp > 1 &&
            (d->hmax % c->h || d->vmax % c->v || hr > 2 || vr > 2))
            return fail(d, JPEG_UNSUPPORTED, "JPEG sampling factors other "
                                             "than 4:4:4, 4:2:2, 4:2:0 and "
                                             "4:4:0 are not supported");
    }
    d->mcux = div_up(d->width, 8L * d->hmax);
    d->mcuy = div_up(d->height, 8L * d->vmax);
    for (int i = 0; i < d->ncomp; ++i) {
        comp_t *c = &d->comp[i];
        c->dw = div_up((long)d->width * c->h, d->hmax);
        c->dh = div_up((long)d->height * c->v, d->vmax);
        c->bw = div_up(c->dw, 8);
        c->bh = div_up(c->dh, 8);
        if (d->ncomp == 1) {
            c->pw = c->bw;
            c->ph = c->bh;
        } else {
            c->pw = d->mcux * c->h;
            c->ph = d->mcuy * c->v;
        }
    }
    d->frame = 1;
    return 0;
}

/* Parse markers from SOI. With `header_only`, stop at the frame header;
 * otherwise decode every scan (coefficient arrays allocated at SOF). */
static int parse(dec_t *d, int header_only) {
    if (d->n < 2 || d->data[0] != 0xFF || d->data[1] != 0xD8)
        return fail(d, JPEG_CORRUPT, "not a JPEG file (no SOI marker)");
    d->pos = 2;
    int scans = 0;
    for (;;) {
        /* find the next marker, skipping stray bytes and fill bytes */
        while (d->pos < d->n && d->data[d->pos] != 0xFF)
            d->pos++;
        while (d->pos < d->n && d->data[d->pos] == 0xFF)
            d->pos++;
        if (d->pos >= d->n)
            return fail(d, JPEG_CORRUPT, "image file is truncated");
        int m = d->data[d->pos++];
        if (m == 0xD9) {
            if (!scans)
                return fail(d, JPEG_CORRUPT, "corrupt JPEG data: no image "
                                             "before EOI");
            return JPEG_OK;
        }
        if (m >= 0xD0 && m <= 0xD7)
            continue;               /* a stray RSTn: libjpeg ignores it */
        if (m == 0x01 || m == 0xD8)
            return fail(d, JPEG_CORRUPT, "corrupt JPEG data: unexpected "
                                         "marker");
        if (d->pos + 2 > d->n)
            return fail(d, JPEG_CORRUPT, "image file is truncated");
        long len = u16(d, d->pos);
        if (len < 2)
            return fail(d, JPEG_CORRUPT, "corrupt JPEG data: bad segment "
                                         "length");
        if (d->pos + len > d->n)
            return fail(d, JPEG_CORRUPT, "image file is truncated");
        long at = d->pos + 2, body = len - 2;
        d->pos += len;
        if (m == 0xC0 || m == 0xC1 || m == 0xC2) {
            int rc = frame(d, at, body, m - 0xC0);
            if (rc)
                return rc;
            if (header_only)
                return JPEG_OK;
            for (int i = 0; i < d->ncomp; ++i) {
                comp_t *c = &d->comp[i];
                c->coef = calloc((size_t)(c->pw * c->ph * 64), sizeof(int16_t));
                if (!c->coef)
                    return fail(d, JPEG_NOMEM, "no memory for the JPEG "
                                               "coefficients");
            }
        } else if (m == 0xC3 || (m >= 0xC5 && m <= 0xC7) ||
                   (m >= 0xC9 && m <= 0xCB) || (m >= 0xCD && m <= 0xCF) ||
                   m == 0xCC) {
            return failf(d, JPEG_UNSUPPORTED,
                         "JPEG frames of type SOF%d (lossless, hierarchical "
                         "or arithmetic-coded) are not supported",
                         m == 0xCC ? -1 : m - 0xC0);
        } else if (m == 0xC4) {
            long p = at, end = at + body;
            while (p < end) {
                int tc = d->data[p] >> 4, th = d->data[p] & 15;
                if (tc > 1 || th > 3 || p + 17 > end)
                    return fail(d, JPEG_CORRUPT, "corrupt JPEG data: bad DHT");
                const uint8_t *counts = d->data + p + 1;
                int nv = 0;
                for (int l = 0; l < 16; ++l)
                    nv += counts[l];
                if (nv > 256 || p + 17 + nv > end)
                    return fail(d, JPEG_CORRUPT, "corrupt JPEG data: bad DHT");
                huff_t *t = tc ? &d->ac[th] : &d->dc[th];
                if (build_huff(t, counts, d->data + p + 17, nv))
                    return fail(d, JPEG_CORRUPT, "corrupt JPEG data: bad "
                                                 "Huffman table");
                p += 17 + nv;
            }
        } else if (m == 0xDB) {
            long p = at, end = at + body;
            while (p < end) {
                int pq = d->data[p] >> 4, tq = d->data[p] & 15;
                long size = pq ? 128 : 64;
                if (pq > 1 || tq > 3 || p + 1 + size > end)
                    return fail(d, JPEG_CORRUPT, "corrupt JPEG data: bad DQT");
                for (int k = 0; k < 64; ++k) {
                    int v = pq ? u16(d, p + 1 + 2 * k) : d->data[p + 1 + k];
                    d->qt[tq][natural_order[k]] = (uint16_t)v;
                }
                d->qt_set[tq] = 1;
                p += 1 + size;
            }
        } else if (m == 0xDD) {
            if (body != 2)
                return fail(d, JPEG_CORRUPT, "corrupt JPEG data: bad DRI");
            d->restart = u16(d, at);
        } else if (m == 0xDA) {
            if (header_only)
                return fail(d, JPEG_CORRUPT, "corrupt JPEG data: SOS before "
                                             "SOF");
            int rc = scan(d, at, body);
            if (rc)
                return rc;
            scans++;
        } else if (m == 0xE0) {
            if (body >= 14 && memcmp(d->data + at, "JFIF\0", 5) == 0)
                d->jfif = 1;
        } else if (m == 0xEE) {
            if (body >= 12 && memcmp(d->data + at, "Adobe", 5) == 0) {
                d->adobe = 1;
                d->adobe_transform = d->data[at + 11];
            }
        } else if (m == 0xDC) {
            return fail(d, JPEG_UNSUPPORTED, "JPEG DNL markers are not "
                                             "supported");
        } else if ((m >= 0xE1 && m <= 0xEF) || m == 0xFE ||
                   (m >= 0xF0 && m <= 0xFD)) {
            /* APPn, COM, JPGn: skipped */
        } else {
            return failf(d, JPEG_CORRUPT, "corrupt JPEG data: unknown marker "
                                          "0x%02X", m);
        }
    }
}

/* 1 YCbCr, 2 RGB: libjpeg's default_decompress_parms for 3 components */
static int color_space(dec_t *d) {
    if (d->jfif)
        return 1;
    if (d->adobe)
        return d->adobe_transform == 0 ? 2 : 1;
    if (d->comp[0].id == 82 && d->comp[1].id == 71 && d->comp[2].id == 66)
        return 2;
    return 1;
}

static void release(dec_t *d) {
    for (int i = 0; i < 3; ++i) {
        free(d->comp[i].coef);
        d->comp[i].coef = NULL;
    }
}

/* info: height, width, components, progressive, then (h, v) a component */
int jpeg_header(const uint8_t *data, long n, int32_t *info, char *err,
                long errlen) {
    dec_t d;
    memset(&d, 0, sizeof(d));
    d.data = data;
    d.n = n;
    d.err = err;
    d.errlen = errlen;
    int rc = parse(&d, 1);
    if (rc == JPEG_OK && !d.frame)
        rc = fail(&d, JPEG_CORRUPT, "corrupt JPEG data: no SOF marker");
    if (rc)
        return rc;
    info[0] = d.height;
    info[1] = d.width;
    info[2] = d.ncomp;
    info[3] = d.progressive;
    for (int i = 0; i < d.ncomp; ++i) {
        info[4 + 2 * i] = d.comp[i].h;
        info[5 + 2 * i] = d.comp[i].v;
    }
    return JPEG_OK;
}

/* Decode into `rgb` (height * width * 3). When `coef` is not NULL it takes
 * each component's coefficients (blocks of whole MCUs, natural order, as
 * decoded: not dequantized) one component after another, `qt` its latched
 * quantization table (64 a component) and `space` the colour space
 * (0 gray, 1 YCbCr, 2 RGB). */
int jpeg_decode(const uint8_t *data, long n, uint8_t *rgb, int16_t *coef,
                uint16_t *qt, int32_t *space, char *err, long errlen) {
    dec_t d;
    memset(&d, 0, sizeof(d));
    d.data = data;
    d.n = n;
    d.err = err;
    d.errlen = errlen;
    int rc = parse(&d, 0);
    if (rc) {
        release(&d);
        return rc;
    }
    for (int i = 0; i < d.ncomp; ++i)
        if (!d.comp[i].latched) {
            release(&d);
            return fail(&d, JPEG_CORRUPT, "corrupt JPEG data: a component "
                                          "appears in no scan");
        }
    int cs = d.ncomp == 1 ? 0 : color_space(&d);
    if (coef) {
        long off = 0;
        for (int i = 0; i < d.ncomp; ++i) {
            comp_t *c = &d.comp[i];
            memcpy(coef + off, c->coef, sizeof(int16_t) * c->pw * c->ph * 64);
            off += c->pw * c->ph * 64;
            memcpy(qt + 64 * i, c->qt, sizeof(c->qt));
        }
        *space = cs;
    }
    long hw = (long)d.width * d.height;
    uint8_t *planes[3] = {NULL, NULL, NULL};
    uint8_t *tmp = NULL;
    int *sums = NULL;
    rc = JPEG_OK;
    for (int i = 0; i < d.ncomp && rc == JPEG_OK; ++i) {
        comp_t *c = &d.comp[i];
        int hr = d.hmax / c->h, vr = d.vmax / c->v;
        free(tmp);
        tmp = malloc((size_t)(c->pw * 8 * c->ph * 8));
        planes[i] = malloc((size_t)hw);
        free(sums);
        sums = malloc(sizeof(int) * (size_t)c->dw);
        if (!tmp || !planes[i] || !sums) {
            rc = fail(&d, JPEG_NOMEM, "no memory for the JPEG planes");
            break;
        }
        jpeg_idct_islow_blocks(c->coef, c->qt, c->ph, c->pw, tmp);
        if (d.ncomp == 1)
            hr = vr = 1;
        upsample(tmp, c->pw * 8, c->dh, c->dw, hr, vr, planes[i], d.height,
                 d.width, sums);
    }
    if (rc == JPEG_OK)
        jpeg_color(planes[0], d.ncomp == 3 ? planes[1] : NULL,
                   d.ncomp == 3 ? planes[2] : NULL, cs, rgb, hw);
    free(tmp);
    free(sums);
    for (int i = 0; i < 3; ++i)
        free(planes[i]);
    release(&d);
    return rc;
}
