/* Host routines of the port's input pipeline, called through ctypes (which
 * releases the GIL, so the loader's threads run them in parallel).
 *
 *   normalize_{u8,f32}_hwc  (flip +) per-channel scale/bias + float32 copy:
 *                           out[y,x,k] = in[y, x|flip, k] * scale[k] + bias[k]
 *   hflip_i32_hw            int32 mask horizontal flip
 *   png_unfilter            PNG row filters 0-4 (each row: a filter byte and
 *                           `rowbytes` filtered bytes)
 *   resize_linear_u8        the fixed-point bilinear resize of uint8 HWC
 *                           images whose tables data/transforms.py computes
 *   resize_nearest          gather of whole pixels by row and column tables
 *
 * Each is held bit-equal to the numpy version beside its caller. Built with
 * -ffp-contract=off: normalize's px*scale+bias rounds twice, as numpy does.
 */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#define NORMALIZE_BODY(T)                                                   \
    if (c == 3) {                                                           \
        const float s0 = scale[0], s1 = scale[1], s2 = scale[2];            \
        const float b0 = bias[0], b1 = bias[1], b2 = bias[2];               \
        for (long y = 0; y < h; ++y) {                                      \
            const T *row = src + y * w * 3;                                 \
            float *out = dst + y * w * 3;                                   \
            if (!hflip) {                                                   \
                for (long x = 0; x < w; ++x) {                              \
                    out[3 * x]     = row[3 * x]     * s0 + b0;              \
                    out[3 * x + 1] = row[3 * x + 1] * s1 + b1;              \
                    out[3 * x + 2] = row[3 * x + 2] * s2 + b2;              \
                }                                                           \
            } else {                                                        \
                for (long x = 0; x < w; ++x) {                              \
                    const T *px = row + 3 * (w - 1 - x);                    \
                    out[3 * x]     = px[0] * s0 + b0;                       \
                    out[3 * x + 1] = px[1] * s1 + b1;                       \
                    out[3 * x + 2] = px[2] * s2 + b2;                       \
                }                                                           \
            }                                                               \
        }                                                                   \
        return;                                                             \
    }                                                                       \
    for (long y = 0; y < h; ++y) {                                          \
        const T *row = src + y * w * c;                                     \
        float *out = dst + y * w * c;                                       \
        for (long x = 0; x < w; ++x) {                                      \
            const T *px = row + (hflip ? (w - 1 - x) : x) * c;              \
            float *o = out + x * c;                                         \
            for (long k = 0; k < c; ++k)                                    \
                o[k] = px[k] * scale[k] + bias[k];                          \
        }                                                                   \
    }

void normalize_u8_hwc(const uint8_t *src, float *dst, long h, long w, long c,
                      const float *scale, const float *bias, int hflip) {
    NORMALIZE_BODY(uint8_t)
}

void normalize_f32_hwc(const float *src, float *dst, long h, long w, long c,
                       const float *scale, const float *bias, int hflip) {
    NORMALIZE_BODY(float)
}

void hflip_i32_hw(const int32_t *src, int32_t *dst, long h, long w) {
    for (long y = 0; y < h; ++y) {
        const int32_t *row = src + y * w;
        int32_t *out = dst + y * w;
        for (long x = 0; x < w; ++x)
            out[x] = row[w - 1 - x];
    }
}

/* Returns 0, or 1 + the index of the first row whose filter type is not
 * 0-4. `bpp` is the filter's byte distance to the left neighbour. */
long png_unfilter(const uint8_t *src, uint8_t *dst, long h, long rowbytes,
                  long bpp) {
    const uint8_t *prev = NULL;
    for (long y = 0; y < h; ++y) {
        const uint8_t *in = src + y * (rowbytes + 1);
        const uint8_t ft = *in++;
        uint8_t *out = dst + y * rowbytes;
        long i;
        switch (ft) {
        case 0:
            memcpy(out, in, (size_t)rowbytes);
            break;
        case 1:
            for (i = 0; i < rowbytes && i < bpp; ++i) out[i] = in[i];
            for (; i < rowbytes; ++i) out[i] = (uint8_t)(in[i] + out[i - bpp]);
            break;
        case 2:
            for (i = 0; i < rowbytes; ++i)
                out[i] = (uint8_t)(in[i] + (prev ? prev[i] : 0));
            break;
        case 3:
            for (i = 0; i < rowbytes; ++i) {
                const int left = i >= bpp ? out[i - bpp] : 0;
                const int up = prev ? prev[i] : 0;
                out[i] = (uint8_t)(in[i] + ((left + up) >> 1));
            }
            break;
        case 4:
            for (i = 0; i < rowbytes; ++i) {
                const int a = i >= bpp ? out[i - bpp] : 0;
                const int b = prev ? prev[i] : 0;
                const int c = (prev && i >= bpp) ? prev[i - bpp] : 0;
                const int p = a + b - c;
                const int pa = abs(p - a), pb = abs(p - b), pc = abs(p - c);
                const int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
                out[i] = (uint8_t)(in[i] + pred);
            }
            break;
        default:
            return y + 1;
        }
        prev = out;
    }
    return 0;
}

/* One source row through the horizontal pass: 2048-scaled int sums. */
static void hrow(const uint8_t *row, long c, long nw, const int32_t *x0,
                 const int32_t *x1, const int32_t *a0, const int32_t *a1,
                 int32_t *out) {
    for (long x = 0; x < nw; ++x) {
        const uint8_t *p0 = row + (long)x0[x] * c, *p1 = row + (long)x1[x] * c;
        for (long k = 0; k < c; ++k)
            out[x * c + k] = p0[k] * a0[x] + p1[k] * a1[x];
    }
}

/* dst[dy, dx] from source rows y0[dy], y1[dy] (weights b0, b1) and columns
 * x0[dx], x1[dx] (weights a0, a1); the vertical pass rounds as
 * ((r0 >> 4) * b0 >> 16) + ((r1 >> 4) * b1 >> 16), then (v + 2) >> 2.
 * Returns 0, or -1 when the two row buffers cannot be allocated. */
long resize_linear_u8(const uint8_t *src, long w, long c, uint8_t *dst,
                      long nh, long nw, const int32_t *x0, const int32_t *x1,
                      const int32_t *a0, const int32_t *a1, const int32_t *y0,
                      const int32_t *y1, const int32_t *b0,
                      const int32_t *b1) {
    const long n = nw * c;
    int32_t *buf = (int32_t *)malloc(sizeof(int32_t) * (size_t)(2 * n));
    if (!buf) return -1;
    int32_t *rows[2] = {buf, buf + n};
    long have[2] = {-1, -1};
    for (long dy = 0; dy < nh; ++dy) {
        const long want[2] = {y0[dy], y1[dy]};
        int32_t *r[2];
        for (int j = 0; j < 2; ++j) {
            int slot = have[0] == want[j] ? 0 : (have[1] == want[j] ? 1 : -1);
            if (slot < 0) {
                /* never overwrite the row the other tap needs */
                if (j == 0)
                    slot = have[0] == want[1] ? 1 : 0;
                else
                    slot = r[0] == rows[0] ? 1 : 0;
                hrow(src + want[j] * w * c, c, nw, x0, x1, a0, a1, rows[slot]);
                have[slot] = want[j];
            }
            r[j] = rows[slot];
        }
        const int32_t wb0 = b0[dy], wb1 = b1[dy];
        uint8_t *out = dst + dy * n;
        for (long i = 0; i < n; ++i) {
            int32_t v = (((r[0][i] >> 4) * wb0) >> 16)
                      + (((r[1][i] >> 4) * wb1) >> 16);
            v = (v + 2) >> 2;
            out[i] = (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v));
        }
    }
    free(buf);
    return 0;
}

/* dst[dy, dx] = src[sy[dy], sx[dx]], a pixel being `psize` bytes. */
void resize_nearest(const uint8_t *src, long w, long psize, uint8_t *dst,
                    long nh, long nw, const int64_t *sy, const int64_t *sx) {
    for (long dy = 0; dy < nh; ++dy) {
        const uint8_t *row = src + sy[dy] * w * psize;
        uint8_t *out = dst + dy * nw * psize;
        if (psize == 1) {
            for (long x = 0; x < nw; ++x) out[x] = row[sx[x]];
        } else if (psize == 4) {
            for (long x = 0; x < nw; ++x)
                memcpy(out + x * 4, row + sx[x] * 4, 4);
        } else {
            for (long x = 0; x < nw; ++x)
                memcpy(out + x * psize, row + sx[x] * psize, (size_t)psize);
        }
    }
}
