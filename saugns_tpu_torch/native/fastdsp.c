/* saugns_tpu native fast path: PILUT oscillator inner loops.
 *
 * Implements the wave-oscillator output semantics documented in
 * sau/generator/wosc.h:238-310 (pre-integrated-table differentiation
 * with Hermite interpolation, self-PM feedback with 1-pole damping).
 * Independent implementation; compiled with the same optimization
 * flags as the reference build (-O3 -ffast-math) so the float
 * contraction behavior matches bit-for-bit on this machine.
 */
#include <stddef.h>
#include <stdint.h>
#include <math.h>

#define LEN 2048
#define LENMASK (LEN - 1)
#define SLENBITS 21
#define SLEN (1u << SLENBITS)
#define SLENMASK (SLEN - 1u)

/* 4-point, 3rd-order Hermite interpolation of a periodic table at a
 * 32-bit phase (semantics of sauWave_get_herp, sau/wave.h:127-141). */
static inline double table_herp(const float *tab, uint32_t phase)
{
    uint32_t ind = phase >> SLENBITS;
    float s0 = tab[(ind - 1) & LENMASK];
    float s1 = tab[ind & LENMASK];
    float s2 = tab[(ind + 1) & LENMASK];
    float s3 = tab[(ind + 2) & LENMASK];
    double x = (phase & SLENMASK) * (1.f / SLEN);
    double c0 = s1;
    double c1 = 0.5 * (s2 - s0);
    double c2 = s0 - 2.5 * s1 + 2.0 * s2 - 0.5 * s3;
    double c3 = 0.5 * (s3 - s0) + 1.5 * (s1 - s2);
    return ((c3 * x + c2) * x + c1) * x + c0;
}

/* Differentiated pre-integrated-table oscillator over a phase buffer.
 * State in/out: prev_phase, prev_Is, prev_s. */
void wosc_run(float *out, const uint32_t *phase, long n,
              const float *pilut, float diff_scale, float diff_offset,
              uint32_t *prev_phase, double *prev_Is, float *prev_s)
{
    uint32_t pp = *prev_phase;
    double pIs = *prev_Is;
    float ps = *prev_s;
    for (long i = 0; i < n; ++i) {
        uint32_t p = phase[i];
        int32_t pd = (int32_t)(p - pp);
        float s;
        if (pd == 0) {
            s = ps;
        } else {
            double Is = table_herp(pilut, p);
            double x = (diff_scale / pd);
            s = (float)((Is - pIs) * x + diff_offset);
            pIs = Is;
            ps = s;
            pp = p;
        }
        out[i] = s;
    }
    *prev_phase = pp;
    *prev_Is = pIs;
    *prev_s = ps;
}

/* Self-PM ("feedback FM") variant: the previous output sample, scaled
 * by pm_abuf and a fixed 2^31 factor, offsets the phase; ringing is
 * damped with a 1-pole average (semantics of wosc.h:273-310). */
void wosc_run_selfmod(float *out, const uint32_t *phase, long n,
                      const float *pm_abuf,
                      const float *pilut, float diff_scale,
                      float diff_offset, uint32_t *prev_phase,
                      double *prev_Is, float *prev_s, float *fb_s)
{
    const float fb_scale = 2147483648.f; /* 2^31 */
    uint32_t pp = *prev_phase;
    double pIs = *prev_Is;
    float ps = *prev_s;
    float fb = *fb_s;
    for (long i = 0; i < n; ++i) {
        uint32_t p = phase[i]
            + (uint32_t)(int64_t)llrintf(fb * pm_abuf[i] * fb_scale);
        int32_t pd = (int32_t)(p - pp);
        float s;
        if (pd == 0) {
            s = ps;
        } else {
            double Is = table_herp(pilut, p);
            double x = (diff_scale / pd);
            s = (float)((Is - pIs) * x + diff_offset);
            pIs = Is;
            ps = s;
            pp = p;
        }
        out[i] = s;
        fb = (fb + s) * 0.5f;
    }
    *prev_phase = pp;
    *prev_Is = pIs;
    *prev_s = ps;
    *fb_s = fb;
}

/* Phase-accumulator fill (semantics of sauPhasor_fill,
 * wosc.h:135-169): pre-incremented integer phase, optional PM and
 * frequency-scaled PM offsets. Buffers may be NULL. */
void phasor_fill(uint32_t *out, long n, float coeff, uint32_t *phase,
                 const float *freq, const float *pm, const float *fpm)
{
    const float fpm_scale = 1.f / 632.45553203367586639978f;
    uint32_t ph = *phase;
    for (long i = 0; i < n; ++i) {
        uint32_t ofs = 0;
        float f = freq[i];
        if (pm && fpm)
            ofs = (uint32_t)(int64_t)llrintf(
                (pm[i] + fpm[i] * fpm_scale * f) * 0x1p31f);
        else if (pm)
            ofs = (uint32_t)(int64_t)llrintf(pm[i] * 0x1p31f);
        else if (fpm)
            ofs = (uint32_t)(int64_t)llrintf(
                fpm[i] * fpm_scale * f * 0x1p31f);
        ph += (uint32_t)(int64_t)llrintf(coeff * f);
        out[i] = ofs + ph;
    }
    *phase = ph;
}

/* Wave-table construction (semantics of sau_global_init_Wave +
 * fill_It, sau/wave.c:77-215). The NumPy port in dsp/wavetables.py
 * computes the same tables with correct per-op rounding -- but the
 * reference binary builds wave.c with -O3 -ffast-math, and gcc's
 * vectorizer then uses SIMD sin/sqrt and reassociated accumulations
 * whose results differ from strict rounding by ~1 ulp on 6 of the 12
 * tables (srs/ean/cat/eto/mto/saw), which is the entire remaining
 * byte divergence on 10 corpus scripts (docs/PARITY.md). Those bits
 * are a property of the COMPILER, not the algorithm, so the only
 * faithful host-parity source is to compile the same construction
 * with the same flags on the same machine -- which also means the
 * loop structure below must mirror sau/wave.c's (the vectorizer's
 * choices depend on it). Falls back to the NumPy tables when no C
 * compiler is available.
 */
#define HALFLEN (LEN >> 1)
#define QUARTERLEN (LEN >> 2)
#define WDVSCALE (LEN * 0.125f)
#define WIVSCALE (1.f / WDVSCALE)
#define W_PI 3.14159265358979323846

static float w_sin[LEN];
static float w_sqr[LEN], w_tri[LEN], w_pitri[LEN];
static float w_eto[LEN], w_ean[LEN], w_piean[LEN];
static float w_saw[LEN], w_par[LEN], w_pipar[LEN];
static float w_srs[LEN], w_pisrs[LEN];
static float w_cat[LEN], w_picat[LEN];
static float w_mto[LEN], w_pimto[LEN];
static float w_hsi[LEN], w_pihsi[LEN];
static float w_spa[LEN], w_pispa[LEN];

static void w_fill_It(float *restrict lut, size_t len,
                      const float scale, const float *restrict in_lut)
{
    double in_dc = 0.f;
    for (size_t i = 0; i < len; ++i) {
        in_dc += in_lut[i];
    }
    in_dc /= len;
    double in_sum = 0.f;
    float lb = 0.f, ub = 0.f;
    for (size_t i = 0; i < len; ++i) {
        in_sum += in_lut[i] - in_dc;
        float x = in_sum * WIVSCALE;
        if (x < lb) lb = x;
        if (x > ub) ub = x;
        lut[i] = x;
    }
    float out_scale = scale / ((ub - lb) * 0.5f);
    float out_dc = -(ub + lb) * 0.5f;
    for (size_t i = 0; i < len; ++i) {
        lut[i] = (lut[i] + out_dc) * out_scale;
    }
}

void wave_tables_build(float *out_luts, float *out_piluts)
{
    int i;
    const float val_scale = 1.f;
    for (i = 0; i < HALFLEN; ++i) {
        const double x = i * (1.f/HALFLEN);
        const float sin_x = sin(W_PI * x);
        w_sin[i] = val_scale * sin_x;
        w_sin[i + HALFLEN] = -val_scale * sin_x;
        w_sqr[i] = val_scale;
        const float srs_x = sqrtf(sin_x);
        w_srs[i] = val_scale * srs_x;
        w_hsi[i] = val_scale * (sin_x*2 - 1.f);
        w_mto[i] = val_scale * (srs_x*2 - 1.f);
        const float spa_x = sin(W_PI * 0.5f * (1 + x));
        w_spa[i + QUARTERLEN] = val_scale * (spa_x*2 - 1.f);
    }
    for (i = 0; i < HALFLEN; ++i) {
        const double x = i * (1.f/(HALFLEN-1));
        const double x_rev = (HALFLEN-i) * (1.f/HALFLEN);
        w_par[i + QUARTERLEN] =
            val_scale * ((x_rev * x_rev) * 2.f - 1.f);
        w_saw[i] = val_scale * (1.f - x);
    }
    w_par[HALFLEN+QUARTERLEN] = -val_scale;
    w_spa[HALFLEN+QUARTERLEN] = -val_scale;
    for (i = 0; i < QUARTERLEN; ++i) {
        const double x = i * (1.f/QUARTERLEN);
        const double x_rev = (QUARTERLEN-i) * (1.f/QUARTERLEN);
        w_pitri[i] = val_scale * ((x * x) - 1.f);
        w_pitri[i + QUARTERLEN] = val_scale * (1.f - (x_rev * x_rev));
        w_tri[i] = val_scale * x;
        w_tri[i + QUARTERLEN] = val_scale * x_rev;
        w_par[i] = w_par[HALFLEN - i];
        w_par[i + HALFLEN+QUARTERLEN] = w_par[HALFLEN+QUARTERLEN - i];
        w_spa[i] = w_spa[HALFLEN - i];
        w_spa[i + HALFLEN+QUARTERLEN] = w_spa[HALFLEN+QUARTERLEN - i];
    }
    for (i = HALFLEN; i < LEN; ++i) {
        w_pitri[i] = -w_pitri[i - HALFLEN];
        w_tri[i] = -w_tri[i - HALFLEN];
        w_sqr[i] = -val_scale;
        w_saw[i] = -w_saw[(LEN-1) - i];
        w_hsi[i] = -val_scale;
        w_mto[i] = -val_scale;
        w_srs[i] = -w_srs[i - HALFLEN];
    }
    const float ean_dc_adj = (1.14603185654 - 1.f) / 2.f;
    const float ean_scale_adj = val_scale / 1.07301592827;
    const float eto_scale_adj = val_scale / 1.21094322205;
    for (i = 0; i < LEN; ++i) {
        int j = (i*2) < LEN ? (i*2) : (i*2) - LEN;
        w_ean[i] = (w_sin[i] + w_par[i] - w_tri[i] + ean_dc_adj) *
            ean_scale_adj;
        w_cat[i] = w_sin[i] + w_mto[i] - w_srs[i];
        w_eto[i] = (w_sin[i] + w_saw[j]) * eto_scale_adj;
    }
    w_fill_It(w_piean, LEN, val_scale, w_ean);
    w_fill_It(w_picat, LEN, val_scale, w_cat);
    w_fill_It(w_pipar, LEN, val_scale, w_par);
    w_fill_It(w_pisrs, LEN, val_scale, w_srs);
    w_fill_It(w_pimto, LEN, val_scale, w_mto);
    w_fill_It(w_pihsi, LEN, val_scale, w_hsi);
    w_fill_It(w_pispa, LEN, val_scale, w_spa);

    /* export in SAU_WAVE__ITEMS order; pilut rows per wave.c:49-62 */
    const float *luts[12] = { w_sin, w_tri, w_srs, w_sqr, w_ean,
        w_cat, w_eto, w_par, w_mto, w_saw, w_hsi, w_spa };
    const float *piluts[12] = { w_sin, w_pitri, w_pisrs, w_tri,
        w_piean, w_picat, w_ean, w_pipar, w_pimto, w_par, w_pihsi,
        w_pispa };
    for (i = 0; i < 12; ++i) {
        for (int k = 0; k < LEN; ++k) {
            out_luts[i * LEN + k] = luts[i][k];
            out_piluts[i * LEN + k] = piluts[i][k];
        }
    }
}
