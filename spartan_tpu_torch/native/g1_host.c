/* BN254 G1 host arithmetic: 4x64-limb Montgomery Fq, Jacobian group ops,
 * shared-doubling windowed MSM, and a batched dual-scalar multiply.
 *
 * This is the native backend for spartan_tpu_torch.ops.curve_host's fallback
 * paths (small commits, bullet IPA folds, verifier-side MSMs) — the role
 * arkworks plays for the reference (reference src/group.rs). The
 * boundary format is 32-byte little-endian canonical field elements;
 * Montgomery form is internal only.
 *
 * Build: cc -O2 -fPIC -shared (needs unsigned __int128, gcc/clang).
 */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#define EXPORT __attribute__((visibility("default")))

typedef unsigned __int128 u128;
typedef uint64_t u64;

/* BN254 base field p, -p^-1 mod 2^64, R mod p, R^2 mod p (R = 2^256) */
static const u64 P[4] = {0x3c208c16d87cfd47ULL, 0x97816a916871ca8dULL,
                         0xb85045b68181585dULL, 0x30644e72e131a029ULL};
static const u64 NINV = 0x87d20782e4866389ULL;
static const u64 RMODP[4] = {0xd35d438dc58f0d9dULL, 0x0a78eb28f5c70b3dULL,
                             0x666ea36f7879462cULL, 0x0e0a77c19a07df2fULL};
static const u64 R2[4] = {0xf32cfc5b538afa89ULL, 0xb5e71911d44501fbULL,
                          0x47ab1eff0a417ff6ULL, 0x06d89f71cab8351fULL};

typedef struct { u64 v[4]; } fq;

static inline int fq_is_zero(const fq *a) {
    return (a->v[0] | a->v[1] | a->v[2] | a->v[3]) == 0;
}

static inline int geq_p(const u64 a[4]) {
    for (int i = 3; i >= 0; i--) {
        if (a[i] > P[i]) return 1;
        if (a[i] < P[i]) return 0;
    }
    return 1; /* equal */
}

static inline void sub_p(u64 a[4]) {
    u128 bw = 0;
    for (int i = 0; i < 4; i++) {
        u128 t = (u128)a[i] - P[i] - bw;
        a[i] = (u64)t;
        bw = (t >> 64) & 1;
    }
}

static inline void fq_add(fq *r, const fq *a, const fq *b) {
    u128 c = 0;
    u64 t[4];
    for (int i = 0; i < 4; i++) {
        c += (u128)a->v[i] + b->v[i];
        t[i] = (u64)c;
        c >>= 64;
    }
    if (c || geq_p(t)) sub_p(t);
    memcpy(r->v, t, 32);
}

static inline void fq_sub(fq *r, const fq *a, const fq *b) {
    u128 bw = 0;
    u64 t[4];
    for (int i = 0; i < 4; i++) {
        u128 d = (u128)a->v[i] - b->v[i] - bw;
        t[i] = (u64)d;
        bw = (d >> 64) & 1;
    }
    if (bw) { /* add p back */
        u128 c = 0;
        for (int i = 0; i < 4; i++) {
            c += (u128)t[i] + P[i];
            t[i] = (u64)c;
            c >>= 64;
        }
    }
    memcpy(r->v, t, 32);
}

static inline void fq_dbl(fq *r, const fq *a) { fq_add(r, a, a); }

/* CIOS Montgomery multiplication */
static void fq_mul(fq *r, const fq *a, const fq *b) {
    u64 t[6] = {0, 0, 0, 0, 0, 0};
    for (int i = 0; i < 4; i++) {
        u128 c = 0;
        for (int j = 0; j < 4; j++) {
            c += (u128)t[j] + (u128)a->v[i] * b->v[j];
            t[j] = (u64)c;
            c >>= 64;
        }
        c += t[4];
        t[4] = (u64)c;
        t[5] = (u64)(c >> 64);

        u64 m = t[0] * NINV;
        c = (u128)t[0] + (u128)m * P[0];
        c >>= 64;
        for (int j = 1; j < 4; j++) {
            c += (u128)t[j] + (u128)m * P[j];
            t[j - 1] = (u64)c;
            c >>= 64;
        }
        c += t[4];
        t[3] = (u64)c;
        t[4] = t[5] + (u64)(c >> 64);
        t[5] = 0;
    }
    if (t[4] || geq_p(t)) sub_p(t);
    memcpy(r->v, t, 32);
}

static inline void fq_sqr(fq *r, const fq *a) { fq_mul(r, a, a); }

static void fq_to_mont(fq *r, const fq *a) {
    fq r2;
    memcpy(r2.v, R2, 32);
    fq_mul(r, a, &r2);
}

static void fq_from_mont(fq *r, const fq *a) {
    fq one = {{1, 0, 0, 0}};
    fq_mul(r, a, &one);
}

/* Fermat inverse on Montgomery-form input (result in Montgomery form) */
static void fq_inv(fq *r, const fq *a) {
    /* exponent p-2, MSB-first square-and-multiply */
    u64 e[4];
    memcpy(e, P, 32);
    /* e = p - 2 */
    u128 bw = 2;
    for (int i = 0; i < 4; i++) {
        u128 d = (u128)e[i] - (u64)bw;
        bw = (d >> 64) & 1;
        e[i] = (u64)d;
        if (!bw) break;
    }
    fq acc;
    memcpy(acc.v, RMODP, 32); /* 1 in Montgomery form */
    for (int i = 253; i >= 0; i--) {
        fq_sqr(&acc, &acc);
        if ((e[i >> 6] >> (i & 63)) & 1) fq_mul(&acc, &acc, a);
    }
    *r = acc;
}

/* Jacobian point; infinity iff z == 0. Coordinates Montgomery-form. */
typedef struct { fq x, y, z; } jac;

static const jac JAC_INF = {{{0, 0, 0, 0}}, {{0, 0, 0, 0}}, {{0, 0, 0, 0}}};

static inline int jac_is_inf(const jac *p) { return fq_is_zero(&p->z); }

static void jac_dbl(jac *r, const jac *p) {
    if (jac_is_inf(p) || fq_is_zero(&p->y)) { *r = JAC_INF; return; }
    fq A, B, C, D, E, F, t, x3, y3, z3;
    fq_sqr(&A, &p->x);
    fq_sqr(&B, &p->y);
    fq_sqr(&C, &B);
    fq_add(&t, &p->x, &B);
    fq_sqr(&t, &t);
    fq_sub(&t, &t, &A);
    fq_sub(&t, &t, &C);
    fq_dbl(&D, &t);
    fq_dbl(&E, &A);
    fq_add(&E, &E, &A);
    fq_sqr(&F, &E);
    fq_sub(&x3, &F, &D);
    fq_sub(&x3, &x3, &D);
    fq_sub(&t, &D, &x3);
    fq_mul(&y3, &E, &t);
    fq_dbl(&t, &C);
    fq_dbl(&t, &t);
    fq_dbl(&t, &t); /* 8C */
    fq_sub(&y3, &y3, &t);
    fq_mul(&z3, &p->y, &p->z);
    fq_dbl(&z3, &z3);
    r->x = x3; r->y = y3; r->z = z3;
}

static void jac_add(jac *r, const jac *p, const jac *q) {
    if (jac_is_inf(p)) { *r = *q; return; }
    if (jac_is_inf(q)) { *r = *p; return; }
    fq z1z1, z2z2, u1, u2, s1, s2, h, i, j, rr, v, t, x3, y3, z3;
    fq_sqr(&z1z1, &p->z);
    fq_sqr(&z2z2, &q->z);
    fq_mul(&u1, &p->x, &z2z2);
    fq_mul(&u2, &q->x, &z1z1);
    fq_mul(&t, &q->z, &z2z2);
    fq_mul(&s1, &p->y, &t);
    fq_mul(&t, &p->z, &z1z1);
    fq_mul(&s2, &q->y, &t);
    fq_sub(&h, &u2, &u1);
    if (fq_is_zero(&h)) {
        fq d;
        fq_sub(&d, &s2, &s1);
        if (fq_is_zero(&d)) { jac_dbl(r, p); return; }
        *r = JAC_INF;
        return;
    }
    fq_dbl(&t, &h);
    fq_sqr(&i, &t);
    fq_mul(&j, &h, &i);
    fq_sub(&rr, &s2, &s1);
    fq_dbl(&rr, &rr);
    fq_mul(&v, &u1, &i);
    fq_sqr(&x3, &rr);
    fq_sub(&x3, &x3, &j);
    fq_sub(&x3, &x3, &v);
    fq_sub(&x3, &x3, &v);
    fq_sub(&t, &v, &x3);
    fq_mul(&y3, &rr, &t);
    fq_mul(&t, &s1, &j);
    fq_dbl(&t, &t);
    fq_sub(&y3, &y3, &t);
    fq_add(&z3, &p->z, &q->z);
    fq_sqr(&z3, &z3);
    fq_sub(&z3, &z3, &z1z1);
    fq_sub(&z3, &z3, &z2z2);
    fq_mul(&z3, &z3, &h);
    r->x = x3; r->y = y3; r->z = z3;
}

/* mixed add: q affine (z = 1 implicit), Montgomery coords */
static void jac_add_affine(jac *r, const jac *p, const fq *qx, const fq *qy) {
    if (jac_is_inf(p)) {
        r->x = *qx; r->y = *qy;
        memcpy(r->z.v, RMODP, 32);
        return;
    }
    fq z1z1, u2, s2, h, hh, i, j, rr, v, t, x3, y3, z3;
    fq_sqr(&z1z1, &p->z);
    fq_mul(&u2, qx, &z1z1);
    fq_mul(&t, &p->z, &z1z1);
    fq_mul(&s2, qy, &t);
    fq_sub(&h, &u2, &p->x);
    if (fq_is_zero(&h)) {
        fq d;
        fq_sub(&d, &s2, &p->y);
        if (fq_is_zero(&d)) { jac_dbl(r, p); return; }
        *r = JAC_INF;
        return;
    }
    fq_sqr(&hh, &h);
    fq_dbl(&i, &hh);
    fq_dbl(&i, &i);
    fq_mul(&j, &h, &i);
    fq_sub(&rr, &s2, &p->y);
    fq_dbl(&rr, &rr);
    fq_mul(&v, &p->x, &i);
    fq_sqr(&x3, &rr);
    fq_sub(&x3, &x3, &j);
    fq_sub(&x3, &x3, &v);
    fq_sub(&x3, &x3, &v);
    fq_sub(&t, &v, &x3);
    fq_mul(&y3, &rr, &t);
    fq_mul(&t, &p->y, &j);
    fq_dbl(&t, &t);
    fq_sub(&y3, &y3, &t);
    fq_mul(&z3, &p->z, &h);
    fq_dbl(&z3, &z3);
    /* z3 = 2*z1*h per this i=4hh variant */
    r->x = x3; r->y = y3; r->z = z3;
}

/* boundary: 32-byte LE canonical -> Montgomery fq */
static void load_fq(fq *r, const uint8_t *src) {
    fq c;
    memcpy(c.v, src, 32);
    fq_to_mont(r, &c);
}

static void store_fq(uint8_t *dst, const fq *a) {
    fq c;
    fq_from_mont(&c, a);
    memcpy(dst, c.v, 32);
}

static void jac_to_affine_bytes(const jac *p, uint8_t *out_xy, uint8_t *out_inf) {
    if (jac_is_inf(p)) {
        memset(out_xy, 0, 64);
        *out_inf = 1;
        return;
    }
    fq zi, zi2, zi3, ax, ay;
    fq_inv(&zi, &p->z);
    fq_sqr(&zi2, &zi);
    fq_mul(&zi3, &zi2, &zi);
    fq_mul(&ax, &p->x, &zi2);
    fq_mul(&ay, &p->y, &zi3);
    store_fq(out_xy, &ax);
    store_fq(out_xy + 32, &ay);
    *out_inf = 0;
}

/* ---- exported entry points ------------------------------------------- */

/* c-bit window digit at bit offset `bit` of a 32-byte LE scalar. */
static unsigned digit_at(const uint8_t *s, int bit, int c) {
    int byte = bit >> 3, sh = bit & 7;
    unsigned v = s[byte];
    if (byte + 1 < 32) v |= (unsigned)s[byte + 1] << 8;
    if (byte + 2 < 32) v |= (unsigned)s[byte + 2] << 16;
    return (v >> sh) & ((1u << c) - 1);
}

/* Bucket-method Pippenger for larger n: ~(254/c) adds/point + 2*2^c
 * reduction adds per window, vs ~75 adds/point for the per-point-table
 * shared-doubling method below (which stays for small n where bucket
 * reduction would dominate). */
static void msm_pippenger(const uint8_t *scalars, const uint8_t *points_xy,
                          const uint8_t *inf, u64 n, jac *out) {
    int c;
    if (n >= (u64)1 << 14) c = 12;
    else if (n >= (u64)1 << 11) c = 10;
    else c = 8;
    int W = (254 + c - 1) / c;
    int nb = (1 << c) - 1;
    jac *buckets = (jac *)malloc(sizeof(jac) * nb);
    fq *axs = (fq *)malloc(sizeof(fq) * n);
    fq *ays = (fq *)malloc(sizeof(fq) * n);
    uint8_t *dead = (uint8_t *)malloc(n);
    for (u64 k = 0; k < n; k++) {
        dead[k] = inf && inf[k];
        if (!dead[k]) {
            load_fq(&axs[k], points_xy + 64 * k);
            load_fq(&ays[k], points_xy + 64 * k + 32);
        }
    }
    jac acc = JAC_INF;
    for (int w = W - 1; w >= 0; w--) {
        if (!jac_is_inf(&acc))
            for (int b = 0; b < c; b++) jac_dbl(&acc, &acc);
        for (int b = 0; b < nb; b++) buckets[b] = JAC_INF;
        int bit = w * c;
        for (u64 k = 0; k < n; k++) {
            if (dead[k]) continue;
            unsigned d = digit_at(scalars + 32 * k, bit, c);
            if (d)
                jac_add_affine(&buckets[d - 1], &buckets[d - 1],
                               &axs[k], &ays[k]);
        }
        jac run = JAC_INF, tot = JAC_INF;
        for (int b = nb - 1; b >= 0; b--) {
            jac_add(&run, &run, &buckets[b]);
            jac_add(&tot, &tot, &run);
        }
        jac_add(&acc, &acc, &tot);
    }
    free(buckets); free(axs); free(ays); free(dead);
    *out = acc;
}

/* MSM: scalars[n] 32B LE (mod r assumed), points: x||y 64B each, inf flags.
 * Bucket Pippenger for n >= 256, per-point-table shared-doubling 4-bit
 * windows below. Output affine bytes + inf flag. */
EXPORT void g1_msm(const uint8_t *scalars, const uint8_t *points_xy,
                   const uint8_t *inf, u64 n, uint8_t *out_xy,
                   uint8_t *out_inf) {
    enum { WBITS = 4, TSIZE = 1 << WBITS, TOP = 256 };
    if (n >= 256) {
        jac acc;
        msm_pippenger(scalars, points_xy, inf, n, &acc);
        jac_to_affine_bytes(&acc, out_xy, out_inf);
        return;
    }
    /* per-point tables of 1..15 multiples (jacobian, from affine input) */
    jac *tables = (jac *)malloc(sizeof(jac) * n * (TSIZE - 1));
    for (u64 k = 0; k < n; k++) {
        jac *row = tables + k * (TSIZE - 1);
        if (inf && inf[k]) {
            for (int d = 0; d < TSIZE - 1; d++) row[d] = JAC_INF;
            continue;
        }
        fq ax, ay;
        load_fq(&ax, points_xy + 64 * k);
        load_fq(&ay, points_xy + 64 * k + 32);
        jac base;
        base.x = ax; base.y = ay;
        memcpy(base.z.v, RMODP, 32);
        row[0] = base;
        for (int d = 1; d < TSIZE - 1; d++)
            jac_add_affine(&row[d], &row[d - 1], &ax, &ay);
    }
    jac acc = JAC_INF;
    for (int shift = TOP - WBITS; shift >= 0; shift -= WBITS) {
        if (!jac_is_inf(&acc))
            for (int b = 0; b < WBITS; b++) jac_dbl(&acc, &acc);
        int byte_idx = shift >> 3;
        int in_byte = shift & 7;
        for (u64 k = 0; k < n; k++) {
            unsigned d = (scalars[32 * k + byte_idx] >> in_byte) & (TSIZE - 1);
            if (d)
                jac_add(&acc, &acc, &tables[k * (TSIZE - 1) + d - 1]);
        }
    }
    free(tables);
    jac_to_affine_bytes(&acc, out_xy, out_inf);
}

/* out[i] = a * P[i] + b * Q[i] (Strauss-Shamir), batched over i.
 * Used for bullet generator folds G' = u_inv*G_L + u*G_R. */
EXPORT void g1_dual_mul_many(const uint8_t *a_scalar, const uint8_t *b_scalar,
                             const uint8_t *p_xy, const uint8_t *p_inf,
                             const uint8_t *q_xy, const uint8_t *q_inf,
                             u64 n, uint8_t *out_xy, uint8_t *out_inf) {
    for (u64 k = 0; k < n; k++) {
        fq px, py, qx, qy;
        int pi = p_inf && p_inf[k], qi = q_inf && q_inf[k];
        if (!pi) {
            load_fq(&px, p_xy + 64 * k);
            load_fq(&py, p_xy + 64 * k + 32);
        }
        if (!qi) {
            load_fq(&qx, q_xy + 64 * k);
            load_fq(&qy, q_xy + 64 * k + 32);
        }
        /* precompute P+Q */
        jac pq = JAC_INF;
        if (!pi) {
            pq.x = px; pq.y = py;
            memcpy(pq.z.v, RMODP, 32);
        }
        if (!qi) jac_add_affine(&pq, &pq, &qx, &qy);
        jac acc = JAC_INF;
        for (int i = 255; i >= 0; i--) {
            if (!jac_is_inf(&acc)) jac_dbl(&acc, &acc);
            unsigned ab = ((a_scalar[i >> 3] >> (i & 7)) & 1);
            unsigned bb = ((b_scalar[i >> 3] >> (i & 7)) & 1);
            if (ab && bb) jac_add(&acc, &acc, &pq);
            else if (ab && !pi) jac_add_affine(&acc, &acc, &px, &py);
            else if (bb && !qi) jac_add_affine(&acc, &acc, &qx, &qy);
        }
        jac_to_affine_bytes(&acc, out_xy + 64 * k, out_inf + k);
    }
}

/* ---- scalar-field (Fr) batch Montgomery conversion -------------------- */
/* BN254 scalar field r; R = 2^256. Used by the host encode/decode path:
 * values cross the boundary as 32-byte LE canonical, device arrays hold
 * vR mod r. */

static const u64 RP[4] = {0x43e1f593f0000001ULL, 0x2833e84879b97091ULL,
                          0xb85045b68181585dULL, 0x30644e72e131a029ULL};
static const u64 RNINV = 0xc2e1f593efffffffULL;
static const u64 RR2[4] = {0x1bb8e645ae216da7ULL, 0x53fe3ab1e35c59e3ULL,
                           0x8c49833d53bb8085ULL, 0x0216d0b17f4e44a5ULL};

static inline int geq_rp(const u64 a[4]) {
    for (int i = 3; i >= 0; i--) {
        if (a[i] > RP[i]) return 1;
        if (a[i] < RP[i]) return 0;
    }
    return 1;
}

static inline void sub_rp(u64 a[4]) {
    u128 bw = 0;
    for (int i = 0; i < 4; i++) {
        u128 t = (u128)a[i] - RP[i] - bw;
        a[i] = (u64)t;
        bw = (t >> 64) & 1;
    }
}

static void fr_mul_(u64 r[4], const u64 a[4], const u64 b[4]) {
    u64 t[6] = {0, 0, 0, 0, 0, 0};
    for (int i = 0; i < 4; i++) {
        u128 c = 0;
        for (int j = 0; j < 4; j++) {
            c += (u128)t[j] + (u128)a[i] * b[j];
            t[j] = (u64)c;
            c >>= 64;
        }
        c += t[4];
        t[4] = (u64)c;
        t[5] = (u64)(c >> 64);
        u64 m = t[0] * RNINV;
        c = (u128)t[0] + (u128)m * RP[0];
        c >>= 64;
        for (int j = 1; j < 4; j++) {
            c += (u128)t[j] + (u128)m * RP[j];
            t[j - 1] = (u64)c;
            c >>= 64;
        }
        c += t[4];
        t[3] = (u64)c;
        t[4] = t[5] + (u64)(c >> 64);
        t[5] = 0;
    }
    if (t[4] || geq_rp(t)) sub_rp(t);
    memcpy(r, t, 32);
}

/* in/out: n 32-byte LE values. dir != 0: canonical -> Montgomery (x * R),
 * dir == 0: Montgomery -> canonical (x * R^-1 via mul by 1). */
EXPORT void fr_batch_mont(const uint8_t *in, u64 n, int dir, uint8_t *out) {
    u64 one[4] = {1, 0, 0, 0};
    for (u64 i = 0; i < n; i++) {
        u64 v[4], o[4];
        memcpy(v, in + 32 * i, 32);
        fr_mul_(o, v, dir ? RR2 : one);
        memcpy(out + 32 * i, o, 32);
    }
}

/* single scalar multiple: out = k * P */
EXPORT void g1_scalar_mul(const uint8_t *k_scalar, const uint8_t *p_xy,
                          uint8_t p_inf, uint8_t *out_xy, uint8_t *out_inf) {
    uint8_t zero[32];
    memset(zero, 0, 32);
    g1_dual_mul_many(k_scalar, zero, p_xy, &p_inf, p_xy, &p_inf, 1,
                     out_xy, out_inf);
}
