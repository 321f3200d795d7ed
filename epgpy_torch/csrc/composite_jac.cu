// composite_jac.cu -- composite-GRE stage trains and their selected T1, T2,
// B1 and df tangents.
//
// Replaces the TPU kernel epgpy_tpu/models/pallas_composite.py:
// _kernel_comp_jac (:364, with its helper _shift_sel :334), driven there by
// composite_jacobian_pallas (:579); the Python wrapper is
// epgpy_torch/models/cuda_composite.py:composite_jacobian_cuda and the
// plain PyTorch twin beside it (composite_jacobian_plain) computes the same
// recurrence with the same operation order.
//
// What it computes, per atom: the forward-mode derivative of composite.cu
// for the tangent groups the 4-bit mask selects (bit 0 T1, 1 T2, 2 B1,
// 3 df).  Plane group 0 is the primal folded ladder, then one group of six
// planes per selected tangent, in that order: 6 (1 + ng) planes of
// H = nstate + 1 rows.  Every op of a stage is affine in the state, so a
// tangent goes through the primal's operator plus the derivative of its
// coefficients applied to the primal: T1 perturbs cZ and the k = 0 recovery
// (drec = -dcZ), T2 the carried cF and the echo's ta decay, B1 the rotation
// coefficients (one more rotation of the primal rows, da = fa b1u pi/180:
// adiabatic stages drop out), df the phasors -- i 2 pi t times the primal,
// t = ta on the echo and ta + tb on the carried F planes, computed whether
// or not a df is given so the df column is exact at df = 0.  The stage's
// shift and its D attenuation are parameter-free and apply to every group
// alike.  Output planes (2 + 2 ng, nadc, B): (re, im) per group, rows in ADC
// order.
//
// What bounds it on the card: the arithmetic, (1 + ng) rotated groups per
// row plus the B1 coefficient pass, with the state, 6 (1 + ng) (nstate + 1)
// floats per atom, too large for a thread.  The design is fisp_jac.cu's, on
// epg_planes.cuh's segmented layout: a ladder takes a segment of W =
// ceil(H / R) lanes and a warp holds 32 / W ladders (6 of 5 lanes at the
// main path's nstate 8, R = 2); lane r keeps rows r + W c, c < R, of every
// group in registers (G = 1 + ng and R are template parameters; which
// tangent a group holds is known at compile time where G leaves one
// choice, else a branch uniform across the block).  A stage is one step of
// R rows on every lane -- rotate, relax, the groups' coefficient terms --
// then the stage's shift, uniform across the warp: epg::seg_shift (+1),
// epg::seg_shift_down (-1) or none, and with D the attenuation computed
// per owned row.  The atom-independent terms of a chunk of up to 32 stages
// (the phase's sin/cos, the flip, ta, tb, b1u, the ADC phasor, the D base
// and ramp, the output row and the shift) sit in a table in shared memory
// that the block fills between two barriers; the atom's own terms of stage
// t0 + j (the flip's sin/cos, the decays and their tangents, the df
// phasors) are computed by lane j of the segment and broadcast by a
// shuffle when that stage runs.  The row-0 lane writes a readout stage's
// echoes into shared memory; after the chunk the block copies each to its
// own output row (adci is a permutation, not increasing) as runs of
// consecutive atoms.  A segment past the last atom runs on a clamped atom
// and stores nothing.  Math is precise (no fast-math).
#include <cuda_runtime.h>

#include <algorithm>

#include "epg_planes.cuh"

namespace {

constexpr float kDeg = 0.017453292519943295f;   // pi / 180
constexpr float kTwoPi = 6.283185307179586f;

// warps per block at most, stages per chunk at most, floats of one chunk's
// table and staged echoes (48 KB), table floats per stage; mirrored by
// cuda_fisp.SEG_WARPS, SEG_PULSES, SEG_CHUNK_FLOATS and
// cuda_composite.COMP_JAC_TABLE
constexpr int kMaxWarps = 4;
constexpr int kMaxStages = 32;
constexpr int kChunkFloats = 12288;
constexpr int kTab = 16;

struct CompJacArgs {
    const float* fa;    // (N,) flip angles, degrees
    const float* phi;   // (N,) RF phases, degrees
    const float* ta;    // (N,) relaxation before the readout, ms
    const float* tb;    // (N,) relaxation after the readout, ms
    const int* adci;    // (N,) output row, -1 = no readout
    const int* shift;   // (N,) shift direction in {-1, 0, +1}
    const float* aph;   // (N,) ADC phase, radians (use_adcph)
    const float* b1u;   // (N,) B1 sensitivity (use_b1u)
    const float* btd;   // (N,) b-value base per squared state index (use_d)
    const float* rdir;  // (N,) ramp direction in {-1, 0, +1} (use_d)
    const float* t1;    // (B,)
    const float* t2;    // (B,)
    const float* b1;    // (B,)
    const float* df;    // (B,) off-resonance, kHz (use_df) or unused
    const float* dc;    // (B,) diffusivity, mm^2/s (use_d) or unused
    float* out;         // (2 + 2 ng, nadc, B): (re, im) per group
    int N, B, H, nadc, mask;
    int use_df, use_up, use_down, use_adcph, use_b1u, use_d;
    int T;              // stages per chunk
};

using epg::fdecay;
using epg::rotate;
using epg::Row;

// An atom's terms of one stage.
struct StageTerms {
    float sa, ca;        // sin, cos of the flip
    float cZ, dcZ;       // Z decay over ta + tb and its T1 derivative
    float cFr, cFi;      // F decay over ta + tb, with the df phasor
    float dcFr, dcFi;    // its T2 derivative
    float e2a, de2a;     // the echo's decay over ta and its T2 derivative
    float pc, ps;        // the echo's phasor: df over ta, then the ADC phase
};

struct Atom {
    float T1, T2, B1, DF;
};

// The terms of the stage whose table entries are v1 = (fa, ta, tb, b1u) and
// v2 = (cos aph, sin aph, -, -).
__device__ __forceinline__ StageTerms stage_terms(const CompJacArgs& p,
                                                  const float4 v1,
                                                  const float4 v2,
                                                  const Atom& at) {
    const bool cdf = p.use_df != 0;
    StageTerms o;
    const float fa = v1.x;
    const float a = p.use_b1u ? fa * (1.0f + v1.w * (at.B1 - 1.0f)) * kDeg
                              : fa * at.B1 * kDeg;
    sincosf(a, &o.sa, &o.ca);
    const float ta = v1.y, tb = v1.z;
    const float tt = ta + tb;
    const float e1a = expf(-ta / at.T1);
    const float e1b = expf(-tb / at.T1);
    o.e2a = expf(-ta / at.T2);
    const float cF = o.e2a * expf(-tb / at.T2);
    o.cZ = e1a * e1b;
    o.de2a = o.e2a * ta / (at.T2 * at.T2);
    const float dcF = cF * tt / (at.T2 * at.T2);
    o.dcZ = o.cZ * tt / (at.T1 * at.T1);
    o.cFr = cF;
    o.cFi = 0.0f;
    o.dcFr = dcF;
    o.dcFi = 0.0f;
    o.pc = 1.0f;
    o.ps = 0.0f;
    if (cdf) {
        float pI, pR;
        sincosf(kTwoPi * at.DF * tt, &pI, &pR);
        o.cFr = cF * pR;
        o.cFi = cF * pI;
        o.dcFr = dcF * pR;
        o.dcFi = dcF * pI;
        sincosf(kTwoPi * at.DF * ta, &o.ps, &o.pc);
    }
    if (p.use_adcph) {
        if (cdf) {
            epg::cmul(o.pc, o.ps, v2.x, v2.y, o.pc, o.ps);
        } else {
            o.pc = v2.x;
            o.ps = v2.y;
        }
    }
    return o;
}

// Lane u of the segment hands its stage terms to the whole segment.
__device__ __forceinline__ StageTerms bcast(const epg::SegLane& q,
                                            const StageTerms& m, int u,
                                            bool cdf, bool phased) {
    StageTerms o = m;
    o.sa = epg::seg_bcast(q, m.sa, u);
    o.ca = epg::seg_bcast(q, m.ca, u);
    o.cZ = epg::seg_bcast(q, m.cZ, u);
    o.dcZ = epg::seg_bcast(q, m.dcZ, u);
    o.cFr = epg::seg_bcast(q, m.cFr, u);
    o.dcFr = epg::seg_bcast(q, m.dcFr, u);
    o.e2a = epg::seg_bcast(q, m.e2a, u);
    o.de2a = epg::seg_bcast(q, m.de2a, u);
    if (cdf) {
        o.cFi = epg::seg_bcast(q, m.cFi, u);
        o.dcFi = epg::seg_bcast(q, m.dcFi, u);
    }
    if (phased) {
        o.pc = epg::seg_bcast(q, m.pc, u);
        o.ps = epg::seg_bcast(q, m.ps, u);
    }
    return o;
}

template <int R>
__device__ __forceinline__ Row row(const float (&s)[6][R], int c) {
    return Row{s[0][c], s[1][c], s[2][c], s[3][c], s[4][c], s[5][c]};
}

template <int R>
__device__ __forceinline__ void put(float (&s)[6][R], int c, float nAR,
                                    float nAI, float nBR, float nBI,
                                    float nZR, float nZI) {
    s[0][c] = nAR;
    s[1][c] = nAI;
    s[2][c] = nBR;
    s[3][c] = nBI;
    s[4][c] = nZR;
    s[5][c] = nZI;
}

// The tangent kinds: T1, T2, B1, df (the mask's bits).  Group g >= 1 of G
// holds the g-th selected kind kd, which lies in [g - 1, g + 4 - G]: one
// choice when G = 5, so the kind is a compile-time constant there.
template <int G, int g, int K>
__device__ __forceinline__ bool holds(int kd) {
    return K >= g - 1 && K <= g + 4 - G && (G == 5 || kd == K);
}

// The kind of group g >= 1: the g-th set bit of the mask.
__device__ __forceinline__ int group_kind(int mask, int g) {
    int kk = 0;
    for (; kk < 3; ++kk)
        if (((mask >> kk) & 1) && --g == 0) break;
    return kk;
}

// What every group's row step reads: the stage's rotated primal row P (and
// its B1 coefficient pass Cb), the stage terms, the echo's output slot.
struct RowCtx {
    Row P, Cb;
    StageTerms pt;
    float fFr, fFi;   // d/ddf of the carried F coefficient: i 2 pi tt cF
    float pR, pI;     // the primal's echo
    float we;         // 2 pi ta
    bool k0, at_echo;
};

// The echo of a rotated k = 0 row: decay over ta, then the phasor.
__device__ __forceinline__ void echo_of(const RowCtx& x, bool phased,
                                        float re, float im, float& oR,
                                        float& oI) {
    oR = x.pt.e2a * re;
    oI = x.pt.e2a * im;
    if (phased) epg::cmul(x.pt.pc, x.pt.ps, oR, oI, oR, oI);
}

// Row c of tangent group g (kind kd): its rotated row, its echo into
// e[2 g TA], e[(2 g + 1) TA] and its relaxed new values.
template <int G, int g, int R>
__device__ __forceinline__ void group_row(float (&s)[6][R], int c, int kd,
                                          const epg::Rot& r,
                                          const RowCtx& x, bool cdf,
                                          bool phased, float* e, int TA) {
    const StageTerms& pt = x.pt;
    const Row t = rotate(r, row(s, c));
    float eR = 0.0f, eI = 0.0f;
    if (holds<G, g, 0>(kd)) {
        // dT1: only cZ and rec = 1 - cZ carry tangents
        if (x.at_echo) echo_of(x, phased, t.AR, t.AI, eR, eI);
        float nAR, nAI, nBR, nBI;
        fdecay(cdf, pt.cFr, pt.cFi, t.AR, t.AI, nAR, nAI);
        fdecay(cdf, pt.cFr, pt.cFi, t.BR, t.BI, nBR, nBI);
        float nZR = pt.cZ * t.ZR + pt.dcZ * x.P.ZR;
        if (x.k0) nZR = nZR - pt.dcZ;
        put(s, c, nAR, nAI, nBR, nBI, nZR, pt.cZ * t.ZI + pt.dcZ * x.P.ZI);
    } else if (holds<G, g, 1>(kd)) {
        // dT2: cF and the echo's ta decay
        if (x.at_echo) {
            float xR = pt.de2a * x.P.AR, xI = pt.de2a * x.P.AI;
            echo_of(x, phased, t.AR, t.AI, eR, eI);
            if (phased) epg::cmul(pt.pc, pt.ps, xR, xI, xR, xI);
            eR = eR + xR;
            eI = eI + xI;
        }
        float aR, aI, bR, bI, xaR, xaI, xbR, xbI;
        fdecay(cdf, pt.cFr, pt.cFi, t.AR, t.AI, aR, aI);
        fdecay(cdf, pt.dcFr, pt.dcFi, x.P.AR, x.P.AI, xaR, xaI);
        fdecay(cdf, pt.cFr, pt.cFi, t.BR, t.BI, bR, bI);
        fdecay(cdf, pt.dcFr, pt.dcFi, x.P.BR, x.P.BI, xbR, xbI);
        put(s, c, aR + xaR, aI + xaI, bR + xbR, bI + xbI, pt.cZ * t.ZR,
            pt.cZ * t.ZI);
    } else if (holds<G, g, 2>(kd)) {
        // dB1: the rotation coefficients' pass
        const Row& C = x.Cb;
        if (x.at_echo)
            echo_of(x, phased, t.AR + C.AR, t.AI + C.AI, eR, eI);
        float nAR, nAI, nBR, nBI;
        fdecay(cdf, pt.cFr, pt.cFi, t.AR + C.AR, t.AI + C.AI, nAR, nAI);
        fdecay(cdf, pt.cFr, pt.cFi, t.BR + C.BR, t.BI + C.BI, nBR, nBI);
        put(s, c, nAR, nAI, nBR, nBI, pt.cZ * (t.ZR + C.ZR),
            pt.cZ * (t.ZI + C.ZI));
    } else if (holds<G, g, 3>(kd)) {
        // ddf: the phasors' derivative on the primal
        if (x.at_echo) {
            echo_of(x, phased, t.AR, t.AI, eR, eI);
            eR = eR + -x.we * x.pI;
            eI = eI + x.we * x.pR;
        }
        float aR, aI, bR, bI, yaR, yaI, ybR, ybI;
        fdecay(cdf, pt.cFr, pt.cFi, t.AR, t.AI, aR, aI);
        fdecay(cdf, pt.cFr, pt.cFi, t.BR, t.BI, bR, bI);
        epg::cmul(x.fFr, x.fFi, x.P.AR, x.P.AI, yaR, yaI);
        epg::cmul(x.fFr, x.fFi, x.P.BR, x.P.BI, ybR, ybI);
        // Z carries no off-resonance
        put(s, c, aR + yaR, aI + yaI, bR + ybR, bI + ybI, pt.cZ * t.ZR,
            pt.cZ * t.ZI);
    }
    if (x.at_echo) {
        e[2 * g * TA] = eR;
        e[(2 * g + 1) * TA] = eI;
    }
}

// Register budget per instance (megre_jac.cu's): 3 blocks of kMaxWarps
// warps per SM (at most 168 registers) at R <= 2 rows per lane, no cap
// above.
template <int R>
constexpr int kMinBlocks = R <= 2 ? 3 : 1;
template <int R>
constexpr int kBoundThreads =
    (kMinBlocks<R> > 1 ? 1 : 2) * kMaxWarps * epg::kWarp;

// G = 1 + ng groups, R rows per lane.  Dynamic shared memory: the chunk's
// table (4 float4 per stage: cos phi, sin phi, cos 2phi, sin 2phi; fa, ta,
// tb, b1u; cos aph, sin aph, btd, rdir; adci, shift as int bits, -, -),
// then the staged echoes (2 G, T, A) of the block's A atoms.
template <int G, int R>
__global__ void __launch_bounds__(kBoundThreads<R>, kMinBlocks<R>)
    composite_jac_kernel(const CompJacArgs p) {
    extern __shared__ float4 smem[];
    constexpr int NO = 2 * G;
    const int T = p.T;
    float4* tab = smem;
    float* stage = reinterpret_cast<float*>(smem + 4 * T);
    const int H = p.H;
    const int W = (H + R - 1) / R;   // lanes per ladder
    const int L = epg::kWarp / W;
    const epg::SegLane q =
        epg::seg_lane(threadIdx.x & (epg::kWarp - 1), W, H);
    const int seg = q.base / W;
    const int A = static_cast<int>(blockDim.x / epg::kWarp) * L;
    const int slot = static_cast<int>(threadIdx.x / epg::kWarp) * L + seg;
    const int atom0 = blockIdx.x * A;
    const bool writer = q.r == 0 && seg < L;   // the segment's row-0 lane
    const int b = min(atom0 + slot, p.B - 1);  // clamped past the last atom
    const bool cdf = p.use_df != 0;
    const bool phased = cdf || p.use_adcph;
    const bool has_b1 = (p.mask & 4) != 0;
    const int TA = T * A;   // floats per staged output plane
    // the kind of each group (T1 0, T2 1, B1 2, df 3): the set bits in order
    const int kd1 = group_kind(p.mask, 1), kd2 = group_kind(p.mask, 2),
              kd3 = group_kind(p.mask, 3), kd4 = group_kind(p.mask, 4);

    Atom at;
    at.T1 = p.t1[b];
    at.T2 = p.t2[b];
    at.B1 = p.b1[b];
    at.DF = cdf ? p.df[b] : 0.0f;
    const float Dc = p.use_d ? p.dc[b] : 0.0f;

    float s[G][6][R];   // s[g][j][c]: plane j of group g, row r + W c
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
        for (int j = 0; j < 6; ++j)
#pragma unroll
            for (int c = 0; c < R; ++c) s[g][j][c] = 0.0f;
    if (q.r == 0) s[0][4][0] = 1.0f;

    const size_t plane = static_cast<size_t>(p.nadc) * p.B;
    for (int i0 = 0; i0 < p.N; i0 += T) {
        const int n = min(T, p.N - i0);
        for (int t = threadIdx.x; t < n; t += blockDim.x) {
            const int i = i0 + t;
            const float ph = p.phi[i] * kDeg;
            float sp, cp, s2p, c2p, as = 0.0f, ac = 1.0f;
            sincosf(ph, &sp, &cp);
            sincosf(2.0f * ph, &s2p, &c2p);
            if (p.use_adcph) sincosf(p.aph[i], &as, &ac);
            int dir = p.shift[i];
            if (!((dir > 0 && p.use_up) || (dir < 0 && p.use_down))) dir = 0;
            const int idx = p.adci[i];
            tab[4 * t] = make_float4(cp, sp, c2p, s2p);
            tab[4 * t + 1] = make_float4(p.fa[i], p.ta[i], p.tb[i],
                                         p.use_b1u ? p.b1u[i] : 1.0f);
            tab[4 * t + 2] = make_float4(ac, as, p.use_d ? p.btd[i] : 0.0f,
                                         p.use_d ? p.rdir[i] : 0.0f);
            tab[4 * t + 3] = make_float4(
                __int_as_float(idx >= 0 && idx < p.nadc ? idx : -1),
                __int_as_float(dir), 0.0f, 0.0f);
        }
        __syncthreads();
        for (int t0 = 0; t0 < n; t0 += W) {
            const int nu = min(W, n - t0);
            // this lane's atom terms of stage t0 + r, broadcast below
            const int tm = t0 + min(q.r, nu - 1);
            const StageTerms mine =
                stage_terms(p, tab[4 * tm + 1], tab[4 * tm + 2], at);
            for (int u = 0; u < nu; ++u) {
                const int t = t0 + u;
                RowCtx x;
                x.pt = bcast(q, mine, u, cdf, phased);
                const StageTerms& pt = x.pt;
                const float4 ph = tab[4 * t];   // cp, sp, c2p, s2p
                const float4 v1 = tab[4 * t + 1];
                const float4 v3 = tab[4 * t + 3];
                const int idx = __float_as_int(v3.x);
                const int dir = __float_as_int(v3.y);
                const epg::Rot r =
                    epg::rot_coeffs_sc(pt.sa, pt.ca, ph.x, ph.y, ph.z, ph.w);
                epg::Rot dr{};
                if (has_b1)
                    dr = epg::rot_coeffs_db1(
                        pt.sa, pt.ca,
                        p.use_b1u ? v1.x * v1.w * kDeg : v1.x * kDeg, ph.x,
                        ph.y, ph.z, ph.w);
                const float rec = 1.0f - pt.cZ;
                const float w = kTwoPi * (v1.y + v1.z);
                x.fFr = -w * pt.cFi;
                x.fFi = w * pt.cFr;
                x.we = kTwoPi * v1.y;
                float* const e = stage + t * A + slot;

#pragma unroll
                for (int c = 0; c < R; ++c) {
                    x.k0 = c == 0 && q.r == 0;
                    x.at_echo = c == 0 && writer && idx >= 0;
                    const Row xr = row(s[0], c);
                    x.P = rotate(r, xr);
                    if (has_b1) x.Cb = rotate(dr, xr);
                    x.pR = x.pI = 0.0f;
                    if (x.at_echo) {
                        echo_of(x, phased, x.P.AR, x.P.AI, x.pR, x.pI);
                        e[0] = x.pR;
                        e[TA] = x.pI;
                    }
                    {   // primal
                        float nAR, nAI, nBR, nBI;
                        fdecay(cdf, pt.cFr, pt.cFi, x.P.AR, x.P.AI, nAR, nAI);
                        fdecay(cdf, pt.cFr, pt.cFi, x.P.BR, x.P.BI, nBR, nBI);
                        float nZR = pt.cZ * x.P.ZR;
                        if (x.k0) nZR = nZR + rec;
                        put(s[0], c, nAR, nAI, nBR, nBI, nZR, pt.cZ * x.P.ZI);
                    }
                    if constexpr (G > 1)
                        group_row<G, 1, R>(s[1], c, kd1, r, x, cdf,
                                           phased, e, TA);
                    if constexpr (G > 2)
                        group_row<G, 2, R>(s[2], c, kd2, r, x, cdf,
                                           phased, e, TA);
                    if constexpr (G > 3)
                        group_row<G, 3, R>(s[3], c, kd3, r, x, cdf,
                                           phased, e, TA);
                    if constexpr (G > 4)
                        group_row<G, 4, R>(s[4], c, kd4, r, x, cdf,
                                           phased, e, TA);
                }
                if (dir > 0) {
#pragma unroll
                    for (int g = 0; g < G; ++g) epg::seg_shift(q, s[g]);
                } else if (dir < 0) {
#pragma unroll
                    for (int g = 0; g < G; ++g) epg::seg_shift_down(q, s[g]);
                }
                const float4 v2 = tab[4 * t + 2];   // -, -, btd, rdir
                const float bt = v2.z;
                if (p.use_d && bt != 0.0f) {
                    // a stage without D: every factor is 1
                    const float rd = v2.w;
#pragma unroll
                    for (int c = 0; c < R; ++c) {
                        const epg::StageAtt f =
                            epg::stage_att(q.r + W * c, bt, rd, Dc);
#pragma unroll
                        for (int g = 0; g < G; ++g) {
                            s[g][0][c] *= f.aA;
                            s[g][1][c] *= f.aA;
                            s[g][2][c] *= f.aB;
                            s[g][3][c] *= f.aB;
                            s[g][4][c] *= f.aZ;
                            s[g][5][c] *= f.aZ;
                        }
                    }
                }
            }
        }
        __syncthreads();
        // each readout stage's staged echoes to its own output row: thread
        // i keeps atom a = i % A and walks the (output, stage) rows
        const int step = blockDim.x / A;
        const int a = threadIdx.x % A;
        const int i = threadIdx.x / A;
        if (i < step && atom0 + a < p.B) {
            for (int rw = i; rw < NO * n; rw += step) {
                const int o = rw / n, t = rw - o * n;
                const int idx = __float_as_int(tab[4 * t + 3].x);
                if (idx >= 0)
                    p.out[o * plane + static_cast<size_t>(idx) * p.B + atom0
                          + a] = stage[(o * T + t) * A + a];
            }
        }
        __syncthreads();   // the next chunk's table overwrites the rows
    }
}

template <int G, int R>
int launch(CompJacArgs a, int warps, cudaStream_t stream) {
    const int W = (a.H + R - 1) / R;
    const int A = warps * (epg::kWarp / W);
    const int per = kTab + 2 * G * A;
    a.T = std::min(kMaxStages, std::max(1, kChunkFloats / per));
    const size_t smem = sizeof(float) * static_cast<size_t>(a.T) * per;
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            composite_jac_kernel<G, R>,
            cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (e != cudaSuccess) return static_cast<int>(e);
    }
    const int grid = (a.B + A - 1) / A;
    composite_jac_kernel<G, R>
        <<<grid, warps * epg::kWarp, smem, stream>>>(a);
    return static_cast<int>(cudaGetLastError());
}

template <int G>
int launch_r(const CompJacArgs& a, int R, int warps, cudaStream_t st) {
    switch (R) {
        case 1: return launch<G, 1>(a, warps, st);
        case 2: return launch<G, 2>(a, warps, st);
        case 3:
            if constexpr (G <= 4) return launch<G, 3>(a, warps, st);
            break;
        case 4:
            if constexpr (G <= 3) return launch<G, 4>(a, warps, st);
            break;
        case 5:
            if constexpr (G <= 2) return launch<G, 5>(a, warps, st);
            break;
        case 10:
            if constexpr (G == 1) return launch<G, 10>(a, warps, st);
            break;
        default:
            break;
    }
    return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Launch on `stream` of CUDA device `device`; allocates nothing.  Returns
// the CUDA error code of the launch (0 on success); the caller raises on
// anything else.  `block` is warps per block (at most 4) and `R` the
// ladder's rows per lane, both from cuda_composite.comp_jac_geometry; an
// instance exists for R <= 2 with 4 groups, 3 with 3, 4 with 2, 5 with 1
// and R = 10 without groups (the gate's edges), and W = ceil(H / R) must
// fit a warp.
extern "C" int epg_composite_jac(const float* fa, const float* phi,
                                 const float* ta, const float* tb,
                                 const int* adci, const int* shift,
                                 const float* aph, const float* b1u,
                                 const float* btd, const float* rdir,
                                 const float* t1, const float* t2,
                                 const float* b1, const float* df,
                                 const float* dc, float* out, int N, int B,
                                 int nadc, int nstate, int R, int mask,
                                 int use_df, int use_up, int use_down,
                                 int use_adcph, int use_b1u, int use_d,
                                 int block, int device, void* stream) {
    CompJacArgs a{fa, phi, ta, tb, adci, shift, aph, b1u, btd, rdir, t1, t2,
                  b1, df, dc, out, N, B, nstate + 1, nadc, mask & 15, use_df,
                  use_up, use_down, use_adcph, use_b1u, use_d, 0};
    const int G = 1 + __builtin_popcount(static_cast<unsigned>(a.mask));
    const cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (block < 1 || block > kMaxWarps || a.H < 2 || R < 1 ||
        (a.H + R - 1) / R > epg::kWarp)
        return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (G) {
        case 1: return launch_r<1>(a, R, block, st);
        case 2: return launch_r<2>(a, R, block, st);
        case 3: return launch_r<3>(a, R, block, st);
        case 4: return launch_r<4>(a, R, block, st);
        default: return launch_r<5>(a, R, block, st);
    }
}
