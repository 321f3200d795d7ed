// fisp_jac.cu -- FISP fingerprints and their dT1/dT2/dB1[/dD] tangents.
//
// Replaces the TPU kernel epgpy_tpu/models/pallas_fisp.py:_kernel_jac
// (:458), driven there by fisp_jacobian_pallas (:775); the Python wrapper
// is epgpy_torch/models/cuda_fisp.py:fisp_jacobian_cuda and the plain
// PyTorch twin beside it (fisp_jacobian_plain) computes the same recurrence
// with the same operation order.
//
// What it computes, per atom: the forward-mode derivative of fisp_half.cu.
// Plane group 0 is the primal folded ladder (A/B/Z re+im, H = nstate + 1
// rows); groups 1-3 are its tangents w.r.t. T1, T2 and B1, group 4 (with
// track_d) w.r.t. the diffusivity D: 24 planes, or 30.  The coefficient
// tangents are sparse: T1 perturbs only cZ and the k = 0 recovery
// rec = 1 - cZ (so drec = -dcZ), T2 only cF and the TE decay of the echo,
// B1 only the rotation coefficients (one extra rotation of the primal
// planes by the coefficient derivatives), D only the post-shift
// attenuation (x' = A(D) M x, so t' = A M t + A'(D) M x).  An inversion
// prep seeds its tangents in closed form.  Per pulse the k = 0 echo of
// every group is written out (2 + 2G outputs of (P, B), re and im).
//
// What bounds it on the card: the operations -- per atom per pulse 4 (5)
// rotations of H rows plus the B1 coefficient pass, ~5x the primal's --
// while the state, 24 (30) x H floats per atom, is 4.5x the primal's and
// did not fit a thread.  The design is epg_planes.cuh's segmented layout:
// a ladder takes a segment of W = ceil(H / R) lanes and a warp holds
// 32 / W ladders; lane r keeps rows r + W c, c < R, of every group in
// registers (R = 2 at the main paths' nstate 10: 5 ladders of 6 lanes per
// warp; R and the group count are template parameters, so no array sits
// in local memory).  A pulse is one step of R rows on every lane --
// rotate, relax, write the new values in place -- and epg::seg_shift
// moves them with two shuffles per plane pair and row.  What a lane does
// once per pulse serves its R rows, and the per-atom scalars are not
// recomputed on every lane: the atom-independent terms of a chunk of up
// to 32 pulses (the RF phase's sin/cos, the flip, TR, TE) sit in a table
// in shared memory that the block fills between two barriers; the atom's
// own terms of pulse t0 + j (sin/cos of the B1-scaled flip, the
// relaxation factors, the df phasors) are computed by lane j of the
// segment and broadcast by a shuffle when that pulse runs; the diffusion
// factors are constant and a lane computes its rows' once.  The row-0
// lane writes the chunk's echoes into shared memory, and after the chunk
// the block copies them out as runs of consecutive atoms (the (2 + 2G, P,
// B) layout).  Blocks of 4 warps keep the register file's granularity
// fine (3 blocks per SM at <= 168 registers).  A segment past the last
// atom runs on a clamped atom and stores nothing.  Math is precise (no
// fast-math), in the thread-per-atom kernel's operation order.
#include <cuda_runtime.h>

#include <algorithm>

#include "epg_planes.cuh"

namespace {

constexpr float kDeg = 0.017453292519943295f;   // pi / 180
constexpr float kPi = 3.141592653589793f;
constexpr float kTwoPi = 6.283185307179586f;

// warps per block at most, pulses per chunk at most, floats of one chunk's
// table and staged echoes (48 KB), table floats per pulse; mirrored by
// cuda_fisp.SEG_WARPS, SEG_PULSES, SEG_CHUNK_FLOATS and SEG_TABLE
constexpr int kMaxWarps = 4;
constexpr int kMaxPulses = 32;
constexpr int kChunkFloats = 12288;
constexpr int kTab = 8;

struct JacArgs {
    const float* fa;    // (P,) flip angles, degrees
    const float* phi;   // (P,) RF phases, degrees
    const float* tr;    // (P,) repetition times, ms
    const float* te;    // (P,) echo times (var_te) or unused
    float te0;          // constant echo time (!var_te)
    float ti;           // inversion delay (use_inv)
    const float* t1;    // (B,)
    const float* t2;    // (B,)
    const float* b1;    // (B,)
    const float* df;    // (B,) off-resonance, kHz (use_df) or unused
    const float* dc;    // (B,) diffusivity (use_diff) or unused
    float bT, bL;       // transverse/longitudinal b-value bases (use_diff)
    float* out;         // (2 + 2G, P, B): re, im, then (re, im) per tangent
    int P, B, H;
    int var_te, use_inv, inv_df, use_df, demod, use_diff, diff_ramp, track_d;
    int T;              // pulses per chunk
};

using epg::fdecay;
using epg::rotate;
using epg::Row;

// An atom's constants: its parameters and, without var_te, the echo's TE
// terms.
struct Atom {
    float T1, T2, B1, DF;
    float E1te, E2te, dE2te, pteR, pteI;
};

// An atom's terms of one pulse.
struct PulseTerms {
    float sa, ca;        // sin, cos of the B1-scaled flip
    float cZ, dcZ;       // Z decay over the TR and its T1 derivative
    float cFr, cFi;      // F decay over the TR, with the df phasor
    float dcFr, dcFi;    // its T2 derivative
    float e2te, de2te;   // TE decay of the echo and its T2 derivative
    float pteR, pteI;    // df phasor of the echo
};

// The terms of the pulse whose table entry is pv = (fa, TR, TE, -).
__device__ __forceinline__ PulseTerms pulse_terms(const JacArgs& p,
                                                  const float4 pv,
                                                  const Atom& at) {
    const bool cdf = p.use_df != 0;
    PulseTerms o;
    sincosf(pv.x * at.B1 * kDeg, &o.sa, &o.ca);
    const float te = pv.z;
    float e1te;
    if (p.var_te) {
        e1te = expf(-te / at.T1);
        o.e2te = expf(-te / at.T2);
        o.de2te = o.e2te * te / (at.T2 * at.T2);
        o.pteR = 1.0f;
        o.pteI = 0.0f;
        if (cdf) sincosf(kTwoPi * at.DF * te, &o.pteI, &o.pteR);
    } else {
        e1te = at.E1te;
        o.e2te = at.E2te;
        o.de2te = at.dE2te;
        o.pteR = at.pteR;
        o.pteI = at.pteI;
    }
    const float TRi = pv.y;
    const float rem = TRi - te;
    const float E1b = expf(-rem / at.T1);
    const float E2b = expf(-rem / at.T2);
    const float cF = o.e2te * E2b;
    o.cZ = e1te * E1b;
    o.dcZ = o.cZ * TRi / (at.T1 * at.T1);
    const float dcF = cF * TRi / (at.T2 * at.T2);
    o.cFr = cF;
    o.cFi = 0.0f;
    o.dcFr = dcF;
    o.dcFi = 0.0f;
    if (cdf) {
        float pI, pR;
        sincosf(kTwoPi * at.DF * TRi, &pI, &pR);
        o.cFr = cF * pR;
        o.cFi = cF * pI;
        o.dcFr = dcF * pR;
        o.dcFi = dcF * pI;
    }
    return o;
}


// Lane u of the segment hands its pulse terms to the whole segment: what
// varies from pulse to pulse (the rest are the atom's constants, the same
// on every lane of the segment).
__device__ __forceinline__ PulseTerms bcast(const epg::SegLane& q,
                                            const PulseTerms& m, int u,
                                            bool cdf, bool var_te) {
    PulseTerms o = m;
    o.sa = epg::seg_bcast(q, m.sa, u);
    o.ca = epg::seg_bcast(q, m.ca, u);
    o.cZ = epg::seg_bcast(q, m.cZ, u);
    o.dcZ = epg::seg_bcast(q, m.dcZ, u);
    o.cFr = epg::seg_bcast(q, m.cFr, u);
    o.dcFr = epg::seg_bcast(q, m.dcFr, u);
    if (cdf) {
        o.cFi = epg::seg_bcast(q, m.cFi, u);
        o.dcFi = epg::seg_bcast(q, m.dcFi, u);
    }
    if (var_te) {
        o.e2te = epg::seg_bcast(q, m.e2te, u);
        o.de2te = epg::seg_bcast(q, m.de2te, u);
        if (cdf) {
            o.pteR = epg::seg_bcast(q, m.pteR, u);
            o.pteI = epg::seg_bcast(q, m.pteI, u);
        }
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

// Register budget per instance: 3 blocks of kMaxWarps warps per SM (at
// most 168 registers) where that needs no spill -- R <= 2 rows per lane
// without the dD group -- and no cap for the others, whose state does not
// fit 168 registers (ptxas -v: 0 B of stack for every instance).
template <int R, int G>
constexpr int kMinBlocks = R <= 2 && G == 3 ? 3 : 1;
template <int R, int G>
constexpr int kBoundThreads =
    (kMinBlocks<R, G> > 1 ? 1 : 2) * kMaxWarps * epg::kWarp;

// R rows per lane, G tangent groups (3, or 4 with track_d).  Dynamic
// shared memory: the chunk's table (2 float4 per pulse: cos phi, sin phi,
// cos 2phi, sin 2phi; fa, TR, TE, -), then the staged echoes (2 + 2G, T,
// A) of the block's A atoms.
template <int R, int G>
__global__ void __launch_bounds__(kBoundThreads<R, G>, kMinBlocks<R, G>)
    fisp_jac_kernel(const JacArgs p) {
    extern __shared__ float4 smem[];
    constexpr int NO = 2 + 2 * G;
    const int T = p.T;
    float4* tab = smem;
    float* stage = reinterpret_cast<float*>(smem + 2 * T);
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
    const int TA = T * A;   // floats per staged output plane

    Atom at;
    at.T1 = p.t1[b];
    at.T2 = p.t2[b];
    at.B1 = p.b1[b];
    at.DF = cdf ? p.df[b] : 0.0f;
    at.E1te = at.E2te = at.dE2te = 0.0f;
    at.pteR = 1.0f;
    at.pteI = 0.0f;
    if (!p.var_te) {
        at.E1te = expf(-p.te0 / at.T1);
        at.E2te = expf(-p.te0 / at.T2);
        at.dE2te = at.E2te * p.te0 / (at.T2 * at.T2);
        if (cdf) sincosf(kTwoPi * at.DF * p.te0, &at.pteI, &at.pteR);
    }
    const float Dc = p.use_diff ? p.dc[b] : 0.0f;
    float att[R][3], datt[R][3];   // the rows' diffusion factors
#pragma unroll
    for (int c = 0; c < R; ++c)
        epg::seg_att(q.r + W * c, p.bT, p.bL, p.diff_ramp != 0, Dc,
                     att[c], datt[c]);

    float s[G + 1][6][R];   // s[g][j][c]: plane j of group g, row r + W c
#pragma unroll
    for (int g = 0; g <= G; ++g)
#pragma unroll
        for (int j = 0; j < 6; ++j)
#pragma unroll
            for (int c = 0; c < R; ++c) s[g][j][c] = 0.0f;
    if (q.r == 0) {
        if (p.use_inv) {
            // inversion prep and its (dT1, dT2, dB1) tangents, closed form
            const float ai = kPi * at.B1;
            float sai, cai;
            sincosf(ai, &sai, &cai);
            const float E1i = expf(-p.ti / at.T1);
            const float E2i = expf(-p.ti / at.T2);
            const float fpi = -sai * E2i;
            s[0][4][0] = cai * E1i + 1.0f - E1i;
            const float dE1i = E1i * p.ti / (at.T1 * at.T1);
            const float dE2i = E2i * p.ti / (at.T2 * at.T2);
            s[1][4][0] = (cai - 1.0f) * dE1i;
            const float dfpi = -sai * dE2i;
            const float bfpi = -cai * kPi * E2i;
            s[3][4][0] = -sai * kPi * E1i;
            // the residual F+ of the primal, dT2 and dB1 groups; with df
            // the TI precession multiplies it and its tangents by one
            // parameter-independent phasor
            const bool prec = cdf && p.inv_df;
            float sth = 0.0f, cth = 1.0f;
            if (prec) sincosf(kTwoPi * at.DF * p.ti, &sth, &cth);
            auto seed = [&](float (&g)[6][R], float v) {
                if (prec) {
                    g[0][0] = -v * sth;
                    g[1][0] = v * cth;
                    g[2][0] = -v * sth;
                    g[3][0] = v * cth;
                } else {
                    g[1][0] = v;
                    g[3][0] = v;
                }
            };
            seed(s[0], fpi);
            seed(s[2], dfpi);
            seed(s[3], bfpi);
        } else {
            s[0][4][0] = 1.0f;
        }
    }

    const size_t plane = static_cast<size_t>(p.P) * p.B;
    for (int i0 = 0; i0 < p.P; i0 += T) {
        const int n = min(T, p.P - i0);
        for (int t = threadIdx.x; t < n; t += blockDim.x) {
            const int i = i0 + t;
            const float ph = p.phi[i] * kDeg;
            float sp, cp, s2p, c2p;
            sincosf(ph, &sp, &cp);
            sincosf(2.0f * ph, &s2p, &c2p);
            tab[2 * t] = make_float4(cp, sp, c2p, s2p);
            tab[2 * t + 1] = make_float4(p.fa[i], p.tr[i],
                                         p.var_te ? p.te[i] : p.te0, 0.0f);
        }
        __syncthreads();
        for (int t0 = 0; t0 < n; t0 += W) {
            const int nu = min(W, n - t0);
            // this lane's atom terms of pulse t0 + r, broadcast below
            const PulseTerms mine =
                pulse_terms(p, tab[2 * (t0 + min(q.r, nu - 1)) + 1], at);
            for (int u = 0; u < nu; ++u) {
                const int t = t0 + u;
                const PulseTerms pt = bcast(q, mine, u, cdf, p.var_te != 0);
                const float4 ph = tab[2 * t];   // cp, sp, c2p, s2p
                const float fa = tab[2 * t + 1].x;
                const epg::Rot r = epg::rot_coeffs_sc(pt.sa, pt.ca, ph.x,
                                                      ph.y, ph.z, ph.w);
                const epg::Rot dr = epg::rot_coeffs_db1(
                    pt.sa, pt.ca, fa * kDeg, ph.x, ph.y, ph.z, ph.w);
                // rec == (1 - E1te) E1b + (1 - E1b)
                const float rec = 1.0f - pt.cZ;

                // echo of group o from its rotated k = 0 row (the row-0
                // lanes): df phase, demod, into the stage
                float* const e = stage + t * A + slot;
                auto write = [&](int o, float eR, float eI) {
                    if (cdf) epg::cmul(pt.pteR, pt.pteI, eR, eI, eR, eI);
                    if (p.demod) {
                        const float dR = eR * ph.x + eI * ph.y;
                        eI = eI * ph.x - eR * ph.y;
                        eR = dR;
                    }
                    e[2 * o * TA] = eR;
                    e[(2 * o + 1) * TA] = eI;
                };

#pragma unroll
                for (int c = 0; c < R; ++c) {
                    const bool k0 = c == 0 && q.r == 0;
                    const bool echo = c == 0 && writer;
                    // primal: rotation, and the B1 coefficient pass over it
                    const Row x = row(s[0], c);
                    const Row P = rotate(r, x);
                    const Row C = rotate(dr, x);
                    if (echo) write(0, pt.e2te * P.AR, pt.e2te * P.AI);
                    {
                        float nAR, nAI, nBR, nBI;
                        fdecay(cdf, pt.cFr, pt.cFi, P.AR, P.AI, nAR, nAI);
                        fdecay(cdf, pt.cFr, pt.cFi, P.BR, P.BI, nBR, nBI);
                        float nZR = pt.cZ * P.ZR;
                        if (k0) nZR = nZR + rec;
                        put(s[0], c, nAR, nAI, nBR, nBI, nZR, pt.cZ * P.ZI);
                    }
                    {   // dT1: only cZ and rec = 1 - cZ carry tangents
                        const Row t1 = rotate(r, row(s[1], c));
                        if (echo) write(1, pt.e2te * t1.AR, pt.e2te * t1.AI);
                        float nAR, nAI, nBR, nBI;
                        fdecay(cdf, pt.cFr, pt.cFi, t1.AR, t1.AI, nAR, nAI);
                        fdecay(cdf, pt.cFr, pt.cFi, t1.BR, t1.BI, nBR, nBI);
                        float nZR = pt.cZ * t1.ZR + pt.dcZ * P.ZR;
                        if (k0) nZR = nZR - pt.dcZ;
                        put(s[1], c, nAR, nAI, nBR, nBI, nZR,
                            pt.cZ * t1.ZI + pt.dcZ * P.ZI);
                    }
                    {   // dT2: only cF (and E2te on the echo) carry tangents
                        const Row t2 = rotate(r, row(s[2], c));
                        if (echo)
                            write(2, pt.e2te * t2.AR + pt.de2te * P.AR,
                                  pt.e2te * t2.AI + pt.de2te * P.AI);
                        float aR, aI, bR, bI, xaR, xaI, xbR, xbI;
                        fdecay(cdf, pt.cFr, pt.cFi, t2.AR, t2.AI, aR, aI);
                        fdecay(cdf, pt.dcFr, pt.dcFi, P.AR, P.AI, xaR, xaI);
                        fdecay(cdf, pt.cFr, pt.cFi, t2.BR, t2.BI, bR, bI);
                        fdecay(cdf, pt.dcFr, pt.dcFi, P.BR, P.BI, xbR, xbI);
                        put(s[2], c, aR + xaR, aI + xaI, bR + xbR, bI + xbI,
                            pt.cZ * t2.ZR, pt.cZ * t2.ZI);
                    }
                    {   // dB1: only the rotation coefficients carry tangents
                        const Row t3 = rotate(r, row(s[3], c));
                        if (echo)
                            write(3, pt.e2te * (t3.AR + C.AR),
                                  pt.e2te * (t3.AI + C.AI));
                        float nAR, nAI, nBR, nBI;
                        fdecay(cdf, pt.cFr, pt.cFi, t3.AR + C.AR, t3.AI + C.AI,
                               nAR, nAI);
                        fdecay(cdf, pt.cFr, pt.cFi, t3.BR + C.BR, t3.BI + C.BI,
                               nBR, nBI);
                        put(s[3], c, nAR, nAI, nBR, nBI,
                            pt.cZ * (t3.ZR + C.ZR), pt.cZ * (t3.ZI + C.ZI));
                    }
                    if (G == 4) {
                        // dD: the attenuation's derivative enters after the
                        // shift
                        const Row t4 = rotate(r, row(s[G], c));
                        if (echo) write(4, pt.e2te * t4.AR, pt.e2te * t4.AI);
                        float nAR, nAI, nBR, nBI;
                        fdecay(cdf, pt.cFr, pt.cFi, t4.AR, t4.AI, nAR, nAI);
                        fdecay(cdf, pt.cFr, pt.cFi, t4.BR, t4.BI, nBR, nBI);
                        put(s[G], c, nAR, nAI, nBR, nBI, pt.cZ * t4.ZR,
                            pt.cZ * t4.ZI);
                    }
                }
#pragma unroll
                for (int g = 0; g <= G; ++g) epg::seg_shift(q, s[g]);

                if (p.use_diff) {
                    // post-shift diffusion attenuation, per destination
                    // row; the dD group adds A'(D) times the shifted,
                    // unattenuated primal
#pragma unroll
                    for (int c = 0; c < R; ++c) {
#pragma unroll
                        for (int g = 1; g <= G; ++g)
#pragma unroll
                            for (int j = 0; j < 6; ++j) {
                                float v = s[g][j][c] * att[c][j / 2];
                                if (g == 4)
                                    v = v + datt[c][j / 2] * s[0][j][c];
                                s[g][j][c] = v;
                            }
#pragma unroll
                        for (int j = 0; j < 6; ++j)
                            s[0][j][c] *= att[c][j / 2];
                    }
                }
            }
        }
        __syncthreads();
        epg::flush_stage(stage, p.out, NO, T, n, A, plane, i0, p.B, atom0);
    }
}

template <int R, int G>
int launch(JacArgs a, int warps, cudaStream_t stream) {
    const int W = (a.H + R - 1) / R;
    const int A = warps * (epg::kWarp / W);
    const int per = kTab + (2 + 2 * G) * A;
    a.T = std::min(kMaxPulses, std::max(1, kChunkFloats / per));
    const size_t smem = sizeof(float) * static_cast<size_t>(a.T) * per;
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            fisp_jac_kernel<R, G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (e != cudaSuccess) return static_cast<int>(e);
    }
    const int grid = (a.B + A - 1) / A;
    fisp_jac_kernel<R, G>
        <<<grid, warps * epg::kWarp, smem, stream>>>(a);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream` of CUDA device `device`; allocates nothing.  Returns
// the CUDA error code of the launch (0 on success); the caller raises on
// anything else.  `block` is warps per block (at most 4); the ladder may
// have at most 96 rows (epg::seg_rows: R <= 3 rows per lane).
extern "C" int epg_fisp_jac(const float* fa, const float* phi,
                            const float* tr, const float* te, float te0,
                            float ti, const float* t1, const float* t2,
                            const float* b1, const float* df,
                            const float* dc, float bT, float bL, float* out,
                            int P, int B, int nstate, int var_te, int use_inv,
                            int inv_df, int use_df, int demod, int use_diff,
                            int diff_ramp, int track_d, int block, int device,
                            void* stream) {
    JacArgs a{fa, phi, tr, te, te0, ti, t1, t2, b1, df, dc, bT, bL, out,
              P, B, nstate + 1, var_te, use_inv, inv_df, use_df, demod,
              use_diff, diff_ramp, track_d, 0};
    const cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (block < 1 || block > kMaxWarps || a.H < 2 || a.H > 3 * epg::kWarp)
        return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (epg::seg_rows(a.H) + (track_d ? 3 : 0)) {
        case 1: return launch<1, 3>(a, block, st);
        case 2: return launch<2, 3>(a, block, st);
        case 3: return launch<3, 3>(a, block, st);
        case 4: return launch<1, 4>(a, block, st);
        case 5: return launch<2, 4>(a, block, st);
        case 6: return launch<3, 4>(a, block, st);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}
