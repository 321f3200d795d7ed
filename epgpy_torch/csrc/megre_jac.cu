// megre_jac.cu -- ME-GRE echoes and their dT1/dT2/dB1/ddf tangents.
//
// Replaces the TPU kernel epgpy_tpu/models/pallas_megre.py:_kernel_megre_jac
// (:220), driven there by megre_jacobian_pallas (:391); the Python wrapper
// is epgpy_torch/models/cuda_megre.py:megre_jacobian_cuda and the plain
// PyTorch twin beside it (megre_jacobian_echoes_plain) computes the same
// recurrence with the same operation order.
//
// What it computes, per atom: the forward-mode derivative of megre.cu.
// Plane group 0 is the primal folded ladder, groups 1-4 its tangents
// w.r.t. T1, T2, B1 and the off-resonance df: 30 planes of H = nstate + 1
// rows.  The coefficient tangents are sparse: T1 perturbs only cZ and the
// k = 0 recovery (drec = -dcZ), T2 only the full-TR cF and each echo's TE
// decay, B1 only the rotation coefficients (one extra rotation of the
// primal planes), df only the phasors -- d/ddf e^{i 2 pi df t} = i 2 pi t
// e^{i 2 pi df t}, with t = te_j on echo j and t = TR on the carried F
// planes.  The df group is carried whether or not a df is given: at df = 0
// its F coefficient i 2 pi TR cF is not zero, so the df column is exact
// where a B0 fit starts.  Per TR every group writes m echoes from its
// rotated k = 0 row: output planes (10, m P, B), (re, im) per group, rows
// in the train's ADC order i m + j.
//
// What bounds it on the card: the operations (five rotated groups plus the
// B1 coefficient pass per row, ~6x the primal's), with the bytes not far
// below: the output is 5x the primal's (6.3 GB at 262,144 atoms x 200 TRs
// x 3 echoes).  The design is fisp_jac.cu's, on epg_planes.cuh's
// segmented layout: a ladder takes a segment of W = ceil(H / R) lanes, a
// warp holds 32 / W ladders (6 ladders of 5 lanes, R = 2 rows per lane,
// at nstate 8), lane r keeps rows r + W c of the 30 planes in registers
// (R a template parameter), a pulse is one step of R rows per lane and
// epg::seg_shift moves the new values by shuffles.  The atom-independent
// terms of a chunk of pulses, the echo times included, sit in a table in
// shared memory; the atom's own terms of pulse t0 + j are computed by
// lane j of the segment and broadcast when the pulse runs.  The echoes
// are spread too: the row-0 lane broadcasts the rotated k = 0 values its
// groups' echoes read (12 floats), and lane j of the segment computes
// echo j's TE decay and df phasor and writes that echo's 10 outputs into
// shared memory (every lane computes an echo, only real ones store, so no
// branch splits the warp); after the chunk the block copies them out as
// runs of consecutive atoms, so the 6.3 GB leave in whole sectors.  A
// segment past the last atom runs on a clamped atom and stores nothing.
// Math is precise (no fast-math), in the thread-per-atom kernel's
// operation order.
#include <cuda_runtime.h>

#include <algorithm>

#include "epg_planes.cuh"

namespace {

constexpr float kDeg = 0.017453292519943295f;   // pi / 180
constexpr float kTwoPi = 6.283185307179586f;

// warps per block at most, pulses per chunk at most, floats of one chunk's
// table and staged echoes (48 KB unless one pulse needs more), table floats
// per pulse; mirrored by cuda_fisp.SEG_WARPS, SEG_PULSES, SEG_CHUNK_FLOATS
// and SEG_TABLE
constexpr int kMaxWarps = 4;
constexpr int kMaxPulses = 32;
constexpr int kChunkFloats = 12288;
constexpr int kTab = 8;

struct MegreJacArgs {
    const float* fa;    // (P,) flip angles, degrees
    const float* phi;   // (P,) RF phases, degrees
    const float* tr;    // (P,) full repetition times, ms
    const float* te;    // (m, P) cumulative echo times, ms
    const float* t1;    // (B,)
    const float* t2;    // (B,)
    const float* b1;    // (B,)
    const float* df;    // (B,) off-resonance, kHz (use_df) or unused
    float* out;         // (10, m P, B): (re, im) of primal, dT1, dT2, dB1, ddf
    int P, B, H, m;
    int use_df, demod;
    int T;              // pulses per chunk
};

using epg::fdecay;
using epg::rotate;
using epg::Row;

// An atom's terms of one pulse.
struct PulseTerms {
    float sa, ca;        // sin, cos of the B1-scaled flip
    float cZ, dcZ;       // Z decay over the TR and its T1 derivative
    float cFr, cFi;      // F decay over the TR, with the df phasor
    float dcFr, dcFi;    // its T2 derivative
};

// The terms of the pulse whose table entry is pv = (fa, TR, -, -).
__device__ __forceinline__ PulseTerms pulse_terms(float4 pv, float T1,
                                                  float T2, float B1,
                                                  float DF, bool cdf) {
    PulseTerms o;
    sincosf(pv.x * B1 * kDeg, &o.sa, &o.ca);
    const float TRi = pv.y;
    const float cF = expf(-TRi / T2);
    o.cZ = expf(-TRi / T1);
    o.dcZ = o.cZ * TRi / (T1 * T1);
    const float dcF = cF * TRi / (T2 * T2);
    o.cFr = cF;
    o.cFi = 0.0f;
    o.dcFr = dcF;
    o.dcFi = 0.0f;
    if (cdf) {
        float pI, pR;
        sincosf(kTwoPi * DF * TRi, &pI, &pR);
        o.cFr = cF * pR;
        o.cFi = cF * pI;
        o.dcFr = dcF * pR;
        o.dcFi = dcF * pI;
    }
    return o;
}

// Lane u of the segment hands its pulse terms to the whole segment.
__device__ __forceinline__ PulseTerms bcast(const epg::SegLane& q,
                                            const PulseTerms& m, int u,
                                            bool cdf) {
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

// Register budget per instance (fisp_jac.cu's): 3 blocks of kMaxWarps
// warps per SM (at most 168 registers) at R <= 2 rows per lane, no cap at
// R = 3 (ptxas -v: 0 B of stack for every instance).
template <int R>
constexpr int kMinBlocks = R <= 2 ? 3 : 1;
template <int R>
constexpr int kBoundThreads =
    (kMinBlocks<R> > 1 ? 1 : 2) * kMaxWarps * epg::kWarp;

// R rows per lane.  Dynamic shared memory: the chunk's table (2 float4
// per pulse: cos phi, sin phi, cos 2phi, sin 2phi; fa, TR, -, -), its
// echo times (T, m), then the staged echoes (10, T m, A) of the block's
// A atoms.
template <int R>
__global__ void __launch_bounds__(kBoundThreads<R>, kMinBlocks<R>)
    megre_jac_kernel(const MegreJacArgs p) {
    extern __shared__ float4 smem[];
    constexpr int G = 4;
    const int T = p.T;
    const int m = p.m;
    const int ld = T * m;   // staged rows per output plane
    float4* tab = smem;
    float* tte = reinterpret_cast<float*>(smem + 2 * T);
    float* stage = tte + ld;
    const int H = p.H;
    const int W = (H + R - 1) / R;   // lanes per ladder
    const int L = epg::kWarp / W;
    const epg::SegLane q =
        epg::seg_lane(threadIdx.x & (epg::kWarp - 1), W, H);
    const int seg = q.base / W;
    const int A = static_cast<int>(blockDim.x / epg::kWarp) * L;
    const int slot = static_cast<int>(threadIdx.x / epg::kWarp) * L + seg;
    const int atom0 = blockIdx.x * A;
    const int ldA = ld * A;   // floats per staged output plane
    const int b = min(atom0 + slot, p.B - 1);  // clamped past the last atom
    const bool cdf = p.use_df != 0;

    const float T1 = p.t1[b];
    const float T2 = p.t2[b];
    const float B1 = p.b1[b];
    const float DF = cdf ? p.df[b] : 0.0f;

    float s[G + 1][6][R];   // s[g][j][c]: plane j of group g, row r + W c
#pragma unroll
    for (int g = 0; g <= G; ++g)
#pragma unroll
        for (int j = 0; j < 6; ++j)
#pragma unroll
            for (int c = 0; c < R; ++c) s[g][j][c] = 0.0f;
    if (q.r == 0) s[0][4][0] = 1.0f;

    const size_t plane = static_cast<size_t>(m) * p.P * p.B;
    for (int i0 = 0; i0 < p.P; i0 += T) {
        const int n = min(T, p.P - i0);
        for (int t = threadIdx.x; t < n; t += blockDim.x) {
            const int i = i0 + t;
            const float ph = p.phi[i] * kDeg;
            float sp, cp, s2p, c2p;
            sincosf(ph, &sp, &cp);
            sincosf(2.0f * ph, &s2p, &c2p);
            tab[2 * t] = make_float4(cp, sp, c2p, s2p);
            tab[2 * t + 1] = make_float4(p.fa[i], p.tr[i], 0.0f, 0.0f);
        }
        for (int n2 = threadIdx.x; n2 < n * m; n2 += blockDim.x) {
            const int t = n2 / m;
            tte[n2] = p.te[static_cast<size_t>(n2 - t * m) * p.P + i0 + t];
        }
        __syncthreads();
        for (int t0 = 0; t0 < n; t0 += W) {
            const int nu = min(W, n - t0);
            // this lane's atom terms of pulse t0 + r, broadcast below
            const PulseTerms mine = pulse_terms(
                tab[2 * (t0 + min(q.r, nu - 1)) + 1], T1, T2, B1, DF, cdf);
            for (int u = 0; u < nu; ++u) {
                const int t = t0 + u;
                const int i = i0 + t;
                const PulseTerms pt = bcast(q, mine, u, cdf);
                const float4 ph = tab[2 * t];   // cp, sp, c2p, s2p
                const float fa = tab[2 * t + 1].x;
                const float TRi = tab[2 * t + 1].y;
                const epg::Rot r = epg::rot_coeffs_sc(pt.sa, pt.ca, ph.x,
                                                      ph.y, ph.z, ph.w);
                const epg::Rot dr = epg::rot_coeffs_db1(
                    pt.sa, pt.ca, fa * kDeg, ph.x, ph.y, ph.z, ph.w);
                const float rec = 1.0f - pt.cZ;
                // d/ddf of the carried F coefficient: i 2 pi TR (cFr + i cFi)
                const float w = kTwoPi * TRi;
                const float fFr = -w * pt.cFi;
                const float fFi = w * pt.cFr;

#pragma unroll
                for (int c = 0; c < R; ++c) {
                    const bool k0 = c == 0 && q.r == 0;
                    // every group's row, rotated; the B1 coefficient pass
                    // over the primal
                    const Row x = row(s[0], c);
                    const Row P = rotate(r, x);
                    const Row C = rotate(dr, x);
                    const Row t1 = rotate(r, row(s[1], c));
                    const Row t2 = rotate(r, row(s[2], c));
                    const Row t3 = rotate(r, row(s[3], c));
                    const Row t4 = rotate(r, row(s[4], c));
                    if (c == 0) {
                        // the k = 0 values the echoes read, from the
                        // segment's row-0 lane
                        const float oR0 = epg::seg_bcast(q, P.AR, 0);
                        const float oI0 = epg::seg_bcast(q, P.AI, 0);
                        const float cR0 = epg::seg_bcast(q, C.AR, 0);
                        const float cI0 = epg::seg_bcast(q, C.AI, 0);
                        const float aR1 = epg::seg_bcast(q, t1.AR, 0);
                        const float aI1 = epg::seg_bcast(q, t1.AI, 0);
                        const float aR2 = epg::seg_bcast(q, t2.AR, 0);
                        const float aI2 = epg::seg_bcast(q, t2.AI, 0);
                        const float aR3 = epg::seg_bcast(q, t3.AR, 0);
                        const float aI3 = epg::seg_bcast(q, t3.AI, 0);
                        const float aR4 = epg::seg_bcast(q, t4.AR, 0);
                        const float aI4 = epg::seg_bcast(q, t4.AI, 0);
                        // echo j on lane j of the segment (j0 + j past
                        // W): every lane computes one, clamped into the
                        // train, and the lanes of a real echo store it, so
                        // no branch splits the warp
                        for (int j0 = 0; j0 < m; j0 += W) {
                            const bool store = seg < L && j0 + q.r < m;
                            const int j = min(j0 + q.r, m - 1);
                            const float te = tte[t * m + j];
                            const float e2te = expf(-te / T2);
                            const float de2te = e2te * te / (T2 * T2);
                            float cph = 1.0f, sn = 0.0f;
                            if (cdf) sincosf(kTwoPi * DF * te, &sn, &cph);
                            // the echo's df phasor
                            auto phase = [&](float re, float im, float& oR,
                                             float& oI) {
                                if (cdf) {
                                    epg::cmul(cph, sn, re, im, oR, oI);
                                } else {
                                    oR = re;
                                    oI = im;
                                }
                            };
                            // demodulation, then into the stage
                            float* const e = stage + (t * m + j) * A + slot;
                            auto write = [&](int o, float eR, float eI) {
                                if (p.demod) {
                                    const float dR = eR * ph.x + eI * ph.y;
                                    eI = eI * ph.x - eR * ph.y;
                                    eR = dR;
                                }
                                if (store) {
                                    e[2 * o * ldA] = eR;
                                    e[(2 * o + 1) * ldA] = eI;
                                }
                            };
                            float pR, pI, eR, eI;
                            phase(e2te * oR0, e2te * oI0, pR, pI);
                            write(0, pR, pI);
                            phase(e2te * aR1, e2te * aI1, eR, eI);
                            write(1, eR, eI);
                            // dT2: the tangent state and the TE decay's
                            // derivative
                            phase(e2te * aR2 + de2te * oR0,
                                  e2te * aI2 + de2te * oI0, eR, eI);
                            write(2, eR, eI);
                            // dB1: the tangent state and the coefficient
                            // pass
                            phase(e2te * (aR3 + cR0), e2te * (aI3 + cI0), eR,
                                  eI);
                            write(3, eR, eI);
                            // ddf: the tangent state and i 2 pi te x the
                            // primal
                            phase(e2te * aR4, e2te * aI4, eR, eI);
                            const float we = kTwoPi * te;
                            write(4, eR + -we * pI, eI + we * pR);
                        }
                    }
                    {   // primal
                        float nAR, nAI, nBR, nBI;
                        fdecay(cdf, pt.cFr, pt.cFi, P.AR, P.AI, nAR, nAI);
                        fdecay(cdf, pt.cFr, pt.cFi, P.BR, P.BI, nBR, nBI);
                        float nZR = pt.cZ * P.ZR;
                        if (k0) nZR = nZR + rec;
                        put(s[0], c, nAR, nAI, nBR, nBI, nZR, pt.cZ * P.ZI);
                    }
                    {   // dT1: only cZ and rec = 1 - cZ carry tangents
                        float nAR, nAI, nBR, nBI;
                        fdecay(cdf, pt.cFr, pt.cFi, t1.AR, t1.AI, nAR, nAI);
                        fdecay(cdf, pt.cFr, pt.cFi, t1.BR, t1.BI, nBR, nBI);
                        float nZR = pt.cZ * t1.ZR + pt.dcZ * P.ZR;
                        if (k0) nZR = nZR - pt.dcZ;
                        put(s[1], c, nAR, nAI, nBR, nBI, nZR,
                            pt.cZ * t1.ZI + pt.dcZ * P.ZI);
                    }
                    {   // dT2: only cF carries a tangent here
                        float aR, aI, bR, bI, xaR, xaI, xbR, xbI;
                        fdecay(cdf, pt.cFr, pt.cFi, t2.AR, t2.AI, aR, aI);
                        fdecay(cdf, pt.dcFr, pt.dcFi, P.AR, P.AI, xaR, xaI);
                        fdecay(cdf, pt.cFr, pt.cFi, t2.BR, t2.BI, bR, bI);
                        fdecay(cdf, pt.dcFr, pt.dcFi, P.BR, P.BI, xbR, xbI);
                        put(s[2], c, aR + xaR, aI + xaI, bR + xbR, bI + xbI,
                            pt.cZ * t2.ZR, pt.cZ * t2.ZI);
                    }
                    {   // dB1: only the rotation coefficients carry tangents
                        float nAR, nAI, nBR, nBI;
                        fdecay(cdf, pt.cFr, pt.cFi, t3.AR + C.AR,
                               t3.AI + C.AI, nAR, nAI);
                        fdecay(cdf, pt.cFr, pt.cFi, t3.BR + C.BR,
                               t3.BI + C.BI, nBR, nBI);
                        put(s[3], c, nAR, nAI, nBR, nBI,
                            pt.cZ * (t3.ZR + C.ZR), pt.cZ * (t3.ZI + C.ZI));
                    }
                    {   // ddf: the tangent through the primal coefficient
                        // and the phasor's derivative on the primal F
                        // planes (Z carries no off-resonance)
                        float aR, aI, bR, bI, yaR, yaI, ybR, ybI;
                        fdecay(cdf, pt.cFr, pt.cFi, t4.AR, t4.AI, aR, aI);
                        fdecay(cdf, pt.cFr, pt.cFi, t4.BR, t4.BI, bR, bI);
                        epg::cmul(fFr, fFi, P.AR, P.AI, yaR, yaI);
                        epg::cmul(fFr, fFi, P.BR, P.BI, ybR, ybI);
                        put(s[4], c, aR + yaR, aI + yaI, bR + ybR, bI + ybI,
                            pt.cZ * t4.ZR, pt.cZ * t4.ZI);
                    }
                }
#pragma unroll
                for (int g = 0; g <= G; ++g) epg::seg_shift(q, s[g]);
            }
        }
        __syncthreads();
        epg::flush_stage(stage, p.out, 10, ld, n * m, A, plane,
                         static_cast<size_t>(i0) * m, p.B, atom0);
    }
}

template <int R>
int launch(MegreJacArgs a, int warps, cudaStream_t stream) {
    const int W = (a.H + R - 1) / R;
    const int A = warps * (epg::kWarp / W);
    const int per = kTab + a.m + 10 * a.m * A;
    a.T = std::min(kMaxPulses, std::max(1, kChunkFloats / per));
    const size_t smem = sizeof(float) * static_cast<size_t>(a.T) * per;
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            megre_jac_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (e != cudaSuccess) return static_cast<int>(e);
    }
    const int grid = (a.B + A - 1) / A;
    megre_jac_kernel<R><<<grid, warps * epg::kWarp, smem, stream>>>(a);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream` of CUDA device `device`; allocates nothing.  Returns
// the CUDA error code of the launch (0 on success); the caller raises on
// anything else.  `block` is warps per block (at most 4); the ladder may
// have at most 96 rows (epg::seg_rows: R <= 3 rows per lane).
extern "C" int epg_megre_jac(const float* fa, const float* phi,
                             const float* tr, const float* te,
                             const float* t1, const float* t2,
                             const float* b1, const float* df, float* out,
                             int P, int B, int m, int nstate, int use_df,
                             int demod, int block, int device, void* stream) {
    MegreJacArgs a{fa, phi, tr, te, t1, t2, b1, df, out, P, B, nstate + 1, m,
                   use_df, demod, 0};
    const cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (block < 1 || block > kMaxWarps || a.H < 2 || a.H > 3 * epg::kWarp
        || m < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (epg::seg_rows(a.H)) {
        case 1: return launch<1>(a, block, st);
        case 2: return launch<2>(a, block, st);
        case 3: return launch<3>(a, block, st);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}
