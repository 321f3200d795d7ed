// dess_jac.cu -- DESS FISP and PSIF echoes and both echoes' dT1/dT2/dB1.
//
// Replaces the TPU kernel epgpy_tpu/models/pallas_dess.py:_kernel_dess_jac
// (:201), driven there by dess_jacobian_pallas (:377); the Python wrapper
// is epgpy_torch/models/cuda_dess.py:dess_jacobian_cuda and the plain
// PyTorch twin beside it (dess_jacobian_echoes_plain) computes the same
// recurrence with the same operation order.
//
// What it computes, per atom: the forward-mode derivative of dess.cu.
// Plane group 0 is the primal folded ladder, groups 1-3 its tangents
// w.r.t. T1, T2 and B1: 24 planes of H = nstate + 1 rows.  The coefficient
// tangents are sparse: T1 perturbs only cZ and the k = 0 recovery (drec =
// -dcZ), T2 only cF (the full-TR decay) and the FISP echo's TE decay, B1
// only the rotation coefficients (one extra rotation of the primal planes).
// Per TR both echoes of every group are written out: the FISP echo from the
// rotated k = 0 row, the PSIF echo from the relaxed B(1) row that becomes
// the new A(0) -- its dT2 includes the full-TR dcF term.  Output planes
// (8, 2P, B), re and im per group, rows in the train's ADC order FISP_0,
// PSIF_0, FISP_1, ...
//
// What bounds it on the card: the arithmetic, ~5x the primal's (four
// rotated groups plus the B1 coefficient pass per row), while the state,
// 24 x (nstate + 1) floats per atom, held one thread per atom in shared
// memory to 8 warps per SM.  The design is fisp_jac.cu's segmented layout
// (epg_planes.cuh) with blocked rows: a ladder takes a segment of W =
// ceil(H / R) lanes and a warp holds 32 / W ladders; lane r keeps rows
// r R + c, c < R, of the four groups in registers (R = 3 at the mapping's
// nstate 8: 10 ladders of 3 lanes per warp, no padding row, 72 floats of
// state per lane; R from cuda_dess.dess_jac_geometry, a template
// parameter).  A pulse is one step of R rows on every lane -- rotate,
// relax, write the new values in place -- and epg::seg_shift_blocked moves
// them: rows within a lane by register, one row of A and of B per lane by
// a shuffle.  The atom-independent terms of a chunk of up to 32 pulses
// (the RF phase's sin/cos, the flip, TR, TE) sit in a table the block
// fills between two barriers; the atom's own terms of pulse t0 + j
// (sin/cos of the B1-scaled flip, exp(-TR/T1), exp(-TR/T2), the df
// phasors, and with a per-pulse TE its decay) are computed by lane j of
// the segment and broadcast by a shuffle when that pulse runs.  The row-0
// lane stages both echoes of the chunk in shared memory -- the FISP echo
// from its rotated row 0, the PSIF echo from its row 0 after the shift
// (the shift's row-0 select takes the relaxed B(1) as the new A(0)) -- and
// after the chunk the block copies them out as runs of consecutive atoms
// (epg::flush_stage).  4-warp blocks; a segment past the last atom runs on
// a clamped atom and stores nothing.  Math is precise (no fast-math);
// sincospif of the angles in half turns.
#include <cuda_runtime.h>

#include "epg_planes.cuh"

namespace {

constexpr float kDeg = 0.017453292519943295f;   // pi / 180

// warps per block at most, pulses per chunk at most, floats of one chunk's
// table and staged echoes (48 KB), table floats per pulse; mirrored by
// cuda_fisp.SEG_WARPS, SEG_PULSES, SEG_CHUNK_FLOATS and SEG_TABLE
constexpr int kMaxWarps = 4;
constexpr int kMaxPulses = 32;
constexpr int kChunkFloats = 12288;
constexpr int kTab = 8;
// output planes: (re, im) of the primal and the three tangents
constexpr int kOut = 8;

struct DessJacArgs {
    const float* fa;    // (P,) flip angles, degrees
    const float* phi;   // (P,) RF phases, degrees
    const float* tr;    // (P,) full repetition times, ms
    const float* te;    // (P,) FISP echo times (var_te) or unused
    float te0;          // constant FISP echo time (!var_te)
    const float* t1;    // (B,)
    const float* t2;    // (B,)
    const float* b1;    // (B,)
    const float* df;    // (B,) off-resonance, kHz (use_df) or unused
    float* out;         // (8, 2P, B): (re, im) of primal, dT1, dT2, dB1
    int P, B, H;
    int var_te, use_df, demod;
    int T;              // pulses per chunk
};

using epg::fdecay;
using epg::rotate;
using epg::Row;

// An atom's constants: its parameters and, without var_te, the FISP
// echo's TE terms.
struct Atom {
    float T1, T2, B1, DF;
    float E2te, dE2te, pteR, pteI;
};

// An atom's terms of one pulse.
struct PulseTerms {
    float sa, ca;        // sin, cos of the B1-scaled flip
    float cZ, dcZ;       // Z decay over the TR and its T1 derivative
    float cFr, cFi;      // F decay over the TR, with the df phasor
    float dcFr, dcFi;    // its T2 derivative
    float e2te, de2te;   // TE decay of the FISP echo and its T2 derivative
    float pteR, pteI;    // df phasor of the FISP echo
};

// The terms of the pulse whose table entry is pv = (fa, TR, TE, -).
__device__ __forceinline__ PulseTerms pulse_terms(const DessJacArgs& p,
                                                  const float4 pv,
                                                  const Atom& at) {
    const bool cdf = p.use_df != 0;
    PulseTerms o;
    sincospif(pv.x * at.B1 * (1.0f / 180.0f), &o.sa, &o.ca);
    if (p.var_te) {
        const float te = pv.z;
        o.e2te = expf(-te / at.T2);
        o.de2te = o.e2te * te / (at.T2 * at.T2);
        o.pteR = 1.0f;
        o.pteI = 0.0f;
        if (cdf) sincospif(2.0f * at.DF * te, &o.pteI, &o.pteR);
    } else {
        o.e2te = at.E2te;
        o.de2te = at.dE2te;
        o.pteR = at.pteR;
        o.pteI = at.pteI;
    }
    const float TRi = pv.y;
    const float cF = expf(-TRi / at.T2);
    o.cZ = expf(-TRi / at.T1);
    o.dcZ = o.cZ * TRi / (at.T1 * at.T1);
    const float dcF = cF * TRi / (at.T2 * at.T2);
    o.cFr = cF;
    o.cFi = 0.0f;
    o.dcFr = dcF;
    o.dcFi = 0.0f;
    if (cdf) {
        float pI, pR;
        sincospif(2.0f * at.DF * TRi, &pI, &pR);
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

// Register budget: 3 blocks of kMaxWarps warps per SM (at most 168
// registers) for every instance (ptxas -v: 167 registers and 0 B of stack
// at R = 3; uncapped, 240 registers held 8 warps per SM and ran ~10%
// slower).
constexpr int kMinBlocks = 3;

// R rows per lane.  Dynamic shared memory: the chunk's table (2 float4
// per pulse: cos phi, sin phi, cos 2phi, sin 2phi; fa, TR, TE, -), then
// the staged echoes (8, 2 T, A) of the block's A atoms, rows FISP_t,
// PSIF_t.
template <int R>
__global__ void __launch_bounds__(kMaxWarps* epg::kWarp, kMinBlocks)
    dess_jac_kernel(const DessJacArgs p) {
    extern __shared__ float4 smem[];
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
    const int TA = 2 * T * A;   // floats per staged output plane

    Atom at;
    at.T1 = p.t1[b];
    at.T2 = p.t2[b];
    at.B1 = p.b1[b];
    at.DF = cdf ? p.df[b] : 0.0f;
    at.E2te = at.dE2te = 0.0f;
    at.pteR = 1.0f;
    at.pteI = 0.0f;
    if (!p.var_te) {
        at.E2te = expf(-p.te0 / at.T2);
        at.dE2te = at.E2te * p.te0 / (at.T2 * at.T2);
        if (cdf) sincospif(2.0f * at.DF * p.te0, &at.pteI, &at.pteR);
    }

    float s[4][6][R];   // s[g][j][c]: plane j of group g, row r R + c
#pragma unroll
    for (int g = 0; g < 4; ++g)
#pragma unroll
        for (int j = 0; j < 6; ++j)
#pragma unroll
            for (int c = 0; c < R; ++c) s[g][j][c] = 0.0f;
    if (q.r == 0) s[0][4][0] = 1.0f;

    const size_t plane = 2 * static_cast<size_t>(p.P) * p.B;
    for (int i0 = 0; i0 < p.P; i0 += T) {
        const int n = min(T, p.P - i0);
        for (int t = threadIdx.x; t < n; t += blockDim.x) {
            const int i = i0 + t;
            const float ph = p.phi[i] * (1.0f / 180.0f);
            float sp, cp, s2p, c2p;
            sincospif(ph, &sp, &cp);
            sincospif(2.0f * ph, &s2p, &c2p);
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
                const float rec = 1.0f - pt.cZ;

                // echo e (0 FISP, 1 PSIF) of group o: the TE phase (FISP
                // only), demod, into the stage
                float* const est = stage + 2 * t * A + slot;
                auto write = [&](int o, int e, float eR, float eI) {
                    if (cdf && e == 0)
                        epg::cmul(pt.pteR, pt.pteI, eR, eI, eR, eI);
                    if (p.demod) {
                        const float dR = eR * ph.x + eI * ph.y;
                        eI = eI * ph.x - eR * ph.y;
                        eR = dR;
                    }
                    est[2 * o * TA + e * A] = eR;
                    est[(2 * o + 1) * TA + e * A] = eI;
                };

#pragma unroll
                for (int c = 0; c < R; ++c) {
                    const bool k0 = c == 0 && q.r == 0;
                    const bool echo = c == 0 && writer;
                    // primal: rotation, and the B1 coefficient pass over it
                    const Row x = row(s[0], c);
                    const Row P = rotate(r, x);
                    const Row C = rotate(dr, x);
                    if (echo) write(0, 0, pt.e2te * P.AR, pt.e2te * P.AI);
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
                        if (echo)
                            write(1, 0, pt.e2te * t1.AR, pt.e2te * t1.AI);
                        float nAR, nAI, nBR, nBI;
                        fdecay(cdf, pt.cFr, pt.cFi, t1.AR, t1.AI, nAR, nAI);
                        fdecay(cdf, pt.cFr, pt.cFi, t1.BR, t1.BI, nBR, nBI);
                        float nZR = pt.cZ * t1.ZR + pt.dcZ * P.ZR;
                        if (k0) nZR = nZR - pt.dcZ;
                        put(s[1], c, nAR, nAI, nBR, nBI, nZR,
                            pt.cZ * t1.ZI + pt.dcZ * P.ZI);
                    }
                    {   // dT2: only cF (and E2te on the FISP echo)
                        const Row t2 = rotate(r, row(s[2], c));
                        if (echo)
                            write(2, 0, pt.e2te * t2.AR + pt.de2te * P.AR,
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
                            write(3, 0, pt.e2te * (t3.AR + C.AR),
                                  pt.e2te * (t3.AI + C.AI));
                        float nAR, nAI, nBR, nBI;
                        fdecay(cdf, pt.cFr, pt.cFi, t3.AR + C.AR, t3.AI + C.AI,
                               nAR, nAI);
                        fdecay(cdf, pt.cFr, pt.cFi, t3.BR + C.BR, t3.BI + C.BI,
                               nBR, nBI);
                        put(s[3], c, nAR, nAI, nBR, nBI,
                            pt.cZ * (t3.ZR + C.ZR), pt.cZ * (t3.ZI + C.ZI));
                    }
                }
#pragma unroll
                for (int g = 0; g < 4; ++g) epg::seg_shift_blocked(q, s[g]);
                // PSIF echoes: the row-0 lane's new A(0), the relaxed B(1)
                if (writer)
#pragma unroll
                    for (int g = 0; g < 4; ++g)
                        write(g, 1, s[g][0][0], s[g][1][0]);
            }
        }
        __syncthreads();
        epg::flush_stage(stage, p.out, kOut, 2 * T, 2 * n, A, plane,
                         2 * static_cast<size_t>(i0), p.B, atom0);
    }
}

template <int R>
int launch(DessJacArgs a, int warps, cudaStream_t stream) {
    const int W = (a.H + R - 1) / R;
    const int A = warps * (epg::kWarp / W);
    const int per = kTab + 2 * kOut * A;
    if (a.T * per > kChunkFloats)
        return static_cast<int>(cudaErrorInvalidValue);
    const size_t smem = sizeof(float) * static_cast<size_t>(a.T) * per;
    const int grid = (a.B + A - 1) / A;
    dess_jac_kernel<R><<<grid, warps * epg::kWarp, smem, stream>>>(a);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream` of CUDA device `device`; allocates nothing.  Returns
// the CUDA error code of the launch (0 on success; cudaErrorInvalidValue
// for R outside 1..3, W = ceil(H / R) lanes beyond a warp, `pulses`
// outside 1..32, or a chunk past 48 KB); the caller raises on anything
// else.  `block` is warps per block (at most 4), `R` the ladder's rows per
// lane and `pulses` the pulses per chunk, all from
// cuda_dess.dess_jac_geometry.
extern "C" int epg_dess_jac(const float* fa, const float* phi,
                            const float* tr, const float* te, float te0,
                            const float* t1, const float* t2,
                            const float* b1, const float* df, float* out,
                            int P, int B, int nstate, int var_te, int use_df,
                            int demod, int R, int block, int pulses,
                            int device, void* stream) {
    DessJacArgs a{fa, phi, tr, te, te0, t1, t2, b1, df, out, P, B,
                  nstate + 1, var_te, use_df, demod, pulses};
    const cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (block < 1 || block > kMaxWarps || a.H < 2 || R < 1
        || (a.H + R - 1) / R > epg::kWarp || pulses < 1
        || pulses > kMaxPulses)
        return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (R) {
        case 1: return launch<1>(a, block, st);
        case 2: return launch<2>(a, block, st);
        case 3: return launch<3>(a, block, st);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}
