// fisp_hess.cu -- per-pulse MRF Jacobian/Hessian of the FISP train.
//
// Replaces the TPU kernel epgpy_tpu/models/pallas_hessian.py:_kernel_hess
// (:83), driven there by fisp_hessian_pallas (:383); the Python wrapper is
// epgpy_torch/models/cuda_hessian.py:fisp_hessian_cuda and the plain
// PyTorch twin beside it (fisp_hessian_plain) computes the same recurrence
// (tests/torch_support.py:hessian_two_pass computes it in this kernel's
// order and equals the twin in float64).
//
// What it computes, per atom: the forward propagation of 3 + 6N tangents
// of the train [T(alpha_n, phi_n), E(tau_n) | E(TE), ADC, E(tau_n), S(1)]
// over N pulses.  Nine groups of folded plane sets (A/B/Z re+im, H =
// nstate + 1 rows): P (the primal), U1 = dP/dT1, U2 = dP/dT2 per atom, and
// per pulse variable i (the "lane") A = d/dalpha_i, T = d/dtau_i and, with
// SECOND, W1/W2 = d2/dT1,2 dalpha_i, X1/X2 = d2/dT1,2 dtau_i.  A lane is
// exactly zero before its pulse i, so every output with i > echo j is an
// exact zero.  After pulse i a lane's groups move by the primal's operator
// plus the per-atom scalars dcZ1, dcF2 and de2 alone, and they form two
// closed chains, {A, W1, W2} and {T, X1, X2}, each of them the recurrence of
// (P, U1, U2) without the recovery; the per-atom groups enter a chain only
// at pulse i, as its seed: P, U1, U2 before the pulse, rotated by the
// pulse's d/dalpha (A) or its rotation (T), then stepped with the normal
// relaxation (A) or with its tau derivatives and the recovery's (T).
//
// What bounds it on the card: the operations -- per atom and pulse, 2 (n+1)
// chains of three groups -- and the output, 12 N^2 floats per atom (1.97 GB
// at 256 atoms x 400 pulses).  The design is two passes on epg_planes.cuh's
// segmented layout (a ladder in a segment of W = ceil(H / R) lanes, lane r
// keeping rows r + W c, c < R, of its groups in registers, the shift by
// shuffles):
// (a) the atom pass runs P, U1, U2 of one atom per segment over the N
//     pulses, one warp per block so that its few warps (the atoms over
//     32 / W) spread over as many SMs; it writes the per-atom outputs and,
//     before every pulse's rotation, the groups' rows into a seed scratch
//     (18 planes, 6 at first order; the wrapper allocates it) laid out
//     [pulse][plane, row block][atom][lane], so a warp's consecutive atoms
//     store one run per plane and row block;
// (b) the lane pass gives every (atom, chain, lane i) a ladder: a warp's
//     segments are one atom, one chain and consecutive i, a block sixteen
//     such warps, so the per-pulse scalars are uniform across the block and
//     sit in a table in shared memory that two warps fill per chunk of 32
//     pulses (one the rotation and its d/dalpha, sincospif once per pulse,
//     the other the relaxation and its tangents).  A ladder holds zeros
//     until pulse i, loads its seed from the scratch there and from then
//     on steps in the plain form: rotate, relax, the chain's cross terms,
//     the shift, the echo.  A block starts at the first pulse of its lowest
//     i and writes the rows above it (i > j) as zeros; the echoes are
//     staged in shared memory per chunk and leave as runs over the block's
//     consecutive i (80 at the flagship's nstate 10).  Blocks are ordered
//     longest first.
// Math is precise (no fast-math).
#include <cuda_runtime.h>

#include "epg_planes.cuh"

namespace {

constexpr float kDeg = 0.017453292519943295f;   // pi / 180
// warps per lane-pass block (the atom pass runs one warp per block),
// pulses per chunk; mirrored by cuda_hessian.HESS_WARPS and HESS_PULSES
constexpr int kWarps = 16;
constexpr int kPulses = 32;
static_assert(kPulses <= epg::kWarp && kWarps >= 2,
              "a lane-pass chunk's table is one pulse per lane of warps 0, 1");

struct HessArgs {
    const float* fa;    // (N,) flip angles, degrees
    const float* phi;   // (N,) RF phases, degrees
    const float* tau;   // (N,) tracked delays, ms (te_sep: the tail TR - TE)
    float te;           // fixed echo time (te_sep)
    float ti;           // inversion delay (use_inv)
    const float* t1;    // (B,)
    const float* t2;    // (B,)
    float* out_atom;    // (6, B, N): sig, dT1, dT2 as (re, im)
    float* out_lane;    // (2G, B, N, N): per lane group (re, im), [b][j][i]
    float* seed;        // (N, S R, B, W): P[, U1, U2] before pulse n
    int N, B, H;
    int te_sep, use_inv;
};

// One step's scalars: the F and Z decay, their T1 and T2 tangents (dcZ1 on
// Z, dcF2 on F) and the echo's decay and its T2 tangent.
struct Coef {
    float cF, cZ, dcZ1, dcF2, e2, de2;
};

// A pulse's table entry in the lane pass: the rotation and the plain step's
// scalars (read at every pulse), then the seed's -- d/dalpha, the tau
// derivatives of the step's scalars and of the recovery (rows 0 of P, U1).
struct __align__(16) Entry {
    epg::Rot r;
    Coef c;
    epg::Rot dr;
    Coef ct;
    float rec0, rec1;
};

using epg::Row;

// the rotation of pulse n and its d/dalpha (alpha in degrees); sincospif
// of the angle in half turns reduces its argument exactly, with no local
// memory (sincosf's reduction of large arguments takes a stack frame)
__device__ __forceinline__ void pulse_rot(const HessArgs& p, int n,
                                          epg::Rot& r, epg::Rot& dr) {
    const float ph = p.phi[n] * (1.0f / 180.0f);
    float sp, cp, s2p, c2p, sa, ca;
    sincospif(ph, &sp, &cp);
    sincospif(2.0f * ph, &s2p, &c2p);
    sincospif(p.fa[n] * (1.0f / 180.0f), &sa, &ca);
    r = epg::rot_coeffs_sc(sa, ca, cp, sp, c2p, s2p);
    dr = epg::rot_coeffs_db1(sa, ca, kDeg, cp, sp, c2p, s2p);
}

// The relaxation of pulse n for one atom (pallas_hessian.py:153-168): the
// plain step's scalars and the relaxation time.
__device__ __forceinline__ Coef pulse_relax(const HessArgs& p, int n,
                                            float T1, float T2, float E2TE,
                                            float dE2TE, float& ttot) {
    ttot = p.te_sep ? p.tau[n] + p.te : p.tau[n];
    Coef c;
    c.cF = expf(-ttot / T2);
    c.cZ = expf(-ttot / T1);
    c.dcZ1 = c.cZ * ttot / (T1 * T1);
    c.dcF2 = c.cF * ttot / (T2 * T2);
    c.e2 = p.te_sep ? E2TE : c.cF;
    c.de2 = p.te_sep ? dE2TE : c.dcF2;
    return c;
}

template <int R>
__device__ __forceinline__ Row row(const float (&s)[6][R], int c) {
    return Row{s[0][c], s[1][c], s[2][c], s[3][c], s[4][c], s[5][c]};
}

// One pulse of C groups (1, or 3: a chain or P, U1, U2) on the segmented
// layout: rotate by r, the echoes of the k = 0 rows into e[o * stride] (o
// = re, im per group; the echoing lane only), relax with c -- group 1's Z
// also takes dcZ1 times group 0's, group 2's F dcF2 times group 0's, rows
// 0 of groups 0 and 1 add rec0 and rec1 to Z -- and shift.
template <int C, int R, typename I>
__device__ __forceinline__ void step(const epg::SegLane& q,
                                     float (&s)[C][6][R], const epg::Rot& r,
                                     const Coef& c, float rec0, float rec1,
                                     bool echo, float* e, I stride) {
#pragma unroll
    for (int k = 0; k < R; ++k) {
        const bool k0 = k == 0 && q.r == 0;
        Row y[C];
#pragma unroll
        for (int g = 0; g < C; ++g) y[g] = epg::rotate(r, row(s[g], k));
        if (k == 0 && echo) {
            e[0] = c.e2 * y[0].AR;
            e[stride] = c.e2 * y[0].AI;
            if constexpr (C == 3) {
                e[2 * stride] = c.e2 * y[1].AR;
                e[3 * stride] = c.e2 * y[1].AI;
                e[4 * stride] = c.e2 * y[2].AR + c.de2 * y[0].AR;
                e[5 * stride] = c.e2 * y[2].AI + c.de2 * y[0].AI;
            }
        }
        s[0][0][k] = c.cF * y[0].AR;
        s[0][1][k] = c.cF * y[0].AI;
        s[0][2][k] = c.cF * y[0].BR;
        s[0][3][k] = c.cF * y[0].BI;
        s[0][4][k] = k0 ? c.cZ * y[0].ZR + rec0 : c.cZ * y[0].ZR;
        s[0][5][k] = c.cZ * y[0].ZI;
        if constexpr (C == 3) {
            s[1][0][k] = c.cF * y[1].AR;
            s[1][1][k] = c.cF * y[1].AI;
            s[1][2][k] = c.cF * y[1].BR;
            s[1][3][k] = c.cF * y[1].BI;
            const float z1 = c.cZ * y[1].ZR + c.dcZ1 * y[0].ZR;
            s[1][4][k] = k0 ? z1 + rec1 : z1;
            s[1][5][k] = c.cZ * y[1].ZI + c.dcZ1 * y[0].ZI;
            s[2][0][k] = c.cF * y[2].AR + c.dcF2 * y[0].AR;
            s[2][1][k] = c.cF * y[2].AI + c.dcF2 * y[0].AI;
            s[2][2][k] = c.cF * y[2].BR + c.dcF2 * y[0].BR;
            s[2][3][k] = c.cF * y[2].BI + c.dcF2 * y[0].BI;
            s[2][4][k] = c.cZ * y[2].ZR;
            s[2][5][k] = c.cZ * y[2].ZI;
        }
    }
#pragma unroll
    for (int g = 0; g < C; ++g) epg::seg_shift(q, s[g]);
}

// (a) The atom pass: P, U1, U2 of one atom per segment over the N pulses;
// the per-atom echoes to out_atom, and before each pulse's rotation the
// rows of the groups the chains seed from (P, U1, U2; P at first order) to
// the seed scratch.
template <bool SECOND, int R>
__global__ void __launch_bounds__(epg::kWarp)
    hess_atom_kernel(const HessArgs p) {
    constexpr int S = SECOND ? 18 : 6;   // seed planes: P[, U1, U2]
    __shared__ epg::Rot rt[kPulses];
    const int H = p.H, N = p.N;
    const int W = (H + R - 1) / R;
    const int L = epg::kWarp / W;
    const epg::SegLane q =
        epg::seg_lane(threadIdx.x & (epg::kWarp - 1), W, H);
    const int seg = q.base / W;
    const int atom = blockIdx.x * L + seg;
    const bool store = seg < L && atom < p.B;
    const int b = min(atom, p.B - 1);   // clamped past the last atom
    const float T1 = p.t1[b];
    const float T2 = p.t2[b];
    float E2TE = 0.0f, dE2TE = 0.0f;
    if (p.te_sep) {
        E2TE = expf(-p.te / T2);
        dE2TE = E2TE * p.te / (T2 * T2);
    }

    float s[3][6][R];   // P, U1, U2: s[g][j][c], plane j of row r + W c
#pragma unroll
    for (int g = 0; g < 3; ++g)
#pragma unroll
        for (int j = 0; j < 6; ++j)
#pragma unroll
            for (int c = 0; c < R; ++c) s[g][j][c] = 0.0f;
    if (q.r == 0) {
        // the initial state: Z(0) = 1, or the closed form of a perfect
        // inversion and its dT1 seed
        if (p.use_inv) {
            const float E1i = expf(-p.ti / T1);
            s[0][4][0] = 1.0f - 2.0f * E1i;
            s[1][4][0] = -2.0f * E1i * p.ti / (T1 * T1);
        } else {
            s[0][4][0] = 1.0f;
        }
    }

    const size_t atom_plane = static_cast<size_t>(p.B) * N;
    const size_t BW = static_cast<size_t>(p.B) * W;   // seed floats per row
    for (int n0 = 0; n0 < N; n0 += kPulses) {
        const int nc = min(kPulses, N - n0);
        if (static_cast<int>(threadIdx.x) < nc) {   // one pulse per lane
            epg::Rot r, dr;
            pulse_rot(p, n0 + threadIdx.x, r, dr);
            rt[threadIdx.x] = r;
        }
        __syncwarp();
        for (int t = 0; t < nc; ++t) {
            const int n = n0 + t;
            if (store) {
                // plane j of row r + W c at seed[n][(j R + c)][b][r]: the
                // warp's consecutive atoms store one run per (j, c)
                float* sd = p.seed + static_cast<size_t>(n) * S * R * BW
                    + static_cast<size_t>(b) * W + q.r;
#pragma unroll
                for (int g = 0; g < S / 6; ++g)
#pragma unroll
                    for (int j = 0; j < 6; ++j)
#pragma unroll
                        for (int c = 0; c < R; ++c)
                            sd[((6 * g + j) * R + c) * BW] = s[g][j][c];
            }
            float ttot;
            const Coef cf = pulse_relax(p, n, T1, T2, E2TE, dE2TE, ttot);
            step<3, R>(q, s, rt[t], cf, 1.0f - cf.cZ, -cf.dcZ1,
                       store && q.r == 0,
                       p.out_atom + static_cast<size_t>(b) * N + n,
                       atom_plane);
        }
        __syncwarp();
    }
}

// The output plane of a chain's staged output o (re, im per group): the
// chains are A, W1, W2 (ch 0) and T, X1, X2 (ch 1) of the (2G, ...) layout
// A, T, W1, W2, X1, X2.
__device__ __forceinline__ int out_plane(int ch, int o) {
    const int grp = o >> 1;
    const int g = grp == 0 ? ch : grp + (ch == 0 ? 1 : 3);
    return 2 * g + (o & 1);
}

// (b) The lane pass: block = (atom b, chain ch, lanes I0 .. I0 + A - 1),
// A = kWarps L ladders, one per segment.  Dynamic shared memory: the
// staged echoes (2C, kPulses, A).
template <bool SECOND, int R>
__global__ void __launch_bounds__(kWarps * epg::kWarp)
    hess_lane_kernel(const HessArgs p) {
    constexpr int C = SECOND ? 3 : 1;   // groups per chain
    constexpr int NO = 2 * C;           // staged outputs per ladder
    extern __shared__ float stage[];
    __shared__ Entry tab[kPulses];
    const int H = p.H, N = p.N;
    const int W = (H + R - 1) / R;
    const int L = epg::kWarp / W;
    const int A = kWarps * L;
    const int lane = threadIdx.x & (epg::kWarp - 1);
    const int warp = threadIdx.x / epg::kWarp;
    const epg::SegLane q = epg::seg_lane(lane, W, H);
    const int seg = q.base / W;
    const int slot = warp * L + seg;
    // blocks of the lowest lanes (the longest) first
    const int ig = blockIdx.x / (2 * p.B);
    const int rem = blockIdx.x - ig * 2 * p.B;
    const int b = rem >> 1, ch = rem & 1;
    const int I0 = ig * A;
    const int i = seg < L ? I0 + slot : -1;   // this ladder's lane
    const bool writer = q.r == 0 && seg < L;
    const int nw = I0 + warp * L;             // the warp's lowest lane
    const float T1 = p.t1[b];
    const float T2 = p.t2[b];
    float E2TE = 0.0f, dE2TE = 0.0f;
    if (p.te_sep) {
        E2TE = expf(-p.te / T2);
        dE2TE = E2TE * p.te / (T2 * T2);
    }
    const size_t NN = static_cast<size_t>(N) * N;
    const size_t lane_plane = static_cast<size_t>(p.B) * NN;
    float* const out = p.out_lane + static_cast<size_t>(b) * NN + I0;
    const int nA = min(A, N - I0);   // the block's lanes below N

    // rows j < I0 of the block's lanes: zeros, one row per warp at a time
    for (int rw = warp; rw < NO * I0; rw += kWarps) {
        const int o = rw / I0, j = rw - o * I0;
        float* dst = out + out_plane(ch, o) * lane_plane
            + static_cast<size_t>(j) * N;
        for (int a = lane; a < nA; a += epg::kWarp) dst[a] = 0.0f;
    }

    float s[C][6][R];
#pragma unroll
    for (int g = 0; g < C; ++g)
#pragma unroll
        for (int j = 0; j < 6; ++j)
#pragma unroll
            for (int c = 0; c < R; ++c) s[g][j][c] = 0.0f;

    const int S = 6 * C;
    const int TA = kPulses * A;   // floats per staged output plane
    for (int n0 = I0; n0 < N; n0 += kPulses) {
        const int nc = min(kPulses, N - n0);
        // the chunk's table: warp 0 the rotations, warp 1 the relaxation
        if (warp == 0 && lane < nc) {
            epg::Rot r, dr;
            pulse_rot(p, n0 + lane, r, dr);
            tab[lane].r = r;
            tab[lane].dr = dr;
        } else if (warp == 1 && lane < nc) {
            float ttot;
            const Coef c =
                pulse_relax(p, n0 + lane, T1, T2, E2TE, dE2TE, ttot);
            const epg::TauTerms tt =
                epg::relax_tau_terms(c.cZ, c.cF, ttot, T1, T2);
            tab[lane].c = c;
            // the T chain's seed step: d/dtau of the decays; the echo
            // moves with tau only in the 4-op form
            tab[lane].ct = Coef{tt.cFt, tt.cZt, tt.cZt1, tt.cFt2,
                                p.te_sep ? 0.0f : tt.cFt,
                                p.te_sep ? 0.0f : tt.cFt2};
            tab[lane].rec0 = -tt.cZt;
            tab[lane].rec1 = -tt.cZt1;
        }
        __syncthreads();
        for (int t = 0; t < nc; ++t) {
            const int n = n0 + t;
            float* const e = stage + t * A + slot;
            if (n < nw) {   // before the warp's lowest lane: zeros
                if (writer)
#pragma unroll
                    for (int o = 0; o < NO; ++o) e[o * TA] = 0.0f;
                continue;
            }
            epg::Rot r = tab[t].r;
            Coef cf = tab[t].c;
            if (n >= nw + L) {   // every ladder of the warp has started
                step<C, R>(q, s, r, cf, 0.0f, 0.0f, writer, e, TA);
                continue;
            }
            // lane n's ladder starts: its seed, rotated by d/dalpha (A) or
            // the rotation (T), stepped with the seed's scalars
            float rec0 = 0.0f, rec1 = 0.0f;
            if (n == i) {
                const size_t BW = static_cast<size_t>(p.B) * W;
                const float* sd = p.seed + static_cast<size_t>(n) * S * R * BW
                    + static_cast<size_t>(b) * W + q.r;
#pragma unroll
                for (int g = 0; g < C; ++g)
#pragma unroll
                    for (int j = 0; j < 6; ++j)
#pragma unroll
                        for (int c = 0; c < R; ++c)
                            s[g][j][c] = sd[((6 * g + j) * R + c) * BW];
                if (ch == 0) {
                    r = tab[t].dr;
                } else {
                    cf = tab[t].ct;
                    rec0 = tab[t].rec0;
                    rec1 = tab[t].rec1;
                }
            }
            step<C, R>(q, s, r, cf, rec0, rec1, writer, e, TA);
        }
        __syncthreads();
        // the chunk's echoes: one (output, pulse) row of nA lanes per warp
        for (int rw = warp; rw < NO * nc; rw += kWarps) {
            const int o = rw / nc, t = rw - o * nc;
            float* dst = out + out_plane(ch, o) * lane_plane
                + static_cast<size_t>(n0 + t) * N;
            const float* src = stage + o * TA + t * A;
            for (int a = lane; a < nA; a += epg::kWarp) dst[a] = src[a];
        }
    }
}

template <bool SECOND, int R>
int launch_atom(const HessArgs& a, cudaStream_t stream) {
    const int atoms = epg::kWarp / ((a.H + R - 1) / R);
    hess_atom_kernel<SECOND, R><<<(a.B + atoms - 1) / atoms, epg::kWarp, 0,
                                  stream>>>(a);
    return static_cast<int>(cudaGetLastError());
}

template <bool SECOND, int R>
int launch_lane(const HessArgs& a, cudaStream_t stream) {
    const int W = (a.H + R - 1) / R;
    const int A = kWarps * (epg::kWarp / W);
    const size_t smem = sizeof(float) * (SECOND ? 6 : 2) * kPulses * A;
    if (smem + sizeof(Entry) * kPulses > 48 * 1024) {   // with the table
        const cudaError_t e = cudaFuncSetAttribute(
            hess_lane_kernel<SECOND, R>,
            cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (e != cudaSuccess) return static_cast<int>(e);
    }
    const long long grid =
        static_cast<long long>((a.N + A - 1) / A) * 2 * a.B;
    if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    hess_lane_kernel<SECOND, R><<<static_cast<unsigned>(grid),
                                  kWarps * epg::kWarp, smem, stream>>>(a);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch both passes on `stream` of CUDA device `device` at R rows per lane
// (cuda_hessian.hess_geometry decides R: 1 or 2 at second order, up to 4
// at first, with W = ceil(H / R) <= 32); allocates nothing: `seed` is the
// caller's scratch of N B 6C W R floats (C = 3 groups at second order, 1
// at first), sized from the same R.  Returns the CUDA error code of the
// launches (0 on success); the caller raises on anything else.
extern "C" int epg_fisp_hess(const float* fa, const float* phi,
                             const float* tau, float te, float ti,
                             const float* t1, const float* t2,
                             float* out_atom, float* out_lane, float* seed,
                             int N, int B, int nstate, int R, int te_sep,
                             int use_inv, int second_order, int device,
                             void* stream) {
    HessArgs a{fa, phi, tau, te, ti, t1, t2, out_atom, out_lane, seed, N, B,
               nstate + 1, te_sep, use_inv};
    const cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (a.H < 2 || N < 1 || B < 1 || R < 1 || R > (second_order ? 2 : 4) ||
        (a.H + R - 1) / R > epg::kWarp)
        return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    int rc;
    if (second_order) {
        rc = R == 1 ? launch_atom<true, 1>(a, st)
                    : launch_atom<true, 2>(a, st);
    } else {
        switch (R) {
            case 1: rc = launch_atom<false, 1>(a, st); break;
            case 2: rc = launch_atom<false, 2>(a, st); break;
            case 3: rc = launch_atom<false, 3>(a, st); break;
            default: rc = launch_atom<false, 4>(a, st); break;
        }
    }
    if (rc != 0) return rc;
    if (second_order)
        return R == 1 ? launch_lane<true, 1>(a, st)
                      : launch_lane<true, 2>(a, st);
    switch (R) {
        case 1: return launch_lane<false, 1>(a, st);
        case 2: return launch_lane<false, 2>(a, st);
        case 3: return launch_lane<false, 3>(a, st);
        default: return launch_lane<false, 4>(a, st);
    }
}
