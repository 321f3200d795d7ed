// fisp_hess.cu -- per-pulse MRF Jacobian/Hessian of the FISP train.
//
// Replaces the TPU kernel epgpy_tpu/models/pallas_hessian.py:_kernel_hess
// (:83), driven there by fisp_hessian_pallas (:383); the Python wrapper is
// epgpy_torch/models/cuda_hessian.py:fisp_hessian_cuda and the plain
// PyTorch twin beside it (fisp_hessian_plain) computes the same recurrence
// with the same operation order.
//
// What it computes, per atom: the forward propagation of 3 + 6N tangents
// of the train [T(alpha_n, phi_n), E(tau_n) | E(TE), ADC, E(tau_n), S(1)]
// over N pulses.  Nine groups of folded plane sets (A/B/Z re+im, H =
// nstate + 1 rows): P (the primal), U1 = dP/dT1, U2 = dP/dT2 per atom, and
// per pulse variable i (the "lane") A = d/dalpha_i, T = d/dtau_i and, with
// SECOND, W1/W2 = d2/dT1,2 dalpha_i, X1/X2 = d2/dT1,2 dtau_i.  Every
// tangent moves by the primal's per-pulse operator (rotation, relaxation,
// folded unit shift) plus seed terms built from the per-atom groups; lane
// i is seeded at pulse i and is exactly zero before it, so every output
// with i > echo j is an exact zero.
//
// What bounds it on the card: the state.  A lane carries 6 groups x 6
// planes x H rows = 1,584 bytes at nstate 10, so 400 lanes of one atom
// (634 KB) do not fit one SM's 227 KB.  The design: one block per (atom,
// tile of L lanes), one thread per lane, the lane groups in shared memory
// at [group][plane][row][thread] (conflict-free; a thread touches only its
// column).  The per-atom groups are needed by every lane at every row, so
// the block keeps them once, as rows already rotated by the pulse's
// rotation (Y) and by its d/dalpha (Q): 36 floats per row, read as
// broadcasts.  They are double-buffered: while the lanes read pulse n's
// rows, the first 3H threads build pulse n+1's (relax, shift, rotate) into
// the other buffer, so one barrier per pulse suffices.  Each tile of an
// atom recomputes them from pulse 0: 3H rows per pulse against L lanes.
// The causal skip: a lane does no work before its pulse (a tile whose
// first lane is above n only writes zeros), which halves the arithmetic;
// the outputs, (2G, B, N, N) floats with the lane index innermost, are
// written coalesced, zeros included.  Math is precise (no fast-math).
#include <cuda_runtime.h>

#include "epg_planes.cuh"

namespace {

constexpr float kDeg = 0.017453292519943295f;   // pi / 180
// floats per ladder row of the per-atom groups: Y of P, U1, U2, then Q
constexpr int kAtomRow = 36;

struct HessArgs {
    const float* fa;    // (N,) flip angles, degrees
    const float* phi;   // (N,) RF phases, degrees
    const float* tau;   // (N,) tracked delays, ms (the tail TR - TE with te_sep)
    float te;           // fixed echo time (te_sep)
    float ti;           // inversion delay (use_inv)
    const float* t1;    // (B,)
    const float* t2;    // (B,)
    float* out_atom;    // (6, B, N): sig, dT1, dT2 as (re, im)
    float* out_lane;    // (2G, B, N, N): per lane group (re, im), [b][j][i]
    int N, B, H, ntiles;
    int te_sep, use_inv;
};

// relaxation coefficients of one pulse (pallas_hessian.py:153-168)
struct Relax {
    float cF, cZ, rec, dcZ1, dcF2, e2, de2;
    epg::TauTerms t;
};

__device__ __forceinline__ void rotate(const epg::Rot& r, const float x[6],
                                       float o[6]) {
    epg::rot_A(r, x[0], x[1], x[2], x[3], x[4], x[5], o[0], o[1]);
    epg::rot_B(r, x[0], x[1], x[2], x[3], x[4], x[5], o[2], o[3]);
    epg::rot_Z(r, x[0], x[1], x[2], x[3], x[4], x[5], o[4], o[5]);
}

// the rotation of pulse n and its d/dalpha (alpha in degrees)
__device__ __forceinline__ void pulse_rot(const HessArgs& p, int n,
                                          epg::Rot& r, epg::Rot& dr) {
    const float ph = p.phi[n] * kDeg;
    float sp, cp, s2p, c2p, sa, ca;
    sincosf(ph, &sp, &cp);
    sincosf(2.0f * ph, &s2p, &c2p);
    sincosf(p.fa[n] * kDeg, &sa, &ca);
    r = epg::rot_coeffs_sc(sa, ca, cp, sp, c2p, s2p);
    dr = epg::rot_coeffs_db1(sa, ca, kDeg, cp, sp, c2p, s2p);
}

__device__ __forceinline__ Relax pulse_relax(const HessArgs& p, int n,
                                             float T1, float T2, float E2TE,
                                             float dE2TE) {
    Relax c;
    const float ttot = p.te_sep ? p.tau[n] + p.te : p.tau[n];
    c.cF = expf(-ttot / T2);
    c.cZ = expf(-ttot / T1);
    c.rec = 1.0f - c.cZ;
    c.dcZ1 = c.cZ * ttot / (T1 * T1);
    c.dcF2 = c.cF * ttot / (T2 * T2);
    c.t = epg::relax_tau_terms(c.cZ, c.cF, ttot, T1, T2);
    c.e2 = p.te_sep ? E2TE : c.cF;
    c.de2 = p.te_sep ? dE2TE : c.dcF2;
    return c;
}

// Unshifted new values of per-atom group g (0 P, 1 U1, 2 U2) at source
// row s, from the rotated rows Rc of the current pulse.
__device__ __forceinline__ void atom_new(const float* Rc, int g, int s,
                                         const Relax& c, float o[6]) {
    const float* y = Rc + s * kAtomRow + 6 * g;
    const float* yp = Rc + s * kAtomRow;
    if (g == 0) {
        for (int j = 0; j < 4; ++j) o[j] = c.cF * y[j];
        o[4] = c.cZ * y[4];
        if (s == 0) o[4] = o[4] + c.rec;
        o[5] = c.cZ * y[5];
    } else if (g == 1) {
        for (int j = 0; j < 4; ++j) o[j] = c.cF * y[j];
        o[4] = c.cZ * y[4] + c.dcZ1 * yp[4];
        if (s == 0) o[4] = o[4] - c.dcZ1;
        o[5] = c.cZ * y[5] + c.dcZ1 * yp[5];
    } else {
        for (int j = 0; j < 4; ++j) o[j] = c.cF * y[j] + c.dcF2 * yp[j];
        o[4] = c.cZ * y[4];
        o[5] = c.cZ * y[5];
    }
}

__device__ __forceinline__ void store_atom_row(float* Rb, int k, int g,
                                               const epg::Rot& r,
                                               const epg::Rot& dr,
                                               const float x[6]) {
    float y[6], q[6];
    rotate(r, x, y);
    rotate(dr, x, q);
    float* row = Rb + k * kAtomRow;
    for (int j = 0; j < 6; ++j) {
        row[6 * g + j] = y[j];
        row[18 + 6 * g + j] = q[j];
    }
}

__device__ __forceinline__ void read6(const epg::PlaneSet& s, int k,
                                      float x[6]) {
    for (int j = 0; j < 6; ++j) x[j] = s.at(j, k);
}

__device__ __forceinline__ void put6(epg::FoldedShift& sh, int k,
                                     const float v[6]) {
    sh.put(k, v[0], v[1], v[2], v[3], v[4], v[5]);
}

// One pulse of lane i's groups (pallas_hessian.py:206-375); m = 1 seeds
// the lane at its own pulse.  Rows are read before they are rewritten by
// the in-place folded shift.
template <bool SECOND>
__device__ __forceinline__ void lane_step(const HessArgs& p,
                                          const epg::PlaneSet* s,
                                          const float* Rc,
                                          const epg::Rot& r, const Relax& c,
                                          float m, size_t at, size_t plane) {
    constexpr int G = SECOND ? 6 : 2;
    const float cF = c.cF, cZ = c.cZ, dcZ1 = c.dcZ1, dcF2 = c.dcF2;
    const float cFt = c.t.cFt, cZt = c.t.cZt, cFt2 = c.t.cFt2,
                cZt1 = c.t.cZt1, e2 = c.e2, de2 = c.de2;
    epg::FoldedShift sh[G];
    for (int g = 0; g < G; ++g) sh[g] = epg::FoldedShift{s[g], 0.0f, 0.0f};
    for (int k = 0; k < p.H; ++k) {
        float row[kAtomRow];
        const float4* src = reinterpret_cast<const float4*>(Rc + k * kAtomRow);
#pragma unroll
        for (int q = 0; q < kAtomRow / 4; ++q) {
            const float4 v = src[q];
            row[4 * q] = v.x;
            row[4 * q + 1] = v.y;
            row[4 * q + 2] = v.z;
            row[4 * q + 3] = v.w;
        }
        const float* YP = row;
        const float* YU1 = row + 6;
        const float* YU2 = row + 12;
        const float* QP = row + 18;
        const float* QU1 = row + 24;
        const float* QU2 = row + 30;
        float x[6], yA[6], yT[6], yW1[6], yW2[6], yX1[6], yX2[6];
        read6(s[0], k, x);
        rotate(r, x, yA);
        read6(s[1], k, x);
        rotate(r, x, yT);
        if constexpr (SECOND) {
            read6(s[2], k, x);
            rotate(r, x, yW1);
            read6(s[3], k, x);
            rotate(r, x, yW2);
            read6(s[4], k, x);
            rotate(r, x, yX1);
            read6(s[5], k, x);
            rotate(r, x, yX2);
        }
        const float rowm = k == 0 ? 1.0f : 0.0f;

        if (k == 0) {  // echoes from the rotated k = 0 rows
            float* o = p.out_lane + at;
            for (int ri = 0; ri < 2; ++ri) {  // re, im
                o[ri * plane] = e2 * (yA[ri] + m * QP[ri]);
                o[(2 + ri) * plane] = p.te_sep
                    ? e2 * yT[ri]
                    : e2 * yT[ri] + m * cFt * YP[ri];
                if constexpr (SECOND) {
                    o[(4 + ri) * plane] = e2 * (yW1[ri] + m * QU1[ri]);
                    o[(6 + ri) * plane] = e2 * yW2[ri] + de2 * yA[ri]
                        + m * (e2 * QU2[ri] + de2 * QP[ri]);
                    if (p.te_sep) {
                        o[(8 + ri) * plane] = e2 * yX1[ri];
                        o[(10 + ri) * plane] = e2 * yX2[ri] + de2 * yT[ri];
                    } else {
                        o[(8 + ri) * plane] = e2 * yX1[ri] + m * cFt * YU1[ri];
                        o[(10 + ri) * plane] = e2 * yX2[ri] + de2 * yT[ri]
                            + m * (cFt * YU2[ri] + cFt2 * YP[ri]);
                    }
                }
            }
        }

        float v[6];
        // a_i: seed lane n with D M' s
        for (int j = 0; j < 4; ++j) v[j] = cF * (yA[j] + m * QP[j]);
        for (int j = 4; j < 6; ++j) v[j] = cZ * (yA[j] + m * QP[j]);
        put6(sh[0], k, v);
        // t_i: seed lane n with D'_tau M s + r'_tau
        for (int j = 0; j < 4; ++j) v[j] = cF * yT[j] + m * cFt * YP[j];
        v[4] = cZ * yT[4] + m * (cZt * YP[4] - rowm * cZt);
        v[5] = cZ * yT[5] + m * cZt * YP[5];
        put6(sh[1], k, v);
        if constexpr (SECOND) {
            // w1 = d2/dT1 da_i
            for (int j = 0; j < 4; ++j) v[j] = cF * (yW1[j] + m * QU1[j]);
            for (int j = 4; j < 6; ++j)
                v[j] = cZ * (yW1[j] + m * QU1[j]) + dcZ1 * (yA[j] + m * QP[j]);
            put6(sh[2], k, v);
            // w2 = d2/dT2 da_i
            for (int j = 0; j < 4; ++j)
                v[j] = cF * (yW2[j] + m * QU2[j]) + dcF2 * (yA[j] + m * QP[j]);
            for (int j = 4; j < 6; ++j) v[j] = cZ * (yW2[j] + m * QU2[j]);
            put6(sh[3], k, v);
            // x1 = d2/dT1 dtau_i
            for (int j = 0; j < 4; ++j) v[j] = cF * yX1[j] + m * cFt * YU1[j];
            v[4] = cZ * yX1[4] + dcZ1 * yT[4]
                + m * (cZt * YU1[4] + cZt1 * YP[4] - rowm * cZt1);
            v[5] = cZ * yX1[5] + dcZ1 * yT[5]
                + m * (cZt * YU1[5] + cZt1 * YP[5]);
            put6(sh[4], k, v);
            // x2 = d2/dT2 dtau_i
            for (int j = 0; j < 4; ++j)
                v[j] = cF * yX2[j] + dcF2 * yT[j]
                    + m * (cFt * YU2[j] + cFt2 * YP[j]);
            for (int j = 4; j < 6; ++j) v[j] = cZ * yX2[j] + m * cZt * YU2[j];
            put6(sh[5], k, v);
        }
    }
    for (int g = 0; g < G; ++g) sh[g].finish();
}

template <bool SECOND>
__global__ void fisp_hess_kernel(const HessArgs p) {
    constexpr int G = SECOND ? 6 : 2;
    extern __shared__ float smem[];
    const int L = static_cast<int>(blockDim.x);
    const int tid = static_cast<int>(threadIdx.x);
    const int H = p.H, N = p.N;
    const int b = blockIdx.x / p.ntiles;
    const int tile = blockIdx.x - b * p.ntiles;
    const int i = tile * L + tid;  // this thread's lane (pulse variable)
    epg::PlaneSet s[G];
    for (int g = 0; g < G; ++g)
        s[g] = epg::PlaneSet{smem + tid + 6 * g * H * L, H, L};
    float* R = smem + 6 * G * H * L;  // [2][H][kAtomRow]

    const float T1 = p.t1[b];
    const float T2 = p.t2[b];
    for (int g = 0; g < G; ++g)
        for (int j = 0; j < 6; ++j)
            for (int k = 0; k < H; ++k) s[g].at(j, k) = 0.0f;
    float E2TE = 0.0f, dE2TE = 0.0f;
    if (p.te_sep) {
        E2TE = expf(-p.te / T2);
        dE2TE = E2TE * p.te / (T2 * T2);
    }

    // pulse 0's per-atom rows: the initial state (Z(0) = 1, or the closed
    // form of a perfect inversion and its dT1 seed), rotated
    epg::Rot r, dr;
    pulse_rot(p, 0, r, dr);
    for (int t = tid; t < 3 * H; t += L) {
        const int g = t / H, k = t - g * H;
        float x[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
        if (k == 0) {
            if (p.use_inv) {
                const float E1i = expf(-p.ti / T1);
                if (g == 0) x[4] = 1.0f - 2.0f * E1i;
                if (g == 1) x[4] = -2.0f * E1i * p.ti / (T1 * T1);
            } else if (g == 0) {
                x[4] = 1.0f;
            }
        }
        store_atom_row(R, k, g, r, dr, x);
    }
    __syncthreads();

    const size_t NN = static_cast<size_t>(N) * N;
    const size_t lane_plane = static_cast<size_t>(p.B) * NN;
    const size_t atom_plane = static_cast<size_t>(p.B) * N;
    for (int n = 0; n < N; ++n) {
        const float* Rc = R + (n & 1) * H * kAtomRow;
        float* Rn = R + ((n + 1) & 1) * H * kAtomRow;
        const Relax c = pulse_relax(p, n, T1, T2, E2TE, dE2TE);
        if (tile == 0 && tid == 0) {
            // per-atom echoes from the rotated k = 0 row
            float* o = p.out_atom + static_cast<size_t>(b) * N + n;
            o[0] = c.e2 * Rc[0];
            o[atom_plane] = c.e2 * Rc[1];
            o[2 * atom_plane] = c.e2 * Rc[6];
            o[3 * atom_plane] = c.e2 * Rc[7];
            o[4 * atom_plane] = c.e2 * Rc[12] + c.de2 * Rc[0];
            o[5 * atom_plane] = c.e2 * Rc[13] + c.de2 * Rc[1];
        }
        if (i < N) {
            const size_t at = static_cast<size_t>(b) * NN
                + static_cast<size_t>(n) * N + i;
            if (i <= n) {
                lane_step<SECOND>(p, s, Rc, r, c, i == n ? 1.0f : 0.0f, at,
                                  lane_plane);
            } else {  // causality: lane i is zero before pulse i
                for (int o = 0; o < 2 * G; ++o)
                    p.out_lane[o * lane_plane + at] = 0.0f;
            }
        }
        if (n + 1 < N) {
            // the next pulse's per-atom rows: relax + recover, fold-shift
            // (A(k) <- A(k-1), A(0) <- B(1), B(k) <- B(k+1), B(N) <- 0),
            // rotate by pulse n+1 and by its d/dalpha
            pulse_rot(p, n + 1, r, dr);
            for (int t = tid; t < 3 * H; t += L) {
                const int g = t / H, k = t - g * H;
                float x[6], nw[6];
                if (k >= 1) {
                    atom_new(Rc, g, k - 1, c, nw);
                    x[0] = nw[0];
                    x[1] = nw[1];
                } else {
                    atom_new(Rc, g, 1, c, nw);
                    x[0] = nw[2];
                    x[1] = nw[3];
                }
                if (k < H - 1) {
                    atom_new(Rc, g, k + 1, c, nw);
                    x[2] = nw[2];
                    x[3] = nw[3];
                } else {
                    x[2] = 0.0f;
                    x[3] = 0.0f;
                }
                atom_new(Rc, g, k, c, nw);
                x[4] = nw[4];
                x[5] = nw[5];
                store_atom_row(Rn, k, g, r, dr, x);
            }
        }
        __syncthreads();
    }
}

template <bool SECOND>
int launch(const HessArgs& a, int block, cudaStream_t stream) {
    constexpr int G = SECOND ? 6 : 2;
    const size_t smem = sizeof(float)
        * (static_cast<size_t>(6 * G) * a.H * block
           + static_cast<size_t>(2 * kAtomRow) * a.H);
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            fisp_hess_kernel<SECOND>,
            cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (e != cudaSuccess) return static_cast<int>(e);
    }
    const long long grid = static_cast<long long>(a.ntiles) * a.B;
    fisp_hess_kernel<SECOND><<<static_cast<unsigned>(grid), block, smem,
                               stream>>>(a);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream` of CUDA device `device`; allocates nothing.  Returns
// the CUDA error code of the launch (0 on success); the caller raises on
// anything else.
extern "C" int epg_fisp_hess(const float* fa, const float* phi,
                             const float* tau, float te, float ti,
                             const float* t1, const float* t2,
                             float* out_atom, float* out_lane, int N, int B,
                             int nstate, int te_sep, int use_inv,
                             int second_order, int block, int device,
                             void* stream) {
    const int ntiles = (N + block - 1) / block;
    if (static_cast<long long>(ntiles) * B > 0x7fffffffLL) return 9;
    HessArgs a{fa, phi, tau, te, ti, t1, t2, out_atom, out_lane, N, B,
               nstate + 1, ntiles, te_sep, use_inv};
    const cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return static_cast<int>(e);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    return second_order ? launch<true>(a, block, st)
                        : launch<false>(a, block, st);
}
