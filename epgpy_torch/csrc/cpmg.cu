// cpmg.cu -- CPMG / multi-spin-echo trains (and DW-TSE).
//
// Replaces the TPU kernel epgpy_tpu/models/pallas_mse.py:_kernel_mse (:114,
// with _diff_att_planes :86), driven there by cpmg_dictionary_pallas
// (:227); the Python wrapper is epgpy_torch/models/cuda_mse.py:
// cpmg_dictionary_cuda and the plain PyTorch twin beside it
// (cpmg_dictionary_plain) computes the same recurrence with the same
// operation order.
//
// What it computes, per atom: after one excitation from equilibrium (closed
// form, the same for every atom), per echo i
//
//     E(tau1_i) S(1) [D1]  T(FA_i * B1, phi_i)  E(tau2_i) S(1) [D2]  ADC
//
// on the folded half-ladder (A(k) = F+(k), B(k) = F+(-k), Z(k), re and im,
// H = nstate + 1 rows); the echo is A(0) after the second shift.  The
// optional DW-TSE attenuation multiplies each row after each shift by
// exp(-f(k) Dc) with the Stejskal-Tanner row factors of diff_attenuation
// (planes.py), per stage b-value base and ramp flag.
//
// What bounds it on the card: instruction issue (2 floats written per atom
// and echo against a rotation, a relaxation and two shifts of every row).
// The design is epg_planes.cuh's segmented layout with blocked rows
// (xgre_jac.cu's): a ladder takes a segment of W = ceil(H / R) lanes and a
// warp holds L = 32 / W ladders; lane r keeps rows r R + c, c < R, of the
// six planes in registers (R = 10 at the published 18 echoes, nstate 36: 8
// ladders of 4 lanes per warp, 60 floats of state per lane; R chosen in
// Python, cuda_mse.cpmg_geometry: 1 or an even R up to 10, with DW-TSE
// too, whose lanes also hold their rows' six attenuation factors, computed
// once).  The
// shift (epg::seg_shift_blocked) moves rows within a lane by register and
// one row of A and of B per lane by a shuffle, so a half-stage costs four
// shuffles whatever R is, and the per-echo work of a lane serves R rows.
// Every row is stepped: cyclic rows (r + W c) would let a half-stage skip
// the register chunks past the rows its echo can have reached
// (epg::reach), but their shift moves every row across lanes, and that
// design measured 2.2x slower at the published train (PERF.md).  The
// per-atom terms of an echo -- sincos(FA_i B1) and the four relaxation
// factors -- are computed for echo t0 + j by lane j of the segment and
// broadcast by shuffles when the echo runs; the atom-independent phase
// terms and the train's flips and delays of a chunk of echoes sit in a
// table the block fills between two barriers.  The row-0 lane stores the
// echo.  4-warp blocks; a segment past the last atom runs on a clamped
// atom and stores nothing.  Math is precise (no fast-math); sincospif of
// the angles in half turns.
#include <cuda_runtime.h>

#include "epg_planes.cuh"

namespace {

// warps per block at most, echoes per chunk at most, table floats per echo
// (cos phi, sin phi, cos 2phi, sin 2phi, FA, tau1, tau2); mirrored by
// cuda_mse.CPMG_WARPS, CPMG_ECHOES and CPMG_TABLE
constexpr int kMaxWarps = 4;
constexpr int kMaxEchoes = 32;
constexpr int kTab = 7;

struct CpmgArgs {
    float exc_ar, exc_ai, exc_z;   // excited F+(0) (re, im) and Z(0)
    const float* fa;    // (E,) refocusing flips, degrees
    const float* phi;   // (E,) refocusing phases, degrees
    const float* tau1;  // (E,) pre-refocusing delays, ms
    const float* tau2;  // (E,) post-refocusing delays, ms
    const float* t1;    // (B,)
    const float* t2;    // (B,)
    const float* b1;    // (B,) refocusing B1 scale
    const float* dc1;   // (B,) stage-1 diffusivity (DIF)
    const float* dc2;   // (B,) stage-2 diffusivity (DIF)
    float bT1, bL1, bT2, bL2;   // b-value bases per stage (DIF)
    float* out;         // (2, E, B): re, im
    int E, B, H;
    int ramp1, ramp2;
    int T;              // echoes per chunk
};

// The largest rows per lane: cuda_mse.CPMG_MAX_ROWS, the R of
// cuda_mse.cpmg_geometry at the published depth and at the gate's deepest
// ladders (nstate 301, 150 with DW-TSE).
constexpr int kMaxRows = 10;

// One half-stage's relaxation of chunk c's row (E2 on the F planes, E1 on
// Z, the recovery `rec` on the row-0 lane's Z).
template <int R>
__device__ __forceinline__ void relax(float (&s)[6][R], int c, float E1,
                                      float E2, float rec, bool row0) {
    s[0][c] *= E2;
    s[1][c] *= E2;
    s[2][c] *= E2;
    s[3][c] *= E2;
    float z = s[4][c] * E1;
    if (row0) z = z + rec;
    s[4][c] = z;
    s[5][c] *= E1;
}

// The post-shift attenuation of the lane's rows.
template <int R>
__device__ __forceinline__ void attenuate(float (&s)[6][R],
                                          const float (&a)[3][R]) {
#pragma unroll
    for (int c = 0; c < R; ++c) {
        s[0][c] *= a[0][c];
        s[1][c] *= a[0][c];
        s[2][c] *= a[1][c];
        s[3][c] *= a[1][c];
        s[4][c] *= a[2][c];
        s[5][c] *= a[2][c];
    }
}

// R rows per lane; DIF: the DW-TSE attenuation.  Static shared memory:
// the chunk's echo table (kTab floats per echo).
template <int R, bool DIF>
__global__ void __launch_bounds__(kMaxWarps* epg::kWarp)
    cpmg_kernel(const CpmgArgs p) {
    __shared__ float tab[kTab * kMaxEchoes];
    const int H = p.H;
    const int W = (H + R - 1) / R;   // lanes per ladder
    const int L = epg::kWarp / W;
    const epg::SegLane q =
        epg::seg_lane(threadIdx.x & (epg::kWarp - 1), W, H);
    const int seg = q.base / W;
    const int warp = static_cast<int>(threadIdx.x / epg::kWarp);
    const int atom = blockIdx.x * static_cast<int>(blockDim.x / epg::kWarp)
                     * L + warp * L + min(seg, L - 1);
    // the segment's row-0 lane stores (idle lanes and atoms past B do not)
    const bool writer = q.r == 0 && seg < L && atom < p.B;
    const int b = min(atom, p.B - 1);   // clamped past the last atom
    const float T1 = p.t1[b];
    const float T2 = p.t2[b];
    const float B1 = p.b1[b];

    float s[6][R];   // s[j][c]: plane j, row r R + c
#pragma unroll
    for (int j = 0; j < 6; ++j)
#pragma unroll
        for (int c = 0; c < R; ++c) s[j][c] = 0.0f;
    if (q.r == 0) {
        s[0][0] = p.exc_ar;
        s[1][0] = p.exc_ai;
        s[2][0] = p.exc_ar;
        s[3][0] = p.exc_ai;
        s[4][0] = p.exc_z;
    }
    // DW-TSE: the stages' (aA, aB, aZ) of the lane's rows (epg::seg_att;
    // its D derivatives are not used)
    float a1[3][DIF ? R : 1], a2[3][DIF ? R : 1];
    if constexpr (DIF) {
        const float d1 = p.dc1[b], d2 = p.dc2[b];
#pragma unroll
        for (int c = 0; c < R; ++c) {
            const int k = q.r * R + c;
            float f1[3], f2[3], unused[3];
            epg::seg_att(k, p.bT1, p.bL1, p.ramp1 != 0, d1, f1, unused);
            epg::seg_att(k, p.bT2, p.bL2, p.ramp2 != 0, d2, f2, unused);
#pragma unroll
            for (int j = 0; j < 3; ++j) {
                a1[j][c] = f1[j];
                a2[j][c] = f2[j];
            }
        }
    }

    const size_t plane = static_cast<size_t>(p.E) * p.B;
    for (int i0 = 0; i0 < p.E; i0 += p.T) {
        const int n = min(p.T, p.E - i0);
        __syncthreads();   // the previous chunk's table reads are done
        for (int e = threadIdx.x; e < n; e += blockDim.x) {
            float* const te = tab + kTab * e;
            const float ph = p.phi[i0 + e] * (1.0f / 180.0f);
            sincospif(ph, &te[1], &te[0]);
            sincospif(2.0f * ph, &te[3], &te[2]);
            te[4] = p.fa[i0 + e];
            te[5] = p.tau1[i0 + e];
            te[6] = p.tau2[i0 + e];
        }
        __syncthreads();
        for (int t0 = 0; t0 < n; t0 += W) {
            const int nu = min(W, n - t0);
            // this lane's per-atom terms of echo t0 + r, broadcast below
            const float* const mine = tab + kTab * (t0 + min(q.r, nu - 1));
            float msa, mca;
            sincospif(mine[4] * B1 * (1.0f / 180.0f), &msa, &mca);
            const float mE1a = expf(-mine[5] / T1);
            const float mE2a = expf(-mine[5] / T2);
            const float mE1b = expf(-mine[6] / T1);
            const float mE2b = expf(-mine[6] / T2);
            for (int u = 0; u < nu; ++u) {
                const int i = i0 + t0 + u;
                const float* const te = tab + kTab * (t0 + u);
                // E(tau1) -> S(1) [-> D1]
                {
                    const float E1 = epg::seg_bcast(q, mE1a, u);
                    const float E2 = epg::seg_bcast(q, mE2a, u);
                    const float rec = 1.0f - E1;
#pragma unroll
                    for (int c = 0; c < R; ++c)
                        relax(s, c, E1, E2, rec, c == 0 && q.r == 0);
                    epg::seg_shift_blocked(q, s);
                    if constexpr (DIF) attenuate(s, a1);
                }
                // T(FA_i * B1, phi_i) -> E(tau2) -> S(1) [-> D2]
                {
                    const epg::Rot r = epg::rot_coeffs_sc(
                        epg::seg_bcast(q, msa, u), epg::seg_bcast(q, mca, u),
                        te[0], te[1], te[2], te[3]);
                    const float E1 = epg::seg_bcast(q, mE1b, u);
                    const float E2 = epg::seg_bcast(q, mE2b, u);
                    const float rec = 1.0f - E1;
#pragma unroll
                    for (int c = 0; c < R; ++c) {
                        const epg::Row x = epg::rotate(
                            r, epg::Row{s[0][c], s[1][c], s[2][c], s[3][c],
                                        s[4][c], s[5][c]});
                        s[0][c] = x.AR;
                        s[1][c] = x.AI;
                        s[2][c] = x.BR;
                        s[3][c] = x.BI;
                        s[4][c] = x.ZR;
                        s[5][c] = x.ZI;
                        relax(s, c, E1, E2, rec, c == 0 && q.r == 0);
                    }
                    epg::seg_shift_blocked(q, s);
                    if constexpr (DIF) attenuate(s, a2);
                }
                if (writer) {
                    const size_t at = static_cast<size_t>(i) * p.B + atom;
                    p.out[at] = s[0][0];
                    p.out[plane + at] = s[1][0];
                }
            }
        }
    }
}

template <int R, bool DIF>
int launch(const CpmgArgs& a, int warps, cudaStream_t stream) {
    const int W = (a.H + R - 1) / R;
    const int atoms = warps * (epg::kWarp / W);
    const int grid = (a.B + atoms - 1) / atoms;
    cpmg_kernel<R, DIF><<<grid, warps * epg::kWarp, 0, stream>>>(a);
    return static_cast<int>(cudaGetLastError());
}

// R = 1 and the even R up to kMaxRows rows per lane (cuda_mse.cpmg_rows)
template <bool DIF, int R = 1>
int launch_r(const CpmgArgs& a, int rows, int warps, cudaStream_t st) {
    if constexpr (R > kMaxRows) {
        return static_cast<int>(cudaErrorInvalidValue);
    } else {
        if (rows == R) return launch<R, DIF>(a, warps, st);
        return launch_r<DIF, R == 1 ? 2 : R + 2>(a, rows, warps, st);
    }
}

}  // namespace

// Launch on `stream` of CUDA device `device`; allocates nothing.  Returns
// the CUDA error code of the launch (0 on success; cudaErrorInvalidValue
// for R other than 1, 2, 4, 6, 8, 10, W = ceil(H / R) lanes beyond a warp,
// `block` outside 1..4 warps or `echoes` outside 1..32); the caller
// raises on anything else.  `R` rows per lane, `block` warps per block and
// `echoes` per chunk come from cuda_mse.cpmg_geometry.
extern "C" int epg_cpmg(float exc_ar, float exc_ai, float exc_z,
                        const float* fa, const float* phi, const float* tau1,
                        const float* tau2, const float* t1, const float* t2,
                        const float* b1, const float* dc1, const float* dc2,
                        float bT1, float bL1, float bT2, float bL2,
                        float* out, int E, int B, int nstate, int use_diff,
                        int ramp1, int ramp2, int R, int block, int echoes,
                        int device, void* stream) {
    CpmgArgs a{exc_ar, exc_ai, exc_z, fa, phi, tau1, tau2, t1, t2, b1,
               dc1, dc2, bT1, bL1, bT2, bL2, out, E, B, nstate + 1,
               ramp1, ramp2, echoes};
    const cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (block < 1 || block > kMaxWarps || R < 1
        || (a.H + R - 1) / R > epg::kWarp || echoes < 1
        || echoes > kMaxEchoes)
        return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    return use_diff ? launch_r<true>(a, R, block, st)
                    : launch_r<false>(a, R, block, st);
}
