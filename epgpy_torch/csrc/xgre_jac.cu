// xgre_jac.cu -- EPG-X gradient-echo trains and their tangents in one pass:
// the per-voxel qMT Gauss-Newton fit's Jacobian (bound-pool fraction,
// free-pool T2, exchange rate, ...).
//
// Replaces the TPU kernel epgpy_tpu/models/pallas_xgre.py:_kernel_xgre_jac
// (:282), driven there by xgre_jacobian_pallas (:400); the Python wrapper
// is epgpy_torch/models/cuda_xgre.py:xgre_jacobian_cuda and the plain
// PyTorch twin beside it (xgre_jacobian_plain) computes the same recurrence
// with the same operation order.
//
// What it computes: xgre.cu's train for G = V + 1 plane groups -- group 0
// the primal, groups 1..V one tangent per fit variable.  The variables
// enter only through the exchange stage matrices and the (per-atom)
// equilibrium densities, so saturation, rotation and shift act on every
// group alike, and each exchange stage adds the product-rule term
// t'_i = sum_j [M_ij (t_j - de_j) + dM_ij (x_j - e_j)] + de_i, whose x is
// the primal from BEFORE the mix (the tangents are mixed first).  Inputs:
// per-atom densities (G C, B) rows g C + c, coefficients (G 6 C C, B) rows
// g 6CC + stage 3CC + part CC + i C + j.  Output planes (2, N, G, C, B):
// (re, im) of F0 per TR, group and compartment.
//
// What bounds it on the card: the operations -- G times xgre.cu's
// rotations plus 2 G - 1 complex mixes per row (the tangent mix is two
// products); at C = 2, G = 3, nstate 10, 262,144 atoms x 48 TRs ~1.6e11,
// ~1.1e11 with an identity stage A skipped (~1.7 ms at the FP32 peak) --
// while the state, 6 C G planes of H = nstate + 1 rows per atom (1,584
// bytes at the main shape), let no more than 4 warps of one thread per
// atom onto an SM.  The design is epg_planes.cuh's segmented layout
// (fisp_jac.cu's) with blocked rows: a ladder takes a segment of W =
// ceil(H / R) lanes and a warp holds 32 / W ladders; lane r keeps rows
// r R + c, c < R, of all 6 C G planes in registers (R = 2 at the main
// shape: 5 ladders of 6 lanes per warp, 72 floats of state per lane; C, G
// and R are template parameters, R chosen in Python, cuda_xgre.
// xgre_jac_geometry).  A TR is one step of R rows on every lane --
// saturate, rotate, mix stage A, mix stage B -- and
// epg::seg_shift_blocked moves every plane pair: rows within a lane by
// register, one row of A and of B per lane by a shuffle.  The per-atom
// stage coefficients and densities (6 C^2 G + C G floats, constant over
// the train) sit in a per-block shared table, one record per ladder at an
// odd stride, read in place by the mixes: a segment's lanes read one
// word, a warp's segments distinct banks, each read one base register
// plus an immediate offset.  The atom-independent terms of a chunk of TRs
// (the RF phase's sin/cos, the saturation factors, the flips) sit in a
// table the block fills between two barriers; the atom's own rotation,
// sincos(alpha B1) per compartment, of TR t0 + j is computed by lane j of
// the segment and broadcast by a shuffle when that TR runs.  A warp whose
// atoms all have the identity stage A with zero tangents (the qMT fit's
// single-stage train) skips stage A's mix; the test runs once, before the
// TR loop, so the branch is warp-uniform.  The row-0 lane stages the
// chunk's echoes in shared memory, and after the chunk the block copies
// them out as runs of consecutive atoms (epg::flush_stage).  4-warp
// blocks, halved while the coefficient table does not fit; a segment past
// the last atom runs on a clamped atom and stores nothing.  Math is
// precise (no fast-math); sincospif of the angles in half turns.
#include <cuda_runtime.h>

#include "epg_planes.cuh"

namespace {

// warps per block at most, TRs per chunk at most, floats of a block's
// coefficient table, TR table and staged echoes (48 KB), TR-table floats
// per compartment; mirrored by cuda_fisp.SEG_WARPS, SEG_PULSES,
// SEG_CHUNK_FLOATS and cuda_xgre.XGRE_JAC_TABLE
constexpr int kMaxWarps = 4;
constexpr int kMaxTRs = 32;
constexpr int kChunkFloats = 12288;
constexpr int kTab = 9;

struct XgreJacArgs {
    const float* alpha;  // (N, C) flips, degrees
    const float* phi;    // (N, C) phases, degrees
    const float* sfr;    // (N, C) saturation of F+, re
    const float* sfi;    //                          im
    const float* szr;    // (N, C) saturation of Z, re
    const float* szi;    //                         im
    const float* b1;     // (B,) flip scale
    const float* dens;   // (G C, B) densities and their tangents
    const float* coef;   // (G 6 C C, B) stage matrices and their tangents
    float* out;          // (2, N, G, C, B): re, im
    int N, B, H, shift;
    int T;               // TRs per chunk
};

// The largest rows per lane a (C, G) instance takes: cuda_xgre.
// xgre_jac_geometry's R at the gate's deepest ladder, H = 302 / (C G)
// (ceil(H / 32) rows, at least 2 up to C G = 6 past 3 rows).
constexpr int max_rows(int cg) {
    return cg <= 2 ? 5 : cg == 3 ? 4 : cg == 4 ? 3 : cg <= 9 ? 2 : 1;
}

// Register budget per instance: 3 blocks of kMaxWarps warps per SM (at
// most 168 registers) while the state is at most 72 floats and the mixes'
// coefficient reads per lane, C^2 G R, at most 24 (ptxas -v: 0 B of stack
// for those), no cap above.
template <int C, int G, int R>
constexpr int kMinBlocks =
    6 * C * G * R <= 72 && C * C * G * R <= 24 ? 3 : 1;

using epg::Row;

// One exchange stage on every group's row: the tangents first (they read
// the pre-mix primal), then the primal.
template <int C, int G>
__device__ __forceinline__ void mix_stage(
    const epg::SharedXMix<C> (&m)[G], const epg::SharedCol (&dens)[G],
    bool k0, const Row (&x)[G][C], Row (&y)[G][C]) {
#pragma unroll
    for (int g = 1; g < G; ++g)
        epg::mix_tangent_rows<C>(m[0], m[g], dens[0], dens[g], k0, x[g],
                                 x[0], y[g]);
    epg::mix_rows<C>(m[0], dens[0], k0, x[0], y[0]);
}

// C compartments, G groups, R rows per lane.  Dynamic shared memory: the
// coefficient table (A records of S = NQ | 1 floats, NQ = 6 C C G + C G:
// stage A then B of each group, then the densities), the chunk's TR table
// (kTab floats per TR and compartment: cos phi, sin phi, cos 2phi,
// sin 2phi, the four saturation factors, the flip) and the staged echoes
// (2, T G C, A).
template <int C, int G, int R>
__global__ void __launch_bounds__(kMaxWarps* epg::kWarp, kMinBlocks<C, G, R>)
    xgre_jac_kernel(const XgreJacArgs p) {
    extern __shared__ float smem[];
    constexpr int CC = C * C;
    constexpr int NQ = 6 * CC * G + C * G;
    constexpr int S = NQ | 1;   // floats per ladder's record (odd)
    const int T = p.T;
    const int H = p.H;
    const int W = (H + R - 1) / R;   // lanes per ladder
    const int L = epg::kWarp / W;
    const epg::SegLane q =
        epg::seg_lane(threadIdx.x & (epg::kWarp - 1), W, H);
    const int seg = q.base / W;
    const int warp = static_cast<int>(threadIdx.x / epg::kWarp);
    const int A = static_cast<int>(blockDim.x / epg::kWarp) * L;
    const int slot = warp * L + min(seg, L - 1);   // idle lanes: the last
    const int atom0 = blockIdx.x * A;
    const bool writer = q.r == 0 && seg < L;   // the segment's row-0 lane
    const int b = min(atom0 + slot, p.B - 1);  // clamped past the last atom
    float* const ctab = smem;
    float* const tab = ctab + S * A;
    float* const stage = tab + kTab * C * T;
    const int TGC = T * G * C;   // floats per staged output plane and atom

    // the coefficient table, read in runs of consecutive atoms
    for (int e = threadIdx.x; e < NQ * A; e += blockDim.x) {
        const int qr = e / A;
        const int a = e - qr * A;
        const int at = min(atom0 + a, p.B - 1);
        ctab[a * S + qr] =
            qr < 6 * CC * G
                ? p.coef[static_cast<size_t>(qr) * p.B + at]
                : p.dens[static_cast<size_t>(qr - 6 * CC * G) * p.B + at];
    }
    __syncthreads();
    const float* const rec = ctab + slot * S;   // this lane's ladder
    epg::SharedXMix<C> mA[G], mB[G];
    epg::SharedCol dens[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
        mA[g] = epg::shared_xmix<C>(rec + g * 6 * CC);
        mB[g] = epg::shared_xmix<C>(rec + g * 6 * CC + 3 * CC);
        dens[g] = epg::SharedCol{rec + 6 * CC * G + g * C};
    }
    // stage A is the identity with zero tangents for every atom of the warp
    bool ident = true;
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
        for (int k = 0; k < CC; ++k) {
            const float one = g == 0 && k % (C + 1) == 0 ? 1.0f : 0.0f;
            ident = ident && mA[g].r[k] == one && mA[g].i[k] == 0.0f
                    && mA[g].l[k] == one;
        }
    const bool skipA = __all_sync(epg::kFullMask, ident);
    const float B1 = p.b1[b];

    float s[G][C][6][R];   // s[g][c][j][k]: plane j of group g, pool c,
                           // row r R + k
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
        for (int c = 0; c < C; ++c)
#pragma unroll
            for (int j = 0; j < 6; ++j)
#pragma unroll
                for (int k = 0; k < R; ++k) s[g][c][j][k] = 0.0f;
    if (q.r == 0)
#pragma unroll
        for (int c = 0; c < C; ++c) s[0][c][4][0] = 1.0f;  // tangents: 0

    const size_t plane = static_cast<size_t>(p.N) * G * C * p.B;
    for (int i0 = 0; i0 < p.N; i0 += T) {
        const int n = min(T, p.N - i0);
        for (int e = threadIdx.x; e < n * C; e += blockDim.x) {
            const int qi = i0 * C + e;   // (TR, compartment) of the chunk
            float* const te = tab + kTab * e;
            const float ph = p.phi[qi] * (1.0f / 180.0f);
            sincospif(ph, &te[1], &te[0]);
            sincospif(2.0f * ph, &te[3], &te[2]);
            te[4] = p.sfr[qi];
            te[5] = p.sfi[qi];
            te[6] = p.szr[qi];
            te[7] = p.szi[qi];
            te[8] = p.alpha[qi];
        }
        __syncthreads();
        for (int t0 = 0; t0 < n; t0 += W) {
            const int nu = min(W, n - t0);
            // this lane's flips of TR t0 + r, broadcast below
            float msa[C], mca[C];
            const float* const mine = tab + kTab * C * (t0 + min(q.r, nu - 1));
#pragma unroll
            for (int c = 0; c < C; ++c)
                sincospif(mine[kTab * c + 8] * B1 * (1.0f / 180.0f), &msa[c],
                          &mca[c]);
            for (int u = 0; u < nu; ++u) {
                const int t = t0 + u;
                const float* const tr = tab + kTab * C * t;
                epg::Rot r[C];
#pragma unroll
                for (int c = 0; c < C; ++c) {
                    const float* const te = tr + kTab * c;
                    r[c] = epg::rot_coeffs_sc(epg::seg_bcast(q, msa[c], u),
                                              epg::seg_bcast(q, mca[c], u),
                                              te[0], te[1], te[2], te[3]);
                }
#pragma unroll
                for (int k = 0; k < R; ++k) {
                    const bool k0 = k == 0 && q.r == 0;
                    Row x[G][C], y[G][C];
#pragma unroll
                    for (int g = 0; g < G; ++g)
#pragma unroll
                        for (int c = 0; c < C; ++c) {
                            const float* const te = tr + kTab * c;
                            x[g][c] = epg::rotate(
                                r[c],
                                epg::saturate(epg::lane_row(s[g][c], k),
                                              te[4], te[5], te[6], te[7]));
                        }
                    if (skipA) {
#pragma unroll
                        for (int g = 0; g < G; ++g)
#pragma unroll
                            for (int c = 0; c < C; ++c) y[g][c] = x[g][c];
                    } else {
                        mix_stage<C, G>(mA, dens, k0, x, y);
                    }
                    if (k == 0 && writer) {
                        float* const e = stage + (t * G * C) * A + slot;
#pragma unroll
                        for (int g = 0; g < G; ++g)
#pragma unroll
                            for (int c = 0; c < C; ++c) {
                                e[(g * C + c) * A] = y[g][c].AR;
                                e[(TGC + g * C + c) * A] = y[g][c].AI;
                            }
                    }
                    mix_stage<C, G>(mB, dens, k0, y, x);
#pragma unroll
                    for (int g = 0; g < G; ++g)
#pragma unroll
                        for (int c = 0; c < C; ++c)
                            epg::lane_put(s[g][c], k, x[g][c]);
                }
                if (p.shift)
#pragma unroll
                    for (int g = 0; g < G; ++g)
#pragma unroll
                        for (int c = 0; c < C; ++c)
                            epg::seg_shift_blocked(q, s[g][c]);
            }
        }
        __syncthreads();
        epg::flush_stage(stage, p.out, 2, TGC, n * G * C, A, plane,
                         static_cast<size_t>(i0) * G * C, p.B, atom0);
    }
}

template <int C, int G, int R>
int launch(XgreJacArgs a, int warps, cudaStream_t stream) {
    constexpr int S = (6 * C * C * G + C * G) | 1;
    const int W = (a.H + R - 1) / R;
    const int A = warps * (epg::kWarp / W);
    const int per = kTab * C + 2 * G * C * A;   // floats per TR
    if (S * A + a.T * per > kChunkFloats)
        return static_cast<int>(cudaErrorInvalidValue);
    const size_t smem =
        sizeof(float) * (static_cast<size_t>(S) * A
                         + static_cast<size_t>(a.T) * per);
    const int grid = (a.B + A - 1) / A;
    xgre_jac_kernel<C, G, R>
        <<<grid, warps * epg::kWarp, smem, stream>>>(a);
    return static_cast<int>(cudaGetLastError());
}

// R = 1 .. max_rows(C G) rows per lane
template <int C, int G>
int launch_r(const XgreJacArgs& a, int R, int warps, cudaStream_t st) {
    constexpr int top = max_rows(C * G);
    switch (R) {
        case 1: return launch<C, G, 1>(a, warps, st);
        case 2:
            if constexpr (top >= 2) return launch<C, G, 2>(a, warps, st);
            break;
        case 3:
            if constexpr (top >= 3) return launch<C, G, 3>(a, warps, st);
            break;
        case 4:
            if constexpr (top >= 4) return launch<C, G, 4>(a, warps, st);
            break;
        case 5:
            if constexpr (top >= 5) return launch<C, G, 5>(a, warps, st);
            break;
        default:
            break;
    }
    return static_cast<int>(cudaErrorInvalidValue);
}

// G = 2..5 groups with C G <= 12 (at most 72 planes): instances beyond
// are refused
template <int C>
int launch_g(const XgreJacArgs& a, int G, int R, int warps,
             cudaStream_t st) {
    if (C * G > 12) return static_cast<int>(cudaErrorInvalidValue);
    switch (G) {
        case 2: return launch_r<C, 2>(a, R, warps, st);
        case 3: return launch_r<C, (C <= 4 ? 3 : 2)>(a, R, warps, st);
        case 4: return launch_r<C, (C <= 3 ? 4 : 2)>(a, R, warps, st);
        case 5: return launch_r<C, (C <= 2 ? 5 : 2)>(a, R, warps, st);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

}  // namespace

// Launch on `stream` of CUDA device `device`; allocates nothing.  Returns
// the CUDA error code of the launch (0 on success; cudaErrorInvalidValue
// for C outside 1..4, G outside 2..5, C G > 12, R outside 1..max_rows(C G),
// W = ceil(H / R) lanes beyond a warp, `pulses` outside 1..32, or a block
// whose coefficient table and chunk pass 48 KB); the caller raises on
// anything else.  `block` is warps per block (at most 4), `R` the ladder's
// rows per lane and `pulses` the TRs per chunk, all from
// cuda_xgre.xgre_jac_geometry.
extern "C" int epg_xgre_jac(const float* alpha, const float* phi,
                            const float* sfr, const float* sfi,
                            const float* szr, const float* szi,
                            const float* b1, const float* dens,
                            const float* coef, float* out, int N, int C,
                            int G, int B, int nstate, int shift, int R,
                            int block, int pulses, int device,
                            void* stream) {
    XgreJacArgs a{alpha, phi, sfr, sfi, szr, szi, b1, dens, coef, out,
                  N, B, nstate + 1, shift, pulses};
    const cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (block < 1 || block > kMaxWarps || R < 1
        || (a.H + R - 1) / R > epg::kWarp || pulses < 1
        || pulses > kMaxTRs)
        return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (C) {
        case 1: return launch_g<1>(a, G, R, block, st);
        case 2: return launch_g<2>(a, G, R, block, st);
        case 3: return launch_g<3>(a, G, R, block, st);
        case 4: return launch_g<4>(a, G, R, block, st);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}
