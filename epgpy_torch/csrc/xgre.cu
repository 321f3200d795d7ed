// xgre.cu -- EPG-X gradient-echo trains over C exchanging compartments:
// two-pool MT-GRE (spoiled) and bSSFP-MT (balanced) dictionaries.
//
// Replaces the TPU kernel epgpy_tpu/models/pallas_xgre.py:_kernel_xgre
// (:48), driven there by xgre_dictionary_pallas (:142); the Python wrapper
// is epgpy_torch/models/cuda_xgre.py:xgre_dictionary_cuda and the plain
// PyTorch twin beside it (xgre_dictionary_plain) computes the same
// recurrence with the same operation order.
//
// What it computes, per atom, over N TRs [R(sat)?, T, X(A)?, ADC, X(B)?,
// S(1)?]: one folded half-ladder (six planes A/B/Z re+im of H = nstate + 1
// rows) per compartment, Z(0) = 1 in each.  Per TR and compartment c: the
// saturation factors (F+ planes times conj(e^{-rT}), Z times e^{-rL}), the
// rotation by alpha_ic * B1 about phi_ic; then, row by row, the exchange
// stage A (the C x C mix of the compartments' rows with the per-atom
// matrices mT, mL around the k = 0 equilibrium of densities dens), the
// readout of each compartment's F+(0), stage B and the unit shift (none
// for a balanced train, which runs at nstate 0).  An absent stage has
// identity matrices.  Output planes (2, N, C, B): (re, im) of F0 per TR
// and compartment.
//
// What bounds it on the card: the operations -- per atom per TR and row, C
// rotations and saturations and two C x C complex mixes; at the MT-GRE
// main shape (C = 2, nstate 10, 262,144 atoms x 100 TRs) the twin counts
// ~8e10, about half of them the kernel's own work (its identity stage A
// and the identity rotations and saturations skipped: chip_smoke.
// xgre_kernel_ops), against 2 x 100 x 2 x 262,144 x 4 bytes out.  The
// design is xgre_jac.cu's at one group
// (epg_planes.cuh's segmented layout with blocked rows): a ladder takes a
// segment of W = ceil(H / R) lanes, a warp 32 / W ladders, and lane r
// keeps rows r R + k, k < R, of all 6 C planes in registers -- every
// compartment of a row on one lane, so the C x C mixes need no shuffle (R
// from Python, cuda_xgre.xgre_geometry: at most 6 C R = 72 floats of
// state on the fewest lanes, R = 6 on W = 2 at the main shape).  A ladder
// whose 6 C H
// floats fit one lane (nstate 0, the balanced train, at every C; C = 1 up
// to 12 rows, C = 2 up to 6) takes the instance of its own length: no
// padding row, select or shuffle, the shift by register moves.  A TR is
// one step of R rows on every lane (epg::xstage_rows: saturate and rotate
// where the TR's flags say the rows change, mix stage A, stage the echo,
// mix stage B) and then epg::seg_shift_blocked: rows within a lane by
// register, one row of A and of B per lane by a shuffle.  The per-atom
// stage coefficients (6 C^2 floats, constant over the train) sit in a
// per-block shared table, one record per ladder at an odd stride; where
// both stages' 6 C^2 floats fit in registers beside the state (6 C R + 6
// C^2 within 84 floats: a ladder on one lane, not the main shape's 6 rows)
// they are loaded there once, else the mixes read them in place (odd
// record stride: a segment's lanes read one word, a warp's segments
// distinct banks).  A stage whose matrices are the identity for every
// atom of the warp (the MT-GRE train's absent stage A) is skipped; the
// test runs once, before the TR loop, so the branch is warp-uniform.  The
// atom-independent terms of a chunk of up to 32 TRs (the RF phase's
// sin/cos, the saturation factors, the flips and the flags) sit in a table
// the block fills between two barriers; each lane computes the atom's own
// sincos(alpha B1) of a compartment it rotates (a flip of 0 is not
// rotated).  The row-0 lane
// stages the chunk's echoes in shared memory, and after the chunk the
// block copies them out as runs of consecutive atoms (epg::flush_stage),
// with a barrier before the next chunk's table.  4-warp blocks, halved
// while the coefficient table does not fit, held at 128 registers; a
// segment past the last atom runs on a clamped atom and stores nothing.
// Math is precise (no fast-math); sincospif of the angles in half turns.
#include <cuda_runtime.h>

#include "epg_planes.cuh"

namespace {

// warps per block at most, TRs per chunk at most, floats of a block's
// coefficient table, TR table and staged echoes (48 KB); mirrored by
// cuda_fisp.SEG_WARPS, SEG_PULSES and SEG_CHUNK_FLOATS
constexpr int kMaxWarps = 4;
constexpr int kMaxTRs = 32;
constexpr int kChunkFloats = 12288;

// The most rows per lane of a C-compartment instance: 6 C R <= 72 floats
// of state (cuda_xgre.X_STATE).
constexpr int max_rows(int C) { return 12 / C; }

struct XgreArgs {
    const float* alpha;  // (N, C) flips, degrees
    const float* phi;    // (N, C) phases, degrees
    const float* sfr;    // (N, C) saturation of F+: conj(e^{-rT}), re
    const float* sfi;    //                                         im
    const float* szr;    // (N, C) saturation of Z: e^{-rL}, re
    const float* szi;    //                                  im
    const float* dens;   // (C,) equilibrium densities
    const float* b1;     // (B,) flip scale
    const float* coef;   // (6 C C, B): stage A then B, parts mT re/im, mL
    float* out;          // (2, N, C, B): re, im
    int N, B, H, shift;
    int T;               // TRs per chunk
};

// C compartments, R rows per lane; ONE: a ladder of exactly R rows on one
// lane (H = R, W = 1).  Dynamic shared memory: the coefficient table (A
// records of S = 6 C C | 1 floats: stage A then B, each mT re, mT im,
// mL), the chunk's TR table (epg::kXTab floats per TR and compartment)
// and the staged echoes (2, T C, A).
template <int C, int R, bool ONE>
__global__ void __launch_bounds__(kMaxWarps* epg::kWarp, 4)
    xgre_kernel(const XgreArgs p) {
    extern __shared__ float smem[];
    constexpr bool REG = epg::kXmixInRegisters<C, R>;
    constexpr int CC = C * C;
    constexpr int S = (6 * CC) | 1;   // floats per ladder's record (odd)
    const int T = p.T;
    const int H = ONE ? R : p.H;
    const int W = ONE ? 1 : (H + R - 1) / R;   // lanes per ladder
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
    float* const stage = tab + epg::kXTab * C * T;
    const int TC = T * C;   // floats per staged output plane and atom

    // the coefficient table, read in runs of consecutive atoms
    for (int e = threadIdx.x; e < 6 * CC * A; e += blockDim.x) {
        const int qr = e / A;
        const int a = e - qr * A;
        ctab[a * S + qr] = p.coef[static_cast<size_t>(qr) * p.B
                                  + min(atom0 + a, p.B - 1)];
    }
    __syncthreads();
    const float* const rec = ctab + slot * S;   // this lane's ladder
    const auto mA = epg::record_xmix<C, REG>(rec);
    const auto mB = epg::record_xmix<C, REG>(rec + 3 * CC);
    // a stage that is the identity for every atom of the warp
    const bool skipA =
        __all_sync(epg::kFullMask, epg::xmix_identity<C>(mA));
    const bool skipB =
        __all_sync(epg::kFullMask, epg::xmix_identity<C>(mB));
    // the densities, read by the row-0 lanes' mixes (a broadcast load)
    const epg::GlobalCol dens{p.dens, 1};
    const float B1 = p.b1[b];

    float s[C][6][R];   // s[c][j][k]: plane j of pool c, row r R + k
#pragma unroll
    for (int c = 0; c < C; ++c)
#pragma unroll
        for (int j = 0; j < 6; ++j)
#pragma unroll
            for (int k = 0; k < R; ++k) s[c][j][k] = 0.0f;
    if (q.r == 0)
#pragma unroll
        for (int c = 0; c < C; ++c) s[c][4][0] = 1.0f;

    const size_t plane = static_cast<size_t>(p.N) * C * p.B;
    for (int i0 = 0; i0 < p.N; i0 += T) {
        const int n = min(T, p.N - i0);
        for (int e = threadIdx.x; e < n * C; e += blockDim.x) {
            const int qi = i0 * C + e;   // (TR, compartment) of the chunk
            float* const te = tab + epg::kXTab * e;
            const float ph = p.phi[qi] * (1.0f / 180.0f);
            sincospif(ph, &te[1], &te[0]);
            sincospif(2.0f * ph, &te[3], &te[2]);
            te[4] = p.sfr[qi];
            te[5] = p.sfi[qi];
            te[6] = p.szr[qi];
            te[7] = p.szi[qi];
            te[8] = p.alpha[qi];
            te[epg::kXFlags] = epg::xflags(te, true);
        }
        __syncthreads();
        for (int t = 0; t < n; ++t) {
            const float* const tr = tab + epg::kXTab * C * t;
            // compartment c's rotation (sincos of the atom's flip), when
            // its rows are rotated
            const auto rot = [&](int c) {
                const float* const te = tr + epg::kXTab * c;
                float sa, ca;
                sincospif(te[8] * B1 * (1.0f / 180.0f), &sa, &ca);
                return epg::rot_coeffs_sc(sa, ca, te[0], te[1], te[2],
                                          te[3]);
            };
            epg::xstage_rows<C, R>(
                s, rot, tr, mA, skipA, mB, skipB, dens, q.r == 0,
                writer ? stage + (t * C) * A + slot : nullptr, A, TC, 1.0f,
                0.0f, false);
            if (p.shift) {
#pragma unroll
                for (int c = 0; c < C; ++c) {
                    if constexpr (ONE) {
                        if constexpr (R > 1) epg::lane_shift<0, 2, R>(s[c]);
                    } else {
                        epg::seg_shift_blocked(q, s[c]);
                    }
                }
            }
        }
        __syncthreads();
        epg::flush_stage(stage, p.out, 2, TC, n * C, A, plane,
                         static_cast<size_t>(i0) * C, p.B, atom0);
        __syncthreads();   // the flush is done before the next chunk
    }
}

template <int C, int R, bool ONE>
int launch(const XgreArgs& a, int warps, cudaStream_t stream) {
    constexpr int S = (6 * C * C) | 1;
    const int W = ONE ? 1 : (a.H + R - 1) / R;
    const int A = warps * (epg::kWarp / W);
    const int per = epg::kXTab * C + 2 * C * A;   // floats per TR
    if (S * A + a.T * per > kChunkFloats)
        return static_cast<int>(cudaErrorInvalidValue);
    const size_t smem = sizeof(float) * (static_cast<size_t>(S) * A
                                         + static_cast<size_t>(a.T) * per);
    const int grid = (a.B + A - 1) / A;
    xgre_kernel<C, R, ONE><<<grid, warps * epg::kWarp, smem, stream>>>(a);
    return static_cast<int>(cudaGetLastError());
}

// R = 1 .. max_rows(C) rows per lane: a ladder of H = R rows takes the
// one-lane instance of its length, any other H the instance of R, which
// exists above max_rows(C) / 2 rows -- the rows the fewest lanes give a
// ladder longer than one lane holds (cuda_xgre.x_rows).
template <int C, int R = 1>
int launch_r(const XgreArgs& a, int rows, int warps, cudaStream_t st) {
    if constexpr (R > max_rows(C)) {
        return static_cast<int>(cudaErrorInvalidValue);
    } else {
        if (rows != R) return launch_r<C, R + 1>(a, rows, warps, st);
        if (a.H == R) return launch<C, R, true>(a, warps, st);
        if constexpr (2 * R > max_rows(C))
            return launch<C, R, false>(a, warps, st);
        return static_cast<int>(cudaErrorInvalidValue);
    }
}

}  // namespace

// Launch on `stream` of CUDA device `device`; allocates nothing.  Returns
// the CUDA error code of the launch (0 on success; cudaErrorInvalidValue
// for C outside 1..4, R without an instance (launch_r), W = ceil(H / R)
// lanes beyond a warp, `block` outside 1..4 warps, `pulses` outside
// 1..32, or a block whose coefficient table and chunk pass 48 KB); the
// caller raises on anything else.  `R` rows per lane, `block` warps per
// block and `pulses` TRs per chunk come from cuda_xgre.xgre_geometry.
extern "C" int epg_xgre(const float* alpha, const float* phi,
                        const float* sfr, const float* sfi, const float* szr,
                        const float* szi, const float* dens, const float* b1,
                        const float* coef, float* out, int N, int C, int B,
                        int nstate, int shift, int R, int block, int pulses,
                        int device, void* stream) {
    XgreArgs a{alpha, phi, sfr, sfi, szr, szi, dens, b1, coef, out,
               N, B, nstate + 1, shift, pulses};
    const cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (block < 1 || block > kMaxWarps || R < 1
        || (a.H + R - 1) / R > epg::kWarp || pulses < 1
        || pulses > kMaxTRs)
        return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (C) {
        case 1: return launch_r<1>(a, R, block, st);
        case 2: return launch_r<2>(a, R, block, st);
        case 3: return launch_r<3>(a, R, block, st);
        case 4: return launch_r<4>(a, R, block, st);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}
