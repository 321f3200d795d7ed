// xcomposite_jac.cu -- composite EPG-X stage trains and their tangents in
// one pass: per-voxel qMT Gauss-Newton fits over MT-prepared schedules.
//
// Replaces the TPU kernel epgpy_tpu/models/pallas_xcomposite.py:
// _kernel_xcomp_jac (:292), driven there by xcomposite_jacobian_pallas
// (:475); the Python wrapper is epgpy_torch/models/cuda_xcomposite.py:
// xcomposite_jacobian_cuda and the plain PyTorch twin beside it
// (xcomposite_jacobian_plain) computes the same recurrence with the same
// operation order.
//
// What it computes: xcomposite.cu's train for G = V + 1 plane groups (the
// primal, then one tangent per fit variable).  Variables enter only through
// the stage-matrix tables and the per-atom densities, so saturation,
// rotation and shift act on every group alike; each table mix adds the
// product-rule term t'_i = sum_j [M_ij (t_j - de_j) + dM_ij (x_j - e_j)] +
// de_i with the group's tangent table entry, x the primal from before the
// mix.  Inputs: densities (G C, B) rows g C + c; tables (G, nmat, 3 C C,
// B).  Output planes (2, nadc, G, C, B).
//
// What bounds it on the card: the operations -- G times xcomposite.cu's
// rotations and 2 G - 1 complex mixes per row; at the exchange-rate fit (C
// = 2, G = 2, nstate 8, 65,536 atoms x 156 stages) 66.8 GFLOP, ~1.0 ms at
// the FP32 peak -- while the state, 6 C G planes of H = nstate + 1 rows
// per atom, let no more than 8 warps of one thread per atom onto an SM.
// The design is xgre_jac.cu's: epg_planes.cuh's segmented layout with
// blocked rows -- a ladder takes a segment of W = ceil(H / R) lanes and a
// warp holds 32 / W ladders; lane r keeps rows r R + c, c < R, of all 6 C
// G planes in registers (R = 3 at the exchange-rate fit: 10 ladders of 3
// lanes per warp, 72 floats of state per lane; C, G and R are template
// parameters, R chosen in Python, cuda_xcomposite.xcomp_jac_geometry).
// A stage is one step of R rows on every lane -- saturate, rotate, mix table
// entry mia, stage the echo, mix entry mib -- and then the stage's shift,
// whose direction is the same for every atom (a warp-uniform branch): up by
// epg::seg_shift_blocked, down by epg::seg_shift_blocked_down (rows within a
// lane by register, one row of A and of B per lane by a shuffle), or none.
// The per-atom tables and densities (nmat G 3 C^2 + C G floats, constant
// over the train) sit in a per-block shared table, one record per ladder at
// an odd stride, read in place by the mixes; where one warp's records do not
// fit in the block's 48 KB (many distinct taus at many pools), the kernel's
// second mode reads the stage's two entries in place from device memory
// instead, each segment's lanes reading the same word (`SHARED`; the
// geometry chooses the mode by shape). The atom-independent terms of a chunk
// of stages (the RF phase's sin/cos, the saturation factors, the flips, the
// output row, shift direction, table entries, B1 sensitivity and the ADC
// phase's sin/cos) sit in a table the block fills between two barriers; the
// atom's own rotation, sincos(alpha eff) per compartment, of stage t0 + j is
// computed by lane j of the segment and broadcast by a shuffle when that
// stage runs. The table also flags, per stage and compartment, whether the
// saturation and the rotation change the rows for every atom: MT trains
// leave the bound pool unflipped and saturate it only in the preparation,
// and a stage skips what it leaves unchanged (a warp-uniform branch; the
// skipped products are exact identities, so the result is the twin's). The
// row-0 lane stages the readout stages' echoes in shared memory, and after
// the chunk the block copies them to their output rows as runs of
// consecutive atoms (epg::flush_stage_rows). 4-warp blocks, halved while the
// coefficient table does not fit; a segment past the last atom runs on a
// clamped atom and stores nothing. Math is precise (no fast-math); sincospif
// of the angles in half turns.
#include <cuda_runtime.h>

#include "epg_planes.cuh"

namespace {

// warps per block at most, stages per chunk at most, floats of a block's
// coefficient table, stage table and staged echoes (48 KB), stage-table
// floats per compartment and per stage; mirrored by cuda_fisp.SEG_WARPS,
// SEG_PULSES, SEG_CHUNK_FLOATS and cuda_xcomposite.XCOMP_JAC_TABLE,
// XCOMP_JAC_STAGE
constexpr float kInvPi = 0.3183098861837907f;   // 1 / pi
constexpr int kMaxWarps = 4;
constexpr int kMaxStages = 32;
constexpr int kChunkFloats = 12288;
constexpr int kStage = 7;
// the stage table per compartment and its flags (epg_planes.cuh): a
// compartment's rows are saturated (has_sat and factors other than (1, 0,
// 1, 0)), rotated (a flip other than 0: the rotation by 0 is the identity)
using epg::kXFlags;
using epg::kXRotate;
using epg::kXSaturate;
constexpr int kTab = epg::kXTab;

struct XcompJacArgs {
    const float* alpha;  // (N, C) flips, degrees
    const float* phi;    // (N, C) phases, degrees
    const float* sfr;    // (N, C) saturation of F+, re (use_sat)
    const float* sfi;    //                          im
    const float* szr;    // (N, C) saturation of Z, re
    const float* szi;    //                         im
    const int* adci;     // (N,) output row, -1 = no readout
    const int* shift;    // (N,) shift direction in {-1, 0, +1}
    const float* aph;    // (N,) ADC phase, radians (use_adcph)
    const int* mia;      // (N,) table entry before the readout
    const int* mib;      // (N,) table entry after the readout
    const float* b1u;    // (N,) B1 sensitivity (use_b1u)
    const float* dens;   // (G C, B) densities and their tangents
    const float* b1;     // (B,) flip scale
    const float* table;  // (G, nmat, 3 C C, B) tables and their tangents
    float* out;          // (2, nadc, G, C, B): re, im
    int N, B, H, nadc, nmat;
    int use_up, use_down, use_adcph, use_sat, use_b1u;
    int T;               // stages per chunk
};

// The largest rows per lane a (C, G) instance takes: cuda_xcomposite.
// xcomp_jac_geometry's R at the gate's deepest ladder, H = 302 / (C G).
constexpr int max_rows(int cg) {
    return cg <= 2 ? 5 : cg == 3 ? 4 : cg == 4 ? 3 : cg <= 9 ? 2 : 1;
}

// Register budget per instance: 3 blocks of kMaxWarps warps per SM (at
// most 168 registers) while the state is at most 72 floats and the mixes'
// coefficient reads per lane, C^2 G R, at most 24, with the table in
// shared memory; no cap otherwise.
template <int C, int G, int R, bool SHARED>
constexpr int kMinBlocks =
    SHARED && 6 * C * G * R <= 72 && C * C * G * R <= 24 ? 3 : 1;

using epg::Row;

// the global mode's stage entries and densities, read in place from device
// memory
using epg::GlobalCol;
using epg::GlobalXMix;

// One table mix on every group's row: the tangents first (they read the
// pre-mix primal), then the primal.
template <int C, int G, class M, class D>
__device__ __forceinline__ void mix_stage(const M (&m)[G], const D (&dens)[G],
                                          bool k0, const Row (&x)[G][C],
                                          Row (&y)[G][C]) {
#pragma unroll
    for (int g = 1; g < G; ++g)
        epg::mix_tangent_rows<C>(m[0], m[g], dens[0], dens[g], k0, x[g],
                                 x[0], y[g]);
    epg::mix_rows<C>(m[0], dens[0], k0, x[0], y[0]);
}

// The R rows of one stage on the lane: saturate and rotate compartment
// c's rows where the stage's flags (te[kXFlags] of its compartment) say
// they change, then per row mix mA, stage the echo (row-0 lane of a
// readout stage: `echo` points at the stage's staged (re, im) planes, `pl`
// floats apart), mix mB.  The flags are the same for every atom, so the
// skips are warp-uniform branches.
template <int C, int G, int R, class M, class D>
__device__ __forceinline__ void stage_rows(
    float (&s)[G][C][6][R], const epg::Rot (&r)[C], const float* tr,
    const M (&mA)[G], const M (&mB)[G], const D (&dens)[G], bool row0_lane,
    float* echo, int A, int pl, float pc, float ps, bool adcph) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
        const float* const te = tr + kTab * c;
        const int flags = __float_as_int(te[kXFlags]);
        if (flags & kXSaturate) {
#pragma unroll
            for (int g = 0; g < G; ++g)
#pragma unroll
                for (int k = 0; k < R; ++k)
                    epg::lane_put(s[g][c], k,
                                  epg::saturate(epg::lane_row(s[g][c], k),
                                                te[4], te[5], te[6], te[7]));
        }
        if (flags & kXRotate) {
#pragma unroll
            for (int g = 0; g < G; ++g)
#pragma unroll
                for (int k = 0; k < R; ++k)
                    epg::lane_put(
                        s[g][c], k,
                        epg::rotate(r[c], epg::lane_row(s[g][c], k)));
        }
    }
#pragma unroll
    for (int k = 0; k < R; ++k) {
        const bool k0 = k == 0 && row0_lane;
        Row x[G][C], y[G][C];
#pragma unroll
        for (int g = 0; g < G; ++g)
#pragma unroll
            for (int c = 0; c < C; ++c) x[g][c] = epg::lane_row(s[g][c], k);
        mix_stage<C, G>(mA, dens, k0, x, y);
        if (k == 0 && echo != nullptr) {
#pragma unroll
            for (int g = 0; g < G; ++g)
#pragma unroll
                for (int c = 0; c < C; ++c) {
                    float eR = y[g][c].AR, eI = y[g][c].AI;
                    if (adcph) epg::cmul(pc, ps, eR, eI, eR, eI);
                    echo[(g * C + c) * A] = eR;
                    echo[(pl + g * C + c) * A] = eI;
                }
        }
        mix_stage<C, G>(mB, dens, k0, y, x);
#pragma unroll
        for (int g = 0; g < G; ++g)
#pragma unroll
            for (int c = 0; c < C; ++c) epg::lane_put(s[g][c], k, x[g][c]);
    }
}

// C compartments, G groups, R rows per lane; SHARED: the coefficient
// table in shared memory (else read from device memory).  Dynamic shared
// memory: the coefficient table (SHARED: A records of S = NQ | 1 floats,
// NQ = nmat G 3 C C + C G: entry m's groups' (mT re, mT im, mL), then the
// densities), the chunk's stage table (kTab floats per compartment -- cos
// phi, sin phi, cos 2phi, sin 2phi, the four saturation factors, the flip,
// the flags as int bits -- then kStage per stage: the output row (-1:
// none) and the shift
// direction, mia and mib as int bits, b1u, cos and sin of the ADC phase)
// and the staged echoes (2, T G C, A).
template <int C, int G, int R, bool SHARED>
__global__ void __launch_bounds__(kMaxWarps* epg::kWarp,
                                  kMinBlocks<C, G, R, SHARED>)
    xcomp_jac_kernel(const XcompJacArgs p) {
    extern __shared__ float smem[];
    constexpr int M3 = 3 * C * C;   // floats of one table entry
    constexpr int GC = G * C;
    constexpr int TS = kTab * C + kStage;   // stage-table floats per stage
    const int nmat = p.nmat;
    const int NQ = nmat * G * M3 + GC;
    const int S = SHARED ? (NQ | 1) : 0;   // floats per ladder's record
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
    float* const stage = tab + TS * T;
    const int TGC = T * GC;   // floats per staged output plane and atom
    const size_t mat = static_cast<size_t>(M3) * p.B;

    if constexpr (SHARED) {
        // the coefficient table, read in runs of consecutive atoms; the
        // first chunk's barrier publishes it
        for (int e = threadIdx.x; e < NQ * A; e += blockDim.x) {
            const int qr = e / A;
            const int a = e - qr * A;
            const int at = min(atom0 + a, p.B - 1);
            int off = qr;   // the densities keep their row
            float v;
            if (qr < nmat * G * M3) {
                const int g = qr / (nmat * M3);
                const int rest = qr - g * nmat * M3;
                const int m = rest / M3;
                off = (m * G + g) * M3 + (rest - m * M3);
                v = p.table[static_cast<size_t>(qr) * p.B + at];
            } else {
                v = p.dens[static_cast<size_t>(qr - nmat * G * M3) * p.B
                           + at];
            }
            ctab[a * S + off] = v;
        }
    }
    const float* const rec = ctab + slot * S;   // this lane's ladder
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

    const size_t plane = static_cast<size_t>(p.nadc) * GC * p.B;
    for (int i0 = 0; i0 < p.N; i0 += T) {
        const int n = min(T, p.N - i0);
        for (int e = threadIdx.x; e < n * C; e += blockDim.x) {
            const int qi = i0 * C + e;   // (stage, compartment) of the chunk
            const int t = e / C;
            float* const te = tab + TS * t + kTab * (e - t * C);
            const float ph = p.phi[qi] * (1.0f / 180.0f);
            sincospif(ph, &te[1], &te[0]);
            sincospif(2.0f * ph, &te[3], &te[2]);
            if (p.use_sat) {
                te[4] = p.sfr[qi];
                te[5] = p.sfi[qi];
                te[6] = p.szr[qi];
                te[7] = p.szi[qi];
            }
            te[8] = p.alpha[qi];
            te[kXFlags] = epg::xflags(te, p.use_sat != 0);
        }
        for (int t = threadIdx.x; t < n; t += blockDim.x) {
            const int i = i0 + t;
            float* const ts = tab + TS * t + kTab * C;
            const int idx = p.adci[i];
            int dir = p.shift[i];
            if (!((dir > 0 && p.use_up) || (dir < 0 && p.use_down))) dir = 0;
            ts[0] = __int_as_float(idx >= 0 && idx < p.nadc ? idx : -1);
            ts[1] = __int_as_float(dir);
            ts[2] = __int_as_float(p.mia[i]);
            ts[3] = __int_as_float(p.mib[i]);
            ts[4] = p.use_b1u ? p.b1u[i] : 1.0f;
            if (p.use_adcph) {
                sincospif(p.aph[i] * kInvPi, &ts[6], &ts[5]);
            } else {
                ts[5] = 1.0f;
                ts[6] = 0.0f;
            }
        }
        __syncthreads();
        for (int t0 = 0; t0 < n; t0 += W) {
            const int nu = min(W, n - t0);
            // this lane's flips of stage t0 + r, broadcast below
            float msa[C], mca[C];
            {
                const float* const mine = tab + TS * (t0 + min(q.r, nu - 1));
                const float eff = p.use_b1u
                                      ? 1.0f + mine[kTab * C + 4] * (B1 - 1.0f)
                                      : B1;
#pragma unroll
                for (int c = 0; c < C; ++c)
                    sincospif(mine[kTab * c + 8] * eff * (1.0f / 180.0f),
                              &msa[c], &mca[c]);
            }
            for (int u = 0; u < nu; ++u) {
                const int t = t0 + u;
                const float* const tr = tab + TS * t;
                const float* const ts = tr + kTab * C;
                epg::Rot r[C];
#pragma unroll
                for (int c = 0; c < C; ++c) {
                    const float* const te = tr + kTab * c;
                    if (__float_as_int(te[kXFlags]) & kXRotate)
                        r[c] = epg::rot_coeffs_sc(
                            epg::seg_bcast(q, msa[c], u),
                            epg::seg_bcast(q, mca[c], u), te[0], te[1],
                            te[2], te[3]);
                }
                const bool readout = __float_as_int(ts[0]) >= 0;
                float* const echo = readout && writer
                                        ? stage + (t * GC) * A + slot
                                        : nullptr;
                const int ma = __float_as_int(ts[2]);
                const int mb = __float_as_int(ts[3]);
                if constexpr (SHARED) {
                    epg::SharedXMix<C> mA[G], mB[G];
                    epg::SharedCol dens[G];
                    const float* const ra = rec + ma * (G * M3);
                    const float* const rb = rec + mb * (G * M3);
#pragma unroll
                    for (int g = 0; g < G; ++g) {
                        mA[g] = epg::shared_xmix<C>(ra + g * M3);
                        mB[g] = epg::shared_xmix<C>(rb + g * M3);
                        dens[g] = epg::SharedCol{rec + nmat * G * M3 + g * C};
                    }
                    stage_rows<C, G, R>(s, r, tr, mA, mB, dens, q.r == 0,
                                        echo, A, TGC, ts[5], ts[6],
                                        p.use_adcph != 0);
                } else {
                    GlobalXMix<C> mA[G], mB[G];
                    GlobalCol dens[G];
                    const size_t part = static_cast<size_t>(C * C) * p.B;
#pragma unroll
                    for (int g = 0; g < G; ++g) {
                        const float* const tg =
                            p.table + static_cast<size_t>(g) * nmat * mat + b;
                        const float* const pa = tg + ma * mat;
                        const float* const pb = tg + mb * mat;
                        mA[g] = GlobalXMix<C>{GlobalCol{pa, p.B},
                                              GlobalCol{pa + part, p.B},
                                              GlobalCol{pa + 2 * part, p.B}};
                        mB[g] = GlobalXMix<C>{GlobalCol{pb, p.B},
                                              GlobalCol{pb + part, p.B},
                                              GlobalCol{pb + 2 * part, p.B}};
                        dens[g] = GlobalCol{
                            p.dens + static_cast<size_t>(g * C) * p.B + b,
                            p.B};
                    }
                    stage_rows<C, G, R>(s, r, tr, mA, mB, dens, q.r == 0,
                                        echo, A, TGC, ts[5], ts[6],
                                        p.use_adcph != 0);
                }
                const int dir = __float_as_int(ts[1]);
                if (dir > 0) {
#pragma unroll
                    for (int g = 0; g < G; ++g)
#pragma unroll
                        for (int c = 0; c < C; ++c)
                            epg::seg_shift_blocked(q, s[g][c]);
                } else if (dir < 0) {
#pragma unroll
                    for (int g = 0; g < G; ++g)
#pragma unroll
                        for (int c = 0; c < C; ++c)
                            epg::seg_shift_blocked_down(q, s[g][c]);
                }
            }
        }
        __syncthreads();
        // staged row t = stage t / GC's (g, c) = t % GC goes to output row
        // adci GC + t % GC, or nowhere
        const auto row_of = [=](int t) {
            const int ts = t / GC;
            const int idx = __float_as_int(tab[TS * ts + kTab * C]);
            return idx < 0 ? -1 : idx * GC + (t - ts * GC);
        };
        epg::flush_stage_rows(stage, p.out, 2, TGC, n * GC, A, plane,
                              row_of, p.B, atom0);
        __syncthreads();   // the flush's table reads are done
    }
}

template <int C, int G, int R, bool SHARED>
int launch(XcompJacArgs a, int warps, cudaStream_t stream) {
    constexpr int TS = kTab * C + kStage;
    const int NQ = a.nmat * G * 3 * C * C + C * G;
    const int S = SHARED ? (NQ | 1) : 0;
    const int W = (a.H + R - 1) / R;
    const int A = warps * (epg::kWarp / W);
    const int per = TS + 2 * G * C * A;   // floats per stage
    if (S * A + a.T * per > kChunkFloats)
        return static_cast<int>(cudaErrorInvalidValue);
    const size_t smem =
        sizeof(float) * (static_cast<size_t>(S) * A
                         + static_cast<size_t>(a.T) * per);
    const int grid = (a.B + A - 1) / A;
    xcomp_jac_kernel<C, G, R, SHARED>
        <<<grid, warps * epg::kWarp, smem, stream>>>(a);
    return static_cast<int>(cudaGetLastError());
}

template <int C, int G, int R>
int launch_m(const XcompJacArgs& a, bool shared, int warps,
             cudaStream_t st) {
    return shared ? launch<C, G, R, true>(a, warps, st)
                  : launch<C, G, R, false>(a, warps, st);
}

// R = 1 .. max_rows(C G) rows per lane
template <int C, int G, int R = 1>
int launch_r(const XcompJacArgs& a, int rows, bool shared, int warps,
             cudaStream_t st) {
    if constexpr (R > max_rows(C * G)) {
        return static_cast<int>(cudaErrorInvalidValue);
    } else {
        if (rows == R) return launch_m<C, G, R>(a, shared, warps, st);
        return launch_r<C, G, R + 1>(a, rows, shared, warps, st);
    }
}

// G = 2..5 groups with C G <= 12 (at most 72 planes): instances beyond
// are refused
template <int C>
int launch_g(const XcompJacArgs& a, int G, int R, bool shared, int warps,
             cudaStream_t st) {
    if (C * G > 12) return static_cast<int>(cudaErrorInvalidValue);
    switch (G) {
        case 2: return launch_r<C, 2>(a, R, shared, warps, st);
        case 3: return launch_r<C, (C <= 4 ? 3 : 2)>(a, R, shared, warps, st);
        case 4: return launch_r<C, (C <= 3 ? 4 : 2)>(a, R, shared, warps, st);
        case 5: return launch_r<C, (C <= 2 ? 5 : 2)>(a, R, shared, warps, st);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

}  // namespace

// Launch on `stream` of CUDA device `device`; allocates nothing.  Returns
// the CUDA error code of the launch (0 on success; cudaErrorInvalidValue
// for C outside 1..4, G outside 2..5, C G > 12, R outside 1..max_rows(C G),
// W = ceil(H / R) lanes beyond a warp, `block` outside 1..4 warps, `stages`
// outside 1..32, or a block whose tables and staged echoes pass 48 KB);
// the caller raises on anything else.  `R` rows per lane, `block` warps
// per block, `stages` per chunk and `shared` (the coefficient table in
// shared memory, else read from device memory) come from
// cuda_xcomposite.xcomp_jac_geometry.
extern "C" int epg_xcomposite_jac(const float* alpha, const float* phi,
                                  const float* sfr, const float* sfi,
                                  const float* szr, const float* szi,
                                  const int* adci, const int* shift,
                                  const float* aph, const int* mia,
                                  const int* mib, const float* b1u,
                                  const float* dens, const float* b1,
                                  const float* table, float* out, int N,
                                  int C, int G, int B, int nadc, int nmat,
                                  int nstate, int use_up, int use_down,
                                  int use_adcph, int use_sat, int use_b1u,
                                  int R, int block, int stages, int shared,
                                  int device, void* stream) {
    XcompJacArgs a{alpha, phi, sfr, sfi, szr, szi, adci, shift, aph, mia,
                   mib, b1u, dens, b1, table, out, N, B, nstate + 1, nadc,
                   nmat, use_up, use_down, use_adcph, use_sat, use_b1u,
                   stages};
    const cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (block < 1 || block > kMaxWarps || R < 1
        || (a.H + R - 1) / R > epg::kWarp || stages < 1
        || stages > kMaxStages || nmat < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const bool sh = shared != 0;
    switch (C) {
        case 1: return launch_g<1>(a, G, R, sh, block, st);
        case 2: return launch_g<2>(a, G, R, sh, block, st);
        case 3: return launch_g<3>(a, G, R, sh, block, st);
        case 4: return launch_g<4>(a, G, R, sh, block, st);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}
