// xcomposite.cu -- composite EPG-X stage trains over C exchanging
// compartments: MT-prepared segmented GRE, IR-MT, saturation-recovery MT.
//
// Replaces the TPU kernel epgpy_tpu/models/pallas_xcomposite.py:
// _kernel_xcomp (:51), driven there by xcomposite_pallas (:147); the Python
// wrapper is epgpy_torch/models/cuda_xcomposite.py:xcomposite_cuda and the
// plain PyTorch twin beside it (xcomposite_plain) computes the same
// recurrence with the same operation order.
//
// What it computes, per atom, over N stages [R(sat)?, T?, X(ta)*, ADC?,
// X(tb)*, S(+-1)?] described by per-stage tables (flips and phases per
// compartment, saturation factors, the output row adci or -1, the shift
// direction, the ADC phase, the B1 sensitivity b1u and the indices mia,
// mib of the pre- and post-readout exchange matrices): xgre.cu's 6C planes
// from Z(0) = 1.  Per stage: saturation (when any stage has one), the
// rotation by alpha_ic (1 + b1u (B1 - 1)) (b1u = 0: an adiabatic pulse)
// about phi_ic, then row by row the mix with table entry mia, the readout
// of each compartment's F+(0) (phased by the ADC phase) to row adci, the
// mix with entry mib and the stage's shift (up, down or none).  The table
// holds one set of per-atom matrices per distinct accumulated tau; entry 0
// is the identity.  Output planes (2, nadc, C, B).
//
// What bounds it on the card: the operations -- per atom per stage and
// row, C rotations and saturations and two C x C complex mixes; at the
// MT-prepared main shape (C = 2, nstate 8, 131,072 atoms x 108 stages)
// ~3.6e10 as the twin counts them, fewer of the kernel's own work (the
// identity entry's mixes, the unflipped bound pool's rotations and the
// free pool's unit saturations skipped), against 2 x 100 x 2 x 131,072 x
// 4 bytes out.  The design is xgre.cu's (epg_planes.cuh's segmented layout
// with blocked rows, every compartment of a row on one lane, R rows per
// lane from Python, cuda_xcomposite.xcomp_geometry; a ladder that fits one
// lane takes the instance of its own length) with xcomposite_jac.cu's
// stages: a stage is one step of R rows on every lane (epg::xstage_rows)
// and then its shift, whose direction is the same for every atom (a
// warp-uniform branch): up by epg::seg_shift_blocked, down by
// epg::seg_shift_blocked_down, or none.  Every table entry of a ladder
// (nmat 3 C^2 floats, constant over the train) is loaded once, before the
// stage loop, into a per-block shared table, one record per ladder at an
// odd stride; a stage loads its two entries into registers where they fit
// beside the state (6 C R + 6 C^2 within 84 floats: R = 5 on 2 lanes at
// the main shape), else the mixes read them in place; where one warp's
// records do not fit in the block's 48 KB (many distinct taus at many
// pools), the kernel's second mode has the mixes read the stage's two
// entries in place from device memory instead, as xcomposite_jac.cu's does
// (`SHARED`; the geometry chooses the mode by shape).  A mix
// with entry 0 is skipped when that entry is the identity for every atom
// of the warp (the test runs once, before the stage loop; the entry is the
// same for every atom, so the branch is warp-uniform).  The
// atom-independent terms of a chunk of up to 32 stages (the RF phase's
// sin/cos, the saturation factors, the flips and their flags, the output
// row, shift direction, table entries, B1 sensitivity and the ADC phase's
// sin/cos) sit in a table the block fills between two barriers; each lane
// computes the atom's own sincos(alpha eff) of a compartment it rotates
// (xgre.cu's).  The row-0 lane stages the readout stages' echoes in shared
// memory, and after the chunk the block copies them to their output rows
// as runs of consecutive atoms (epg::flush_stage_rows, which reads the
// chunk's table: a barrier follows it).  4-warp blocks, halved while the
// coefficient table does not fit, held at 128 registers in the shared
// mode; a segment past the last atom runs on a clamped atom and stores
// nothing.  Math is precise (no fast-math); sincospif of the angles in
// half turns.
#include <cuda_runtime.h>

#include "epg_planes.cuh"

namespace {

constexpr float kInvPi = 0.3183098861837907f;   // 1 / pi

// warps per block at most, stages per chunk at most, floats of a block's
// coefficient table, stage table and staged echoes (48 KB), stage-table
// floats per stage beside epg::kXTab per compartment; mirrored by
// cuda_fisp.SEG_WARPS, SEG_PULSES, SEG_CHUNK_FLOATS and
// cuda_xcomposite.XCOMP_STAGE
constexpr int kMaxWarps = 4;
constexpr int kMaxStages = 32;
constexpr int kChunkFloats = 12288;
constexpr int kStage = 7;

// The most rows per lane of a C-compartment instance: 6 C R <= 72 floats
// of state (cuda_xgre.X_STATE).
constexpr int max_rows(int C) { return 12 / C; }

struct XcompArgs {
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
    const float* dens;   // (C,) equilibrium densities
    const float* b1;     // (B,) flip scale
    const float* table;  // (nmat, 3 C C, B) stage matrices
    float* out;          // (2, nadc, C, B): re, im
    int N, B, H, nadc, nmat;
    int use_up, use_down, use_adcph, use_sat, use_b1u;
    int T;               // stages per chunk
};

// Table entry m of atom b read in place from device memory.
template <int C>
__device__ __forceinline__ epg::GlobalXMix<C> global_entry(const XcompArgs& p,
                                                           int m, int b) {
    const size_t part = static_cast<size_t>(C * C) * p.B;
    const float* const pm = p.table + m * 3 * part + b;
    return epg::GlobalXMix<C>{epg::GlobalCol{pm, p.B},
                              epg::GlobalCol{pm + part, p.B},
                              epg::GlobalCol{pm + 2 * part, p.B}};
}

// C compartments, R rows per lane; ONE: a ladder of exactly R rows on one
// lane (H = R, W = 1); SHARED: the coefficient table in shared memory
// (else read from device memory).  Dynamic shared memory: the coefficient
// table (SHARED: A records of S = nmat 3 C C | 1 floats, entry m's mT re,
// mT im, mL at m 3 C C), the chunk's stage table (epg::kXTab floats per
// compartment, then kStage per stage: the output row (-1: none) and the
// shift direction, mia and mib as int bits, b1u, cos and sin of the ADC
// phase) and the staged echoes (2, T C, A).
template <int C, int R, bool ONE, bool SHARED>
__global__ void __launch_bounds__(kMaxWarps* epg::kWarp, SHARED ? 4 : 1)
    xcomp_kernel(const XcompArgs p) {
    extern __shared__ float smem[];
    constexpr bool REG = epg::kXmixInRegisters<C, R>;
    constexpr int M3 = 3 * C * C;   // floats of one table entry
    constexpr int TS = epg::kXTab * C + kStage;   // table floats per stage
    const int S = SHARED ? ((p.nmat * M3) | 1) : 0;   // floats per record
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
    float* const stage = tab + TS * T;
    const int TC = T * C;   // floats per staged output plane and atom
    const float* const rec = ctab + slot * S;   // this lane's ladder

    bool id0;   // entry 0 is the identity for this lane's atom
    if constexpr (SHARED) {
        // every table entry, read in runs of consecutive atoms
        for (int e = threadIdx.x; e < p.nmat * M3 * A; e += blockDim.x) {
            const int qr = e / A;
            const int a = e - qr * A;
            ctab[a * S + qr] = p.table[static_cast<size_t>(qr) * p.B
                                       + min(atom0 + a, p.B - 1)];
        }
        __syncthreads();
        id0 = epg::xmix_identity<C>(epg::shared_xmix<C>(rec));
    } else {
        id0 = epg::xmix_identity<C>(global_entry<C>(p, 0, b));
    }
    const bool skip0 = __all_sync(epg::kFullMask, id0);
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

    const size_t plane = static_cast<size_t>(p.nadc) * C * p.B;
    for (int i0 = 0; i0 < p.N; i0 += T) {
        const int n = min(T, p.N - i0);
        for (int e = threadIdx.x; e < n * C; e += blockDim.x) {
            const int qi = i0 * C + e;   // (stage, compartment) of the chunk
            const int t = e / C;
            float* const te = tab + TS * t + epg::kXTab * (e - t * C);
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
            te[epg::kXFlags] = epg::xflags(te, p.use_sat != 0);
        }
        for (int t = threadIdx.x; t < n; t += blockDim.x) {
            const int i = i0 + t;
            float* const ts = tab + TS * t + epg::kXTab * C;
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
        for (int t = 0; t < n; ++t) {
            const float* const tr = tab + TS * t;
            const float* const ts = tr + epg::kXTab * C;
            // compartment c's rotation (sincos of the atom's flip),
            // when its rows are rotated
            const auto rot = [&](int c) {
                const float* const te = tr + epg::kXTab * c;
                const float eff =
                    p.use_b1u ? 1.0f + ts[4] * (B1 - 1.0f) : B1;
                float sa, ca;
                sincospif(te[8] * eff * (1.0f / 180.0f), &sa, &ca);
                return epg::rot_coeffs_sc(sa, ca, te[0], te[1], te[2],
                                          te[3]);
            };
            float* const echo = __float_as_int(ts[0]) >= 0 && writer
                                    ? stage + (t * C) * A + slot
                                    : nullptr;
            const int ma = __float_as_int(ts[2]);
            const int mb = __float_as_int(ts[3]);
            const bool skipA = skip0 && ma == 0;
            const bool skipB = skip0 && mb == 0;
            if constexpr (SHARED) {
                epg::xstage_rows<C, R>(
                    s, rot, tr, epg::record_xmix<C, REG>(rec + ma * M3),
                    skipA, epg::record_xmix<C, REG>(rec + mb * M3),
                    skipB, dens, q.r == 0, echo, A, TC, ts[5], ts[6],
                    p.use_adcph != 0);
            } else {
                epg::xstage_rows<C, R>(
                    s, rot, tr, global_entry<C>(p, ma, b), skipA,
                    global_entry<C>(p, mb, b), skipB, dens, q.r == 0,
                    echo, A, TC, ts[5], ts[6], p.use_adcph != 0);
            }
            const int dir = __float_as_int(ts[1]);
            if (dir > 0) {
#pragma unroll
                for (int c = 0; c < C; ++c) {
                    if constexpr (ONE) {
                        if constexpr (R > 1)
                            epg::lane_shift<0, 2, R>(s[c]);
                    } else {
                        epg::seg_shift_blocked(q, s[c]);
                    }
                }
            } else if (dir < 0) {
#pragma unroll
                for (int c = 0; c < C; ++c) {
                    if constexpr (ONE) {
                        if constexpr (R > 1)
                            epg::lane_shift<2, 0, R>(s[c]);
                    } else {
                        epg::seg_shift_blocked_down(q, s[c]);
                    }
                }
            }
        }
        __syncthreads();
        // staged row t = stage t / C's compartment t % C goes to output row
        // adci C + t % C, or nowhere
        const auto row_of = [=](int t) {
            const int st = t / C;
            const int idx = __float_as_int(tab[TS * st + epg::kXTab * C]);
            return idx < 0 ? -1 : idx * C + (t - st * C);
        };
        epg::flush_stage_rows(stage, p.out, 2, TC, n * C, A, plane, row_of,
                              p.B, atom0);
        __syncthreads();   // the flush's table reads are done
    }
}

template <int C, int R, bool ONE, bool SHARED>
int launch(const XcompArgs& a, int warps, cudaStream_t stream) {
    constexpr int TS = epg::kXTab * C + kStage;
    const int S = SHARED ? ((a.nmat * 3 * C * C) | 1) : 0;
    const int W = ONE ? 1 : (a.H + R - 1) / R;
    const int A = warps * (epg::kWarp / W);
    const int per = TS + 2 * C * A;   // floats per stage
    if (S * A + a.T * per > kChunkFloats)
        return static_cast<int>(cudaErrorInvalidValue);
    const size_t smem = sizeof(float) * (static_cast<size_t>(S) * A
                                         + static_cast<size_t>(a.T) * per);
    const int grid = (a.B + A - 1) / A;
    xcomp_kernel<C, R, ONE, SHARED>
        <<<grid, warps * epg::kWarp, smem, stream>>>(a);
    return static_cast<int>(cudaGetLastError());
}

template <int C, int R, bool ONE>
int launch_m(const XcompArgs& a, bool shared, int warps, cudaStream_t st) {
    return shared ? launch<C, R, ONE, true>(a, warps, st)
                  : launch<C, R, ONE, false>(a, warps, st);
}

// R = 1 .. max_rows(C) rows per lane: a ladder of H = R rows takes the
// one-lane instance of its length, any other H the instance of R, which
// exists above max_rows(C) / 2 rows (xgre.cu's launch_r).
template <int C, int R = 1>
int launch_r(const XcompArgs& a, int rows, bool shared, int warps,
             cudaStream_t st) {
    if constexpr (R > max_rows(C)) {
        return static_cast<int>(cudaErrorInvalidValue);
    } else {
        if (rows != R) return launch_r<C, R + 1>(a, rows, shared, warps, st);
        if (a.H == R) return launch_m<C, R, true>(a, shared, warps, st);
        if constexpr (2 * R > max_rows(C))
            return launch_m<C, R, false>(a, shared, warps, st);
        return static_cast<int>(cudaErrorInvalidValue);
    }
}

}  // namespace

// Launch on `stream` of CUDA device `device`; allocates nothing.  Returns
// the CUDA error code of the launch (0 on success; cudaErrorInvalidValue
// for C outside 1..4, R without an instance (launch_r), W = ceil(H / R)
// lanes beyond a warp, `block` outside 1..4 warps, `stages` outside
// 1..32, or a block whose tables and staged echoes pass 48 KB); the caller
// raises on anything else.  `R` rows per lane, `block` warps per block,
// `stages` per chunk and `shared` (the coefficient table in shared memory,
// else read from device memory) come from cuda_xcomposite.xcomp_geometry.
extern "C" int epg_xcomposite(const float* alpha, const float* phi,
                              const float* sfr, const float* sfi,
                              const float* szr, const float* szi,
                              const int* adci, const int* shift,
                              const float* aph, const int* mia,
                              const int* mib, const float* b1u,
                              const float* dens, const float* b1,
                              const float* table, float* out, int N, int C,
                              int B, int nadc, int nmat, int nstate,
                              int use_up, int use_down, int use_adcph,
                              int use_sat, int use_b1u, int R, int block,
                              int stages, int shared, int device,
                              void* stream) {
    XcompArgs a{alpha, phi, sfr, sfi, szr, szi, adci, shift, aph, mia, mib,
                b1u, dens, b1, table, out, N, B, nstate + 1, nadc, nmat,
                use_up, use_down, use_adcph, use_sat, use_b1u, stages};
    const cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (block < 1 || block > kMaxWarps || R < 1
        || (a.H + R - 1) / R > epg::kWarp || stages < 1
        || stages > kMaxStages || nmat < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const bool sh = shared != 0;
    switch (C) {
        case 1: return launch_r<1>(a, R, sh, block, st);
        case 2: return launch_r<2>(a, R, sh, block, st);
        case 3: return launch_r<3>(a, R, sh, block, st);
        case 4: return launch_r<4>(a, R, sh, block, st);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}
