// composite.cu -- composite-GRE stage trains: MPRAGE, cardiac MRF with IR
// and T2prep preps, saturation recovery, DW-prepared trains.
//
// Replaces the TPU kernel epgpy_tpu/models/pallas_composite.py:_kernel_comp
// (:69, with its helper _datten :41), driven there by composite_pallas
// (:274); the Python wrapper is epgpy_torch/models/cuda_composite.py:
// composite_cuda and the plain PyTorch twin beside it (composite_plain)
// computes the same recurrence with the same operation order.
//
// What it computes, per atom (T1, T2, B1, df, Dc), over N stages
// [T?, E*, Adc?, E*, S(+-1)?, D?] described by ten per-stage tables (flip,
// phase, relaxation before and after the readout ta and tb, the output row
// adci or -1, the shift direction, the ADC phase, the B1 sensitivity b1u,
// the b-value base btd and the ramp direction rdir): the folded half-ladder
// of fisp_half.cu (six planes A/B/Z re+im of H = nstate + 1 rows from
// Z(0) = 1).  Per stage: every row is rotated once by a = fa (1 + b1u
// (B1 - 1)) (b1u = 0: an adiabatic pulse, the same angle for every atom);
// the echo is the rotated k = 0 row decayed over ta and phased by the df
// and ADC phasors, written to output row adci; the rows relax over ta + tb
// with the recovery at k = 0 (k-independent relaxation commutes with the
// readout); the ladder shifts up, down or not at all; a D stage closes with
// its attenuation by destination row.  Output planes (2, nadc, B): the
// engine's layout, with no reorder pass.
//
// What bounds it on the card: instruction issue.  Per atom per stage the
// rotation and relaxation of H rows (~36 FP32 operations each) plus a few
// transcendentals; at nstate 10, 128k atoms x 275 stages ~2.4e10
// operations against 2 x 256 x 128k x 4 bytes out.  The design is
// fisp_half.cu's: epg_planes.cuh's segmented layout with blocked rows, a
// ladder in a segment of W = ceil(H / R) lanes, L = 32 / W ladders per
// warp, lane r holding rows r R + c, c < R, of the six planes in
// registers (R chosen in Python, cuda_composite.comp_geometry).  A ladder
// of up to 12 rows sits on one lane and takes the instance of its own
// length (both main paths: nstate 10 and MPRAGE's 8), held at 128
// registers; the shift's direction is uniform across the warp per stage:
// up, down or none -- register moves on one lane, else
// epg::seg_shift_blocked / epg::seg_shift_blocked_down.
// The block copies a chunk of up to 32 stages of the tables into shared
// memory between two barriers, with what is the same for every atom
// computed there once: cos/sin of phi and 2 phi, the ADC phase's cos/sin,
// the output row, the shift direction the flags admit, and whether ta and
// tb repeat the previous stage's.  The atom's own terms of stage t0 + j --
// sincos of the B1-scaled flip, the four relaxation exponentials, the df
// phasors over ta and ta + tb -- are computed by lane j of the segment and
// broadcast by shuffles when the stage runs; where every stage of a group
// of W repeats its predecessor's ta and tb (a warp-uniform vote), the
// relaxation terms are kept from the previous group.  A D stage (btd != 0)
// attenuates each lane's rows by epg::stage_att, computed per row since
// btd changes from stage to stage.  The row-0 lane stages a readout
// stage's echo in shared memory, and after the chunk the block writes each
// to the output row adci names as runs of consecutive atoms
// (epg::flush_stage_rows).  4-warp blocks; a segment past the last atom
// runs on a clamped atom and stores nothing.  Math is precise (no
// fast-math); sincospif of the angles in half turns.
#include <cuda_runtime.h>

#include "epg_planes.cuh"

namespace {

constexpr float kInvPi = 0.3183098861837907f;   // 1 / pi

// warps per block at most, stages per chunk at most, floats of one chunk's
// table and staged echoes (48 KB), table floats per stage, rows per lane
// at most; mirrored by cuda_fisp.SEG_WARPS, SEG_PULSES, SEG_CHUNK_FLOATS,
// cuda_composite.COMP_TABLE and COMP_MAX_ROWS
constexpr int kMaxWarps = 4;
constexpr int kMaxStages = 32;
constexpr int kChunkFloats = 12288;
constexpr int kTab = 16;
constexpr int kMaxRows = 12;

struct CompArgs {
    const float* fa;    // (N,) flip angles, degrees
    const float* phi;   // (N,) RF phases, degrees
    const float* ta;    // (N,) relaxation before the readout, ms
    const float* tb;    // (N,) relaxation after the readout, ms
    const int* adci;    // (N,) output row, -1 = no readout
    const int* shift;   // (N,) shift direction in {-1, 0, +1}
    const float* aph;   // (N,) ADC phase, radians (use_adcph)
    const float* b1u;   // (N,) B1 sensitivity (use_b1u)
    const float* btd;   // (N,) b-value base per squared state index (use_d)
    const float* rdir;  // (N,) ramp direction in {-1, 0, +1} (use_d)
    const float* t1;    // (B,)
    const float* t2;    // (B,)
    const float* b1;    // (B,)
    const float* df;    // (B,) off-resonance, kHz (use_df) or unused
    const float* dc;    // (B,) diffusivity, mm^2/s (use_d) or unused
    float* out;         // (2, nadc, B): re, im
    int N, B, H, nadc;
    int use_df, use_up, use_down, use_adcph, use_b1u, use_d;
    int T;              // stages per chunk
};

struct Atom {
    float T1, T2, B1, DF;
};

// An atom's relaxation terms of one stage: the echo's decay over ta and
// its df phasor, the F decay over ta + tb (with its df phasor), the Z
// decay and the k = 0 recovery.
struct Relax {
    float e2a, pc, ps, cFr, cFi, cZ, rec;
};

// The relaxation terms of a stage of relaxation times ta and tb.
__device__ __forceinline__ Relax relax_terms(bool cdf, float ta, float tb,
                                             const Atom& at) {
    Relax o;
    const float e1a = expf(-ta / at.T1);
    const float e1b = expf(-tb / at.T1);
    o.e2a = expf(-ta / at.T2);
    const float cF = o.e2a * expf(-tb / at.T2);
    o.cZ = e1a * e1b;
    o.rec = 1.0f - o.cZ;
    o.cFr = cF;
    o.cFi = 0.0f;
    o.pc = 1.0f;
    o.ps = 0.0f;
    if (cdf) {
        float pI, pR;
        sincospif(2.0f * at.DF * (ta + tb), &pI, &pR);
        o.cFr = cF * pR;
        o.cFi = cF * pI;
        sincospif(2.0f * at.DF * ta, &o.ps, &o.pc);
    }
    return o;
}

// Lane u of the lane's segment hands it v (a segment of one lane keeps its
// own).
__device__ __forceinline__ float bcast1(const epg::SegLane& q, float v,
                                        int u) {
    return q.W == 1 ? v : epg::seg_bcast(q, v, u);
}

// Lane u of the segment hands its relaxation terms to the whole segment.
__device__ __forceinline__ Relax bcast(const epg::SegLane& q, const Relax& m,
                                       int u, bool cdf) {
    Relax o = m;
    o.e2a = bcast1(q, m.e2a, u);
    o.cFr = bcast1(q, m.cFr, u);
    o.cZ = bcast1(q, m.cZ, u);
    o.rec = bcast1(q, m.rec, u);
    if (cdf) {
        o.cFi = bcast1(q, m.cFi, u);
        o.pc = bcast1(q, m.pc, u);
        o.ps = bcast1(q, m.ps, u);
    }
    return o;
}

// The stage's folded shift of a lane's rows: up (dir > 0), down (dir < 0)
// or none -- epg::seg_shift_blocked / epg::seg_shift_blocked_down, or
// epg::lane_shift for a ladder of a static HS rows on one lane (HS = 1
// never shifts: the wrapper refuses shifting trains at nstate 0).
template <int R, int HS>
__device__ __forceinline__ void shift(const epg::SegLane& q, int dir,
                                      float (&s)[6][R]) {
    if constexpr (HS > 1) {
        if (dir > 0) {
            epg::lane_shift<0, 2, HS>(s);
        } else if (dir < 0) {
            epg::lane_shift<2, 0, HS>(s);
        }
    } else if constexpr (HS == 0) {
        if (dir > 0) {
            epg::seg_shift_blocked(q, s);
        } else if (dir < 0) {
            epg::seg_shift_blocked_down(q, s);
        }
    }
}

// The stage train on the lane's rows: R rows per lane of a ladder of p.H
// rows (HS = 0) or of a static HS rows on one lane; DFM: the off-resonance
// terms off (0), on (1) or as p.use_df says (2).  smem: the chunk's table
// (4 float4 per stage: cos phi, sin phi, cos 2phi, sin 2phi; fa, ta, tb,
// b1u; cos aph, sin aph, btd, rdir; adci and the shift as int bits,
// repeats, -), then the staged echoes (2, T, A) of the block's A atoms.
template <int R, int HS, int DFM>
__device__ __forceinline__ void comp_run(const CompArgs& p, float4* smem) {
    constexpr int NR = HS > 0 ? HS : R;   // rows a lane steps
    const int T = p.T;
    float4* tab = smem;
    float* stage = reinterpret_cast<float*>(smem + 4 * T);
    const int H = HS > 0 ? HS : p.H;
    const int W = HS > 0 ? 1 : (H + R - 1) / R;   // lanes per ladder
    const int L = epg::kWarp / W;
    const epg::SegLane q =
        epg::seg_lane(threadIdx.x & (epg::kWarp - 1), W, H);
    const int seg = q.base / W;
    const int A = static_cast<int>(blockDim.x / epg::kWarp) * L;
    const int slot = static_cast<int>(threadIdx.x / epg::kWarp) * L + seg;
    const int atom0 = blockIdx.x * A;
    const bool writer = q.r == 0 && seg < L;   // the segment's row-0 lane
    const int b = min(atom0 + slot, p.B - 1);  // clamped past the last atom
    const bool cdf = DFM == 2 ? p.use_df != 0 : DFM == 1;
    const bool phased = cdf || p.use_adcph;
    const int TA = T * A;   // floats per staged output plane

    Atom at;
    at.T1 = p.t1[b];
    at.T2 = p.t2[b];
    at.B1 = p.b1[b];
    at.DF = cdf ? p.df[b] : 0.0f;
    const float Dc = p.use_d ? p.dc[b] : 0.0f;

    float s[6][R];   // s[j][c]: plane j, row r R + c
#pragma unroll
    for (int j = 0; j < 6; ++j)
#pragma unroll
        for (int c = 0; c < R; ++c) s[j][c] = 0.0f;
    if (q.r == 0) s[4][0] = 1.0f;

    Relax rx{};   // the relaxation terms of the stage that runs
    const size_t plane = static_cast<size_t>(p.nadc) * p.B;
    for (int i0 = 0; i0 < p.N; i0 += T) {
        const int n = min(T, p.N - i0);
        for (int t = threadIdx.x; t < n; t += blockDim.x) {
            const int i = i0 + t;
            const float ph = p.phi[i] * (1.0f / 180.0f);
            float sp, cp, s2p, c2p, as = 0.0f, ac = 1.0f;
            sincospif(ph, &sp, &cp);
            sincospif(2.0f * ph, &s2p, &c2p);
            if (p.use_adcph) sincospif(p.aph[i] * kInvPi, &as, &ac);
            int dir = p.shift[i];
            if (!((dir > 0 && p.use_up) || (dir < 0 && p.use_down))) dir = 0;
            const int idx = p.adci[i];
            const float tai = p.ta[i], tbi = p.tb[i];
            const bool repeats =
                i > 0 && tai == p.ta[i - 1] && tbi == p.tb[i - 1];
            tab[4 * t] = make_float4(cp, sp, c2p, s2p);
            tab[4 * t + 1] = make_float4(p.fa[i], tai, tbi,
                                         p.use_b1u ? p.b1u[i] : 1.0f);
            tab[4 * t + 2] = make_float4(ac, as, p.use_d ? p.btd[i] : 0.0f,
                                         p.use_d ? p.rdir[i] : 0.0f);
            tab[4 * t + 3] = make_float4(
                __int_as_float(idx >= 0 && idx < p.nadc ? idx : -1),
                __int_as_float(dir), repeats ? 1.0f : 0.0f, 0.0f);
        }
        __syncthreads();
#pragma unroll 1
        for (int t0 = 0; t0 < n; t0 += W) {
            const int nu = min(W, n - t0);
            // this lane's atom terms of stage t0 + r, broadcast below
            const int tm = t0 + min(q.r, nu - 1);
            const float4 mv = tab[4 * tm + 1];   // fa, ta, tb, b1u
            const float a = p.use_b1u ? mv.x * (1.0f + mv.w * (at.B1 - 1.0f))
                                      : mv.x * at.B1;
            float msa, mca;
            sincospif(a * (1.0f / 180.0f), &msa, &mca);
            // every stage of the group repeats its predecessor's ta and tb:
            // the terms of the last stage run stand
            const bool held =
                __all_sync(epg::kFullMask, tab[4 * tm + 3].z != 0.0f);
            Relax mine = rx;
            if (!held) mine = relax_terms(cdf, mv.y, mv.z, at);
#pragma unroll 1
            for (int u = 0; u < nu; ++u) {
                const int t = t0 + u;
                if (!held) rx = bcast(q, mine, u, cdf);
                const float4 ph = tab[4 * t];   // cp, sp, c2p, s2p
                const float4 v3 = tab[4 * t + 3];
                const int idx = __float_as_int(v3.x);
                const int dir = __float_as_int(v3.y);
                const epg::Rot r = epg::rot_coeffs_sc(
                    bcast1(q, msa, u), bcast1(q, mca, u), ph.x, ph.y, ph.z,
                    ph.w);
                float* const est = stage + t * A + slot;
#pragma unroll
                for (int c = 0; c < NR; ++c) {
                    const epg::Row y = epg::rotate(
                        r, epg::Row{s[0][c], s[1][c], s[2][c], s[3][c],
                                    s[4][c], s[5][c]});
                    if (c == 0 && writer && idx >= 0) {
                        // the echo: decay over ta, then the df phasor and
                        // the ADC phase
                        float eR = rx.e2a * y.AR, eI = rx.e2a * y.AI;
                        if (phased) {
                            float pc = rx.pc, ps = rx.ps;
                            if (p.use_adcph) {
                                const float4 v2 = tab[4 * t + 2];
                                if (cdf) {
                                    epg::cmul(pc, ps, v2.x, v2.y, pc, ps);
                                } else {
                                    pc = v2.x;
                                    ps = v2.y;
                                }
                            }
                            epg::cmul(pc, ps, eR, eI, eR, eI);
                        }
                        est[0] = eR;
                        est[TA] = eI;
                    }
                    epg::fdecay(cdf, rx.cFr, rx.cFi, y.AR, y.AI, s[0][c],
                                s[1][c]);
                    epg::fdecay(cdf, rx.cFr, rx.cFi, y.BR, y.BI, s[2][c],
                                s[3][c]);
                    float nZR = rx.cZ * y.ZR;
                    if (c == 0 && q.r == 0) nZR = nZR + rx.rec;
                    s[4][c] = nZR;
                    s[5][c] = rx.cZ * y.ZI;
                }
                shift<R, HS>(q, dir, s);
                if (p.use_d) {
                    const float4 v2 = tab[4 * t + 2];   // -, -, btd, rdir
                    if (v2.z != 0.0f) {   // a stage without D: every factor is 1
#pragma unroll
                        for (int c = 0; c < NR; ++c) {
                            const epg::StageAtt f =
                                epg::stage_att(q.r * R + c, v2.z, v2.w, Dc);
                            s[0][c] *= f.aA;
                            s[1][c] *= f.aA;
                            s[2][c] *= f.aB;
                            s[3][c] *= f.aB;
                            s[4][c] *= f.aZ;
                            s[5][c] *= f.aZ;
                        }
                    }
                }
            }
        }
        __syncthreads();
        // each readout stage's staged echo to its own output row (adci is a
        // permutation, not increasing)
        epg::flush_stage_rows(
            stage, p.out, 2, T, n, A, plane,
            [tab](int t) { return __float_as_int(tab[4 * t + 3].x); }, p.B,
            atom0);
        __syncthreads();   // the next chunk's table overwrites the rows
    }
}

// Register budget: __launch_bounds__'s least number of resident blocks of
// kMaxWarps warps, by instance: 4 (at most 128 registers) for a ladder on
// one lane, none for the others (ptxas -v, PERF.md: uncapped, the one-lane
// instance at nstate 10 takes 168 registers).
template <int R, int HS>
constexpr int kMinBlocks = HS > 0 ? 4 : 1;

// R rows per lane (HS = 0: a ladder of p.H rows across ceil(p.H / R)
// lanes; HS > 0: a ladder of HS <= R rows on one lane, with the
// off-resonance terms resolved at compile time).
template <int R, int HS>
__global__ void __launch_bounds__(kMaxWarps* epg::kWarp, kMinBlocks<R, HS>)
    composite_kernel(const CompArgs p) {
    extern __shared__ float4 smem[];
    if constexpr (HS > 0) {
        if (p.use_df) {
            comp_run<R, HS, 1>(p, smem);
        } else {
            comp_run<R, HS, 0>(p, smem);
        }
    } else {
        comp_run<R, HS, 2>(p, smem);
    }
}

template <int R, int HS>
int launch(const CompArgs& a, int warps, cudaStream_t stream) {
    const int W = (a.H + R - 1) / R;
    const int A = warps * (epg::kWarp / W);
    const int per = kTab + 2 * A;
    if (a.T * per > kChunkFloats)
        return static_cast<int>(cudaErrorInvalidValue);
    const size_t smem = sizeof(float) * static_cast<size_t>(a.T) * per;
    const int grid = (a.B + A - 1) / A;
    composite_kernel<R, HS><<<grid, warps * epg::kWarp, smem, stream>>>(a);
    return static_cast<int>(cudaGetLastError());
}

// A ladder of H <= R rows on one lane at R = H rounded up to even (the
// rows cuda_fisp.half_rows gives it, R = 1 at H = 1) takes the
// static instance of its H; any other (R, H) the instance of R.  R = 1
// and the even R up to kMaxRows rows per lane.
template <int R = 1>
int launch_r(const CompArgs& a, int rows, int warps, cudaStream_t st) {
    if constexpr (R > kMaxRows) {
        return static_cast<int>(cudaErrorInvalidValue);
    } else {
        if (rows == R) {
            if (a.H == R) return launch<R, R>(a, warps, st);
            if constexpr (R >= 3)
                if (a.H == R - 1) return launch<R, R - 1>(a, warps, st);
            return launch<R, 0>(a, warps, st);
        }
        return launch_r<R == 1 ? 2 : R + 2>(a, rows, warps, st);
    }
}

}  // namespace

// Launch on `stream` of CUDA device `device`; allocates nothing.  Returns
// the CUDA error code of the launch (0 on success; cudaErrorInvalidValue
// for R other than 1, 2, 4, ..., 12, W = ceil(H / R) lanes beyond a warp,
// `block` outside 1..4 warps, `stages` outside 1..32 or a chunk past 48
// KB); the caller raises on anything else.  `R` rows per lane, `block`
// warps per block and `stages` per chunk come from
// cuda_composite.comp_geometry.
extern "C" int epg_composite(const float* fa, const float* phi,
                             const float* ta, const float* tb,
                             const int* adci, const int* shift,
                             const float* aph, const float* b1u,
                             const float* btd, const float* rdir,
                             const float* t1, const float* t2,
                             const float* b1, const float* df,
                             const float* dc, float* out, int N, int B,
                             int nadc, int nstate, int use_df, int use_up,
                             int use_down, int use_adcph, int use_b1u,
                             int use_d, int R, int block, int stages,
                             int device, void* stream) {
    CompArgs a{fa, phi, ta, tb, adci, shift, aph, b1u, btd, rdir, t1, t2, b1,
               df, dc, out, N, B, nstate + 1, nadc, use_df, use_up, use_down,
               use_adcph, use_b1u, use_d, stages};
    const cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (block < 1 || block > kMaxWarps || a.H < 1 || R < 1
        || (a.H + R - 1) / R > epg::kWarp || stages < 1
        || stages > kMaxStages)
        return static_cast<int>(cudaErrorInvalidValue);
    return launch_r(a, R, block, static_cast<cudaStream_t>(stream));
}
