// megre.cu -- multi-echo spoiled GRE (ME-GRE): m echoes per TR.
//
// Replaces the TPU kernel epgpy_tpu/models/pallas_megre.py:_kernel_megre
// (:93), driven there by megre_dictionary_pallas (:169); the Python wrapper
// is epgpy_torch/models/cuda_megre.py:megre_dictionary_cuda and the plain
// PyTorch twin beside it (megre_echoes_plain) computes the same recurrence
// with the same operation order.
//
// What it computes, per atom (T1, T2, B1, df), over P TRs of the train
// [T, (E, ADC) x m, E?, S(1)]: the folded half-ladder of fisp_half.cu (six
// planes A/B/Z re+im of H = nstate + 1 rows from Z(0) = 1).  Per TR i:
// every row is rotated once by (FA_i * B1, phi_i); echo j is the rotated
// k = 0 row times the echo factor e^{-te_ji / T2} e^{i 2 pi df te_ji}
// (the cumulative echo times come as an (m, P) matrix), optionally
// demodulated by phi_i; then the rows relax over the full TR_i
// (k-independent relaxation commutes with everything between the pulse
// and the shift, so the echo spacing never enters the carried state) and
// shift by one through the centre.  The output is written in the train's
// ADC order, row i m + j: planes (2, m P, B), the engine's layout with no
// reorder pass.
//
// What bounds it on the card: instruction issue.  Per atom per TR the
// rotation and relaxation of H rows (~40 FP32 operations each) plus m
// echoes; at nstate 8, m 3, 262,144 atoms x 200 TRs ~3.6e10 operations
// (0.54 ms at the FP32 peak) against 2 * 600 * 262,144 * 4 bytes out
// (0.38 ms at 3.35 TB/s).  The design is fisp_half.cu's segmented layout
// with blocked rows: a ladder takes a segment of W = ceil(H / R) lanes, a
// warp 32 / W ladders, and lane r keeps rows r R + c, c < R, of the six
// planes in registers (R from Python, cuda_megre.megre_geometry: the
// fewest lanes with at most 12 rows each, R = ceil(H / W), odd R
// included).  A ladder of up to 12 rows (nstate <= 11, the bench's
// nstate 8) sits on one lane and takes the instance of its own length HS:
// no padding row is stepped, the shift is register moves, no shuffle
// runs, the off-resonance terms are resolved at compile time, and
// consecutive lanes hold consecutive atoms, so each echo is stored
// directly, coalesced along atoms.  Deeper ladders take the instance of
// R, whose shift (epg::seg_shift_blocked) moves rows within a lane by
// register and one row of A and of B per lane by a shuffle.  The row-0
// lane of a ladder stores its echoes directly on every instance (a warp
// stores 32 / W consecutive atoms at once; this timed faster than
// staging a chunk's echoes in shared memory at 2 to 26 lanes per
// ladder), so the echoes take no shared memory and no echo count is
// refused.  The atom-independent terms of a
// chunk of up to 32 TRs -- the RF phase's cos/sin of phi and 2 phi, the
// flip, TR and whether TR and the m echo times repeat the previous TR's
// -- sit in a table the block fills between two barriers; the echo times
// themselves are read in place (a broadcast load) only on a TR whose
// flags say they changed, so the table does not grow with m.  Each lane
// computes the sine and cosine of its atom's B1-scaled flip every TR; the
// relaxation terms (cF with its df phasor, cZ, the recovery) and, up to
// kHeldEchoes echoes, the echo factors sit in registers and are
// recomputed only on a TR whose flags say TR or the echo times changed
// (every lane steps the same TR: the test is warp-uniform); past
// kHeldEchoes echoes the factors are recomputed each TR, so that the
// state alone fills the registers.  4-warp blocks held at 128 registers
// (16 warps per SM; 168 for 10-12 rows per lane across lanes, kMinBlocks);
// a segment past the last atom runs on a clamped atom and stores
// nothing.  Math is precise (no fast-math); sincospif of the
// angles in half turns.
#include <cuda_runtime.h>

#include "epg_planes.cuh"

namespace {

// warps per block at most, TRs per chunk, table floats per TR, rows per
// lane at most, echoes whose factors a lane holds in registers; mirrored
// by cuda_megre.MEGRE_WARPS, MEGRE_TRS, MEGRE_TABLE, MEGRE_MAX_ROWS and
// MEGRE_HELD_ECHOES
constexpr int kMaxWarps = 4;
constexpr int kMaxTRs = 32;
constexpr int kTab = 8;
constexpr int kMaxRows = 12;
constexpr int kHeldEchoes = 4;
// the fewest rows per lane of a ladder across lanes: H > (W - 1) kMaxRows
// rows on W = ceil(H / R) lanes give R > kMaxRows (W - 1) / W >= 6
constexpr int kMinSplitRows = kMaxRows / 2 + 1;

struct MegreArgs {
    const float* fa;    // (P,) flip angles, degrees
    const float* phi;   // (P,) RF phases, degrees
    const float* tr;    // (P,) full repetition times, ms
    const float* te;    // (m, P) cumulative echo times, ms
    const float* t1;    // (B,)
    const float* t2;    // (B,)
    const float* b1;    // (B,)
    const float* df;    // (B,) off-resonance, kHz (use_df) or unused
    float* out;         // (2, m P, B): re, im; row i m + j
    int P, B, H, m;
    int use_df, demod;
};

// An atom's relaxation terms over a TR: the F decay with its df phasor,
// the Z decay and the k = 0 recovery.
struct Relax {
    float cFr, cFi, cZ, rec;
};

__device__ __forceinline__ Relax relax_terms(float TRi, float T1, float T2,
                                             float DF2, bool cdf) {
    Relax o;
    const float cF = expf(-TRi / T2);
    o.cZ = expf(-TRi / T1);
    o.rec = 1.0f - o.cZ;
    o.cFr = cF;
    o.cFi = 0.0f;
    if (cdf) {
        float pI, pR;
        sincospif(DF2 * TRi, &pI, &pR);
        o.cFr = cF * pR;
        o.cFi = cF * pI;
    }
    return o;
}

// The echo factor of an echo at te: e^{-te / T2} times, with df, the
// phasor e^{i pi DF2 te} (DF2 = 2 df).
__device__ __forceinline__ void echo_factor(float te, float T2, float DF2,
                                            bool cdf, float& fR, float& fI) {
    const float e = expf(-te / T2);
    fR = e;
    fI = 0.0f;
    if (cdf) {
        float sI, sR;
        sincospif(DF2 * te, &sI, &sR);
        fR = e * sR;
        fI = e * sI;
    }
}

// The train on the lane's rows: R rows per lane of a ladder of p.H rows
// (HS = 0) or a ladder of a static HS rows on one lane; DFM: the
// off-resonance terms off (0), on (1) or as p.use_df says (2).  tab: the
// chunk's table, 2 float4 per TR: cos phi, sin phi, cos 2phi, sin 2phi;
// fa, TR, TR repeats, echo times repeat.
template <int R, int HS, int DFM>
__device__ __forceinline__ void megre_run(const MegreArgs& p, float4* tab) {
    constexpr int NR = HS > 0 ? HS : R;   // rows a lane steps
    constexpr int T = kMaxTRs;
    const int H = HS > 0 ? HS : p.H;
    const int W = HS > 0 ? 1 : (H + R - 1) / R;   // lanes per ladder
    const int L = epg::kWarp / W;
    const epg::SegLane q =
        epg::seg_lane(threadIdx.x & (epg::kWarp - 1), W, H);
    const int seg = q.base / W;
    const int A = static_cast<int>(blockDim.x / epg::kWarp) * L;
    const int slot = static_cast<int>(threadIdx.x / epg::kWarp) * L
                     + min(seg, L - 1);   // idle lanes: the last
    const int atom0 = blockIdx.x * A;
    // the segment's row-0 lane of an atom in the batch stores the echoes
    const bool writer = q.r == 0 && seg < L && atom0 + slot < p.B;
    const int b = min(atom0 + slot, p.B - 1);  // clamped past the last atom
    const bool cdf = DFM == 2 ? p.use_df != 0 : DFM == 1;
    const int m = p.m;
    const bool held = m <= kHeldEchoes;

    const float T1 = p.t1[b];
    const float T2 = p.t2[b];
    const float B1 = p.b1[b];
    const float DF2 = cdf ? 2.0f * p.df[b] : 0.0f;

    float s[6][R];   // s[j][c]: plane j, row r R + c
#pragma unroll
    for (int j = 0; j < 6; ++j)
#pragma unroll
        for (int c = 0; c < R; ++c) s[j][c] = 0.0f;
    if (q.r == 0) s[4][0] = 1.0f;

    Relax rx{};               // the relaxation terms of the TR that runs
    float ef[kHeldEchoes][2];   // the held echo factors (m <= kHeldEchoes)
#pragma unroll
    for (int j = 0; j < kHeldEchoes; ++j) ef[j][0] = ef[j][1] = 0.0f;
    const size_t plane = static_cast<size_t>(m) * p.P * p.B;
    for (int i0 = 0; i0 < p.P; i0 += T) {
        const int n = min(T, p.P - i0);
        for (int t = threadIdx.x; t < n; t += blockDim.x) {
            const int i = i0 + t;
            const float ph = p.phi[i] * (1.0f / 180.0f);
            float sp, cp, s2p, c2p;
            sincospif(ph, &sp, &cp);
            sincospif(2.0f * ph, &s2p, &c2p);
            const float tri = p.tr[i];
            const bool trep = i > 0 && tri == p.tr[i - 1];
            bool terep = i > 0;
            for (int j = 0; terep && j < m; ++j) {
                const size_t o = static_cast<size_t>(j) * p.P + i;
                terep = p.te[o] == p.te[o - 1];
            }
            tab[2 * t] = make_float4(cp, sp, c2p, s2p);
            tab[2 * t + 1] = make_float4(p.fa[i], tri, trep ? 1.0f : 0.0f,
                                         terep ? 1.0f : 0.0f);
        }
        __syncthreads();
#pragma unroll 1
        for (int t = 0; t < n; ++t) {
            const int i = i0 + t;
            const float4 ph = tab[2 * t];       // cp, sp, c2p, s2p
            const float4 mv = tab[2 * t + 1];   // fa, TR, repeats
            float sa, ca;
            sincospif(mv.x * B1 * (1.0f / 180.0f), &sa, &ca);
            if (mv.z == 0.0f) rx = relax_terms(mv.y, T1, T2, DF2, cdf);
            if (held && mv.w == 0.0f) {
#pragma unroll
                for (int j = 0; j < kHeldEchoes; ++j)
                    if (j < m)
                        echo_factor(
                            __ldg(p.te + static_cast<size_t>(j) * p.P + i),
                            T2, DF2, cdf, ef[j][0], ef[j][1]);
            }
            const epg::Rot r =
                epg::rot_coeffs_sc(sa, ca, ph.x, ph.y, ph.z, ph.w);
            // echo j of the rotated k = 0 row: stored by the writer, dropped
            // by the other lanes
            const auto emit = [&](int j, float fR, float fI, float AR,
                                  float AI) {
                float eR, eI;
                if (cdf) {
                    epg::cmul(fR, fI, AR, AI, eR, eI);
                } else {
                    eR = fR * AR;
                    eI = fR * AI;
                }
                if (p.demod) {
                    const float dR = eR * ph.x + eI * ph.y;
                    eI = eI * ph.x - eR * ph.y;
                    eR = dR;
                }
                if (!writer) return;
                const size_t o =
                    (static_cast<size_t>(i) * m + j) * p.B + atom0 + slot;
                p.out[o] = eR;
                p.out[plane + o] = eI;
            };
#pragma unroll
            for (int c = 0; c < NR; ++c) {
                const epg::Row y = epg::rotate(
                    r, epg::Row{s[0][c], s[1][c], s[2][c], s[3][c], s[4][c],
                                s[5][c]});
                if (c == 0 && q.r == 0) {
                    if (held) {
#pragma unroll
                        for (int j = 0; j < kHeldEchoes; ++j)
                            if (j < m) emit(j, ef[j][0], ef[j][1], y.AR, y.AI);
                    } else {
#pragma unroll 1
                        for (int j = 0; j < m; ++j) {
                            float fR, fI;
                            echo_factor(__ldg(p.te
                                              + static_cast<size_t>(j) * p.P
                                              + i),
                                        T2, DF2, cdf, fR, fI);
                            emit(j, fR, fI, y.AR, y.AI);
                        }
                    }
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
            if constexpr (HS > 0) {
                epg::lane_shift<0, 2, HS>(s);
            } else {
                epg::seg_shift_blocked(q, s);
            }
        }
        __syncthreads();   // the table is done before the next chunk's
    }
}

// Register budget: __launch_bounds__'s least number of resident blocks of
// kMaxWarps warps, by instance: 4 (at most 128 registers: 16 warps per
// SM), 3 (168) for the instances of 10-12 rows per lane across lanes,
// which spill 24-128 B at 128 (ptxas -v; the one-lane instances of 10-12
// rows do not).
template <int R, int HS>
constexpr int kMinBlocks = HS == 0 && R >= 10 ? 3 : 4;

// HS > 0: a ladder of HS = R rows on one lane, with the off-resonance
// terms resolved at compile time; HS = 0: R rows per lane, a ladder of
// p.H rows across ceil(p.H / R) lanes.
template <int R, int HS>
__global__ void __launch_bounds__(kMaxWarps* epg::kWarp, kMinBlocks<R, HS>)
    megre_kernel(const MegreArgs p) {
    __shared__ float4 smem[kTab / 4 * kMaxTRs];
    if constexpr (HS > 0) {
        if (p.use_df) {
            megre_run<R, HS, 1>(p, smem);
        } else {
            megre_run<R, HS, 0>(p, smem);
        }
    } else {
        megre_run<R, HS, 2>(p, smem);
    }
}

template <int R, int HS>
int launch(const MegreArgs& a, int warps, cudaStream_t stream) {
    const int W = HS > 0 ? 1 : (a.H + R - 1) / R;
    const long long A = static_cast<long long>(warps) * (epg::kWarp / W);
    const int grid = static_cast<int>((a.B + A - 1) / A);
    megre_kernel<R, HS><<<grid, warps * epg::kWarp, 0, stream>>>(a);
    return static_cast<int>(cudaGetLastError());
}

// R rows per lane: a ladder of H = R rows takes the one-lane instance of
// its length, any other H the instance of R (R = kMinSplitRows ..
// kMaxRows, the rows the fewest lanes give a ladder longer than one lane
// holds).
template <int R = 1>
int launch_r(const MegreArgs& a, int rows, int warps, cudaStream_t st) {
    if constexpr (R > kMaxRows) {
        return static_cast<int>(cudaErrorInvalidValue);
    } else {
        if (rows != R) return launch_r<R + 1>(a, rows, warps, st);
        if constexpr (R >= 2) {
            if (a.H == R) return launch<R, R>(a, warps, st);
        }
        if constexpr (R >= kMinSplitRows) return launch<R, 0>(a, warps, st);
        return static_cast<int>(cudaErrorInvalidValue);
    }
}

}  // namespace

// Launch on `stream` of CUDA device `device`; allocates nothing.  Returns
// the CUDA error code of the launch (0 on success; cudaErrorInvalidValue
// for nstate < 1, m < 1, R without an instance (launch_r), W = ceil(H /
// R) lanes beyond a warp or `block` outside 1..4 warps); the caller
// raises on anything else.  `R` rows per lane and `block` warps per block
// come from cuda_megre.megre_geometry.  `out` is (2, m P, B): re, then
// im.
extern "C" int epg_megre(const float* fa, const float* phi, const float* tr,
                         const float* te, const float* t1, const float* t2,
                         const float* b1, const float* df, float* out, int P,
                         int B, int m, int nstate, int use_df, int demod,
                         int R, int block, int device, void* stream) {
    MegreArgs a{fa, phi, tr, te, t1, t2, b1, df, out, P, B, nstate + 1, m,
                use_df, demod};
    const cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (block < 1 || block > kMaxWarps || a.H < 2 || m < 1 || R < 1
        || (a.H + R - 1) / R > epg::kWarp)
        return static_cast<int>(cudaErrorInvalidValue);
    return launch_r(a, R, block, static_cast<cudaStream_t>(stream));
}
