// dess.cu -- double-echo steady state (DESS): FISP and PSIF echoes.
//
// Replaces the TPU kernel epgpy_tpu/models/pallas_dess.py:_kernel_dess
// (:33), driven there by dess_dictionary_pallas (:151); the Python wrapper
// is epgpy_torch/models/cuda_dess.py:dess_dictionary_cuda and the plain
// PyTorch twin beside it (dess_echoes_plain) computes the same recurrence
// with the same operation order.
//
// What it computes, per atom (T1, T2, B1, df), over P TRs of the train
// [T, E(TE), ADC, E(mid), S(1), E(TE2), ADC]: the folded half-ladder of
// fisp_half.cu (six planes A/B/Z re+im of H = nstate + 1 rows from Z(0) =
// 1).  Per TR i: every row is rotated by (FA_i * B1, phi_i); the FISP echo
// is the rotated k = 0 row decayed over TE_i (E2, the df phase, optional
// demodulation); the rows relax over the full TR_i = TE + mid + TE2 (k-
// independent relaxation commutes with the shift, so the mid/TE2 split
// never enters) and shift by one through the centre; the PSIF echo is the
// new A(0) = the relaxed B(1) (optional demodulation, no TE phase).  The
// output is written in the train's ADC order, FISP_0, PSIF_0, FISP_1, ...:
// planes (2, 2P, B), the engine's layout with no interleaving pass.
//
// What bounds it on the card: instruction issue.  Per atom per TR the
// rotation and relaxation of H rows (~40 FP32 operations each), the flip's
// sine and cosine and two echoes; at nstate 8 and 262,144 atoms x 48 TRs
// ~7.1e9 operations (0.106 ms at the FP32 peak) against 4 * 48 * 262,144 *
// 4 bytes out (0.06 ms at 3.35 TB/s).  The design is megre.cu's: the
// segmented layout with blocked rows, a ladder on a segment of W =
// ceil(H / R) lanes, 32 / W ladders per warp, lane r keeping rows r R + c,
// c < R, of the six planes in registers (R from Python,
// cuda_dess.dess_geometry: the fewest lanes with at most 12 rows each, R =
// ceil(H / W), odd R included).  A ladder of up to 12 rows (nstate <= 11,
// the mapping train's nstate 8) sits on one lane and takes the instance of
// its own length HS: no padding row is stepped, the shift is register
// moves (epg::lane_shift), no shuffle runs, the off-resonance terms are
// resolved at compile time.  Deeper ladders take the instance of R, whose
// shift (epg::seg_shift_blocked) moves rows within a lane by register and
// one row of A and of B per lane by a shuffle.  The row-0 lane of a ladder
// stores both echoes directly, coalesced along atoms (a warp's row-0 lanes
// hold consecutive atoms).  The atom-independent terms of a chunk of up to
// 32 TRs (the RF phase's cos/sin of phi and 2 phi, the flip, TR, TE and
// whether TR and TE repeat the previous TR's) sit in a table the block
// fills between two barriers (epg::fill_pulse_table); each lane computes
// the sine and cosine of its atom's B1-scaled flip every TR (sincospif of
// half turns), and its TR terms (cF with its df phasor, cZ, the recovery)
// and TE terms (the echo's decay and phasor) only on a TR whose flags say
// TR or TE changed (every lane steps the same TR: the test is
// warp-uniform).  The decays are exp2f of the time times the atom's
// -log2(e) / T, with no division per TR.  4-warp blocks held at 128
// registers (16 warps per SM; 168 for 10-12 rows per lane across lanes,
// kMinBlocks); a segment past the last atom runs on a clamped atom and
// stores nothing.  Math is precise (no fast-math).
#include <cuda_runtime.h>

#include "epg_planes.cuh"

namespace {

// warps per block at most and rows per lane at most; mirrored by
// cuda_dess.DESS_WARPS and DESS_MAX_ROWS (TRs per chunk: epg::kTabPulses,
// cuda_dess.DESS_TRS)
constexpr int kMaxWarps = 4;
constexpr int kMaxRows = 12;
// the fewest rows per lane of a ladder across lanes: H > (W - 1) kMaxRows
// rows on W = ceil(H / R) lanes give R > kMaxRows (W - 1) / W >= 6
constexpr int kMinSplitRows = kMaxRows / 2 + 1;

struct DessArgs {
    const float* fa;    // (P,) flip angles, degrees
    const float* phi;   // (P,) RF phases, degrees
    const float* tr;    // (P,) full repetition times, ms
    const float* te;    // (P,) FISP echo times (var_te) or unused
    float te0;          // constant FISP echo time (!var_te)
    const float* t1;    // (B,)
    const float* t2;    // (B,)
    const float* b1;    // (B,)
    const float* df;    // (B,) off-resonance, kHz (use_df) or unused
    float* out;         // (2, 2P, B): re, im; rows FISP_0, PSIF_0, ...
    int P, B, H;
    int var_te, use_df, demod;
};

// The train on the lane's rows: R rows per lane of a ladder of p.H rows
// (HS = 0) or a ladder of a static HS rows on one lane; DFM: the
// off-resonance terms off (0), on (1) or as p.use_df says (2).  tab: the
// chunk's table (epg::fill_pulse_table).
template <int R, int HS, int DFM>
__device__ __forceinline__ void dess_run(const DessArgs& p, float4* tab) {
    constexpr int NR = HS > 0 ? HS : R;   // rows a lane steps
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

    const float T1 = p.t1[b];
    const float T2 = p.t2[b];
    const float B1 = p.b1[b];
    const float DF2 = cdf ? 2.0f * p.df[b] : 0.0f;   // phasor half turns
    const float k1 = epg::exp2_rate(T1);
    const float k2 = epg::exp2_rate(T2);

    float s[6][R];   // s[j][c]: plane j, row r R + c
#pragma unroll
    for (int j = 0; j < 6; ++j)
#pragma unroll
        for (int c = 0; c < R; ++c) s[j][c] = 0.0f;
    if (q.r == 0) s[4][0] = 1.0f;

    // the TE terms (hoisted when TE is constant) and the TR terms, kept
    // while the table says they repeat
    float e2te = 0.0f, pteR = 1.0f, pteI = 0.0f;
    if (!p.var_te) epg::te_exp2(p.te0, k2, DF2, cdf, e2te, pteR, pteI);
    epg::Relax rx{};
    const size_t plane = 2 * static_cast<size_t>(p.P) * p.B;
    for (int i0 = 0; i0 < p.P; i0 += epg::kTabPulses) {
        const int n = min(epg::kTabPulses, p.P - i0);
        epg::fill_pulse_table(tab, i0, n, p.phi, p.fa, p.tr, p.te, p.te0,
                              p.var_te != 0);
        __syncthreads();
#pragma unroll 1
        for (int t = 0; t < n; ++t) {
            const float4 ph = tab[2 * t];       // cp, sp, c2p, s2p
            const float4 mv = tab[2 * t + 1];   // fa, TR, TE, flags
            const int fl = static_cast<int>(mv.w);
            if (p.var_te && !(fl & epg::kTeRepeats))
                epg::te_exp2(mv.z, k2, DF2, cdf, e2te, pteR, pteI);
            float sa, ca;
            sincospif(mv.x * B1 * (1.0f / 180.0f), &sa, &ca);
            if (!(fl & epg::kTrRepeats))
                rx = epg::relax_exp2(mv.y, k1, k2, DF2, cdf);
            const epg::Rot r =
                epg::rot_coeffs_sc(sa, ca, ph.x, ph.y, ph.z, ph.w);
            // row 2 i (FISP) of the ladder's atom; PSIF is the next row
            const size_t o =
                static_cast<size_t>(2 * (i0 + t)) * p.B + atom0 + slot;
            const auto store = [&](size_t at, float eR, float eI) {
                if (p.demod) {
                    const float dR = eR * ph.x + eI * ph.y;
                    eI = eI * ph.x - eR * ph.y;
                    eR = dR;
                }
                if (!writer) return;
                p.out[at] = eR;
                p.out[plane + at] = eI;
            };
            epg::step_rows<NR>(s, r, rx, cdf, q.r == 0,
                               [&](const epg::Row& y) {
                // FISP echo: the rotated k = 0 row after the TE decay
                float eR = y.AR * e2te, eI = y.AI * e2te;
                if (cdf) epg::cmul(pteR, pteI, eR, eI, eR, eI);
                store(o, eR, eI);
            });
            if constexpr (HS > 0) {
                epg::lane_shift<0, 2, HS>(s);
            } else {
                epg::seg_shift_blocked(q, s);
            }
            // PSIF echo: the post-shift A(0), on the row-0 lane
            store(o + p.B, s[0][0], s[1][0]);
        }
        __syncthreads();   // the table is read before the next chunk's
    }
}

// Register budget: __launch_bounds__'s least number of resident blocks of
// kMaxWarps warps, by instance: 4 (at most 128 registers: 16 warps per
// SM), 3 (168) for the instances of 10-12 rows per lane across lanes, as
// in megre.cu.
template <int R, int HS>
constexpr int kMinBlocks = HS == 0 && R >= 10 ? 3 : 4;

// HS > 0: a ladder of HS = R rows on one lane, with the off-resonance
// terms resolved at compile time; HS = 0: R rows per lane, a ladder of
// p.H rows across ceil(p.H / R) lanes.
template <int R, int HS>
__global__ void __launch_bounds__(kMaxWarps* epg::kWarp, kMinBlocks<R, HS>)
    dess_kernel(const DessArgs p) {
    __shared__ float4 tab[2 * epg::kTabPulses];
    if constexpr (HS > 0) {
        if (p.use_df) {
            dess_run<R, HS, 1>(p, tab);
        } else {
            dess_run<R, HS, 0>(p, tab);
        }
    } else {
        dess_run<R, HS, 2>(p, tab);
    }
}

template <int R, int HS>
int launch(const DessArgs& a, int warps, cudaStream_t stream) {
    const int W = HS > 0 ? 1 : (a.H + R - 1) / R;
    const long long A = static_cast<long long>(warps) * (epg::kWarp / W);
    const int grid = static_cast<int>((a.B + A - 1) / A);
    dess_kernel<R, HS><<<grid, warps * epg::kWarp, 0, stream>>>(a);
    return static_cast<int>(cudaGetLastError());
}

// R rows per lane: a ladder of H = R rows takes the one-lane instance of
// its length, any other H the instance of R (R = kMinSplitRows ..
// kMaxRows, the rows the fewest lanes give a ladder longer than one lane
// holds).
template <int R = 2>
int launch_r(const DessArgs& a, int rows, int warps, cudaStream_t st) {
    if constexpr (R > kMaxRows) {
        return static_cast<int>(cudaErrorInvalidValue);
    } else {
        if (rows != R) return launch_r<R + 1>(a, rows, warps, st);
        if (a.H == R) return launch<R, R>(a, warps, st);
        if constexpr (R >= kMinSplitRows) return launch<R, 0>(a, warps, st);
        return static_cast<int>(cudaErrorInvalidValue);
    }
}

}  // namespace

// Launch on `stream` of CUDA device `device`; allocates nothing.  Returns
// the CUDA error code of the launch (0 on success; cudaErrorInvalidValue
// for nstate < 1, P or B < 1, R without an instance (launch_r), W =
// ceil(H / R) lanes beyond a warp or `block` outside 1..4 warps); the
// caller raises on anything else.  `R` rows per lane and `block` warps per
// block come from cuda_dess.dess_geometry.
extern "C" int epg_dess(const float* fa, const float* phi, const float* tr,
                        const float* te, float te0, const float* t1,
                        const float* t2, const float* b1, const float* df,
                        float* out, int P, int B, int nstate, int var_te,
                        int use_df, int demod, int R, int block, int device,
                        void* stream) {
    DessArgs a{fa, phi, tr, te, te0, t1, t2, b1, df, out, P, B, nstate + 1,
               var_te, use_df, demod};
    const cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (block < 1 || block > kMaxWarps || a.H < 2 || P < 1 || B < 1 || R < 1
        || (a.H + R - 1) / R > epg::kWarp)
        return static_cast<int>(cudaErrorInvalidValue);
    return launch_r(a, R, block, static_cast<cudaStream_t>(stream));
}
