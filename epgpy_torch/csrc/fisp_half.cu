// fisp_half.cu -- FISP MR-fingerprinting dictionary, folded half-ladder.
//
// Replaces the TPU kernel epgpy_tpu/models/pallas_fisp.py:_kernel_half
// (:270), driven there by fisp_dictionary_pallas (:899); the Python
// wrapper is epgpy_torch/models/cuda_fisp.py:fisp_dictionary_cuda and the
// plain PyTorch twin beside it (fisp_dictionary_plain) computes the same
// recurrence with the same operation order.
//
// What it computes, per atom (T1, T2, B1, df, Dc), over P pulses: the six
// folded planes A/B/Z (re, im) of H = nstate + 1 rows start at Z(0) = 1
// (or after a closed-form 180*B1 inversion and TI relaxation, with the
// residual F+ precessing during TI when inv_df); per pulse i the k = 0
// echo at TE is written out (E2 decay, optional df phase, optional
// demodulation by e^{-i phi_i}), then every row is rotated by the Weigel
// coefficients of (FA_i * B1, phi_i) with both relaxations folded into
// the coefficients (cF for F, cZ for Z, recovery at k = 0), the ladder is
// shifted by one through the centre, and optional DW-FISP attenuation
// rows multiply the result.
//
// What bounds it on the card: instruction issue.  Per atom per pulse the
// rotation and relaxation of H rows are ~36 FP32 operations a row, ~1e11
// for 102,400 atoms x 1000 pulses at nstate 10, against 2 * P * B * 4
// bytes written (819 MB there) and a few (P,) and (B,) vectors read.
// The design is epg_planes.cuh's segmented layout with blocked rows
// (cpmg.cu's): a ladder takes a segment of W = ceil(H / R) lanes and a
// warp holds L = 32 / W ladders; lane r keeps rows r R + c, c < R, of the
// six planes in registers (R chosen in Python, cuda_fisp.
// fisp_half_geometry: the fewest lanes with at most 12 rows each, R 1 or
// even).  A ladder of up to 12 rows sits on one lane, and takes the
// instance of its own length HS: no padding row is stepped, the shift is
// register moves, no shuffle runs, the off-resonance terms are resolved
// at compile time, and __launch_bounds__ holds it at 128 registers (16
// warps per SM; uncapped it took 163 and ran slower, at 96 it spills).
// Deeper ladders take the instance of R, whose shift
// (epg::seg_shift_blocked) moves rows within a lane by register and one
// row of A and of B per lane by a shuffle.  The atom-independent terms of
// a chunk of up to 32 pulses -- the RF phase's cos/sin of phi and 2 phi,
// the flip, TR, TE and whether TR and TE repeat the previous pulse's --
// sit in a table the block fills between two barriers.  The atom's own
// terms of pulse t0 + j -- sincos of the B1-scaled flip and the
// relaxation factors (e^{-TE/T}, e^{-(TR - TE)/T}, the recovery, the df
// phasors) -- are computed by lane j of the segment and broadcast by
// shuffles when the pulse runs; where every pulse of a group of W repeats
// its predecessor's TR and TE (the headline train: a warp-uniform vote on
// the table), the relaxation factors are kept from the previous group.
// The pulse loop runs two groups per iteration (without DW-FISP).
// DW-FISP's attenuation factors are constant over the train: a lane
// computes its rows' once into its own column of shared memory and reads
// them back each pulse, so that the state alone fills the registers.  The
// row-0 lane stages each echo in shared memory, and after the chunk the
// block writes them out as runs of consecutive atoms (epg::flush_stage).
// 4-warp blocks; a segment past the last atom runs on a clamped atom and
// stores nothing.  Math is precise (no fast-math); sincospif of the angles
// in half turns.
#include <cuda_runtime.h>

#include "epg_planes.cuh"

namespace {

// warps per block at most, pulses per chunk at most, floats of one chunk's
// table and staged echoes (48 KB), table floats per pulse, rows per lane
// at most; mirrored by cuda_fisp.SEG_WARPS, SEG_PULSES, SEG_CHUNK_FLOATS,
// HALF_TABLE and HALF_MAX_ROWS
constexpr int kMaxWarps = 4;
constexpr int kMaxPulses = 32;
constexpr int kChunkFloats = 12288;
constexpr int kTab = 8;
constexpr int kMaxRows = 12;

struct FispArgs {
    const float* fa;    // (P,) flip angles, degrees
    const float* phi;   // (P,) RF phases, degrees
    const float* tr;    // (P,) repetition times, ms
    const float* te;    // (P,) echo times (var_te) or unused
    float te0;          // constant echo time (!var_te)
    float ti;           // inversion delay (use_inv)
    const float* t1;    // (B,)
    const float* t2;    // (B,)
    const float* b1;    // (B,)
    const float* df;    // (B,) off-resonance, kHz (use_df) or unused
    const float* dc;    // (B,) diffusivity (DIF) or unused
    float bT, bL;       // transverse/longitudinal b-value bases (DIF)
    float* out;         // (2, P, B): re, im
    int P, B, H;
    int var_te, use_inv, inv_df, use_df, demod, diff_ramp;
    int T;              // pulses per chunk
};

// An atom's constants: its parameters and, without var_te, the echo's TE
// terms.
struct Atom {
    float T1, T2, B1, DF;
    float E1te, E2te, pteR, pteI;
};

// An atom's relaxation terms of one pulse: the echo's TE decay and df
// phasor, the F decay over the TR (with its df phasor), the Z decay and
// the k = 0 recovery.
struct Relax {
    float e2te, pteR, pteI, cFr, cFi, cZ, rec;
};

// The relaxation terms of a pulse of repetition time TRi and echo time te.
__device__ __forceinline__ Relax relax_terms(const FispArgs& p, float TRi,
                                             float te, const Atom& at) {
    const bool cdf = p.use_df != 0;
    Relax o;
    float e1te;
    if (p.var_te) {
        e1te = expf(-te / at.T1);
        o.e2te = expf(-te / at.T2);
        o.pteR = 1.0f;
        o.pteI = 0.0f;
        if (cdf) sincospif(2.0f * at.DF * te, &o.pteI, &o.pteR);
    } else {
        e1te = at.E1te;
        o.e2te = at.E2te;
        o.pteR = at.pteR;
        o.pteI = at.pteI;
    }
    const float rem = TRi - te;
    const float E1b = expf(-rem / at.T1);
    const float E2b = expf(-rem / at.T2);
    const float cF = o.e2te * E2b;
    o.cZ = e1te * E1b;
    o.rec = (1.0f - e1te) * E1b + (1.0f - E1b);
    o.cFr = cF;
    o.cFi = 0.0f;
    if (cdf) {
        float pI, pR;
        sincospif(2.0f * at.DF * (te + rem), &pI, &pR);
        o.cFr = cF * pR;
        o.cFi = cF * pI;
    }
    return o;
}

// Lane u of the lane's segment hands it v (a segment of one lane keeps its
// own).
__device__ __forceinline__ float bcast1(const epg::SegLane& q, float v,
                                        int u) {
    return q.W == 1 ? v : epg::seg_bcast(q, v, u);
}

// Lane u of the segment hands its relaxation terms to the whole segment:
// what the options make vary (the rest are the atom's constants).
__device__ __forceinline__ Relax bcast(const epg::SegLane& q, const Relax& m,
                                       int u, bool cdf, bool var_te) {
    Relax o = m;
    o.cFr = bcast1(q, m.cFr, u);
    o.cZ = bcast1(q, m.cZ, u);
    o.rec = bcast1(q, m.rec, u);
    if (cdf) o.cFi = bcast1(q, m.cFi, u);
    if (var_te) {
        o.e2te = bcast1(q, m.e2te, u);
        if (cdf) {
            o.pteR = bcast1(q, m.pteR, u);
            o.pteI = bcast1(q, m.pteI, u);
        }
    }
    return o;
}

// The folded up shift of a lane's rows: epg::seg_shift_blocked, or
// epg::lane_shift for a ladder of a static HS rows on one lane.
template <int R, int HS>
__device__ __forceinline__ void shift_up(const epg::SegLane& q,
                                         float (&s)[6][R]) {
    if constexpr (HS > 0) {
        epg::lane_shift<0, 2, HS>(s);
    } else {
        epg::seg_shift_blocked(q, s);
    }
}

// The train on the lane's rows: R rows per lane of a ladder of p.H rows
// (HS = 0) or of a static HS rows on one lane; DIF: the DW-FISP
// attenuation; DFM: the off-resonance terms off (0), on (1) or as p.use_df
// says (2).  smem: the chunk's table (2 float4 per pulse: cos phi, sin phi,
// cos 2phi, sin 2phi; fa, TR, TE, repeats), then the staged echoes (2, T,
// A) of the block's A atoms, then (DIF) the lanes' attenuation factors.
template <int R, int HS, bool DIF, int DFM>
__device__ __forceinline__ void fisp_run(const FispArgs& p, float4* smem) {
    constexpr int NR = HS > 0 ? HS : R;   // rows a lane steps
    const int T = p.T;
    float4* tab = smem;
    float* stage = reinterpret_cast<float*>(smem + 2 * T);
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
    const bool var_te = p.var_te != 0;
    const int TA = T * A;   // floats per staged output plane

    Atom at;
    at.T1 = p.t1[b];
    at.T2 = p.t2[b];
    at.B1 = p.b1[b];
    at.DF = cdf ? p.df[b] : 0.0f;
    at.E1te = at.E2te = 0.0f;
    at.pteR = 1.0f;
    at.pteI = 0.0f;
    if (!var_te) {
        at.E1te = expf(-p.te0 / at.T1);
        at.E2te = expf(-p.te0 / at.T2);
        if (cdf) sincospif(2.0f * at.DF * p.te0, &at.pteI, &at.pteR);
    }

    float s[6][R];   // s[j][c]: plane j, row r R + c
#pragma unroll
    for (int j = 0; j < 6; ++j)
#pragma unroll
        for (int c = 0; c < R; ++c) s[j][c] = 0.0f;
    if (q.r == 0) {
        if (p.use_inv) {
            // 180*B1 pulse about phi = 0, then TI relaxation; the folded
            // layout keeps A(0) = B(0) = F+(0)
            float sai, cai;
            sincospif(at.B1, &sai, &cai);
            const float E1i = expf(-p.ti / at.T1);
            const float E2i = expf(-p.ti / at.T2);
            const float fpi = -sai * E2i;
            if (cdf && p.inv_df) {
                float sth, cth;
                sincospif(2.0f * at.DF * p.ti, &sth, &cth);
                s[0][0] = -fpi * sth;
                s[1][0] = fpi * cth;
                s[2][0] = -fpi * sth;
                s[3][0] = fpi * cth;
            } else {
                s[1][0] = fpi;
                s[3][0] = fpi;
            }
            s[4][0] = cai * E1i + 1.0f - E1i;
        } else {
            s[4][0] = 1.0f;
        }
    }
    // DW-FISP: the post-shift (aA, aB, aZ) of the lane's rows (epg::seg_att;
    // its D derivatives are not used), each lane's in its own column of
    // shared memory (3 R rows of blockDim.x after the staged echoes): read
    // back each pulse, they leave the registers to the state
    float* const att = stage + 2 * TA + threadIdx.x;
    const int ld = blockDim.x;
    if constexpr (DIF) {
        const float Dc = p.dc[b];
#pragma unroll
        for (int c = 0; c < NR; ++c) {
            float f[3], unused[3];
            epg::seg_att(q.r * R + c, p.bT, p.bL, p.diff_ramp != 0, Dc, f,
                         unused);
#pragma unroll
            for (int j = 0; j < 3; ++j) att[(j * R + c) * ld] = f[j];
        }
    }

    Relax rx{};   // the relaxation terms of the pulse that runs
    const size_t plane = static_cast<size_t>(p.P) * p.B;
    for (int i0 = 0; i0 < p.P; i0 += T) {
        const int n = min(T, p.P - i0);
        for (int t = threadIdx.x; t < n; t += blockDim.x) {
            const int i = i0 + t;
            const float ph = p.phi[i] * (1.0f / 180.0f);
            float sp, cp, s2p, c2p;
            sincospif(ph, &sp, &cp);
            sincospif(2.0f * ph, &s2p, &c2p);
            const float tri = p.tr[i];
            const float tei = var_te ? p.te[i] : p.te0;
            const bool repeats = i > 0 && tri == p.tr[i - 1]
                                 && (!var_te || tei == p.te[i - 1]);
            tab[2 * t] = make_float4(cp, sp, c2p, s2p);
            tab[2 * t + 1] =
                make_float4(p.fa[i], tri, tei, repeats ? 1.0f : 0.0f);
        }
        __syncthreads();
        // one group of W pulses from t0 (one pulse on one lane)
        auto group = [&](int t0) {
            const int nu = min(W, n - t0);
            // this lane's atom terms of pulse t0 + r, broadcast below
            const float4 mv = tab[2 * (t0 + min(q.r, nu - 1)) + 1];
            float msa, mca;
            sincospif(mv.x * at.B1 * (1.0f / 180.0f), &msa, &mca);
            // every pulse of the group repeats its predecessor's TR and TE:
            // the terms of the last pulse run stand
            const bool held = __all_sync(epg::kFullMask, mv.w != 0.0f);
            Relax mine = rx;
            if (!held) mine = relax_terms(p, mv.y, mv.z, at);
#pragma unroll 1
            for (int u = 0; u < nu; ++u) {
                const int t = t0 + u;
                if (!held) rx = bcast(q, mine, u, cdf, var_te);
                const float4 ph = tab[2 * t];   // cp, sp, c2p, s2p
                const epg::Rot r = epg::rot_coeffs_sc(
                    bcast1(q, msa, u), bcast1(q, mca, u), ph.x, ph.y, ph.z,
                    ph.w);
                float* const est = stage + t * A + slot;
#pragma unroll
                for (int c = 0; c < NR; ++c) {
                    const epg::Row y = epg::rotate(
                        r, epg::Row{s[0][c], s[1][c], s[2][c], s[3][c],
                                    s[4][c], s[5][c]});
                    if (c == 0 && writer) {
                        // echo from the k = 0 row after rotation and TE decay
                        float eR = y.AR * rx.e2te, eI = y.AI * rx.e2te;
                        if (cdf) epg::cmul(rx.pteR, rx.pteI, eR, eI, eR, eI);
                        if (p.demod) {
                            const float dR = eR * ph.x + eI * ph.y;
                            eI = eI * ph.x - eR * ph.y;
                            eR = dR;
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
                shift_up<R, HS>(q, s);
                if constexpr (DIF) {
#pragma unroll
                    for (int c = 0; c < NR; ++c) {
                        const float aA = att[c * ld];
                        const float aB = att[(R + c) * ld];
                        const float aZ = att[(2 * R + c) * ld];
                        s[0][c] *= aA;
                        s[1][c] *= aA;
                        s[2][c] *= aB;
                        s[3][c] *= aB;
                        s[4][c] *= aZ;
                        s[5][c] *= aZ;
                    }
                }
            }
        };
        // unrolled by two without DW-FISP (8% faster at the headline
        // shape, PERF.md); its factors' loads would spill at 128 registers
        if constexpr (DIF) {
#pragma unroll 1
            for (int t0 = 0; t0 < n; t0 += W) group(t0);
        } else {
#pragma unroll 2
            for (int t0 = 0; t0 < n; t0 += W) group(t0);
        }
        __syncthreads();
        epg::flush_stage(stage, p.out, 2, T, n, A, plane,
                         static_cast<size_t>(i0), p.B, atom0);
    }
}

// Register budget: __launch_bounds__'s least number of resident blocks of
// kMaxWarps warps, by instance: 4 (at most 128 registers) for a ladder of
// up to 11 rows on one lane, 3 (168) for 12 rows, which spill at 128, none
// for the others (ptxas -v, PERF.md: uncapped, the one-lane instance at
// nstate 10 takes 163 registers, 12 warps per SM; at 96 it spills).
template <int R, int HS, bool DIF>
constexpr int kMinBlocks = HS == 0 ? 1 : HS < 12 ? 4 : 3;

// R rows per lane (HS = 0: a ladder of p.H rows across ceil(p.H / R)
// lanes; HS > 0: a ladder of HS <= R rows on one lane, with the
// off-resonance terms resolved at compile time); DIF: the DW-FISP
// attenuation.
template <int R, int HS, bool DIF>
__global__ void __launch_bounds__(kMaxWarps* epg::kWarp,
                                  kMinBlocks<R, HS, DIF>)
    fisp_half_kernel(const FispArgs p) {
    extern __shared__ float4 smem[];
    if constexpr (HS > 0) {
        if (p.use_df) {
            fisp_run<R, HS, DIF, 1>(p, smem);
        } else {
            fisp_run<R, HS, DIF, 0>(p, smem);
        }
    } else {
        fisp_run<R, HS, DIF, 2>(p, smem);
    }
}

template <int R, int HS, bool DIF>
int launch(const FispArgs& a, int warps, cudaStream_t stream) {
    const int W = (a.H + R - 1) / R;
    const int A = warps * (epg::kWarp / W);
    const int per = kTab + 2 * A;
    if (a.T * per > kChunkFloats)
        return static_cast<int>(cudaErrorInvalidValue);
    const size_t smem =
        sizeof(float) * (static_cast<size_t>(a.T) * per
                         + (DIF ? 3 * R * warps * epg::kWarp : 0));
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            fisp_half_kernel<R, HS, DIF>,
            cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (e != cudaSuccess) return static_cast<int>(e);
    }
    const int grid = (a.B + A - 1) / A;
    fisp_half_kernel<R, HS, DIF>
        <<<grid, warps * epg::kWarp, smem, stream>>>(a);
    return static_cast<int>(cudaGetLastError());
}

// A ladder of H <= R rows on one lane at R = H rounded up to even (the
// rows cuda_fisp.half_rows gives it) takes the static instance of its H;
// any other (R, H) the instance of R.  R = 1 and the even R up to
// kMaxRows rows per lane.
template <bool DIF, int R = 1>
int launch_r(const FispArgs& a, int rows, int warps, cudaStream_t st) {
    if constexpr (R > kMaxRows) {
        return static_cast<int>(cudaErrorInvalidValue);
    } else {
        if (rows == R) {
            if constexpr (R >= 2) {
                if (a.H == R) return launch<R, R, DIF>(a, warps, st);
                if (a.H == R - 1 && R >= 3)
                    return launch<R, (R >= 3 ? R - 1 : R), DIF>(a, warps, st);
            }
            return launch<R, 0, DIF>(a, warps, st);
        }
        return launch_r<DIF, R == 1 ? 2 : R + 2>(a, rows, warps, st);
    }
}

}  // namespace

// Launch on `stream` of CUDA device `device`; allocates nothing.  Returns
// the CUDA error code of the launch (0 on success; cudaErrorInvalidValue
// for nstate < 1, R other than 1, 2, 4, ..., 12, W = ceil(H / R) lanes
// beyond a warp, `block` outside 1..4 warps, `pulses` outside 1..32 or a
// chunk past 48 KB); the caller raises on anything else.  `R` rows per
// lane, `block` warps per block and `pulses` per chunk come from
// cuda_fisp.fisp_half_geometry.  `out` is (2, P, B): re, then im.
extern "C" int epg_fisp_half(const float* fa, const float* phi,
                             const float* tr, const float* te, float te0,
                             float ti, const float* t1, const float* t2,
                             const float* b1, const float* df,
                             const float* dc, float bT, float bL, float* out,
                             int P, int B, int nstate, int var_te,
                             int use_inv, int inv_df, int use_df, int demod,
                             int use_diff, int diff_ramp, int R, int block,
                             int pulses, int device, void* stream) {
    FispArgs a{fa, phi, tr, te, te0, ti, t1, t2, b1, df, dc, bT, bL, out,
               P, B, nstate + 1, var_te, use_inv, inv_df, use_df, demod,
               diff_ramp, pulses};
    const cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (block < 1 || block > kMaxWarps || a.H < 2 || R < 1
        || (a.H + R - 1) / R > epg::kWarp || pulses < 1
        || pulses > kMaxPulses)
        return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    return use_diff ? launch_r<true>(a, R, block, st)
                    : launch_r<false>(a, R, block, st);
}
