// fisp_full.cu -- FISP MR-fingerprinting dictionary on the full ladder.
//
// Replaces the TPU kernel epgpy_tpu/models/pallas_fisp.py:_kernel (:116),
// driven there by fisp_dictionary_pallas(half_ladder=False) (:899) and, as
// there, taken at nstate 0, where the folded ladder has no k = 1 row; the
// Python wrapper is epgpy_torch/models/cuda_fisp.py:fisp_full_ladder_cuda
// and the plain PyTorch twin beside it (fisp_full_echoes_plain) computes
// the same recurrence with the same operation order.  It is also the
// parity oracle of fisp_half.cu, whose fold it does not use.
//
// What it computes, per atom (T1, T2, B1, df), over P pulses: the literal
// ladder of K = 2 nstate + 1 rows, k = -nstate..nstate with k = 0 at row
// nstate, as six planes F+, F- and Z (re, im), from Z(0) = 1 (or after a
// closed-form 180*B1 inversion and TI relaxation, the residual F+
// precessing during TI when inv_df).  Per pulse i: the k = 0 echo at TE
// (the rotated centre row, E2 decay, optional df phase, optional
// demodulation by e^{-i phi_i}); every row rotated by the Weigel
// coefficients of (FA_i * B1, phi_i) with the full-TR relaxation and the
// df phasor folded into the coefficients (F+ by cF e^{i w}, F- by its
// conjugate, Z by cZ, recovery 1 - cZ at k = 0); then F+ moves up a row
// and F- down a row, zero-filled at the ends.  No diffusion: the JAX
// wrapper takes it only on the half ladder.
//
// What bounds it on the card: at nstate 0, the route users take (a
// perfectly spoiled dictionary), the echo stores, 2 * P * B * 4 bytes
// (819 MB at 102,400 atoms x 1000 pulses, 0.245 ms at 3.35 TB/s).  There
// the ladder is one row and the shift zero-fills F+(0) and F-(0) after
// every pulse, so from the second pulse on the state is Z(0) alone, and a
// real one: F-(0) = conj(F+(0)) makes the rotation's Z row real.  The
// nstate-0 instance keeps that state in registers, one thread per atom:
// a peeled first pulse carries the inversion prologue's F+ and F-, and
// every later pulse is the echo m02 Z e2te and Z <- cos(a) cZ Z + 1 - cZ,
// ~45 instructions per atom and pulse against 8 bytes stored.  The
// atom-independent terms of a chunk of up to 32 pulses (the RF phase's
// cos/sin of phi and 2 phi, the flip, TR, TE and whether TR and TE repeat
// the previous pulse's) sit in a table the block fills between two
// barriers (epg::fill_pulse_table); per atom and pulse there remain the
// sincospif of the B1-scaled flip in half turns and, on a pulse whose TR
// or TE changed, the decays (exp2f of the time times the atom's
// -log2(e) / T, no division per pulse) and the df phasors; the rest of the
// time they stay in registers.  The first pulse of the train is peeled
// off the chunk's loop, which is unrolled by 4: the sines and cosines of
// four pulses' flips do not wait on Z and overlap (0.333 against 0.401 ms
// at the headline's shape on an H100 80GB HBM3 at 700 W, PERF.md).  Echo
// stores coalesce along atoms.
// Deeper ladders (nstate 1-150, the parity oracle, off every main path)
// run one thread per atom with the literal 2 nstate + 1 rows in shared
// memory at
// [plane][row][threadIdx.x] (conflict-free), walked in place: row r is
// read, its new values computed, Z(r) written, F+(r) takes the carried new
// F+(r-1), and F-(r-1) the new F-(r); they read the same table and take
// the same decay and angle forms, so one twin serves both instances.  A
// thread past the last atom runs on a clamped atom and stores nothing;
// math is precise (no fast-math).  Gate (cuda_fisp.full_kernel_fits): 6
// planes x (2 nstate + 1) rows x 32 threads x 4 bytes in 227 KB, nstate
// <= 150.
#include <cuda_runtime.h>

#include "epg_planes.cuh"

namespace {

// threads per block of the nstate-0 instance and at most of the deeper
// one; mirrored by cuda_fisp.FULL_BLOCK
constexpr int kBlock = 128;

struct FispFullArgs {
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
    float* out_re;      // (P, B)
    float* out_im;      // (P, B)
    int P, B, N;        // N = nstate: rows 0..2N, k = 0 at row N
    int var_te, use_inv, inv_df, use_df, demod;
};

// One atom: its B1, 2 df (the phasors' half turns per ms) and exp2 decay
// rates (epg::exp2_rate of T1 and T2).
struct Atom {
    float B1, DF2, k1, k2;
};

__device__ __forceinline__ Atom load_atom(const FispFullArgs& p, int b) {
    return Atom{p.b1[b], p.use_df ? 2.0f * p.df[b] : 0.0f,
                epg::exp2_rate(p.t1[b]), epg::exp2_rate(p.t2[b])};
}

// The k = 0 row at the start of the train: F+ and F- (re, im) and Z(0)
// (real), from equilibrium or after the closed-form inversion prep (the
// residual F+ precessing during TI when inv_df); F-(0) is the conjugate
// of F+(0).
struct Centre {
    float FpR, FpI, FmR, FmI, Z;
};

__device__ __forceinline__ Centre start(const FispFullArgs& p,
                                        const Atom& a) {
    Centre c{0.0f, 0.0f, 0.0f, 0.0f, 1.0f};
    if (!p.use_inv) return c;
    epg::inversion_exp2(a.B1, a.k1, a.k2, p.ti, a.DF2, p.use_df && p.inv_df,
                        c.FpR, c.FpI, c.Z);
    c.FmR = c.FpR;
    c.FmI = -c.FpI;
    return c;
}

// The echo of the k = 0 row (F+, F-, Z) after the rotation r and the TE
// decay e2te: cos2 F+ + m01 F- + m02 Z (Weigel: m01 = e^{2ip} sin2, m02 =
// -i e^{ip} sin a; r.a1 = m01, r.a2 = m02).
__device__ __forceinline__ void centre_echo(const epg::Rot& r, float FpR,
                                            float FpI, float FmR, float FmI,
                                            float ZR, float ZI, float e2te,
                                            float& eR, float& eI) {
    float bR, bI, dR, dI;
    epg::cmul(r.a1r, r.a1i, FmR, FmI, bR, bI);
    epg::cmul(r.a2r, r.a2i, ZR, ZI, dR, dI);
    eR = (r.c2 * FpR + bR + dR) * e2te;
    eI = (r.c2 * FpI + bI + dI) * e2te;
}

// The echo's df phase (pte) and demodulation by the pulse's phase (cp, sp),
// then its store where the thread's atom is in the batch.
__device__ __forceinline__ void store_echo(const FispFullArgs& p, bool cdf,
                                           float pteR, float pteI, float cp,
                                           float sp, bool live, size_t o,
                                           float eR, float eI) {
    if (cdf) epg::cmul(pteR, pteI, eR, eI, eR, eI);
    if (p.demod) {
        const float xR = eR * cp + eI * sp;
        eI = eI * cp - eR * sp;
        eR = xR;
    }
    if (live) {
        p.out_re[o] = eR;
        p.out_im[o] = eI;
    }
}

// nstate 0: one thread per atom, the k = 0 row in registers.  From the
// second pulse on F+ and F- are zero (the shift empties them) and Z real,
// so only Z is stepped.
__global__ void __launch_bounds__(kBlock) fisp_full_k0(const FispFullArgs p) {
    __shared__ float4 tab[2 * epg::kTabPulses];
    const int bi = blockIdx.x * blockDim.x + threadIdx.x;
    const bool live = bi < p.B;
    const int b = min(bi, p.B - 1);   // clamped past the last atom
    const bool cdf = p.use_df != 0;
    const Atom a = load_atom(p, b);
    const Centre c = start(p, a);
    float Z = c.Z;

    float e2te = 0.0f, pteR = 1.0f, pteI = 0.0f;
    if (!p.var_te) epg::te_exp2(p.te0, a.k2, a.DF2, cdf, e2te, pteR, pteI);
    float cZ = 0.0f, rec = 0.0f;
    for (int i0 = 0; i0 < p.P; i0 += epg::kTabPulses) {
        const int n = min(epg::kTabPulses, p.P - i0);
        epg::fill_pulse_table(tab, i0, n, p.phi, p.fa, p.tr, p.te, p.te0,
                              p.var_te != 0);
        __syncthreads();
        // pulse t of the chunk: its terms, echo and Z step; `first`: the
        // train's first pulse, which carries the prologue's F+ and F-
        const auto pulse = [&](int t, bool first) {
            const float4 ph = tab[2 * t];       // cp, sp, c2p, s2p
            const float4 mv = tab[2 * t + 1];   // fa, TR, TE, flags
            const int fl = static_cast<int>(mv.w);
            if (p.var_te && !(fl & epg::kTeRepeats))
                epg::te_exp2(mv.z, a.k2, a.DF2, cdf, e2te, pteR, pteI);
            float sa, ca;
            sincospif(mv.x * a.B1 * (1.0f / 180.0f), &sa, &ca);
            if (!(fl & epg::kTrRepeats)) {
                cZ = exp2f(a.k1 * mv.y);
                rec = 1.0f - cZ;
            }
            const epg::Rot r =
                epg::rot_coeffs_sc(sa, ca, ph.x, ph.y, ph.z, ph.w);
            float eR, eI;
            if (first) {
                // Z's imaginary part is 2 Im(m20 F+) - 2 Im(m20 F+) = 0
                centre_echo(r, c.FpR, c.FpI, c.FmR, c.FmI, Z, 0.0f, e2te, eR,
                            eI);
                float aR, aI, bR, bI;
                epg::cmul(r.b0r * cZ, r.b0i * cZ, c.FpR, c.FpI, aR, aI);
                epg::cmul(r.b1r * cZ, r.b1i * cZ, c.FmR, c.FmI, bR, bI);
                Z = aR + bR + r.caa * cZ * Z + rec;
            } else {
                // F+ = F- = 0, Z real: the echo m02 Z, Z <- cos(a) cZ Z
                // plus the recovery
                eR = r.a2r * Z * e2te;
                eI = r.a2i * Z * e2te;
                Z = r.caa * cZ * Z + rec;
            }
            store_echo(p, cdf, pteR, pteI, ph.x, ph.y, live,
                       static_cast<size_t>(i0 + t) * p.B + bi, eR, eI);
        };
        int t0 = 0;
        if (i0 == 0) {
            pulse(0, true);
            t0 = 1;
        }
#pragma unroll 4
        for (int t = t0; t < n; ++t) pulse(t, false);
        __syncthreads();   // the table is read before the next chunk's
    }
}

// nstate >= 1 (the parity oracle): one thread per atom, the 2 N + 1 rows
// of the six planes in shared memory after the block's table.
__global__ void __launch_bounds__(kBlock) fisp_full_rows(const FispFullArgs p) {
    extern __shared__ float smem[];
    __shared__ float4 tab[2 * epg::kTabPulses];
    const int bi = blockIdx.x * blockDim.x + threadIdx.x;
    const bool live = bi < p.B;
    const int b = min(bi, p.B - 1);   // clamped past the last atom
    const bool cdf = p.use_df != 0;
    const int N = p.N;
    const int K = 2 * N + 1;
    // planes 0-5: F+ re, F+ im, F- re, F- im, Z re, Z im
    const epg::PlaneSet s{smem + threadIdx.x, K, static_cast<int>(blockDim.x)};
    const Atom a = load_atom(p, b);

    for (int j = 0; j < 6; ++j)
        for (int k = 0; k < K; ++k) s.at(j, k) = 0.0f;
    const Centre c = start(p, a);
    s.at(0, N) = c.FpR;
    s.at(1, N) = c.FpI;
    s.at(2, N) = c.FmR;
    s.at(3, N) = c.FmI;
    s.at(4, N) = c.Z;

    float e2te = 0.0f, pteR = 1.0f, pteI = 0.0f;
    if (!p.var_te) epg::te_exp2(p.te0, a.k2, a.DF2, cdf, e2te, pteR, pteI);
    epg::Relax rx{};
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
                epg::te_exp2(mv.z, a.k2, a.DF2, cdf, e2te, pteR, pteI);
            float sa, ca;
            sincospif(mv.x * a.B1 * (1.0f / 180.0f), &sa, &ca);
            if (!(fl & epg::kTrRepeats))
                rx = epg::relax_exp2(mv.y, a.k1, a.k2, a.DF2, cdf);
            const epg::Rot r =
                epg::rot_coeffs_sc(sa, ca, ph.x, ph.y, ph.z, ph.w);
            // the relaxation folded into the rotation rows: F+ by cF e^{i
            // w} (rx.cFr, rx.cFi), F- by its conjugate, Z by cZ; m12 = i
            // e^{-ip} sin a is conj(m02)
            float c00r, c00i, c01r, c01i, c02r, c02i;
            epg::cmul(rx.cFr, rx.cFi, r.c2, 0.0f, c00r, c00i);
            epg::cmul(rx.cFr, rx.cFi, r.a1r, r.a1i, c01r, c01i);
            epg::cmul(rx.cFr, rx.cFi, r.a2r, r.a2i, c02r, c02i);
            float c10r, c10i, c11r, c11i, c12r, c12i;
            epg::cmul(rx.cFr, -rx.cFi, r.a1r, -r.a1i, c10r, c10i);
            epg::cmul(rx.cFr, -rx.cFi, r.c2, 0.0f, c11r, c11i);
            epg::cmul(rx.cFr, -rx.cFi, r.a2r, -r.a2i, c12r, c12i);
            const float z0r = r.b0r * rx.cZ, z0i = r.b0i * rx.cZ;
            const float z1r = r.b1r * rx.cZ, z1i = r.b1i * rx.cZ;
            const float zz = r.caa * rx.cZ;

            float carR = 0.0f, carI = 0.0f;   // new F+(k-1), waiting for k
            for (int k = 0; k < K; ++k) {
                const float FpR = s.at(0, k), FpI = s.at(1, k);
                const float FmR = s.at(2, k), FmI = s.at(3, k);
                const float ZR = s.at(4, k), ZI = s.at(5, k);
                float aR, aI, bR, bI, dR, dI;
                if (k == N) {
                    float eR, eI;
                    centre_echo(r, FpR, FpI, FmR, FmI, ZR, ZI, e2te, eR,
                                eI);
                    store_echo(p, cdf, pteR, pteI, ph.x, ph.y, live,
                               static_cast<size_t>(i0 + t) * p.B + bi, eR,
                               eI);
                }
                epg::cmul(c00r, c00i, FpR, FpI, aR, aI);
                epg::cmul(c01r, c01i, FmR, FmI, bR, bI);
                epg::cmul(c02r, c02i, ZR, ZI, dR, dI);
                const float nFpR = aR + bR + dR, nFpI = aI + bI + dI;
                epg::cmul(c10r, c10i, FpR, FpI, aR, aI);
                epg::cmul(c11r, c11i, FmR, FmI, bR, bI);
                epg::cmul(c12r, c12i, ZR, ZI, dR, dI);
                const float nFmR = aR + bR + dR, nFmI = aI + bI + dI;
                epg::cmul(z0r, z0i, FpR, FpI, aR, aI);
                epg::cmul(z1r, z1i, FmR, FmI, bR, bI);
                float nZR = aR + bR + zz * ZR;
                if (k == N) nZR = nZR + rx.rec;
                // unit shift: F+ up a row, F- down a row, Z in place
                s.at(4, k) = nZR;
                s.at(5, k) = aI + bI + zz * ZI;
                s.at(0, k) = carR;
                s.at(1, k) = carI;
                carR = nFpR;
                carI = nFpI;
                if (k >= 1) {
                    s.at(2, k - 1) = nFmR;
                    s.at(3, k - 1) = nFmI;
                }
            }
            s.at(2, K - 1) = 0.0f;
            s.at(3, K - 1) = 0.0f;
        }
        __syncthreads();   // the table is read before the next chunk's
    }
}

}  // namespace

// Launch on `stream` of CUDA device `device`; allocates nothing.  Returns
// the CUDA error code of the launch (0 on success; cudaErrorInvalidValue
// for nstate < 0, P or B < 1, or a `block` other than kBlock at nstate 0
// or outside 32..kBlock above); the caller raises on anything else.
// `block` threads per block come from cuda_fisp.full_geometry, which
// halves it from kBlock while the deeper instance's planes and table do
// not fit a block's shared memory.
extern "C" int epg_fisp_full(const float* fa, const float* phi,
                             const float* tr, const float* te, float te0,
                             float ti, const float* t1, const float* t2,
                             const float* b1, const float* df, float* out_re,
                             float* out_im, int P, int B, int nstate,
                             int var_te, int use_inv, int inv_df, int use_df,
                             int demod, int block, int device, void* stream) {
    FispFullArgs a{fa, phi, tr, te, te0, ti, t1, t2, b1, df, out_re, out_im,
                   P, B, nstate, var_te, use_inv, inv_df, use_df, demod};
    cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (nstate < 0 || P < 1 || B < 1 || block < 32 || block > kBlock
        || (nstate == 0 && block != kBlock))
        return static_cast<int>(cudaErrorInvalidValue);
    const int grid = (B + block - 1) / block;
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (nstate == 0) {
        fisp_full_k0<<<grid, block, 0, st>>>(a);
        return static_cast<int>(cudaGetLastError());
    }
    const size_t smem =
        sizeof(float) * 6 * static_cast<size_t>(2 * nstate + 1) * block;
    if (smem > 48 * 1024 - sizeof(float4) * 2 * epg::kTabPulses) {
        e = cudaFuncSetAttribute(
            fisp_full_rows, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (e != cudaSuccess) return static_cast<int>(e);
    }
    fisp_full_rows<<<grid, block, smem, st>>>(a);
    return static_cast<int>(cudaGetLastError());
}
