// bssfp.cu -- balanced SSFP (TrueFISP) fingerprints at k = 0.
//
// Replaces the TPU kernel epgpy_tpu/models/pallas_bssfp.py:_kernel (:57),
// driven there by bssfp_dictionary_pallas (:381); the Python wrapper is
// epgpy_torch/models/cuda_bssfp.py:bssfp_dictionary_cuda and the plain
// PyTorch twin beside it (bssfp_echoes_plain) computes the same recurrence
// with the same operation order.
//
// What it computes, per atom (T1, T2, B1, df), over P pulses: a balanced
// train never leaves k = 0, and F-(0) = conj(F+(0)) with a real Z(0) hold
// through every pulse, so the state is three floats (Re F+, Im F+, Z),
// starting at Z = 1 or after a closed-form 180*B1 inversion and TI
// relaxation whose residual F+ precesses by df.  Per pulse i: the k = 0
// rotation by (FA_i * B1, phi_i), the echo at TE_i (E2 decay, the df phase,
// optional demodulation by e^{-i phi_i}) written to the (P, B) planes, then
// the full-TR relaxation with the df precession and the Z recovery.
//
// What bounds it on the card: the outputs are 2 * P * B * 4 bytes (655 MB
// at 500 pulses x 163,840 atoms, 0.2 ms at 3.35 TB/s) and the inputs a few
// (P,) and (B,) vectors, against ~60 FP32 operations per atom and pulse
// plus the transcendentals, whose instructions outnumber the rest.  The
// design: one thread per atom keeps the three state floats in registers
// across the whole train and stores each pulse's echo coalesced along
// atoms (one 128-byte line per warp, pulse and plane).  The atom-
// independent terms of a chunk of up to 32 pulses -- the RF phase's
// cos/sin of phi and 2 phi, the flip, TR, TE and whether TR and TE repeat
// the previous pulse's -- sit in a table the block fills between two
// barriers (every thread then reads one word at a time: a broadcast).
// Per atom and pulse there remain the sincos of the B1-scaled flip and,
// on a pulse whose TR or TE differs from the previous one's (every pulse
// of the benchmark's train), the TR decays and phasor and the TE decay and
// phasor; the rest of the time they stay in registers.  Angles are in half
// turns, the inversion prologue's too (sincospif: no large-argument path
// and no stack frame, exact at any df t), the phasors' from the atom's 2
// df; the decays are exp2f of the time times the atom's -log2(e) / T, with
// no division per pulse (0.58 ms against 0.74 with expf(-t / T) at the
// benchmark's shape, PERF.md).  A thread past the last atom runs on a
// clamped atom and stores nothing; math is precise (no fast-math): the
// error budget is against an f64 reference.
#include <cuda_runtime.h>

#include "epg_planes.cuh"

namespace {

// threads per block, pulses per chunk at most; mirrored by
// cuda_bssfp.BLOCK and BSSFP_PULSES
constexpr int kBlock = 128;
constexpr int kMaxPulses = epg::kTabPulses;

struct BssfpArgs {
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
    float* out;         // (2, P, B): re, im
    int P, B;
    int var_te, use_inv, use_df, demod;
};

__global__ void __launch_bounds__(kBlock) bssfp_kernel(const BssfpArgs p) {
    __shared__ float4 tab[2 * kMaxPulses];
    const int bi = blockIdx.x * blockDim.x + threadIdx.x;
    const bool live = bi < p.B;
    const int b = min(bi, p.B - 1);   // clamped past the last atom
    const float T1 = p.t1[b];
    const float T2 = p.t2[b];
    const float B1 = p.b1[b];
    const bool cdf = p.use_df != 0;
    const float DF = cdf ? p.df[b] : 0.0f;
    const float DF2 = 2.0f * DF;   // the phasors' half turns per ms
    const float k1 = epg::exp2_rate(T1);
    const float k2 = epg::exp2_rate(T2);

    // the inversion prep and TI precession, or equilibrium
    float FR = 0.0f, FI = 0.0f, Z = 1.0f;
    if (p.use_inv) epg::inversion_exp2(B1, k1, k2, p.ti, DF2, cdf, FR, FI, Z);

    // the TE terms (hoisted when TE is constant) and the TR terms, kept
    // while the table says they repeat
    float e2te = 0.0f, pteR = 1.0f, pteI = 0.0f;
    if (!p.var_te) epg::te_exp2(p.te0, k2, DF2, cdf, e2te, pteR, pteI);
    float cF = 0.0f, cZ = 0.0f, pR = 1.0f, pI = 0.0f;
    const size_t plane = static_cast<size_t>(p.P) * p.B;

    for (int i0 = 0; i0 < p.P; i0 += kMaxPulses) {
        const int n = min(kMaxPulses, p.P - i0);
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
            const epg::Rot r =
                epg::rot_coeffs_sc(sa, ca, ph.x, ph.y, ph.z, ph.w);
            float nFR, nFI, nZ;
            epg::rot_k0(r, FR, FI, Z, nFR, nFI, nZ);

            // echo at TE: T2 decay, off-resonance phase, demodulation
            float eR = nFR * e2te, eI = nFI * e2te;
            if (cdf) epg::cmul(pteR, pteI, eR, eI, eR, eI);
            if (p.demod) {
                const float dR = eR * ph.x + eI * ph.y;
                eI = eI * ph.x - eR * ph.y;
                eR = dR;
            }
            if (live) {
                const size_t o = static_cast<size_t>(i0 + t) * p.B + bi;
                p.out[o] = eR;
                p.out[plane + o] = eI;
            }

            // full-TR relaxation (no shift: the state stays at k = 0)
            if (!(fl & epg::kTrRepeats)) {
                cF = exp2f(k2 * mv.y);
                cZ = exp2f(k1 * mv.y);
                if (cdf) sincospif(DF2 * mv.y, &pI, &pR);
            }
            if (cdf) {
                FR = cF * (nFR * pR - nFI * pI);
                FI = cF * (nFI * pR + nFR * pI);
            } else {
                FR = cF * nFR;
                FI = cF * nFI;
            }
            Z = cZ * nZ + (1.0f - cZ);
        }
        __syncthreads();   // the table is read before the next chunk's
    }
}

}  // namespace

// Launch on `stream` of CUDA device `device`; allocates nothing.  Returns
// the CUDA error code of the launch (0 on success; cudaErrorInvalidValue
// for a `block` other than kBlock); the caller raises on anything else.
extern "C" int epg_bssfp(const float* fa, const float* phi, const float* tr,
                         const float* te, float te0, float ti,
                         const float* t1, const float* t2, const float* b1,
                         const float* df, float* out, int P, int B,
                         int var_te, int use_inv, int use_df, int demod,
                         int block, int device, void* stream) {
    BssfpArgs a{fa, phi, tr, te, te0, ti, t1, t2, b1, df, out, P, B,
                var_te, use_inv, use_df, demod};
    const cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (block != kBlock || P < 1 || B < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    const int grid = (B + block - 1) / block;
    bssfp_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(a);
    return static_cast<int>(cudaGetLastError());
}
