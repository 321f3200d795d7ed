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
// plus the precise transcendentals (sincosf of the phase, the doubled phase
// and the flip, expf of the TR decays, two df phasors): ~5e9 operations
// there, of the same order as the bytes' time, with the transcendentals'
// many instructions each on top.  The design: one thread per atom keeps the
// three state floats in registers across the whole train (no shared
// memory, no barrier), reads the per-pulse table through the read-only
// path (every thread of a warp reads the same word: a broadcast), and
// stores each pulse's echo coalesced along atoms, so the bytes leave at the
// rate of one 128-byte line per warp and pulse.  The TE decay and TE phasor
// are hoisted when TE is constant.  The ragged atom edge is masked; math is
// precise (no fast-math): the error budget is against an f64 reference.
#include <cuda_runtime.h>

#include "epg_planes.cuh"

namespace {

constexpr float kDeg = 0.017453292519943295f;   // pi / 180
constexpr float kPi = 3.141592653589793f;
constexpr float kTwoPi = 6.283185307179586f;

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

__global__ void bssfp_kernel(const BssfpArgs p) {
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= p.B) return;  // ragged edge; no barrier follows
    const float T1 = p.t1[b];
    const float T2 = p.t2[b];
    const float B1 = p.b1[b];
    const bool cdf = p.use_df != 0;
    const float DF = cdf ? p.df[b] : 0.0f;

    float FR = 0.0f, FI = 0.0f, Z = 1.0f;
    if (p.use_inv) {
        // 180*B1 pulse about phi = 0, then TI relaxation and precession
        float sai, cai;
        sincosf(kPi * B1, &sai, &cai);
        const float E1i = expf(-p.ti / T1);
        const float E2i = expf(-p.ti / T2);
        const float fpi = -sai * E2i;
        if (cdf) {
            float si, ci;
            sincosf(kTwoPi * DF * p.ti, &si, &ci);
            FR = -fpi * si;
            FI = fpi * ci;
        } else {
            FI = fpi;
        }
        Z = cai * E1i + 1.0f - E1i;
    }

    float E2te = 0.0f, pteR0 = 1.0f, pteI0 = 0.0f;
    if (!p.var_te) {
        E2te = expf(-p.te0 / T2);
        if (cdf) sincosf(kTwoPi * DF * p.te0, &pteI0, &pteR0);
    }
    const size_t plane = static_cast<size_t>(p.P) * p.B;

    for (int i = 0; i < p.P; ++i) {
        float e2te = E2te, pteR = pteR0, pteI = pteI0;
        if (p.var_te) {
            const float te = __ldg(p.te + i);
            e2te = expf(-te / T2);
            if (cdf) sincosf(kTwoPi * DF * te, &pteI, &pteR);
        }
        const float ph = __ldg(p.phi + i) * kDeg;
        float sp, cp, s2p, c2p;
        sincosf(ph, &sp, &cp);
        sincosf(2.0f * ph, &s2p, &c2p);
        const epg::Rot r =
            epg::rot_coeffs(__ldg(p.fa + i) * B1 * kDeg, cp, sp, c2p, s2p);
        float nFR, nFI, nZ;
        epg::rot_k0(r, FR, FI, Z, nFR, nFI, nZ);

        // echo at TE: T2 decay, off-resonance phase, demodulation
        float eR = nFR * e2te, eI = nFI * e2te;
        if (cdf) epg::cmul(pteR, pteI, eR, eI, eR, eI);
        if (p.demod) {
            const float dR = eR * cp + eI * sp;
            eI = eI * cp - eR * sp;
            eR = dR;
        }
        const size_t o = static_cast<size_t>(i) * p.B + b;
        p.out[o] = eR;
        p.out[plane + o] = eI;

        // full-TR relaxation (no shift: the state stays at k = 0)
        const float TRi = __ldg(p.tr + i);
        const float cF = expf(-TRi / T2);
        const float cZ = expf(-TRi / T1);
        if (cdf) {
            float pI, pR;
            sincosf(kTwoPi * DF * TRi, &pI, &pR);
            FR = cF * (nFR * pR - nFI * pI);
            FI = cF * (nFI * pR + nFR * pI);
        } else {
            FR = cF * nFR;
            FI = cF * nFI;
        }
        Z = cZ * nZ + (1.0f - cZ);
    }
}

}  // namespace

// Launch on `stream` of CUDA device `device`; allocates nothing.  Returns
// the CUDA error code of the launch (0 on success); the caller raises on
// anything else.
extern "C" int epg_bssfp(const float* fa, const float* phi, const float* tr,
                         const float* te, float te0, float ti,
                         const float* t1, const float* t2, const float* b1,
                         const float* df, float* out, int P, int B,
                         int var_te, int use_inv, int use_df, int demod,
                         int block, int device, void* stream) {
    BssfpArgs a{fa, phi, tr, te, te0, ti, t1, t2, b1, df, out, P, B,
                var_te, use_inv, use_df, demod};
    cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return static_cast<int>(e);
    const int grid = (B + block - 1) / block;
    bssfp_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(a);
    return static_cast<int>(cudaGetLastError());
}
