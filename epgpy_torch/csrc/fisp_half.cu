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
// What bounds it on the card: per atom per pulse the rotation and shift
// are ~1 kFLOP on the FP32 pipes plus a few precise transcendentals
// (sincosf of the flip, expf of the relaxation, sincosf of the df phase),
// ~1e11 FLOP for 102,400 atoms x 1000 pulses; the output is
// 2 * P * B * 4 bytes (819 MB there) and the inputs are a few (P,) and
// (B,) vectors.  So it is compute-bound.  The design: one thread per atom
// with the whole pulse loop inside the thread (the TPU's sequential
// pulse-chunk grid axis has no counterpart: blocks run in no order), the
// state in shared memory at [plane][row][threadIdx.x] (conflict-free, any
// runtime nstate, no barrier since a thread touches only its column),
// per-pulse scalars read by every thread of a warp at one address (a
// broadcast), and echo stores coalesced along atoms.  The ragged atom edge
// is masked; no padding atoms or pulses are simulated.  Math is precise
// (no fast-math): the error budget is against an f64 reference over
// 1000 pulses.
#include <cuda_runtime.h>

#include "epg_planes.cuh"

namespace {

constexpr float kDeg = 0.017453292519943295f;   // pi / 180
constexpr float kPi = 3.141592653589793f;
constexpr float kTwoPi = 6.283185307179586f;

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
    const float* dc;    // (B,) diffusivity (use_diff) or unused
    float bT, bL;       // transverse/longitudinal b-value bases (use_diff)
    float* out_re;      // (P, B)
    float* out_im;      // (P, B)
    int P, B, H;
    int var_te, use_inv, inv_df, use_df, demod, use_diff, diff_ramp;
};

__global__ void fisp_half_kernel(const FispArgs p) {
    extern __shared__ float smem[];
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= p.B) return;  // ragged edge; no barrier follows
    const int H = p.H;
    const epg::PlaneSet s{smem + threadIdx.x, H, static_cast<int>(blockDim.x)};

    const float T1 = p.t1[b];
    const float T2 = p.t2[b];
    const float B1 = p.b1[b];
    const float DF = p.use_df ? p.df[b] : 0.0f;

    for (int j = 0; j < 6; ++j)
        for (int k = 0; k < H; ++k) s.at(j, k) = 0.0f;
    if (p.use_inv) {
        // 180*B1 pulse about phi = 0, then TI relaxation; the folded
        // layout keeps A(0) = B(0) = F+(0)
        const float ai = kPi * B1;
        const float E1i = expf(-p.ti / T1);
        const float E2i = expf(-p.ti / T2);
        float sai, cai;
        sincosf(ai, &sai, &cai);
        const float fpi = -sai * E2i;
        if (p.use_df && p.inv_df) {
            float sth, cth;
            sincosf(kTwoPi * DF * p.ti, &sth, &cth);
            s.at(0, 0) = -fpi * sth;
            s.at(1, 0) = fpi * cth;
            s.at(2, 0) = -fpi * sth;
            s.at(3, 0) = fpi * cth;
        } else {
            s.at(1, 0) = fpi;
            s.at(3, 0) = fpi;
        }
        s.at(4, 0) = cai * E1i + 1.0f - E1i;
    } else {
        s.at(4, 0) = 1.0f;
    }

    float E1te = 0.0f, E2te = 0.0f;
    if (!p.var_te) {
        E1te = expf(-p.te0 / T1);
        E2te = expf(-p.te0 / T2);
    }

    for (int i = 0; i < p.P; ++i) {
        float te, e1te, e2te;
        if (p.var_te) {
            te = p.te[i];
            e1te = expf(-te / T1);
            e2te = expf(-te / T2);
        } else {
            te = p.te0;
            e1te = E1te;
            e2te = E2te;
        }
        const float ph = p.phi[i] * kDeg;
        float sp, cp, s2p, c2p;
        sincosf(ph, &sp, &cp);
        sincosf(2.0f * ph, &s2p, &c2p);
        const epg::Rot r = epg::rot_coeffs(p.fa[i] * B1 * kDeg, cp, sp, c2p, s2p);

        const float rem = p.tr[i] - te;
        const float E1b = expf(-rem / T1);
        const float E2b = expf(-rem / T2);
        const float cF = e2te * E2b;
        const float cZ = e1te * E1b;
        const float rec = (1.0f - e1te) * E1b + (1.0f - E1b);
        float pteR = 1.0f, pteI = 0.0f, cFr = cF, cFi = 0.0f;
        if (p.use_df) {
            sincosf(kTwoPi * DF * te, &pteI, &pteR);
            float pI, pR;
            sincosf(kTwoPi * DF * (te + rem), &pI, &pR);
            cFr = cF * pR;
            cFi = cF * pI;
        }

        epg::FoldedShift sh{s, 0.0f, 0.0f};
        for (int k = 0; k < H; ++k) {
            const float AR = s.at(0, k), AI = s.at(1, k);
            const float BR = s.at(2, k), BI = s.at(3, k);
            const float ZR = s.at(4, k), ZI = s.at(5, k);
            float rAR, rAI, rBR, rBI, rZR, rZI;
            epg::rot_A(r, AR, AI, BR, BI, ZR, ZI, rAR, rAI);
            epg::rot_B(r, AR, AI, BR, BI, ZR, ZI, rBR, rBI);
            epg::rot_Z(r, AR, AI, BR, BI, ZR, ZI, rZR, rZI);
            if (k == 0) {
                // echo from the k = 0 row after rotation and TE decay
                float eR = rAR * e2te, eI = rAI * e2te;
                if (p.use_df) epg::cmul(pteR, pteI, eR, eI, eR, eI);
                if (p.demod) {
                    const float dR = eR * cp + eI * sp;
                    eI = eI * cp - eR * sp;
                    eR = dR;
                }
                const size_t o = static_cast<size_t>(i) * p.B + b;
                p.out_re[o] = eR;
                p.out_im[o] = eI;
            }
            float nAR, nAI, nBR, nBI;
            if (p.use_df) {
                epg::cmul(cFr, cFi, rAR, rAI, nAR, nAI);
                epg::cmul(cFr, cFi, rBR, rBI, nBR, nBI);
            } else {
                nAR = cF * rAR;
                nAI = cF * rAI;
                nBR = cF * rBR;
                nBI = cF * rBI;
            }
            float nZR = cZ * rZR;
            if (k == 0) nZR = nZR + rec;
            sh.put(k, nAR, nAI, nBR, nBI, nZR, cZ * rZI);
        }
        sh.finish();

        if (p.use_diff) {
            // post-shift diffusion attenuation, per destination row
            const float Dc = p.dc[b];
            for (int k = 0; k < H; ++k) {
                const float kf = static_cast<float>(k);
                const float k2 = kf * kf;
                float aA, aB;
                if (p.diff_ramp) {
                    aA = expf(-(p.bT * (k2 - kf + 1.0f / 3.0f)) * Dc);
                    aB = expf(-(p.bT * (k2 + kf + 1.0f / 3.0f)) * Dc);
                } else {
                    aA = expf(-(p.bT * k2) * Dc);
                    aB = aA;
                }
                const float aZ = expf(-(p.bL * k2) * Dc);
                s.at(0, k) *= aA;
                s.at(1, k) *= aA;
                s.at(2, k) *= aB;
                s.at(3, k) *= aB;
                s.at(4, k) *= aZ;
                s.at(5, k) *= aZ;
            }
        }
    }
}

}  // namespace

// Launch on `stream` of CUDA device `device`; allocates nothing.  Returns
// the CUDA error code of the launch (0 on success); the caller raises on
// anything else.
extern "C" int epg_fisp_half(const float* fa, const float* phi,
                             const float* tr, const float* te, float te0,
                             float ti, const float* t1, const float* t2,
                             const float* b1, const float* df,
                             const float* dc, float bT, float bL,
                             float* out_re, float* out_im, int P, int B,
                             int nstate, int var_te, int use_inv, int inv_df,
                             int use_df, int demod, int use_diff,
                             int diff_ramp, int block, int device,
                             void* stream) {
    FispArgs a{fa, phi, tr, te, te0, ti, t1, t2, b1, df, dc, bT, bL,
               out_re, out_im, P, B, nstate + 1,
               var_te, use_inv, inv_df, use_df, demod, use_diff, diff_ramp};
    cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return static_cast<int>(e);
    const size_t smem = sizeof(float) * 6 * static_cast<size_t>(a.H) * block;
    if (smem > 48 * 1024) {
        e = cudaFuncSetAttribute(
            fisp_half_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (e != cudaSuccess) return static_cast<int>(e);
    }
    const int grid = (B + block - 1) / block;
    fisp_half_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(a);
    return static_cast<int>(cudaGetLastError());
}
