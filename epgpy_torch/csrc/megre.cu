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
// k = 0 row decayed by exp(-te_ji / T2) and phased by 2 pi df te_ji (the
// cumulative echo times come as an (m, P) matrix), optionally demodulated
// by phi_i; then the rows relax over the full TR_i (k-independent
// relaxation commutes with everything between the pulse and the shift, so
// the echo spacing never enters the carried state) and shift by one
// through the centre.  The output is written in the train's ADC order,
// row i m + j: planes (2, m P, B), the engine's layout with no reorder
// pass.
//
// What bounds it on the card: per atom per TR the rotation of H rows (~70
// FP32 operations each) plus m echoes (an expf and, with df, a sincosf
// each); at nstate 8, m 3, 262,144 atoms x 200 TRs ~4e10 operations
// (0.6 ms at the FP32 peak) against 2 * 600 * 262,144 * 4 bytes out (0.4 ms
// at 3.35 TB/s): compute-bound, near the balance point.  The design is
// fisp_half.cu's: one thread per atom runs the whole train, the planes
// sit in shared memory at [plane][row][threadIdx.x] (conflict-free, no
// barrier: a thread touches only its column), the shift is a row walk
// (epg::FoldedShift), the per-TR scalars are read by every thread of a
// warp at one address, and each echo store coalesces along atoms.  The
// ragged atom edge is masked; math is precise.
#include <cuda_runtime.h>

#include "epg_planes.cuh"

namespace {

constexpr float kDeg = 0.017453292519943295f;   // pi / 180
constexpr float kTwoPi = 6.283185307179586f;

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

__global__ void megre_kernel(const MegreArgs p) {
    extern __shared__ float smem[];
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= p.B) return;  // ragged edge; no barrier follows
    const int H = p.H;
    const epg::PlaneSet s{smem + threadIdx.x, H, static_cast<int>(blockDim.x)};
    const bool cdf = p.use_df != 0;

    const float T1 = p.t1[b];
    const float T2 = p.t2[b];
    const float B1 = p.b1[b];
    const float DF = cdf ? p.df[b] : 0.0f;

    for (int j = 0; j < 6; ++j)
        for (int k = 0; k < H; ++k) s.at(j, k) = 0.0f;
    s.at(4, 0) = 1.0f;

    const size_t plane = static_cast<size_t>(p.m) * p.P * p.B;

    for (int i = 0; i < p.P; ++i) {
        const float ph = p.phi[i] * kDeg;
        float sp, cp, s2p, c2p;
        sincosf(ph, &sp, &cp);
        sincosf(2.0f * ph, &s2p, &c2p);
        const epg::Rot r =
            epg::rot_coeffs(p.fa[i] * B1 * kDeg, cp, sp, c2p, s2p);

        const float TRi = p.tr[i];
        const float cF = expf(-TRi / T2);
        const float cZ = expf(-TRi / T1);
        const float rec = 1.0f - cZ;
        float cFr = cF, cFi = 0.0f;
        if (cdf) {
            float pI, pR;
            sincosf(kTwoPi * DF * TRi, &pI, &pR);
            cFr = cF * pR;
            cFi = cF * pI;
        }

        epg::FoldedShift sh{s, 0.0f, 0.0f};
        for (int k = 0; k < H; ++k) {
            const epg::Row R = epg::rotate(r, epg::read_row(s, k));
            if (k == 0) {
                // m echoes: copies of the rotated k = 0 row, each decayed
                // and phased to its own echo time
                for (int j = 0; j < p.m; ++j) {
                    const float te = p.te[static_cast<size_t>(j) * p.P + i];
                    const float e2te = expf(-te / T2);
                    float eR = e2te * R.AR, eI = e2te * R.AI;
                    if (cdf) {
                        float sI, sR;
                        sincosf(kTwoPi * DF * te, &sI, &sR);
                        epg::cmul(sR, sI, eR, eI, eR, eI);
                    }
                    if (p.demod) {
                        const float dR = eR * cp + eI * sp;
                        eI = eI * cp - eR * sp;
                        eR = dR;
                    }
                    const size_t o =
                        (static_cast<size_t>(i) * p.m + j) * p.B + b;
                    p.out[o] = eR;
                    p.out[plane + o] = eI;
                }
            }
            float nAR, nAI, nBR, nBI;
            epg::fdecay(cdf, cFr, cFi, R.AR, R.AI, nAR, nAI);
            epg::fdecay(cdf, cFr, cFi, R.BR, R.BI, nBR, nBI);
            float nZR = cZ * R.ZR;
            if (k == 0) nZR = nZR + rec;
            sh.put(k, nAR, nAI, nBR, nBI, nZR, cZ * R.ZI);
        }
        sh.finish();
    }
}

}  // namespace

// Launch on `stream` of CUDA device `device`; allocates nothing.  Returns
// the CUDA error code of the launch (0 on success); the caller raises on
// anything else.
extern "C" int epg_megre(const float* fa, const float* phi, const float* tr,
                         const float* te, const float* t1, const float* t2,
                         const float* b1, const float* df, float* out, int P,
                         int B, int m, int nstate, int use_df, int demod,
                         int block, int device, void* stream) {
    MegreArgs a{fa, phi, tr, te, t1, t2, b1, df, out, P, B, nstate + 1, m,
                use_df, demod};
    cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return static_cast<int>(e);
    const size_t smem = sizeof(float) * 6 * static_cast<size_t>(a.H) * block;
    if (smem > 48 * 1024) {
        e = cudaFuncSetAttribute(
            megre_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (e != cudaSuccess) return static_cast<int>(e);
    }
    const int grid = (B + block - 1) / block;
    megre_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(a);
    return static_cast<int>(cudaGetLastError());
}
