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
// What bounds it on the card: per atom per TR the rotation of H rows (~70
// FP32 operations each) and the precise transcendentals; at nstate 8 and
// 262,144 atoms x 48 TRs ~8e9 operations (0.12 ms at the FP32 peak)
// against 4 * 48 * 262,144 * 4 bytes out (0.06 ms at 3.35 TB/s): it is
// compute-bound.  The design is fisp_half.cu's: one thread per atom runs
// the whole train, the planes sit in shared memory at
// [plane][row][threadIdx.x] (conflict-free, no barrier: a thread touches
// only its column), the shift is a row walk (epg::FoldedShift) that hands
// the PSIF echo over as it writes row 0 of A, the per-TR scalars are read
// by every thread of a warp at one address, and the echo stores coalesce
// along atoms.  The ragged atom edge is masked; math is precise.
#include <cuda_runtime.h>

#include "epg_planes.cuh"

namespace {

constexpr float kDeg = 0.017453292519943295f;   // pi / 180
constexpr float kTwoPi = 6.283185307179586f;

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

__global__ void dess_kernel(const DessArgs p) {
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

    float E2te = 0.0f, pteR0 = 1.0f, pteI0 = 0.0f;
    if (!p.var_te) {
        E2te = expf(-p.te0 / T2);
        if (cdf) sincosf(kTwoPi * DF * p.te0, &pteI0, &pteR0);
    }
    const size_t plane = 2 * static_cast<size_t>(p.P) * p.B;

    for (int i = 0; i < p.P; ++i) {
        float e2te = E2te, pteR = pteR0, pteI = pteI0;
        if (p.var_te) {
            const float te = p.te[i];
            e2te = expf(-te / T2);
            if (cdf) sincosf(kTwoPi * DF * te, &pteI, &pteR);
        }
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

        auto demod_store = [&](size_t o, float eR, float eI) {
            if (p.demod) {
                const float dR = eR * cp + eI * sp;
                eI = eI * cp - eR * sp;
                eR = dR;
            }
            p.out[o] = eR;
            p.out[plane + o] = eI;
        };
        const size_t fisp = static_cast<size_t>(2 * i) * p.B + b;

        epg::FoldedShift sh{s, 0.0f, 0.0f};
        for (int k = 0; k < H; ++k) {
            const epg::Row R = epg::rotate(r, epg::read_row(s, k));
            if (k == 0) {
                // FISP echo: the rotated k = 0 row after the TE decay
                float eR = R.AR * e2te, eI = R.AI * e2te;
                if (cdf) epg::cmul(pteR, pteI, eR, eI, eR, eI);
                demod_store(fisp, eR, eI);
            }
            float nAR, nAI, nBR, nBI;
            epg::fdecay(cdf, cFr, cFi, R.AR, R.AI, nAR, nAI);
            epg::fdecay(cdf, cFr, cFi, R.BR, R.BI, nBR, nBI);
            float nZR = cZ * R.ZR;
            if (k == 0) nZR = nZR + rec;
            sh.put(k, nAR, nAI, nBR, nBI, nZR, cZ * R.ZI);
            // PSIF echo: the post-shift A(0), which put() takes from B(1)
            if (k == 1) demod_store(fisp + p.B, nBR, nBI);
        }
        sh.finish();
    }
}

}  // namespace

// Launch on `stream` of CUDA device `device`; allocates nothing.  Returns
// the CUDA error code of the launch (0 on success); the caller raises on
// anything else.
extern "C" int epg_dess(const float* fa, const float* phi, const float* tr,
                        const float* te, float te0, const float* t1,
                        const float* t2, const float* b1, const float* df,
                        float* out, int P, int B, int nstate, int var_te,
                        int use_df, int demod, int block, int device,
                        void* stream) {
    DessArgs a{fa, phi, tr, te, te0, t1, t2, b1, df, out, P, B, nstate + 1,
               var_te, use_df, demod};
    cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return static_cast<int>(e);
    const size_t smem = sizeof(float) * 6 * static_cast<size_t>(a.H) * block;
    if (smem > 48 * 1024) {
        e = cudaFuncSetAttribute(
            dess_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (e != cudaSuccess) return static_cast<int>(e);
    }
    const int grid = (B + block - 1) / block;
    dess_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(a);
    return static_cast<int>(cudaGetLastError());
}
