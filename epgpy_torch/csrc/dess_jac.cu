// dess_jac.cu -- DESS FISP and PSIF echoes and both echoes' dT1/dT2/dB1.
//
// Replaces the TPU kernel epgpy_tpu/models/pallas_dess.py:_kernel_dess_jac
// (:201), driven there by dess_jacobian_pallas (:377); the Python wrapper
// is epgpy_torch/models/cuda_dess.py:dess_jacobian_cuda and the plain
// PyTorch twin beside it (dess_jacobian_echoes_plain) computes the same
// recurrence with the same operation order.
//
// What it computes, per atom: the forward-mode derivative of dess.cu.
// Plane group 0 is the primal folded ladder, groups 1-3 its tangents
// w.r.t. T1, T2 and B1: 24 planes of H = nstate + 1 rows.  The coefficient
// tangents are sparse: T1 perturbs only cZ and the k = 0 recovery (drec =
// -dcZ), T2 only cF (the full-TR decay) and the FISP echo's TE decay, B1
// only the rotation coefficients (one extra rotation of the primal planes).
// Per TR both echoes of every group are written out: the FISP echo from the
// rotated k = 0 row, the PSIF echo from the relaxed B(1) row that becomes
// the new A(0) -- its dT2 includes the full-TR dcF term.  Output planes
// (8, 2P, B), re and im per group, rows in the train's ADC order FISP_0,
// PSIF_0, FISP_1, ...
//
// What bounds it on the card: the arithmetic, ~5x the primal's (four
// rotated groups plus the B1 coefficient pass per row), and the state, 24 x
// (nstate + 1) floats per atom (864 bytes at nstate 8).  The design is
// fisp_jac.cu's: one thread per atom runs the whole train, the planes sit
// in shared memory at [plane][row][threadIdx.x] (conflict-free, no barrier),
// one row walk serves every group (the primal row stays in registers while
// each tangent group is read, rotated, relaxed and handed to its shift),
// the ragged atom edge is masked and math is precise.  The price is
// occupancy, as for fisp_jac.cu: at 64 threads and nstate 8 a block holds
// 54 KB.
#include <cuda_runtime.h>

#include "epg_planes.cuh"

namespace {

constexpr float kDeg = 0.017453292519943295f;   // pi / 180
constexpr float kTwoPi = 6.283185307179586f;

struct DessJacArgs {
    const float* fa;    // (P,) flip angles, degrees
    const float* phi;   // (P,) RF phases, degrees
    const float* tr;    // (P,) full repetition times, ms
    const float* te;    // (P,) FISP echo times (var_te) or unused
    float te0;          // constant FISP echo time (!var_te)
    const float* t1;    // (B,)
    const float* t2;    // (B,)
    const float* b1;    // (B,)
    const float* df;    // (B,) off-resonance, kHz (use_df) or unused
    float* out;         // (8, 2P, B): (re, im) of primal, dT1, dT2, dB1
    int P, B, H;
    int var_te, use_df, demod;
};

__global__ void dess_jac_kernel(const DessJacArgs p) {
    extern __shared__ float smem[];
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= p.B) return;  // ragged edge; no barrier follows
    const int H = p.H;
    const int ld = static_cast<int>(blockDim.x);
    epg::PlaneSet s[4];
    for (int g = 0; g < 4; ++g)
        s[g] = epg::PlaneSet{smem + threadIdx.x + 6 * g * H * ld, H, ld};
    const bool cdf = p.use_df != 0;

    const float T1 = p.t1[b];
    const float T2 = p.t2[b];
    const float B1 = p.b1[b];
    const float DF = cdf ? p.df[b] : 0.0f;

    for (int g = 0; g < 4; ++g)
        for (int j = 0; j < 6; ++j)
            for (int k = 0; k < H; ++k) s[g].at(j, k) = 0.0f;
    s[0].at(4, 0) = 1.0f;

    float E2te = 0.0f, dE2te = 0.0f, pteR0 = 1.0f, pteI0 = 0.0f;
    if (!p.var_te) {
        E2te = expf(-p.te0 / T2);
        dE2te = E2te * p.te0 / (T2 * T2);
        if (cdf) sincosf(kTwoPi * DF * p.te0, &pteI0, &pteR0);
    }
    const size_t plane = 2 * static_cast<size_t>(p.P) * p.B;

    for (int i = 0; i < p.P; ++i) {
        float e2te = E2te, de2te = dE2te, pteR = pteR0, pteI = pteI0;
        if (p.var_te) {
            const float te = p.te[i];
            e2te = expf(-te / T2);
            de2te = e2te * te / (T2 * T2);
            if (cdf) sincosf(kTwoPi * DF * te, &pteI, &pteR);
        }
        const float fa = p.fa[i];
        const float ph = p.phi[i] * kDeg;
        float sp, cp, s2p, c2p, sa, ca;
        sincosf(ph, &sp, &cp);
        sincosf(2.0f * ph, &s2p, &c2p);
        sincosf(fa * B1 * kDeg, &sa, &ca);
        const epg::Rot r = epg::rot_coeffs_sc(sa, ca, cp, sp, c2p, s2p);
        const epg::Rot dr =
            epg::rot_coeffs_db1(sa, ca, fa * kDeg, cp, sp, c2p, s2p);

        const float TRi = p.tr[i];
        const float cF = expf(-TRi / T2);
        const float cZ = expf(-TRi / T1);
        const float rec = 1.0f - cZ;
        const float dcZ = cZ * TRi / (T1 * T1);
        const float dcF = cF * TRi / (T2 * T2);
        float cFr = cF, cFi = 0.0f, dcFr = dcF, dcFi = 0.0f;
        if (cdf) {
            float pI, pR;
            sincosf(kTwoPi * DF * TRi, &pI, &pR);
            cFr = cF * pR;
            cFi = cF * pI;
            dcFr = dcF * pR;
            dcFi = dcF * pI;
        }

        const size_t fisp = static_cast<size_t>(2 * i) * p.B + b;
        // echo of group o at row `at`: the TE phase (FISP only), demod
        auto write = [&](int o, size_t at, bool te_phase, float eR,
                         float eI) {
            if (cdf && te_phase) epg::cmul(pteR, pteI, eR, eI, eR, eI);
            if (p.demod) {
                const float dR = eR * cp + eI * sp;
                eI = eI * cp - eR * sp;
                eR = dR;
            }
            p.out[(2 * o) * plane + at] = eR;
            p.out[(2 * o + 1) * plane + at] = eI;
        };
        // the relaxed group handed to its shift; the PSIF echo of group o
        // is the relaxed B(1), the post-shift A(0)
        auto put = [&](epg::FoldedShift& sh, int o, int k, float nAR,
                       float nAI, float nBR, float nBI, float nZR,
                       float nZI) {
            sh.put(k, nAR, nAI, nBR, nBI, nZR, nZI);
            if (k == 1) write(o, fisp + p.B, false, nBR, nBI);
        };

        epg::FoldedShift sh[4];
        for (int g = 0; g < 4; ++g) sh[g] = epg::FoldedShift{s[g], 0.0f, 0.0f};
        for (int k = 0; k < H; ++k) {
            // primal: rotation, and the B1 coefficient pass over it
            const epg::Row x = epg::read_row(s[0], k);
            const epg::Row R = epg::rotate(r, x);
            const epg::Row C = epg::rotate(dr, x);
            if (k == 0) write(0, fisp, true, e2te * R.AR, e2te * R.AI);
            {
                float nAR, nAI, nBR, nBI;
                epg::fdecay(cdf, cFr, cFi, R.AR, R.AI, nAR, nAI);
                epg::fdecay(cdf, cFr, cFi, R.BR, R.BI, nBR, nBI);
                float nZR = cZ * R.ZR;
                if (k == 0) nZR = nZR + rec;
                put(sh[0], 0, k, nAR, nAI, nBR, nBI, nZR, cZ * R.ZI);
            }
            {   // dT1: only cZ and rec = 1 - cZ carry tangents
                const epg::Row t = epg::rotate(r, epg::read_row(s[1], k));
                if (k == 0) write(1, fisp, true, e2te * t.AR, e2te * t.AI);
                float nAR, nAI, nBR, nBI;
                epg::fdecay(cdf, cFr, cFi, t.AR, t.AI, nAR, nAI);
                epg::fdecay(cdf, cFr, cFi, t.BR, t.BI, nBR, nBI);
                float nZR = cZ * t.ZR + dcZ * R.ZR;
                if (k == 0) nZR = nZR - dcZ;
                put(sh[1], 1, k, nAR, nAI, nBR, nBI, nZR,
                    cZ * t.ZI + dcZ * R.ZI);
            }
            {   // dT2: only cF (and E2te on the FISP echo) carry tangents
                const epg::Row t = epg::rotate(r, epg::read_row(s[2], k));
                if (k == 0)
                    write(2, fisp, true, e2te * t.AR + de2te * R.AR,
                          e2te * t.AI + de2te * R.AI);
                float aR, aI, bR, bI, xaR, xaI, xbR, xbI;
                epg::fdecay(cdf, cFr, cFi, t.AR, t.AI, aR, aI);
                epg::fdecay(cdf, dcFr, dcFi, R.AR, R.AI, xaR, xaI);
                epg::fdecay(cdf, cFr, cFi, t.BR, t.BI, bR, bI);
                epg::fdecay(cdf, dcFr, dcFi, R.BR, R.BI, xbR, xbI);
                put(sh[2], 2, k, aR + xaR, aI + xaI, bR + xbR, bI + xbI,
                    cZ * t.ZR, cZ * t.ZI);
            }
            {   // dB1: only the rotation coefficients carry tangents
                const epg::Row t = epg::rotate(r, epg::read_row(s[3], k));
                if (k == 0)
                    write(3, fisp, true, e2te * (t.AR + C.AR),
                          e2te * (t.AI + C.AI));
                float nAR, nAI, nBR, nBI;
                epg::fdecay(cdf, cFr, cFi, t.AR + C.AR, t.AI + C.AI, nAR,
                            nAI);
                epg::fdecay(cdf, cFr, cFi, t.BR + C.BR, t.BI + C.BI, nBR,
                            nBI);
                put(sh[3], 3, k, nAR, nAI, nBR, nBI, cZ * (t.ZR + C.ZR),
                    cZ * (t.ZI + C.ZI));
            }
        }
        for (int g = 0; g < 4; ++g) sh[g].finish();
    }
}

}  // namespace

// Launch on `stream` of CUDA device `device`; allocates nothing.  Returns
// the CUDA error code of the launch (0 on success); the caller raises on
// anything else.
extern "C" int epg_dess_jac(const float* fa, const float* phi,
                            const float* tr, const float* te, float te0,
                            const float* t1, const float* t2,
                            const float* b1, const float* df, float* out,
                            int P, int B, int nstate, int var_te, int use_df,
                            int demod, int block, int device, void* stream) {
    DessJacArgs a{fa, phi, tr, te, te0, t1, t2, b1, df, out, P, B,
                  nstate + 1, var_te, use_df, demod};
    cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return static_cast<int>(e);
    const size_t smem =
        sizeof(float) * 24 * static_cast<size_t>(a.H) * block;
    if (smem > 48 * 1024) {
        e = cudaFuncSetAttribute(
            dess_jac_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (e != cudaSuccess) return static_cast<int>(e);
    }
    const int grid = (B + block - 1) / block;
    dess_jac_kernel<<<grid, block, smem,
                      static_cast<cudaStream_t>(stream)>>>(a);
    return static_cast<int>(cudaGetLastError());
}
