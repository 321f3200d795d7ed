// megre_jac.cu -- ME-GRE echoes and their dT1/dT2/dB1/ddf tangents.
//
// Replaces the TPU kernel epgpy_tpu/models/pallas_megre.py:_kernel_megre_jac
// (:220), driven there by megre_jacobian_pallas (:391); the Python wrapper
// is epgpy_torch/models/cuda_megre.py:megre_jacobian_cuda and the plain
// PyTorch twin beside it (megre_jacobian_echoes_plain) computes the same
// recurrence with the same operation order.
//
// What it computes, per atom: the forward-mode derivative of megre.cu.
// Plane group 0 is the primal folded ladder, groups 1-4 its tangents
// w.r.t. T1, T2, B1 and the off-resonance df: 30 planes of H = nstate + 1
// rows.  The coefficient tangents are sparse: T1 perturbs only cZ and the
// k = 0 recovery (drec = -dcZ), T2 only the full-TR cF and each echo's TE
// decay, B1 only the rotation coefficients (one extra rotation of the
// primal planes), df only the phasors -- d/ddf e^{i 2 pi df t} = i 2 pi t
// e^{i 2 pi df t}, with t = te_j on echo j and t = TR on the carried F
// planes.  The df group is carried whether or not a df is given: at df = 0
// its F coefficient i 2 pi TR cF is not zero, so the df column is exact
// where a B0 fit starts.  Per TR every group writes m echoes from its
// rotated k = 0 row: output planes (10, m P, B), (re, im) per group, rows
// in the train's ADC order i m + j.
//
// What bounds it on the card: the arithmetic, ~6x the primal's (five
// rotated groups plus the B1 coefficient pass per row), and the state, 30 x
// (nstate + 1) floats per atom (1080 bytes at nstate 8); the output is 5x
// the primal's (6.3 GB at 262,144 atoms x 200 TRs x 3 echoes).  The design
// is dess_jac.cu's: one thread per atom runs the whole train, the planes
// sit in shared memory at [plane][row][threadIdx.x] (conflict-free, no
// barrier), one row walk serves every group, each group's relaxed row goes
// to its own folded shift, the ragged atom edge is masked and math is
// precise.  The price is occupancy: at 64 threads and nstate 8 a block
// holds 67.5 KB.
#include <cuda_runtime.h>

#include "epg_planes.cuh"

namespace {

constexpr float kDeg = 0.017453292519943295f;   // pi / 180
constexpr float kTwoPi = 6.283185307179586f;

struct MegreJacArgs {
    const float* fa;    // (P,) flip angles, degrees
    const float* phi;   // (P,) RF phases, degrees
    const float* tr;    // (P,) full repetition times, ms
    const float* te;    // (m, P) cumulative echo times, ms
    const float* t1;    // (B,)
    const float* t2;    // (B,)
    const float* b1;    // (B,)
    const float* df;    // (B,) off-resonance, kHz (use_df) or unused
    float* out;         // (10, m P, B): (re, im) of primal, dT1, dT2, dB1, ddf
    int P, B, H, m;
    int use_df, demod;
};

__global__ void megre_jac_kernel(const MegreJacArgs p) {
    extern __shared__ float smem[];
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= p.B) return;  // ragged edge; no barrier follows
    const int H = p.H;
    const int ld = static_cast<int>(blockDim.x);
    epg::PlaneSet s[5];
    for (int g = 0; g < 5; ++g)
        s[g] = epg::PlaneSet{smem + threadIdx.x + 6 * g * H * ld, H, ld};
    const bool cdf = p.use_df != 0;

    const float T1 = p.t1[b];
    const float T2 = p.t2[b];
    const float B1 = p.b1[b];
    const float DF = cdf ? p.df[b] : 0.0f;

    for (int g = 0; g < 5; ++g)
        for (int j = 0; j < 6; ++j)
            for (int k = 0; k < H; ++k) s[g].at(j, k) = 0.0f;
    s[0].at(4, 0) = 1.0f;

    const size_t plane = static_cast<size_t>(p.m) * p.P * p.B;

    for (int i = 0; i < p.P; ++i) {
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
        // d/ddf of the carried F coefficient: i 2 pi TR (cFr + i cFi)
        const float w = kTwoPi * TRi;
        const float fFr = -w * cFi;
        const float fFi = w * cFr;

        // echo o of row `row`: demodulation, then the store
        auto write = [&](int o, size_t row, float eR, float eI) {
            if (p.demod) {
                const float dR = eR * cp + eI * sp;
                eI = eI * cp - eR * sp;
                eR = dR;
            }
            const size_t at = row * p.B + b;
            p.out[(2 * o) * plane + at] = eR;
            p.out[(2 * o + 1) * plane + at] = eI;
        };

        epg::FoldedShift sh[5];
        for (int g = 0; g < 5; ++g) sh[g] = epg::FoldedShift{s[g], 0.0f, 0.0f};
        for (int k = 0; k < H; ++k) {
            // every group's row, rotated; the B1 coefficient pass over the
            // primal
            const epg::Row x = epg::read_row(s[0], k);
            const epg::Row R = epg::rotate(r, x);
            const epg::Row C = epg::rotate(dr, x);
            const epg::Row t1 = epg::rotate(r, epg::read_row(s[1], k));
            const epg::Row t2 = epg::rotate(r, epg::read_row(s[2], k));
            const epg::Row t3 = epg::rotate(r, epg::read_row(s[3], k));
            const epg::Row t4 = epg::rotate(r, epg::read_row(s[4], k));
            if (k == 0) {
                for (int j = 0; j < p.m; ++j) {
                    const float te = p.te[static_cast<size_t>(j) * p.P + i];
                    const float e2te = expf(-te / T2);
                    const float de2te = e2te * te / (T2 * T2);
                    float c = 1.0f, sn = 0.0f;
                    if (cdf) sincosf(kTwoPi * DF * te, &sn, &c);
                    // the echo's df phasor
                    auto phase = [&](float re, float im, float& oR,
                                     float& oI) {
                        if (cdf) {
                            epg::cmul(c, sn, re, im, oR, oI);
                        } else {
                            oR = re;
                            oI = im;
                        }
                    };
                    const size_t row = static_cast<size_t>(i) * p.m + j;
                    float pR, pI, eR, eI;
                    phase(e2te * R.AR, e2te * R.AI, pR, pI);
                    write(0, row, pR, pI);
                    phase(e2te * t1.AR, e2te * t1.AI, eR, eI);
                    write(1, row, eR, eI);
                    // dT2: the tangent state and the TE decay's derivative
                    phase(e2te * t2.AR + de2te * R.AR,
                          e2te * t2.AI + de2te * R.AI, eR, eI);
                    write(2, row, eR, eI);
                    // dB1: the tangent state and the coefficient pass
                    phase(e2te * (t3.AR + C.AR), e2te * (t3.AI + C.AI), eR,
                          eI);
                    write(3, row, eR, eI);
                    // ddf: the tangent state and i 2 pi te x the primal
                    phase(e2te * t4.AR, e2te * t4.AI, eR, eI);
                    const float we = kTwoPi * te;
                    write(4, row, eR + -we * pI, eI + we * pR);
                }
            }
            {   // primal
                float nAR, nAI, nBR, nBI;
                epg::fdecay(cdf, cFr, cFi, R.AR, R.AI, nAR, nAI);
                epg::fdecay(cdf, cFr, cFi, R.BR, R.BI, nBR, nBI);
                float nZR = cZ * R.ZR;
                if (k == 0) nZR = nZR + rec;
                sh[0].put(k, nAR, nAI, nBR, nBI, nZR, cZ * R.ZI);
            }
            {   // dT1: only cZ and rec = 1 - cZ carry tangents
                float nAR, nAI, nBR, nBI;
                epg::fdecay(cdf, cFr, cFi, t1.AR, t1.AI, nAR, nAI);
                epg::fdecay(cdf, cFr, cFi, t1.BR, t1.BI, nBR, nBI);
                float nZR = cZ * t1.ZR + dcZ * R.ZR;
                if (k == 0) nZR = nZR - dcZ;
                sh[1].put(k, nAR, nAI, nBR, nBI, nZR, cZ * t1.ZI + dcZ * R.ZI);
            }
            {   // dT2: only cF carries a tangent here
                float aR, aI, bR, bI, xaR, xaI, xbR, xbI;
                epg::fdecay(cdf, cFr, cFi, t2.AR, t2.AI, aR, aI);
                epg::fdecay(cdf, dcFr, dcFi, R.AR, R.AI, xaR, xaI);
                epg::fdecay(cdf, cFr, cFi, t2.BR, t2.BI, bR, bI);
                epg::fdecay(cdf, dcFr, dcFi, R.BR, R.BI, xbR, xbI);
                sh[2].put(k, aR + xaR, aI + xaI, bR + xbR, bI + xbI,
                          cZ * t2.ZR, cZ * t2.ZI);
            }
            {   // dB1: only the rotation coefficients carry tangents
                float nAR, nAI, nBR, nBI;
                epg::fdecay(cdf, cFr, cFi, t3.AR + C.AR, t3.AI + C.AI, nAR,
                            nAI);
                epg::fdecay(cdf, cFr, cFi, t3.BR + C.BR, t3.BI + C.BI, nBR,
                            nBI);
                sh[3].put(k, nAR, nAI, nBR, nBI, cZ * (t3.ZR + C.ZR),
                          cZ * (t3.ZI + C.ZI));
            }
            {   // ddf: the tangent through the primal coefficient and the
                // phasor's derivative on the primal F planes (Z carries no
                // off-resonance)
                float aR, aI, bR, bI, yaR, yaI, ybR, ybI;
                epg::fdecay(cdf, cFr, cFi, t4.AR, t4.AI, aR, aI);
                epg::fdecay(cdf, cFr, cFi, t4.BR, t4.BI, bR, bI);
                epg::cmul(fFr, fFi, R.AR, R.AI, yaR, yaI);
                epg::cmul(fFr, fFi, R.BR, R.BI, ybR, ybI);
                sh[4].put(k, aR + yaR, aI + yaI, bR + ybR, bI + ybI,
                          cZ * t4.ZR, cZ * t4.ZI);
            }
        }
        for (int g = 0; g < 5; ++g) sh[g].finish();
    }
}

}  // namespace

// Launch on `stream` of CUDA device `device`; allocates nothing.  Returns
// the CUDA error code of the launch (0 on success); the caller raises on
// anything else.
extern "C" int epg_megre_jac(const float* fa, const float* phi,
                             const float* tr, const float* te,
                             const float* t1, const float* t2,
                             const float* b1, const float* df, float* out,
                             int P, int B, int m, int nstate, int use_df,
                             int demod, int block, int device, void* stream) {
    MegreJacArgs a{fa, phi, tr, te, t1, t2, b1, df, out, P, B, nstate + 1, m,
                   use_df, demod};
    cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return static_cast<int>(e);
    const size_t smem =
        sizeof(float) * 30 * static_cast<size_t>(a.H) * block;
    if (smem > 48 * 1024) {
        e = cudaFuncSetAttribute(
            megre_jac_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (e != cudaSuccess) return static_cast<int>(e);
    }
    const int grid = (B + block - 1) / block;
    megre_jac_kernel<<<grid, block, smem,
                       static_cast<cudaStream_t>(stream)>>>(a);
    return static_cast<int>(cudaGetLastError());
}
