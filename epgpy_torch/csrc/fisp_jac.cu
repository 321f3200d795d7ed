// fisp_jac.cu -- FISP fingerprints and their dT1/dT2/dB1[/dD] tangents.
//
// Replaces the TPU kernel epgpy_tpu/models/pallas_fisp.py:_kernel_jac
// (:458), driven there by fisp_jacobian_pallas (:775); the Python wrapper
// is epgpy_torch/models/cuda_fisp.py:fisp_jacobian_cuda and the plain
// PyTorch twin beside it (fisp_jacobian_plain) computes the same recurrence
// with the same operation order.
//
// What it computes, per atom: the forward-mode derivative of fisp_half.cu.
// Plane group 0 is the primal folded ladder (A/B/Z re+im, H = nstate + 1
// rows); groups 1-3 are its tangents w.r.t. T1, T2 and B1, group 4 (with
// track_d) w.r.t. the diffusivity D: 24 planes, or 30.  The coefficient
// tangents are sparse: T1 perturbs only cZ and the k = 0 recovery
// rec = 1 - cZ (so drec = -dcZ), T2 only cF and the TE decay of the echo,
// B1 only the rotation coefficients (one extra rotation of the primal
// planes by the coefficient derivatives), D only the post-shift
// attenuation (x' = A(D) M x, so t' = A M t + A'(D) M x).  An inversion
// prep seeds its tangents in closed form.  Per pulse the k = 0 echo of
// every group is written out (2 + 2G outputs of (P, B), re and im).
//
// What bounds it on the card: per atom per pulse 4 (5) rotations of 11
// rows plus the B1 coefficient pass, ~5x the primal's arithmetic, and the
// state is 24 x 11 floats = 1,056 bytes per atom (1,320 with D), 4.5x the
// primal's.  The design is the primal's: one thread per atom runs the
// whole pulse loop, the planes sit in shared memory at
// [plane][row][threadIdx.x] (conflict-free, no barrier: a thread touches
// only its column), the ragged atom edge is masked, math is precise.  The
// price is occupancy: at 64 threads a block holds 67.5 KB, so an SM keeps
// 3 blocks (6 warps) resident, against 24 warps for the primal.  Per row
// the primal values stay in registers while each tangent group is read,
// rotated and written back, so one row walk serves every group.
#include <cuda_runtime.h>

#include "epg_planes.cuh"

namespace {

constexpr float kDeg = 0.017453292519943295f;   // pi / 180
constexpr float kPi = 3.141592653589793f;
constexpr float kTwoPi = 6.283185307179586f;

struct JacArgs {
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
    float* out;         // (2 + 2G, P, B): re, im, then (re, im) per tangent
    int P, B, H;
    int var_te, use_inv, inv_df, use_df, demod, use_diff, diff_ramp, track_d;
};

using epg::fdecay;
using epg::read_row;
using epg::rotate;
using epg::Row;

__global__ void fisp_jac_kernel(const JacArgs p) {
    extern __shared__ float smem[];
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= p.B) return;  // ragged edge; no barrier follows
    const int H = p.H;
    const int ld = static_cast<int>(blockDim.x);
    const int G = p.track_d ? 4 : 3;
    epg::PlaneSet s[5];
    for (int g = 0; g <= G; ++g)
        s[g] = epg::PlaneSet{smem + threadIdx.x + 6 * g * H * ld, H, ld};
    const bool cdf = p.use_df != 0;

    const float T1 = p.t1[b];
    const float T2 = p.t2[b];
    const float B1 = p.b1[b];
    const float DF = cdf ? p.df[b] : 0.0f;
    const float Dc = p.use_diff ? p.dc[b] : 0.0f;

    for (int g = 0; g <= G; ++g)
        for (int j = 0; j < 6; ++j)
            for (int k = 0; k < H; ++k) s[g].at(j, k) = 0.0f;
    if (p.use_inv) {
        // inversion prep and its (dT1, dT2, dB1) tangents, closed form
        const float ai = kPi * B1;
        float sai, cai;
        sincosf(ai, &sai, &cai);
        const float E1i = expf(-p.ti / T1);
        const float E2i = expf(-p.ti / T2);
        const float fpi = -sai * E2i;
        s[0].at(4, 0) = cai * E1i + 1.0f - E1i;
        const float dE1i = E1i * p.ti / (T1 * T1);
        const float dE2i = E2i * p.ti / (T2 * T2);
        s[1].at(4, 0) = (cai - 1.0f) * dE1i;
        const float dfpi = -sai * dE2i;
        const float bfpi = -cai * kPi * E2i;
        s[3].at(4, 0) = -sai * kPi * E1i;
        const int grp[3] = {0, 2, 3};
        const float val[3] = {fpi, dfpi, bfpi};
        if (cdf && p.inv_df) {
            // the TI precession multiplies the residual F+ and its
            // tangents by one parameter-independent phasor
            float sth, cth;
            sincosf(kTwoPi * DF * p.ti, &sth, &cth);
            for (int n = 0; n < 3; ++n) {
                s[grp[n]].at(0, 0) = -val[n] * sth;
                s[grp[n]].at(1, 0) = val[n] * cth;
                s[grp[n]].at(2, 0) = -val[n] * sth;
                s[grp[n]].at(3, 0) = val[n] * cth;
            }
        } else {
            for (int n = 0; n < 3; ++n) {
                s[grp[n]].at(1, 0) = val[n];
                s[grp[n]].at(3, 0) = val[n];
            }
        }
    } else {
        s[0].at(4, 0) = 1.0f;
    }

    float E1te = 0.0f, E2te = 0.0f, dE2te = 0.0f, pteR0 = 1.0f, pteI0 = 0.0f;
    if (!p.var_te) {
        E1te = expf(-p.te0 / T1);
        E2te = expf(-p.te0 / T2);
        dE2te = E2te * p.te0 / (T2 * T2);
        if (cdf) sincosf(kTwoPi * DF * p.te0, &pteI0, &pteR0);
    }
    const size_t plane = static_cast<size_t>(p.P) * p.B;

    for (int i = 0; i < p.P; ++i) {
        float te, e1te, e2te, de2te, pteR = pteR0, pteI = pteI0;
        if (p.var_te) {
            te = p.te[i];
            e1te = expf(-te / T1);
            e2te = expf(-te / T2);
            de2te = e2te * te / (T2 * T2);
            if (cdf) sincosf(kTwoPi * DF * te, &pteI, &pteR);
        } else {
            te = p.te0;
            e1te = E1te;
            e2te = E2te;
            de2te = dE2te;
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
        const float rem = TRi - te;
        const float E1b = expf(-rem / T1);
        const float E2b = expf(-rem / T2);
        const float cF = e2te * E2b;
        const float cZ = e1te * E1b;
        const float rec = 1.0f - cZ;  // == (1 - E1te) E1b + (1 - E1b)
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

        // echo of group o from its rotated k = 0 row: df phase, demod
        auto write = [&](int o, float eR, float eI) {
            if (cdf) epg::cmul(pteR, pteI, eR, eI, eR, eI);
            if (p.demod) {
                const float dR = eR * cp + eI * sp;
                eI = eI * cp - eR * sp;
                eR = dR;
            }
            const size_t at = static_cast<size_t>(i) * p.B + b;
            p.out[(2 * o) * plane + at] = eR;
            p.out[(2 * o + 1) * plane + at] = eI;
        };

        epg::FoldedShift sh[5];
        for (int g = 0; g <= G; ++g) sh[g] = epg::FoldedShift{s[g], 0.0f, 0.0f};
        for (int k = 0; k < H; ++k) {
            // primal: rotation, and the B1 coefficient pass over it
            const Row x = read_row(s[0], k);
            const Row R = rotate(r, x);
            const Row C = rotate(dr, x);
            if (k == 0) write(0, e2te * R.AR, e2te * R.AI);
            {
                float nAR, nAI, nBR, nBI;
                fdecay(cdf, cFr, cFi, R.AR, R.AI, nAR, nAI);
                fdecay(cdf, cFr, cFi, R.BR, R.BI, nBR, nBI);
                float nZR = cZ * R.ZR;
                if (k == 0) nZR = nZR + rec;
                sh[0].put(k, nAR, nAI, nBR, nBI, nZR, cZ * R.ZI);
            }
            {   // dT1: only cZ and rec = 1 - cZ carry tangents
                const Row t = rotate(r, read_row(s[1], k));
                if (k == 0) write(1, e2te * t.AR, e2te * t.AI);
                float nAR, nAI, nBR, nBI;
                fdecay(cdf, cFr, cFi, t.AR, t.AI, nAR, nAI);
                fdecay(cdf, cFr, cFi, t.BR, t.BI, nBR, nBI);
                float nZR = cZ * t.ZR + dcZ * R.ZR;
                if (k == 0) nZR = nZR - dcZ;
                sh[1].put(k, nAR, nAI, nBR, nBI, nZR, cZ * t.ZI + dcZ * R.ZI);
            }
            {   // dT2: only cF (and E2te on the echo) carry tangents
                const Row t = rotate(r, read_row(s[2], k));
                if (k == 0)
                    write(2, e2te * t.AR + de2te * R.AR,
                          e2te * t.AI + de2te * R.AI);
                float aR, aI, bR, bI, xaR, xaI, xbR, xbI;
                fdecay(cdf, cFr, cFi, t.AR, t.AI, aR, aI);
                fdecay(cdf, dcFr, dcFi, R.AR, R.AI, xaR, xaI);
                fdecay(cdf, cFr, cFi, t.BR, t.BI, bR, bI);
                fdecay(cdf, dcFr, dcFi, R.BR, R.BI, xbR, xbI);
                sh[2].put(k, aR + xaR, aI + xaI, bR + xbR, bI + xbI,
                          cZ * t.ZR, cZ * t.ZI);
            }
            {   // dB1: only the rotation coefficients carry tangents
                const Row t = rotate(r, read_row(s[3], k));
                if (k == 0)
                    write(3, e2te * (t.AR + C.AR), e2te * (t.AI + C.AI));
                float nAR, nAI, nBR, nBI;
                fdecay(cdf, cFr, cFi, t.AR + C.AR, t.AI + C.AI, nAR, nAI);
                fdecay(cdf, cFr, cFi, t.BR + C.BR, t.BI + C.BI, nBR, nBI);
                sh[3].put(k, nAR, nAI, nBR, nBI, cZ * (t.ZR + C.ZR),
                          cZ * (t.ZI + C.ZI));
            }
            if (p.track_d) {
                // dD: the attenuation's derivative enters after the shift
                const Row t = rotate(r, read_row(s[4], k));
                if (k == 0) write(4, e2te * t.AR, e2te * t.AI);
                float nAR, nAI, nBR, nBI;
                fdecay(cdf, cFr, cFi, t.AR, t.AI, nAR, nAI);
                fdecay(cdf, cFr, cFi, t.BR, t.BI, nBR, nBI);
                sh[4].put(k, nAR, nAI, nBR, nBI, cZ * t.ZR, cZ * t.ZI);
            }
        }
        for (int g = 0; g <= G; ++g) sh[g].finish();

        if (p.use_diff) {
            // post-shift diffusion attenuation, per destination row; the
            // dD group adds A'(D) times the shifted, unattenuated primal
            for (int k = 0; k < H; ++k) {
                const float kf = static_cast<float>(k);
                const float k2 = kf * kf;
                float fA, fB;
                if (p.diff_ramp) {
                    fA = p.bT * (k2 - kf + 1.0f / 3.0f);
                    fB = p.bT * (k2 + kf + 1.0f / 3.0f);
                } else {
                    fA = p.bT * k2;
                    fB = fA;
                }
                const float fZ = p.bL * k2;
                const float a[3] = {expf(-fA * Dc), expf(-fB * Dc),
                                    expf(-fZ * Dc)};
                for (int g = 1; g <= G; ++g)
                    for (int j = 0; j < 6; ++j) {
                        float v = s[g].at(j, k) * a[j / 2];
                        if (g == 4) {
                            const float f = j < 2 ? fA : (j < 4 ? fB : fZ);
                            v = v + (-f * a[j / 2]) * s[0].at(j, k);
                        }
                        s[g].at(j, k) = v;
                    }
                for (int j = 0; j < 6; ++j) s[0].at(j, k) *= a[j / 2];
            }
        }
    }
}

}  // namespace

// Launch on `stream` of CUDA device `device`; allocates nothing.  Returns
// the CUDA error code of the launch (0 on success); the caller raises on
// anything else.
extern "C" int epg_fisp_jac(const float* fa, const float* phi,
                            const float* tr, const float* te, float te0,
                            float ti, const float* t1, const float* t2,
                            const float* b1, const float* df,
                            const float* dc, float bT, float bL, float* out,
                            int P, int B, int nstate, int var_te, int use_inv,
                            int inv_df, int use_df, int demod, int use_diff,
                            int diff_ramp, int track_d, int block, int device,
                            void* stream) {
    JacArgs a{fa, phi, tr, te, te0, ti, t1, t2, b1, df, dc, bT, bL, out,
              P, B, nstate + 1, var_te, use_inv, inv_df, use_df, demod,
              use_diff, diff_ramp, track_d};
    cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return static_cast<int>(e);
    const size_t planes = track_d ? 30 : 24;
    const size_t smem =
        sizeof(float) * planes * static_cast<size_t>(a.H) * block;
    if (smem > 48 * 1024) {
        e = cudaFuncSetAttribute(
            fisp_jac_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (e != cudaSuccess) return static_cast<int>(e);
    }
    const int grid = (B + block - 1) / block;
    fisp_jac_kernel<<<grid, block, smem,
                      static_cast<cudaStream_t>(stream)>>>(a);
    return static_cast<int>(cudaGetLastError());
}
