// composite_jac.cu -- composite-GRE stage trains and their selected T1, T2,
// B1 and df tangents.
//
// Replaces the TPU kernel epgpy_tpu/models/pallas_composite.py:
// _kernel_comp_jac (:364, with its helper _shift_sel :334), driven there by
// composite_jacobian_pallas (:579); the Python wrapper is
// epgpy_torch/models/cuda_composite.py:composite_jacobian_cuda and the
// plain PyTorch twin beside it (composite_jacobian_plain) computes the same
// recurrence with the same operation order.
//
// What it computes, per atom: the forward-mode derivative of composite.cu
// for the tangent groups the 4-bit mask selects (bit 0 T1, 1 T2, 2 B1,
// 3 df).  Plane group 0 is the primal folded ladder, then one group of six
// planes per selected tangent, in that order: 6 (1 + ng) planes of
// H = nstate + 1 rows, so an unselected group costs no shared memory.  Every
// op of a stage is affine in the state, so a tangent goes through the
// primal's operator plus the derivative of its coefficients applied to the
// primal: T1 perturbs cZ and the k = 0 recovery (drec = -dcZ), T2 the
// carried cF and the echo's ta decay, B1 the rotation coefficients (one
// more rotation of the primal rows, da = fa b1u pi/180: adiabatic stages
// drop out), df the phasors -- i 2 pi t times the primal, t = ta on the
// echo and ta + tb on the carried F planes, computed whether or not a df
// is given so the df column is exact at df = 0.  The stage's shift and its
// D attenuation are parameter-free and apply to every group alike.  Output
// planes (2 + 2 ng, nadc, B): (re, im) per group, rows in ADC order.
//
// What bounds it on the card: the arithmetic, (1 + ng) rotated groups per
// row plus the B1 coefficient pass, and the state, 6 (1 + ng) (nstate + 1)
// floats per atom (1080 bytes at nstate 8 with all four groups).  The
// design is megre_jac.cu's: one thread per atom runs the whole train, the
// planes sit in shared memory at [plane][row][threadIdx.x] (conflict-free,
// no barrier), one row walk serves every group (each group reads, rotates
// and puts its own row into its own epg::StageShift, so only the primal's
// rotated row is held across groups), the stage tables are broadcast reads
// from global memory and every branch on a stage or on the mask is uniform
// across the block.  The ragged atom edge is masked; math is precise.
#include <cuda_runtime.h>

#include "epg_planes.cuh"

namespace {

constexpr float kDeg = 0.017453292519943295f;   // pi / 180
constexpr float kTwoPi = 6.283185307179586f;

struct CompJacArgs {
    const float* fa;    // (N,) flip angles, degrees
    const float* phi;   // (N,) RF phases, degrees
    const float* ta;    // (N,) relaxation before the readout, ms
    const float* tb;    // (N,) relaxation after the readout, ms
    const int* adci;    // (N,) output row, -1 = no readout
    const int* shift;   // (N,) shift direction in {-1, 0, +1}
    const float* aph;   // (N,) ADC phase, radians (use_adcph)
    const float* b1u;   // (N,) B1 sensitivity (use_b1u)
    const float* btd;   // (N,) b-value base per squared state index (use_d)
    const float* rdir;  // (N,) ramp direction in {-1, 0, +1} (use_d)
    const float* t1;    // (B,)
    const float* t2;    // (B,)
    const float* b1;    // (B,)
    const float* df;    // (B,) off-resonance, kHz (use_df) or unused
    const float* dc;    // (B,) diffusivity, mm^2/s (use_d) or unused
    float* out;         // (2 + 2 ng, nadc, B): (re, im) per group
    int N, B, H, nadc, mask;
    int use_df, use_up, use_down, use_adcph, use_b1u, use_d;
};

__global__ void composite_jac_kernel(const CompJacArgs p) {
    extern __shared__ float smem[];
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= p.B) return;  // ragged edge; no barrier follows
    const int H = p.H;
    const int ld = static_cast<int>(blockDim.x);
    // the plane group of each selected tangent (T1, T2, B1, df), 0 when
    // not selected; groups are packed after the primal in that order
    int slot[4];
    int ng = 0;
    for (int g = 0; g < 4; ++g) slot[g] = (p.mask >> g) & 1 ? ++ng : 0;
    auto set = [&](int g) {
        return epg::PlaneSet{smem + threadIdx.x + 6 * g * H * ld, H, ld};
    };
    const epg::PlaneSet P = set(0);
    const bool cdf = p.use_df != 0;

    const float T1 = p.t1[b];
    const float T2 = p.t2[b];
    const float B1 = p.b1[b];
    const float DF = cdf ? p.df[b] : 0.0f;
    const float Dc = p.use_d ? p.dc[b] : 0.0f;

    for (int g = 0; g <= ng; ++g)
        for (int j = 0; j < 6; ++j)
            for (int k = 0; k < H; ++k) set(g).at(j, k) = 0.0f;
    P.at(4, 0) = 1.0f;

    const size_t plane = static_cast<size_t>(p.nadc) * p.B;

    for (int i = 0; i < p.N; ++i) {
        const float fa = p.fa[i];
        const float ph = p.phi[i] * kDeg;
        float sp, cp, s2p, c2p, sa, ca;
        sincosf(ph, &sp, &cp);
        sincosf(2.0f * ph, &s2p, &c2p);
        float a, da;
        if (p.use_b1u) {
            const float u = p.b1u[i];
            a = fa * (1.0f + u * (B1 - 1.0f)) * kDeg;
            da = fa * u * kDeg;
        } else {
            a = fa * B1 * kDeg;
            da = fa * kDeg;
        }
        sincosf(a, &sa, &ca);
        const epg::Rot r = epg::rot_coeffs_sc(sa, ca, cp, sp, c2p, s2p);
        const epg::Rot dr = epg::rot_coeffs_db1(sa, ca, da, cp, sp, c2p, s2p);

        const float ta = p.ta[i];
        const float tb = p.tb[i];
        const float tt = ta + tb;
        const float e1a = expf(-ta / T1);
        const float e1b = expf(-tb / T1);
        const float e2a = expf(-ta / T2);
        const float cF = e2a * expf(-tb / T2);
        const float cZ = e1a * e1b;
        const float rec = 1.0f - cZ;
        const float de2a = e2a * ta / (T2 * T2);
        const float dcF = cF * tt / (T2 * T2);
        const float dcZ = cZ * tt / (T1 * T1);
        float cFr = cF, cFi = 0.0f, dcFr = dcF, dcFi = 0.0f;
        if (cdf) {
            float pI, pR;
            sincosf(kTwoPi * DF * tt, &pI, &pR);
            cFr = cF * pR;
            cFi = cF * pI;
            dcFr = dcF * pR;
            dcFi = dcF * pI;
        }
        // d/ddf of the carried F coefficient: i 2 pi tt (cFr + i cFi)
        const float w = kTwoPi * tt;
        const float fFr = -w * cFi;
        const float fFi = w * cFr;
        // the echo's phasor: df over ta, then the ADC phase
        const bool phased = cdf || p.use_adcph;
        float pc = 1.0f, ps = 0.0f;
        if (cdf) sincosf(kTwoPi * DF * ta, &ps, &pc);
        if (p.use_adcph) {
            float as, ac;
            sincosf(p.aph[i], &as, &ac);
            if (cdf) {
                epg::cmul(pc, ps, ac, as, pc, ps);
            } else {
                pc = ac;
                ps = as;
            }
        }
        // the echo of a rotated k = 0 row: decay over ta, then the phasor
        auto echo = [&](float re, float im, float& oR, float& oI) {
            oR = e2a * re;
            oI = e2a * im;
            if (phased) epg::cmul(pc, ps, oR, oI, oR, oI);
        };
        const int idx = p.adci[i];
        const bool readout = idx >= 0 && idx < p.nadc;
        auto write = [&](int o, float eR, float eI) {
            const size_t at = static_cast<size_t>(idx) * p.B + b;
            p.out[(2 * o) * plane + at] = eR;
            p.out[(2 * o + 1) * plane + at] = eI;
        };

        int dir = p.shift[i];
        if (!((dir > 0 && p.use_up) || (dir < 0 && p.use_down))) dir = 0;
        epg::StageShift shP(P, dir);
        epg::StageShift sh1(set(slot[0]), dir), sh2(set(slot[1]), dir),
            sh3(set(slot[2]), dir), sh4(set(slot[3]), dir);
        for (int k = 0; k < H; ++k) {
            const epg::Row x = epg::read_row(P, k);
            const epg::Row R = epg::rotate(r, x);
            float pR = 0.0f, pI = 0.0f;
            const bool at_echo = k == 0 && readout;
            if (at_echo) {
                echo(R.AR, R.AI, pR, pI);
                write(0, pR, pI);
            }
            {   // primal
                float nAR, nAI, nBR, nBI;
                epg::fdecay(cdf, cFr, cFi, R.AR, R.AI, nAR, nAI);
                epg::fdecay(cdf, cFr, cFi, R.BR, R.BI, nBR, nBI);
                float nZR = cZ * R.ZR;
                if (k == 0) nZR = nZR + rec;
                shP.put(k, nAR, nAI, nBR, nBI, nZR, cZ * R.ZI);
            }
            if (slot[0]) {   // dT1: only cZ and rec = 1 - cZ carry tangents
                const epg::Row t = epg::rotate(r, epg::read_row(sh1.up.s, k));
                if (at_echo) {
                    float eR, eI;
                    echo(t.AR, t.AI, eR, eI);
                    write(slot[0], eR, eI);
                }
                float nAR, nAI, nBR, nBI;
                epg::fdecay(cdf, cFr, cFi, t.AR, t.AI, nAR, nAI);
                epg::fdecay(cdf, cFr, cFi, t.BR, t.BI, nBR, nBI);
                float nZR = cZ * t.ZR + dcZ * R.ZR;
                if (k == 0) nZR = nZR - dcZ;
                sh1.put(k, nAR, nAI, nBR, nBI, nZR, cZ * t.ZI + dcZ * R.ZI);
            }
            if (slot[1]) {   // dT2: cF and the echo's ta decay
                const epg::Row t = epg::rotate(r, epg::read_row(sh2.up.s, k));
                if (at_echo) {
                    float eR, eI, xR = de2a * R.AR, xI = de2a * R.AI;
                    echo(t.AR, t.AI, eR, eI);
                    if (phased) epg::cmul(pc, ps, xR, xI, xR, xI);
                    write(slot[1], eR + xR, eI + xI);
                }
                float aR, aI, bR, bI, xaR, xaI, xbR, xbI;
                epg::fdecay(cdf, cFr, cFi, t.AR, t.AI, aR, aI);
                epg::fdecay(cdf, dcFr, dcFi, R.AR, R.AI, xaR, xaI);
                epg::fdecay(cdf, cFr, cFi, t.BR, t.BI, bR, bI);
                epg::fdecay(cdf, dcFr, dcFi, R.BR, R.BI, xbR, xbI);
                sh2.put(k, aR + xaR, aI + xaI, bR + xbR, bI + xbI,
                        cZ * t.ZR, cZ * t.ZI);
            }
            if (slot[2]) {   // dB1: the rotation coefficients' pass
                const epg::Row C = epg::rotate(dr, x);
                const epg::Row t = epg::rotate(r, epg::read_row(sh3.up.s, k));
                if (at_echo) {
                    float eR, eI;
                    echo(t.AR + C.AR, t.AI + C.AI, eR, eI);
                    write(slot[2], eR, eI);
                }
                float nAR, nAI, nBR, nBI;
                epg::fdecay(cdf, cFr, cFi, t.AR + C.AR, t.AI + C.AI, nAR, nAI);
                epg::fdecay(cdf, cFr, cFi, t.BR + C.BR, t.BI + C.BI, nBR, nBI);
                sh3.put(k, nAR, nAI, nBR, nBI, cZ * (t.ZR + C.ZR),
                        cZ * (t.ZI + C.ZI));
            }
            if (slot[3]) {   // ddf: the phasors' derivative on the primal
                const epg::Row t = epg::rotate(r, epg::read_row(sh4.up.s, k));
                if (at_echo) {
                    float eR, eI;
                    echo(t.AR, t.AI, eR, eI);
                    const float we = kTwoPi * ta;
                    write(slot[3], eR + -we * pI, eI + we * pR);
                }
                float aR, aI, bR, bI, yaR, yaI, ybR, ybI;
                epg::fdecay(cdf, cFr, cFi, t.AR, t.AI, aR, aI);
                epg::fdecay(cdf, cFr, cFi, t.BR, t.BI, bR, bI);
                epg::cmul(fFr, fFi, R.AR, R.AI, yaR, yaI);
                epg::cmul(fFr, fFi, R.BR, R.BI, ybR, ybI);
                // Z carries no off-resonance
                sh4.put(k, aR + yaR, aI + yaI, bR + ybR, bI + ybI,
                        cZ * t.ZR, cZ * t.ZI);
            }
        }
        shP.finish();
        if (slot[0]) sh1.finish();
        if (slot[1]) sh2.finish();
        if (slot[2]) sh3.finish();
        if (slot[3]) sh4.finish();
        if (p.use_d) {
            const float bt = p.btd[i];
            if (bt != 0.0f) {   // a stage without D: every factor is 1
                const float rd = p.rdir[i];
                for (int k = 0; k < H; ++k) {
                    const epg::StageAtt f = epg::stage_att(k, bt, rd, Dc);
                    for (int g = 0; g <= ng; ++g)
                        epg::attenuate_row(set(g), k, f);
                }
            }
        }
    }
}

}  // namespace

// Launch on `stream` of CUDA device `device`; allocates nothing.  Returns
// the CUDA error code of the launch (0 on success); the caller raises on
// anything else.
extern "C" int epg_composite_jac(const float* fa, const float* phi,
                                 const float* ta, const float* tb,
                                 const int* adci, const int* shift,
                                 const float* aph, const float* b1u,
                                 const float* btd, const float* rdir,
                                 const float* t1, const float* t2,
                                 const float* b1, const float* df,
                                 const float* dc, float* out, int N, int B,
                                 int nadc, int nstate, int mask, int use_df,
                                 int use_up, int use_down, int use_adcph,
                                 int use_b1u, int use_d, int block,
                                 int device, void* stream) {
    CompJacArgs a{fa, phi, ta, tb, adci, shift, aph, b1u, btd, rdir, t1, t2,
                  b1, df, dc, out, N, B, nstate + 1, nadc, mask & 15, use_df,
                  use_up, use_down, use_adcph, use_b1u, use_d};
    const int ng = __builtin_popcount(static_cast<unsigned>(a.mask));
    cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return static_cast<int>(e);
    const size_t smem =
        sizeof(float) * 6 * (1 + ng) * static_cast<size_t>(a.H) * block;
    if (smem > 48 * 1024) {
        e = cudaFuncSetAttribute(
            composite_jac_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (e != cudaSuccess) return static_cast<int>(e);
    }
    const int grid = (B + block - 1) / block;
    composite_jac_kernel<<<grid, block, smem,
                           static_cast<cudaStream_t>(stream)>>>(a);
    return static_cast<int>(cudaGetLastError());
}
