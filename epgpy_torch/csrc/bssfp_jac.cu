// bssfp_jac.cu -- balanced SSFP fingerprints and their dT1/dT2/dB1[/ddf]
// tangents at k = 0.
//
// Replaces the TPU kernel epgpy_tpu/models/pallas_bssfp.py:_kernel_jac
// (:153), driven there by bssfp_jacobian_pallas (:439); the Python wrapper
// is epgpy_torch/models/cuda_bssfp.py:bssfp_jacobian_cuda and the plain
// PyTorch twin beside it (bssfp_jacobian_echoes_plain) computes the same
// recurrence with the same operation order.
//
// What it computes, per atom: the forward-mode derivative of bssfp.cu.
// Each tangent of a balanced train keeps the primal's k = 0 symmetry, so
// every group is three floats: the primal, then dT1, dT2, dB1 and, with
// track_df, ddf -- 12 or 15 floats.  The coefficient tangents are sparse:
// T1 perturbs only cZ and the recovery 1 - cZ, T2 only cF and the echo's
// TE decay, B1 only the rotation (one extra k = 0 rotation of the primal by
// the coefficient derivatives), df only the precession phasors, whose
// derivative is i 2 pi t times the primal (t = TR per pulse, TE per echo,
// TI through the prep).  An inversion prep seeds its tangents in closed
// form.  Per pulse the echo of every group is written out (2 + 2G planes of
// (P, B), re and im).
//
// What bounds it on the card: the bytes.  The outputs are (2 + 2G) * P * B
// * 4 bytes (3.3 GB with ddf at 500 pulses x 163,840 atoms, 1 ms at
// 3.35 TB/s) against ~200 FP32 operations per atom and pulse (0.25 ms at
// the FP32 peak there).  The design is the primal's: one thread per atom,
// the 12 or 15 state floats in registers for the whole train (no shared
// memory, no barrier), the per-pulse table through the read-only path, and
// every output plane stored coalesced along atoms.  The ragged atom edge is
// masked; math is precise.
#include <cuda_runtime.h>

#include "epg_planes.cuh"

namespace {

constexpr float kDeg = 0.017453292519943295f;   // pi / 180
constexpr float kPi = 3.141592653589793f;
constexpr float kTwoPi = 6.283185307179586f;

struct BssfpJacArgs {
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
    float* out;         // (2 + 2G, P, B): re, im, then (re, im) per tangent
    int P, B;
    int var_te, use_inv, use_df, demod, track_df;
};

// One group's k = 0 state: Re F+, Im F+, Z.
struct K0 {
    float FR, FI, Z;
};

__device__ __forceinline__ K0 rotk0(const epg::Rot& r, const K0& s) {
    K0 o;
    epg::rot_k0(r, s.FR, s.FI, s.Z, o.FR, o.FI, o.Z);
    return o;
}

__global__ void bssfp_jac_kernel(const BssfpJacArgs p) {
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= p.B) return;  // ragged edge; no barrier follows
    const float T1 = p.t1[b];
    const float T2 = p.t2[b];
    const float B1 = p.b1[b];
    const bool cdf = p.use_df != 0;
    const bool tdf = p.track_df != 0;
    const float DF = cdf ? p.df[b] : 0.0f;

    // s[0] primal, s[1..3] dT1, dT2, dB1, s[4] ddf (track_df)
    K0 s[5];
    for (int g = 0; g < 5; ++g) s[g] = K0{0.0f, 0.0f, 0.0f};
    if (p.use_inv) {
        // inversion prep and its tangents, closed form; the F+ seeds are
        // i v e^{i th}, th the TI precession (parameter-free for T1/T2/B1)
        float sai, cai;
        sincosf(kPi * B1, &sai, &cai);
        const float E1i = expf(-p.ti / T1);
        const float E2i = expf(-p.ti / T2);
        const float dE1i = E1i * p.ti / (T1 * T1);
        const float dE2i = E2i * p.ti / (T2 * T2);
        float si = 0.0f, ci = 1.0f;
        if (cdf) sincosf(kTwoPi * DF * p.ti, &si, &ci);
        const float fpi = -sai * E2i;
        const int grp[3] = {0, 2, 3};
        const float val[3] = {fpi, -sai * dE2i, -cai * kPi * E2i};
        for (int n = 0; n < 3; ++n) {
            s[grp[n]].FR = cdf ? -val[n] * si : 0.0f;
            s[grp[n]].FI = cdf ? val[n] * ci : val[n];
        }
        s[0].Z = cai * E1i + 1.0f - E1i;
        s[1].Z = (cai - 1.0f) * dE1i;
        s[3].Z = -sai * kPi * E1i;
        if (tdf) {
            const float tTI = kTwoPi * p.ti;
            s[4].FR = cdf ? -tTI * fpi * ci : -tTI * fpi;
            s[4].FI = cdf ? -tTI * fpi * si : 0.0f;
        }
    } else {
        s[0].Z = 1.0f;
    }

    float E2te = 0.0f, dE2te = 0.0f, pteR0 = 1.0f, pteI0 = 0.0f;
    if (!p.var_te) {
        E2te = expf(-p.te0 / T2);
        dE2te = E2te * p.te0 / (T2 * T2);
        if (cdf) sincosf(kTwoPi * DF * p.te0, &pteI0, &pteR0);
    }
    const size_t plane = static_cast<size_t>(p.P) * p.B;

    for (int i = 0; i < p.P; ++i) {
        float te = p.te0, e2te = E2te, de2te = dE2te;
        float pteR = pteR0, pteI = pteI0;
        if (p.var_te) {
            te = __ldg(p.te + i);
            e2te = expf(-te / T2);
            de2te = e2te * te / (T2 * T2);
            if (cdf) sincosf(kTwoPi * DF * te, &pteI, &pteR);
        }
        const float fa = __ldg(p.fa + i);
        const float ph = __ldg(p.phi + i) * kDeg;
        float sp, cp, s2p, c2p, sa, ca;
        sincosf(ph, &sp, &cp);
        sincosf(2.0f * ph, &s2p, &c2p);
        sincosf(fa * B1 * kDeg, &sa, &ca);
        const epg::Rot r = epg::rot_coeffs_sc(sa, ca, cp, sp, c2p, s2p);
        const epg::Rot dr =
            epg::rot_coeffs_db1(sa, ca, fa * kDeg, cp, sp, c2p, s2p);

        const K0 R = rotk0(r, s[0]);
        const K0 t1 = rotk0(r, s[1]);
        const K0 t2 = rotk0(r, s[2]);
        const K0 tb = rotk0(r, s[3]);
        const K0 C = rotk0(dr, s[0]);

        const size_t at = static_cast<size_t>(i) * p.B + b;
        auto write = [&](int o, float eR, float eI) {
            if (cdf) epg::cmul(pteR, pteI, eR, eI, eR, eI);
            if (p.demod) {
                const float dR = eR * cp + eI * sp;
                eI = eI * cp - eR * sp;
                eR = dR;
            }
            p.out[(2 * o) * plane + at] = eR;
            p.out[(2 * o + 1) * plane + at] = eI;
        };
        write(0, e2te * R.FR, e2te * R.FI);
        write(1, e2te * t1.FR, e2te * t1.FI);
        write(2, e2te * t2.FR + de2te * R.FR, e2te * t2.FI + de2te * R.FI);
        write(3, e2te * (tb.FR + C.FR), e2te * (tb.FI + C.FI));
        K0 td{0.0f, 0.0f, 0.0f};
        if (tdf) {
            // ddf echo: e^{i ang_te} e2te (tangent + i 2 pi te primal)
            td = rotk0(r, s[4]);
            const float wte = kTwoPi * te;
            write(4, e2te * (td.FR - wte * R.FI), e2te * (td.FI + wte * R.FR));
        }

        const float TRi = __ldg(p.tr + i);
        const float cF = expf(-TRi / T2);
        const float cZ = expf(-TRi / T1);
        const float dcZ = cZ * TRi / (T1 * T1);
        const float dcF = cF * TRi / (T2 * T2);
        float pR = 1.0f, pI = 0.0f;
        if (cdf) sincosf(kTwoPi * DF * TRi, &pI, &pR);
        // (c e^{i 2 pi df TR}) (re + i im)
        auto fmul = [&](float c, float re, float im, float& oR, float& oI) {
            if (cdf) {
                oR = c * (re * pR - im * pI);
                oI = c * (im * pR + re * pI);
            } else {
                oR = c * re;
                oI = c * im;
            }
        };
        fmul(cF, R.FR, R.FI, s[0].FR, s[0].FI);
        s[0].Z = cZ * R.Z + (1.0f - cZ);
        // dT1: only cZ and the recovery 1 - cZ carry tangents
        fmul(cF, t1.FR, t1.FI, s[1].FR, s[1].FI);
        s[1].Z = cZ * t1.Z + dcZ * R.Z - dcZ;
        // dT2: only cF (and the echo's TE decay) carry tangents
        float bR, bI, xR, xI;
        fmul(cF, t2.FR, t2.FI, bR, bI);
        fmul(dcF, R.FR, R.FI, xR, xI);
        s[2] = K0{bR + xR, bI + xI, cZ * t2.Z};
        // dB1: only the rotation coefficients carry tangents
        fmul(cF, tb.FR + C.FR, tb.FI + C.FI, s[3].FR, s[3].FI);
        s[3].Z = cZ * (tb.Z + C.Z);
        if (tdf) {
            // ddf: e^{i ang} cF (tangent + i 2 pi TR primal); Z phase-free
            const float wtr = kTwoPi * TRi;
            fmul(cF, td.FR - wtr * R.FI, td.FI + wtr * R.FR, s[4].FR,
                 s[4].FI);
            s[4].Z = cZ * td.Z;
        }
    }
}

}  // namespace

// Launch on `stream` of CUDA device `device`; allocates nothing.  Returns
// the CUDA error code of the launch (0 on success); the caller raises on
// anything else.
extern "C" int epg_bssfp_jac(const float* fa, const float* phi,
                             const float* tr, const float* te, float te0,
                             float ti, const float* t1, const float* t2,
                             const float* b1, const float* df, float* out,
                             int P, int B, int var_te, int use_inv,
                             int use_df, int demod, int track_df, int block,
                             int device, void* stream) {
    BssfpJacArgs a{fa, phi, tr, te, te0, ti, t1, t2, b1, df, out, P, B,
                   var_te, use_inv, use_df, demod, track_df};
    cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return static_cast<int>(e);
    const int grid = (B + block - 1) / block;
    bssfp_jac_kernel<<<grid, block, 0,
                       static_cast<cudaStream_t>(stream)>>>(a);
    return static_cast<int>(cudaGetLastError());
}
