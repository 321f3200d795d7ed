// fisp_full.cu -- FISP MR-fingerprinting dictionary on the full ladder.
//
// Replaces the TPU kernel epgpy_tpu/models/pallas_fisp.py:_kernel (:116),
// driven there by fisp_dictionary_pallas(half_ladder=False) (:899) and, as
// there, taken at nstate 0, where the folded ladder has no k = 1 row; the
// Python wrapper is epgpy_torch/models/cuda_fisp.py:fisp_full_ladder_cuda
// and the plain PyTorch twin beside it (fisp_full_echoes_plain) computes
// the same recurrence with the same operation order.  It is also the
// parity oracle of fisp_half.cu, whose fold it does not use.
//
// What it computes, per atom (T1, T2, B1, df), over P pulses: the literal
// ladder of K = 2 nstate + 1 rows, k = -nstate..nstate with k = 0 at row
// nstate, as six planes F+, F- and Z (re, im), from Z(0) = 1 (or after a
// closed-form 180*B1 inversion and TI relaxation, the residual F+
// precessing during TI when inv_df).  Per pulse i: the k = 0 echo at TE
// (the rotated centre row, E2 decay, optional df phase, optional
// demodulation by e^{-i phi_i}); every row rotated by the Weigel
// coefficients of (FA_i * B1, phi_i) with both relaxations and the df
// phasor folded into the coefficients (F+ by cF e^{i w}, F- by its
// conjugate, Z by cZ, recovery at k = 0); then F+ moves up a row and F-
// down a row, zero-filled at the ends.  No diffusion: the JAX wrapper
// takes it only on the half ladder.
//
// What bounds it on the card: about twice fisp_half.cu's arithmetic, since
// every k is held twice (F+ and F- of 2 nstate + 1 rows against the fold's
// nstate + 1), on the FP32 pipes -- compute-bound as fisp_half.cu is; at
// nstate 0 one row, and the output stores dominate.  The design is
// fisp_half.cu's: one thread per atom runs the whole train, the planes sit
// in shared memory at [plane][row][threadIdx.x] (conflict-free, no
// barrier), per-pulse scalars are read at one address per warp, echo
// stores coalesce along atoms.  The shift is a row walk in place: row r is
// read, its new values computed, Z(r) written, F+(r) takes the carried new
// F+(r-1), and F-(r-1) the new F-(r).  The ragged atom edge is masked; math
// is precise.  Gate: 6 planes x (2 nstate + 1) rows x 32 threads x 4 bytes
// in 227 KB, nstate <= 150.
#include <cuda_runtime.h>

#include "epg_planes.cuh"

namespace {

constexpr float kDeg = 0.017453292519943295f;   // pi / 180
constexpr float kPi = 3.141592653589793f;
constexpr float kTwoPi = 6.283185307179586f;

struct FispFullArgs {
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
    float* out_re;      // (P, B)
    float* out_im;      // (P, B)
    int P, B, N;        // N = nstate: rows 0..2N, k = 0 at row N
    int var_te, use_inv, inv_df, use_df, demod;
};

__global__ void fisp_full_kernel(const FispFullArgs p) {
    extern __shared__ float smem[];
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= p.B) return;  // ragged edge; no barrier follows
    const int N = p.N;
    const int K = 2 * N + 1;
    // planes 0-5: F+ re, F+ im, F- re, F- im, Z re, Z im
    const epg::PlaneSet s{smem + threadIdx.x, K, static_cast<int>(blockDim.x)};

    const float T1 = p.t1[b];
    const float T2 = p.t2[b];
    const float B1 = p.b1[b];
    const float DF = p.use_df ? p.df[b] : 0.0f;

    for (int j = 0; j < 6; ++j)
        for (int r = 0; r < K; ++r) s.at(j, r) = 0.0f;
    if (p.use_inv) {
        // 180*B1 pulse about phi = 0, then TI relaxation; F-(0) is the
        // conjugate of F+(0)
        const float ai = kPi * B1;
        const float E1i = expf(-p.ti / T1);
        const float E2i = expf(-p.ti / T2);
        float sai, cai;
        sincosf(ai, &sai, &cai);
        const float fpi = -sai * E2i;
        if (p.use_df && p.inv_df) {
            float sth, cth;
            sincosf(kTwoPi * DF * p.ti, &sth, &cth);
            s.at(0, N) = -fpi * sth;
            s.at(1, N) = fpi * cth;
            s.at(2, N) = -fpi * sth;
            s.at(3, N) = -fpi * cth;
        } else {
            s.at(1, N) = fpi;
            s.at(3, N) = -fpi;
        }
        s.at(4, N) = cai * E1i + 1.0f - E1i;
    } else {
        s.at(4, N) = 1.0f;
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
        const float a = p.fa[i] * B1 * kDeg;
        const float ph = p.phi[i] * kDeg;
        float sa, ca, sp, cp, s2p, c2p;
        sincosf(a, &sa, &ca);
        sincosf(ph, &sp, &cp);
        sincosf(2.0f * ph, &s2p, &c2p);
        const float cos2 = (1.0f + ca) * 0.5f;
        const float sin2 = (1.0f - ca) * 0.5f;
        // Weigel rotation coefficients: m00 = m11 = cos2, m01 = e^{2ip}
        // sin2 (m10 its conjugate), m02 = -i e^{ip} sin a, m12 = i e^{-ip}
        // sin a, m20 = -i/2 e^{-ip} sin a, m21 = i/2 e^{ip} sin a, m22 = cos a
        const float m01r = c2p * sin2, m01i = s2p * sin2;
        const float m02r = sp * sa, m02i = -cp * sa;
        const float m12r = sp * sa, m12i = cp * sa;
        const float m20r = -0.5f * sp * sa, m20i = -0.5f * cp * sa;
        const float m21r = -0.5f * sp * sa, m21i = 0.5f * cp * sa;

        const float rem = p.tr[i] - te;
        const float E1b = expf(-rem / T1);
        const float E2b = expf(-rem / T2);
        const float cF = e2te * E2b;
        const float cZ = e1te * E1b;
        const float rec = (1.0f - e1te) * E1b + (1.0f - E1b);
        float pteR = 1.0f, pteI = 0.0f;
        // the F+ coefficient (cF e^{i 2 pi df TR}) and F-'s conjugate
        float cFpR = cF, cFpI = 0.0f, cFmR = cF, cFmI = 0.0f;
        if (p.use_df) {
            sincosf(kTwoPi * DF * te, &pteI, &pteR);
            float pI, pR;
            sincosf(kTwoPi * DF * (te + rem), &pI, &pR);
            cFpR = cF * pR;
            cFpI = cF * pI;
            cFmR = cF * pR;
            cFmI = -cF * pI;
        }
        // the relaxation folded into the rotation rows
        float c00r, c00i, c01r, c01i, c02r, c02i;
        epg::cmul(cFpR, cFpI, cos2, 0.0f, c00r, c00i);
        epg::cmul(cFpR, cFpI, m01r, m01i, c01r, c01i);
        epg::cmul(cFpR, cFpI, m02r, m02i, c02r, c02i);
        float c10r, c10i, c11r, c11i, c12r, c12i;
        epg::cmul(cFmR, cFmI, m01r, -m01i, c10r, c10i);
        epg::cmul(cFmR, cFmI, cos2, 0.0f, c11r, c11i);
        epg::cmul(cFmR, cFmI, m12r, m12i, c12r, c12i);
        const float z0r = m20r * cZ, z0i = m20i * cZ;
        const float z1r = m21r * cZ, z1i = m21i * cZ;
        const float zz = ca * cZ;

        float carR = 0.0f, carI = 0.0f;   // new F+(r-1), waiting for row r
        for (int r = 0; r < K; ++r) {
            const float FpR = s.at(0, r), FpI = s.at(1, r);
            const float FmR = s.at(2, r), FmI = s.at(3, r);
            const float ZR = s.at(4, r), ZI = s.at(5, r);
            float aR, aI, bR, bI, dR, dI;
            if (r == N) {
                // echo from the k = 0 row (post-rotation, post-TE decay)
                epg::cmul(m01r, m01i, FmR, FmI, bR, bI);
                epg::cmul(m02r, m02i, ZR, ZI, dR, dI);
                float eR = (cos2 * FpR + bR + dR) * e2te;
                float eI = (cos2 * FpI + bI + dI) * e2te;
                if (p.use_df) epg::cmul(pteR, pteI, eR, eI, eR, eI);
                if (p.demod) {
                    const float xR = eR * cp + eI * sp;
                    eI = eI * cp - eR * sp;
                    eR = xR;
                }
                const size_t o = static_cast<size_t>(i) * p.B + b;
                p.out_re[o] = eR;
                p.out_im[o] = eI;
            }
            epg::cmul(c00r, c00i, FpR, FpI, aR, aI);
            epg::cmul(c01r, c01i, FmR, FmI, bR, bI);
            epg::cmul(c02r, c02i, ZR, ZI, dR, dI);
            const float nFpR = aR + bR + dR, nFpI = aI + bI + dI;
            epg::cmul(c10r, c10i, FpR, FpI, aR, aI);
            epg::cmul(c11r, c11i, FmR, FmI, bR, bI);
            epg::cmul(c12r, c12i, ZR, ZI, dR, dI);
            const float nFmR = aR + bR + dR, nFmI = aI + bI + dI;
            epg::cmul(z0r, z0i, FpR, FpI, aR, aI);
            epg::cmul(z1r, z1i, FmR, FmI, bR, bI);
            float nZR = aR + bR + zz * ZR;
            if (r == N) nZR = nZR + rec;
            // unit shift: F+ up a row, F- down a row, Z in place
            s.at(4, r) = nZR;
            s.at(5, r) = aI + bI + zz * ZI;
            s.at(0, r) = carR;
            s.at(1, r) = carI;
            carR = nFpR;
            carI = nFpI;
            if (r >= 1) {
                s.at(2, r - 1) = nFmR;
                s.at(3, r - 1) = nFmI;
            }
        }
        s.at(2, K - 1) = 0.0f;
        s.at(3, K - 1) = 0.0f;
    }
}

}  // namespace

// Launch on `stream` of CUDA device `device`; allocates nothing.  Returns
// the CUDA error code of the launch (0 on success); the caller raises on
// anything else.
extern "C" int epg_fisp_full(const float* fa, const float* phi,
                             const float* tr, const float* te, float te0,
                             float ti, const float* t1, const float* t2,
                             const float* b1, const float* df, float* out_re,
                             float* out_im, int P, int B, int nstate,
                             int var_te, int use_inv, int inv_df, int use_df,
                             int demod, int block, int device, void* stream) {
    FispFullArgs a{fa, phi, tr, te, te0, ti, t1, t2, b1, df, out_re, out_im,
                   P, B, nstate, var_te, use_inv, inv_df, use_df, demod};
    cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return static_cast<int>(e);
    const size_t smem =
        sizeof(float) * 6 * static_cast<size_t>(2 * nstate + 1) * block;
    if (smem > 48 * 1024) {
        e = cudaFuncSetAttribute(
            fisp_full_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (e != cudaSuccess) return static_cast<int>(e);
    }
    const int grid = (B + block - 1) / block;
    fisp_full_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(a);
    return static_cast<int>(cudaGetLastError());
}
