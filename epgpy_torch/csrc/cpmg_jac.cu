// cpmg_jac.cu -- CPMG echo trains and their dT1/dT2/dB1 tangents.
//
// Replaces the TPU kernel epgpy_tpu/models/pallas_mse.py:_kernel_mse_jac
// (:309), driven there by cpmg_jacobian_pallas (:468); the Python wrapper
// is epgpy_torch/models/cuda_mse.py:cpmg_jacobian_cuda and the plain
// PyTorch twin beside it (cpmg_jacobian_plain) computes the same recurrence
// with the same operation order.
//
// What it computes, per atom: the forward-mode derivative of cpmg.cu.
// Plane group 0 is the primal folded ladder, groups 1-3 its tangents with
// respect to T1, T2 and B1: 24 planes of H = nstate + 1 rows.  The tangents
// are sparse per stage: T1 perturbs only the Z decay E1 and the k = 0
// recovery 1 - E1, T2 only the F decay E2, B1 only the refocusing
// rotation's coefficients (one extra rotation of the primal planes by the
// coefficient derivatives, d(a)/dB1 = FA_i; the scalar excitation is
// exact, so every tangent starts at zero).  The DW-TSE attenuation does not
// depend on (T1, T2, B1): it multiplies every group alike.  Per echo the
// k = 0 row of each group is written (8 outputs of (E, B)).
//
// What bounds it on the card: shared memory, hence occupancy.  One thread
// per atom keeps 24 planes (30 with the attenuation rows): 3,552 bytes per
// atom at the published 18-echo depth (nstate 36), 4,440 with DW, so a
// block of 64 atoms holds 227 KB (32 with DW) and an SM runs one block.
// The layout is fisp_jac.cu's ([plane][row][threadIdx.x], conflict-free,
// no barrier); each half-stage is one row walk per echo in which the
// primal row stays in registers while every group is relaxed (and, in the
// second walk, rotated) and written back through the in-place folded
// shift.  Math is precise (no fast-math).
#include <cuda_runtime.h>

#include "epg_planes.cuh"

namespace {

constexpr float kDeg = 0.017453292519943295f;   // pi / 180

struct JacArgs {
    float exc_ar, exc_ai, exc_z;   // excited F+(0) (re, im) and Z(0)
    const float* fa;    // (E,) refocusing flips, degrees
    const float* phi;   // (E,) refocusing phases, degrees
    const float* tau1;  // (E,) pre-refocusing delays, ms
    const float* tau2;  // (E,) post-refocusing delays, ms
    const float* t1;    // (B,)
    const float* t2;    // (B,)
    const float* b1;    // (B,) refocusing B1 scale
    const float* dc1;   // (B,) stage-1 diffusivity (use_diff)
    const float* dc2;   // (B,) stage-2 diffusivity (use_diff)
    float bT1, bL1, bT2, bL2;   // b-value bases per stage (use_diff)
    float* out;         // (8, E, B): re, im of the primal, dT1, dT2, dB1
    int E, B, H;
    int use_diff, ramp1, ramp2;
};

using epg::read_row;
using epg::rotate;
using epg::Row;

// relaxation of one half-stage and its T1/T2 derivatives
struct Relax {
    float E1, E2, rec, dE1, dE2;
};

__device__ __forceinline__ Relax relax(float tau, float T1, float T2) {
    Relax c;
    c.E1 = expf(-tau / T1);
    c.E2 = expf(-tau / T2);
    c.rec = 1.0f - c.E1;
    c.dE1 = c.E1 * tau / (T1 * T1);
    c.dE2 = c.E2 * tau / (T2 * T2);
    return c;
}

// E(tau) on the row k of each group (p: primal, t1/t2/tb: tangents, all
// already rotated in the second half-stage), handed to the shifts after the
// stage's attenuation `a` (null without diffusion)
__device__ __forceinline__ void relax_put(epg::FoldedShift* sh,
                                          const epg::PlaneSet* a, int k,
                                          const Relax& c, const Row& p,
                                          const Row& t1, const Row& t2,
                                          const Row& tb) {
    {
        float nZR = p.ZR * c.E1;
        if (k == 0) nZR = nZR + c.rec;
        epg::put_attenuated(sh[0], a, k, p.AR * c.E2, p.AI * c.E2,
                            p.BR * c.E2, p.BI * c.E2, nZR, p.ZI * c.E1);
    }
    {   // dT1: E1 and the recovery
        float nZR = t1.ZR * c.E1 + p.ZR * c.dE1;
        if (k == 0) nZR = nZR - c.dE1;
        epg::put_attenuated(sh[1], a, k, t1.AR * c.E2, t1.AI * c.E2,
                            t1.BR * c.E2, t1.BI * c.E2, nZR,
                            t1.ZI * c.E1 + p.ZI * c.dE1);
    }
    // dT2: E2
    epg::put_attenuated(sh[2], a, k, t2.AR * c.E2 + p.AR * c.dE2,
                        t2.AI * c.E2 + p.AI * c.dE2,
                        t2.BR * c.E2 + p.BR * c.dE2,
                        t2.BI * c.E2 + p.BI * c.dE2, t2.ZR * c.E1,
                        t2.ZI * c.E1);
    // dB1: passes through
    epg::put_attenuated(sh[3], a, k, tb.AR * c.E2, tb.AI * c.E2,
                        tb.BR * c.E2, tb.BI * c.E2, tb.ZR * c.E1,
                        tb.ZI * c.E1);
}

__global__ void cpmg_jac_kernel(const JacArgs p) {
    extern __shared__ float smem[];
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= p.B) return;  // ragged edge; no barrier follows
    const int H = p.H;
    const int ld = static_cast<int>(blockDim.x);
    epg::PlaneSet s[4];
    for (int g = 0; g < 4; ++g)
        s[g] = epg::PlaneSet{smem + threadIdx.x + 6 * g * H * ld, H, ld};
    const bool dif = p.use_diff != 0;
    // with diffusion: planes 24-26 stage 1's (aA, aB, aZ), 27-29 stage 2's
    const epg::PlaneSet a1{smem + threadIdx.x + 24 * H * ld, H, ld};
    const epg::PlaneSet a2{smem + threadIdx.x + 27 * H * ld, H, ld};
    const epg::PlaneSet* att1 = dif ? &a1 : nullptr;
    const epg::PlaneSet* att2 = dif ? &a2 : nullptr;

    const float T1 = p.t1[b];
    const float T2 = p.t2[b];
    const float B1 = p.b1[b];
    if (dif) {
        epg::att_rows(a1, p.bT1, p.bL1, p.ramp1 != 0, p.dc1[b]);
        epg::att_rows(a2, p.bT2, p.bL2, p.ramp2 != 0, p.dc2[b]);
    }
    for (int g = 0; g < 4; ++g)
        for (int j = 0; j < 6; ++j)
            for (int k = 0; k < H; ++k) s[g].at(j, k) = 0.0f;
    s[0].at(0, 0) = p.exc_ar;
    s[0].at(1, 0) = p.exc_ai;
    s[0].at(2, 0) = p.exc_ar;
    s[0].at(3, 0) = p.exc_ai;
    s[0].at(4, 0) = p.exc_z;

    const size_t plane = static_cast<size_t>(p.E) * p.B;
    for (int i = 0; i < p.E; ++i) {
        // E(tau1) -> S(1) [-> D1]
        {
            const Relax c = relax(p.tau1[i], T1, T2);
            epg::FoldedShift sh[4];
            for (int g = 0; g < 4; ++g)
                sh[g] = epg::FoldedShift{s[g], 0.0f, 0.0f};
            for (int k = 0; k < H; ++k)
                relax_put(sh, att1, k, c, read_row(s[0], k),
                          read_row(s[1], k), read_row(s[2], k),
                          read_row(s[3], k));
            for (int g = 0; g < 4; ++g) sh[g].finish();
        }
        // T(FA_i * B1, phi_i) with its B1 coefficient pass -> E(tau2) ->
        // S(1) [-> D2]
        {
            const float fa = p.fa[i];
            const float ph = p.phi[i] * kDeg;
            float sp, cp, s2p, c2p, sa, ca;
            sincosf(ph, &sp, &cp);
            sincosf(2.0f * ph, &s2p, &c2p);
            sincosf(fa * B1 * kDeg, &sa, &ca);
            const epg::Rot r = epg::rot_coeffs_sc(sa, ca, cp, sp, c2p, s2p);
            const epg::Rot dr =
                epg::rot_coeffs_db1(sa, ca, fa * kDeg, cp, sp, c2p, s2p);
            const Relax c = relax(p.tau2[i], T1, T2);
            epg::FoldedShift sh[4];
            for (int g = 0; g < 4; ++g)
                sh[g] = epg::FoldedShift{s[g], 0.0f, 0.0f};
            for (int k = 0; k < H; ++k) {
                const Row x = read_row(s[0], k);
                const Row C = rotate(dr, x);
                Row tb = rotate(r, read_row(s[3], k));
                tb.AR = tb.AR + C.AR;
                tb.AI = tb.AI + C.AI;
                tb.BR = tb.BR + C.BR;
                tb.BI = tb.BI + C.BI;
                tb.ZR = tb.ZR + C.ZR;
                tb.ZI = tb.ZI + C.ZI;
                relax_put(sh, att2, k, c, rotate(r, x),
                          rotate(r, read_row(s[1], k)),
                          rotate(r, read_row(s[2], k)), tb);
            }
            for (int g = 0; g < 4; ++g) sh[g].finish();
        }
        const size_t at = static_cast<size_t>(i) * p.B + b;
        for (int g = 0; g < 4; ++g) {
            p.out[(2 * g) * plane + at] = s[g].at(0, 0);
            p.out[(2 * g + 1) * plane + at] = s[g].at(1, 0);
        }
    }
}

}  // namespace

// Launch on `stream` of CUDA device `device`; allocates nothing.  Returns
// the CUDA error code of the launch (0 on success); the caller raises on
// anything else.  The arguments are epg_cpmg's, `out` holding 8 planes.
extern "C" int epg_cpmg_jac(float exc_ar, float exc_ai, float exc_z,
                            const float* fa, const float* phi,
                            const float* tau1, const float* tau2,
                            const float* t1, const float* t2,
                            const float* b1, const float* dc1,
                            const float* dc2, float bT1, float bL1,
                            float bT2, float bL2, float* out, int E, int B,
                            int nstate, int use_diff, int ramp1, int ramp2,
                            int block, int device, void* stream) {
    JacArgs a{exc_ar, exc_ai, exc_z, fa, phi, tau1, tau2, t1, t2, b1,
              dc1, dc2, bT1, bL1, bT2, bL2, out, E, B, nstate + 1,
              use_diff, ramp1, ramp2};
    cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return static_cast<int>(e);
    const size_t planes = use_diff ? 30 : 24;
    const size_t smem =
        sizeof(float) * planes * static_cast<size_t>(a.H) * block;
    if (smem > 48 * 1024) {
        e = cudaFuncSetAttribute(cpmg_jac_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
        if (e != cudaSuccess) return static_cast<int>(e);
    }
    const int grid = (B + block - 1) / block;
    cpmg_jac_kernel<<<grid, block, smem,
                      static_cast<cudaStream_t>(stream)>>>(a);
    return static_cast<int>(cudaGetLastError());
}
