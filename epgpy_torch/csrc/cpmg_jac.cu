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
// What bounds it on the card: instruction issue, not bytes or operations.
// The state per atom is set by the physics: 24 plane values (30 with the
// DW-TSE factors) per ladder row, H = nstate + 1 rows (nstate 36 at the
// published 18-echo depth).  The layout sets how many threads share it:
// one warp per atom, the rows across its lanes (epg_planes.cuh's
// warp-row layout), so a row step is one chunk step of the warp -- a few
// shuffles (epg::WarpShift) instead of a serial walk -- and the shared
// memory that held one block of 64 one-thread ladders per SM now holds 56
// atom-warps; 80 registers let 24 run.  Each row's values sit in one
// record of 25 (31) floats, odd so the lanes' rows fall in distinct banks,
// and every access to a row is one address plus a constant offset: the
// layout of [plane][row] planes cost as many address instructions as
// floating-point ones.  A block is `block` atom-warps.  Each half-stage
// walks only the 32-row chunks its echo can have reached (epg::reach):
// rows beyond hold exact zeros, so the outputs are those of the full walk.
// The lanes of a chunk past the reach still compute (zeros); at nstate 36
// about half the lane-steps carry reached rows.  Math is precise (no
// fast-math).
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
    const float* dc1;   // (B,) stage-1 diffusivity (with DW-TSE)
    const float* dc2;   // (B,) stage-2 diffusivity (with DW-TSE)
    float bT1, bL1, bT2, bL2;   // b-value bases per stage (with DW-TSE)
    float* out;         // (8, E, B): re, im of the primal, dT1, dT2, dB1
    int E, B, H;
    int ramp1, ramp2;
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
// already rotated in the second half-stage), each new value times the
// DW-TSE factor `f` of the row it lands on (DIF), handed to the shifts
template <bool DIF>
__device__ __forceinline__ void relax_put(epg::WarpShift* sh, int k,
                                          const Relax& c,
                                          const epg::StageAtt& f,
                                          const Row& p, const Row& t1,
                                          const Row& t2, const Row& tb) {
    const float fA = DIF ? f.aA : 1.0f;
    const float fB = DIF ? f.aB : 1.0f;
    const float fZ = DIF ? f.aZ : 1.0f;
    Row n[4];
    {
        float nZR = p.ZR * c.E1;
        if (k == 0) nZR = nZR + c.rec;
        n[0] = Row{p.AR * c.E2, p.AI * c.E2, p.BR * c.E2, p.BI * c.E2, nZR,
                   p.ZI * c.E1};
    }
    {   // dT1: E1 and the recovery
        float nZR = t1.ZR * c.E1 + p.ZR * c.dE1;
        if (k == 0) nZR = nZR - c.dE1;
        n[1] = Row{t1.AR * c.E2, t1.AI * c.E2, t1.BR * c.E2, t1.BI * c.E2,
                   nZR, t1.ZI * c.E1 + p.ZI * c.dE1};
    }
    // dT2: E2
    n[2] = Row{t2.AR * c.E2 + p.AR * c.dE2, t2.AI * c.E2 + p.AI * c.dE2,
               t2.BR * c.E2 + p.BR * c.dE2, t2.BI * c.E2 + p.BI * c.dE2,
               t2.ZR * c.E1, t2.ZI * c.E1};
    // dB1: passes through
    n[3] = Row{tb.AR * c.E2, tb.AI * c.E2, tb.BR * c.E2, tb.BI * c.E2,
               tb.ZR * c.E1, tb.ZI * c.E1};
#pragma unroll
    for (int g = 0; g < 4; ++g) {
        if (DIF) {
            n[g].AR *= fA;
            n[g].AI *= fA;
            n[g].BR *= fB;
            n[g].BI *= fB;
            n[g].ZR *= fZ;
            n[g].ZI *= fZ;
        }
        sh[g].put(k, n[g].AR, n[g].AI, n[g].BR, n[g].BI, n[g].ZR, n[g].ZI);
    }
}

// floats per row record: 4 groups x 6 planes [+ 2 stages x (aA, aB, aZ)],
// one more to make it odd (conflict-free rows across the lanes)
template <bool DIF>
constexpr int kRecord = DIF ? 31 : 25;

template <bool DIF>
__global__ void __launch_bounds__(256) cpmg_jac_kernel(const JacArgs p) {
    extern __shared__ float smem[];
    constexpr int S = kRecord<DIF>;
    const int lane = static_cast<int>(threadIdx.x) & (epg::kWarp - 1);
    const int warp = static_cast<int>(threadIdx.x) / epg::kWarp;
    const int b = blockIdx.x * (blockDim.x / epg::kWarp) + warp;
    if (b >= p.B) return;  // a whole warp past the ragged edge; no barrier
    const int H = p.H;
    float* base = smem + static_cast<size_t>(warp) * S * H;
    epg::RowSet s[4];
#pragma unroll
    for (int g = 0; g < 4; ++g) s[g] = epg::RowSet{base + 6 * g, S, H};
    // with diffusion: values 24-26 stage 1's (aA, aB, aZ), 27-29 stage 2's
    const epg::RowSet a1{base + 24, S, H};
    const epg::RowSet a2{base + 27, S, H};

    const float T1 = p.t1[b];
    const float T2 = p.t2[b];
    const float B1 = p.b1[b];
    for (int t = lane; t < S * H; t += epg::kWarp) base[t] = 0.0f;
    __syncwarp();
    if (DIF) {
        epg::att_rows_warp(a1, p.bT1, p.bL1, p.ramp1 != 0, p.dc1[b], lane);
        epg::att_rows_warp(a2, p.bT2, p.bL2, p.ramp2 != 0, p.dc2[b], lane);
    }
    if (lane == 0) {
        base[0] = p.exc_ar;
        base[1] = p.exc_ai;
        base[2] = p.exc_ar;
        base[3] = p.exc_ai;
        base[4] = p.exc_z;
    }
    __syncwarp();

    const size_t plane = static_cast<size_t>(p.E) * p.B;
    const epg::StageAtt none{1.0f, 1.0f, 1.0f};
    for (int i = 0; i < p.E; ++i) {
        // E(tau1) -> S(1) [-> D1]
        {
            const Relax c = relax(p.tau1[i], T1, T2);
            epg::WarpShift sh[4];
#pragma unroll
            for (int g = 0; g < 4; ++g) sh[g] = epg::warp_shift(s[g]);
            const int top = epg::reach(i, 1, H);
            for (int k = lane; k - lane <= top; k += epg::kWarp) {
                const int kr = k < H ? k : H - 1;
                relax_put<DIF>(sh, k, c, DIF ? epg::warp_att(a1, k) : none,
                               read_row(s[0], kr), read_row(s[1], kr),
                               read_row(s[2], kr), read_row(s[3], kr));
            }
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
            epg::WarpShift sh[4];
#pragma unroll
            for (int g = 0; g < 4; ++g) sh[g] = epg::warp_shift(s[g]);
            const int top = epg::reach(i, 2, H);
            for (int k = lane; k - lane <= top; k += epg::kWarp) {
                const int kr = k < H ? k : H - 1;
                const Row x = read_row(s[0], kr);
                const Row C = rotate(dr, x);
                Row tb = rotate(r, read_row(s[3], kr));
                tb.AR = tb.AR + C.AR;
                tb.AI = tb.AI + C.AI;
                tb.BR = tb.BR + C.BR;
                tb.BI = tb.BI + C.BI;
                tb.ZR = tb.ZR + C.ZR;
                tb.ZI = tb.ZI + C.ZI;
                relax_put<DIF>(sh, k, c, DIF ? epg::warp_att(a2, k) : none,
                               rotate(r, x), rotate(r, read_row(s[1], kr)),
                               rotate(r, read_row(s[2], kr)), tb);
            }
        }
        // row 0 of each group (lane 0's) to lanes 0-7, one output each
        __syncwarp();
        if (lane < 8) {
            p.out[lane * plane + static_cast<size_t>(i) * p.B + b] =
                base[6 * (lane >> 1) + (lane & 1)];
        }
        __syncwarp();
    }
}

template <bool DIF>
int launch(const JacArgs& a, int block, cudaStream_t stream) {
    const size_t smem = sizeof(float) * kRecord<DIF>
        * static_cast<size_t>(a.H) * block;
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            cpmg_jac_kernel<DIF>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (e != cudaSuccess) return static_cast<int>(e);
    }
    const int grid = (a.B + block - 1) / block;
    cpmg_jac_kernel<DIF><<<grid, block * epg::kWarp, smem, stream>>>(a);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream` of CUDA device `device`; allocates nothing.  Returns
// the CUDA error code of the launch (0 on success); the caller raises on
// anything else.  The arguments are epg_cpmg's, `out` holding 8 planes,
// except `block`: atom-warps per block (at most 8).
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
              ramp1, ramp2};
    const cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (block < 1 || block > 8)
        return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    return use_diff ? launch<true>(a, block, st) : launch<false>(a, block, st);
}
