// xgre_jac.cu -- EPG-X gradient-echo trains and their tangents in one pass:
// the per-voxel qMT Gauss-Newton fit's Jacobian (bound-pool fraction,
// free-pool T2, exchange rate, ...).
//
// Replaces the TPU kernel epgpy_tpu/models/pallas_xgre.py:_kernel_xgre_jac
// (:282), driven there by xgre_jacobian_pallas (:400); the Python wrapper
// is epgpy_torch/models/cuda_xgre.py:xgre_jacobian_cuda and the plain
// PyTorch twin beside it (xgre_jacobian_plain) computes the same recurrence
// with the same operation order.
//
// What it computes: xgre.cu's train for G = V + 1 plane groups -- group 0
// the primal, groups 1..V one tangent per fit variable.  The variables
// enter only through the exchange stage matrices and the (per-atom)
// equilibrium densities, so saturation, rotation and shift act on every
// group alike, and each exchange stage adds the product-rule term
// t'_i = sum_j [M_ij (t_j - de_j) + dM_ij (x_j - e_j)] + de_i, whose x is
// the primal from BEFORE the mix (the tangents are mixed first).  Inputs:
// per-atom densities (G C, B) rows g C + c, coefficients (G 6 C C, B) rows
// g 6CC + stage 3CC + part CC + i C + j.  Output planes (2, N, G, C, B):
// (re, im) of F0 per TR, group and compartment.
//
// What bounds it on the card: G times xgre.cu's rotations plus 2 G - 1
// complex mixes per row (the tangent mix is two products); at C = 2, G =
// 3, nstate 10, 262,144 atoms x 48 TRs ~1.5e11 operations (~2.3 ms at the
// FP32 peak): compute-bound.  Design: one thread per atom, the 6 C G planes
// in shared memory at [plane][row][threadIdx.x]; the 6 C^2 G per-atom
// matrix coefficients are constant over the train and are loaded into
// registers once, before the TR loop (they spill to local memory at the
// largest C G); the rows of every group are read once per TR, and each
// group's rows go back through its own folded-shift row walk.  Templates:
// C = 1..4 compartments, G = 2..5 groups, C G <= 12.  The ragged atom edge
// is masked.
#include <cuda_runtime.h>

#include "epg_planes.cuh"

namespace {

constexpr float kDeg = 0.017453292519943295f;   // pi / 180

struct XgreJacArgs {
    const float* alpha;  // (N, C) flips, degrees
    const float* phi;    // (N, C) phases, degrees
    const float* sfr;    // (N, C) saturation of F+, re
    const float* sfi;    //                          im
    const float* szr;    // (N, C) saturation of Z, re
    const float* szi;    //                         im
    const float* b1;     // (B,) flip scale
    const float* dens;   // (G C, B) densities and their tangents
    const float* coef;   // (G 6 C C, B) stage matrices and their tangents
    float* out;          // (2, N, G, C, B): re, im
    int N, B, H, shift;
};

template <int C, int G>
__global__ void xgre_jac_kernel(const XgreJacArgs p) {
    extern __shared__ float smem[];
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= p.B) return;  // ragged edge; no barrier follows
    const int H = p.H;
    const int ld = static_cast<int>(blockDim.x);
    epg::PlaneSet s[G][C];
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
        for (int c = 0; c < C; ++c)
            s[g][c] = epg::PlaneSet{
                smem + threadIdx.x + 6 * (g * C + c) * H * ld, H, ld};

    epg::XMix<C> mA[G], mB[G];
    float dens[G][C];
#pragma unroll
    for (int g = 0; g < G; ++g) {
        const float* rows = p.coef + static_cast<size_t>(g) * 6 * C * C * p.B;
        mA[g] = epg::load_xmix<C>(rows, p.B, b);
        mB[g] = epg::load_xmix<C>(rows + 3 * C * C * p.B, p.B, b);
#pragma unroll
        for (int c = 0; c < C; ++c)
            dens[g][c] = p.dens[static_cast<size_t>(g * C + c) * p.B + b];
    }
    const float B1 = p.b1[b];

#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
        for (int c = 0; c < C; ++c) {
            for (int j = 0; j < 6; ++j)
                for (int k = 0; k < H; ++k) s[g][c].at(j, k) = 0.0f;
            if (g == 0) s[g][c].at(4, 0) = 1.0f;   // tangents start at 0
        }

    const size_t plane = static_cast<size_t>(p.N) * G * C * p.B;
    for (int i = 0; i < p.N; ++i) {
        epg::Rot r[C];
        float fr[C], fi[C], zr[C], zi[C];
#pragma unroll
        for (int c = 0; c < C; ++c) {
            const int q = i * C + c;
            const float ph = p.phi[q] * kDeg;
            float sp, cp, s2p, c2p;
            sincosf(ph, &sp, &cp);
            sincosf(2.0f * ph, &s2p, &c2p);
            r[c] = epg::rot_coeffs(p.alpha[q] * kDeg * B1, cp, sp, c2p, s2p);
            fr[c] = p.sfr[q];
            fi[c] = p.sfi[q];
            zr[c] = p.szr[q];
            zi[c] = p.szi[q];
        }
        epg::StageShift sh[G][C];
#pragma unroll
        for (int g = 0; g < G; ++g)
#pragma unroll
            for (int c = 0; c < C; ++c)
                sh[g][c] = epg::StageShift(s[g][c], p.shift);
        for (int k = 0; k < H; ++k) {
            const bool k0 = k == 0;
            epg::Row x[G][C], y[G][C];
#pragma unroll
            for (int g = 0; g < G; ++g)
#pragma unroll
                for (int c = 0; c < C; ++c)
                    x[g][c] = epg::rotate(r[c], epg::saturate(
                        epg::read_row(s[g][c], k), fr[c], fi[c], zr[c],
                        zi[c]));
            // stage A: the tangents first (they read the pre-mix primal)
#pragma unroll
            for (int g = 1; g < G; ++g)
                epg::mix_tangent_rows<C>(mA[0], mA[g], dens[0], dens[g], k0,
                                         x[g], x[0], y[g]);
            epg::mix_rows<C>(mA[0], dens[0], k0, x[0], y[0]);
            if (k0) {
#pragma unroll
                for (int g = 0; g < G; ++g)
#pragma unroll
                    for (int c = 0; c < C; ++c) {
                        const size_t o =
                            ((static_cast<size_t>(i) * G + g) * C + c) * p.B
                            + b;
                        p.out[o] = y[g][c].AR;
                        p.out[plane + o] = y[g][c].AI;
                    }
            }
            // stage B
#pragma unroll
            for (int g = 1; g < G; ++g)
                epg::mix_tangent_rows<C>(mB[0], mB[g], dens[0], dens[g], k0,
                                         y[g], y[0], x[g]);
            epg::mix_rows<C>(mB[0], dens[0], k0, y[0], x[0]);
#pragma unroll
            for (int g = 0; g < G; ++g)
#pragma unroll
                for (int c = 0; c < C; ++c)
                    sh[g][c].put(k, x[g][c].AR, x[g][c].AI, x[g][c].BR,
                                 x[g][c].BI, x[g][c].ZR, x[g][c].ZI);
        }
#pragma unroll
        for (int g = 0; g < G; ++g)
#pragma unroll
            for (int c = 0; c < C; ++c) sh[g][c].finish();
    }
}

template <int C, int G>
int launch(const XgreJacArgs& a, int block, void* stream) {
    const size_t smem = sizeof(float) * 6 * C * G
                        * static_cast<size_t>(a.H) * block;
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            xgre_jac_kernel<C, G>,
            cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (e != cudaSuccess) return static_cast<int>(e);
    }
    const int grid = (a.B + block - 1) / block;
    xgre_jac_kernel<C, G><<<grid, block, smem,
                            static_cast<cudaStream_t>(stream)>>>(a);
    return static_cast<int>(cudaGetLastError());
}

// G = 2..5 groups with C G <= 12 (at most 72 planes): instances beyond
// spill most of their registers and only lengthen the build
template <int C>
int launch_g(const XgreJacArgs& a, int G, int block, void* stream) {
    if (C * G > 12) return static_cast<int>(cudaErrorInvalidValue);
    switch (G) {
        case 2: return launch<C, 2>(a, block, stream);
        case 3: return launch<C, (C <= 4 ? 3 : 2)>(a, block, stream);
        case 4: return launch<C, (C <= 3 ? 4 : 2)>(a, block, stream);
        case 5: return launch<C, (C <= 2 ? 5 : 2)>(a, block, stream);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

}  // namespace

// Launch on `stream` of CUDA device `device`; allocates nothing.  Returns
// the CUDA error code of the launch (0 on success; cudaErrorInvalidValue
// for C outside 1..4, G outside 2..5 or C G > 12); the caller raises on
// anything else.
extern "C" int epg_xgre_jac(const float* alpha, const float* phi,
                            const float* sfr, const float* sfi,
                            const float* szr, const float* szi,
                            const float* b1, const float* dens,
                            const float* coef, float* out, int N, int C,
                            int G, int B, int nstate, int shift, int block,
                            int device, void* stream) {
    XgreJacArgs a{alpha, phi, sfr, sfi, szr, szi, b1, dens, coef, out,
                  N, B, nstate + 1, shift};
    const cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return static_cast<int>(e);
    switch (C) {
        case 1: return launch_g<1>(a, G, block, stream);
        case 2: return launch_g<2>(a, G, block, stream);
        case 3: return launch_g<3>(a, G, block, stream);
        case 4: return launch_g<4>(a, G, block, stream);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}
