// xcomposite_jac.cu -- composite EPG-X stage trains and their tangents in
// one pass: per-voxel qMT Gauss-Newton fits over MT-prepared schedules.
//
// Replaces the TPU kernel epgpy_tpu/models/pallas_xcomposite.py:
// _kernel_xcomp_jac (:292), driven there by xcomposite_jacobian_pallas
// (:475); the Python wrapper is epgpy_torch/models/cuda_xcomposite.py:
// xcomposite_jacobian_cuda and the plain PyTorch twin beside it
// (xcomposite_jacobian_plain) computes the same recurrence with the same
// operation order.
//
// What it computes: xcomposite.cu's train for G = V + 1 plane groups (the
// primal, then one tangent per fit variable).  Variables enter only through
// the stage-matrix tables and the per-atom densities, so saturation,
// rotation and shift act on every group alike; each table mix adds the
// product-rule term t'_i = sum_j [M_ij (t_j - de_j) + dM_ij (x_j - e_j)] +
// de_i with the group's tangent table entry, x the primal from before the
// mix.  Inputs: densities (G C, B) rows g C + c; tables (G, nmat, 3 C C,
// B).  Output planes (2, nadc, G, C, B).
//
// What bounds it on the card: G times xcomposite.cu's rotations and 2 G - 1
// complex mixes per row; at C = 2, G = 2, nstate 8, 65,536 atoms x 108
// stages ~2.6e10 operations (~0.4 ms at the FP32 peak): compute-bound.
// Design: one thread per atom, the 6 C G planes in shared memory at
// [plane][row][threadIdx.x]; per stage every group's two table entries
// (6 C^2 G per-atom floats, coalesced across the block) are loaded into
// registers before the row walk; each group's rows go back through its own
// epg::StageShift.  Templates: C = 1..4, G = 2..5, C G <= 12.  The ragged
// atom edge is masked.
#include <cuda_runtime.h>

#include "epg_planes.cuh"

namespace {

constexpr float kDeg = 0.017453292519943295f;   // pi / 180

struct XcompJacArgs {
    const float* alpha;  // (N, C) flips, degrees
    const float* phi;    // (N, C) phases, degrees
    const float* sfr;    // (N, C) saturation of F+, re (use_sat)
    const float* sfi;    //                          im
    const float* szr;    // (N, C) saturation of Z, re
    const float* szi;    //                         im
    const int* adci;     // (N,) output row, -1 = no readout
    const int* shift;    // (N,) shift direction in {-1, 0, +1}
    const float* aph;    // (N,) ADC phase, radians (use_adcph)
    const int* mia;      // (N,) table entry before the readout
    const int* mib;      // (N,) table entry after the readout
    const float* b1u;    // (N,) B1 sensitivity (use_b1u)
    const float* dens;   // (G C, B) densities and their tangents
    const float* b1;     // (B,) flip scale
    const float* table;  // (G, nmat, 3 C C, B) tables and their tangents
    float* out;          // (2, nadc, G, C, B): re, im
    int N, B, H, nadc, nmat;
    int use_up, use_down, use_adcph, use_sat, use_b1u;
};

template <int C, int G>
__global__ void xcomp_jac_kernel(const XcompJacArgs p) {
    extern __shared__ float smem[];
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= p.B) return;  // ragged edge; no barrier follows
    const int H = p.H;
    const int ld = static_cast<int>(blockDim.x);
    epg::PlaneSet s[G][C];
    float dens[G][C];
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
        for (int c = 0; c < C; ++c) {
            s[g][c] = epg::PlaneSet{
                smem + threadIdx.x + 6 * (g * C + c) * H * ld, H, ld};
            dens[g][c] = p.dens[static_cast<size_t>(g * C + c) * p.B + b];
        }
    const float B1 = p.b1[b];
    const size_t mat = static_cast<size_t>(3 * C * C) * p.B;

#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
        for (int c = 0; c < C; ++c) {
            for (int j = 0; j < 6; ++j)
                for (int k = 0; k < H; ++k) s[g][c].at(j, k) = 0.0f;
            if (g == 0) s[g][c].at(4, 0) = 1.0f;   // tangents start at 0
        }

    const size_t plane = static_cast<size_t>(p.nadc) * G * C * p.B;
    for (int i = 0; i < p.N; ++i) {
        const float eff = p.use_b1u ? 1.0f + p.b1u[i] * (B1 - 1.0f) : B1;
        epg::Rot r[C];
        float fr[C] = {}, fi[C] = {}, zr[C] = {}, zi[C] = {};
#pragma unroll
        for (int c = 0; c < C; ++c) {
            const int q = i * C + c;
            const float ph = p.phi[q] * kDeg;
            float sp, cp, s2p, c2p;
            sincosf(ph, &sp, &cp);
            sincosf(2.0f * ph, &s2p, &c2p);
            r[c] = epg::rot_coeffs(p.alpha[q] * kDeg * eff, cp, sp, c2p,
                                   s2p);
            if (p.use_sat) {
                fr[c] = p.sfr[q];
                fi[c] = p.sfi[q];
                zr[c] = p.szr[q];
                zi[c] = p.szi[q];
            }
        }
        epg::XMix<C> mA[G], mB[G];
#pragma unroll
        for (int g = 0; g < G; ++g) {
            const float* tg = p.table + static_cast<size_t>(g) * p.nmat * mat;
            mA[g] = epg::load_xmix<C>(tg + p.mia[i] * mat, p.B, b);
            mB[g] = epg::load_xmix<C>(tg + p.mib[i] * mat, p.B, b);
        }
        const int idx = p.adci[i];
        const bool write = idx >= 0 && idx < p.nadc;
        float pc = 1.0f, ps = 0.0f;
        if (p.use_adcph) sincosf(p.aph[i], &ps, &pc);
        int dir = p.shift[i];
        if (!((dir > 0 && p.use_up) || (dir < 0 && p.use_down))) dir = 0;
        epg::StageShift sh[G][C];
#pragma unroll
        for (int g = 0; g < G; ++g)
#pragma unroll
            for (int c = 0; c < C; ++c)
                sh[g][c] = epg::StageShift(s[g][c], dir);
        for (int k = 0; k < H; ++k) {
            const bool k0 = k == 0;
            epg::Row x[G][C], y[G][C];
#pragma unroll
            for (int g = 0; g < G; ++g)
#pragma unroll
                for (int c = 0; c < C; ++c) {
                    epg::Row v = epg::read_row(s[g][c], k);
                    if (p.use_sat) v = epg::saturate(v, fr[c], fi[c], zr[c],
                                                     zi[c]);
                    x[g][c] = epg::rotate(r[c], v);
                }
            // the tangents first: they read the pre-mix primal
#pragma unroll
            for (int g = 1; g < G; ++g)
                epg::mix_tangent_rows<C>(mA[0], mA[g], dens[0], dens[g], k0,
                                         x[g], x[0], y[g]);
            epg::mix_rows<C>(mA[0], dens[0], k0, x[0], y[0]);
            if (k0 && write) {
#pragma unroll
                for (int g = 0; g < G; ++g)
#pragma unroll
                    for (int c = 0; c < C; ++c) {
                        float eR = y[g][c].AR, eI = y[g][c].AI;
                        if (p.use_adcph) epg::cmul(pc, ps, eR, eI, eR, eI);
                        const size_t o =
                            ((static_cast<size_t>(idx) * G + g) * C + c)
                            * p.B + b;
                        p.out[o] = eR;
                        p.out[plane + o] = eI;
                    }
            }
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
int launch(const XcompJacArgs& a, int block, void* stream) {
    const size_t smem = sizeof(float) * 6 * C * G
                        * static_cast<size_t>(a.H) * block;
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            xcomp_jac_kernel<C, G>,
            cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (e != cudaSuccess) return static_cast<int>(e);
    }
    const int grid = (a.B + block - 1) / block;
    xcomp_jac_kernel<C, G><<<grid, block, smem,
                             static_cast<cudaStream_t>(stream)>>>(a);
    return static_cast<int>(cudaGetLastError());
}

// G = 2..5 groups with C G <= 12 (at most 72 planes): instances beyond
// spill most of their registers and only lengthen the build
template <int C>
int launch_g(const XcompJacArgs& a, int G, int block, void* stream) {
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
extern "C" int epg_xcomposite_jac(const float* alpha, const float* phi,
                                  const float* sfr, const float* sfi,
                                  const float* szr, const float* szi,
                                  const int* adci, const int* shift,
                                  const float* aph, const int* mia,
                                  const int* mib, const float* b1u,
                                  const float* dens, const float* b1,
                                  const float* table, float* out, int N,
                                  int C, int G, int B, int nadc, int nmat,
                                  int nstate, int use_up, int use_down,
                                  int use_adcph, int use_sat, int use_b1u,
                                  int block, int device, void* stream) {
    XcompJacArgs a{alpha, phi, sfr, sfi, szr, szi, adci, shift, aph, mia,
                   mib, b1u, dens, b1, table, out, N, B, nstate + 1, nadc,
                   nmat, use_up, use_down, use_adcph, use_sat, use_b1u};
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
