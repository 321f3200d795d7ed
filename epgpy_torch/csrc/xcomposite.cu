// xcomposite.cu -- composite EPG-X stage trains over C exchanging
// compartments: MT-prepared segmented GRE, IR-MT, saturation-recovery MT.
//
// Replaces the TPU kernel epgpy_tpu/models/pallas_xcomposite.py:
// _kernel_xcomp (:51), driven there by xcomposite_pallas (:147); the Python
// wrapper is epgpy_torch/models/cuda_xcomposite.py:xcomposite_cuda and the
// plain PyTorch twin beside it (xcomposite_plain) computes the same
// recurrence with the same operation order.
//
// What it computes, per atom, over N stages [R(sat)?, T?, X(ta)*, ADC?,
// X(tb)*, S(+-1)?] described by per-stage tables (flips and phases per
// compartment, saturation factors, the output row adci or -1, the shift
// direction, the ADC phase, the B1 sensitivity b1u and the indices mia,
// mib of the pre- and post-readout exchange matrices): xgre.cu's 6C planes
// from Z(0) = 1.  Per stage: saturation (when any stage has one), the
// rotation by alpha_ic (1 + b1u (B1 - 1)) (b1u = 0: an adiabatic pulse)
// about phi_ic, then row by row the mix with table entry mia, the readout
// of each compartment's F+(0) (phased by the ADC phase) to row adci, the
// mix with entry mib and the stage's shift (up, down or none).  The table
// holds one set of per-atom matrices per distinct accumulated tau; entry 0
// is the identity.  Output planes (2, nadc, C, B).
//
// What bounds it on the card: per atom per stage and row, C rotations
// (~70 FP32 operations each) and two C x C complex mixes; at C = 2,
// nstate 8, 131,072 atoms x 108 stages ~3e10 operations (~0.5 ms at the
// FP32 peak) against 2 x 100 x 2 x 131,072 x 4 bytes out (0.06 ms):
// compute-bound.  Design: composite.cu's -- one thread per atom, the 6C
// planes in shared memory at [plane][row][threadIdx.x], the per-stage
// tables read from global memory by every thread at one address (a
// broadcast), uniform branches on adci and the shift -- with xgre.cu's mix:
// each stage loads its two table entries' 6 C^2 per-atom coefficients
// (coalesced across the block) into registers before its row walk.  The
// rows go back through epg::StageShift (FoldedShift up, DownShift down) per
// compartment.  Template C = 1..4.  The ragged atom edge is masked.
#include <cuda_runtime.h>

#include "epg_planes.cuh"

namespace {

constexpr float kDeg = 0.017453292519943295f;   // pi / 180

struct XcompArgs {
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
    const float* dens;   // (C,) equilibrium densities
    const float* b1;     // (B,) flip scale
    const float* table;  // (nmat, 3 C C, B) stage matrices
    float* out;          // (2, nadc, C, B): re, im
    int N, B, H, nadc;
    int use_up, use_down, use_adcph, use_sat, use_b1u;
};

template <int C>
__global__ void xcomp_kernel(const XcompArgs p) {
    extern __shared__ float smem[];
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= p.B) return;  // ragged edge; no barrier follows
    const int H = p.H;
    const int ld = static_cast<int>(blockDim.x);
    epg::PlaneSet s[C];
#pragma unroll
    for (int c = 0; c < C; ++c)
        s[c] = epg::PlaneSet{smem + threadIdx.x + 6 * c * H * ld, H, ld};
    float dens[C];
#pragma unroll
    for (int c = 0; c < C; ++c) dens[c] = p.dens[c];
    const float B1 = p.b1[b];
    const size_t mat = static_cast<size_t>(3 * C * C) * p.B;

#pragma unroll
    for (int c = 0; c < C; ++c) {
        for (int j = 0; j < 6; ++j)
            for (int k = 0; k < H; ++k) s[c].at(j, k) = 0.0f;
        s[c].at(4, 0) = 1.0f;
    }

    const size_t plane = static_cast<size_t>(p.nadc) * C * p.B;
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
        const epg::XMix<C> mA = epg::load_xmix<C>(p.table + p.mia[i] * mat,
                                                  p.B, b);
        const epg::XMix<C> mB = epg::load_xmix<C>(p.table + p.mib[i] * mat,
                                                  p.B, b);
        const int idx = p.adci[i];
        const bool write = idx >= 0 && idx < p.nadc;
        float pc = 1.0f, ps = 0.0f;
        if (p.use_adcph) sincosf(p.aph[i], &ps, &pc);
        int dir = p.shift[i];
        if (!((dir > 0 && p.use_up) || (dir < 0 && p.use_down))) dir = 0;
        epg::StageShift sh[C];
#pragma unroll
        for (int c = 0; c < C; ++c) sh[c] = epg::StageShift(s[c], dir);
        for (int k = 0; k < H; ++k) {
            epg::Row x[C], y[C];
#pragma unroll
            for (int c = 0; c < C; ++c) {
                epg::Row v = epg::read_row(s[c], k);
                if (p.use_sat) v = epg::saturate(v, fr[c], fi[c], zr[c],
                                                 zi[c]);
                x[c] = epg::rotate(r[c], v);
            }
            epg::mix_rows<C>(mA, dens, k == 0, x, y);
            if (k == 0 && write) {
#pragma unroll
                for (int c = 0; c < C; ++c) {
                    float eR = y[c].AR, eI = y[c].AI;
                    if (p.use_adcph) epg::cmul(pc, ps, eR, eI, eR, eI);
                    const size_t o =
                        (static_cast<size_t>(idx) * C + c) * p.B + b;
                    p.out[o] = eR;
                    p.out[plane + o] = eI;
                }
            }
            epg::mix_rows<C>(mB, dens, k == 0, y, x);
#pragma unroll
            for (int c = 0; c < C; ++c)
                sh[c].put(k, x[c].AR, x[c].AI, x[c].BR, x[c].BI, x[c].ZR,
                          x[c].ZI);
        }
#pragma unroll
        for (int c = 0; c < C; ++c) sh[c].finish();
    }
}

template <int C>
int launch(const XcompArgs& a, int block, void* stream) {
    const size_t smem = sizeof(float) * 6 * C * static_cast<size_t>(a.H)
                        * block;
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            xcomp_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (e != cudaSuccess) return static_cast<int>(e);
    }
    const int grid = (a.B + block - 1) / block;
    xcomp_kernel<C><<<grid, block, smem,
                      static_cast<cudaStream_t>(stream)>>>(a);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream` of CUDA device `device`; allocates nothing.  Returns
// the CUDA error code of the launch (0 on success; cudaErrorInvalidValue
// for C outside 1..4); the caller raises on anything else.
extern "C" int epg_xcomposite(const float* alpha, const float* phi,
                              const float* sfr, const float* sfi,
                              const float* szr, const float* szi,
                              const int* adci, const int* shift,
                              const float* aph, const int* mia,
                              const int* mib, const float* b1u,
                              const float* dens, const float* b1,
                              const float* table, float* out, int N, int C,
                              int B, int nadc, int nstate, int use_up,
                              int use_down, int use_adcph, int use_sat,
                              int use_b1u, int block, int device,
                              void* stream) {
    XcompArgs a{alpha, phi, sfr, sfi, szr, szi, adci, shift, aph, mia, mib,
                b1u, dens, b1, table, out, N, B, nstate + 1, nadc, use_up,
                use_down, use_adcph, use_sat, use_b1u};
    const cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return static_cast<int>(e);
    switch (C) {
        case 1: return launch<1>(a, block, stream);
        case 2: return launch<2>(a, block, stream);
        case 3: return launch<3>(a, block, stream);
        case 4: return launch<4>(a, block, stream);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}
