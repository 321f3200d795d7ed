// xgre.cu -- EPG-X gradient-echo trains over C exchanging compartments:
// two-pool MT-GRE (spoiled) and bSSFP-MT (balanced) dictionaries.
//
// Replaces the TPU kernel epgpy_tpu/models/pallas_xgre.py:_kernel_xgre
// (:48), driven there by xgre_dictionary_pallas (:142); the Python wrapper
// is epgpy_torch/models/cuda_xgre.py:xgre_dictionary_cuda and the plain
// PyTorch twin beside it (xgre_dictionary_plain) computes the same
// recurrence with the same operation order.
//
// What it computes, per atom, over N TRs [R(sat)?, T, X(A)?, ADC, X(B)?,
// S(1)?]: one folded half-ladder (six planes A/B/Z re+im of H = nstate + 1
// rows) per compartment, Z(0) = 1 in each.  Per TR and compartment c: the
// saturation factors (F+ planes times conj(e^{-rT}), Z times e^{-rL}), the
// rotation by alpha_ic * B1 about phi_ic; then, row by row, the exchange
// stage A (the C x C mix of the compartments' rows with the per-atom
// matrices mT, mL around the k = 0 equilibrium of densities dens), the
// readout of each compartment's F+(0), stage B and the unit shift (none
// for a balanced train, which runs at nstate 0).  An absent stage has
// identity matrices.  Output planes (2, N, C, B): (re, im) of F0 per TR
// and compartment.
//
// What bounds it on the card: per atom per TR and row, C rotations (~70
// FP32 operations each) and two C x C complex mixes (~16 C^2); at C = 2,
// nstate 10, 262,144 atoms x 100 TRs ~1e11 operations (~1.6 ms at the
// FP32 peak) against 2 x 100 x 2 x 262,144 x 4 bytes out (0.13 ms):
// compute-bound.  The design is fisp_half.cu's: one thread per atom runs
// the whole train, the 6C planes sit in shared memory at
// [plane][row][threadIdx.x] (conflict-free, no barrier), each row is read
// once per TR and written back through the folded shift's row walk
// (epg::FoldedShift, one per compartment).  The per-atom stage matrices
// are constant over the train: their 6 C^2 floats are loaded into
// registers once, before the TR loop.  Template C = 1..4 unrolls the mix.
// The ragged atom edge is masked; math is precise.
#include <cuda_runtime.h>

#include "epg_planes.cuh"

namespace {

constexpr float kDeg = 0.017453292519943295f;   // pi / 180

struct XgreArgs {
    const float* alpha;  // (N, C) flips, degrees
    const float* phi;    // (N, C) phases, degrees
    const float* sfr;    // (N, C) saturation of F+: conj(e^{-rT}), re
    const float* sfi;    //                                         im
    const float* szr;    // (N, C) saturation of Z: e^{-rL}, re
    const float* szi;    //                                  im
    const float* dens;   // (C,) equilibrium densities
    const float* b1;     // (B,) flip scale
    const float* coef;   // (6 C C, B): stage A then B, parts mT re/im, mL
    float* out;          // (2, N, C, B): re, im
    int N, B, H, shift;
};

template <int C>
__global__ void xgre_kernel(const XgreArgs p) {
    extern __shared__ float smem[];
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= p.B) return;  // ragged edge; no barrier follows
    const int H = p.H;
    const int ld = static_cast<int>(blockDim.x);
    epg::PlaneSet s[C];
#pragma unroll
    for (int c = 0; c < C; ++c)
        s[c] = epg::PlaneSet{smem + threadIdx.x + 6 * c * H * ld, H, ld};

    const epg::XMix<C> mA = epg::load_xmix<C>(p.coef, p.B, b);
    const epg::XMix<C> mB = epg::load_xmix<C>(p.coef + 3 * C * C * p.B,
                                              p.B, b);
    float dens[C];
#pragma unroll
    for (int c = 0; c < C; ++c) dens[c] = p.dens[c];
    const float B1 = p.b1[b];

#pragma unroll
    for (int c = 0; c < C; ++c) {
        for (int j = 0; j < 6; ++j)
            for (int k = 0; k < H; ++k) s[c].at(j, k) = 0.0f;
        s[c].at(4, 0) = 1.0f;
    }

    const size_t plane = static_cast<size_t>(p.N) * C * p.B;
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
        epg::StageShift sh[C];
#pragma unroll
        for (int c = 0; c < C; ++c) sh[c] = epg::StageShift(s[c], p.shift);
        for (int k = 0; k < H; ++k) {
            epg::Row x[C], y[C];
#pragma unroll
            for (int c = 0; c < C; ++c)
                x[c] = epg::rotate(r[c], epg::saturate(
                    epg::read_row(s[c], k), fr[c], fi[c], zr[c], zi[c]));
            epg::mix_rows<C>(mA, dens, k == 0, x, y);
            if (k == 0) {
#pragma unroll
                for (int c = 0; c < C; ++c) {
                    const size_t o =
                        (static_cast<size_t>(i) * C + c) * p.B + b;
                    p.out[o] = y[c].AR;
                    p.out[plane + o] = y[c].AI;
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
int launch(const XgreArgs& a, int block, void* stream) {
    const size_t smem = sizeof(float) * 6 * C * static_cast<size_t>(a.H)
                        * block;
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            xgre_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (e != cudaSuccess) return static_cast<int>(e);
    }
    const int grid = (a.B + block - 1) / block;
    xgre_kernel<C><<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
        a);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream` of CUDA device `device`; allocates nothing.  Returns
// the CUDA error code of the launch (0 on success; cudaErrorInvalidValue
// for C outside 1..4); the caller raises on anything else.
extern "C" int epg_xgre(const float* alpha, const float* phi,
                        const float* sfr, const float* sfi, const float* szr,
                        const float* szi, const float* dens, const float* b1,
                        const float* coef, float* out, int N, int C, int B,
                        int nstate, int shift, int block, int device,
                        void* stream) {
    XgreArgs a{alpha, phi, sfr, sfi, szr, szi, dens, b1, coef, out,
               N, B, nstate + 1, shift};
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
