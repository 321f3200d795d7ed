// composite.cu -- composite-GRE stage trains: MPRAGE, cardiac MRF with IR
// and T2prep preps, saturation recovery, DW-prepared trains.
//
// Replaces the TPU kernel epgpy_tpu/models/pallas_composite.py:_kernel_comp
// (:69, with its helper _datten :41), driven there by composite_pallas
// (:274); the Python wrapper is epgpy_torch/models/cuda_composite.py:
// composite_cuda and the plain PyTorch twin beside it (composite_plain)
// computes the same recurrence with the same operation order.
//
// What it computes, per atom (T1, T2, B1, df, Dc), over N stages
// [T?, E*, Adc?, E*, S(+-1)?, D?] described by ten per-stage tables (flip,
// phase, relaxation before and after the readout ta and tb, the output row
// adci or -1, the shift direction, the ADC phase, the B1 sensitivity b1u,
// the b-value base btd and the ramp direction rdir): the folded half-ladder
// of fisp_half.cu (six planes A/B/Z re+im of H = nstate + 1 rows from
// Z(0) = 1).  Per stage: every row is rotated once by a = fa (1 + b1u
// (B1 - 1)) (b1u = 0: an adiabatic pulse, the same angle for every atom);
// the echo is the rotated k = 0 row decayed over ta and phased by the df
// and ADC phasors, written to output row adci; the rows relax over ta + tb
// with the recovery at k = 0 (k-independent relaxation commutes with the
// readout); the ladder shifts up, down or not at all; a D stage closes with
// its attenuation by destination row.  Output planes (2, nadc, B): the
// engine's layout, with no reorder pass.
//
// What bounds it on the card: per atom per stage the rotation of H rows
// (~70 FP32 operations each) plus a few transcendentals per stage; at
// nstate 10, 128k atoms x 275 stages ~3e10 operations (0.4 ms at the FP32
// peak) against 2 x 256 x 128k x 4 bytes out (0.08 ms at 3.35 TB/s):
// compute-bound.  The design is fisp_half.cu's: one thread per atom runs
// the whole train, the planes sit in shared memory at
// [plane][row][threadIdx.x] (conflict-free, no barrier), the stage tables
// are read from global memory at each stage by every thread at one address
// (a broadcast: up to 8192 stages are too many for constant memory), and
// the branches on adci, the shift and the D stage are uniform across the
// block.  The shift is a row walk in place (epg::StageShift: FoldedShift
// up, DownShift down); the attenuation is a second pass over the
// destination rows, computed per row because btd changes from stage to
// stage.  The ragged atom edge is masked; math is precise.
#include <cuda_runtime.h>

#include "epg_planes.cuh"

namespace {

constexpr float kDeg = 0.017453292519943295f;   // pi / 180
constexpr float kTwoPi = 6.283185307179586f;

struct CompArgs {
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
    float* out;         // (2, nadc, B): re, im
    int N, B, H, nadc;
    int use_df, use_up, use_down, use_adcph, use_b1u, use_d;
};

__global__ void composite_kernel(const CompArgs p) {
    extern __shared__ float smem[];
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= p.B) return;  // ragged edge; no barrier follows
    const int H = p.H;
    const epg::PlaneSet s{smem + threadIdx.x, H, static_cast<int>(blockDim.x)};
    const bool cdf = p.use_df != 0;

    const float T1 = p.t1[b];
    const float T2 = p.t2[b];
    const float B1 = p.b1[b];
    const float DF = cdf ? p.df[b] : 0.0f;
    const float Dc = p.use_d ? p.dc[b] : 0.0f;

    for (int j = 0; j < 6; ++j)
        for (int k = 0; k < H; ++k) s.at(j, k) = 0.0f;
    s.at(4, 0) = 1.0f;

    const size_t plane = static_cast<size_t>(p.nadc) * p.B;

    for (int i = 0; i < p.N; ++i) {
        const float fa = p.fa[i];
        const float ph = p.phi[i] * kDeg;
        float sp, cp, s2p, c2p;
        sincosf(ph, &sp, &cp);
        sincosf(2.0f * ph, &s2p, &c2p);
        const float a = p.use_b1u ? fa * (1.0f + p.b1u[i] * (B1 - 1.0f)) * kDeg
                                  : fa * B1 * kDeg;
        const epg::Rot r = epg::rot_coeffs(a, cp, sp, c2p, s2p);

        const float ta = p.ta[i];
        const float tb = p.tb[i];
        const float e1a = expf(-ta / T1);
        const float e1b = expf(-tb / T1);
        const float e2a = expf(-ta / T2);
        const float cF = e2a * expf(-tb / T2);
        const float cZ = e1a * e1b;
        const float rec = 1.0f - cZ;
        float cFr = cF, cFi = 0.0f;
        if (cdf) {
            float pI, pR;
            sincosf(kTwoPi * DF * (ta + tb), &pI, &pR);
            cFr = cF * pR;
            cFi = cF * pI;
        }
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

        int dir = p.shift[i];
        if (!((dir > 0 && p.use_up) || (dir < 0 && p.use_down))) dir = 0;
        epg::StageShift sh(s, dir);
        for (int k = 0; k < H; ++k) {
            const epg::Row R = epg::rotate(r, epg::read_row(s, k));
            if (k == 0) {
                const int idx = p.adci[i];
                if (idx >= 0 && idx < p.nadc) {
                    float eR = e2a * R.AR, eI = e2a * R.AI;
                    if (phased) epg::cmul(pc, ps, eR, eI, eR, eI);
                    const size_t o = static_cast<size_t>(idx) * p.B + b;
                    p.out[o] = eR;
                    p.out[plane + o] = eI;
                }
            }
            float nAR, nAI, nBR, nBI;
            epg::fdecay(cdf, cFr, cFi, R.AR, R.AI, nAR, nAI);
            epg::fdecay(cdf, cFr, cFi, R.BR, R.BI, nBR, nBI);
            float nZR = cZ * R.ZR;
            if (k == 0) nZR = nZR + rec;
            sh.put(k, nAR, nAI, nBR, nBI, nZR, cZ * R.ZI);
        }
        sh.finish();
        if (p.use_d) {
            const float bt = p.btd[i];
            if (bt != 0.0f) {   // a stage without D: every factor is 1
                const float rd = p.rdir[i];
                for (int k = 0; k < H; ++k)
                    epg::attenuate_row(s, k, epg::stage_att(k, bt, rd, Dc));
            }
        }
    }
}

}  // namespace

// Launch on `stream` of CUDA device `device`; allocates nothing.  Returns
// the CUDA error code of the launch (0 on success); the caller raises on
// anything else.
extern "C" int epg_composite(const float* fa, const float* phi,
                             const float* ta, const float* tb,
                             const int* adci, const int* shift,
                             const float* aph, const float* b1u,
                             const float* btd, const float* rdir,
                             const float* t1, const float* t2,
                             const float* b1, const float* df,
                             const float* dc, float* out, int N, int B,
                             int nadc, int nstate, int use_df, int use_up,
                             int use_down, int use_adcph, int use_b1u,
                             int use_d, int block, int device, void* stream) {
    CompArgs a{fa, phi, ta, tb, adci, shift, aph, b1u, btd, rdir, t1, t2, b1,
               df, dc, out, N, B, nstate + 1, nadc, use_df, use_up, use_down,
               use_adcph, use_b1u, use_d};
    cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return static_cast<int>(e);
    const size_t smem = sizeof(float) * 6 * static_cast<size_t>(a.H) * block;
    if (smem > 48 * 1024) {
        e = cudaFuncSetAttribute(
            composite_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (e != cudaSuccess) return static_cast<int>(e);
    }
    const int grid = (B + block - 1) / block;
    composite_kernel<<<grid, block, smem,
                       static_cast<cudaStream_t>(stream)>>>(a);
    return static_cast<int>(cudaGetLastError());
}
