// cpmg_design.cu -- per-echo CPMG design Jacobian (and mixed Hessian).
//
// Replaces the TPU kernel epgpy_tpu/models/pallas_msedesign.py:
// _kernel_design (:80), driven there by cpmg_design_pallas (:279); the
// Python wrapper is epgpy_torch/models/cuda_msedesign.py:cpmg_design_cuda
// and the plain PyTorch twin beside it (cpmg_design_plain) computes the
// same recurrence with the same operation order.
//
// What it computes, per atom: the forward propagation of 3 + 2E (first
// order) or 3 + 6E (second order) tangents of the CPMG train with
// symmetric half-spacings esp_n / 2 around each refocusing pulse.  Groups
// of folded plane sets (A/B/Z re+im, H = nstate + 1 rows): P (the primal),
// U1 = dP/dT1, U2 = dP/dT2 per atom, and per design variable i (the
// "lane", the echo index) A = d/dalpha_i, T = d/desp_i and, with SECOND,
// W1/W2 = d2/dT1,2 dalpha_i, X1/X2 = d2/dT1,2 desp_i.  Every tangent moves
// by the primal's per-echo operator plus seed terms at its own echo built
// from the per-atom groups; esp_i enters both half-spacings of echo i,
// each with the chain coefficient 1/2.  Lane i is zero before echo i, so
// every output with i > echo j is an exact zero, which the kernel writes.
//
// What bounds it on the card: instruction issue and, at a few atoms, the
// latency of one lane's chain of 2E half-stages, not bytes or operations.
// A lane carries 6 groups x 6 planes x H rows (H = 65 at the example's E
// = 32, nstate 64).  The design: one block per (atom, tile of lanes), one
// warp per lane (a "lane-warp"), the rows of its groups across the warp's
// 32 threads (epg_planes.cuh's warp-row layout: one record of 6 G + 1
// floats per row, odd so the lanes' rows fall in distinct banks; a thread
// touches only its own rows and values cross lanes by shuffles,
// epg::WarpShift).  Tile t of an atom takes lanes t, t + ntiles, ... so
// that the tiles finish together.  The per-atom groups are needed only by
// the seeded lane, but must advance every echo: the block keeps three
// buffers of them (entering the echo, after its first half-stage, after
// its rotation; 18 floats per row each, stored 19 apart), built
// cooperatively by all threads between barriers (four per echo) and read
// row-wise by the lane-warps.  Each tile recomputes them.  The lane work
// is two chunk walks per echo (half-stage 1; rotation fused with
// half-stage 2); every walk, per-atom stages included, stops at the last
// row the echo can have reached (epg::reach): rows beyond hold exact
// zeros.  The causal skip: a lane-warp does no work before its echo, and
// writes its zeros.  Outputs are (2G, B, E, E) floats with the lane index
// innermost.  Math is precise (no fast-math).
#include <cuda_runtime.h>

#include "epg_planes.cuh"

namespace {

constexpr float kDeg = 0.017453292519943295f;   // pi / 180
// floats per ladder row of one per-atom buffer: P, U1, U2 (6 planes each)
// and one more, so that the lane-warps' row reads are conflict-free
constexpr int kAtomRow = 19;

struct DesignArgs {
    float exc_ar, exc_ai, exc_z;   // excited F+(0) (re, im) and Z(0)
    const float* fa;    // (E,) refocusing flips, degrees
    const float* phi;   // (E,) refocusing phases, degrees
    const float* esp;   // (E,) echo spacings, ms
    const float* t1;    // (B,)
    const float* t2;    // (B,)
    float* out_atom;    // (6, B, E): sig, dT1, dT2 as (re, im)
    float* out_lane;    // (2G, B, E, E): per lane group (re, im), [b][j][i]
    int E, B, H, ntiles;
};

constexpr int kMaxTile = 8;   // lane-warps per block

// half-spacing coefficients (pallas_msedesign.py:121-134)
struct Coef {
    float cF, cZ, rec, dcF2, dcZ1, eF, eZ, eF2, eZ1;
};

__device__ __forceinline__ Coef coeffs(float esp, float T1, float T2) {
    Coef c;
    const float tau = 0.5f * esp;
    c.cF = expf(-tau / T2);
    c.cZ = expf(-tau / T1);
    c.rec = 1.0f - c.cZ;
    c.dcF2 = c.cF * tau / (T2 * T2);
    c.dcZ1 = c.cZ * tau / (T1 * T1);
    c.eF = -0.5f * c.cF / T2;
    c.eZ = -0.5f * c.cZ / T1;
    c.eF2 = 0.5f * c.cF * (1.0f - tau / T2) / (T2 * T2);
    c.eZ1 = 0.5f * c.cZ * (1.0f - tau / T1) / (T1 * T1);
    return c;
}

__device__ __forceinline__ void rotate(const epg::Rot& r, const float x[6],
                                       float o[6]) {
    epg::rot_A(r, x[0], x[1], x[2], x[3], x[4], x[5], o[0], o[1]);
    epg::rot_B(r, x[0], x[1], x[2], x[3], x[4], x[5], o[2], o[3]);
    epg::rot_Z(r, x[0], x[1], x[2], x[3], x[4], x[5], o[4], o[5]);
}

// Unshifted new values of per-atom group g (0 P, 1 U1, 2 U2) at source
// row s through E(esp/2), from the buffer `src`.
__device__ __forceinline__ void atom_new(const float* src, int g, int s,
                                         const Coef& c, float o[6]) {
    const float* y = src + s * kAtomRow + 6 * g;
    const float* p = src + s * kAtomRow;
    if (g == 0) {
        for (int j = 0; j < 4; ++j) o[j] = c.cF * y[j];
        o[4] = c.cZ * y[4];
        if (s == 0) o[4] = o[4] + c.rec;
        o[5] = c.cZ * y[5];
    } else if (g == 1) {
        for (int j = 0; j < 4; ++j) o[j] = c.cF * y[j];
        o[4] = c.cZ * y[4] + c.dcZ1 * p[4];
        if (s == 0) o[4] = o[4] - c.dcZ1;
        o[5] = c.cZ * y[5] + c.dcZ1 * p[5];
    } else {
        for (int j = 0; j < 4; ++j) o[j] = c.cF * y[j] + c.dcF2 * p[j];
        o[4] = c.cZ * y[4];
        o[5] = c.cZ * y[5];
    }
}

// Cooperative half-stage of the per-atom groups: dst = Sh(D src + r) on
// rows 0..rows-1 (those it can reach; dst holds zeros beyond), split over
// the block's n threads.
__device__ __forceinline__ void atom_stage(const float* src, float* dst,
                                           const Coef& c, int H, int rows,
                                           int tid, int n) {
    for (int t = tid; t < 3 * rows; t += n) {
        const int g = t / rows, k = t - g * rows;
        float nw[6];
        float* o = dst + k * kAtomRow + 6 * g;
        if (k >= 1) {
            atom_new(src, g, k - 1, c, nw);
            o[0] = nw[0];
            o[1] = nw[1];
        } else {
            atom_new(src, g, 1, c, nw);
            o[0] = nw[2];
            o[1] = nw[3];
        }
        if (k < H - 1) {
            atom_new(src, g, k + 1, c, nw);
            o[2] = nw[2];
            o[3] = nw[3];
        } else {
            o[2] = 0.0f;
            o[3] = 0.0f;
        }
        atom_new(src, g, k, c, nw);
        o[4] = nw[4];
        o[5] = nw[5];
    }
}

// Cooperative rotation of the per-atom groups: dst = M src on rows
// 0..rows-1.
__device__ __forceinline__ void atom_rotate(const float* src, float* dst,
                                            const epg::Rot& r, int rows,
                                            int tid, int n) {
    for (int t = tid; t < 3 * rows; t += n) {
        const int g = t / rows, k = t - g * rows;
        rotate(r, src + k * kAtomRow + 6 * g, dst + k * kAtomRow + 6 * g);
    }
}

__device__ __forceinline__ void read6(const epg::RowSet& s, int k,
                                      float x[6]) {
    const float* r = &s.at(0, k);
#pragma unroll
    for (int j = 0; j < 6; ++j) x[j] = r[j];
}

__device__ __forceinline__ void put6(epg::WarpShift& sh, int k,
                                     const float v[6]) {
    sh.put(k, v[0], v[1], v[2], v[3], v[4], v[5]);
}

// E(esp/2) on row k of the lane groups (pallas_msedesign.py:155-201): the
// unshifted new values, handed to the folded shifts.  y* are the rows
// entering the stage (rotated already in the second half-stage), at the
// per-atom buffer entering it, m = 1 seeds the lane at its own echo.
template <bool SECOND>
__device__ __forceinline__ void lane_put(epg::WarpShift* sh, int k,
                                         const Coef& c, float m,
                                         const float* at, const float yA[6],
                                         const float yT[6],
                                         const float yW1[6],
                                         const float yW2[6],
                                         const float yX1[6],
                                         const float yX2[6]) {
    const float* P = at;
    const float* U1 = at + 6;
    const float* U2 = at + 12;
    const float rowm = k == 0 ? 1.0f : 0.0f;
    const float cF = c.cF, cZ = c.cZ, eF = c.eF, eZ = c.eZ;
    float v[6];
    for (int j = 0; j < 4; ++j) v[j] = cF * yA[j];
    v[4] = cZ * yA[4];
    v[5] = cZ * yA[5];
    put6(sh[0], k, v);
    for (int j = 0; j < 4; ++j) v[j] = cF * yT[j] + m * eF * P[j];
    v[4] = cZ * yT[4] + m * (eZ * P[4] - rowm * eZ);
    v[5] = cZ * yT[5] + m * eZ * P[5];
    put6(sh[1], k, v);
    if constexpr (SECOND) {
        const float dcZ1 = c.dcZ1, dcF2 = c.dcF2, eF2 = c.eF2, eZ1 = c.eZ1;
        for (int j = 0; j < 4; ++j) v[j] = cF * yW1[j];
        v[4] = cZ * yW1[4] + dcZ1 * yA[4];
        v[5] = cZ * yW1[5] + dcZ1 * yA[5];
        put6(sh[2], k, v);
        for (int j = 0; j < 4; ++j) v[j] = cF * yW2[j] + dcF2 * yA[j];
        v[4] = cZ * yW2[4];
        v[5] = cZ * yW2[5];
        put6(sh[3], k, v);
        for (int j = 0; j < 4; ++j) v[j] = cF * yX1[j] + m * eF * U1[j];
        v[4] = cZ * yX1[4] + dcZ1 * yT[4]
            + m * (eZ * U1[4] + eZ1 * P[4] - rowm * eZ1);
        v[5] = cZ * yX1[5] + dcZ1 * yT[5] + m * (eZ * U1[5] + eZ1 * P[5]);
        put6(sh[4], k, v);
        for (int j = 0; j < 4; ++j)
            v[j] = cF * yX2[j] + dcF2 * yT[j] + m * (eF * U2[j] + eF2 * P[j]);
        v[4] = cZ * yX2[4] + m * eZ * U2[4];
        v[5] = cZ * yX2[5] + m * eZ * U2[5];
        put6(sh[5], k, v);
    }
}

// One echo of lane i's groups: half-stage 1, then the rotation (lane A
// seeded with M' P, W1/W2 with M' U1 / M' U2) fused with half-stage 2,
// each over the 32-row chunks echo n can have reached; lanes past the
// ladder's end read its last row and the shifts drop what they compute.
// S0, S1, S2: the per-atom buffers entering the echo, after half-stage 1
// and after the rotation.
template <bool SECOND>
__device__ __forceinline__ void lane_echo(const DesignArgs& p,
                                          const epg::RowSet* s, int n,
                                          int lane, const float* S0,
                                          const float* S1, const float* S2,
                                          const Coef& c, const epg::Rot& r,
                                          const epg::Rot& dr, float m) {
    constexpr int G = SECOND ? 6 : 2;
    const int H = p.H;
    float y[6][6];
    {
        epg::WarpShift sh[G];
#pragma unroll
        for (int g = 0; g < G; ++g) sh[g] = epg::warp_shift(s[g]);
        const int top = epg::reach(n, 1, H);
        for (int k = lane; k - lane <= top; k += epg::kWarp) {
            const int kr = k < H ? k : H - 1;
#pragma unroll
            for (int g = 0; g < G; ++g) read6(s[g], kr, y[g]);
            lane_put<SECOND>(sh, k, c, m, S0 + kr * kAtomRow, y[0], y[1],
                             y[2], y[3], y[4], y[5]);
        }
    }
    {
        epg::WarpShift sh[G];
#pragma unroll
        for (int g = 0; g < G; ++g) sh[g] = epg::warp_shift(s[g]);
        const int top = epg::reach(n, 2, H);
        for (int k = lane; k - lane <= top; k += epg::kWarp) {
            const int kr = k < H ? k : H - 1;
            const float* a1 = S1 + kr * kAtomRow;
#pragma unroll
            for (int g = 0; g < G; ++g) {
                float x[6];
                read6(s[g], kr, x);
                rotate(r, x, y[g]);
            }
            // seeds: d(M)/dalpha applied to the per-atom rows P, U1, U2
            // after half-stage 1, into lane groups A, W1, W2
#pragma unroll
            for (int q = 0; q < (SECOND ? 3 : 1); ++q) {
                const int g = q == 0 ? 0 : q + 1;
                float d[6];
                rotate(dr, a1 + 6 * q, d);
#pragma unroll
                for (int j = 0; j < 6; ++j) y[g][j] = y[g][j] + m * d[j];
            }
            lane_put<SECOND>(sh, k, c, m, S2 + kr * kAtomRow, y[0], y[1],
                             y[2], y[3], y[4], y[5]);
        }
    }
}

template <bool SECOND>
__global__ void __launch_bounds__(kMaxTile * epg::kWarp)
cpmg_design_kernel(const DesignArgs p) {
    constexpr int G = SECOND ? 6 : 2;
    extern __shared__ float smem[];
    const int nthr = static_cast<int>(blockDim.x);
    const int L = nthr / epg::kWarp;
    const int tid = static_cast<int>(threadIdx.x);
    const int lane = tid & (epg::kWarp - 1);
    const int w = tid / epg::kWarp;
    const int H = p.H, E = p.E;
    const int b = blockIdx.x / p.ntiles;
    const int tile = blockIdx.x - b * p.ntiles;
    const int i = tile + w * p.ntiles;  // this warp's lane (echo variable)
    constexpr int S = 6 * G + 1;   // floats per row record (odd)
    float* base = smem + static_cast<size_t>(w) * S * H;
    epg::RowSet s[G];
#pragma unroll
    for (int g = 0; g < G; ++g) s[g] = epg::RowSet{base + 6 * g, S, H};
    float* S0 = smem + static_cast<size_t>(S) * H * L;  // [H][kAtomRow]
    float* S1 = S0 + H * kAtomRow;
    float* S2 = S1 + H * kAtomRow;

    const float T1 = p.t1[b];
    const float T2 = p.t2[b];
    // every plane and per-atom buffer starts at zero (rows beyond the
    // reach stay so); the excited state; U1, U2 start at zero
    for (int t = tid; t < (S * L + 3 * kAtomRow) * H; t += nthr)
        smem[t] = 0.0f;
    __syncthreads();
    if (tid == 0) {
        S0[0] = p.exc_ar;
        S0[1] = p.exc_ai;
        S0[2] = p.exc_ar;
        S0[3] = p.exc_ai;
        S0[4] = p.exc_z;
    }
    __syncthreads();

    const size_t EE = static_cast<size_t>(E) * E;
    const size_t lane_plane = static_cast<size_t>(p.B) * EE;
    const size_t atom_plane = static_cast<size_t>(p.B) * E;
    for (int n = 0; n < E; ++n) {
        const Coef c = coeffs(p.esp[n], T1, T2);
        const float ph = p.phi[n] * kDeg;
        float sp, cp, s2p, c2p, sa, ca;
        sincosf(ph, &sp, &cp);
        sincosf(2.0f * ph, &s2p, &c2p);
        sincosf(p.fa[n] * kDeg, &sa, &ca);
        const epg::Rot r = epg::rot_coeffs_sc(sa, ca, cp, sp, c2p, s2p);
        const epg::Rot dr =
            epg::rot_coeffs_db1(sa, ca, kDeg, cp, sp, c2p, s2p);
        const int rows1 = epg::reach(n, 1, H) + 1;
        const int rows2 = epg::reach(n, 2, H) + 1;

        atom_stage(S0, S1, c, H, rows1, tid, nthr);
        __syncthreads();
        atom_rotate(S1, S2, r, rows1, tid, nthr);
        __syncthreads();
        if (i < E) {   // uniform per warp
            const size_t at = static_cast<size_t>(b) * EE
                + static_cast<size_t>(n) * E + i;
            if (i <= n) {
                lane_echo<SECOND>(p, s, n, lane, S0, S1, S2, c, r, dr,
                                  i == n ? 1.0f : 0.0f);
                __syncwarp();   // row 0 (lane 0's) to lanes 0..2G-1
                if (lane < 2 * G)
                    p.out_lane[lane * lane_plane + at] =
                        base[6 * (lane >> 1) + (lane & 1)];
            } else if (lane < 2 * G) {  // causality: zero before echo i
                p.out_lane[lane * lane_plane + at] = 0.0f;
            }
        }
        __syncthreads();      // S0 is no longer read this echo, nor row 0
        atom_stage(S2, S0, c, H, rows2, tid, nthr);
        __syncthreads();
        if (tile == 0 && tid < 6) {
            // per-atom echoes: row 0 of P, U1, U2 after the second stage
            p.out_atom[tid * atom_plane + static_cast<size_t>(b) * E + n] =
                S0[6 * (tid >> 1) + (tid & 1)];
        }
    }
}

template <bool SECOND>
int launch(const DesignArgs& a, int tile, cudaStream_t stream) {
    constexpr int G = SECOND ? 6 : 2;
    if (tile < 1 || tile > kMaxTile)
        return static_cast<int>(cudaErrorInvalidValue);
    const size_t smem = sizeof(float) * static_cast<size_t>(a.H)
        * (static_cast<size_t>(6 * G + 1) * tile + 3 * kAtomRow);
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            cpmg_design_kernel<SECOND>,
            cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (e != cudaSuccess) return static_cast<int>(e);
    }
    const long long grid = static_cast<long long>(a.ntiles) * a.B;
    cpmg_design_kernel<SECOND><<<static_cast<unsigned>(grid),
                                 tile * epg::kWarp, smem, stream>>>(a);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream` of CUDA device `device`; allocates nothing.  Returns
// the CUDA error code of the launch (0 on success); the caller raises on
// anything else.  `tile` is lane-warps per block (at most 8).
extern "C" int epg_cpmg_design(float exc_ar, float exc_ai, float exc_z,
                               const float* fa, const float* phi,
                               const float* esp, const float* t1,
                               const float* t2, float* out_atom,
                               float* out_lane, int E, int B, int nstate,
                               int second_order, int tile, int device,
                               void* stream) {
    const int ntiles = (E + tile - 1) / tile;
    if (static_cast<long long>(ntiles) * B > 0x7fffffffLL) return 9;
    DesignArgs a{exc_ar, exc_ai, exc_z, fa, phi, esp, t1, t2, out_atom,
                 out_lane, E, B, nstate + 1, ntiles};
    const cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return static_cast<int>(e);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    return second_order ? launch<true>(a, tile, st)
                        : launch<false>(a, tile, st);
}
