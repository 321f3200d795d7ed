// epg_planes.cuh -- plane math shared by the folded half-ladder EPG kernels.
//
// Device-function counterpart of epgpy_tpu/models/pallas_common.py:19-120
// (_cmul, _rot_coeffs, _rot_A/_rot_B/_rot_Z, _apply_rot, _shift_store);
// the torch twins live in epgpy_torch/models/planes.py and keep the same
// operation order, so a kernel and its plain version differ only by
// rounding (FMA contraction, libm).
//
// Layout: one atom's ladder is a "plane set" of six real planes of H =
// nstate + 1 rows -- A(k) = F+(k), B(k) = F+(-k), Z(k), each as (re, im),
// k = 0..N.  F-(k) = conj(F+(-k)) is implied (the FISP-family evolution
// preserves the conjugate symmetry), so every rotation term is rowwise.
// In shared memory, plane j row k of the thread's atom sits at
// base[(j * H + k) * ld] with ld = blockDim.x: consecutive threads touch
// consecutive words (no bank conflicts), and each thread owns its column,
// so no __syncthreads is needed between rows or pulses.
#pragma once

#include <cuda_runtime.h>

namespace epg {

// Weigel rotation closed forms for flip a (radians) and phase terms
// (cos phi, sin phi, cos 2phi, sin 2phi): the 10-tuple of _rot_coeffs.
// The same struct holds coefficient derivatives (rot_coeffs_db1).
struct Rot {
    float c2, a1r, a1i, a2r, a2i;    // A row: cos^2(a/2), m01, m02
    float caa, b0r, b0i, b1r, b1i;   // Z row: cos a, m20, m21
};

__device__ __forceinline__ void cmul(float cr, float ci, float xr, float xi,
                                     float& re, float& im) {
    re = cr * xr - ci * xi;
    im = cr * xi + ci * xr;
}

// rot_coeffs from sin a and cos a
__device__ __forceinline__ Rot rot_coeffs_sc(float sa, float ca, float cp,
                                             float sp, float c2p, float s2p) {
    const float cos2 = (1.0f + ca) * 0.5f;
    const float sin2 = (1.0f - ca) * 0.5f;
    Rot r;
    r.c2 = cos2;
    r.a1r = c2p * sin2;
    r.a1i = s2p * sin2;
    r.a2r = sp * sa;
    r.a2i = -cp * sa;
    r.caa = ca;
    r.b0r = -0.5f * sp * sa;
    r.b0i = -0.5f * cp * sa;
    r.b1r = -0.5f * sp * sa;
    r.b1i = 0.5f * cp * sa;
    return r;
}

// d/dB1 of rot_coeffs for a flip a = FA * B1 with da = d(a)/dB1 (the
// FISP Jacobian's B1 tangent; _kernel_jac's dcos2, dm01 .. dm21, dca)
__device__ __forceinline__ Rot rot_coeffs_db1(float sa, float ca, float da,
                                              float cp, float sp, float c2p,
                                              float s2p) {
    const float dsa = ca * da;
    const float dsin2 = 0.5f * sa * da;
    Rot r;
    r.c2 = -0.5f * sa * da;
    r.a1r = c2p * dsin2;
    r.a1i = s2p * dsin2;
    r.a2r = sp * dsa;
    r.a2i = -cp * dsa;
    r.caa = -sa * da;
    r.b0r = -0.5f * sp * dsa;
    r.b0i = -0.5f * cp * dsa;
    r.b1r = -0.5f * sp * dsa;
    r.b1i = 0.5f * cp * dsa;
    return r;
}

// TR-derivatives of the folded relaxation cF = e^{-TR/T2}, cZ = e^{-TR/T1}
// (the per-pulse Hessian kernel's tau tangents; relax_tau_terms of
// planes.py): dcF/dTR, dcZ/dTR, d2cF/dTR dT2, d2cZ/dTR dT1.
struct TauTerms {
    float cFt, cZt, cFt2, cZt1;
};

__device__ __forceinline__ TauTerms relax_tau_terms(float cZ, float cF,
                                                    float TR, float T1,
                                                    float T2) {
    TauTerms t;
    t.cFt = -cF / T2;
    t.cZt = -cZ / T1;
    t.cFt2 = cF * (1.0f - TR / T2) / (T2 * T2);
    t.cZt1 = cZ * (1.0f - TR / T1) / (T1 * T1);
    return t;
}

// c2*A + (a1)*conj(B) + (a2)*Z
__device__ __forceinline__ void rot_A(const Rot& r, float AR, float AI,
                                      float BR, float BI, float ZR, float ZI,
                                      float& re, float& im) {
    re = r.c2 * AR + r.a1r * BR + r.a1i * BI + r.a2r * ZR - r.a2i * ZI;
    im = r.c2 * AI + r.a1i * BR - r.a1r * BI + r.a2r * ZI + r.a2i * ZR;
}

// c2*B + (a1)*conj(A) + (a2)*conj(Z)
__device__ __forceinline__ void rot_B(const Rot& r, float AR, float AI,
                                      float BR, float BI, float ZR, float ZI,
                                      float& re, float& im) {
    re = r.c2 * BR + r.a1r * AR + r.a1i * AI + r.a2r * ZR + r.a2i * ZI;
    im = r.c2 * BI + r.a1i * AR - r.a1r * AI + r.a2i * ZR - r.a2r * ZI;
}

// (b0)*A + (b1)*conj(B) + caa*Z
__device__ __forceinline__ void rot_Z(const Rot& r, float AR, float AI,
                                      float BR, float BI, float ZR, float ZI,
                                      float& re, float& im) {
    re = r.b0r * AR - r.b0i * AI + r.b1r * BR + r.b1i * BI + r.caa * ZR;
    im = r.b0r * AI + r.b0i * AR + r.b1i * BR - r.b1r * BI + r.caa * ZI;
}

// The rotation restricted to k = 0 of a balanced (unshifted) train, whose
// F-(0) = conj(F+(0)) and Z(0) is real (pallas_bssfp.py:113-122; rot_k0 of
// planes.py): nF+ = c2 F+ + a1 conj(F+) + a2 Z, nZ = 2 Re(b0 F+) + caa Z.
// With rot_coeffs_db1's coefficients it is the B1 coefficient pass.
__device__ __forceinline__ void rot_k0(const Rot& r, float FR, float FI,
                                       float Z, float& nFR, float& nFI,
                                       float& nZ) {
    nFR = r.c2 * FR + r.a1r * FR + r.a1i * FI + r.a2r * Z;
    nFI = r.c2 * FI + r.a1i * FR - r.a1r * FI + r.a2i * Z;
    nZ = 2.0f * (r.b0r * FR - r.b0i * FI) + r.caa * Z;
}

// One row of a plane set, and its rotation (rot_A, rot_B, rot_Z).
struct Row {
    float AR, AI, BR, BI, ZR, ZI;
};

__device__ __forceinline__ Row rotate(const Rot& r, const Row& x) {
    Row o;
    rot_A(r, x.AR, x.AI, x.BR, x.BI, x.ZR, x.ZI, o.AR, o.AI);
    rot_B(r, x.AR, x.AI, x.BR, x.BI, x.ZR, x.ZI, o.BR, o.BI);
    rot_Z(r, x.AR, x.AI, x.BR, x.BI, x.ZR, x.ZI, o.ZR, o.ZI);
    return o;
}

// The F-plane decay (cF e^{i 2 pi df TR}) times (re + i im), or its T2
// derivative when handed dcF; a real product without off-resonance.
__device__ __forceinline__ void fdecay(bool cplx, float cr, float ci,
                                       float re, float im, float& oR,
                                       float& oI) {
    if (cplx) {
        cmul(cr, ci, re, im, oR, oI);
    } else {
        oR = cr * re;
        oI = cr * im;
    }
}

// One thread's plane set in shared memory.
struct PlaneSet {
    float* base;  // &smem[threadIdx.x]
    int H;        // rows per plane (nstate + 1)
    int ld;       // stride between rows (blockDim.x)
    __device__ __forceinline__ float& at(int j, int k) const {
        return base[(j * H + k) * ld];
    }
};

// The composite kernels' stage-closing diffusion attenuation of row k
// (_datten of pallas_composite.py:41-66; stage_attenuation of planes.py)
// for the stage's b-value base bt and ramp direction rd in {-1, 0, +1}:
// A(k) was ramped (k - rd) -> k and B(k) = F+(-k) was ramped
// -(k + rd) -> -k, so the rd k term changes sign between them; Z does not
// ramp.  Computed per row at each stage and never stored: bt changes from
// stage to stage.
struct StageAtt {
    float aA, aB, aZ;
};

__device__ __forceinline__ StageAtt stage_att(int k, float bt, float rd,
                                              float Dc) {
    const float kf = static_cast<float>(k);
    const float k2 = kf * kf;
    const float third = (rd * rd) * (1.0f / 3.0f);
    return StageAtt{expf(-(bt * (k2 - rd * kf + third)) * Dc),
                    expf(-(bt * (k2 + rd * kf + third)) * Dc),
                    expf(-(bt * k2) * Dc)};
}

// -- EPG-X: the C x C exchange mix of C compartments' plane sets --

// One exchange stage's coefficients for C compartments, row-major (i, j):
// the transverse matrix mT (re, im; it acts on A and B alike, both F+
// states) and the real longitudinal matrix mL.
template <int C>
struct XMix {
    float r[C * C], i[C * C], l[C * C];
};

// An XMix read in place from a ladder's record of a per-block shared
// table: coefficient q of part 0/1/2 at p[part C C + q].  With the records
// of a block's ladders at an odd stride, every lane of a ladder's segment
// reads one address (a broadcast), the segments of a warp read distinct
// banks, and each read is one base register plus an immediate offset.
struct SharedCol {
    const float* p;
    __device__ __forceinline__ float operator[](int q) const { return p[q]; }
};

template <int C>
struct SharedXMix {
    SharedCol r, i, l;
};

template <int C>
__device__ __forceinline__ SharedXMix<C> shared_xmix(const float* p) {
    return SharedXMix<C>{SharedCol{p}, SharedCol{p + C * C},
                         SharedCol{p + 2 * C * C}};
}

// The mix of row k of C plane sets (_mix_planes of pallas_common.py:74-99;
// mix_planes of planes.py): A and B with mT, Z with mL around the
// equilibrium, which sits on the k = 0 Z row (k0): dev = Z - dens there,
// Z' = mL dev + dens.  m is an XMix<C> or a SharedXMix<C>, dens a float[C]
// or a SharedCol.  x and y must not alias.
template <int C, class M, class D>
__device__ __forceinline__ void mix_rows(const M& m, const D& dens, bool k0,
                                         const Row (&x)[C], Row (&y)[C]) {
    float dev[C];
#pragma unroll
    for (int j = 0; j < C; ++j) dev[j] = k0 ? x[j].ZR - dens[j] : x[j].ZR;
#pragma unroll
    for (int i = 0; i < C; ++i) {
        Row o;
#pragma unroll
        for (int j = 0; j < C; ++j) {
            const int q = i * C + j;
            float ar, ai, br, bi;
            cmul(m.r[q], m.i[q], x[j].AR, x[j].AI, ar, ai);
            cmul(m.r[q], m.i[q], x[j].BR, x[j].BI, br, bi);
            const float zr = m.l[q] * dev[j];
            const float zi = m.l[q] * x[j].ZI;
            if (j == 0) {
                o = Row{ar, ai, br, bi, zr, zi};
            } else {
                o.AR += ar;
                o.AI += ai;
                o.BR += br;
                o.BI += bi;
                o.ZR += zr;
                o.ZI += zi;
            }
        }
        if (k0) o.ZR += dens[i];
        y[i] = o;
    }
}

// The tangent of mix_rows (pallas_xgre.py:324-350; mix_tangent of
// planes.py): t'_i = sum_j [M_ij (t_j - de_j) + dM_ij (x_j - e_j)] + de_i,
// with x the primal rows from BEFORE the mix, dm and ddens the tangents of
// the coefficients and the densities (types as mix_rows's).  t and y must
// not alias.
template <int C, class M, class D>
__device__ __forceinline__ void mix_tangent_rows(
    const M& m, const M& dm, const D& dens, const D& ddens, bool k0,
    const Row (&t)[C], const Row (&x)[C], Row (&y)[C]) {
    float xdev[C], tdev[C];
#pragma unroll
    for (int j = 0; j < C; ++j) {
        xdev[j] = k0 ? x[j].ZR - dens[j] : x[j].ZR;
        tdev[j] = k0 ? t[j].ZR - ddens[j] : t[j].ZR;
    }
#pragma unroll
    for (int i = 0; i < C; ++i) {
        Row o;
#pragma unroll
        for (int j = 0; j < C; ++j) {
            const int q = i * C + j;
            float ar, ai, dar, dai, br, bi, dbr, dbi;
            cmul(m.r[q], m.i[q], t[j].AR, t[j].AI, ar, ai);
            cmul(dm.r[q], dm.i[q], x[j].AR, x[j].AI, dar, dai);
            cmul(m.r[q], m.i[q], t[j].BR, t[j].BI, br, bi);
            cmul(dm.r[q], dm.i[q], x[j].BR, x[j].BI, dbr, dbi);
            const float zr = m.l[q] * tdev[j] + dm.l[q] * xdev[j];
            const float zi = m.l[q] * t[j].ZI + dm.l[q] * x[j].ZI;
            ar = ar + dar;
            ai = ai + dai;
            br = br + dbr;
            bi = bi + dbi;
            if (j == 0) {
                o = Row{ar, ai, br, bi, zr, zi};
            } else {
                o.AR += ar;
                o.AI += ai;
                o.BR += br;
                o.BI += bi;
                o.ZR += zr;
                o.ZI += zi;
            }
        }
        if (k0) o.ZR += ddens[i];
        y[i] = o;
    }
}

// The EPG-X saturation of one row before the pulse: A and B (F+ states)
// times the complex factor (fr, fi) = conj(e^{-rT}), Z times (zr, zi) =
// e^{-rL} (pallas_xgre.py:77-84).
__device__ __forceinline__ Row saturate(const Row& x, float fr, float fi,
                                        float zr, float zi) {
    Row o;
    cmul(fr, fi, x.AR, x.AI, o.AR, o.AI);
    cmul(fr, fi, x.BR, x.BI, o.BR, o.BI);
    cmul(zr, zi, x.ZR, x.ZI, o.ZR, o.ZI);
    return o;
}

// -- warp-row layout: one warp per folded ladder, rows across its lanes --
//
// The CPMG tangent kernels (cpmg_jac.cu, cpmg_design.cu) give each ladder
// a warp.  Lane l owns rows l, l + 32, ..., walked as 32-row chunks c (row
// k = 32 c + l).  Row k of every plane of every group the warp carries
// sits in one record of S floats in shared memory (plane j of a group at
// record offset 6 g + j), S odd: consecutive lanes then touch words S
// apart, all in distinct banks, and every access to a row is one address
// plus a constant offset.  A lane reads and writes only its own rows:
// values cross lanes by shuffles, so a half-stage needs no __syncwarp
// between its chunks.

constexpr int kWarp = 32;
constexpr unsigned kFullMask = 0xffffffffu;

// One group's planes (or a set of per-row values) on the warp-row layout.
struct RowSet {
    float* base;  // record of row 0, at the group's first plane
    int S;        // floats per row record (odd)
    int H;        // rows (nstate + 1)
    __device__ __forceinline__ float& at(int j, int k) const {
        return base[k * S + j];
    }
};

__device__ __forceinline__ Row read_row(const RowSet& s, int k) {
    const float* r = &s.at(0, k);
    return Row{r[0], r[1], r[2], r[3], r[4], r[5]};
}

// The folded unit shift (planes.shift_fold) on the warp-row layout: fed the
// same unshifted new values of every row, it leaves the same planes.
// Every lane of the warp calls put(k, ...) for chunk c = 0, 1, ... in
// order, k = 32 c + lane, rows k >= H included (their values are
// dropped); the caller walks only the chunks that can hold non-zero rows
// (a chunk beyond the ladder's reach holds exact zeros and stays so).
// put writes the lane's own row k: A(k) <- new A(k-1), B(k) <- new B(k+1)
// (B(H-1) <- 0), Z(k) <- new Z(k), with A(0) <- new B(1).  Two rotations
// by one lane move A up and B down; at the chunk's edges they hand lane 0
// the chunk's last new A, kept as the next chunk's A(k-1), and lane 31
// the chunk's first new B, which belongs to the previous chunk's last row
// (lane 31's own row there).  Lane 31 writes its own B(k) as 0 until then,
// which stands when no chunk follows: that row is beyond the reach, or
// the ladder's end.
struct WarpShift {
    RowSet s;
    float carR, carI;  // lane 0: new A of row 32 c - 1

    __device__ __forceinline__ void put(int k, float nAR, float nAI,
                                        float nBR, float nBI, float nZR,
                                        float nZI) {
        const int lane = k & (kWarp - 1);
        const int below = (lane + kWarp - 1) & (kWarp - 1);
        const int above = (lane + 1) & (kWarp - 1);
        const float aR = __shfl_sync(kFullMask, nAR, below);
        const float aI = __shfl_sync(kFullMask, nAI, below);
        const float bR = __shfl_sync(kFullMask, nBR, above);
        const float bI = __shfl_sync(kFullMask, nBI, above);
        const bool first = lane == 0, last = lane == kWarp - 1;
        const float AR = first ? (k == 0 ? bR : carR) : aR;
        const float AI = first ? (k == 0 ? bI : carI) : aI;
        carR = aR;
        carI = aI;
        const bool zeroB = last || k == s.H - 1;
        if (k < s.H) {
            float* r = &s.at(0, k);
            r[0] = AR;
            r[1] = AI;
            r[2] = zeroB ? 0.0f : bR;
            r[3] = zeroB ? 0.0f : bI;
            r[4] = nZR;
            r[5] = nZI;
        }
        if (last && k >= kWarp) {
            s.at(2, k - kWarp) = bR;
            s.at(3, k - kWarp) = bI;
        }
    }
};

__device__ __forceinline__ WarpShift warp_shift(const RowSet& s) {
    return WarpShift{s, 0.0f, 0.0f};
}

// The DW-TSE factors for the new values of row k (attenuate() of
// planes.py after the shift): each value is scaled by the row the shift moves it to -- A to k + 1, B to
// k - 1, Z to k -- from `a`, whose values 0, 1, 2 are aA, aB, aZ; rows are
// clamped into the ladder for the lanes past its end, whose values the
// shift drops.
__device__ __forceinline__ StageAtt warp_att(const RowSet& a, int k) {
    const int top = a.H - 1;
    return StageAtt{a.at(0, k + 1 < top ? k + 1 : top),
                    a.at(1, k >= 1 ? (k - 1 < top ? k - 1 : top) : 0),
                    a.at(2, k < top ? k : top)};
}

// The attenuation rows of one stage on the warp-row layout
// (planes.diff_attenuation's order of operations: f = bT (k^2 -+ k + 1/3)
// or bT k^2, bL k^2; a = exp(-f Dc)): lane l fills rows l, l + 32, ...
// (call __syncwarp before other lanes read them).
__device__ __forceinline__ void att_rows_warp(const RowSet& a, float bT,
                                              float bL, bool ramp, float Dc,
                                              int lane) {
    for (int k = lane; k < a.H; k += kWarp) {
        const float kf = static_cast<float>(k);
        const float k2 = kf * kf;
        float fA, fB;
        if (ramp) {
            fA = bT * (k2 - kf + 1.0f / 3.0f);
            fB = bT * (k2 + kf + 1.0f / 3.0f);
        } else {
            fA = bT * k2;
            fB = fA;
        }
        const float fZ = bL * k2;
        a.at(0, k) = expf(-fA * Dc);
        a.at(1, k) = expf(-fB * Dc);
        a.at(2, k) = expf(-fZ * Dc);
    }
}

// The last row a half-stage of echo i (0-based) can make non-zero, within
// the ladder: after the excitation only row 0 holds state and every shift
// reaches one row further, so the first half-stage of echo i reaches row
// 2 i + 1, the second 2 i + 2.
__device__ __forceinline__ int reach(int i, int half, int H) {
    const int r = 2 * i + half;
    return r < H - 1 ? r : H - 1;
}

// -- segmented layout: several short ladders per warp, rows across the
// lanes of a segment, the state in registers --
//
// The tangent kernels fisp_jac.cu, megre_jac.cu, composite_jac.cu,
// fisp_hess.cu (its two passes), xgre_jac.cu, dess_jac.cu and
// xcomposite_jac.cu and the primal kernels cpmg.cu, fisp_half.cu,
// composite.cu, xgre.cu and xcomposite.cu give a folded ladder of H =
// nstate + 1 rows a segment of W = ceil(H / R) consecutive lanes, and a
// warp holds L = 32 / W segments; lanes past the last segment run the
// same instructions on a clamped atom and store nothing.  Lane r of a
// segment owns rows k = r + W c, c < R, of every plane of every group
// (xgre_jac.cu, dess_jac.cu, xcomposite_jac.cu and the primal kernels:
// rows k = r R + c, the blocked layout of seg_shift_blocked), in
// registers: R is a template
// parameter, so each plane is a statically indexed float[R], and the
// per-pulse work of a lane -- its rotation coefficients, the broadcasts,
// the shift's selects -- serves R rows.  Rows k >= H are padding and stay
// zero.  Values cross lanes only by shuffles, so nothing of the state
// needs a barrier.

// Rows per lane for a ladder of H rows: 2 (W = ceil(H / 2) lanes), 3 past
// 64 rows, 1 for the shortest ladders; the kernels' gates keep H <= 75
// (cuda_fisp.seg_layout mirrors this).
__host__ __device__ __forceinline__ int seg_rows(int H) {
    return H <= 3 ? 1 : (H <= 64 ? 2 : 3);
}

struct SegLane {
    int lane;  // lane in the warp
    int r;     // lane in the segment: it owns rows r + W c (r R + c in
               // the blocked layout of seg_shift_blocked)
    int base;  // the segment's first lane
    int W;     // lanes per segment
    int H;     // rows (nstate + 1)
};

// The lane's place for segments of W lanes.
__device__ __forceinline__ SegLane seg_lane(int lane, int W, int H) {
    const int seg = lane / W;
    return SegLane{lane, lane - seg * W, seg * W, W, H};
}

// Lane u of the lane's segment hands every lane of it v (lanes past the
// last segment read some lane of the warp; they store nothing).
__device__ __forceinline__ float seg_bcast(const SegLane& q, float v,
                                           int u) {
    return __shfl_sync(kFullMask, v, (q.base + u) & (kWarp - 1));
}

// The folded unit shift (planes.shift_fold) on the segmented layout: fed the
// same unshifted new values of every row (s[j][c]: plane j of row r +
// W c), it leaves the same planes.  A(k) <- new A(k-1), A(0) <- new B(1),
// B(k) <- new B(k+1), B(H-1) <- 0, Z unshifted.  Two rotations of the
// segment by one lane move new A up and new B down: a lane reads the lane
// below and the lane above, the segment's first and last lanes each
// other, chunk by chunk.  The row-0 lane takes B(1) (the lane above) as
// both A(0) and B(0); lane 0 of chunk c > 0 takes new A of row W c - 1
// from the last lane's chunk c - 1; the last lane takes new B of row
// W (c + 1) from lane 0's chunk c + 1; the row-(H-1) lane writes B as 0.
// Padding rows are written as 0.
template <int R>
__device__ __forceinline__ void seg_shift(const SegLane& q,
                                          float (&s)[6][R]) {
    const bool first = q.r == 0;
    const bool last = q.r == q.W - 1;
    const int below = (first ? q.base + q.W - 1 : q.lane - 1) & (kWarp - 1);
    const int above = (last ? q.base : q.lane + 1) & (kWarp - 1);
    float aR[R], aI[R], bR[R], bI[R];
#pragma unroll
    for (int c = 0; c < R; ++c) {
        aR[c] = __shfl_sync(kFullMask, s[0][c], below);
        aI[c] = __shfl_sync(kFullMask, s[1][c], below);
        bR[c] = __shfl_sync(kFullMask, s[2][c], above);
        bI[c] = __shfl_sync(kFullMask, s[3][c], above);
    }
#pragma unroll
    for (int c = 0; c < R; ++c) {
        const int k = q.r + q.W * c;
        const int prev = c > 0 ? c - 1 : 0;
        const int next = c + 1 < R ? c + 1 : c;
        const float AR = first ? (c == 0 ? bR[0] : aR[prev]) : aR[c];
        const float AI = first ? (c == 0 ? bI[0] : aI[prev]) : aI[c];
        const bool up = last && c + 1 < R;
        const float BR = up ? bR[next] : bR[c];
        const float BI = up ? bI[next] : bI[c];
        const bool keep = R == 1 || k < q.H;   // W = H at R = 1
        const bool zeroB = k >= q.H - 1;
        s[0][c] = keep ? AR : 0.0f;
        s[1][c] = keep ? AI : 0.0f;
        s[2][c] = zeroB ? 0.0f : BR;
        s[3][c] = zeroB ? 0.0f : BI;
        s[4][c] = keep ? s[4][c] : 0.0f;
        s[5][c] = keep ? s[5][c] : 0.0f;
    }
}

// The folded unit shift (planes.shift_fold) on the segmented layout with
// blocked rows -- lane r of a segment owns rows r R + c, c < R (s[j][c]),
// instead of seg_shift's r + W c: fed the same unshifted new values of
// every row, it leaves the same planes.  A(k) <- new A(k-1), A(0) <- new
// B(1), B(k) <- new B(k+1), B(H-1) <- 0, Z unshifted.  Within a lane the
// rows move by register; across lanes one shuffle per plane: a lane takes
// the lane below's last new A and the lane above's first new B (the
// segment's first lane takes B(1) as A(0) instead; its last lane's last
// row is row H-1 or padding, whose B is 0).  Padding rows (k >= H) keep A
// and B at 0; their Z is not touched and stays 0, since a row of zeros
// rotates, relaxes and mixes to zeros away from row 0.
template <int R>
__device__ __forceinline__ void seg_shift_blocked(const SegLane& q,
                                                  float (&s)[6][R]) {
    const bool first = q.r == 0;
    const int below = (q.lane + kWarp - 1) & (kWarp - 1);
    const int above = (q.lane + 1) & (kWarp - 1);
    const float aR = __shfl_sync(kFullMask, s[0][R - 1], below);
    const float aI = __shfl_sync(kFullMask, s[1][R - 1], below);
    const float bR = __shfl_sync(kFullMask, s[2][0], above);
    const float bI = __shfl_sync(kFullMask, s[3][0], above);
    // new A(0) of the segment's first lane: new B(1), its own second row
    // or the lane above's first
    const float a0R = first ? (R > 1 ? s[2][R > 1 ? 1 : 0] : bR) : aR;
    const float a0I = first ? (R > 1 ? s[3][R > 1 ? 1 : 0] : bI) : aI;
    const int k0 = q.r * R;
#pragma unroll
    for (int c = R - 1; c >= 0; --c) {
        const float AR = c > 0 ? s[0][c > 0 ? c - 1 : 0] : a0R;
        const float AI = c > 0 ? s[1][c > 0 ? c - 1 : 0] : a0I;
        s[0][c] = k0 + c < q.H ? AR : 0.0f;
        s[1][c] = k0 + c < q.H ? AI : 0.0f;
    }
#pragma unroll
    for (int c = 0; c < R; ++c) {
        const float BR = c + 1 < R ? s[2][c + 1 < R ? c + 1 : c] : bR;
        const float BI = c + 1 < R ? s[3][c + 1 < R ? c + 1 : c] : bI;
        s[2][c] = k0 + c >= q.H - 1 ? 0.0f : BR;
        s[3][c] = k0 + c >= q.H - 1 ? 0.0f : BI;
    }
}

// The folded down shift (planes.shift_down) on the segmented layout with blocked
// rows (xcomposite_jac.cu's S(-1)): A(k) <- new A(k+1), A(H-1) <- 0, B(k)
// <- new B(k-1), B(0) <- new A(1), Z unshifted -- seg_shift_blocked with
// the roles of the A and B planes swapped.  Within a lane the rows move by
// register; across lanes one shuffle per plane: a lane takes the lane
// below's last new B and the lane above's first new A (the segment's
// first lane takes A(1) as B(0) instead; its last lane's last row is row
// H-1 or padding, whose A is 0).  Padding rows (k >= H) keep A and B at 0
// and their Z untouched.
template <int R>
__device__ __forceinline__ void seg_shift_blocked_down(const SegLane& q,
                                                       float (&s)[6][R]) {
    const bool first = q.r == 0;
    const int below = (q.lane + kWarp - 1) & (kWarp - 1);
    const int above = (q.lane + 1) & (kWarp - 1);
    const float bR = __shfl_sync(kFullMask, s[2][R - 1], below);
    const float bI = __shfl_sync(kFullMask, s[3][R - 1], below);
    const float aR = __shfl_sync(kFullMask, s[0][0], above);
    const float aI = __shfl_sync(kFullMask, s[1][0], above);
    // new B(0) of the segment's first lane: new A(1), its own second row
    // or the lane above's first
    const float b0R = first ? (R > 1 ? s[0][R > 1 ? 1 : 0] : aR) : bR;
    const float b0I = first ? (R > 1 ? s[1][R > 1 ? 1 : 0] : aI) : bI;
    const int k0 = q.r * R;
#pragma unroll
    for (int c = R - 1; c >= 0; --c) {
        const float BR = c > 0 ? s[2][c > 0 ? c - 1 : 0] : b0R;
        const float BI = c > 0 ? s[3][c > 0 ? c - 1 : 0] : b0I;
        s[2][c] = k0 + c < q.H ? BR : 0.0f;
        s[3][c] = k0 + c < q.H ? BI : 0.0f;
    }
#pragma unroll
    for (int c = 0; c < R; ++c) {
        const float AR = c + 1 < R ? s[0][c + 1 < R ? c + 1 : c] : aR;
        const float AI = c + 1 < R ? s[1][c + 1 < R ? c + 1 : c] : aI;
        s[0][c] = k0 + c >= q.H - 1 ? 0.0f : AR;
        s[1][c] = k0 + c >= q.H - 1 ? 0.0f : AI;
    }
}

// The folded down shift (planes.shift_down) on the segmented layout (the composite
// tangent kernel's S(-1)): A(k) <- new A(k+1), A(H-1) <- 0, B(k) <- new
// B(k-1), B(0) <- new A(1), Z unshifted -- seg_shift with the roles of the A
// and B planes swapped: new B moves up (a lane reads the lane below) and
// new A down (the lane above), with seg_shift's wrap, row-0, last-row and
// padding selects.
template <int R>
__device__ __forceinline__ void seg_shift_down(const SegLane& q,
                                               float (&s)[6][R]) {
    const bool first = q.r == 0;
    const bool last = q.r == q.W - 1;
    const int below = (first ? q.base + q.W - 1 : q.lane - 1) & (kWarp - 1);
    const int above = (last ? q.base : q.lane + 1) & (kWarp - 1);
    float bR[R], bI[R], aR[R], aI[R];
#pragma unroll
    for (int c = 0; c < R; ++c) {
        bR[c] = __shfl_sync(kFullMask, s[2][c], below);
        bI[c] = __shfl_sync(kFullMask, s[3][c], below);
        aR[c] = __shfl_sync(kFullMask, s[0][c], above);
        aI[c] = __shfl_sync(kFullMask, s[1][c], above);
    }
#pragma unroll
    for (int c = 0; c < R; ++c) {
        const int k = q.r + q.W * c;
        const int prev = c > 0 ? c - 1 : 0;
        const int next = c + 1 < R ? c + 1 : c;
        const float BR = first ? (c == 0 ? aR[0] : bR[prev]) : bR[c];
        const float BI = first ? (c == 0 ? aI[0] : bI[prev]) : bI[c];
        const bool up = last && c + 1 < R;
        const float AR = up ? aR[next] : aR[c];
        const float AI = up ? aI[next] : aI[c];
        const bool keep = R == 1 || k < q.H;   // W = H at R = 1
        const bool zeroA = k >= q.H - 1;
        s[0][c] = zeroA ? 0.0f : AR;
        s[1][c] = zeroA ? 0.0f : AI;
        s[2][c] = keep ? BR : 0.0f;
        s[3][c] = keep ? BI : 0.0f;
        s[4][c] = keep ? s[4][c] : 0.0f;
        s[5][c] = keep ? s[5][c] : 0.0f;
    }
}

// The folded shifts of a ladder of a static H <= R rows held by one lane
// (s[j][c]: plane j, row c; the blocked layout at W = 1, as fisp_half.cu
// and composite.cu run their ladders of up to 12 rows): planes U, U + 1
// move up a row and planes D, D + 1 down -- seg_shift_blocked with U = 0
// (A), D = 2 (B), seg_shift_blocked_down with U = 2, D = 0: U(k) <-
// U(k-1), U(0) <- D(1), D(k) <- D(k+1), D(H-1) <- 0, Z unshifted.  Rows c
// >= H are never touched, so no select runs.
template <int U, int D, int H, int R>
__device__ __forceinline__ void lane_shift(float (&s)[6][R]) {
    static_assert(H >= 2 && H <= R, "one lane holds the ladder");
    const float u0R = s[D][1], u0I = s[D + 1][1];
#pragma unroll
    for (int c = H - 1; c >= 1; --c) {
        s[U][c] = s[U][c - 1];
        s[U + 1][c] = s[U + 1][c - 1];
    }
    s[U][0] = u0R;
    s[U + 1][0] = u0I;
#pragma unroll
    for (int c = 0; c + 1 < H; ++c) {
        s[D][c] = s[D][c + 1];
        s[D + 1][c] = s[D + 1][c + 1];
    }
    s[D][H - 1] = 0.0f;
    s[D + 1][H - 1] = 0.0f;
}

// The post-shift diffusion attenuation factors of row k (fisp_jac's and
// att_rows_warp's order of operations: f = bT (k^2 -+ k + 1/3) or bT k^2,
// bL k^2; a = exp(-f Dc)) and their D derivatives d = -f a, for A, B, Z.
// Constant over a train, so a lane computes its rows' once.
__device__ __forceinline__ void seg_att(int k, float bT, float bL,
                                        bool ramp, float Dc, float (&a)[3],
                                        float (&d)[3]) {
    const float kf = static_cast<float>(k);
    const float k2 = kf * kf;
    float f[3];
    if (ramp) {
        f[0] = bT * (k2 - kf + 1.0f / 3.0f);
        f[1] = bT * (k2 + kf + 1.0f / 3.0f);
    } else {
        f[0] = bT * k2;
        f[1] = f[0];
    }
    f[2] = bL * k2;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
        a[j] = expf(-f[j] * Dc);
        d[j] = -f[j] * a[j];
    }
}

// A block's staged outputs to device memory, each staged row to the output
// row row_of(t) (a callable; a negative row is not written): for each of
// `planes` output planes, `rows` staged rows of `A` atoms,
// stage[(o * ld + t) * A + a] -> out[o * plane + row_of(t) * B + atom0 + a]
// where atom0 + a < B.  Thread i keeps atom a = i % A and walks the rows
// i / A, i / A + blockDim / A, ... (the threads past the last whole sweep
// idle), so each row leaves as one run of consecutive words and no
// division runs per row.
template <class RowOf>
__device__ __forceinline__ void flush_stage_rows(const float* stage,
                                                 float* out, int planes,
                                                 int ld, int rows, int A,
                                                 size_t plane,
                                                 const RowOf& row_of, int B,
                                                 int atom0) {
    const int step = blockDim.x / A;
    const int a = threadIdx.x % A;
    const int i = threadIdx.x / A;
    if (i >= step || atom0 + a >= B) return;
    int o = i / rows, t = i - o * rows;
    while (o < planes) {
        const int row = row_of(t);
        if (row >= 0)
            out[o * plane + static_cast<size_t>(row) * B + atom0 + a] =
                stage[(o * ld + t) * A + a];
        t += step;
        while (t >= rows) {
            t -= rows;
            ++o;
        }
    }
}

// flush_stage_rows to consecutive output rows: staged row t to row0 + t.
__device__ __forceinline__ void flush_stage(const float* stage, float* out,
                                            int planes, int ld, int rows,
                                            int A, size_t plane, size_t row0,
                                            int B, int atom0) {
    const int first = static_cast<int>(row0);
    flush_stage_rows(stage, out, planes, ld, rows, A, plane,
                     [first](int t) { return first + t; }, B, atom0);
}


// -- the EPG-X primal kernels' stage on the segmented layout (xgre.cu,
// xcomposite.cu: blocked rows, all C compartments of a row on one lane) --

// A coefficient column read in place from device memory: entry q at p[q
// ld] (the composite EPG-X kernels' stage entries and densities when the
// per-atom tables do not fit in shared memory; every lane of a segment
// reads the same word).
struct GlobalCol {
    const float* p;
    int ld;
    __device__ __forceinline__ float operator[](int q) const {
        return __ldg(p + static_cast<size_t>(q) * ld);
    }
};

template <int C>
struct GlobalXMix {
    GlobalCol r, i, l;
};

// An XMix loaded into registers from a ladder's record of a per-block
// shared table (shared_xmix's layout).
template <int C>
__device__ __forceinline__ XMix<C> load_shared_xmix(const float* p) {
    XMix<C> m;
#pragma unroll
    for (int q = 0; q < C * C; ++q) {
        m.r[q] = p[q];
        m.i[q] = p[C * C + q];
        m.l[q] = p[2 * C * C + q];
    }
    return m;
}

// Whether a primal EPG-X instance (C pools, R rows per lane) holds a
// step's two stages' coefficients in registers: while its 6 C R floats of
// state and their 6 C^2 coefficients stay within 84 floats; else its
// mixes read them in place from the block's shared table.  In registers a step reads them once instead of once per
// row; two pools on 6 rows (96 floats) spilled at 128 registers (ptxas).
template <int C, int R>
constexpr bool kXmixInRegisters = 6 * C * R + 6 * C * C <= 84;

// A stage's coefficients from a ladder's record: loaded into registers
// (REG) or read in place by the mixes.
template <int C, bool REG>
__device__ __forceinline__ auto record_xmix(const float* p) {
    if constexpr (REG) {
        return load_shared_xmix<C>(p);
    } else {
        return shared_xmix<C>(p);
    }
}

// Row c of a lane's six planes s[j][c], and its store.
template <int R>
__device__ __forceinline__ Row lane_row(const float (&s)[6][R], int c) {
    return Row{s[0][c], s[1][c], s[2][c], s[3][c], s[4][c], s[5][c]};
}

template <int R>
__device__ __forceinline__ void lane_put(float (&s)[6][R], int c,
                                         const Row& x) {
    s[0][c] = x.AR;
    s[1][c] = x.AI;
    s[2][c] = x.BR;
    s[3][c] = x.BI;
    s[4][c] = x.ZR;
    s[5][c] = x.ZI;
}

// The primal kernels' per-TR (per-stage) table: kXTab floats per
// compartment -- cos phi, sin phi, cos 2phi, sin 2phi, the saturation
// factors fr, fi, zr, zi, the flip (degrees) and, at kXFlags, the flags as
// int bits: kXSaturate where the factors are not (1, 0, 1, 0), kXRotate
// where the flip is not 0.  A saturation by (1, 0, 1, 0) and a rotation by
// 0 are exact identities, so the stages that skip them keep the twin's
// result.
constexpr int kXTab = 10;
constexpr int kXFlags = 9;
constexpr int kXSaturate = 1, kXRotate = 2;

// The flags of a compartment's table entry te (its first 9 floats filled).
__device__ __forceinline__ float xflags(const float* te, bool sat) {
    int f = 0;
    if (sat && !(te[4] == 1.0f && te[5] == 0.0f && te[6] == 1.0f
                 && te[7] == 0.0f))
        f |= kXSaturate;
    if (te[8] != 0.0f) f |= kXRotate;
    return __int_as_float(f);
}

// Whether an exchange stage's per-atom coefficients m are the identity.
template <int C, class M>
__device__ __forceinline__ bool xmix_identity(const M& m) {
    bool id = true;
#pragma unroll
    for (int k = 0; k < C * C; ++k) {
        const float one = k % (C + 1) == 0 ? 1.0f : 0.0f;
        id = id && m.r[k] == one && m.i[k] == 0.0f && m.l[k] == one;
    }
    return id;
}

// The R rows of one EPG-X stage on a lane (s[c][j][k]: plane j of
// compartment c, row k of the lane): compartment c's rows saturated and
// rotated (by rot(c), a callable giving the Rot, called only then, so that
// one compartment's coefficients are live at a time) where the stage's
// flags (tr[kXTab c + kXFlags]) say they change, then per row the mix mA
// (skipped with skipA), the echo of the
// row-0 lane (echo != nullptr: compartment c's (re, im) to echo[c A] and
// echo[(pl + c) A], phased by (pc, ps) with adcph), the mix mB (skipped
// with skipB); dens as mix_rows takes it.  The flags and skips are the
// same for every lane of the warp, so each branch is warp-uniform; a
// skipped mix is the identity, whose product around the densities the
// twin rounds once.
template <int C, int R, class RotOf, class M, class D>
__device__ __forceinline__ void xstage_rows(
    float (&s)[C][6][R], const RotOf& rot, const float* tr, const M& mA,
    bool skipA, const M& mB, bool skipB, const D& dens,
    bool row0_lane, float* echo, int A, int pl, float pc, float ps,
    bool adcph) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
        const float* const te = tr + kXTab * c;
        const int flags = __float_as_int(te[kXFlags]);
        if (flags & kXSaturate) {
#pragma unroll
            for (int k = 0; k < R; ++k)
                lane_put(s[c], k, saturate(lane_row(s[c], k), te[4], te[5],
                                           te[6], te[7]));
        }
        if (flags & kXRotate) {
            const Rot r = rot(c);
#pragma unroll
            for (int k = 0; k < R; ++k)
                lane_put(s[c], k, rotate(r, lane_row(s[c], k)));
        }
    }
#pragma unroll
    for (int k = 0; k < R; ++k) {
        const bool k0 = k == 0 && row0_lane;
        Row x[C], y[C];
#pragma unroll
        for (int c = 0; c < C; ++c) x[c] = lane_row(s[c], k);
        if (skipA) {
#pragma unroll
            for (int c = 0; c < C; ++c) y[c] = x[c];
        } else {
            mix_rows<C>(mA, dens, k0, x, y);
        }
        if (k == 0 && echo != nullptr) {
#pragma unroll
            for (int c = 0; c < C; ++c) {
                float eR = y[c].AR, eI = y[c].AI;
                if (adcph) cmul(pc, ps, eR, eI, eR, eI);
                echo[c * A] = eR;
                echo[(pl + c) * A] = eI;
            }
        }
        if (skipB) {
#pragma unroll
            for (int c = 0; c < C; ++c) lane_put(s[c], k, y[c]);
        } else {
            mix_rows<C>(mB, dens, k0, y, x);
#pragma unroll
            for (int c = 0; c < C; ++c) lane_put(s[c], k, x[c]);
        }
    }
}


// -- the primal kernels' per-chunk pulse table and one TR of a lane's rows
// (bssfp.cu, fisp_full.cu, dess.cu; megre.cu steps its rows the same
// way) --

// The atom-independent terms of a chunk of up to kTabPulses pulses, which
// the block fills between two barriers: per pulse two float4, (cos phi,
// sin phi, cos 2phi, sin 2phi) of the RF phase by sincospif of phi / 180,
// and (flip in degrees, TR, TE, flags), the flags as a float holding
// kTrRepeats and kTeRepeats where TR and TE equal the previous pulse's (a
// constant TE repeats from the second pulse on).  Every thread then reads
// one word at a time (a broadcast), and a kernel keeps its decays of TR
// and TE in registers while the flags say they repeat: every lane steps
// the same pulse, so the test is warp-uniform.
constexpr int kTabPulses = 32;
constexpr int kTrRepeats = 1, kTeRepeats = 2;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ void fill_pulse_table(float4* tab, int i0, int n,
                                                 const float* phi,
                                                 const float* fa,
                                                 const float* tr,
                                                 const float* te, float te0,
                                                 bool var_te) {
    for (int t = threadIdx.x; t < n; t += blockDim.x) {
        const int i = i0 + t;
        const float ph = phi[i] * (1.0f / 180.0f);
        float sp, cp, s2p, c2p;
        sincospif(ph, &sp, &cp);
        sincospif(2.0f * ph, &s2p, &c2p);
        const float tri = tr[i];
        const float tei = var_te ? te[i] : te0;
        int fl = 0;
        if (i > 0 && tri == tr[i - 1]) fl |= kTrRepeats;
        if (i > 0 && (!var_te || tei == te[i - 1])) fl |= kTeRepeats;
        tab[2 * t] = make_float4(cp, sp, c2p, s2p);
        tab[2 * t + 1] = make_float4(fa[i], tri, tei, static_cast<float>(fl));
    }
}

// An atom's exp2 decay rate per ms, -log2(e) / T, as the twins form it
// (planes.exp2_rates): the reciprocal, then the product.  A decay over t
// is then exp2f(k t), with no division per pulse.
__device__ __forceinline__ float exp2_rate(float T) {
    return (1.0f / T) * -kLog2e;
}

// The echo's TE terms (planes.exp2_te_terms): e^{-TE / T2} as exp2f(k2
// TE) and, with df, the phasor of DF2 TE half turns (DF2 = 2 df).
__device__ __forceinline__ void te_exp2(float te, float k2, float DF2,
                                        bool cdf, float& e2te, float& pteR,
                                        float& pteI) {
    e2te = exp2f(k2 * te);
    if (cdf) sincospif(DF2 * te, &pteI, &pteR);
}

// A 180*B1 pulse about phi = 0 (B1 half turns), then TI relaxation, in
// closed form (planes.inversion_exp2): F+(0) (FR, FI), its residual
// precessing by DF2 TI half turns when `precess`, and Z(0).
__device__ __forceinline__ void inversion_exp2(float B1, float k1, float k2,
                                               float ti, float DF2,
                                               bool precess, float& FR,
                                               float& FI, float& Z) {
    float sai, cai;
    sincospif(B1, &sai, &cai);
    const float E1i = exp2f(k1 * ti);
    const float E2i = exp2f(k2 * ti);
    const float fpi = -sai * E2i;
    if (precess) {
        float si, ci;
        sincospif(DF2 * ti, &si, &ci);
        FR = -fpi * si;
        FI = fpi * ci;
    } else {
        FR = 0.0f;
        FI = fpi;
    }
    Z = cai * E1i + 1.0f - E1i;
}

// An atom's relaxation terms over a TR: the F decay with its df phasor,
// the Z decay and the k = 0 recovery.
struct Relax {
    float cFr, cFi, cZ, rec;
};

// The terms over TR by exp2f of TR times the atom's rates k1 and k2
// (exp2_rate of T1 and T2), the phasor by sincospif of DF2 TR half turns
// (DF2 = 2 df).
__device__ __forceinline__ Relax relax_exp2(float TR, float k1, float k2,
                                            float DF2, bool cdf) {
    Relax o;
    const float cF = exp2f(k2 * TR);
    o.cZ = exp2f(k1 * TR);
    o.rec = 1.0f - o.cZ;
    o.cFr = cF;
    o.cFi = 0.0f;
    if (cdf) {
        float pI, pR;
        sincospif(DF2 * TR, &pI, &pR);
        o.cFr = cF * pR;
        o.cFi = cF * pI;
    }
    return o;
}

// One TR of a folded ladder's rows on a lane, before the shift: each of
// the first NR rows s[j][c] rotated by r, then relaxed by rx (A and B
// times the F decay, Z times cZ, the recovery on row c = 0 where the lane
// holds the ladder's row 0); echo(y) sees row c = 0 rotated and not yet
// relaxed, on every lane (a lane that does not hold row 0 drops it).
template <int NR, int R, class Echo>
__device__ __forceinline__ void step_rows(float (&s)[6][R], const Rot& r,
                                          const Relax& rx, bool cdf,
                                          bool row0, const Echo& echo) {
#pragma unroll
    for (int c = 0; c < NR; ++c) {
        const Row y = rotate(r, lane_row(s, c));
        if (c == 0) echo(y);
        fdecay(cdf, rx.cFr, rx.cFi, y.AR, y.AI, s[0][c], s[1][c]);
        fdecay(cdf, rx.cFr, rx.cFi, y.BR, y.BI, s[2][c], s[3][c]);
        float nZR = rx.cZ * y.ZR;
        if (c == 0 && row0) nZR = nZR + rx.rec;
        s[4][c] = nZR;
        s[5][c] = rx.cZ * y.ZI;
    }
}

}  // namespace epg
