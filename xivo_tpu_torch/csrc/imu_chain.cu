// Fast propagation's chain over one frame's IMU slots and its visual
// segment, for Hopper (sm_90a), in float32 and float64:
//
//   xivo_imu_chain_f32, xivo_imu_chain_f64
//
// It replaces no Pallas kernel. It is the counterpart of XLA's fusion of
// the fully unrolled lax.scan of xivo_tpu/filter/pipeline.py:1246
// (_propagate_frame_fast), which the port's plain version
// (ops/imu_chain.chain_plain) runs as a Python loop of some 770 small
// launches a slot: here the chain is one launch a frame step.
//
// What it computes for each sequence (a row of the batch), in the state's
// dtype, is the plain version's mathematics: for each slot with dt > 0 the
// slopes (gyro - lg) / max(dt, 1e-12) and the same for the accelerometer,
// then n = clip(ceil(dt / h0), 1, S) uniform substeps of h = dt / n with the
// IMU reading interpolated to each substep's midpoint: compose_motion to the
// midpoint, motion_jacobians there (F, G), compose_motion over the substep,
// Phi_i = I + F h + (F h)^2 / 2, Phi <- Phi_i Phi and
// Q <- Phi_i Q Phi_i^T + h G Qimu G^T; then lg, la, the slopes and the
// count of intervals. A slot with dt <= 0 keeps the carry. The visual
// segment is one more interval, over dt_eff with the last slopes, masked on
// dt_eff > 0. The rotation is not projected (the caller projects it once a
// frame); so3.exp takes the same small-angle branch below the same switch.
// The plain version's grid substeps k >= n have h = 0 and are exact no-ops
// there: they are skipped here.
//
// Structure used (the same mathematics; only the order of rounding
// differs): F's non-zero rows are W, T and V (0-8), so
// A = F h + (F h)^2 / 2 is a 9 x 39 block, whose square needs F h's
// columns 0-8 alone. Phi's rows 9-38 stay the identity's, so only its rows
// 0-8 (P9) are kept: P9 <- P9 + A[:, :9] P9 + A[:, 9:] (the identity rows'
// part). Q <- M + M A^T on columns 0-8, with M = Q + A Q on rows 0-8 and
// Q elsewhere. G Qimu G^T is block diagonal: q_g on W, R diag(q_a) R^T on
// V (R the midpoint's rotation), q_bg and q_ba on their diagonals. Where
// the plain version adds a product with an exact zero, this kernel skips
// it.
//
// Bound: about 67 k flops a row and an active substep (A, P9, and the two
// 9 x 39 x 39 products that give M and Q's new columns), 4 x 5 substeps
// a frame at 100 Hz and 3 x 10 at 200 Hz with h0 = 2 ms, and one more on a
// frame whose dt_eff > 0 (the packed streams give dt_eff = 0 on most
// frames): 5.5 and 8.3 GFLOP a frame at B = 4096, 0.08 and 0.12 ms at 67
// TFLOP/s in float32. Bytes (the 61 + 7 KI inputs read once, Phi and Q written once,
// 2 x 39 x 39 x 4 B a row) give 0.015-0.016 ms. So operations bound it, and
// each row is a chain of small dependent steps. Design: one CTA of 128
// threads a row; the frame's P9 and Q stay in shared memory (rows padded to
// 41 values, so that the column walks of neighbouring threads hit distinct
// banks) and go to device memory once, at the end. Thread 0 composes the
// substep's motion, F h and the noise block (a few hundred flops) while the
// other threads wait; then every thread takes entries of A, of P9's and
// M's new rows, and of Q's new columns: five barriers a substep. About 16
// KB of shared memory a CTA in float32 (31 KB in float64), so many CTAs
// share an SM and one CTA's serial part overlaps the others' products.
// Plain FMA arithmetic: no tensor cores, so no TF32.
#include <cuda_runtime.h>

namespace {

constexpr int kM = 39;          // the motion block
constexpr int kR = 9;           // F's non-zero rows: W, T, V
constexpr int kLD = 41;         // a row in shared memory, padded
constexpr int kNA = kR * kM;    // entries of a 9 x 39 block
constexpr int kThreads = 128;

// error-state offsets (filter/layout.py)
constexpr int kBG = 9, kBA = 12, kWSG = 21, kCG = 24, kCA = 33;

// the input row of a sequence (ops/imu_chain.py): Rsb, Tsb, Vsb, bg, ba,
// Rsg, Cg, Ca, lg, la, sg, sa, dt_eff, then KI gyro readings, KI
// accelerometer readings and KI slot lengths
constexpr int IN_R = 0, IN_T = 9, IN_V = 12, IN_BG = 15, IN_BA = 18,
              IN_RSG = 21, IN_CG = 30, IN_CA = 39, IN_LG = 48, IN_LA = 51,
              IN_SG = 54, IN_SA = 57, IN_DTE = 60, N_IN = 61;
// the output row: Rsb, Tsb, Vsb, lg, la, sg, sa
constexpr int OUT_R = 0, OUT_T = 9, OUT_V = 12, OUT_LG = 15, OUT_LA = 18,
              OUT_SG = 21, OUT_SA = 24, N_OUT = 27;

template <typename T>
struct Consts {
    T g[3];         // gravity
    T q2[12];       // diag Qimu: gyro, accel, gyro bias, accel bias
    T h0;           // the grid's step
    T tiny;         // the slopes' floor on dt
    T eps;          // so3's small-angle switch on |w|^2
    int S;          // grid substeps a slot
};

__device__ __forceinline__ float s_sin(float x) { return sinf(x); }
__device__ __forceinline__ double s_sin(double x) { return sin(x); }
__device__ __forceinline__ float s_cos(float x) { return cosf(x); }
__device__ __forceinline__ double s_cos(double x) { return cos(x); }
__device__ __forceinline__ float s_sqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double s_sqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float s_ceil(float x) { return ceilf(x); }
__device__ __forceinline__ double s_ceil(double x) { return ceil(x); }

// the nominal motion and the IMU carry of a row, kept by thread 0
template <typename T>
struct Motion {
    T R[9], Tp[3], V[3], bg[3], ba[3], Rsg[9], Cg[9], Ca[9];
    T lg[3], la[3], sg[3], sa[3];
    T DW[6];        // (-Rsg hat(g))[:, :2], F's V rows on Wsg
};

template <typename T>
struct Shared {
    T Q[kM * kLD];
    T P9[2][kR * kLD];  // Phi's rows 0-8, this substep's and the next
    T Fh[kR * kLD];     // F h, rows 0-8 (its zero entries stay 0)
    T A[kR * kLD];      // F h + (F h)^2 / 2
    T Mq[kR * kLD];     // rows 0-8 of M = Q + A Q
    T Qc[kM * kR];      // columns 0-8 of the new Q, before the noise
    T Gv[9];            // h R diag(q_a) R^T: the noise's V block
    T Gd[9];            // h q_g, h q_bg, h q_ba: the noise's diagonals
    Motion<T> x;
};

template <typename T>
__device__ __forceinline__ void mat3(const T* a, const T* b, T* c) {
    for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j)
            c[3 * i + j] = a[3 * i] * b[j] + a[3 * i + 1] * b[3 + j]
                           + a[3 * i + 2] * b[6 + j];
}

template <typename T>
__device__ __forceinline__ T dot3(const T* a, const T* v) {
    return a[0] * v[0] + a[1] * v[1] + a[2] * v[2];
}

// Rodrigues (geom/so3.exp): I + a hat(w) + b hat(w)^2
template <typename T>
__device__ __forceinline__ void so3_exp(const T* w, T eps, T* E) {
    const T t2 = w[0] * w[0] + w[1] * w[1] + w[2] * w[2];
    const T t = s_sqrt(t2);
    const bool small = t2 < eps;
    const T a = small ? T(1) - t2 / T(6) : s_sin(t) / t;
    const T b = small ? T(0.5) - t2 / T(24) : (T(1) - s_cos(t)) / t2;
    const T W[9] = {T(0), -w[2], w[1], w[2], T(0), -w[0], -w[1], w[0], T(0)};
    T WW[9];
    mat3(W, W, WW);
    for (int e = 0; e < 9; ++e)
        E[e] = ((e % 4 == 0 ? T(1) : T(0)) + a * W[e]) + b * WW[e];
}

// Thread 0: one substep of length h from the interpolated reading (gy,
// ac) with slopes (sg, sa): F h and the noise at the midpoint into shared
// memory, the motion and the reading advanced by h.
template <typename T>
__device__ void compose_substep(Shared<T>& sh, const Consts<T>& c, T* gy,
                                T* ac, const T* sg, const T* sa, T h) {
    Motion<T>& x = sh.x;
    const T hh = T(0.5) * h;
    T gym[3], acm[3], gc[3], acc[3], f[3], w[3], E[9], Rm[9], Vm[3];
    for (int l = 0; l < 3; ++l) {
        gym[l] = gy[l] + sg[l] * hh;
        acm[l] = ac[l] + sa[l] * hh;
    }
    for (int i = 0; i < 3; ++i) {
        gc[i] = dot3(x.Cg + 3 * i, gym) - x.bg[i];
        acc[i] = dot3(x.Ca + 3 * i, acm) - x.ba[i];
    }
    for (int i = 0; i < 3; ++i)
        f[i] = dot3(x.R + 3 * i, acc) + dot3(x.Rsg + 3 * i, c.g);
    // the midpoint: compose_motion over h / 2
    for (int i = 0; i < 3; ++i) w[i] = gc[i] * hh;
    so3_exp(w, c.eps, E);
    mat3(x.R, E, Rm);
    for (int i = 0; i < 3; ++i) Vm[i] = x.V[i] + f[i] * hh;

    // F h at the midpoint (motion_jacobians), its non-zero entries
    T* F = sh.Fh;
    F[0 * kLD + 1] = gc[2] * h;         // -hat(gyro_calib) on W
    F[0 * kLD + 2] = -gc[1] * h;
    F[1 * kLD + 0] = -gc[2] * h;
    F[1 * kLD + 2] = gc[0] * h;
    F[2 * kLD + 0] = gc[1] * h;
    F[2 * kLD + 1] = -gc[0] * h;
    const T ha[9] = {T(0), -acc[2], acc[1], acc[2], T(0), -acc[0],
                     -acc[1], acc[0], T(0)};
    // upper-triangular Ca's six parameters: entries (j, l) of Ca
    const int cj[6] = {0, 0, 0, 1, 1, 2}, cl[6] = {0, 1, 2, 1, 2, 2};
    for (int i = 0; i < 3; ++i) {
        T* fw = F + i * kLD;
        T* ft = F + (3 + i) * kLD;
        T* fv = F + (6 + i) * kLD;
        fw[kBG + i] = -h;                       // -I on bg
        for (int l = 0; l < 3; ++l)             // the gyro on Cg's row i
            fw[kCG + 3 * i + l] = gym[l] * h;
        ft[6 + i] = h;                          // I on V
        for (int j = 0; j < 3; ++j) {
            fv[j] = ((-Rm[3 * i]) * ha[j] + (-Rm[3 * i + 1]) * ha[3 + j]
                     + (-Rm[3 * i + 2]) * ha[6 + j]) * h;
            fv[kBA + j] = -Rm[3 * i + j] * h;   // -R on ba
        }
        fv[kWSG] = x.DW[2 * i] * h;
        fv[kWSG + 1] = x.DW[2 * i + 1] * h;
        for (int k = 0; k < 6; ++k)             // d V / d Ca
            fv[kCA + k] = (Rm[3 * i + cj[k]] * acm[cl[k]]) * h;
    }
    // h G Qimu G^T
    for (int i = 0; i < 3; ++i) {
        sh.Gd[i] = c.q2[i] * h;
        sh.Gd[3 + i] = c.q2[6 + i] * h;
        sh.Gd[6 + i] = c.q2[9 + i] * h;
        for (int j = 0; j < 3; ++j)
            sh.Gv[3 * i + j] = ((Rm[3 * i] * c.q2[3]) * Rm[3 * j]
                                + (Rm[3 * i + 1] * c.q2[4]) * Rm[3 * j + 1]
                                + (Rm[3 * i + 2] * c.q2[5]) * Rm[3 * j + 2])
                               * h;
    }
    // the substep: compose_motion over h with the midpoint's velocity
    for (int i = 0; i < 3; ++i) {
        x.Tp[i] = x.Tp[i] + Vm[i] * h;
        x.V[i] = x.V[i] + f[i] * h;
        w[i] = gc[i] * h;
    }
    so3_exp(w, c.eps, E);
    T Rn[9];
    mat3(x.R, E, Rn);
    for (int e = 0; e < 9; ++e) x.R[e] = Rn[e];
    for (int l = 0; l < 3; ++l) {
        gy[l] = gy[l] + sg[l] * h;
        ac[l] = ac[l] + sa[l] * h;
    }
}

template <typename T>
__device__ __forceinline__ int grid_substeps(T dt, const Consts<T>& c) {
    const T r = s_ceil(dt / c.h0);
    return r >= T(c.S) ? c.S : (r <= T(1) ? 1 : (int)r);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
imu_chain_kernel(const T* __restrict__ xin, T* __restrict__ xout,
                 T* __restrict__ Phi, T* __restrict__ Qout,
                 long long* __restrict__ nprop_out, int KI, Consts<T> c) {
    __shared__ Shared<T> sh;
    const int tid = threadIdx.x;
    const T* row = xin + (size_t)blockIdx.x * (N_IN + 7 * KI);
    const T* gyro = row + N_IN;
    const T* accel = gyro + 3 * KI;
    const T* dts = accel + 3 * KI;

    for (int e = tid; e < kM * kLD; e += kThreads) sh.Q[e] = T(0);
    for (int e = tid; e < kR * kLD; e += kThreads) {
        sh.P9[0][e] = e / kLD == e % kLD ? T(1) : T(0);
        sh.Fh[e] = T(0);
    }
    long long nprop = 0;                // thread 0's count
    if (tid == 0) {
        Motion<T>& x = sh.x;
        for (int e = 0; e < 9; ++e) {
            x.R[e] = row[IN_R + e];
            x.Rsg[e] = row[IN_RSG + e];
            x.Cg[e] = row[IN_CG + e];
            x.Ca[e] = row[IN_CA + e];
        }
        for (int l = 0; l < 3; ++l) {
            x.Tp[l] = row[IN_T + l];
            x.V[l] = row[IN_V + l];
            x.bg[l] = row[IN_BG + l];
            x.ba[l] = row[IN_BA + l];
            x.lg[l] = row[IN_LG + l];
            x.la[l] = row[IN_LA + l];
            x.sg[l] = row[IN_SG + l];
            x.sa[l] = row[IN_SA + l];
        }
        const T hg[9] = {T(0), -c.g[2], c.g[1], c.g[2], T(0), -c.g[0],
                         -c.g[1], c.g[0], T(0)};
        for (int i = 0; i < 3; ++i)
            for (int j = 0; j < 2; ++j)
                x.DW[2 * i + j] = (-x.Rsg[3 * i]) * hg[j]
                                  + (-x.Rsg[3 * i + 1]) * hg[3 + j]
                                  + (-x.Rsg[3 * i + 2]) * hg[6 + j];
    }
    __syncthreads();

    int cur = 0;
    for (int k = 0; k <= KI; ++k) {     // k == KI: the visual segment
        // every thread reads the same length: the branch is uniform
        const T dt = k < KI ? dts[k] : row[IN_DTE];
        if (!(dt > T(0))) continue;
        const int n = grid_substeps(dt, c);
        const T h = dt / T(n);
        T gy[3], ac[3], sg[3], sa[3];   // thread 0's
        if (tid == 0) {
            const Motion<T>& x = sh.x;
            const T d = dt > c.tiny ? dt : c.tiny;
            for (int l = 0; l < 3; ++l) {
                gy[l] = x.lg[l];
                ac[l] = x.la[l];
                sg[l] = k < KI ? (gyro[3 * k + l] - x.lg[l]) / d : x.sg[l];
                sa[l] = k < KI ? (accel[3 * k + l] - x.la[l]) / d : x.sa[l];
            }
        }
        for (int sub = 0; sub < n; ++sub) {
            if (tid == 0) compose_substep(sh, c, gy, ac, sg, sa, h);
            __syncthreads();
            // A = F h + (F h)^2 / 2
            for (int e = tid; e < kNA; e += kThreads) {
                const int i = e / kM, j = e % kM;
                const T* fi = sh.Fh + i * kLD;
                T s = T(0);
                for (int q = 0; q < kR; ++q) s += fi[q] * sh.Fh[q * kLD + j];
                sh.A[i * kLD + j] = fi[j] + T(0.5) * s;
            }
            __syncthreads();
            // P9 <- P9 + A Phi and M's rows 0-8 = Q + A Q
            const T* P = sh.P9[cur];
            T* Pn = sh.P9[cur ^ 1];
            for (int e = tid; e < kNA; e += kThreads) {
                const int i = e / kM, j = e % kM;
                const T* a = sh.A + i * kLD;
                T s = T(0);
                for (int q = 0; q < kR; ++q) s += a[q] * P[q * kLD + j];
                if (j >= kR) s += a[j];
                Pn[i * kLD + j] = P[i * kLD + j] + s;
                T t = T(0);
                for (int q = 0; q < kM; ++q) t += a[q] * sh.Q[q * kLD + j];
                sh.Mq[i * kLD + j] = sh.Q[i * kLD + j] + t;
            }
            __syncthreads();
            // Q's columns 0-8: M + M A^T
            for (int e = tid; e < kM * kR; e += kThreads) {
                const int r = e / kR, j = e % kR;
                const T* mr = r < kR ? sh.Mq + r * kLD : sh.Q + r * kLD;
                const T* a = sh.A + j * kLD;
                T s = T(0);
                for (int q = 0; q < kM; ++q) s += mr[q] * a[q];
                sh.Qc[e] = mr[j] + s;
            }
            __syncthreads();
            // the new Q, with h G Qimu G^T
            for (int e = tid; e < kNA; e += kThreads) {
                const int i = e / kM, j = e % kM;
                T v;
                if (j >= kR) {
                    v = sh.Mq[i * kLD + j];
                } else {
                    v = sh.Qc[i * kR + j];
                    if (i < 3 && j == i) v += sh.Gd[i];
                    if (i >= 6 && j >= 6) v += sh.Gv[3 * (i - 6) + j - 6];
                }
                sh.Q[i * kLD + j] = v;
            }
            for (int e = tid; e < (kM - kR) * kR; e += kThreads) {
                const int r = kR + e / kR, j = e % kR;
                sh.Q[r * kLD + j] = sh.Qc[r * kR + j];
            }
            if (tid < 6) sh.Q[(kBG + tid) * kLD + kBG + tid] += sh.Gd[3 + tid];
            __syncthreads();
            cur ^= 1;
        }
        if (tid == 0) {
            Motion<T>& x = sh.x;
            for (int l = 0; l < 3; ++l) {
                if (k < KI) {
                    x.lg[l] = gyro[3 * k + l];
                    x.la[l] = accel[3 * k + l];
                    x.sg[l] = sg[l];
                    x.sa[l] = sa[l];
                } else {
                    x.lg[l] = x.lg[l] + x.sg[l] * dt;
                    x.la[l] = x.la[l] + x.sa[l] * dt;
                }
            }
            ++nprop;
        }
    }

    const size_t base = (size_t)blockIdx.x * kM * kM;
    const T* P = sh.P9[cur];
    for (int e = tid; e < kM * kM; e += kThreads) {
        const int i = e / kM, j = e % kM;
        Phi[base + e] = i < kR ? P[i * kLD + j] : (i == j ? T(1) : T(0));
        Qout[base + e] = sh.Q[i * kLD + j];
    }
    if (tid == 0) {
        const Motion<T>& x = sh.x;
        T* out = xout + (size_t)blockIdx.x * N_OUT;
        for (int e = 0; e < 9; ++e) out[OUT_R + e] = x.R[e];
        for (int l = 0; l < 3; ++l) {
            out[OUT_T + l] = x.Tp[l];
            out[OUT_V + l] = x.V[l];
            out[OUT_LG + l] = x.lg[l];
            out[OUT_LA + l] = x.la[l];
            out[OUT_SG + l] = x.sg[l];
            out[OUT_SA + l] = x.sa[l];
        }
        nprop_out[blockIdx.x] = nprop;
    }
}

// consts: gravity (3), the 12 noise densities, h0, the slopes' floor and
// the small-angle switch, as doubles (ops/imu_chain.constants); each is
// rounded to T, and the densities squared in T, as the plain version does
template <typename T>
int launch(const void* xin, void* xout, void* phi, void* q, void* nprop,
           int B, int KI, int S, const void* consts, void* stream) {
    if (B <= 0) return 0;
    const double* k = (const double*)consts;
    Consts<T> c;
    for (int i = 0; i < 3; ++i) c.g[i] = (T)k[i];
    for (int i = 0; i < 12; ++i) {
        const T s = (T)k[3 + i];
        c.q2[i] = s * s;
    }
    c.h0 = (T)k[15];
    c.tiny = (T)k[16];
    c.eps = (T)k[17];
    c.S = S;
    imu_chain_kernel<T><<<B, kThreads, 0, (cudaStream_t)stream>>>(
        (const T*)xin, (T*)xout, (T*)phi, (T*)q, (long long*)nprop, KI, c);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int xivo_imu_chain_f32(const void* xin, void* xout, void* phi, void* q,
                       void* nprop, int B, int KI, int S, const void* consts,
                       void* stream) {
    return launch<float>(xin, xout, phi, q, nprop, B, KI, S, consts, stream);
}

int xivo_imu_chain_f64(const void* xin, void* xout, void* phi, void* q,
                       void* nprop, int B, int KI, int S, const void* consts,
                       void* stream) {
    return launch<double>(xin, xout, phi, q, nprop, B, KI, S, consts,
                          stream);
}

}  // extern "C"
