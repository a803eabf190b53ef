// Pyramidal Lucas-Kanade kernels for Hopper (sm_90a): the port of the two
// Pallas kernels of xivo_tpu/ops/lk_pallas.py.
//
//   xivo_lk_templates_f32  replaces _tmpl_kernel (lk_pallas.py:107)  (B4)
//   xivo_lk_gn_f32         replaces _gn_kernel   (lk_pallas.py:60)   (B5)
//
// Layout: track-leading, as the JAX package's public functions have it.
// M tracks; patches (M, S, S), windows (M, w, w), per-track scalars (M, k),
// all row-major float32.
//
// Bilinear window. The TPU kernels sum over all S - w + 1 integer offsets
// with 2-hot weights (a layout trick for the vector lanes); that sum equals
// the 4-tap bilinear form computed here: the start is clipped to
// [0, S - w - 1 + 0.999], b = floor(start), f = start - b, weights (1 - f, f)
// on each axis, rows first, then columns.
//
// B4 (templates) is bound by bytes: each track reads the (w + 1)^2 window it
// needs of each of its three S x S patches and writes three w x w windows;
// there is no reuse to exploit. A thread per output entry (all three
// arrays), M * w^2 threads in blocks of 256, lanes across columns, so the
// four taps of neighbouring lanes are neighbouring addresses and the card
// holds enough loads in flight to cover their latency.
//
// B5 (Gauss-Newton loop) is bound by latency, not by bytes or FLOPs: up to
// `iters` dependent steps per track, each a bilinear resample of the
// window, a residual, two reductions over w^2 entries, a 2x2 solve, a clamp
// and the done/escaped flags. The design keeps everything of the chain on
// chip. One warp owns one track (a block holds four); the S x S search
// patch is staged once into shared memory (3.8 KB at S = 31) with eight
// loads in flight per lane, each lane keeps its <= 8 of the w^2 entries of
// T, Gx and Gy in registers for the whole loop, and the two sums are
// reduced with __shfl_xor_sync butterflies, which leave the same value in
// every lane, so all lanes take the same step, clamp and flags. A warp
// whose track is done leaves the loop, and one whose track starts done (an
// empty or invalid row, a flat template) loads nothing but its position
// and state: done-masked updates are no-ops, so this is exactly the
// full-budget result. Convergence uses the squared form
// dx^2 + dy^2 < eps^2, as the TPU kernel does (the plain version tests
// ||step|| < eps, as the reference's jnp path does; the two differ only at
// the rounding of eps).
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;              // B5: tracks per block
constexpr int kMaxPerLane = 8;         // B5: w * w <= 32 * 8 (w <= 16)
constexpr int kStage = 8;              // B5: patch loads in flight a lane
constexpr int kTmplThreads = 256;      // B4: window entries per block

struct Tap {
    int off;        // row-major offset of the top-left tap in the patch
    float c0y, c1y, c0x, c1x;
};

// Top-left tap and weights of the window at continuous start (sx, sy).
__device__ __forceinline__ Tap window_tap(float sx, float sy, int S, int w) {
    const float top = (float)(S - w - 1) + 0.999f;
    sx = fminf(fmaxf(sx, 0.0f), top);
    sy = fminf(fmaxf(sy, 0.0f), top);
    const float bx = floorf(sx), by = floorf(sy);
    const float fx = sx - bx, fy = sy - by;
    Tap t;
    t.off = (int)by * S + (int)bx;
    t.c0y = 1.0f - fy;
    t.c1y = fy;
    t.c0x = 1.0f - fx;
    t.c1x = fx;
    return t;
}

// Window entry (i, j): rows first (the two rows at columns j and j + 1),
// then columns.
__device__ __forceinline__ float window_at(const float* p, const Tap& t,
                                           int i, int j, int S) {
    const float* q = p + t.off + i * S + j;
    const float col0 = t.c0y * q[0] + t.c1y * q[S];
    const float col1 = t.c0y * q[1] + t.c1y * q[S + 1];
    return t.c0x * col0 + t.c1x * col1;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int m = 16; m > 0; m >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, m);
    return v;
}

__global__ void __launch_bounds__(kTmplThreads)
templates_kernel(const float* __restrict__ tp, const float* __restrict__ gxp,
                 const float* __restrict__ gyp, const float* __restrict__ pos,
                 float* __restrict__ T, float* __restrict__ Gx,
                 float* __restrict__ Gy, int M, int S, int w) {
    const int n = w * w;                 // M * n < 2^31 (the wrapper)
    const int idx = blockIdx.x * kTmplThreads + threadIdx.x;
    if (idx >= M * n) return;
    const int track = idx / n;
    const int e = idx - track * n;
    const int i = e / w, j = e - i * w;
    const Tap t = window_tap(pos[2 * track], pos[2 * track + 1], S, w);
    const size_t in = (size_t)track * S * S;
    T[idx] = window_at(tp + in, t, i, j, S);
    Gx[idx] = window_at(gxp + in, t, i, j, S);
    Gy[idx] = window_at(gyp + in, t, i, j, S);
}

__global__ void __launch_bounds__(32 * kWarps)
gn_kernel(const float* __restrict__ sp, const float* __restrict__ T,
          const float* __restrict__ Gx, const float* __restrict__ Gy,
          const float* __restrict__ sc, const float* __restrict__ pt,
          const float* __restrict__ st, float* __restrict__ pt_out,
          float* __restrict__ st_out, int M, int S, int w, int iters) {
    extern __shared__ float smem[];
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int track = blockIdx.x * kWarps + warp;
    if (track >= M) return;          // whole warps only: no block barrier
    float* patch = smem + warp * S * S;
    float px = pt[2 * track], py = pt[2 * track + 1];
    bool done = st[2 * track] > 0.5f;
    bool esc = st[2 * track + 1] > 0.5f;

    if (!done) {
        // stage the search patch, kStage loads in flight per lane
        const float* src = sp + (size_t)track * S * S;
        const int n_sp = S * S;
        for (int base = 0; base < n_sp; base += 32 * kStage) {
            float v[kStage];
#pragma unroll
            for (int u = 0; u < kStage; ++u) {
                const int e = base + lane + 32 * u;
                v[u] = e < n_sp ? src[e] : 0.0f;
            }
#pragma unroll
            for (int u = 0; u < kStage; ++u) {
                const int e = base + lane + 32 * u;
                if (e < n_sp) patch[e] = v[u];
            }
        }
    }

    // this lane's window entries, kept in registers for the whole loop
    const int n = w * w;
    const size_t base = (size_t)track * n;
    float t_[kMaxPerLane], gx_[kMaxPerLane], gy_[kMaxPerLane];
    int ij_[kMaxPerLane];
#pragma unroll
    for (int k = 0; k < kMaxPerLane; ++k) {
        const int e = lane + 32 * k;
        const bool on = !done && e < n;
        t_[k] = on ? T[base + e] : 0.0f;
        gx_[k] = on ? Gx[base + e] : 0.0f;
        gy_[k] = on ? Gy[base + e] : 0.0f;
        ij_[k] = on ? (e / w) * S + (e - (e / w) * w) : 0;
    }
    __syncwarp();

    const float* s = sc + 9 * (size_t)track;
    const float gxx = s[0], gxy = s[1], gyy = s[2], det = s[3];
    const float lox = s[4], loy = s[5], hix = s[6], hiy = s[7];
    const float eps2 = s[8];
    const float half = (float)(w / 2);

    for (int it = 0; it < iters && !done; ++it) {
        const Tap t = window_tap(px - half, py - half, S, w);
        float bx = 0.0f, by = 0.0f;
#pragma unroll
        for (int k = 0; k < kMaxPerLane; ++k) {
            if (lane + 32 * k < n) {
                const float* q = patch + t.off + ij_[k];
                const float col0 = t.c0y * q[0] + t.c1y * q[S];
                const float col1 = t.c0y * q[1] + t.c1y * q[S + 1];
                const float r = (t.c0x * col0 + t.c1x * col1) - t_[k];
                bx += gx_[k] * r;
                by += gy_[k] * r;
            }
        }
        bx = warp_sum(bx);
        by = warp_sum(by);
        const float dx = (gyy * bx - gxy * by) / det;
        const float dy = (gxx * by - gxy * bx) / det;
        const bool small = dx * dx + dy * dy < eps2;
        const float rawx = px - dx, rawy = py - dy;
        const float cx = fminf(fmaxf(rawx, lox), hix);
        const float cy = fminf(fmaxf(rawy, loy), hiy);
        const bool hit = (rawx != cx) || (rawy != cy);
        px = cx;
        py = cy;
        esc = esc || hit;
        done = small || hit;
    }
    if (lane == 0) {
        pt_out[2 * track] = px;
        pt_out[2 * track + 1] = py;
        st_out[2 * track] = done ? 1.0f : 0.0f;
        st_out[2 * track + 1] = esc ? 1.0f : 0.0f;
    }
}


}  // namespace

extern "C" {

int xivo_lk_templates_f32(const float* tp, const float* gxp, const float* gyp,
                          const float* pos, float* T, float* Gx, float* Gy,
                          int M, int S, int w, void* stream) {
    if (M <= 0) return 0;
    const int grid = (M * w * w + kTmplThreads - 1) / kTmplThreads;
    templates_kernel<<<grid, kTmplThreads, 0, (cudaStream_t)stream>>>(
        tp, gxp, gyp, pos, T, Gx, Gy, M, S, w);
    return (int)cudaGetLastError();
}

int xivo_lk_gn_f32(const float* sp, const float* T, const float* Gx,
                   const float* Gy, const float* sc, const float* pt,
                   const float* st, float* pt_out, float* st_out, int M,
                   int S, int w, int iters, void* stream) {
    if (M <= 0) return 0;
    const size_t smem = sizeof(float) * kWarps * S * S;
    gn_kernel<<<(M + kWarps - 1) / kWarps, 32 * kWarps, smem,
                (cudaStream_t)stream>>>(
        sp, T, Gx, Gy, sc, pt, st, pt_out, st_out, M, S, w, iters);
    return (int)cudaGetLastError();
}

}  // extern "C"
