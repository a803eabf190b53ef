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
// and the done/escaped flags; the slowest track sets the launch's time. One
// warp owns one track, one track a block (two or four tracks a block, or
// four strided over the grid, are slower: tools/lk_breakdown.py). A track
// that starts done (an empty or invalid row, a flat template) loads nothing
// but its position and state: done-masked updates are no-ops, so this is
// exactly the full-budget result. A live track then issues all its other
// loads before it waits on any: each lane's <= 8 of the w^2 entries of T,
// Gx and Gy and the 9 scalars into registers, kept for the whole loop, and
// the S x S search patch by 4-byte cp.async into shared memory (a track's
// patch starts at 4 S^2 bytes, 16-byte aligned on one track in four, so no
// wider copy fits every track); then one cp.async.wait_all. A step has no
// branch: every lane reads the four taps of each of its entries (a lane
// past the window reads entry 0 and adds nothing, by a select), so its 32
// reads go out together, not four at a time behind each entry's sums. The
// arithmetic is fixed operation for operation: lane entries e = lane +
// 32 k, four taps, rows first, each product and sum rounded in one order
// (written out with __fmaf_rn and __fmul_rn, so that no contraction is left
// to the compiler), a __shfl_xor_sync butterfly, which leaves the same
// value in every lane, so all lanes take the same step, clamp and flags,
// and two divisions by det. So a change of the kernel's structure leaves
// its outputs as they were, bit for bit (tools/lk_breakdown.py --parent
// checks that against another tree's build). A warp whose track is done
// leaves the loop. Convergence uses the squared form dx^2 + dy^2 < eps^2,
// as the TPU kernel does (the plain version tests ||step|| < eps, as the
// reference's jnp path does; the two differ only at the rounding of eps).
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 1;              // B5: tracks per block
constexpr int kMaxPerLane = 8;         // B5: w * w <= 32 * 8 (w <= 16)
constexpr int kTmplThreads = 256;      // B4: window entries per block

struct Tap {
    int off;        // row-major offset of the top-left tap in the patch
    float c0y, c1y, c0x, c1x;
};

// Top-left tap and weights of the window at continuous start (sx, sy) in
// an S x S patch whose rows lie ld floats apart.
__device__ __forceinline__ Tap window_tap(float sx, float sy, int S, int w,
                                          int ld) {
    const float top = (float)(S - w - 1) + 0.999f;
    sx = fminf(fmaxf(sx, 0.0f), top);
    sy = fminf(fmaxf(sy, 0.0f), top);
    const float bx = floorf(sx), by = floorf(sy);
    const float fx = sx - bx, fy = sy - by;
    Tap t;
    t.off = (int)by * ld + (int)bx;
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

// 4-byte asynchronous copy from device memory into shared memory.
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                 :: "r"(d), "l"(src) : "memory");
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
    const Tap t = window_tap(pos[2 * track], pos[2 * track + 1], S, w, S);
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
          float* __restrict__ st_out, int M, int S, int w, int ld,
          float inv_w, int iters) {
    extern __shared__ float smem[];
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int track = blockIdx.x * kWarps + warp;
    if (track >= M) return;          // whole warps only: no block barrier
    float px = pt[2 * track], py = pt[2 * track + 1];
    bool done = st[2 * track] > 0.5f;
    bool esc = st[2 * track + 1] > 0.5f;

    if (!done) {
        // one round of loads: this lane's window entries and the scalars
        // into registers, ...
        const int n = w * w;
        const size_t base = (size_t)track * n;
        float t_[kMaxPerLane], gx_[kMaxPerLane], gy_[kMaxPerLane];
#pragma unroll
        for (int k = 0; k < kMaxPerLane; ++k) {
            const int e = lane + 32 * k;
            const bool on = e < n;
            t_[k] = on ? T[base + e] : 0.0f;
            gx_[k] = on ? Gx[base + e] : 0.0f;
            gy_[k] = on ? Gy[base + e] : 0.0f;
        }
        const float* s = sc + 9 * (size_t)track;
        const float gxx = s[0], gxy = s[1], gyy = s[2], det = s[3];
        const float lox = s[4], loy = s[5], hix = s[6], hiy = s[7];
        const float eps2 = s[8];
        // ... and the search patch by cp.async
        float* patch = smem + warp * S * ld;
        const float* src = sp + (size_t)track * S * S;
        for (int e = lane; e < S * S; e += 32)
            cp_async4(patch + e, src + e);
        // the patch offset of this lane's window entries (entry 0 past the
        // window): e = w i + j at ld i + j, i = e / w from a float product,
        // exact while w^2 < 2^21 (an integer division is slower:
        // tools/lk_breakdown.py's `idiv`)
        int ij_[kMaxPerLane];
#pragma unroll
        for (int k = 0; k < kMaxPerLane; ++k) {
            const int e = lane + 32 * k;
            const int i = (int)(((float)e + 0.5f) * inv_w);
            ij_[k] = e < n ? e + i * (ld - w) : 0;
        }
        const float half = (float)(w / 2);
        asm volatile("cp.async.wait_all;\n" ::: "memory");
        __syncwarp();

        for (int it = 0; it < iters && !done; ++it) {
            const Tap t = window_tap(px - half, py - half, S, w, ld);
            const float* q0 = patch + t.off;
            float bx = 0.0f, by = 0.0f;
#pragma unroll
            for (int k = 0; k < kMaxPerLane; ++k) {
                // a lane past the window reads entry 0 and adds nothing
                const float* q = q0 + ij_[k];
                const float col0 =
                    __fmaf_rn(t.c0y, q[0], __fmul_rn(t.c1y, q[ld]));
                const float col1 =
                    __fmaf_rn(t.c0y, q[1], __fmul_rn(t.c1y, q[ld + 1]));
                const float r = __fsub_rn(
                    __fmaf_rn(t.c0x, col0, __fmul_rn(t.c1x, col1)), t_[k]);
                const bool on = lane + 32 * k < n;
                bx = on ? __fmaf_rn(r, gx_[k], bx) : bx;
                by = on ? __fmaf_rn(r, gy_[k], by) : by;
            }
            bx = warp_sum(bx);
            by = warp_sum(by);
            const float dx = __fmaf_rn(gyy, bx, -__fmul_rn(gxy, by)) / det;
            const float dy = __fmaf_rn(gxx, by, -__fmul_rn(gxy, bx)) / det;
            const bool small =
                __fmaf_rn(dx, dx, __fmul_rn(dy, dy)) < eps2;
            const float rawx = px - dx, rawy = py - dy;
            const float cx = fminf(fmaxf(rawx, lox), hix);
            const float cy = fminf(fmaxf(rawy, loy), hiy);
            const bool hit = (rawx != cx) || (rawy != cy);
            px = cx;
            py = cy;
            esc = esc || hit;
            done = small || hit;
        }
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
    const int ld = S;    // the patch's row stride in shared memory
    const size_t smem = sizeof(float) * kWarps * S * ld;
    gn_kernel<<<(M + kWarps - 1) / kWarps, 32 * kWarps, smem,
                (cudaStream_t)stream>>>(
        sp, T, Gx, Gy, sc, pt, st, pt_out, st_out, M, S, w, ld, 1.0f / w,
        iters);
    return (int)cudaGetLastError();
}

}  // extern "C"
