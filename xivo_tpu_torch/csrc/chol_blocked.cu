// Blocked batched Cholesky for Hopper (sm_90a). One kernel replaces two
// Pallas kernels that compute the same function under the same contract:
//
//   xivo_tpu/ops/lanes_chol.py:103  _chol_lanes_kernel  (B1, the filter's
//                                   per-frame Cholesky at 228 and 229)
//   xivo_tpu/ops/chol_pallas.py:37  _chol_kernel        (B7, the blocked
//                                   Cholesky of the linear-algebra profile)
//
// Contract: (B, m, m) row-major float32, one matrix per batch item, only
// the lower triangle read. A pivot <= 1e-30 zeroes its column of L, so
// exactly-zero rows and columns of the input come out exactly zero; the
// strict upper triangle of L is zero. Every product is a float32 FMA (the
// TPU kernels run at Precision.HIGHEST; no TF32 here). Any m whose packed
// triangle fits one block's shared memory (m <= ~330); a larger m fails as
// an invalid launch.
//
// What bounds it: at (256, 228, 228) the function reads the lower triangle
// and writes L once (~80 MB, 0.024 ms at 3.35 TB/s) and does m^3/3 flops a
// matrix (~1 GFLOP, 0.015 ms at 67 TFLOP/s): the bound is the bytes. What
// sets the time is the factorization's dependence chain, a pivot at a
// time, and the phases that wait on it: a column at a time, B1 took 456
// block-wide barriers a matrix; with a warp-factored diagonal block a
// panel, 45 (B7), and then the trailing update's shared-memory traffic (0.5
// words a FMA, bank conflicts on a row-major packed triangle). The design:
//   - one CTA per matrix, the lower triangle packed BY COLUMNS in shared
//     memory: column j holds rows 4*(j/4) .. mp - 1 (mp = m rounded up to
//     8), so every column starts on 16 bytes and (i, j) is float4-aligned
//     when 4 | i. 109,440 bytes at m = 228 (109,456 at 229): two CTAs an
//     SM, and B = 256 runs in one wave;
//   - panels of 16 columns. Look-ahead: while the other warps write panel
//     p's columns of L to device memory and apply its trailing update,
//     warp 0 updates the next panel's 16 x 16 diagonal block (two lanes a
//     row, half the panel's columns each) and factors it in registers (a
//     lane per row, the column of each step passed by shuffles), so the
//     pivot chain runs behind the update. Then every thread solves a row
//     of the next panel below its block against the factored block, read
//     from shared memory. Two block-wide barriers a panel: 32 at m = 228;
//   - the trailing update A22 -= P P^T is a register-tiled SYRK: a thread
//     per 8 x 8 tile of the lower triangle (from a tile list made once per
//     CTA: no square-root search) reads four float4 of the panel's columns
//     a step for 64 FMAs (0.25 words a FMA); the lanes of a quarter-warp
//     take consecutive row tiles, the two row halves of a tile swapped on
//     every other group of four lanes, so the float4 reads are free of
//     bank conflicts;
//   - device memory: the load is cp.async, coalesced along rows (panel
//     0's columns in a group of their own, so its block is factored while
//     the rest streams in); the zero upper triangle is written at the
//     start, and each panel's columns of L as soon as they are final,
//     behind the chain.
#include <cuda_runtime.h>

namespace {

constexpr float kFloor = 1e-30f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kT = 16;                      // panel width
constexpr int kBlock = kT * kT + kT;        // a factored block, see below

// Rows padded to the SYRK's 8-row tiles (a panel starts on a tile).
__host__ __device__ __forceinline__ int padded(int m) { return (m + 7) & ~7; }

// Column-major packed lower triangle: the offset of column j's first
// stored row (row 4 * (j / 4)); col_off(m, mp) is the whole size.
__host__ __device__ __forceinline__ int col_off(int j, int mp) {
    const int g = j >> 2, r = j & 3;
    return 4 * g * mp - 8 * g * (g - 1) + r * (mp - 4 * g);
}

// (i, j) lives at cbase(j, mp) + i.
__device__ __forceinline__ int cbase(int j, int mp) {
    return col_off(j, mp) - 4 * (j >> 2);
}

// For j0 a multiple of 4: cbase(j0 + l) = cbase(j0) + l (mp - j0) - 4
// quad_sum(l), so a panel's column bases need one base and one stride.
__host__ __device__ constexpr int quad_sum(int l) {
    int s = 0;
    for (int t = 1; t <= l; ++t) s += t >> 2;
    return s;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                 "l"(src)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float4 ld4(const float* p) {
    return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, float4 v) {
    *reinterpret_cast<float4*>(p) = v;
}

// Columns jlo .. jhi - 1 into the packed layout, a warp per row and its
// lanes across the row: each warp's reads are one coalesced run of the
// row, and each lane's copy lands in its column. Stored entries outside
// the lower triangle, and rows m .. mp - 1, are 0.
__device__ void load_rows(const float* __restrict__ src, float* A, int m,
                          int mp, int jlo, int jhi) {
    const int lane = threadIdx.x & 31, nw = blockDim.x >> 5;
    for (int i = threadIdx.x >> 5; i < mp; i += nw) {
        const int jend = min(jhi, (i & ~3) + 4);   // stored: 4 (j / 4) <= i
        for (int j = jlo + lane; j < jend; j += 32) {
            float* dst = A + cbase(j, mp) + i;
            if (j <= i && i < m)
                cp_async4(dst, src + (size_t)i * m + j);
            else
                *dst = 0.0f;
        }
    }
}

// The SYRK's tiles, (row tile a, column tile b), b <= a < nt, as
// (a << 8) | b, by b descending and a ascending: the tiles whose column
// tile is b0 or later are the first (nt - b0)(nt - b0 + 1) / 2.
__device__ void make_tiles(unsigned short* tiles, int nt) {
    const int n = nt * (nt + 1) / 2;
    for (int t = threadIdx.x; t < n; t += blockDim.x) {
        int u = 0;
        while ((u + 1) * (u + 2) / 2 <= t) ++u;
        const int b = nt - 1 - u, a = b + (t - u * (u + 1) / 2);
        tiles[t] = (unsigned short)((a << 8) | b);
    }
}

// The strict upper triangle of L, a warp per row.
__device__ void zero_upper(float* __restrict__ dst, int m) {
    const int lane = threadIdx.x & 31, nw = blockDim.x >> 5;
    for (int i = threadIdx.x >> 5; i < m; i += nw)
        for (int j = i + 1 + lane; j < m; j += 32)
            dst[(size_t)i * m + j] = 0.0f;
}

// Warp 0 alone: the w x w diagonal block at (n0, n0), first updated by
// the 16 final columns of the panel at c0 (c0 < 0: no update; lanes r and
// r + 16 take row r, each for half the columns), then factored in
// registers, a lane per row, the column of each step passed by shuffles.
// Lanes r >= w hold zeros, which stay zero and give dead pivots past w.
// Writes the factored block to blk: L[k][j] at 16 j + k, then the
// reciprocal pivots (0 for a dead pivot).
__device__ void factor_block(const float* A, float* blk, int mp, int c0,
                             int n0, int w) {
    const int lane = threadIdx.x, r = lane & (kT - 1), h = lane / kT;
    const bool row = r < w;
    const float* D = A + cbase(n0, mp);
    const int ds = mp - n0;
    float a[kT];
#pragma unroll
    for (int k = 0; k < kT; ++k)
        a[k] = (h == 0 && row && k <= r)
                   ? D[k * ds - 4 * quad_sum(k) + n0 + r] : 0.0f;
    if (c0 >= 0) {
        // for the last block, rows past mp read the next column's first
        // entries (it exists: n0 < m); they reach only a[k] with k >= w,
        // which nothing reads as L
        const float* P = A + cbase(c0, mp) + n0;
        const int ps = mp - c0;
#pragma unroll
        for (int l = 0; l < kT / 2; ++l) {
            const int ll = l + h * (kT / 2);
            const float* col =
                P + ll * ps -
                4 * (h ? quad_sum(l + kT / 2) : quad_sum(l));
            const float pr = row ? col[r] : 0.0f;
#pragma unroll
            for (int q = 0; q < kT; q += 4) {
                const float4 v = ld4(col + q);
                a[q] -= pr * v.x;
                a[q + 1] -= pr * v.y;
                a[q + 2] -= pr * v.z;
                a[q + 3] -= pr * v.w;
            }
        }
#pragma unroll
        for (int k = 0; k < kT; ++k) {
            a[k] += __shfl_down_sync(kFull, a[k], kT);
            if (h) a[k] = 0.0f;
        }
    }
    // a[k] for k > r is never read as L (lj is 0 there) and is zeroed
    // before it leaves the warp
#pragma unroll
    for (int j = 0; j < kT; ++j) {
        const float piv = __shfl_sync(kFull, a[j], j);
        const bool alive = piv > kFloor;
        const float rd = alive ? rsqrtf(piv) : 0.0f;
        const float d = piv * rd;
        const float lj = (r == j) ? d : (r > j ? a[j] * rd : 0.0f);
        a[j] = lj;
        if (lane == 0) blk[kT * kT + j] = rd;
#pragma unroll
        for (int k = j + 1; k < kT; ++k)
            a[k] -= lj * __shfl_sync(kFull, lj, k);
    }
    if (lane < kT) {
#pragma unroll
        for (int k = 0; k < kT; ++k) blk[k * kT + r] = k <= r ? a[k] : 0.0f;
    }
}

// The rows below the diagonal block of the full panel at c0, a thread per
// row, each solved against the factored block by the column steps of the
// right-looking sweep (scale by the reciprocal pivot, then update the
// later columns), the block read from shared memory (a broadcast).
__device__ void solve_below(float* A, const float* blk, int m, int mp,
                            int c0) {
    float* P = A + cbase(c0, mp);
    const int ps = mp - c0;
    for (int i = c0 + kT + threadIdx.x; i < m; i += blockDim.x) {
        float x[kT];
#pragma unroll
        for (int k = 0; k < kT; ++k) x[k] = P[k * ps - 4 * quad_sum(k) + i];
#pragma unroll
        for (int j = 0; j < kT; ++j) {
            x[j] *= blk[kT * kT + j];
#pragma unroll
            for (int q = (j + 1) & ~3; q < kT; q += 4) {
                const float4 v = ld4(blk + j * kT + q);
                if (q > j) x[q] -= x[j] * v.x;
                if (q + 1 > j) x[q + 1] -= x[j] * v.y;
                if (q + 2 > j) x[q + 2] -= x[j] * v.z;
                x[q + 3] -= x[j] * v.w;
            }
        }
#pragma unroll
        for (int k = 0; k < kT; ++k) P[k * ps - 4 * quad_sum(k) + i] = x[k];
    }
}

// The panel's columns of L (rows c0 .. m - 1) to device memory, by the
// threads past warp 0: a run of 16 entries of a row for each 16 threads.
__device__ void store_panel(const float* A, const float* blk,
                            float* __restrict__ out, int m, int mp, int c0,
                            int w) {
    const int t = threadIdx.x - 32, col = t % kT;
    if (col >= w) return;
    const float* C = A + cbase(c0 + col, mp);
    for (int i = c0 + t / kT; i < m; i += (blockDim.x - 32) / kT) {
        const int r = i - c0;
        out[(size_t)i * m + c0 + col] =
            r < w ? (col <= r ? blk[col * kT + r] : 0.0f) : C[i];
    }
}

// A[i][k] -= sum_l P[i][l] P[k][l] for n0 + 16 <= i and n0 <= k <= i (P:
// the panel's 16 columns from row n0 on, final in shared memory), by the
// threads past warp 0; the next panel's diagonal block is warp 0's. A
// thread per 8 x 8 tile; its rows i0 + 4s .. + 3 and i0 + 4(1 - s) .. + 3
// with s = bit 2 of the thread, so the eight lanes of a quarter-warp read
// eight distinct float4 bank groups; its columns k0 .. k0 + 7 are read by
// the whole quarter-warp at once (a broadcast). Entries above the diagonal
// inside a diagonal tile are computed and written into the column's
// padding, which nothing reads; columns past m are not stored and not
// written.
__device__ void trailing_update(float* A, const unsigned short* tiles,
                                int m, int mp, int c0) {
    const int n0 = c0 + kT, nb = (mp >> 3) - (n0 >> 3);
    const int count = nb * (nb + 1) / 2;
    const int s = (threadIdx.x >> 2) & 1;
    const float* P = A + cbase(c0, mp);
    const int ps = mp - c0;
    for (int t = threadIdx.x - 32; t < count; t += blockDim.x - 32) {
        const int e = tiles[t];
        const int i0 = 8 * (e >> 8), k0 = 8 * (e & 255);
        if (i0 < n0 + kT) continue;
        const int ia = i0 + 4 * s, ib = i0 + 4 * (s ^ 1);
        float acc[8][8];
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
            for (int c = 0; c < 8; ++c) acc[r][c] = 0.0f;
#pragma unroll
        for (int l = 0; l < kT; ++l) {
            const float* col = P + l * ps - 4 * quad_sum(l);
            const float4 p0 = ld4(col + ia), p1 = ld4(col + ib);
            const float4 q0 = ld4(col + k0), q1 = ld4(col + k0 + 4);
            const float pa[8] = {p0.x, p0.y, p0.z, p0.w,
                                 p1.x, p1.y, p1.z, p1.w};
            const float qb[8] = {q0.x, q0.y, q0.z, q0.w,
                                 q1.x, q1.y, q1.z, q1.w};
#pragma unroll
            for (int r = 0; r < 8; ++r)
#pragma unroll
                for (int c = 0; c < 8; ++c)
                    acc[r][c] = fmaf(pa[r], qb[c], acc[r][c]);
        }
        float* C = A + cbase(k0, mp);
        const int cs = mp - k0;
#pragma unroll
        for (int c = 0; c < 8; ++c) {
            const int k = k0 + c, top = 4 * (k >> 2);
            float* col = C + c * cs - 4 * quad_sum(c);
            if (k < m) {
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    const int row = h ? ib : ia;
                    if (row >= top) {
                        float4 v = ld4(col + row);
                        v.x -= acc[4 * h][c];
                        v.y -= acc[4 * h + 1][c];
                        v.z -= acc[4 * h + 2][c];
                        v.w -= acc[4 * h + 3][c];
                        st4(col + row, v);
                    }
                }
            }
        }
    }
}

// 256 threads and two CTAs an SM: up to 128 registers a thread. Per
// panel p: all threads solve p's rows below its (already factored)
// diagonal block; barrier; then warp 0 updates and factors the next
// panel's block (look-ahead) while the other warps write p's columns of L
// to device memory and apply p's trailing update; barrier.
__global__ void __launch_bounds__(kThreads, 2)
chol_blocked_kernel(const float* __restrict__ in, float* __restrict__ out,
                    int m) {
    extern __shared__ __align__(16) float smem[];
    const int mp = padded(m);
    float* A = smem;
    float* blocks = smem + col_off(m, mp);              // two, in turn
    unsigned short* tiles =
        reinterpret_cast<unsigned short*>(blocks + 2 * kBlock);
    const size_t off = (size_t)blockIdx.x * m * m;
    in += off;
    out += off;
    load_rows(in, A, m, mp, 0, min(kT, m));
    cp_async_commit();
    load_rows(in, A, m, mp, kT, m);
    cp_async_commit();
    make_tiles(tiles, mp >> 3);
    zero_upper(out, m);
    cp_async_wait<1>();                 // panel 0's columns are in
    __syncthreads();
    if (threadIdx.x < 32) factor_block(A, blocks, mp, -1, 0, min(kT, m));
    __syncthreads();
    for (int c0 = 0, p = 0; c0 < m; c0 += kT, ++p) {
        const int w = min(kT, m - c0), n0 = c0 + kT;
        const float* blk = blocks + (p & 1) * kBlock;
        if (n0 < m) solve_below(A, blk, m, mp, c0);
        if (p == 0) cp_async_wait<0>();
        __syncthreads();
        if (threadIdx.x < 32) {
            if (n0 < m)
                factor_block(A, blocks + ((p + 1) & 1) * kBlock, mp, c0, n0,
                             min(kT, m - n0));
        } else {
            store_panel(A, blk, out, m, mp, c0, w);
            if (n0 < m) trailing_update(A, tiles, m, mp, c0);
        }
        __syncthreads();
    }
}

size_t smem_bytes(int m) {
    const int mp = padded(m), nt = mp >> 3;
    const size_t bytes =
        ((size_t)col_off(m, mp) + 2 * kBlock) * sizeof(float) +
        (size_t)nt * (nt + 1) / 2 * sizeof(unsigned short);
    return (bytes + 15) & ~(size_t)15;
}

}  // namespace

// Plain C entry points for ctypes. xivo_chol_blocked_init runs once per
// device, before the first launch there: it lets the kernel use all the
// shared memory a block may have on that device. xivo_chol_blocked_f32
// launches on the given stream, does not synchronize, and returns
// cudaGetLastError() (0 = launched); a matrix too large for one block's
// shared memory fails there, as an invalid launch.
extern "C" {

int xivo_chol_blocked_init(void) {
    int dev = 0, smem = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(
            &smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess)
        err = cudaFuncSetAttribute(
            chol_blocked_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            smem);
    if (err == cudaSuccess)
        err = cudaFuncSetAttribute(
            chol_blocked_kernel,
            cudaFuncAttributePreferredSharedMemoryCarveout,
            (int)cudaSharedmemCarveoutMaxShared);
    return (int)err;
}

int xivo_chol_blocked_f32(const float* in, float* out, int batch, int m,
                          void* stream) {
    chol_blocked_kernel<<<batch, kThreads, smem_bytes(m),
                          (cudaStream_t)stream>>>(in, out, m);
    return (int)cudaGetLastError();
}

}  // extern "C"
