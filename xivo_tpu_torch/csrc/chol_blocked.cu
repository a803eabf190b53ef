// Blocked batched Cholesky, and the same factorization followed by a
// blocked triangular inverse, for Hopper (sm_90a). Three kernels replace
// four Pallas kernels:
//
//   chol_blocked_kernel      xivo_tpu/ops/lanes_chol.py:103
//                            _chol_lanes_kernel (B1, the filter's per-frame
//                            Cholesky at 228 and 229) and
//                            xivo_tpu/ops/chol_pallas.py:37 _chol_kernel
//                            (B7), the same function under one contract
//   chol_inv_blocked_kernel  xivo_tpu/ops/lanes_chol.py:108
//                            _chol_inv_lanes_kernel (B2: L and L^-1)
//   tri_inv_blocked_kernel   xivo_tpu/ops/lanes_chol.py:133
//                            _tri_inv_lanes_kernel (B3: a triangle's
//                            inverse)
//
// Contract: (B, m, m) row-major float32, one matrix per batch item, only
// the lower triangle read. A pivot <= 1e-30 zeroes its column of L, so
// exactly-zero rows and columns of the input come out exactly zero; the
// strict upper triangle of L is zero. L^-1 (B2, B3) inverts the live
// pivots and has a zero row and column at each dead one (a diagonal of L
// <= 1e-30 for B3), whatever B3's input holds below the diagonal there;
// its upper triangle is zero. Every product is a float32 FMA (the TPU
// kernels run at Precision.HIGHEST; no TF32 here). Any m whose packed
// buffers fit one block's shared memory (B1/B7: m <= ~330; B2 and B3,
// which add the row-packed inverse: m <= ~230); a larger m
// fails as an invalid launch.
//
// B2 and B3 at 60 and 120 rows (the filter's innovation factor and the
// OOS blocks) are bound by bytes too (~0.003 and ~0.011 ms at B = 256):
// what sets their time is the chain. Walked a column at a time, with a
// barrier and a serial dot product for each row of the inverse, it took
// some 30 times the bound on the H100; here the factorization is B1's, and the inverse a
// block-row substitution that keeps the row-by-row substitution's order
// of sums (see the inversion stage below).
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
// reciprocal pivots (0 for a dead pivot); with kKeep, also its lower
// triangle back into A, where nothing else reads or writes it until the
// factorization ends (B2's inversion reads it there).
template <bool kKeep>
__device__ void factor_block(float* A, float* blk, int mp, int c0, int n0,
                             int w) {
    const int lane = threadIdx.x, r = lane & (kT - 1), h = lane / kT;
    const bool row = r < w;
    float* D = A + cbase(n0, mp);
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
        if (kKeep && row) {
#pragma unroll
            for (int k = 0; k < kT; ++k)
                if (k <= r) D[k * ds - 4 * quad_sum(k) + n0 + r] = a[k];
        }
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

// The factorization, by every thread of the CTA; A, blocks and tiles in
// shared memory (see smem_bytes). Per panel p: all threads solve p's rows
// below its (already factored) diagonal block; barrier; then warp 0
// updates and factors the next panel's block (look-ahead) while the other
// warps write p's columns of L to device memory and apply p's trailing
// update; barrier. Ends with L in A below the diagonal blocks and, with
// kKeep, in them too.
template <bool kKeep>
__device__ __forceinline__ void factorize(const float* __restrict__ in,
                                          float* __restrict__ out, float* A,
                                          float* blocks,
                                          unsigned short* tiles, int m,
                                          int mp) {
    load_rows(in, A, m, mp, 0, min(kT, m));
    cp_async_commit();
    load_rows(in, A, m, mp, kT, m);
    cp_async_commit();
    make_tiles(tiles, mp >> 3);
    zero_upper(out, m);
    cp_async_wait<1>();                 // panel 0's columns are in
    __syncthreads();
    if (threadIdx.x < 32)
        factor_block<kKeep>(A, blocks, mp, -1, 0, min(kT, m));
    __syncthreads();
    for (int c0 = 0, p = 0; c0 < m; c0 += kT, ++p) {
        const int w = min(kT, m - c0), n0 = c0 + kT;
        const float* blk = blocks + (p & 1) * kBlock;
        if (n0 < m) solve_below(A, blk, m, mp, c0);
        if (p == 0) cp_async_wait<0>();
        __syncthreads();
        if (threadIdx.x < 32) {
            if (n0 < m)
                factor_block<kKeep>(A, blocks + ((p + 1) & 1) * kBlock, mp,
                                    c0, n0, min(kT, m - n0));
        } else {
            store_panel(A, blk, out, m, mp, c0, w);
            if (n0 < m) trailing_update(A, tiles, m, mp, c0);
        }
        __syncthreads();
    }
}

// ---------------------------------------------------------------------------
// The inversion stage (B2 after the factorization, B3 after a load):
// X = L^-1 from the packed L in A, into X packed BY ROWS: row i holds
// columns 0 .. 4 (i / 4) + 3, so every row starts on 16 bytes (the
// entries past i are never read). First the reciprocal pivots, 1 / L[i][i]
// (0 for a dead pivot <= 1e-30), into rdv; then block-row forward
// substitution, 16 rows a step and one barrier a step (4 at 60 rows, 8 at
// 120): at step I every column c <= 16 I + 15 of the rows 16 I .. 16 I +
// 15 at once, two lanes a column:
//   - the sums over the final rows above, sum over c <= k < 16 I of
//     L[i][k] X[k][c], eight rows a lane, the lanes of a warp in step
//     over k: for each k two float4 of L's column k (the same for every
//     column: a broadcast) and one entry of X's row k (consecutive
//     columns on consecutive lane pairs), eight FMAs;
//   - the two lanes swap their sums by shuffles, and each then runs the
//     16 rows in turn in registers, both alike (SIMT makes the copy
//     free): X[i][c] = (e_c - sum_i) * rdv[i], then sum_i' += L[i'][i]
//     X[i][c] for the later rows i' of the block; lane q stores rows 8q ..
//     8q + 7.
// (Two lanes a column timed best on the H100: with one the sums run
// longer, with four the copies of the 16-row chain cost more warps.)
// Every entry's sum thus runs over k = c, c + 1, ... in order, one FMA a
// term, and the last step is (e_c - sum) * (1 / L[i][i]): forward
// substitution row by row, term for term, so that a given L gives the
// same X bit for bit as a kernel that finishes one row of X a step; only
// the chain is shorter (16 steps in registers and a barrier a block row,
// not a barrier and a serial dot product a row). A
// dead pivot gives x = 0, which adds exactly nothing to later sums, so
// whatever L holds below the diagonal in a dead row or column is ignored
// and that row and column of X come out exactly zero.
// ---------------------------------------------------------------------------

// Offset of row i of the row-packed X; row_off(mp) is the whole size.
__host__ __device__ __forceinline__ int row_off(int i) {
    const int g = i >> 2, r = i & 3;
    return 4 * (g + 1) * (2 * g + r);
}

__device__ __forceinline__ void fma4(float* acc, float4 l, float x) {
    acc[0] = fmaf(l.x, x, acc[0]);
    acc[1] = fmaf(l.y, x, acc[1]);
    acc[2] = fmaf(l.z, x, acc[2]);
    acc[3] = fmaf(l.w, x, acc[3]);
}

// Floats of rdv: a pivot for every row of the last block row.
__host__ __device__ __forceinline__ int rdv_size(int m) {
    return (m + kT - 1) & ~(kT - 1);
}

// Lanes a column in the substitution, and the rows of the block row each
// keeps a sum for.
constexpr int kLanes = 2;
constexpr int kRows = kT / kLanes;

// X = L^-1 (see above), ending with a barrier; L final in A, read after a
// barrier. Lanes kLanes q' .. kLanes q' + kLanes - 1 take column q' of a
// pass; a lane past the pass's columns takes column i0, whose sums are
// empty, and stores nothing, but runs every shuffle.
__device__ void invert(const float* A, float* X, float* rdv, int m,
                       int mp) {
    for (int i = threadIdx.x; i < rdv_size(m); i += blockDim.x) {
        const float d = i < m ? A[cbase(i, mp) + i] : 0.0f;
        rdv[i] = d > kFloor ? 1.0f / d : 0.0f;
    }
    __syncthreads();
    const int lane = threadIdx.x & 31, q = lane % kLanes;
    const int group = lane - q;
    for (int i0 = 0; i0 < m; i0 += kT) {
        const int n = kLanes * min(i0 + kT, m), r0 = i0 + kRows * q;
        const float* D = A + cbase(i0, mp) + i0;   // L[i0][i0], its column
        const int ds = mp - i0;
        float rd[kT];
#pragma unroll
        for (int g = 0; g < kT; g += 4) {
            const float4 v = ld4(rdv + i0 + g);
            rd[g] = v.x;
            rd[g + 1] = v.y;
            rd[g + 2] = v.z;
            rd[g + 3] = v.w;
        }
        for (int base = 0; base < n; base += blockDim.x) {
            const bool ok = base + threadIdx.x < n;
            const int c = ok ? (base + threadIdx.x) / kLanes : i0;
            // the sums over k < i0, kRows rows a lane: the warp walks k
            // from its first column cw (a multiple of 8), four a step
            // (strides mp - k and k + 4), so that its lanes read one
            // float4 run of L's column k and consecutive entries of X's
            // row k; a lane adds exact zeros while k < c, which leave its
            // sum +0 until its first term, as a walk from k = c would
            float own[kRows] = {};
            const int cw = (base + (threadIdx.x & ~31)) / kLanes;
            if (r0 < m && cw < i0) {
                const float* lk = A + cbase(cw, mp) + r0;
                const float* xk = X + row_off(cw) + c;
                for (int k = cw; k < i0; k += 4) {
                    const int ls = mp - k, xs = k + 4;
#pragma unroll
                    for (int u = 0; u < 4; ++u) {
                        const float x = k + u >= c ? xk[u * xs] : 0.0f;
#pragma unroll
                        for (int j = 0; j < kRows; j += 4)
                            if (r0 + j < m)
                                fma4(own + j, ld4(lk + u * ls + j), x);
                    }
                    lk += 4 * ls - 4;
                    xk += 4 * xs;
                }
            }
            float acc[kT];
#pragma unroll
            for (int r = 0; r < kT; ++r)
                acc[r] = kLanes == 1 ? own[r]
                                     : __shfl_sync(kFull, own[r % kRows],
                                                   group | (r / kRows));
#pragma unroll
            for (int r = 0; r < kT; ++r) {
                const int i = i0 + r;
                const float x =
                    i >= c ? ((i == c ? 1.0f : 0.0f) - acc[r]) * rd[r] : 0.0f;
                if (i >= m) break;             // and so are the rows after
                if (ok && q == r / kRows && i >= c) X[row_off(i) + c] = x;
                const float* col = D + r * ds - 4 * quad_sum(r);
#pragma unroll
                for (int g = (r + 1) & ~3; g < kT; g += 4) {
                    if (i0 + g < m) {
                        const float4 l = ld4(col + g);
                        if (g > r) acc[g] = fmaf(l.x, x, acc[g]);
                        if (g + 1 > r) acc[g + 1] = fmaf(l.y, x, acc[g + 1]);
                        if (g + 2 > r) acc[g + 2] = fmaf(l.z, x, acc[g + 2]);
                        acc[g + 3] = fmaf(l.w, x, acc[g + 3]);
                    }
                }
            }
        }
        __syncthreads();
    }
}

// X to device memory, row-major with a zero upper triangle: a warp per
// row, its lanes along the row.
__device__ void store_rows(const float* X, float* __restrict__ dst, int m) {
    const int lane = threadIdx.x & 31, nw = blockDim.x >> 5;
    for (int i = threadIdx.x >> 5; i < m; i += nw) {
        const float* xr = X + row_off(i);
        for (int j = lane; j < m; j += 32)
            dst[(size_t)i * m + j] = j <= i ? xr[j] : 0.0f;
    }
}

// B2's and B3's common end: the inverse, then its store (rdv after X).
__device__ __forceinline__ void inverse_stage(const float* A, float* X,
                                              float* __restrict__ dst,
                                              int m, int mp) {
    invert(A, X, X + row_off(mp), m, mp);
    store_rows(X, dst, m);
}


// 256 threads and two CTAs an SM: up to 128 registers a thread.
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
    factorize<false>(in + off, out + off, A, blocks, tiles, m, mp);
}

// B2: the factorization as above, keeping the diagonal blocks in A, then
// the inversion stage. Shared memory: A | blocks | X | rdv | tiles.
__global__ void __launch_bounds__(kThreads, 2)
chol_inv_blocked_kernel(const float* __restrict__ in,
                        float* __restrict__ out_l,
                        float* __restrict__ out_inv, int m) {
    extern __shared__ __align__(16) float smem[];
    const int mp = padded(m);
    float* A = smem;
    float* blocks = A + col_off(m, mp);
    float* X = blocks + 2 * kBlock;
    unsigned short* tiles =
        reinterpret_cast<unsigned short*>(X + row_off(mp) + rdv_size(m));
    const size_t off = (size_t)blockIdx.x * m * m;
    factorize<true>(in + off, out_l + off, A, blocks, tiles, m, mp);
    inverse_stage(A, X, out_inv + off, m, mp);
}

// B3: L's lower triangle loaded into the same packed layout, then the
// inversion stage. Shared memory: A | X | rdv.
__global__ void __launch_bounds__(kThreads, 2)
tri_inv_blocked_kernel(const float* __restrict__ in, float* __restrict__ out,
                       int m) {
    extern __shared__ __align__(16) float smem[];
    const int mp = padded(m);
    float* A = smem;
    float* X = A + col_off(m, mp);
    const size_t off = (size_t)blockIdx.x * m * m;
    load_rows(in + off, A, m, mp, 0, m);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    inverse_stage(A, X, out + off, m, mp);
}

size_t round16(size_t bytes) { return (bytes + 15) & ~(size_t)15; }

size_t tiles_bytes(int mp) {
    const int nt = mp >> 3;
    return (size_t)nt * (nt + 1) / 2 * sizeof(unsigned short);
}

size_t smem_bytes(int m) {
    const int mp = padded(m);
    return round16(((size_t)col_off(m, mp) + 2 * kBlock) * sizeof(float) +
                   tiles_bytes(mp));
}

size_t smem_bytes_chol_inv(int m) {
    const int mp = padded(m);
    return round16(((size_t)col_off(m, mp) + 2 * kBlock + row_off(mp) +
                    rdv_size(m)) * sizeof(float) + tiles_bytes(mp));
}

size_t smem_bytes_tri_inv(int m) {
    const int mp = padded(m);
    return ((size_t)col_off(m, mp) + row_off(mp) + rdv_size(m)) *
           sizeof(float);
}

// Let a kernel use up to `smem` bytes of dynamic shared memory, with the
// largest shared-memory carve-out.
template <typename Kernel>
cudaError_t prepare(Kernel kernel, int smem) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    return cudaFuncSetAttribute(kernel,
                                cudaFuncAttributePreferredSharedMemoryCarveout,
                                (int)cudaSharedmemCarveoutMaxShared);
}

}  // namespace

// Plain C entry points for ctypes. xivo_chol_blocked_init runs once per
// device, before the first launch there: it lets every kernel use all the
// shared memory a block may have on that device. The launch entries
// launch on the given stream, do not synchronize, and return
// cudaGetLastError() (0 = launched); a matrix too large for one block's
// shared memory fails there, as an invalid launch.
extern "C" {

int xivo_chol_blocked_init(void) {
    int dev = 0, smem = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(
            &smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess) err = prepare(chol_blocked_kernel, smem);
    if (err == cudaSuccess) err = prepare(chol_inv_blocked_kernel, smem);
    if (err == cudaSuccess) err = prepare(tri_inv_blocked_kernel, smem);
    return (int)err;
}

int xivo_chol_blocked_f32(const float* in, float* out, int batch, int m,
                          void* stream) {
    chol_blocked_kernel<<<batch, kThreads, smem_bytes(m),
                          (cudaStream_t)stream>>>(in, out, m);
    return (int)cudaGetLastError();
}

int xivo_chol_inv_f32(const float* in, float* out_l, float* out_inv,
                      int batch, int m, void* stream) {
    chol_inv_blocked_kernel<<<batch, kThreads, smem_bytes_chol_inv(m),
                              (cudaStream_t)stream>>>(in, out_l, out_inv, m);
    return (int)cudaGetLastError();
}

int xivo_tri_inv_f32(const float* in, float* out, int batch, int m,
                     void* stream) {
    tri_inv_blocked_kernel<<<batch, kThreads, smem_bytes_tri_inv(m),
                             (cudaStream_t)stream>>>(in, out, m);
    return (int)cudaGetLastError();
}

}  // extern "C"
