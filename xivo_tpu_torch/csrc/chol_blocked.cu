// Blocked right-looking batched Cholesky for Hopper (sm_90a): the port of
// the Pallas kernel of xivo_tpu/ops/chol_pallas.py.
//
//   xivo_chol_blocked_f32  replaces _chol_kernel (chol_pallas.py:37)  (B7)
//
// Contract (B1's, the same as the TPU kernel's): (B, m, m) row-major
// float32, one matrix per batch item, only the lower triangle read. A
// pivot <= 1e-30 zeroes its column of L, so exactly-zero rows and columns
// of the input come out exactly zero; the strict upper triangle of L is
// zero. Every product is a float32 FMA (the TPU kernel's trailing update
// runs at Precision.HIGHEST; no TF32 here).
//
// What bounds it on the card: at (256, 228, 228) the function reads the
// lower triangle and writes L once (~80 MB), and does m^3/3 flops per
// matrix (~1 GFLOP in all): a few microseconds at the card's rates. What
// sets its time is the dependence chain of the factorization. B1
// (lanes_chol.cu) walks it one column at a time, with two block-wide
// barriers a column (456 at m = 228). This kernel keeps the TPU kernel's
// blocked right-looking structure, which is what shortens that chain; the
// TPU's batch-in-lanes layout, one-hot masks and static 128-wide blocks
// have no meaning here and are not carried over. One CTA per matrix; the
// packed lower triangle lives in shared memory (104 KB at m = 228, so two
// CTAs share an SM and B = 256 runs in one wave), and for each panel of
// T columns (T = 8, 16 or 32; the wrapper's default is 16):
//   1. one warp factors the T x T diagonal block in registers, a lane per
//      row, the column of each step passed by warp shuffles (no block-wide
//      barrier inside the panel), with the pivot floor;
//   2. every row below the block solves against it on its own, a thread
//      per row, its T entries in registers, the block read from a dense
//      copy in shared memory (all threads read the same entry: broadcast);
//   3. the deferred trailing update A22 -= P P^T on the lower triangle
//      only: each thread owns a 4 x 4 tile of A22 and accumulates the
//      panel's T products in registers (a register-tiled SYRK reading P
//      from the packed triangle), then subtracts once.
// Three barriers a panel: 45 at m = 228 with T = 16 (24 with T = 32)
// against B1's 456. The ragged edge (228 = 14 x 16 + 4, 60 = 3 x 16 + 12)
// is masked: the last panel is narrower, and the tiles past m are cut.
#include <cuda_runtime.h>

namespace {

constexpr float kFloor = 1e-30f;
constexpr int kTile = 4;            // trailing update: kTile^2 outputs a thread
constexpr unsigned kFull = 0xffffffffu;

// Packed lower-triangular storage: row i starts at tri(i), holds columns
// 0..i.
__device__ __forceinline__ int tri(int i) { return i * (i + 1) / 2; }

// Load the lower triangle of a row-major (m, m) matrix, packed; a warp per
// row, lanes across the row.
__device__ void load_lower(const float* __restrict__ src, float* dst, int m) {
    const int lane = threadIdx.x & 31, nw = blockDim.x >> 5;
    for (int i = threadIdx.x >> 5; i < m; i += nw)
        for (int k = lane; k <= i; k += 32)
            dst[tri(i) + k] = src[(size_t)i * m + k];
}

// Store a packed lower triangle as a row-major (m, m) matrix, zeroing the
// strict upper triangle.
__device__ void store_lower(const float* src, float* __restrict__ dst,
                            int m) {
    const int lane = threadIdx.x & 31, nw = blockDim.x >> 5;
    for (int i = threadIdx.x >> 5; i < m; i += nw)
        for (int k = lane; k < m; k += 32)
            dst[(size_t)i * m + k] = (k <= i) ? src[tri(i) + k] : 0.0f;
}

// Step 1, run by warp 0 alone: factor the w x w diagonal block at (c0, c0)
// in place. Lane r holds row c0 + r of the block; lanes r >= w (the ragged
// edge) hold zeros, which stay zero and give dead pivots past w. Writes a
// dense copy of the block's L to l11 (T rows of stride T + 1) and the
// reciprocal pivots (0 for a dead pivot) to rdiag, for step 2.
template <int T>
__device__ void factor_diag(float* A, float* l11, float* rdiag, int c0,
                            int w) {
    const int r = threadIdx.x;
    const bool row_ok = r < w;
    float a[T];
#pragma unroll
    for (int k = 0; k < T; ++k)
        a[k] = (row_ok && k <= r) ? A[tri(c0 + r) + c0 + k] : 0.0f;
#pragma unroll
    for (int j = 0; j < T; ++j) {
        const float piv = __shfl_sync(kFull, a[j], j);
        const bool alive = piv > kFloor;
        const float d = alive ? sqrtf(piv) : 0.0f;
        const float rd = alive ? 1.0f / d : 0.0f;
        const float lj = (r == j) ? d : (r > j ? a[j] * rd : 0.0f);
        a[j] = lj;
        if (r == j) rdiag[j] = rd;
#pragma unroll
        for (int k = j + 1; k < T; ++k) {
            const float lk = __shfl_sync(kFull, lj, k);
            if (k <= r) a[k] -= lj * lk;
        }
    }
    if (r < T) {
#pragma unroll
        for (int k = 0; k < T; ++k) {
            if (row_ok && k <= r) A[tri(c0 + r) + c0 + k] = a[k];
            l11[r * (T + 1) + k] = (k <= r) ? a[k] : 0.0f;
        }
    }
}

// Step 2: rows c0 + w .. m - 1 of the panel, each solved against the
// factored block by the same column steps as the right-looking sweep
// (scale by the reciprocal pivot, then update the later columns).
template <int T>
__device__ void solve_panel(float* A, const float* l11, const float* rdiag,
                            int m, int c0, int w) {
    for (int i = c0 + w + threadIdx.x; i < m; i += blockDim.x) {
        float* row = A + tri(i) + c0;
        float x[T];
#pragma unroll
        for (int k = 0; k < T; ++k) x[k] = (k < w) ? row[k] : 0.0f;
#pragma unroll
        for (int j = 0; j < T; ++j) {
            x[j] *= rdiag[j];
#pragma unroll
            for (int k = j + 1; k < T; ++k) x[k] -= x[j] * l11[k * (T + 1) + j];
        }
#pragma unroll
        for (int k = 0; k < T; ++k)
            if (k < w) row[k] = x[k];
    }
}

// Step 3: A[i][k] -= sum_l P[i][l] P[k][l] for n0 <= k <= i < m, where P is
// the panel (columns c0 .. c0 + w - 1, final after step 2) and n0 = c0 + w.
// The lower triangle of A22 is cut into kTile x kTile tiles, tile (ti, tk)
// with tk <= ti numbered tri(ti) + tk; a thread per tile. The panel is
// only read here and the tiles only written, so no barrier is needed
// inside.
__device__ void trailing_update(float* A, int m, int c0, int w) {
    const int n0 = c0 + w;
    const int nt = (m - n0 + kTile - 1) / kTile;
    const int ntiles = nt * (nt + 1) / 2;
    for (int t = threadIdx.x; t < ntiles; t += blockDim.x) {
        int ti = (int)((sqrtf(8.0f * (float)t + 1.0f) - 1.0f) * 0.5f);
        while (tri(ti + 1) <= t) ++ti;
        while (tri(ti) > t) --ti;
        const int tk = t - tri(ti);
        const int i0 = n0 + ti * kTile, k0 = n0 + tk * kTile;
        int pa[kTile], pb[kTile];
#pragma unroll
        for (int r = 0; r < kTile; ++r) {
            pa[r] = tri(min(i0 + r, m - 1)) + c0;   // rows past m: cut below
            pb[r] = tri(min(k0 + r, m - 1)) + c0;
        }
        float acc[kTile][kTile];
#pragma unroll
        for (int r = 0; r < kTile; ++r)
#pragma unroll
            for (int c = 0; c < kTile; ++c) acc[r][c] = 0.0f;
        for (int l = 0; l < w; ++l) {
            float a[kTile], b[kTile];
#pragma unroll
            for (int r = 0; r < kTile; ++r) {
                a[r] = A[pa[r] + l];
                b[r] = A[pb[r] + l];
            }
#pragma unroll
            for (int r = 0; r < kTile; ++r)
#pragma unroll
                for (int c = 0; c < kTile; ++c)
                    acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
        }
#pragma unroll
        for (int r = 0; r < kTile; ++r)
#pragma unroll
            for (int c = 0; c < kTile; ++c) {
                const int i = i0 + r, k = k0 + c;
                if (i < m && k <= i) A[tri(i) + k] -= acc[r][c];
            }
    }
}

constexpr int kMaxThreads = 512;

// At most 512 threads and two CTAs an SM: up to 64 registers a thread.
template <int T>
__global__ void __launch_bounds__(kMaxThreads, 2)
chol_blocked_kernel(const float* __restrict__ in, float* __restrict__ out,
                    int m) {
    extern __shared__ float smem[];
    float* A = smem;                       // tri(m), becomes L
    float* l11 = smem + tri(m);            // T x (T + 1)
    float* rdiag = l11 + T * (T + 1);      // T
    const size_t off = (size_t)blockIdx.x * m * m;
    load_lower(in + off, A, m);
    __syncthreads();
    for (int c0 = 0; c0 < m; c0 += T) {
        const int w = min(T, m - c0);
        if (threadIdx.x < 32) factor_diag<T>(A, l11, rdiag, c0, w);
        __syncthreads();
        solve_panel<T>(A, l11, rdiag, m, c0, w);
        __syncthreads();
        trailing_update(A, m, c0, w);
        __syncthreads();
    }
    store_lower(A, out + off, m);
}

int threads_for(int m) { return m <= 64 ? 256 : kMaxThreads; }

size_t smem_bytes(int m, int T) {
    return ((size_t)m * (m + 1) / 2 + (size_t)T * (T + 1) + T)
           * sizeof(float);
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, int smem) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    return cudaFuncSetAttribute(kernel,
                                cudaFuncAttributePreferredSharedMemoryCarveout,
                                (int)cudaSharedmemCarveoutMaxShared);
}

template <int T>
cudaError_t launch(const float* in, float* out, int batch, int m,
                   cudaStream_t stream) {
    chol_blocked_kernel<T><<<batch, threads_for(m), smem_bytes(m, T),
                             stream>>>(in, out, m);
    return cudaGetLastError();
}

}  // namespace

// Plain C entry points for ctypes. xivo_chol_blocked_init runs once per
// device, before the first launch there: it lets the kernel use all the
// shared memory a block may have on that device. xivo_chol_blocked_f32
// launches on the given stream with panel width `block` (8, 16 or 32),
// does not synchronize, and returns cudaGetLastError() (0 = launched); a
// matrix too large for one block's shared memory fails there, as an
// invalid launch.
extern "C" {

int xivo_chol_blocked_init(void) {
    int dev = 0, smem = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(
            &smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess) err = prepare(chol_blocked_kernel<8>, smem);
    if (err == cudaSuccess) err = prepare(chol_blocked_kernel<16>, smem);
    if (err == cudaSuccess) err = prepare(chol_blocked_kernel<32>, smem);
    return (int)err;
}

int xivo_chol_blocked_f32(const float* in, float* out, int batch, int m,
                          int block, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    switch (block) {
        case 8: return (int)launch<8>(in, out, batch, m, s);
        case 16: return (int)launch<16>(in, out, batch, m, s);
        case 32: return (int)launch<32>(in, out, batch, m, s);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // extern "C"
