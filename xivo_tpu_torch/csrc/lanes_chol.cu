// Batched Cholesky, fused Cholesky + inverse, and triangular inverse for
// Hopper (sm_90a): the port of the three Pallas kernels of
// xivo_tpu/ops/lanes_chol.py.
//
//   xivo_chol_f32      replaces _chol_lanes_kernel     (lanes_chol.py:103)
//   xivo_chol_inv_f32  replaces _chol_inv_lanes_kernel (lanes_chol.py:108)
//   xivo_tri_inv_f32   replaces _tri_inv_lanes_kernel  (lanes_chol.py:133)
//
// Contract (same as the TPU kernels): (B, m, m) row-major float32, one
// matrix per batch item. A pivot <= 1e-30 zeroes its column of L (and its
// row of L^-1), so exactly-zero rows/columns of the input (empty slots,
// gauge-fixed entries, frozen calibration states) come out exactly zero.
// The strict upper triangle of every output is zero, and only the lower
// triangle of every input is read.
//
// What bounds these on the card: the square-root filter's main path calls
// them at m = 228 (xivo_chol_f32, the per-frame recompression) and m = 60
// (the innovation factor) for B = 256 sequences. The arithmetic is tiny
// (m^3/3 flops per matrix) and the bytes are one read and one write of
// the batch, but a Cholesky is a chain of m dependent column steps: the
// kernel is bound by that latency and by the barrier each step needs, not
// by bytes or FLOPs. The TPU kernel put the batch in the vector lanes to
// vectorize the chain; here the batch maps to CTAs instead (one CTA per
// matrix, so every SM runs its own chains) and the matrix lives in shared
// memory, so each column step costs two __syncthreads and shared-memory
// traffic only: no device-memory round trip inside the chain. Only the
// lower triangle is kept, packed (m(m+1)/2 floats: 102 KiB at m = 228), so
// two CTAs fit on an SM and B = 256 runs in one wave over 132 SMs. The
// trailing update gives each warp whole rows, its lanes across columns,
// which keeps shared-memory accesses conflict-free. Making the chain
// shorter (blocked panels) is later work.
#include <cuda_runtime.h>

namespace {

constexpr float kFloor = 1e-30f;

// Packed lower-triangular storage: row i starts at tri(i), holds columns
// 0..i.
__device__ __forceinline__ int tri(int i) { return i * (i + 1) / 2; }

// Rows are walked one warp per row (warp w takes rows w, w + warps, ...),
// lanes across the row.
__device__ __forceinline__ int lane_id() { return threadIdx.x & 31; }
__device__ __forceinline__ int warp_id() { return threadIdx.x >> 5; }
__device__ __forceinline__ int n_warps() { return blockDim.x >> 5; }

// Load the lower triangle of a row-major (m, m) matrix, packed.
__device__ void load_lower(const float* __restrict__ src, float* dst, int m) {
    for (int i = warp_id(); i < m; i += n_warps())
        for (int k = lane_id(); k <= i; k += 32)
            dst[tri(i) + k] = src[i * m + k];
}

// Store a packed lower triangle as a row-major (m, m) matrix, zeroing the
// strict upper triangle.
__device__ void store_lower(const float* src, float* __restrict__ dst,
                            int m) {
    for (int i = warp_id(); i < m; i += n_warps())
        for (int k = lane_id(); k < m; k += 32)
            dst[i * m + k] = (k <= i) ? src[tri(i) + k] : 0.0f;
}

// Column step j of the right-looking sweep: scale column j of L below
// the diagonal in place and copy the whole column (pivot included) into
// col, returning 1/L[j][j] (0 for a dead pivot). Every thread reads the
// pivot, so the diagonal itself is written back only after the caller's
// barrier, by trailing_update.
__device__ float scale_column(float* A, float* col, int m, int j) {
    const float piv = A[tri(j) + j];
    const bool alive = piv > kFloor;
    const float d = alive ? sqrtf(piv) : 0.0f;
    const float rd = alive ? 1.0f / d : 0.0f;
    for (int i = j + threadIdx.x; i < m; i += blockDim.x) {
        const float v = (i == j) ? d : A[tri(i) + j] * rd;
        if (i != j) A[tri(i) + j] = v;
        col[i] = v;
    }
    return rd;
}

// Write back the pivot, then the trailing symmetric rank-1 update of the
// lower triangle: A[i][k] -= L[i][j] L[k][j] for j < k <= i.
__device__ void trailing_update(float* A, const float* col, int m, int j) {
    if (threadIdx.x == 0) A[tri(j) + j] = col[j];
    for (int i = j + 1 + warp_id(); i < m; i += n_warps()) {
        const float li = col[i];
        float* row = A + tri(i);
        for (int k = j + 1 + lane_id(); k <= i; k += 32)
            row[k] -= li * col[k];
    }
}

// Row j of L^-1 by forward substitution, from row j of L (final for
// columns <= j) and rows < j of L^-1: Linv[j][c] = (delta_jc -
// sum_{c<=k<j} L[j][k] Linv[k][c]) / L[j][j]; a dead pivot gives a zero row.
__device__ void inverse_row(const float* Lt, float* inv, int j, float rd) {
    const float* lrow = Lt + tri(j);
    for (int c = threadIdx.x; c <= j; c += blockDim.x) {
        float acc = 0.0f;
        // p walks down column c of the packed inverse: tri(k) + c
        for (int k = c, p = tri(c) + c; k < j; p += ++k)
            acc += lrow[k] * inv[p];
        inv[tri(j) + c] = ((c == j ? 1.0f : 0.0f) - acc) * rd;
    }
}

// At most 1024 threads, two CTAs per SM: the compiler keeps to 32
// registers a thread so that both fit.
__global__ void __launch_bounds__(1024, 2)
chol_kernel(const float* __restrict__ in, float* __restrict__ out, int m) {
    extern __shared__ float smem[];
    float* A = smem;             // tri(m), becomes L
    float* col = smem + tri(m);  // m
    const size_t off = (size_t)blockIdx.x * m * m;
    load_lower(in + off, A, m);
    __syncthreads();
    for (int j = 0; j < m; ++j) {
        scale_column(A, col, m, j);
        __syncthreads();
        trailing_update(A, col, m, j);
        __syncthreads();
    }
    store_lower(A, out + off, m);
}

__global__ void chol_inv_kernel(const float* __restrict__ in,
                                float* __restrict__ out_l,
                                float* __restrict__ out_inv, int m) {
    extern __shared__ float smem[];
    float* A = smem;                 // tri(m), becomes L
    float* inv = smem + tri(m);      // tri(m), becomes L^-1
    float* col = smem + 2 * tri(m);  // m
    const size_t off = (size_t)blockIdx.x * m * m;
    load_lower(in + off, A, m);
    __syncthreads();
    for (int j = 0; j < m; ++j) {
        const float rd = scale_column(A, col, m, j);
        __syncthreads();
        // row j of L is final now; the trailing update writes only rows
        // and columns > j, so the forward substitution runs beside it
        inverse_row(A, inv, j, rd);
        trailing_update(A, col, m, j);
        __syncthreads();
    }
    store_lower(A, out_l + off, m);
    store_lower(inv, out_inv + off, m);
}

__global__ void tri_inv_kernel(const float* __restrict__ in,
                               float* __restrict__ out, int m) {
    extern __shared__ float smem[];
    float* Lt = smem;            // tri(m)
    float* inv = smem + tri(m);  // tri(m)
    const size_t off = (size_t)blockIdx.x * m * m;
    load_lower(in + off, Lt, m);
    __syncthreads();
    for (int j = 0; j < m; ++j) {
        const float d = Lt[tri(j) + j];
        inverse_row(Lt, inv, j, d > kFloor ? 1.0f / d : 0.0f);
        __syncthreads();
    }
    store_lower(inv, out + off, m);
}

int threads_for(int m) { return m <= 64 ? 256 : (m <= 128 ? 512 : 1024); }

size_t tri_floats(int m) { return (size_t)m * (m + 1) / 2; }

// Let a kernel opt in to up to `smem` bytes of dynamic shared memory, and
// ask for the largest shared-memory carve-out so that two large CTAs share
// an SM.
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

// Plain C entry points for ctypes. xivo_lanes_chol_init runs once per
// device, before the first launch there: it lets every kernel use all the
// shared memory a block may have on that device. The launch entries then
// launch on the given stream, do not synchronize, and return
// cudaGetLastError() (0 = launched); a matrix too large for one block's
// shared memory fails there, as an invalid launch.
extern "C" {

int xivo_lanes_chol_init(void) {
    int dev = 0, smem = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(
            &smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess) err = prepare(chol_kernel, smem);
    if (err == cudaSuccess) err = prepare(chol_inv_kernel, smem);
    if (err == cudaSuccess) err = prepare(tri_inv_kernel, smem);
    return (int)err;
}

int xivo_chol_f32(const float* in, float* out, int batch, int m,
                  void* stream) {
    const size_t smem = (tri_floats(m) + m) * sizeof(float);
    chol_kernel<<<batch, threads_for(m), smem, (cudaStream_t)stream>>>(
        in, out, m);
    return (int)cudaGetLastError();
}

int xivo_chol_inv_f32(const float* in, float* out_l, float* out_inv,
                      int batch, int m, void* stream) {
    const size_t smem = (2 * tri_floats(m) + m) * sizeof(float);
    chol_inv_kernel<<<batch, threads_for(m), smem, (cudaStream_t)stream>>>(
        in, out_l, out_inv, m);
    return (int)cudaGetLastError();
}

int xivo_tri_inv_f32(const float* in, float* out, int batch, int m,
                     void* stream) {
    const size_t smem = 2 * tri_floats(m) * sizeof(float);
    tri_inv_kernel<<<batch, threads_for(m), smem, (cudaStream_t)stream>>>(
        in, out, m);
    return (int)cudaGetLastError();
}

}  // extern "C"
