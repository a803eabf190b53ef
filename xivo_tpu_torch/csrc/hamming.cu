// Hamming nearest-neighbour search for Hopper (sm_90a): the port of the
// Pallas kernel of xivo_tpu/ops/hamming_pallas.py.
//
//   xivo_hamming_nn  replaces _kernel (hamming_pallas.py:34)  (B6)
//
// For B sequences: F query descriptors (B, F, 8) against an M-entry map
// (B, M, 8) with a validity mask (B, M). Each descriptor is 8 words of 32
// bits, held in int64 (the port's layout). The result per query is the
// packed key (dist << 32) | idx of its nearest valid entry, in int64; the
// caller fills the keys with (10000 << 32) | 0 beforehand, so a query with
// no valid entry keeps distance 10000 and index 0, as the reference does.
// Taking the minimum of the packed key gives the lowest index among equal
// distances by construction, in any order of the blocks.
//
// What bounds it: the function must read the mask (1.3 MB at B = 64,
// M = 20000), the queries and the words of the valid entries only; a live
// map holds a few hundred valid entries of its 20000, so the mask and the
// queries are most of the bytes, and the population counts (8 * F per
// valid entry) are few. One block per (sequence, chunk of kChunk map
// entries, tile of up to kThreads queries) first lists the chunk's valid
// entries from the mask and leaves at once if there are none; otherwise it
// stages the listed entries' words, and only those, in shared memory
// (16 KB if all are valid). Each thread keeps one query's 8 words in
// registers and scans a share of the list; all threads of a warp read the
// same or neighbouring list entries, so the shared loads broadcast. With
// fewer queries than threads (F = 30), kThreads / F threads share a query,
// each taking every (kThreads / F)-th listed entry. A thread keeps its
// running minimum key in a register, folds it into the block's minimum in
// shared memory with a 64-bit atomicMin, and one thread per query folds
// the block's minimum into the result with a 64-bit atomicMin in device
// memory. The list's order (shared atomics) does not matter: the minimum
// of the keys is the same in any order. M needs no padding: the last chunk
// is ragged.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 512;      // map entries per block
constexpr int kThreads = 256;    // threads per block, queries per tile
constexpr int kWords = 8;

__global__ void hamming_nn_kernel(const long long* __restrict__ q,
                                  const long long* __restrict__ desc,
                                  const unsigned char* __restrict__ valid,
                                  unsigned long long* __restrict__ best,
                                  int F, int M, int n_qtiles) {
    __shared__ uint32_t s_desc[kChunk * kWords];  // listed entries' words
    __shared__ short s_list[kChunk];         // valid entries of the chunk
    __shared__ int s_n;
    __shared__ unsigned long long s_best[kThreads];

    const int b = blockIdx.y / n_qtiles;
    const int q0 = (blockIdx.y % n_qtiles) * kThreads;
    const int nq = min(kThreads, F - q0);
    const int m0 = blockIdx.x * kChunk;
    const int nm = min(kChunk, M - m0);

    if (threadIdx.x == 0) s_n = 0;
    __syncthreads();
    const unsigned char* vsrc = valid + (long long)b * M + m0;
    for (int i = threadIdx.x; i < nm; i += blockDim.x)
        if (vsrc[i]) s_list[atomicAdd(&s_n, 1)] = (short)i;
    __syncthreads();
    const int n_valid = s_n;
    if (n_valid == 0) return;                // the same for the whole block

    if (threadIdx.x < nq) s_best[threadIdx.x] = ~0ULL;
    const long long* src = desc + ((long long)b * M + m0) * kWords;
    for (int i = threadIdx.x; i < n_valid * kWords; i += blockDim.x)
        s_desc[i] = (uint32_t)src[s_list[i / kWords] * kWords + i % kWords];
    __syncthreads();

    const int share = max(1, kThreads / nq);    // threads per query
    const int qi = threadIdx.x % nq;
    const int part = threadIdx.x / nq;
    if (part < share) {
        const long long* qsrc = q + ((long long)b * F + q0 + qi) * kWords;
        uint32_t w[kWords];
#pragma unroll
        for (int k = 0; k < kWords; ++k) w[k] = (uint32_t)qsrc[k];
        unsigned long long key = ~0ULL;
        for (int l = part; l < n_valid; l += share) {
            const int j = s_list[l];
            const uint32_t* e = s_desc + l * kWords;
            int d = 0;
#pragma unroll
            for (int k = 0; k < kWords; ++k) d += __popc(w[k] ^ e[k]);
            const unsigned long long kj =
                ((unsigned long long)d << 32) | (unsigned)(m0 + j);
            key = kj < key ? kj : key;
        }
        if (key != ~0ULL) atomicMin(&s_best[qi], key);
    }
    __syncthreads();
    if (threadIdx.x < nq && s_best[threadIdx.x] != ~0ULL)
        atomicMin(&best[(long long)b * F + q0 + threadIdx.x],
                  s_best[threadIdx.x]);
}

}  // namespace

extern "C" {

// q (B, F, 8) int64, desc (B, M, 8) int64, valid (B, M) bool, best (B, F)
// int64 holding (10000 << 32) on entry.
int xivo_hamming_nn(const long long* q, const long long* desc,
                    const unsigned char* valid, long long* best, int B,
                    int F, int M, void* stream) {
    if (B <= 0 || F <= 0 || M <= 0) return 0;
    const int n_qtiles = (F + kThreads - 1) / kThreads;
    const dim3 grid((M + kChunk - 1) / kChunk, B * n_qtiles);
    hamming_nn_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        q, desc, valid, (unsigned long long*)best, F, M, n_qtiles);
    return (int)cudaGetLastError();
}

}  // extern "C"
