// Hamming nearest-neighbour search for Hopper (sm_90a): the port of the
// Pallas kernel of xivo_tpu/ops/hamming_pallas.py.
//
//   xivo_hamming_nn  replaces _kernel (hamming_pallas.py:34)  (B6)
//
// For B sequences: F query descriptors (B, F, 8) against an M-entry map
// (B, M, 8) with a validity mask (B, M), and an optional query-row mask
// (B, F). Each descriptor is 8 words of 32 bits, held in int64 (the port's
// layout). Per query row the kernel writes the distance and the index of
// its nearest valid entry, the lowest index among equal distances, as
// int64; a row with no valid entry, or whose query-row mask is false, gets
// (10000, 0), as the reference does for the former. One launch writes
// every row: nothing runs before or after it.
//
// What bounds it: the function must read the mask (1.3 MB at B = 64,
// M = 20000), the unmasked queries and the words of the valid entries
// only, and compute a 256-bit distance per (unmasked query, valid entry).
// A live map holds well under 2 % of its slots, so on the mapped path the
// bytes bound it and the time goes to latency: a few dependent trips to
// memory and the cluster's barriers. With every entry valid, the
// operations bound it.
//
// Design: G thread-block clusters of C CTAs a sequence, C and G chosen at
// launch from B and F (choose_shape below): cluster g takes the g-th of G
// parts of the sequence's unmasked rows, and its CTAs split the map.
// - Each CTA reads 1/C of the sequence's mask, 16 bytes a thread (the row
//   need not be aligned: the loads cover the 16-byte pieces that hold it,
//   and bytes outside the row are ignored), and lists its valid entries
//   in index order with a block-wide prefix sum of the per-thread counts;
//   no shared atomics.
// - Each CTA stores its list's length in every peer's shared memory
//   (distributed shared memory); after cluster.sync() each reads the
//   lists it needs from its peers and takes 1/C of the cluster's whole
//   list: the work is split evenly however the valid entries lie (a ring
//   buffer keeps them contiguous, in one or two CTAs' part of the mask).
// - Every CTA lists the unmasked query rows (the query-row mask is F
//   bytes) and deals its cluster's part of them to its threads: s = the
//   largest power of two <= min(32, kThreads / rows) threads per row (in
//   passes of kThreads rows), each keeping its row's 8 words in registers
//   and scanning every s-th entry of the CTA's share.
// - The share is staged through shared memory in tiles of kTile entries,
//   double-buffered with cp.async, and narrowed to 32-bit words once per
//   entry before it is scored.
// - A thread scans its entries in index order and keeps the first of the
//   smallest distance (branch-free). The packed key (dist << 32) | idx is
//   folded over the threads of a row with warp shuffles (a row's threads
//   are at most a warp) and stored through distributed shared memory into
//   the slot that the row's owner keeps for this CTA: one writer a slot,
//   and the owner fills its slots before the first cluster.sync(), which
//   every store follows. After a last cluster.sync() (no CTA reads a peer
//   after it, so none leaves while a peer may read its shared memory) the
//   owner writes the minimum of its slots: the smallest distance at the
//   lowest index, in any order of the work, so the result is exact.
// - So a cluster takes two cluster barriers (one more per extra round or
//   pass), and the arrival at a third, split, at the start: no CTA
//   touches a peer before every CTA of the cluster has started.
// The mask is processed in rounds of C * kThreads * 16 entries, and the
// rows in passes of kThreads, so shared memory is bounded whatever M is;
// F is at most kMaxF.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxCluster = 8;   // CTAs a cluster (the portable most)
constexpr int kThreads = 256;    // threads per CTA, query rows per pass
constexpr int kWarps = kThreads / 32;
constexpr int kWords = 8;
constexpr int kSeg = kThreads * 16;   // mask entries a CTA lists a round
constexpr int kTile = 128;       // list entries staged per tile
constexpr int kMaxF = 1024;      // query rows per sequence
constexpr int kMinRows = kThreads / 32;   // a row takes at most a warp
constexpr int kNoMatch = 10000;
constexpr unsigned long long kNone = ~0ULL;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The cluster barrier split in two: a CTA may touch a peer's shared
// memory only once every CTA of the cluster has started, which the wait
// after an arrive at the start guarantees.
__device__ __forceinline__ void cluster_arrive_relaxed() {
    asm volatile("barrier.cluster.arrive.relaxed;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
    asm volatile("barrier.cluster.wait;\n" ::: "memory");
}

// The Hamming distance of two 256-bit descriptors (8 words each) with 4
// population counts instead of 8. Carry-save adders (a + b + c =
// (a ^ b ^ c) + 2 maj(a, b, c), one 3-input logic operation for each
// half) sum seven of the 8 XORed words bit by bit into one word of weight
// 1 and three of weight 2; one more sums those three into weights 2 and
// 4. With the eighth word that leaves four words to count: 16 logic
// operations (8 XORs, 8 for the adders) and 4 counts a pair, where the
// count runs at a quarter of the rate of a logic operation. Exact.
__device__ __forceinline__ uint32_t distance(const uint32_t* w, uint4 a,
                                             uint4 c) {
    const uint32_t x0 = w[0] ^ a.x, x1 = w[1] ^ a.y, x2 = w[2] ^ a.z,
                   x3 = w[3] ^ a.w, x4 = w[4] ^ c.x, x5 = w[5] ^ c.y,
                   x6 = w[6] ^ c.z, x7 = w[7] ^ c.w;
    const uint32_t s1 = x0 ^ x1 ^ x2, c1 = (x0 & x1) | (x2 & (x0 ^ x1));
    const uint32_t s2 = s1 ^ x3 ^ x4, c2 = (s1 & x3) | (x4 & (s1 ^ x3));
    const uint32_t s3 = s2 ^ x5 ^ x6, c3 = (s2 & x5) | (x6 & (s2 ^ x5));
    const uint32_t twos = c1 ^ c2 ^ c3, fours = (c1 & c2) | (c3 & (c1 ^ c2));
    return __popc(s3) + __popc(x7) + 2 * __popc(twos) + 4 * __popc(fours);
}

// Exclusive prefix sum of v over the CTA's threads in thread order; *total
// receives the sum. Two barriers; s_warp is free again on return.
__device__ int block_prefix(int v, int* s_warp, int* total) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    int x = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, x, o);
        if (lane >= o) x += y;
    }
    if (lane == 31) s_warp[warp] = x;
    __syncthreads();
    int base = 0, sum = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
        const int t = s_warp[w];
        base += w < warp ? t : 0;
        sum += t;
    }
    *total = sum;
    __syncthreads();
    return base + x - v;
}

// at most 64 registers a thread, so that 4 CTAs fit an SM (with 46 KB of
// shared memory each). Launched in clusters of C CTAs, G clusters a
// sequence; C is a template argument, so that the loops over the cluster
// unroll (read at run time, C cost a register spill and about 1 us a call on
// an H100).
template <int C>
__global__ void __launch_bounds__(kThreads, 4)
    hamming_nn_kernel(const long long* __restrict__ q,
                      const long long* __restrict__ desc,
                      const unsigned char* __restrict__ valid,
                      const unsigned char* __restrict__ qmask,
                      long long* __restrict__ dist,
                      long long* __restrict__ idx, int F, int M, int G) {
    __shared__ __align__(16) long long s_raw[2][kTile * kWords];
    __shared__ __align__(16) uint32_t s_nar[kTile * kWords];
    // the keys of the rows this CTA owns, fc slots for each CTA of the
    // cluster: each CTA stores its own keys there, the owner takes the min
    __shared__ unsigned long long s_key[kMaxF + kMaxCluster];
    __shared__ uint16_t s_list[kSeg];    // this CTA's valid entries, a round
    __shared__ uint16_t s_mine[kSeg];    // its share of the cluster's list
    __shared__ uint16_t s_q[kMaxF];      // the unmasked query rows
    __shared__ int s_warp[kWarps];
    __shared__ int s_count[kMaxCluster];  // each CTA's list length, a round

    cluster_arrive_relaxed();
    cg::cluster_group cluster = cg::this_cluster();
    const int rank = (int)cluster.block_rank();
    const int cl = blockIdx.x / C;               // this cluster
    const int b = cl / G, g = cl - b * G;        // its sequence, its part
    const int tid = threadIdx.x;

    // the mask row as 16-byte pieces; entry m is byte m + mis of them
    const unsigned char* row = valid + (long long)b * M;
    const int mis = (int)((uintptr_t)row & 15);
    const uint4* gran = (const uint4*)(row - mis);
    const int n_gran = (mis + M + 15) / 16;
    const int n_round = C * kThreads;            // pieces a round
    const int n_rounds = (n_gran + n_round - 1) / n_round;

    // this CTA's piece of round k: (first piece of the round, own offset,
    // own count)
    auto piece = [&](int k, int& r0, int& my0, int& myn) {
        r0 = k * n_round;
        const int rn = min(n_round, n_gran - r0);
        const int per = (rn + C - 1) / C;
        my0 = rank * per;
        myn = max(0, min(per, rn - my0));
    };
    // round 0's mask load goes out before anything waits
    uint4 first = make_uint4(0, 0, 0, 0);
    {
        int r0, my0, myn;
        piece(0, r0, my0, myn);
        if (tid < myn) first = gran[r0 + my0 + tid];
    }

    // the unmasked query rows, in order
    int n_q = F;
    if (qmask != nullptr) {
        const unsigned char* qrow = qmask + (long long)b * F;
        n_q = 0;
        for (int f0 = 0; f0 < F; f0 += kThreads) {
            const int f = f0 + tid;
            const int on = f < F && qrow[f] != 0;
            int tot;
            const int at = block_prefix(on, s_warp, &tot);
            if (on) s_q[n_q + at] = (uint16_t)f;
            n_q += tot;
        }
        // the masked rows of this CTA's 1/(G C) of the rows
        const int part = g * C + rank, parts = G * C;
        for (int f = F * part / parts + tid; f < F * (part + 1) / parts;
             f += kThreads)
            if (qrow[f] == 0) {
                dist[(long long)b * F + f] = kNoMatch;
                idx[(long long)b * F + f] = 0;
            }
    }
    // this cluster's rows of the list, [lo, hi); CTA r owns [lo + r fc,
    // lo + (r + 1) fc)
    const int lo = n_q * g / G, hi = n_q * (g + 1) / G;
    const int fc = (hi - lo + C - 1) / C;
    for (int i = tid; i < C * fc; i += kThreads) s_key[i] = kNone;
    __syncthreads();
    cluster_wait();       // every peer has started

    for (int p0 = lo; p0 < hi; p0 += kThreads) {
        // this pass's rows: s threads each, s a power of two <= 32, so
        // that one warp holds all the threads of a row
        const int qn = min(kThreads, hi - p0);
        int s = 1;
        while (s < 32 && 2 * s * qn <= kThreads) s *= 2;
        const int j = tid / s, part = tid & (s - 1);
        const bool live = j < qn;
        uint32_t w[kWords];
        if (live) {
            const int f = qmask != nullptr ? s_q[p0 + j] : p0 + j;
            const longlong2* src =
                (const longlong2*)(q + ((long long)b * F + f) * kWords);
#pragma unroll
            for (int k = 0; k < kWords / 2; ++k) {
                const longlong2 v = src[k];
                w[2 * k] = (uint32_t)v.x;
                w[2 * k + 1] = (uint32_t)v.y;
            }
        }
        uint32_t best_d = 0xFFFFFFFFu, best_i = 0;

        for (int k = 0; k < n_rounds; ++k) {
            int r0, my0, myn;
            piece(k, r0, my0, myn);
            // list this CTA's valid entries, in index order, relative to
            // the round's first entry
            uint4 v = first;
            if (p0 > lo || k > 0)
                v = tid < myn ? gran[r0 + my0 + tid] : make_uint4(0, 0, 0, 0);
            const int g0 = r0 + my0 + tid;          // this thread's piece
            const uint32_t word[4] = {v.x, v.y, v.z, v.w};
            uint32_t bits = 0;
            if (tid < myn) {
#pragma unroll
                for (int c = 0; c < 16; ++c) {
                    const int m = g0 * 16 + c - mis;
                    if (((word[c >> 2] >> (8 * (c & 3))) & 0xFFu) != 0 &&
                        m >= 0 && m < M)
                        bits |= 1u << c;
                }
            }
            int total;
            int at = block_prefix(__popc(bits), s_warp, &total);
            while (bits) {
                const int c = __ffs(bits) - 1;
                bits &= bits - 1;
                s_list[at++] = (uint16_t)((my0 + tid) * 16 + c);
            }
            // every CTA learns this one's length
            if (tid < C) cluster.map_shared_rank(s_count, tid)[rank] = total;
            cluster.sync();

            // the cluster's list: CTA r's part starts at pre[r]; this CTA
            // takes entries [e_lo, e_hi) of it
            int pre[C + 1];
            pre[0] = 0;
#pragma unroll
            for (int r = 0; r < C; ++r) pre[r + 1] = pre[r] + s_count[r];
            const int L = pre[C];
            const int e_lo = L * rank / C;
            const int e_hi = L * (rank + 1) / C;
            for (int e = e_lo + tid; e < e_hi; e += kThreads) {
                // the last CTA whose part starts at or before e holds it
                int r = 0, start = 0;
#pragma unroll
                for (int c = 1; c < C; ++c)
                    if (e >= pre[c]) r = c, start = pre[c];
                s_mine[e - e_lo] =
                    cluster.map_shared_rank(s_list, r)[e - start];
            }
            // peers may overwrite their lists and lengths in the next round
            if (p0 + kThreads < hi || k + 1 < n_rounds)
                cluster.sync();
            else
                __syncthreads();

            const int n = e_hi - e_lo;
            const int mbase = r0 * 16 - mis;   // entry of list value 0
            const int n_tiles = (n + kTile - 1) / kTile;
            auto stage = [&](int t) {
                const int t0 = t * kTile, tn = min(kTile, n - t0);
                long long* dst = s_raw[t & 1];
                for (int c = tid; c < tn * 4; c += kThreads) {
                    const int m = mbase + s_mine[t0 + (c >> 2)];
                    cp_async16(dst + c * 2,
                               desc + ((long long)b * M + m) * kWords +
                                   (c & 3) * 2);
                }
                cp_async_commit();
            };
            // the round's best: distance and position in s_mine
            uint32_t rd = 0xFFFFFFFFu;
            int rpos = 0;
            auto scan = [&](int t0, int e0, int tn, int step) {
#pragma unroll 4
                for (int e = e0; e < tn; e += step) {
                    const uint4* en = (const uint4*)(s_nar + e * kWords);
                    const uint4 a = en[0], c = en[1];
                    const uint32_t d = distance(w, a, c);
                    const bool better = d < rd;
                    rd = better ? d : rd;
                    rpos = better ? t0 + e : rpos;
                }
            };
            if (n_tiles > 0) stage(0);
            for (int t = 0; t < n_tiles; ++t) {
                if (t + 1 < n_tiles) {
                    stage(t + 1);
                    cp_async_wait<1>();
                } else {
                    cp_async_wait<0>();
                }
                __syncthreads();
                const int t0 = t * kTile, tn = min(kTile, n - t0);
                const longlong2* raw = (const longlong2*)s_raw[t & 1];
                for (int c = tid; c < tn * 4; c += kThreads) {
                    const longlong2 x = raw[c];
                    *(uint2*)(s_nar + c * 2) =
                        make_uint2((uint32_t)x.x, (uint32_t)x.y);
                }
                __syncthreads();
                if (live) {
                    if (s == 1)
                        scan(t0, 0, tn, 1);
                    else
                        scan(t0, part, tn, s);
                }
                __syncthreads();
            }
            // rounds come in index order: a later one wins only if closer
            if (rd < best_d) {
                best_d = rd;
                best_i = (uint32_t)(mbase + s_mine[rpos]);
            }
        }

        // fold over the row's threads (one warp holds them all), and store
        // the key in the owner's slot for this CTA
        unsigned long long key =
            best_d == 0xFFFFFFFFu
                ? kNone
                : ((unsigned long long)best_d << 32) | best_i;
        for (int o = s >> 1; o > 0; o >>= 1) {
            const unsigned long long y = __shfl_xor_sync(0xffffffffu, key, o);
            key = y < key ? y : key;
        }
        if (live && part == 0 && key != kNone) {
            const int r = p0 + j - lo;               // row of the part
            const int own = r / fc;
            cluster.map_shared_rank(s_key, own)[rank * fc + r - own * fc] =
                key;
        }
    }

    // every key is in its owner's slots; no CTA reads a peer after this
    cluster.sync();
    for (int i = tid; i < fc; i += kThreads) {
        const int r = lo + rank * fc + i;
        if (r >= hi) break;
        unsigned long long key = kNone;
#pragma unroll
        for (int p = 0; p < C; ++p)
            key = s_key[p * fc + i] < key ? s_key[p * fc + i] : key;
        const long long o =
            (long long)b * F + (qmask != nullptr ? s_q[r] : r);
        dist[o] = key == kNone ? kNoMatch : (long long)(key >> 32);
        idx[o] = key == kNone ? 0 : (long long)(key & 0xFFFFFFFFu);
    }
}

using Kernel = void (*)(const long long*, const long long*,
                       const unsigned char*, const unsigned char*,
                       long long*, long long*, int, int, int);
// the kernel for clusters of C CTAs at [C - 1]
constexpr Kernel kKernels[kMaxCluster] = {
    hamming_nn_kernel<1>, hamming_nn_kernel<2>, hamming_nn_kernel<3>,
    hamming_nn_kernel<4>, hamming_nn_kernel<5>, hamming_nn_kernel<6>,
    hamming_nn_kernel<7>, hamming_nn_kernel<8>};

// The launch's shape for B sequences of F rows: C CTAs a cluster and G
// clusters a sequence. C gives the fewest waves of B clusters for the
// least work a CTA (waves / C the least, ties to the larger C, which
// reads the mask fewer times), from how many clusters of each size the
// card holds at once; then G parts of the rows, kMinRows at least each,
// fill what one wave leaves.
cudaError_t choose_shape(int B, int F, int* C, int* G) {
    constexpr int kDevices = 64;
    static int cap[kDevices][kMaxCluster + 1];   // clusters at once
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    if (dev >= kDevices) return cudaErrorInvalidDevice;
    for (int c = 1; c <= kMaxCluster; ++c) {
        if (cap[dev][c] > 0) continue;
        cudaLaunchConfig_t cfg = {};
        cfg.gridDim = dim3(c * 64);
        cfg.blockDim = dim3(kThreads);
        cudaLaunchAttribute a[1];
        a[0].id = cudaLaunchAttributeClusterDimension;
        a[0].val.clusterDim.x = c;
        a[0].val.clusterDim.y = a[0].val.clusterDim.z = 1;
        cfg.attrs = a;
        cfg.numAttrs = 1;
        int n = 0;
        e = cudaOccupancyMaxActiveClusters(&n, (void*)kKernels[c - 1],
                                           &cfg);
        if (e != cudaSuccess) return e;
        cap[dev][c] = n > 0 ? n : 1;
    }
    int best_c = kMaxCluster;
    long long best_waves = (B + cap[dev][best_c] - 1) / cap[dev][best_c];
    for (int c = kMaxCluster - 1; c >= 1; --c) {
        const long long waves = (B + cap[dev][c] - 1) / cap[dev][c];
        if (waves * best_c < best_waves * c) best_c = c, best_waves = waves;
    }
    *C = best_c;
    *G = max(1, min(cap[dev][best_c] / B, (F + kMinRows - 1) / kMinRows));
    return cudaSuccess;
}

}  // namespace

extern "C" {

// q (B, F, 8) int64, desc (B, M, 8) int64, valid (B, M) bool, qmask (B, F)
// bool or null; dist, idx (B, F) int64, written in full. q and desc
// 16-byte aligned, F <= kMaxF. A cluster shape the card cannot schedule
// is an error, not a retry.
int xivo_hamming_nn(const long long* q, const long long* desc,
                    const unsigned char* valid, const unsigned char* qmask,
                    long long* dist, long long* idx, int B, int F, int M,
                    void* stream) {
    if (B <= 0 || F <= 0 || M <= 0) return 0;
    if (F > kMaxF) return (int)cudaErrorInvalidValue;
    int C = 0, G = 0;
    cudaError_t e = choose_shape(B, F, &C, &G);
    if (e != cudaSuccess) return (int)e;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)(B * G * C));
    cfg.blockDim = dim3(kThreads);
    cfg.stream = (cudaStream_t)stream;
    cudaLaunchAttribute a[1];
    a[0].id = cudaLaunchAttributeClusterDimension;
    a[0].val.clusterDim.x = C;
    a[0].val.clusterDim.y = a[0].val.clusterDim.z = 1;
    cfg.attrs = a;
    cfg.numAttrs = 1;
    e = cudaLaunchKernelEx(&cfg, kKernels[C - 1], q, desc, valid, qmask,
                           dist, idx, F, M, G);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
}

}  // extern "C"
