// Stand-in for the CUDA runtime header, so that a kernel header of
// proof_systems_tpu_torch/csrc compiles with a host C++20 compiler: the
// CUDA qualifiers are defined away, and one block of up to 1,024 threads
// (one warp, or several) is emulated by host threads: host_lane is the
// thread's index in the block. Shuffles and __syncwarp meet at a
// std::barrier of the thread's warp (threads 32w .. 32w + 31), and
// __syncthreads at one of the whole block. The code under test must reach
// every shuffle and barrier in all threads of the warp (or block), as the
// full mask requires on the card; a thread that skips one deadlocks here.
// A shuffle of width w reads within the thread's segment of w.
#pragma once

#include <algorithm>
#include <barrier>
#include <cstdint>
#include <cstdlib>
#include <memory>
#include <vector>

#define __device__
#define __host__
#define __global__
#define __forceinline__ inline
#define __noinline__
#define __launch_bounds__(...)
#define __restrict__

struct HostWarp {
    explicit HostWarp(int threads = 32) : bar(threads) {
        for (int w = 0; 32 * w < threads; ++w)
            warps.push_back(std::make_unique<std::barrier<>>(std::min(32, threads - 32 * w)));
    }
    std::barrier<> bar;                                   // the block's
    std::vector<std::unique_ptr<std::barrier<>>> warps;  // each warp's
    uint32_t slot[1024];
};

extern HostWarp *host_warp;
extern thread_local int host_lane;

inline void host_warp_wait() { host_warp->warps[host_lane / 32]->arrive_and_wait(); }

inline uint32_t __shfl_sync(unsigned mask, uint32_t v, int src, int width = 32) {
    if (mask != 0xffffffffu) std::abort();
    host_warp->slot[host_lane] = v;
    host_warp_wait();
    const uint32_t r = host_warp->slot[(host_lane & ~(width - 1)) + (src & (width - 1))];
    host_warp_wait();
    return r;
}

inline uint32_t __shfl_up_sync(unsigned mask, uint32_t v, unsigned d, int width = 32) {
    if (mask != 0xffffffffu) std::abort();
    host_warp->slot[host_lane] = v;
    host_warp_wait();
    const int src = host_lane - (int)d;
    const uint32_t r = src >= (host_lane & ~(width - 1)) ? host_warp->slot[src] : v;
    host_warp_wait();
    return r;
}

inline void __syncwarp(unsigned mask = 0xffffffffu) {
    if (mask != 0xffffffffu) std::abort();
    host_warp_wait();
}

inline void __syncthreads() { host_warp->bar.arrive_and_wait(); }

// Leading zero bits of a 32-bit word (32 for 0), as the CUDA intrinsic.
inline int __clz(int x) { return x ? __builtin_clz((unsigned)x) : 32; }
