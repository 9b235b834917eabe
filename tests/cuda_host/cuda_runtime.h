// Stand-in for the CUDA runtime header, so that a kernel header of
// proof_systems_tpu_torch/csrc compiles with a host C++20 compiler: the
// CUDA qualifiers are defined away, and one warp (or one block) is emulated
// by host threads whose shuffles and barriers (__shfl_sync, __shfl_up_sync,
// __syncwarp, __syncthreads) meet at a std::barrier of all of them. The
// code under test must reach every shuffle and barrier in all threads, as
// the full mask requires on the card; a thread that skips one deadlocks
// here. A shuffle of width w reads within the thread's segment of w.
#pragma once

#include <barrier>
#include <cstdint>
#include <cstdlib>

#define __device__
#define __host__
#define __global__
#define __forceinline__ inline
#define __noinline__
#define __launch_bounds__(...)
#define __restrict__

struct HostWarp {
    explicit HostWarp(int threads = 32) : bar(threads) {}
    std::barrier<> bar;
    uint32_t slot[1024];
};

extern HostWarp *host_warp;
extern thread_local int host_lane;

inline uint32_t __shfl_sync(unsigned mask, uint32_t v, int src, int width = 32) {
    if (mask != 0xffffffffu) std::abort();
    host_warp->slot[host_lane] = v;
    host_warp->bar.arrive_and_wait();
    const uint32_t r = host_warp->slot[(host_lane & ~(width - 1)) + (src & (width - 1))];
    host_warp->bar.arrive_and_wait();
    return r;
}

inline uint32_t __shfl_up_sync(unsigned mask, uint32_t v, unsigned d, int width = 32) {
    if (mask != 0xffffffffu) std::abort();
    host_warp->slot[host_lane] = v;
    host_warp->bar.arrive_and_wait();
    const int src = host_lane - (int)d;
    const uint32_t r = src >= (host_lane & ~(width - 1)) ? host_warp->slot[src] : v;
    host_warp->bar.arrive_and_wait();
    return r;
}

inline void __syncwarp(unsigned mask = 0xffffffffu) {
    if (mask != 0xffffffffu) std::abort();
    host_warp->bar.arrive_and_wait();
}

inline void __syncthreads() { host_warp->bar.arrive_and_wait(); }
