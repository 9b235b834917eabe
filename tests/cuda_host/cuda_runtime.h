// Stand-in for the CUDA runtime header, so that a kernel header of
// proof_systems_tpu_torch/csrc compiles with a host C++20 compiler: the
// CUDA qualifiers are defined away, and one warp is emulated by 32 host
// threads whose __shfl_sync calls meet at a std::barrier. The code under
// test must reach every shuffle in all 32 lanes, as the full mask requires
// on the card; a lane that skips one deadlocks here.
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
    std::barrier<> bar{32};
    uint32_t slot[32];
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
