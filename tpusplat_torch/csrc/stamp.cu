// Stage stamps: one-thread kernels that write the device clock into a ring,
// for Hopper (sm_90a). The device half of tpusplat_torch/trace.py.
//
// Replaces no TPU kernel. The JAX package reads its stage times from the
// outside (XLA's profiler); the port's steps run as CUDA graph replays, whose
// kernels a host clock sees as one block, so each stage of a captured step
// launches a stamp at its start, and the stamp is recorded into the graph
// like any other kernel: the counterpart of the reference's timestamp
// queries (src/Renderer.cpp:484-699).
//
// A stamp reads %globaltimer (ns) and takes its slot in a ring of kRing
// entries by an atomicAdd on a device-side head; the entry holds the time
// and (tag << 8) | stage, the tag naming the compiled step whose graph holds
// the stamp. The ring and its head are module globals, so a graph needs no
// buffer of its own and a replay writes where an eager launch does. Each
// stage has a kernel of its own, tpusplat_stamp_<stage>, so that the stamps
// also appear by name in a profiler's trace. Bound: launch latency; one
// 16-byte store and one atomic a stamp. A kernel starts once the one before
// it on the stream has ended, so a stamp dates the end of the stage before.
//
// tpusplat_anchor writes the clock into its own global, outside the ring,
// for pairing the host clock with the device's (trace.anchor).

#include <cuda_runtime.h>
#include <time.h>

namespace {

constexpr unsigned long long kRing = 1ull << 16;  // trace.RING

__device__ unsigned long long g_head;
__device__ ulonglong2 g_ring[kRing];
__device__ unsigned long long g_anchor;

__device__ __forceinline__ unsigned long long globaltimer() {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    return t;
}

__device__ __forceinline__ void stamp(unsigned stage, unsigned tag) {
    const unsigned long long t = globaltimer();
    const unsigned long long i = atomicAdd(&g_head, 1ull);
    g_ring[i & (kRing - 1)] = make_ulonglong2(t, (static_cast<unsigned long long>(tag) << 8) | stage);
}

}  // namespace

// The ids are the positions in trace.STAGES.
#define TPUSPLAT_STAMP(name, id) \
    extern "C" __global__ void tpusplat_stamp_##name(unsigned tag) { stamp(id, tag); }
TPUSPLAT_STAMP(preprocess, 0)
TPUSPLAT_STAMP(binning, 1)
TPUSPLAT_STAMP(blend, 2)
TPUSPLAT_STAMP(loss, 3)
TPUSPLAT_STAMP(blend_bwd, 4)
TPUSPLAT_STAMP(preprocess_bwd, 5)
TPUSPLAT_STAMP(adam, 6)
TPUSPLAT_STAMP(writeback, 7)
TPUSPLAT_STAMP(end, 8)
TPUSPLAT_STAMP(densify, 9)
TPUSPLAT_STAMP(regularize, 10)
TPUSPLAT_STAMP(regularize_bwd, 11)
#undef TPUSPLAT_STAMP

extern "C" __global__ void tpusplat_anchor() { g_anchor = globaltimer(); }

namespace {

using StampKernel = void (*)(unsigned);
const StampKernel kStamps[] = {
    tpusplat_stamp_preprocess, tpusplat_stamp_binning,        tpusplat_stamp_blend,
    tpusplat_stamp_loss,       tpusplat_stamp_blend_bwd,      tpusplat_stamp_preprocess_bwd,
    tpusplat_stamp_adam,       tpusplat_stamp_writeback,      tpusplat_stamp_end,
    tpusplat_stamp_densify,    tpusplat_stamp_regularize,     tpusplat_stamp_regularize_bwd,
};
constexpr int kStages = sizeof(kStamps) / sizeof(kStamps[0]);

}  // namespace

// Loads every kernel of the module now (CUDA loads a module's kernels lazily,
// at their first launch, which must not fall inside a graph capture).
extern "C" int tpusplat_trace_load() {
    cudaFuncAttributes attr;
    for (StampKernel k : kStamps) {
        const cudaError_t err = cudaFuncGetAttributes(&attr, k);
        if (err != cudaSuccess) return err;
    }
    return cudaFuncGetAttributes(&attr, tpusplat_anchor);
}

extern "C" int tpusplat_trace_stamp(int stage, unsigned tag, void* stream) {
    if (stage < 0 || stage >= kStages) return cudaErrorInvalidValue;
    kStamps[stage]<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(tag);
    return cudaGetLastError();
}

// Copies the head and the whole ring [kRing, 2] to the host. The caller has
// synchronised the device.
extern "C" int tpusplat_trace_read(void* ring, unsigned long long* head) {
    cudaError_t err = cudaMemcpyFromSymbol(head, g_head, sizeof(unsigned long long));
    if (err != cudaSuccess) return err;
    return cudaMemcpyFromSymbol(ring, g_ring, sizeof(g_ring));
}

// One pairing of the clocks: CLOCK_MONOTONIC (Python's perf_counter_ns)
// just before an anchor kernel's launch, and the device clock as it ran.
extern "C" int tpusplat_trace_anchor(void* stream, unsigned long long* host_ns,
                                     unsigned long long* device_ns) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t err = cudaStreamSynchronize(s);
    if (err != cudaSuccess) return err;
    timespec ts;
    clock_gettime(CLOCK_MONOTONIC, &ts);
    tpusplat_anchor<<<1, 1, 0, s>>>();
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    err = cudaStreamSynchronize(s);
    if (err != cudaSuccess) return err;
    *host_ns = static_cast<unsigned long long>(ts.tv_sec) * 1000000000ull + ts.tv_nsec;
    return cudaMemcpyFromSymbol(device_ns, g_anchor, sizeof(unsigned long long));
}
