// K6: the one-sided halo exchange of the multi-part solver, stacked on
// one card:
//   recv[p, q, :] = send[q, p, :]   for every pair q != p whose sender
//                                   has a window for p (send_counts[q, p]
//                                   > 0), or every pair with gating off.
//
// Replaces acg_tpu/parallel/halo_dma.py: _exchange_kernel (:158), the
// pallas_call of _exchange (:248).  On the TPU each shard starts one
// remote put per neighbour into row `me` of the peer's receive plane and
// waits on DMA semaphores, after a neighbourhood barrier.  Here every
// part lives in one (P, P, maxcnt) send plane and one receive plane on
// the same card, so the puts of all shards are the blocks of ONE launch.
// Stream order gives the barrier (the previous pack and unpack finished
// before the launch, the next ones start after it) and the send/receive
// waits (the launch completes), so no flags are needed.  Rows that no
// block writes (the diagonal, and pairs the gate skips) keep what the
// receive plane held; the unpack masks padding ghost slots, as on the
// TPU.  Like every TPU put, each pair moves all maxcnt elements of its
// window (windows are padded to the largest neighbour count,
// halo_dma.py:22-25).
//
// Bound on an H100: memory, 2 * maxcnt * itemsize bytes per gated pair
// (read the window once, write it once).  The design spreads that copy
// over the card: the grid is (chunk of the window, src, dst), each block
// moving kChunk bytes of one pair's window, so a 0.5 MB window (path
// (h)'s irregular plan) is 32 blocks instead of one block walking it in
// 250 dependent steps.  A block of a skipped pair (the diagonal, or a
// zero count under gating) exits at its first instruction; gating stays
// on the device, so the host never reads the counts.  Every thread
// writes four 16-byte destination vectors from loads all in flight
// together, with a scalar head and tail of under 16 bytes.  Where the
// source window sits at another byte phase mod 16 than the destination
// (maxcnt * itemsize not a multiple of 16: bf16 and f32 windows of odd
// length, path (h)'s f64 windows between parts of unequal parity), each
// destination vector is funnel-shifted out of the two aligned source
// vectors around it (the second one is the next lane's first, from
// L1), so every load and store stays 16 bytes wide.
#include "common.cuh"

#include <cstdint>

namespace {

constexpr int kChunk = 16384;           // bytes of a window per block
constexpr int kUnroll = kChunk / 16 / kBlock;   // uint4 per thread: 4

template <typename T>
__global__ void __launch_bounds__(kBlock)
halo_put_kernel(const T* __restrict__ send,
                const int* __restrict__ send_counts, int nparts,
                long long maxcnt, int gate, T* __restrict__ recv) {
  const int src = blockIdx.y;
  const int dst = blockIdx.z;
  if (src == dst) return;
  if (gate && send_counts[src * nparts + dst] <= 0) return;
  const T* from = send + (static_cast<long long>(src) * nparts + dst) * maxcnt;
  T* to = recv + (static_cast<long long>(dst) * nparts + src) * maxcnt;
  // a scalar head up to the destination's first 16-byte boundary, whole
  // 16-byte destination vectors, a scalar tail; the head and tail (whole
  // elements: the phases are multiples of sizeof(T)) belong to chunk 0
  const int tphase = static_cast<int>(reinterpret_cast<uintptr_t>(to) & 15);
  const int fphase = static_cast<int>(reinterpret_cast<uintptr_t>(from) & 15);
  const long long bytes = maxcnt * static_cast<long long>(sizeof(T));
  const long long head =
      tphase ? min(static_cast<long long>(16 - tphase), bytes) : 0;
  const long long nvec = (bytes - head) / 16;
  const long long tail0 = head + nvec * 16;
  if (blockIdx.x == 0) {
    const int nh = static_cast<int>(head / sizeof(T));
    const int nt = static_cast<int>((bytes - tail0) / sizeof(T));
    const long long t0 = tail0 / static_cast<long long>(sizeof(T));
    if (threadIdx.x < nh) to[threadIdx.x] = __ldg(from + threadIdx.x);
    if (threadIdx.x < nt) to[t0 + threadIdx.x] = __ldg(from + t0 + threadIdx.x);
  }
  uint4* vt = reinterpret_cast<uint4*>(reinterpret_cast<char*>(to) + head);
  const long long v0 = static_cast<long long>(blockIdx.x) * (kChunk / 16) +
                       threadIdx.x;
  // the source bytes of destination vector v start `delta` bytes into
  // the source's 16-byte vector vf[v] (and run into vf[v + 1])
  const int delta = (fphase + static_cast<int>(head)) & 15;
  const uint4* vf = reinterpret_cast<const uint4*>(
      reinterpret_cast<const char*>(from) + head - delta);
  uint4 buf[kUnroll];
  if (delta == 0) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long v = v0 + u * kBlock;
      if (v < nvec) buf[u] = __ldg(vf + v);
    }
  } else {
    uint4 nxt[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long v = v0 + u * kBlock;
      if (v < nvec) {
        buf[u] = __ldg(vf + v);
        nxt[u] = __ldg(vf + v + 1);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) buf[u] = shift16(buf[u], nxt[u], delta);
  }
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const long long v = v0 + u * kBlock;
    if (v < nvec) vt[v] = buf[u];
  }
}

template <typename T>
int launch(const void* send, const void* send_counts, int nparts,
           long long maxcnt, int gate, void* recv, cudaStream_t s) {
  const long long bytes = maxcnt * static_cast<long long>(sizeof(T));
  const long long nchunks = (bytes + kChunk - 1) / kChunk;
  if (nchunks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned int>(nchunks),
                  static_cast<unsigned int>(nparts),
                  static_cast<unsigned int>(nparts));
  halo_put_kernel<T><<<grid, kBlock, 0, s>>>(
      static_cast<const T*>(send), static_cast<const int*>(send_counts),
      nparts, maxcnt, gate, static_cast<T*>(recv));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// send, recv: (nparts, nparts, maxcnt) contiguous planes of `itemsize`-
// byte elements (8, 4 or 2); send_counts: (nparts, nparts) int32 on the
// device, send_counts[q, p] = values part q sends to part p.  gate != 0
// copies only the pairs with a positive count.  Launches on `stream`,
// allocates nothing, returns cudaGetLastError().
extern "C" int acg_halo_put(int itemsize, const void* send,
                            const void* send_counts, int nparts,
                            long long maxcnt, int gate, void* recv,
                            void* stream) {
  if (nparts <= 1 || maxcnt <= 0) return 0;
  if (nparts > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (itemsize == 8)
    return launch<uint64_t>(send, send_counts, nparts, maxcnt, gate, recv, s);
  if (itemsize == 4)
    return launch<uint32_t>(send, send_counts, nparts, maxcnt, gate, recv, s);
  if (itemsize == 2)
    return launch<uint16_t>(send, send_counts, nparts, maxcnt, gate, recv, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
