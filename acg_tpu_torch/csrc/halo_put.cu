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
// the same card, so the puts of all shards are the blocks of ONE launch:
// block (q, p) copies q's window for p into p's row q.  Stream order
// gives the barrier (the previous pack and unpack finished before the
// launch, the next ones start after it) and the send/receive waits (the
// launch completes), so no flags are needed.  Rows that no block writes
// (the diagonal, and pairs the gate skips) keep what the receive plane
// held; the unpack masks padding ghost slots, as on the TPU.
//
// Like every TPU put, each block moves all maxcnt elements of its window
// (windows are padded to the largest neighbour count, halo_dma.py:22-25).
//
// Bound on an H100: memory, 2 * maxcnt * itemsize bytes per gated pair
// (read the window once, write it once); for the flagship's band halo
// (2,048 values per neighbour) that is well under a microsecond, so the
// launch itself dominates.  Copies are by element, templated on the
// element size (8/4/2 bytes: f64, f32, bf16 vectors), one thread per
// element, coalesced along the window.
#include "common.cuh"

#include <cstdint>

namespace {

template <typename T>
__global__ void __launch_bounds__(kBlock)
halo_put_kernel(const T* __restrict__ send,
                const int* __restrict__ send_counts, int nparts,
                long long maxcnt, int gate, T* __restrict__ recv) {
  const int src = blockIdx.x;
  const int dst = blockIdx.y;
  if (src == dst) return;
  if (gate && send_counts[src * nparts + dst] <= 0) return;
  const T* from = send + (static_cast<long long>(src) * nparts + dst) * maxcnt;
  T* to = recv + (static_cast<long long>(dst) * nparts + src) * maxcnt;
  for (long long k = threadIdx.x; k < maxcnt; k += blockDim.x) {
    to[k] = from[k];
  }
}

template <typename T>
int launch(const void* send, const void* send_counts, int nparts,
           long long maxcnt, int gate, void* recv, cudaStream_t s) {
  const dim3 grid(static_cast<unsigned int>(nparts),
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
