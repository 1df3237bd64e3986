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
//
// The cross-process form (acg_halo_put_peer / acg_halo_wait_peer below)
// replaces the same TPU kernel where the parts live in several
// processes, one per card (or several sharing one card).  Each rank
// allocates its receive planes, flags and acks with cudaMalloc
// (acg_ipc_alloc: its own allocation, so the IPC handle carries no
// offset inside a caching allocator's block) and maps every peer's
// allocation through CUDA IPC; the same code serves two processes on
// one card and ranks on NVLink-connected cards.  The put follows aCG's
// device-initiated put, wait and signal (cg-kernels-cuda.cu:713-776):
//   put   one launch per exchange, grid (window chunk, local src part,
//         dst part); a block copies its chunk of the window straight
//         into the owner's receive plane, fences at system scope and
//         counts itself on a per-pair counter; the pair's last block
//         stores the exchange's sequence number into the owner's
//         flag[dst, src] with st.release.sys.
//   wait  a small launch of its own after the put: first it releases
//         the acks of the previous exchange (ack[src, dst] = seq - 1 in
//         the sender's memory: the unpack of that exchange came before
//         it on this stream), then it spins, with __nanosleep backoff
//         and a bound on the elapsed %globaltimer, until (a) every
//         gated sender's flag has reached seq (ld.acquire.sys) and (b)
//         every gated receiver has acked seq - 1.  Past the bound it
//         writes an error word in mapped host memory, which the
//         wrapper raises on; nothing hangs.
// Two receive planes alternate by the sequence number's parity, and (b)
// makes the reuse explicit: put seq + 1 writes the plane of exchange
// seq - 1 only after every receiver has unpacked that exchange.  Flags
// and acks carry sequence numbers, so nothing is reset between
// exchanges.  The wait is not a spin inside the put: two processes on
// one H100 time-slice their contexts, and a put that spun would hold
// the card while its peer's put waited to run.
#include "common.cuh"

#include <cstdint>

namespace {

constexpr int kChunk = 16384;           // bytes of a window per block
constexpr int kUnroll = kChunk / 16 / kBlock;   // uint4 per thread: 4

// block blockIdx.x's chunk of one pair's window: maxcnt elements from
// `from` to `to` (no early return: callers synchronise after it)
template <typename T>
__device__ __forceinline__ void copy_window(const T* __restrict__ from,
                                            T* __restrict__ to,
                                            long long maxcnt) {
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
__global__ void __launch_bounds__(kBlock)
halo_put_kernel(const T* __restrict__ send,
                const int* __restrict__ send_counts, int nparts,
                long long maxcnt, int gate, T* __restrict__ recv) {
  const int src = blockIdx.y;
  const int dst = blockIdx.z;
  if (src == dst) return;
  if (gate && send_counts[src * nparts + dst] <= 0) return;
  copy_window<T>(send + (static_cast<long long>(src) * nparts + dst) * maxcnt,
                 recv + (static_cast<long long>(dst) * nparts + src) * maxcnt,
                 maxcnt);
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

// -- K6 across processes -------------------------------------------------

namespace {

__device__ __forceinline__ void st_release_sys(unsigned int* p,
                                               unsigned int v) {
  asm volatile("st.release.sys.global.u32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

__device__ __forceinline__ unsigned int ld_acquire_sys(
    const unsigned int* p) {
  unsigned int v;
  asm volatile("ld.acquire.sys.global.u32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ bool gated(const int* counts, int nparts, int q,
                                      int p, int gate) {
  return q != p && (!gate || counts[q * nparts + p] > 0);
}

// tab (4 * nparts int64, on the device): [parity * nparts + p] is the
// address of part p's rows in its owner's receive plane `parity` (p's
// plane row block, (nparts, maxcnt) elements), [2 * nparts + p] of p's
// flag row in its owner's memory (nparts uint32, one per source part),
// [3 * nparts + q] of q's ack row in its owner's memory (nparts uint32,
// one per destination part).  Own parts point at this rank's allocation.
template <typename T>
__global__ void __launch_bounds__(kBlock)
halo_put_peer_kernel(const T* __restrict__ send,
                     const int* __restrict__ counts, int nparts, int lo,
                     long long maxcnt, int gate,
                     const long long* __restrict__ tab, int parity,
                     unsigned int seq, unsigned long long* __restrict__ done,
                     unsigned long long nchunks) {
  const int i = blockIdx.y;          // local source part
  const int q = lo + i;
  const int p = blockIdx.z;          // destination part
  if (!gated(counts, nparts, q, p, gate)) return;
  T* to = reinterpret_cast<T*>(tab[parity * nparts + p]) +
          static_cast<long long>(q) * maxcnt;
  copy_window<T>(send + (static_cast<long long>(i) * nparts + p) * maxcnt,
                 to, maxcnt);
  __threadfence_system();
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned long long old =
        atomicAdd(done + static_cast<long long>(i) * nparts + p, 1ull);
    if (old + 1 == static_cast<unsigned long long>(seq) * nchunks) {
      __threadfence_system();
      st_release_sys(reinterpret_cast<unsigned int*>(tab[2 * nparts + p]) + q,
                     seq);
    }
  }
}

__global__ void __launch_bounds__(kBlock)
halo_wait_peer_kernel(const int* __restrict__ counts, int nparts, int lo,
                      int nlocal, int gate,
                      const long long* __restrict__ tab,
                      const unsigned int* own_flags,
                      const unsigned int* own_acks, unsigned int seq,
                      long long timeout_ns, volatile int* err) {
  const int npairs = nlocal * nparts;
  // release the acks of exchange seq - 1: its unpack ran before this
  // launch on this stream, so its receive plane may be written again
  if (seq > 1) {
    for (int k = threadIdx.x; k < npairs; k += blockDim.x) {
      const int p = lo + k / nparts, q = k % nparts;
      if (gated(counts, nparts, q, p, gate))
        st_release_sys(reinterpret_cast<unsigned int*>(tab[3 * nparts + q]) +
                           p,
                       seq - 1);
    }
  }
  __syncthreads();
  const unsigned long long t0 = global_ns();
  for (int k = threadIdx.x; k < 2 * npairs; k += blockDim.x) {
    const int kk = k % npairs, i = kk / nparts, o = kk % nparts;
    const unsigned int* addr;
    unsigned int target;
    if (k < npairs) {       // the flag of source o into local part i
      if (!gated(counts, nparts, o, lo + i, gate)) continue;
      addr = own_flags + kk;
      target = seq;
    } else {                // the ack of destination o for local part i
      if (seq < 2 || !gated(counts, nparts, lo + i, o, gate)) continue;
      addr = own_acks + kk;
      target = seq - 1;
    }
    unsigned int sleep = 32;
    while (ld_acquire_sys(addr) < target) {
      if (static_cast<long long>(global_ns() - t0) > timeout_ns) {
        *err = k < npairs ? 1 : 2;
        __threadfence_system();
        break;
      }
      __nanosleep(sleep);
      if (sleep < 2048) sleep *= 2;
    }
  }
}

template <typename T>
int launch_peer(const void* send, const void* counts, int nparts, int lo,
                int nlocal, long long maxcnt, int gate, const void* tab,
                int parity, unsigned int seq, void* done, cudaStream_t s) {
  const long long bytes = maxcnt * static_cast<long long>(sizeof(T));
  const long long nchunks = (bytes + kChunk - 1) / kChunk;
  if (nchunks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned int>(nchunks),
                  static_cast<unsigned int>(nlocal),
                  static_cast<unsigned int>(nparts));
  halo_put_peer_kernel<T><<<grid, kBlock, 0, s>>>(
      static_cast<const T*>(send), static_cast<const int*>(counts), nparts,
      lo, maxcnt, gate, static_cast<const long long*>(tab), parity, seq,
      static_cast<unsigned long long*>(done),
      static_cast<unsigned long long>(nchunks));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The put of exchange `seq` (>= 1) into receive plane seq % 2 (`parity`):
// send (nlocal, nparts, maxcnt) holds this rank's parts lo .. lo + nlocal
// - 1; counts (nparts, nparts) int32 on the device; tab as above; done
// (nlocal * nparts) uint64 per-pair block counters, zero at the first
// exchange.  Returns cudaGetLastError().
extern "C" int acg_halo_put_peer(int itemsize, const void* send,
                                 const void* counts, int nparts, int lo,
                                 int nlocal, long long maxcnt, int gate,
                                 const void* tab, int parity,
                                 unsigned int seq, void* done, void* stream) {
  if (nparts <= 1 || nlocal <= 0 || maxcnt <= 0) return 0;
  if (nparts > 65535 || nlocal > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (itemsize == 8)
    return launch_peer<uint64_t>(send, counts, nparts, lo, nlocal, maxcnt,
                                 gate, tab, parity, seq, done, s);
  if (itemsize == 4)
    return launch_peer<uint32_t>(send, counts, nparts, lo, nlocal, maxcnt,
                                 gate, tab, parity, seq, done, s);
  if (itemsize == 2)
    return launch_peer<uint16_t>(send, counts, nparts, lo, nlocal, maxcnt,
                                 gate, tab, parity, seq, done, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The wait of exchange `seq`: one block; own_flags (nlocal, nparts) and
// own_acks (nlocal, nparts) uint32 in this rank's allocation; err a
// device-visible int in mapped host memory (0 = fine, 1 = a flag, 2 = an
// ack did not arrive within timeout_ns).
extern "C" int acg_halo_wait_peer(const void* counts, int nparts, int lo,
                                  int nlocal, int gate, const void* tab,
                                  const void* own_flags, const void* own_acks,
                                  unsigned int seq, long long timeout_ns,
                                  void* err, void* stream) {
  if (nparts <= 1 || nlocal <= 0) return 0;
  halo_wait_peer_kernel<<<1, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(counts), nparts, lo, nlocal, gate,
      static_cast<const long long*>(tab),
      static_cast<const unsigned int*>(own_flags),
      static_cast<const unsigned int*>(own_acks), seq, timeout_ns,
      static_cast<volatile int*>(err));
  return static_cast<int>(cudaGetLastError());
}

// -- the IPC allocation of the cross-process form -------------------------
// Each returns a cudaError_t as int.

// `bytes` of device memory on `device`, zeroed and synchronised (peers
// may read it as soon as its handle is out).
extern "C" int acg_ipc_alloc(int device, long long bytes, void** ptr) {
  cudaError_t e = cudaSetDevice(device);
  if (e == cudaSuccess) e = cudaMalloc(ptr, static_cast<size_t>(bytes));
  if (e == cudaSuccess) e = cudaMemset(*ptr, 0, static_cast<size_t>(bytes));
  if (e == cudaSuccess) e = cudaDeviceSynchronize();
  return static_cast<int>(e);
}

// the 64-byte cudaIpcMemHandle_t of an acg_ipc_alloc pointer into `out`
extern "C" int acg_ipc_handle(void* ptr, void* out) {
  cudaIpcMemHandle_t h;
  const cudaError_t e = cudaIpcGetMemHandle(&h, ptr);
  if (e == cudaSuccess) memcpy(out, &h, sizeof(h));
  return static_cast<int>(e);
}

// map a PEER's handle (never this process's own: CUDA refuses it)
extern "C" int acg_ipc_open(int device, const void* handle, void** ptr) {
  cudaIpcMemHandle_t h;
  memcpy(&h, handle, sizeof(h));
  cudaError_t e = cudaSetDevice(device);
  if (e == cudaSuccess)
    e = cudaIpcOpenMemHandle(ptr, h, cudaIpcMemLazyEnablePeerAccess);
  return static_cast<int>(e);
}

extern "C" int acg_ipc_close(void* ptr) {
  return static_cast<int>(cudaIpcCloseMemHandle(ptr));
}

extern "C" int acg_ipc_free(void* ptr) {
  return static_cast<int>(cudaFree(ptr));
}

// one int of mapped pinned host memory, zeroed: *host for the CPU,
// *dev for kernels
extern "C" int acg_ipc_host_word(void** host, void** dev) {
  cudaError_t e = cudaHostAlloc(host, sizeof(int),
                                cudaHostAllocMapped | cudaHostAllocPortable);
  if (e != cudaSuccess) return static_cast<int>(e);
  *static_cast<volatile int*>(*host) = 0;
  return static_cast<int>(cudaHostGetDevicePointer(dev, *host, 0));
}

extern "C" int acg_ipc_host_free(void* host) {
  return static_cast<int>(cudaFreeHost(host));
}

extern "C" int acg_ipc_handle_size() {
  return static_cast<int>(sizeof(cudaIpcMemHandle_t));
}
