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
// The cross-process form (acg_halo_put_peer and acg_memops below)
// replaces the same TPU kernel where the parts live in several
// processes, one per card (or several sharing one card).  Each rank
// allocates its receive planes, flags and acks with cudaMalloc
// (acg_ipc_alloc: its own allocation, so the IPC handle carries no
// offset inside a caching allocator's block) and maps every peer's
// allocation through CUDA IPC; the same code serves two processes on
// one card and ranks on NVLink-connected cards.  The bytes move as aCG's
// device-initiated put does (cg-kernels-cuda.cu:713-776): one launch per
// exchange, grid (window chunk, local src part, dst part), each block
// copying its chunk of a window straight into the owner's receive plane
// with copy_window above.  The synchronisation runs off the SMs, as
// aCG's host-initiated NVSHMEM halo does it (nvshmemx_*_put_signal_on_
// stream and signal_wait_until_on_stream, acg/halo.cu:181-242): stream
// memory operations that the card's front end executes in stream order.
// Exchange seq on a rank's stream is
//   1. write seq - 1 into the ack word of every gated sender on another
//      rank (the unpack of exchange seq - 1 came before on this stream),
//   2. wait until the ack of every gated receiver on another rank is
//      >= seq - 2 (the last reader of the plane about to be written),
//   3. the put kernel, which only copies,
//   4. write seq into the flag word of every gated receiver on another
//      rank (a write-value operation with its default memory barrier:
//      the put's stores are visible before the flag is),
//   5. wait until the flag of every gated sender on another rank is
//      >= seq (a wait-value operation, GEQ, with FLUSH where the device
//      can flush remote writes).
// Each run of writes or of waits is one cuStreamBatchMemOp (acg_memops
// below).  Pairs within one rank need no word at all: their put and
// unpack share the stream.
// Two receive planes alternate by the sequence number's parity and 2
// makes their reuse explicit, so one-way gating is safe; flags and
// acks carry sequence numbers, so nothing is reset between exchanges.
// The schedule (which words, which values) is built on the host
// (parallel/halo_dma.py: peer_schedule) and passed as address lists.
//
// Bound on an H100: not the bytes (the flagship's band plan moves 98 KB,
// well under a microsecond of copy), but the signal's round trip.  On
// separate cards that is a flag's latency across NVLink; on one card
// shared by two processes it is a switch between the two contexts,
// which time-slice the card.  A wait in the front end holds no SM, and
// a stream blocked on it lets the card run the peer's context, where a
// spinning wait kernel (this kernel's first form) kept the card for its
// time slice while the peer's put waited to run: 1.21 ms an exchange
// on one H100 shared by two processes, against 0.17-0.33 ms now and a
// one-flag ping-pong between the two contexts of 0.15 ms
// (scripts/torch_k6_peer_ab.py).  The copy keeps copy_window's design:
// the put takes 6-7 us of the exchange.
#include "common.cuh"

#include <cuda.h>

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

// tab (2 * nparts int64, on the device): [parity * nparts + p] is the
// address of part p's rows in its owner's receive plane `parity` (p's
// plane row block, (nparts, maxcnt) elements); own parts point at this
// rank's allocation.
template <typename T>
__global__ void __launch_bounds__(kBlock)
halo_put_peer_kernel(const T* __restrict__ send,
                     const int* __restrict__ counts, int nparts, int lo,
                     long long maxcnt, int gate,
                     const long long* __restrict__ tab, int parity) {
  const int i = blockIdx.y;          // local source part
  const int q = lo + i;
  const int p = blockIdx.z;          // destination part
  if (q == p || (gate && counts[q * nparts + p] <= 0)) return;
  T* to = reinterpret_cast<T*>(tab[parity * nparts + p]) +
          static_cast<long long>(q) * maxcnt;
  copy_window<T>(send + (static_cast<long long>(i) * nparts + p) * maxcnt,
                 to, maxcnt);
}

template <typename T>
int launch_peer(const void* send, const void* counts, int nparts, int lo,
                int nlocal, long long maxcnt, int gate, const void* tab,
                int parity, cudaStream_t s) {
  const long long bytes = maxcnt * static_cast<long long>(sizeof(T));
  const long long nchunks = (bytes + kChunk - 1) / kChunk;
  if (nchunks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned int>(nchunks),
                  static_cast<unsigned int>(nlocal),
                  static_cast<unsigned int>(nparts));
  halo_put_peer_kernel<T><<<grid, kBlock, 0, s>>>(
      static_cast<const T*>(send), static_cast<const int*>(counts), nparts,
      lo, maxcnt, gate, static_cast<const long long*>(tab), parity);
  return static_cast<int>(cudaGetLastError());
}

// libcuda's stream memory operations, reached through the runtime's
// entry-point query (the library links no libcuda).  Every run of them
// goes in one cuStreamBatchMemOp, a lone operation too, so one entry
// point serves every case: on an H100 an operation costs the card under
// 1 us in a batch of 100 and a lone call from Python 3-4 us, set by the
// host's call (scripts/torch_k6_peer_ab.py).
using BatchMemOpFn = CUresult (*)(CUstream, unsigned int,
                                  CUstreamBatchMemOpParams*, unsigned int);
BatchMemOpFn g_batch_mem_op = nullptr;

constexpr int kBatch = 128;   // operations a cuStreamBatchMemOp (< 256)

cudaError_t cu_entry(const char* name, void** fn) {
  cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
  cudaError_t e = cudaGetDriverEntryPointByVersion(name, fn, 12000,
                                                   cudaEnableDefault, &q);
#else
  cudaError_t e = cudaGetDriverEntryPoint(name, fn, cudaEnableDefault, &q);
#endif
  if (e == cudaSuccess &&
      (q != cudaDriverEntryPointSuccess || *fn == nullptr))
    e = cudaErrorSymbolNotFound;
  return e;
}

}  // namespace

// The put of exchange seq into receive plane seq % 2 (`parity`): send
// (nlocal, nparts, maxcnt) holds this rank's parts lo .. lo + nlocal - 1;
// counts (nparts, nparts) int32 on the device; tab as above.  Only
// copies: acg_memops orders it against the peers.  Returns
// cudaGetLastError().
extern "C" int acg_halo_put_peer(int itemsize, const void* send,
                                 const void* counts, int nparts, int lo,
                                 int nlocal, long long maxcnt, int gate,
                                 const void* tab, int parity, void* stream) {
  if (nparts <= 1 || nlocal <= 0 || maxcnt <= 0) return 0;
  if (nparts > 65535 || nlocal > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (itemsize == 8)
    return launch_peer<uint64_t>(send, counts, nparts, lo, nlocal, maxcnt,
                                 gate, tab, parity, s);
  if (itemsize == 4)
    return launch_peer<uint32_t>(send, counts, nparts, lo, nlocal, maxcnt,
                                 gate, tab, parity, s);
  if (itemsize == 2)
    return launch_peer<uint16_t>(send, counts, nparts, lo, nlocal, maxcnt,
                                 gate, tab, parity, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Resolve the stream memory operations (once) and report whether
// `device` can flush remote writes after a wait (*can_flush).  Returns a
// cudaError_t: cudaErrorSymbolNotFound where libcuda lacks them.
extern "C" int acg_memops_init(int device, int* can_flush) {
  if (g_batch_mem_op == nullptr) {
    void* b = nullptr;
    const cudaError_t e = cu_entry("cuStreamBatchMemOp", &b);
    if (e != cudaSuccess) return static_cast<int>(e);
    g_batch_mem_op = reinterpret_cast<BatchMemOpFn>(b);
  }
  *can_flush = 0;
  return static_cast<int>(cudaDeviceGetAttribute(
      can_flush, cudaDevAttrCanFlushRemoteWrites, device));
}

// Enqueue n stream memory operations on `stream`, in order: op i waits
// until the 32-bit word at addr[i] is >= seq + delta[i] (wait[i] != 0,
// with wait_flags | CU_STREAM_WAIT_VALUE_GEQ) or writes seq + delta[i]
// there (with the default memory barrier before it).  A run of one kind
// goes in batches of up to kBatch; a batch never mixes writes and waits,
// so a write always precedes the waits after it.  Returns a CUresult
// (CUDA_ERROR_NOT_INITIALIZED before acg_memops_init).
extern "C" int acg_memops(int n, const unsigned long long* addr,
                          const long long* delta, const int* wait,
                          unsigned int seq, int wait_flags, void* stream) {
  if (g_batch_mem_op == nullptr)
    return static_cast<int>(CUDA_ERROR_NOT_INITIALIZED);
  CUstream s = static_cast<CUstream>(stream);
  CUstreamBatchMemOpParams ops[kBatch];
  const unsigned int wflags =
      CU_STREAM_WAIT_VALUE_GEQ | static_cast<unsigned int>(wait_flags);
  int i = 0;
  while (i < n) {
    int j = i;
    while (j < n && j - i < kBatch && (wait[j] != 0) == (wait[i] != 0)) ++j;
    memset(ops, 0, sizeof(ops));
    for (int k = i; k < j; ++k) {
      CUstreamBatchMemOpParams& o = ops[k - i];
      const cuuint32_t v = static_cast<cuuint32_t>(seq + delta[k]);
      if (wait[k]) {
        o.waitValue.operation = CU_STREAM_MEM_OP_WAIT_VALUE_32;
        o.waitValue.address = addr[k];
        o.waitValue.value = v;
        o.waitValue.flags = wflags;
      } else {
        o.writeValue.operation = CU_STREAM_MEM_OP_WRITE_VALUE_32;
        o.writeValue.address = addr[k];
        o.writeValue.value = v;
        o.writeValue.flags = CU_STREAM_WRITE_VALUE_DEFAULT;
      }
    }
    const CUresult r =
        g_batch_mem_op(s, static_cast<unsigned int>(j - i), ops, 0);
    if (r != CUDA_SUCCESS) return static_cast<int>(r);
    i = j;
  }
  return 0;
}

// a stream of its own that never waits for the legacy default stream
// (the watchdog's, which releases a wait that no peer will satisfy)
extern "C" int acg_stream_create(void** stream) {
  return static_cast<int>(cudaStreamCreateWithFlags(
      reinterpret_cast<cudaStream_t*>(stream), cudaStreamNonBlocking));
}

extern "C" int acg_stream_destroy(void* stream) {
  return static_cast<int>(
      cudaStreamDestroy(static_cast<cudaStream_t>(stream)));
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

// map a PEER's handle (never this process's own: CUDA refuses it).  A
// refused open is returned, and cleared from the runtime's last error:
// left there, the next kernel launch's check would report it
extern "C" int acg_ipc_open(int device, const void* handle, void** ptr) {
  cudaIpcMemHandle_t h;
  memcpy(&h, handle, sizeof(h));
  cudaError_t e = cudaSetDevice(device);
  if (e == cudaSuccess)
    e = cudaIpcOpenMemHandle(ptr, h, cudaIpcMemLazyEnablePeerAccess);
  if (e != cudaSuccess) cudaGetLastError();
  return static_cast<int>(e);
}

extern "C" int acg_ipc_close(void* ptr) {
  return static_cast<int>(cudaIpcCloseMemHandle(ptr));
}

extern "C" int acg_ipc_free(void* ptr) {
  return static_cast<int>(cudaFree(ptr));
}

extern "C" int acg_ipc_handle_size() {
  return static_cast<int>(sizeof(cudaIpcMemHandle_t));
}
