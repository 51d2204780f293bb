// The sharded solve's collectives between the cards of one process, as
// device kernels that read their peers' memory over the peer-to-peer link
// (NVLink on an H100 host): the counterpart of the JAX package's lax.psum
// and lax.ppermute inside its shard_map body (exsaddle_tpu/parallel/
// cart_abf.py), where the port's one-card mesh makes .to() copies
// (parallel/shard_mesh.py). Being kernels, they can sit inside each card's
// conditional graph (graphs.ControlGraph), which a cross-card copy cannot.
//
// One launch is one collective on one card. Each card of the group runs
// the same sequence of collectives (the loops take the same branches on
// every card, their control state being replicated bit for bit), so the
// n-th collective of every card is the same one: its epoch e = n.
//
//   0. reuse: the card's send slot e % PEER_SLOTS last held epoch
//      e - PEER_SLOTS; every block waits until each peer has posted
//      e - PEER_SLOTS + 1 (a lagged wait: it rarely waits at all);
//   1. pack: the card's outgoing values (strided float64 views: interface
//      planes, a psum partial, an L-2 slab) go into that slot, at offsets
//      every card computes alike (kernels/peer.py plan);
//   2. post: the last block to finish packing writes e into every peer's
//      mailbox entry for this card (a release at system scope, then the
//      remote stores);
//   3. wait: every block waits until each card it reads from (the `waits`
//      mask: every peer for a psum or a gather, the neighbours whose
//      planes it takes for a halo) has posted e in this card's own mailbox
//      (volatile local loads, then an acquire at system scope), for at
//      most the group's timeout;
//   4. apply: read the peers' slots (ld.global.cv, nothing cached) and
//      add them into the card's planes (mode ADD, the halo's adds in the
//      order of the moves), copy them out (COPY: ghost planes, gathered
//      slabs), or fold every card's partial in global card order (FOLD:
//      s = p0; s = s + p1; ...), which is ShardMesh.psum's fold, so every
//      card gets the same bits, and the one-card psum's.
//
// Slot reuse: a card reads a peer's slot of epoch e only after that peer
// posted e, and within its own epoch-e launch. The peer writes that slot
// again at epoch e + PEER_SLOTS, after every card posted e + 1, which each
// does after its epoch-e launch completed (stream order), i.e. after it
// read the slot. So a collective waits only for the cards it reads from,
// and a card runs at most PEER_SLOTS - 1 collectives ahead of the slowest.
//
// Both waits add their time to the card's wait counter (block 0's), which
// the host reads to split a collective's time between waiting and moving.
//
// A wait that outlasts the timeout writes the card's error word (code 1,
// the collective's site, the epoch, the peer it waited for) and gives up;
// from then on the card's collectives skip their waits, FOLD and COPY
// write zeros and ADD adds nothing. Zero dots read as converged to every
// Krylov control kernel, so the solve ends at once and the host raises on
// the error word after it (parallel/cart_abf.py).
//
// No TPU kernel is replaced: the JAX package's collectives are XLA's.
// Every entry returns its cudaError_t (0 on success).

#include <cuda_runtime.h>

#define PEER_MAX_CARDS 8
#define PEER_MAX_ITEMS 16
#define PEER_THREADS 256
#define PEER_SLOTS 4

// A launch's parameters, passed by value (__grid_constant__). They sit
// outside the anonymous namespace: the C entry takes them, and a function
// of a type with internal linkage would not be exported.

// a strided float64 view of up to 4 dims (elements), row-major order
struct PeerView {
  double* ptr;
  int n;
  int ndim;
  int size[4];
  int stride[4];
};

struct PeerParams {
  unsigned long long* epoch;     // this card's last epoch
  unsigned long long* mail;      // this card's mailbox: [c] = card c's post
  unsigned long long* peer_mail[PEER_MAX_CARDS];  // every card's mailbox
  double* send[PEER_MAX_CARDS];  // every card's send buffer: PEER_SLOTS
                                 // slots of cap
  unsigned long long* err;       // this card: code, site, epoch, peer
  unsigned int* arrive;          // this card: blocks done packing
  unsigned long long* wait_ns;   // this card: ns its waits took (block 0)
  long long cap;
  long long timeout_ns;          // the bounded wait
  int ncards, me, site, mode;
  int waits;                     // bit c: wait for card c's post
  int nout, nin;
  PeerView out[PEER_MAX_ITEMS];  // outgoing values, packed in order
  long long out_off[PEER_MAX_ITEMS];
  PeerView in[PEER_MAX_ITEMS];   // where incoming values go
  long long in_off[PEER_MAX_ITEMS];
  int in_card[PEER_MAX_ITEMS];
};

namespace {

enum { MODE_ADD = 0, MODE_COPY = 1, MODE_FOLD = 2 };

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ long long view_off(const PeerView& v,
                                              long long j) {
  long long off = 0;
  for (int d = v.ndim - 1; d >= 0; --d) {
    const int s = v.size[d];
    off += (j % s) * v.stride[d];
    j /= s;
  }
  return off;
}

// item i and index j within it of flat index t over items of sizes n
__device__ __forceinline__ int find_item(const PeerView* v, int count,
                                         long long* t) {
  int i = 0;
  while (i < count - 1 && *t >= v[i].n) {
    *t -= v[i].n;
    ++i;
  }
  return i;
}

// release / acquire at system scope: orders this card's writes (and the
// reads before them) against the peers, which a device-scope fence does not
__device__ __forceinline__ void fence_sys() {
  asm volatile("fence.acq_rel.sys;" ::: "memory");
}

// wait until every card c in `mask` has posted at least `least` in this
// card's mailbox, for at most the timeout from t0; false (the error word
// written) where it timed out
__device__ bool wait_posts(const PeerParams& P, int mask,
                           unsigned long long least, unsigned long long e,
                           unsigned long long t0) {
  const long long limit = P.timeout_ns;
  for (int c = 0; c < P.ncards; ++c) {
    if (c == P.me || !((mask >> c) & 1)) continue;
    while (((volatile unsigned long long*)P.mail)[c] < least) {
      if ((long long)(global_ns() - t0) > limit) {
        if (atomicCAS(P.err, 0ULL, 1ULL) == 0ULL) {
          P.err[1] = (unsigned long long)P.site;
          P.err[2] = e;
          P.err[3] = (unsigned long long)c;
        }
        return false;
      }
    }
  }
  return true;
}

__global__ void __launch_bounds__(PEER_THREADS)
    peer_kernel(const __grid_constant__ PeerParams P) {
  __shared__ unsigned long long s_epoch;
  __shared__ int s_abort, s_last;
  const int tid = threadIdx.x;
  const int all = (1 << P.ncards) - 1;
  unsigned long long waited = 0ULL;
  if (tid == 0) {
    s_epoch = *(volatile unsigned long long*)P.epoch + 1ULL;
    s_abort = *(volatile unsigned long long*)P.err != 0ULL;
    // 0. the slot's last epoch read by every peer
    if (!s_abort && s_epoch > PEER_SLOTS) {
      const unsigned long long t0 = global_ns();
      if (!wait_posts(P, all, s_epoch - PEER_SLOTS + 1ULL, s_epoch, t0))
        s_abort = 1;
      fence_sys();
      waited += global_ns() - t0;
    }
  }
  __syncthreads();
  const unsigned long long e = s_epoch;
  const long long slot = (long long)(e % PEER_SLOTS) * P.cap;
  double* mine = P.send[P.me] + slot;
  const long long g0 = (long long)blockIdx.x * blockDim.x + tid;
  const long long gs = (long long)gridDim.x * blockDim.x;

  // 1. pack
  if (!s_abort) {
    long long total = 0;
    for (int i = 0; i < P.nout; ++i) total += P.out[i].n;
    for (long long t = g0; t < total; t += gs) {
      long long j = t;
      const int i = find_item(P.out, P.nout, &j);
      mine[P.out_off[i] + j] = P.out[i].ptr[view_off(P.out[i], j)];
    }
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(P.arrive, 1u) == gridDim.x - 1;
  __syncthreads();

  // 2. post (the last block to pack)
  if (s_last && tid == 0) {
    *P.arrive = 0u;
    *(volatile unsigned long long*)P.epoch = e;
    fence_sys();
    for (int c = 0; c < P.ncards; ++c)
      if (c != P.me) ((volatile unsigned long long*)P.peer_mail[c])[P.me] = e;
  }

  // 3. wait for this card's own post (every block has packed: a plane
  // packed here may be one the apply adds into) and for the cards it reads
  if (tid == 0) {
    const unsigned long long t0 = global_ns();
    while (*(volatile unsigned long long*)P.epoch < e) {
    }
    if (!s_abort && !wait_posts(P, P.waits, e, e, t0)) s_abort = 1;
    fence_sys();
    waited += global_ns() - t0;
    if (blockIdx.x == 0) *P.wait_ns += waited;
  }
  __syncthreads();

  // 4. apply
  if (P.mode == MODE_FOLD) {
    const PeerView& d = P.in[0];
    for (long long j = g0; j < d.n; j += gs) {
      double s = 0.0;
      if (!s_abort) {
        for (int c = 0; c < P.ncards; ++c) {
          const double v =
              c == P.me ? P.out[0].ptr[view_off(P.out[0], j)]
                        : __ldcv(P.send[c] + slot + P.in_off[0] + j);
          s = c == 0 ? v : __dadd_rn(s, v);
        }
      }
      d.ptr[view_off(d, j)] = s;
    }
    return;
  }
  if (s_abort && P.mode == MODE_ADD) return;
  long long total = 0;
  for (int i = 0; i < P.nin; ++i) total += P.in[i].n;
  for (long long t = g0; t < total; t += gs) {
    long long j = t;
    const int i = find_item(P.in, P.nin, &j);
    double* dst = P.in[i].ptr + view_off(P.in[i], j);
    if (s_abort) {
      *dst = 0.0;
    } else {
      const double v = __ldcv(P.send[P.in_card[i]] + slot + P.in_off[i] + j);
      *dst = P.mode == MODE_ADD ? __dadd_rn(*dst, v) : v;
    }
  }
}

}  // namespace

extern "C" {

int peer_params_size() { return (int)sizeof(PeerParams); }

int peer_slots() { return PEER_SLOTS; }

int peer_collective_f64(const PeerParams* p, int blocks, void* stream) {
  peer_kernel<<<blocks, PEER_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      *p);
  return cudaGetLastError();
}

// Peer access from every card of devs to every other (already enabled is
// fine); *missing = 1 where some pair has none (nothing enabled then).
int peer_enable(int n, const int* devs, int* missing) {
  int prev = 0;
  cudaError_t e = cudaGetDevice(&prev);
  if (e != cudaSuccess) return e;
  *missing = 0;
  for (int i = 0; i < n && !*missing; ++i)
    for (int j = 0; j < n; ++j) {
      if (i == j) continue;
      int can = 0;
      e = cudaDeviceCanAccessPeer(&can, devs[i], devs[j]);
      if (e != cudaSuccess) return e;
      if (!can) *missing = 1;
    }
  for (int i = 0; i < n && !*missing; ++i) {
    e = cudaSetDevice(devs[i]);
    if (e != cudaSuccess) return e;
    for (int j = 0; j < n; ++j) {
      if (i == j) continue;
      e = cudaDeviceEnablePeerAccess(devs[j], 0);
      if (e == cudaErrorPeerAccessAlreadyEnabled) {
        cudaGetLastError();
        e = cudaSuccess;
      }
      if (e != cudaSuccess) return e;
    }
  }
  return cudaSetDevice(prev);
}

}  // extern "C"
