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
//      add them into the card's planes (mode ADD), copy them out (COPY:
//      ghost planes, gathered slabs), or fold every card's partial in
//      global card order (FOLD: s = p0; s = s + p1; ...), which is
//      ShardMesh.psum's fold, so every card gets the same bits, and the
//      one-card psum's.
//
// A destination view takes its values from sources: a peer, an offset in
// that peer's slot and strides laid over the view's index space (a
// source may be a strided part of a plane the peer packed). COPY and
// FOLD read one source, ADD 1, 3 or 7. ADD sums the destination's own
// value and its sources pairwise, the source list ordered as the leaves
// of the tree (v0 + v1) + (v2 + v3), ... with v0 the own value: the
// one-card mesh's halo over k split axes in axis order, each axis adding
// the neighbour's value after the earlier axes (the edge of two
// interface planes takes (own + y) + (z + diagonal), the diagonal card's
// value read from the plane it packed for its own neighbour). The
// destinations of one launch must not overlap.
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
#define PEER_MAX_OUT 16    // packed views per launch
#define PEER_MAX_IN 24     // destination views per launch
#define PEER_MAX_SRC 48    // their sources, over all destinations
#define PEER_MAX_TERMS 8   // an ADD sums its own value and up to 7 sources
#define PEER_THREADS 256
#define PEER_SLOTS 4

// A launch's parameters, passed by value (__grid_constant__) within the
// classic 4 KB kernel parameter limit (static_assert below). They sit
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

// where a destination's values come from: card `card`'s slot, at `off`
// plus the destination's index (its view's dims) times `stride`
struct PeerSrc {
  int card;
  int off;
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
  PeerView out[PEER_MAX_OUT];    // outgoing values, packed in order
  int out_off[PEER_MAX_OUT];
  PeerView in[PEER_MAX_IN];      // where incoming values go
  int in_src[PEER_MAX_IN];       // each destination's first source
  int in_nsrc[PEER_MAX_IN];      // and their count
  PeerSrc src[PEER_MAX_SRC];
};

static_assert(sizeof(PeerParams) <= 4096,
              "PeerParams exceeds the classic 4 KB kernel parameter limit");

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

// the index (row-major over the view's dims) of flat index j
__device__ __forceinline__ void view_index(const PeerView& v, long long j,
                                           int* idx) {
#pragma unroll
  for (int d = 3; d >= 0; --d) {
    idx[d] = 0;
    if (d < v.ndim) {
      idx[d] = (int)(j % v.size[d]);
      j /= v.size[d];
    }
  }
}

__device__ __forceinline__ long long index_off(const int* idx,
                                               const int* stride, int ndim) {
  long long off = 0;
#pragma unroll
  for (int d = 0; d < 4; ++d)
    if (d < ndim) off += (long long)idx[d] * stride[d];
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
    const long long off = P.src[P.in_src[0]].off;
    for (long long j = g0; j < d.n; j += gs) {
      double s = 0.0;
      if (!s_abort) {
        for (int c = 0; c < P.ncards; ++c) {
          const double v =
              c == P.me ? P.out[0].ptr[view_off(P.out[0], j)]
                        : __ldcv(P.send[c] + slot + off + j);
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
    const PeerView& d = P.in[i];
    int idx[4];
    view_index(d, j, idx);
    double* dst = d.ptr + index_off(idx, d.stride, d.ndim);
    if (s_abort) {
      *dst = 0.0;
      continue;
    }
    const PeerSrc* S = P.src + P.in_src[i];
    if (P.mode == MODE_COPY) {
      *dst = __ldcv(P.send[S[0].card] + slot + S[0].off +
                    index_off(idx, S[0].stride, d.ndim));
      continue;
    }
    // ADD: the own value and the sources, summed pairwise in leaf order
    const int n = P.in_nsrc[i];
    double v[PEER_MAX_TERMS];
    v[0] = *dst;
#pragma unroll
    for (int q = 1; q < PEER_MAX_TERMS; ++q)
      v[q] = q <= n ? __ldcv(P.send[S[q - 1].card] + slot + S[q - 1].off +
                             index_off(idx, S[q - 1].stride, d.ndim))
                    : 0.0;
#pragma unroll
    for (int w = 1; w < PEER_MAX_TERMS; w *= 2)
#pragma unroll
      for (int q = 0; q + w < PEER_MAX_TERMS; q += 2 * w)
        if (q + w <= n) v[q] = __dadd_rn(v[q], v[q + w]);
    *dst = v[0];
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
