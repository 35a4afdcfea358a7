// Shared pieces of the fused engine's kernels (fused_<protocol>_tick.cu):
// the counter PRNG, the Bernoulli knobs, the state-leaf, plan and parameter
// layouts of the C entry points, request selection, and the per-lane
// building blocks that the single-decree ticks have in common (the message
// buffers with reply delivery, and the learner table), and the shared-memory
// column and launch of the kernels that keep one per lane.
//
// Every kernel runs one thread per instance (lane) and keeps the lane's
// state in registers for a whole chunk (the Multi-Paxos and SynchPaxos
// kernels keep their slot-indexed arrays in shared memory beside them):
// every helper here is force-inlined and every loop has compile-time
// bounds, so arrays stay in registers.
//
// A measuring build (nvcc -DFUSED_COUNT_DRAWS) also counts every counter-
// PRNG draw a kernel makes, summed over lanes and ticks: the masks are drawn
// lazily, so that count is the PRNG work a run's data needs, which an
// operation census of the tick counts in place of drawing every mask.  A
// kernel that keeps slot-indexed arrays out of registers also counts the
// elements it touches (Multi-Paxos its slot arrays, SynchPaxos its delay
// stamps), for the same reason.  The
// timed build compiles none of it.
//
// Semantics follow the plain PyTorch version bit for bit:
//  - random bits are uint32 (wrapping mul/add, logical shifts); Bernoulli
//    masks are unsigned compares against host-rounded thresholds;
//  - lane i draws from stream seed mix(seed, tick, blk0 + i / block), and a
//    mask element (prefix..., i) hashes position prefix * block + i % block,
//    where `block` is the stream block (not the CUDA block size).

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kLeaves = 28;        // state leaves of a single-decree protocol, tick excluded
constexpr int kStampedLeaves = 30;  // the same with the two buffers' delay stamps
constexpr int kMaxLeaves = 32;     // room for every protocol's leaves
constexpr int kParams = 27;
constexpr int32_t kInt32Max = 2147483647;
constexpr int kThreads = 128;
constexpr int32_t kInt32Min = -2147483647 - 1;
constexpr int32_t kBallotLimit = (1 << 15) - 1;  // report-time ballot limit
constexpr int kMaxProposers = 8;                 // core/ballot.py

// Stream ids (core/streams.py).
constexpr uint32_t kSel = 0, kBusy = 1, kDeliver = 2, kDupReq = 3,
                   kDupRep = 4, kKeepProm = 5, kKeepAccd = 6, kKeepP1 = 7,
                   kKeepP2 = 8, kBackoff = 9, kDelayBits = 13, kLatBits = 14;

// The leaves every protocol shares, in flatten order after its 12 role
// leaves (3 acceptor, 9 proposer): learner, requests, replies.  A state with
// delay stamps has each buffer's `until` after its four leaves; its entry
// point moves the two stamp leaves last (move_stamps_last), so these
// indices hold for both layouts.
enum SharedLeaf {
  kLtBal = 12, kLtVal, kLtMask, kChosen, kChosenVal, kChosenTick, kViolations,
  kEvictions,
  kRqBal, kRqV1, kRqV2, kRqPresent,
  kRpBal, kRpV1, kRpV2, kRpPresent,
  kRqUntil, kRpUntil,
};

struct Leaves {
  void* p[kMaxLeaves];
};

struct Plan {
  const int32_t* crash_start;   // (A, I)
  const int32_t* crash_end;     // (A, I)
  const uint8_t* equivocate;    // (A, I) bool
  const int32_t* pcrash_start;  // (P, I) proposer crash window (Multi-Paxos)
  const int32_t* pcrash_end;    // (P, I)
  const int32_t* link_delay;    // (P, A, I) per-link latency cap (SynchPaxos), or null
};

// A Bernoulli knob: mode 0 = off (mask absent), 1 = draw against thr,
// 2 = p >= 1 (always fires).
struct Knob {
  int32_t mode;
  uint32_t thr;
};

struct Params {
  int64_t n_inst;
  int32_t block;  // stream block: lanes per counter-PRNG block id
  int32_t n_ticks;
  uint32_t seed;
  int32_t blk0;
  int32_t clamp_per_tick;
  int32_t timeout;
  int32_t backoff_n;
  int32_t stride;
  int32_t q1, q2;
  Knob idle, hold, dup, drop;
  int32_t q_fast;
  int32_t lease_len;  // Multi-Paxos progress lease
  int32_t log_total;  // Multi-Paxos global log length (0: the window is the log)
  Knob delay;              // p_delay: mode 0 off, 1 draw (never "always")
  int32_t delay_max;       // latency draw range, >= 1
  int32_t delta;           // SynchPaxos synchrony window, >= 0
  int32_t sp_unsafe_fast;  // SynchPaxos planted bug
};

__host__ __device__ constexpr int bit_length(int x) {
  return x <= 0 ? 0 : 1 + bit_length(x >> 1);
}

__device__ __forceinline__ int32_t wrap_add(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) + static_cast<uint32_t>(b));
}

__device__ __forceinline__ uint32_t mix32(uint32_t seed, uint32_t tick, uint32_t blk) {
  uint32_t h = seed * 0x9E3779B1u + tick * 0x85EBCA77u + blk * 0xC2B2AE3Du + 0x165667B1u;
  h ^= h >> 16;
  h *= 0x7FEB352Du;
  h ^= h >> 15;
  return h;
}

__device__ __forceinline__ uint32_t counter_bits(uint32_t seed, uint32_t stream, uint32_t pos) {
  uint32_t x = pos + 0x9E3779B9u * (stream + 1u);
  x ^= seed * 0x85EBCA6Bu;
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

#ifdef FUSED_COUNT_DRAWS
// Read and cleared by fused_draws(): counter_bits draws, slot-array touches.
__device__ unsigned long long g_draws = 0, g_touches = 0;
#endif

// One lane's count of counter_bits draws and of slot-array element touches
// (an element read, written, or read and written back at one site of a
// tick); empty unless FUSED_COUNT_DRAWS.
struct DrawCount {
#ifdef FUSED_COUNT_DRAWS
  uint32_t n = 0, touched = 0;
  __device__ __forceinline__ void add() { ++n; }
  __device__ __forceinline__ void touch(uint32_t k) { touched += k; }
  __device__ __forceinline__ void flush() const {
    atomicAdd(&g_draws, static_cast<unsigned long long>(n));
    atomicAdd(&g_touches, static_cast<unsigned long long>(touched));
  }
#else
  __device__ __forceinline__ void add() {}
  __device__ __forceinline__ void touch(uint32_t) {}
  __device__ __forceinline__ void flush() const {}
#endif
};

template <typename T>
__device__ __forceinline__ T load(const Leaves& L, int leaf, int row, int64_t n, int64_t i) {
  return reinterpret_cast<const T*>(L.p[leaf])[row * n + i];
}

template <typename T>
__device__ __forceinline__ void store(const Leaves& L, int leaf, int row, int64_t n, int64_t i, T v) {
  reinterpret_cast<T*>(L.p[leaf])[row * n + i] = v;
}

// ballot_round(b) = (b - 1) // MAX_PROPOSERS, floored (an arithmetic shift).
__device__ __forceinline__ int32_t ballot_round(int32_t b) { return wrap_add(b, -1) >> 3; }

// make_ballot(ballot_round(b) + stride, pid): the next ballot of proposer pid.
__device__ __forceinline__ int32_t next_ballot(int32_t b, int32_t stride, int pid) {
  return wrap_add(
      static_cast<int32_t>(static_cast<uint32_t>(wrap_add(ballot_round(b), stride)) * kMaxProposers),
      pid + 1);
}

// One lane's counter stream for one tick.
struct TickStream {
  uint32_t seed, block, lane;
  DrawCount* draws;

  __device__ __forceinline__ uint32_t pos(int prefix) const {
    return static_cast<uint32_t>(prefix) * block + lane;
  }
  __device__ __forceinline__ uint32_t bits(uint32_t stream, int prefix) const {
    draws->add();
    return counter_bits(seed, stream, pos(prefix));
  }
  // bern(p) for a knob that is on: True w.p. p.
  __device__ __forceinline__ bool fires_at(const Knob& k, uint32_t stream, int prefix) const {
    return k.mode == 2 || bits(stream, prefix) < k.thr;
  }
  // bern_not(p): True w.p. 1 - p, all True when the knob is off.
  __device__ __forceinline__ bool survives_at(const Knob& k, uint32_t stream, int prefix) const {
    return k.mode == 0 || !fires_at(k, stream, prefix);
  }
};

// Request selection for acceptor a over a (2, P, A) request buffer whose
// presence is the bitmask `present` (slot j = kp * A + a, kp = kind * P + p):
// the present slot with the highest score (random bits, low bits replaced
// by kp), or -1.  Draws one SEL element per present slot.
template <int P, int A>
__device__ __forceinline__ int select_request(const TickStream& ts, uint32_t present, int a) {
  constexpr int kNbits = bit_length(2 * P - 1) > 1 ? bit_length(2 * P - 1) : 1;
  constexpr int32_t kScoreMask = ~((1 << kNbits) - 1);
  int32_t fmax = kInt32Min;
  int win = -1;
#pragma unroll
  for (int kp = 0; kp < 2 * P; ++kp) {
    const int j = kp * A + a;
    if ((present >> j) & 1u) {
      const int32_t score = (static_cast<int32_t>(ts.bits(kSel, j)) & kScoreMask) | kp;
      if (score > fmax) {
        fmax = score;
        win = kp;
      }
    }
  }
  return win;
}

// The two message buffers of a lane, slot j = (kind * P + p) * A + a, with
// presence as bitmasks.
template <int S>
struct MsgBufs {
  static_assert(S <= 32, "slot presence must fit one 32-bit mask");
  int32_t rq_bal[S], rq_v1[S], rq_v2[S], rp_bal[S], rp_v1[S], rp_v2[S];
  uint32_t rq_present, rp_present;

  __device__ __forceinline__ void load_from(const Leaves& L, int64_t n, int64_t i) {
    rq_present = rp_present = 0;
#pragma unroll
    for (int j = 0; j < S; ++j) {
      rq_bal[j] = load<int32_t>(L, kRqBal, j, n, i);
      rq_v1[j] = load<int32_t>(L, kRqV1, j, n, i);
      rq_v2[j] = load<int32_t>(L, kRqV2, j, n, i);
      rq_present |= (load<uint8_t>(L, kRqPresent, j, n, i) != 0 ? 1u : 0u) << j;
      rp_bal[j] = load<int32_t>(L, kRpBal, j, n, i);
      rp_v1[j] = load<int32_t>(L, kRpV1, j, n, i);
      rp_v2[j] = load<int32_t>(L, kRpV2, j, n, i);
      rp_present |= (load<uint8_t>(L, kRpPresent, j, n, i) != 0 ? 1u : 0u) << j;
    }
  }

  __device__ __forceinline__ void store_to(const Leaves& L, int64_t n, int64_t i) const {
#pragma unroll
    for (int j = 0; j < S; ++j) {
      store<int32_t>(L, kRqBal, j, n, i, rq_bal[j]);
      store<int32_t>(L, kRqV1, j, n, i, rq_v1[j]);
      store<int32_t>(L, kRqV2, j, n, i, rq_v2[j]);
      store<uint8_t>(L, kRqPresent, j, n, i, ((rq_present >> j) & 1u) ? 1 : 0);
      store<int32_t>(L, kRpBal, j, n, i, rp_bal[j]);
      store<int32_t>(L, kRpV1, j, n, i, rp_v1[j]);
      store<int32_t>(L, kRpV2, j, n, i, rp_v2[j]);
      store<uint8_t>(L, kRpPresent, j, n, i, ((rp_present >> j) & 1u) ? 1 : 0);
    }
  }

  // Reply delivery: the replies that have arrived (`ready`, the delay
  // gate) and are not held this tick.  Returns them; the caller's `rp_next`
  // becomes the presence after consuming them (duplicated replies stay).
  __device__ __forceinline__ uint32_t deliver(const Params& prm, const TickStream& ts,
                                              uint32_t* rp_next, uint32_t ready = ~0u) const {
    uint32_t delivered = rp_present & ready;
    if (prm.hold.mode != 0) {
#pragma unroll
      for (int j = 0; j < S; ++j)
        if (((delivered >> j) & 1u) && ts.fires_at(prm.hold, kDeliver, j)) delivered &= ~(1u << j);
    }
    uint32_t taken = delivered;
    if (prm.dup.mode != 0) {
#pragma unroll
      for (int j = 0; j < S; ++j)
        if (((taken >> j) & 1u) && ts.fires_at(prm.dup, kDupRep, j)) taken &= ~(1u << j);
    }
    *rp_next = rp_present & ~taken;
    return delivered;
  }

  // Request selection for acceptor a (select_request).
  template <int P, int A>
  __device__ __forceinline__ int select(const TickStream& ts, int a) const {
    return select_request<P, A>(ts, rq_present, a);
  }
};

// The learner's bounded (ballot, value) -> voter-mask table of one lane.
template <int K>
struct Learner {
  int32_t bal[K], val[K], mask[K];
  bool chosen;
  int32_t chosen_val, chosen_tick, violations, evictions;

  __device__ __forceinline__ void load_from(const Leaves& L, int64_t n, int64_t i) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      bal[k] = load<int32_t>(L, kLtBal, k, n, i);
      val[k] = load<int32_t>(L, kLtVal, k, n, i);
      mask[k] = load<int32_t>(L, kLtMask, k, n, i);
    }
    chosen = load<uint8_t>(L, kChosen, 0, n, i) != 0;
    chosen_val = load<int32_t>(L, kChosenVal, 0, n, i);
    chosen_tick = load<int32_t>(L, kChosenTick, 0, n, i);
    violations = load<int32_t>(L, kViolations, 0, n, i);
    evictions = load<int32_t>(L, kEvictions, 0, n, i);
  }

  __device__ __forceinline__ void store_to(const Leaves& L, int64_t n, int64_t i) const {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      store<int32_t>(L, kLtBal, k, n, i, bal[k]);
      store<int32_t>(L, kLtVal, k, n, i, val[k]);
      store<int32_t>(L, kLtMask, k, n, i, mask[k]);
    }
    store<uint8_t>(L, kChosen, 0, n, i, chosen ? 1 : 0);
    store<int32_t>(L, kChosenVal, 0, n, i, chosen_val);
    store<int32_t>(L, kChosenTick, 0, n, i, chosen_tick);
    store<int32_t>(L, kViolations, 0, n, i, violations);
    store<int32_t>(L, kEvictions, 0, n, i, evictions);
  }

  // learner_observe: fold this tick's accept events (acceptor a accepted
  // (ev_bal[a], ev_val[a]) where bit a of ev_flag is set) in acceptor
  // order, then update chosen and count agreement violations, plus
  // `extra_viol` (the acceptor-local invariant breaks).  A slot is chosen
  // once its mask holds quorum_of(its ballot) voters.
  template <int A, typename QuorumOf>
  __device__ __forceinline__ void observe(uint32_t ev_flag, const int32_t (&ev_bal)[A],
                                          const int32_t (&ev_val)[A], int32_t tick,
                                          int extra_viol, QuorumOf quorum_of) {
    uint32_t pre_chosen = 0;
#pragma unroll
    for (int k = 0; k < K; ++k)
      pre_chosen |= (__popc(static_cast<uint32_t>(mask[k])) >= quorum_of(bal[k]) ? 1u : 0u) << k;
#pragma unroll
    for (int a = 0; a < A; ++a) {
      const int32_t b = ev_bal[a], v = ev_val[a];
      if (!(((ev_flag >> a) & 1u) && b > 0)) continue;
      const int32_t bit = 1 << a;
      bool any_match = false;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (bal[k] == b && val[k] == v) {
          mask[k] |= bit;
          any_match = true;
        }
      }
      if (any_match) continue;
      int32_t min_bal = bal[0];
#pragma unroll
      for (int k = 1; k < K; ++k) min_bal = min(min_bal, bal[k]);
      if (min_bal == 0 || b > min_bal) {
        bool done = false;
#pragma unroll
        for (int k = 0; k < K; ++k) {
          if (!done && bal[k] == min_bal) {
            bal[k] = b;
            val[k] = v;
            mask[k] = bit;
            done = true;
          }
        }
        if (min_bal != 0) ++evictions;
      } else {
        ++evictions;
      }
    }
    uint32_t newly = 0;
    int32_t first_val = 0;
#pragma unroll
    for (int k = K - 1; k >= 0; --k) {
      if (__popc(static_cast<uint32_t>(mask[k])) >= quorum_of(bal[k]) && !((pre_chosen >> k) & 1u)) {
        newly |= 1u << k;
        first_val = val[k];
      }
    }
    const bool any_new = newly != 0;
    const int32_t cv = chosen ? chosen_val : (any_new ? first_val : 0);
    const bool ch = chosen || any_new;
    chosen_tick = chosen ? chosen_tick : (any_new ? tick : -1);
    int viol = 0;
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (((newly >> k) & 1u) && val[k] != cv && ch) ++viol;
    chosen = ch;
    chosen_val = cv;
    violations = wrap_add(violations, viol + extra_viol);
  }
};

Knob knob(const long long* v) {
  return Knob{static_cast<int32_t>(v[0]), static_cast<uint32_t>(v[1])};
}

// Unpack a C entry point's arguments: `leaves` and `plan` are host arrays
// of device pointers (the protocol's `want_leaves` per-lane state leaves in
// flatten order; crash_start, crash_end, equivocate, pcrash_start,
// pcrash_end, link_delay, the last null where the plan has none); `params`
// holds kParams integers in the order of the Python wrapper
// (_kernel_params).  A kernel that does not model the bounded delay
// (`reads_delay` false) refuses p_delay.  Returns cudaSuccess or
// cudaErrorInvalidValue.
cudaError_t read_args(void** leaves, int n_leaves, int want_leaves, void** plan,
                      const long long* params, int n_params, Leaves* L, Plan* pl, Params* prm,
                      bool reads_delay = false) {
  if (n_leaves != want_leaves || want_leaves > kMaxLeaves || n_params != kParams)
    return cudaErrorInvalidValue;
  for (int j = 0; j < n_leaves; ++j) L->p[j] = leaves[j];
  *pl = Plan{static_cast<const int32_t*>(plan[0]), static_cast<const int32_t*>(plan[1]),
             static_cast<const uint8_t*>(plan[2]), static_cast<const int32_t*>(plan[3]),
             static_cast<const int32_t*>(plan[4]), static_cast<const int32_t*>(plan[5])};
  prm->n_inst = params[0];
  prm->block = static_cast<int32_t>(params[1]);
  prm->n_ticks = static_cast<int32_t>(params[2]);
  prm->seed = static_cast<uint32_t>(params[3]);
  prm->blk0 = static_cast<int32_t>(params[4]);
  prm->clamp_per_tick = static_cast<int32_t>(params[5]);
  prm->timeout = static_cast<int32_t>(params[6]);
  prm->backoff_n = static_cast<int32_t>(params[7]);
  prm->stride = static_cast<int32_t>(params[8]);
  prm->q1 = static_cast<int32_t>(params[9]);
  prm->q2 = static_cast<int32_t>(params[10]);
  prm->idle = knob(params + 11);
  prm->hold = knob(params + 13);
  prm->dup = knob(params + 15);
  prm->drop = knob(params + 17);
  prm->q_fast = static_cast<int32_t>(params[19]);
  prm->lease_len = static_cast<int32_t>(params[20]);
  prm->log_total = static_cast<int32_t>(params[21]);
  prm->delay = knob(params + 22);
  prm->delay_max = static_cast<int32_t>(params[24]);
  prm->delta = static_cast<int32_t>(params[25]);
  prm->sp_unsafe_fast = static_cast<int32_t>(params[26]);
  if (prm->n_inst <= 0 || prm->block <= 0 || prm->n_inst % prm->block != 0 || prm->backoff_n < 1 ||
      prm->delay_max < 1 || prm->delta < 0 || prm->delay.mode == 2)
    return cudaErrorInvalidValue;
  if (prm->delay.mode != 0 && (!reads_delay || pl->link_delay == nullptr))
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

// A stamped state's leaves arrive in flatten order, each buffer's `until`
// after its four leaves; move the two stamp leaves last (SharedLeaf).
void move_stamps_last(Leaves* L) {
  void* rq_until = L->p[kRqBal + 4];
  for (int j = kRqBal + 4; j < kRpUntil - 1; ++j) L->p[j] = L->p[j + 1];
  L->p[kRqUntil] = rq_until;
}

// Grid size for one thread per lane, `threads` lanes a block.
inline unsigned grid_for(int64_t n_inst, int threads = kThreads) {
  return static_cast<unsigned>((n_inst + threads - 1) / threads);
}

// The kernels that keep a column per lane in shared memory (Multi-Paxos,
// SynchPaxos).

constexpr int kMaxDevices = 64;  // devices whose shared-memory limit is cached

// One thread's column of the block's shared buffer: word r at p[r * B].
template <int B>
struct Column {
  int32_t* p;  // the buffer + threadIdx.x
  __device__ __forceinline__ int32_t& operator[](int r) const { return p[r * B]; }
};

// Dynamic shared memory of `bytes` a block for `kernel` on the current
// device: the limit is raised (and the carveout set to the most shared
// memory) the first time a size is asked for on a device.  `allowed` is the
// kernel's own cache.  A refused request clears the runtime's last error,
// so that it does not fail the next launch, and is returned.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, int (&allowed)[kMaxDevices]) {
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return rc;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (allowed[dev] == bytes) return cudaSuccess;
  rc = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (rc == cudaSuccess)
    rc = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
  if (rc != cudaSuccess) {
    cudaGetLastError();
    return rc;
  }
  allowed[dev] = bytes;
  return cudaSuccess;
}

using TickKernel = void (*)(Leaves, Plan, const int32_t*, Params);

// One instantiation of such a kernel, B lanes a block, with `smem` bytes of
// dynamic shared memory a block (at least NEED, its staged rows'):
// `launch` runs it over prm.n_inst lanes, `occupancy` asks how many of its
// blocks an SM holds.
template <TickKernel KERNEL, int B, int NEED>
struct SmemInst {
  static cudaError_t prepare(int smem) {
    static int allowed[kMaxDevices] = {};
    if (smem < NEED) return cudaErrorInvalidValue;
    return allow_smem(KERNEL, smem, allowed);
  }

  static cudaError_t launch(const Leaves& L, const Plan& plan, const int32_t* tick,
                            const Params& prm, int smem, cudaStream_t stream) {
    const cudaError_t rc = prepare(smem);
    if (rc != cudaSuccess) return rc;
    KERNEL<<<grid_for(prm.n_inst, B), B, smem, stream>>>(L, plan, tick, prm);
    return cudaGetLastError();
  }

  static cudaError_t occupancy(int smem, int* blocks_per_sm) {
    const cudaError_t rc = prepare(smem);
    if (rc != cudaSuccess) return rc;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, KERNEL, B, smem);
  }
};

}  // namespace

#ifdef FUSED_COUNT_DRAWS
// Copies the counts of the launches since the last call to out[0] (draws)
// and out[1] (slot-array touches) and clears them; call after the launches
// are complete.  Returns a cudaError_t.
extern "C" int fused_draws(unsigned long long* out) {
  const unsigned long long zero = 0;
  cudaError_t rc = cudaMemcpyFromSymbol(out, g_draws, sizeof(*out));
  if (rc == cudaSuccess) rc = cudaMemcpyFromSymbol(out + 1, g_touches, sizeof(*out));
  if (rc == cudaSuccess) rc = cudaMemcpyToSymbol(g_draws, &zero, sizeof(zero));
  if (rc == cudaSuccess) rc = cudaMemcpyToSymbol(g_touches, &zero, sizeof(zero));
  return rc;
}
#endif
