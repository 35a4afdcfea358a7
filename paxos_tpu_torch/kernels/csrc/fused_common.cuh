// Shared pieces of the fused engine's kernels (fused_<protocol>_tick.cu):
// the counter PRNG, the Bernoulli knobs, the state-leaf, plan and parameter
// layouts of the C entry points, the learner table that the single-decree
// ticks have in common, the shared-memory column and launch of the kernels
// that keep one per lane, the rolled selection, fenced row copy, message
// column and column learner of the single-decree kernels and the pieces of
// the gray-failure and partition arms of K1 to K3 and K5 (namespace sd),
// and the phase clocks.
//
// Every kernel runs one thread per instance (lane) and keeps the lane's
// scalars in registers for a whole chunk (the Multi-Paxos kernel keeps its
// slot-indexed arrays in shared memory beside them, the single-decree
// kernels their message payloads and learner table): every helper here is
// force-inlined and every loop over a register array has compile-time
// bounds, so those arrays stay in registers.
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
constexpr int kParams = 37;
constexpr int kPlanLeaves = 15;
constexpr int32_t kInt32Max = 2147483647;
constexpr int32_t kInt32Min = -2147483647 - 1;
constexpr int32_t kBallotLimit = (1 << 15) - 1;  // report-time ballot limit
constexpr int kMaxProposers = 8;                 // core/ballot.py

// Stream ids (core/streams.py).
constexpr uint32_t kSel = 0, kBusy = 1, kDeliver = 2, kDupReq = 3,
                   kDupRep = 4, kKeepProm = 5, kKeepAccd = 6, kKeepP1 = 7,
                   kKeepP2 = 8, kBackoff = 9, kLinkBits = 10, kDupBits = 11,
                   kCorrupt = 12, kDelayBits = 13, kLatBits = 14;

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

// The gray-failure and partition arms of K1 to K3 and K5
// (fused_paxos_tick.cu, fused_fastpaxos_tick.cu, fused_raftcore_tick.cu,
// fused_multipaxos_tick.cu): their knobs and plan leaves, a separate kernel argument of their arms instantiations only, so
// that Plan and Params, which every kernel takes, stay as they are.  An
// optional plan leaf is null where the plan has none.
struct Gray {
  Knob corrupt;            // p_corrupt
  int32_t stale_k;         // snapshot period of stale recovery, 0 off
  int32_t amnesia;         // a recovering acceptor forgets its state
  int32_t partition;       // p_part > 0: cut links stall
  int32_t asym;            // p_asym > 0: part_dir makes a cut one-way
  int32_t flaky;           // p_flaky > 0: per-link drop thresholds replace p_drop
  int32_t flaky_dup;       // ... and per-link dup thresholds p_dup (links_dup)
  int32_t timeout_skew;    // timeout_skew > 0: ptimeout extends each timeout
  int32_t backoff_skew;    // backoff_skew > 1: pboff multiplies each backoff
  const int32_t* part_start;  // (I,) partition window
  const int32_t* part_end;    // (I,)
  const uint8_t* aside;       // (A, I) bool acceptor's side of the cut
  const uint8_t* pside;       // (P, I) bool proposer's side of the cut
  const int32_t* part_dir;    // (I,) 0 two-way, 1 requests cut, 2 replies cut (p_asym), or null
  const int32_t* link_drop;   // (P, A, I) uint32 drop threshold (p_flaky), or null
  const int32_t* link_dup;    // (P, A, I) uint32 dup threshold (p_flaky + dup), or null
  const int32_t* ptimeout;    // (P, I) extra timeout ticks (timeout_skew), or null
  const int32_t* pboff;       // (P, I) backoff multiplier (backoff_skew), or null

  // Whether a knob of the arms is on.
  bool on() const {
    return corrupt.mode != 0 || stale_k != 0 || amnesia != 0 || partition != 0 || asym != 0 ||
           flaky != 0 || flaky_dup != 0 || timeout_skew != 0 || backoff_skew != 0;
  }
};

__host__ __device__ constexpr int bit_length(int x) {
  return x <= 0 ? 0 : 1 + bit_length(x >> 1);
}

__device__ __forceinline__ int32_t wrap_add(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) + static_cast<uint32_t>(b));
}

// x mod k for k > 0, in [0, k) (the plain ticks' floor modulo).
__device__ __forceinline__ int32_t floor_mod(int32_t x, int32_t k) {
  const int32_t m = x % k;
  return m < 0 ? m + k : m;
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
  // bits_below(raw bits, thr): a per-link threshold (a uint32 in an int32
  // bit pattern, compared without sign); a 0 threshold never fires, and
  // is not drawn.
  __device__ __forceinline__ bool below_at(int32_t thr, uint32_t stream, int prefix) const {
    return thr != 0 && bits(stream, prefix) < static_cast<uint32_t>(thr);
  }
};

// The learner's bounded (ballot, value) -> voter-mask table of one lane,
// in registers for the fold of a tick (sd::ColumnLearner).
template <int K>
struct Learner {
  int32_t bal[K], val[K], mask[K];
  bool chosen;
  int32_t chosen_val, chosen_tick, violations, evictions;

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
// flatten order; kPlanLeaves plan leaves: crash_start, crash_end,
// equivocate, pcrash_start, pcrash_end, link_delay, then Gray's
// part_start to pboff, each optional one null where the plan has none);
// `params` holds kParams integers in the order of the Python wrapper
// (_kernel_params), Gray's knobs last.  A kernel that does not model the
// bounded delay (`reads_delay` false) refuses p_delay; one that does not
// model the gray-failure and partition arms (`gray` null) refuses their
// knobs, and a knob of theirs on needs its plan leaves.  Returns
// cudaSuccess or cudaErrorInvalidValue.
cudaError_t read_args(void** leaves, int n_leaves, int want_leaves, void** plan,
                      const long long* params, int n_params, Leaves* L, Plan* pl, Params* prm,
                      bool reads_delay = false, Gray* gray = nullptr) {
  if (n_leaves != want_leaves || want_leaves > kMaxLeaves || n_params != kParams)
    return cudaErrorInvalidValue;
  for (int j = 0; j < n_leaves; ++j) L->p[j] = leaves[j];
  const auto i32 = [&](int k) { return static_cast<const int32_t*>(plan[k]); };
  const auto u8 = [&](int k) { return static_cast<const uint8_t*>(plan[k]); };
  *pl = Plan{i32(0), i32(1), u8(2), i32(3), i32(4), i32(5)};
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
  const auto flag = [&](int k) { return static_cast<int32_t>(params[k]); };
  const Gray g{knob(params + 27), flag(29), flag(30), flag(31), flag(32), flag(33), flag(34),
               flag(35), flag(36), i32(6), i32(7), u8(8), u8(9), i32(10), i32(11), i32(12),
               i32(13), i32(14)};
  if (prm->n_inst <= 0 || prm->block <= 0 || prm->n_inst % prm->block != 0 || prm->backoff_n < 1 ||
      prm->delay_max < 1 || prm->delta < 0 || prm->delay.mode == 2 || g.stale_k < 0)
    return cudaErrorInvalidValue;
  if (prm->delay.mode != 0 && (!reads_delay || pl->link_delay == nullptr))
    return cudaErrorInvalidValue;
  if (g.on() && gray == nullptr) return cudaErrorInvalidValue;
  if ((g.partition && (g.part_start == nullptr || g.part_end == nullptr || g.aside == nullptr ||
                       g.pside == nullptr)) ||
      (g.asym && g.part_dir == nullptr) || (g.flaky && g.link_drop == nullptr) ||
      (g.flaky_dup && (!g.flaky || g.link_dup == nullptr)) ||
      (g.timeout_skew && g.ptimeout == nullptr) || (g.backoff_skew && g.pboff == nullptr))
    return cudaErrorInvalidValue;
  if (gray != nullptr) *gray = g;
  return cudaSuccess;
}

// A Paxos, Fast Paxos or Raft-core state with snapshot shadows (stale_k >
// 0) arrives with them after the three acceptor (voter) leaves, in flatten
// order; its entry point moves them last (move_snapshots_last), so that
// SharedLeaf's indices hold, and the shadows of the three durable fields
// are these.  A Multi-Paxos state carries two, after its two acceptor
// leaves, moved after its own leaves alike.
constexpr int kSnapLeaves = kLeaves + 3;
enum SnapLeaf { kSnap0 = kLeaves, kSnap1, kSnap2 };
constexpr int kMaxSnaps = 3;

// Moves the n_snaps shadow leaves at index `at` after the state's other
// n_base leaves.
void move_snapshots_last(Leaves* L, int n_base = kLeaves, int at = 3, int n_snaps = 3) {
  void* snaps[kMaxSnaps];
  for (int k = 0; k < n_snaps; ++k) snaps[k] = L->p[at + k];
  for (int j = at; j < n_base; ++j) L->p[j] = L->p[j + n_snaps];
  for (int k = 0; k < n_snaps; ++k) L->p[n_base + k] = snaps[k];
}

// read_args for a kernel with an arms instantiation (K1 to K3, K5): the
// state's leaves are n_base (K1 to K3: kLeaves), or n_base + n_snaps with
// the snapshot shadows at index `at` (moved last); `arms` is the
// instantiation the wrapper picked, which must be the arms' exactly when a
// knob of theirs is on, and stale_k needs the shadows.  Returns
// cudaSuccess or cudaErrorInvalidValue.
cudaError_t read_gray_args(bool arms, void** leaves, int n_leaves, void** plan,
                           const long long* params, int n_params, Leaves* L, Plan* pl,
                           Params* prm, Gray* gray, int n_base = kLeaves, int at = 3,
                           int n_snaps = 3) {
  if (n_snaps > kMaxSnaps) return cudaErrorInvalidValue;
  const bool snapshots = n_leaves == n_base + n_snaps;
  const cudaError_t bad = read_args(leaves, n_leaves, snapshots ? n_base + n_snaps : n_base, plan,
                                    params, n_params, L, pl, prm, false, gray);
  if (bad != cudaSuccess) return bad;
  if (gray->on() != arms || (gray->stale_k > 0 && !snapshots)) return cudaErrorInvalidValue;
  if (snapshots) move_snapshots_last(L, n_base, at, n_snaps);
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
inline unsigned grid_for(int64_t n_inst, int threads) {
  return static_cast<unsigned>((n_inst + threads - 1) / threads);
}

// The kernels that keep a column per lane in shared memory (all five).

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

// One instantiation of such a kernel (a `__global__` function of Leaves,
// Plan, the tick pointer, Params and any further arguments), B lanes a
// block, with `smem` bytes of dynamic shared memory a block (at least NEED,
// its staged rows'): `launch` runs it over prm.n_inst lanes, `occupancy`
// asks how many of its blocks an SM holds.
template <auto KERNEL, int B, int NEED>
struct SmemInst {
  static cudaError_t prepare(int smem) {
    static int allowed[kMaxDevices] = {};
    if (smem < NEED) return cudaErrorInvalidValue;
    return allow_smem(KERNEL, smem, allowed);
  }

  template <typename... More>
  static cudaError_t launch(const Leaves& L, const Plan& plan, const int32_t* tick,
                            const Params& prm, int smem, cudaStream_t stream, const More&... more) {
    const cudaError_t rc = prepare(smem);
    if (rc != cudaSuccess) return rc;
    KERNEL<<<grid_for(prm.n_inst, B), B, smem, stream>>>(L, plan, tick, prm, more...);
    return cudaGetLastError();
  }

  static cudaError_t occupancy(int smem, int* blocks_per_sm) {
    const cudaError_t rc = prepare(smem);
    if (rc != cudaSuccess) return rc;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, KERNEL, B, smem);
  }
};

// The phase-clock measuring build (nvcc -DFUSED_PHASE_CLOCKS) of a kernel
// whose tick has N phases (K1 to K4): a lane sums the clock64() cycles
// between consecutive phase boundaries (its own cycles, which include the
// time other warps hold the SM) and adds them to g_phase at the end; empty
// in every other build.
constexpr int kMaxPhases = 8;  // fused_tick.PHASE_SLOTS

#ifdef FUSED_PHASE_CLOCKS
// Read and cleared by fused_phase_clocks(): clock64() cycles per phase,
// summed over lanes and ticks.
__device__ unsigned long long g_phase[kMaxPhases];
#endif

template <int N>
struct PhaseClock {
  static_assert(N <= kMaxPhases, "g_phase holds kMaxPhases phases");
#ifdef FUSED_PHASE_CLOCKS
  long long t;
  uint32_t sum[N];
  // clock64() exists in device code only; nvcc's host pass sees 0.
  __device__ __forceinline__ static long long now() {
#ifdef __CUDA_ARCH__
    return clock64();
#else
    return 0;
#endif
  }
  __device__ __forceinline__ PhaseClock() : t(now()), sum{} {}
  __device__ __forceinline__ void mark(int k) {
    const long long now = PhaseClock::now();
    sum[k] += static_cast<uint32_t>(now - t);
    t = now;
  }
  __device__ __forceinline__ void flush() const {
#pragma unroll
    for (int k = 0; k < N; ++k) atomicAdd(&g_phase[k], static_cast<unsigned long long>(sum[k]));
  }
#else
  __device__ __forceinline__ void mark(int) {}
  __device__ __forceinline__ void flush() const {}
#endif
};

// The rolled and fenced building blocks of the single-decree kernels, each
// of which keeps a column per lane (K1 to K4); K5 keeps its own copies
// (fused_multipaxos_tick.cu).
namespace sd {

// Request selection for acceptor a over a (2, P, A) request buffer whose
// presence is the bitmask `present` (slot j = kp * A + a, kp = kind * P +
// p), as the plain select_from_scores: the present slot with the highest
// score (random bits, low bits replaced by kp), or -1.  It draws one SEL
// element per present slot only: the scores are distinct (kp in the low
// bits), so the order of the draws does not change the winner.
template <int P, int A>
__device__ __forceinline__ int select_present(const TickStream& ts, uint32_t present, int a) {
  constexpr int kNbits = bit_length(2 * P - 1) > 1 ? bit_length(2 * P - 1) : 1;
  constexpr int32_t kScoreMask = ~((1 << kNbits) - 1);
  uint32_t mine = 0;  // bit kp: slot kp * A + a is present
#pragma unroll
  for (int kp = 0; kp < 2 * P; ++kp) mine |= ((present >> (kp * A + a)) & 1u) << kp;
  int32_t fmax = kInt32Min;
  int win = -1;
  for (uint32_t m = mine; m != 0; m &= m - 1) {
    const int kp = __ffs(m) - 1;
    const int32_t score = (static_cast<int32_t>(ts.bits(kSel, kp * A + a)) & kScoreMask) | kp;
    if (score > fmax) {
      fmax = score;
      win = kp;
    }
  }
  return win;
}

// ROWS rows of a leaf from its row FROM on, to (from) the column from row
// OFF on, UNROLL rows at a time (0: all).  A load ends with a compiler
// fence, so that one leaf's loads are in flight at a time: without it the
// compiler issues all the column's loads at once and spills the registers
// they need.
template <int ROWS, int FROM, int OFF, int UNROLL = 0, int B>
__device__ __forceinline__ void load_rows(const Column<B>& col, const Leaves& L, int leaf,
                                          int64_t n, int64_t i) {
  const int32_t* g = static_cast<const int32_t*>(L.p[leaf]) + i;
#pragma unroll (UNROLL > 0 ? UNROLL : ROWS)
  for (int r = 0; r < ROWS; ++r) col[OFF + r] = g[(FROM + r) * n];
  asm volatile("" ::: "memory");
}

template <int ROWS, int FROM, int OFF, int B>
__device__ __forceinline__ void store_rows(const Column<B>& col, const Leaves& L, int leaf,
                                           int64_t n, int64_t i) {
  int32_t* g = static_cast<int32_t*>(L.p[leaf]) + i;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) g[(FROM + r) * n] = col[OFF + r];
}

// A Paxos, Fast Paxos or Raft-core lane's staged rows, in column order
// (mirrored by fused_tick.FR_STAGED_LEAVES).  Slot j = (kind * P + p) * A +
// a of a buffer, E = P * A slots a kind.  A request's v1 is staged for every slot
// where RV_V1 (Raft-core: a REQVOTE carries the candidate's entry term),
// else for the kind-1 slots only; a reply's v2 for the kind-0 slots only
// (row j).  The words the tick only ever writes as 0 get no row
// (fused_tick.FR_ZERO_WORDS).  SynchPaxos keeps its own layout, with the
// stamps (SpStaged).
template <int P, int A, int K, bool RV_V1>
struct SdStaged {
  static constexpr int S = 2 * P * A, E = P * A;
  static constexpr int kRqV1From = RV_V1 ? 0 : E;     // the first slot whose v1 is staged
  static constexpr int kRqBal = 0;                     // requests.bal (2, P, A)
  static constexpr int kRqV1 = kRqBal + S;             // requests.v1 from slot kRqV1From
  static constexpr int kRpBal = kRqV1 + S - kRqV1From;  // replies.bal (2, P, A)
  static constexpr int kRpV1 = kRpBal + S;             // replies.v1 (2, P, A)
  static constexpr int kRpV2 = kRpV1 + S;              // replies.v2, kind 0
  static constexpr int kLtBal = kRpV2 + E;             // learner.lt_bal (K)
  static constexpr int kLtVal = kLtBal + K;            // learner.lt_val (K)
  static constexpr int kLtMask = kLtVal + K;           // learner.lt_mask (K)
  static constexpr int kRows = kLtMask + K;
  // The row of slot j's request v1 (j >= kRqV1From).
  __host__ __device__ static constexpr int rq_v1(int j) { return kRqV1 + j - kRqV1From; }
};

// Rows of a leaf that the column copy of a kernel held to MIN_BLOCKS
// blocks an SM has in flight (load_column's UNROLL): all of them (0), but
// 8 at 4 blocks, whose 128 registers a thread a whole leaf overran (K2's
// (2,5,8) spilled 16 B in its prologue), while K3's whole-leaf copy ran
// 0.1 ms faster a chunk at 3 blocks (PERF.md §6).
template <int MIN_BLOCKS>
constexpr int kCopyUnroll = MIN_BLOCKS > 3 ? 8 : 0;

// The column at the start of the chunk: every staged row, UNROLL rows of a
// leaf at a time (load_rows).
template <int P, int A, int K, bool RV_V1, int UNROLL, int B>
__device__ __forceinline__ void load_column(const Column<B>& col, const Leaves& L, int64_t n,
                                            int64_t i) {
  using G = SdStaged<P, A, K, RV_V1>;
  load_rows<G::S, 0, G::kRqBal, UNROLL>(col, L, kRqBal, n, i);
  load_rows<G::S - G::kRqV1From, G::kRqV1From, G::kRqV1, UNROLL>(col, L, kRqV1, n, i);
  load_rows<G::S, 0, G::kRpBal, UNROLL>(col, L, kRpBal, n, i);
  load_rows<G::S, 0, G::kRpV1, UNROLL>(col, L, kRpV1, n, i);
  load_rows<G::E, 0, G::kRpV2, UNROLL>(col, L, kRpV2, n, i);
  load_rows<K, 0, G::kLtBal, UNROLL>(col, L, kLtBal, n, i);
  load_rows<K, 0, G::kLtVal, UNROLL>(col, L, kLtVal, n, i);
  load_rows<K, 0, G::kLtMask, UNROLL>(col, L, kLtMask, n, i);
}

// The column at the end of the chunk: the slots of each buffer that the
// chunk wrote (bitmasks rq_written, rp_written) with their zero-only words
// as 0, and the learner table if an accept event reached it.
template <int P, int A, int K, bool RV_V1, int B>
__device__ __forceinline__ void store_column(const Column<B>& col, const Leaves& L, int64_t n,
                                             int64_t i, uint32_t rq_written, uint32_t rp_written,
                                             bool lt_written) {
  using G = SdStaged<P, A, K, RV_V1>;
  for (uint32_t m = rq_written; m != 0; m &= m - 1) {
    const int j = __ffs(m) - 1;
    store<int32_t>(L, kRqBal, j, n, i, col[G::kRqBal + j]);
    store<int32_t>(L, kRqV1, j, n, i, j >= G::kRqV1From ? col[G::rq_v1(j)] : 0);
    store<int32_t>(L, kRqV2, j, n, i, 0);
  }
  for (uint32_t m = rp_written; m != 0; m &= m - 1) {
    const int j = __ffs(m) - 1;
    store<int32_t>(L, kRpBal, j, n, i, col[G::kRpBal + j]);
    store<int32_t>(L, kRpV1, j, n, i, col[G::kRpV1 + j]);
    store<int32_t>(L, kRpV2, j, n, i, j < G::E ? col[G::kRpV2 + j] : 0);
  }
  if (lt_written) {
    store_rows<K, 0, G::kLtBal>(col, L, kLtBal, n, i);
    store_rows<K, 0, G::kLtVal>(col, L, kLtVal, n, i);
    store_rows<K, 0, G::kLtMask>(col, L, kLtMask, n, i);
  }
}

// The learner's scalars of a lane whose (ballot, value, voters) table sits
// in the column from row ROW on (ballots, then values, then voter masks).
template <int K, int ROW>
struct ColumnLearner {
  bool chosen;
  int32_t chosen_val, chosen_tick, violations, evictions;

  __device__ __forceinline__ void load_from(const Leaves& L, int64_t n, int64_t i) {
    chosen = load<uint8_t>(L, kChosen, 0, n, i) != 0;
    chosen_val = load<int32_t>(L, kChosenVal, 0, n, i);
    chosen_tick = load<int32_t>(L, kChosenTick, 0, n, i);
    violations = load<int32_t>(L, kViolations, 0, n, i);
    evictions = load<int32_t>(L, kEvictions, 0, n, i);
  }

  __device__ __forceinline__ void store_to(const Leaves& L, int64_t n, int64_t i) const {
    store<uint8_t>(L, kChosen, 0, n, i, chosen ? 1 : 0);
    store<int32_t>(L, kChosenVal, 0, n, i, chosen_val);
    store<int32_t>(L, kChosenTick, 0, n, i, chosen_tick);
    store<int32_t>(L, kViolations, 0, n, i, violations);
    store<int32_t>(L, kEvictions, 0, n, i, evictions);
  }

  // A tick without an accept event: the table stays as it is, and the
  // fold's other writes reduce to the scalars'.
  __device__ __forceinline__ void quiet(int extra_viol) {
    chosen_val = chosen ? chosen_val : 0;
    chosen_tick = chosen ? chosen_tick : -1;
    violations = wrap_add(violations, extra_viol);
  }

  // Learner::observe on the table in the column.  An event folds where it
  // carries a ballot; a tick without one leaves the table as it is, and
  // the fold's other writes reduce to the scalars'.  A tick with one copies
  // the table to registers for the fold and back; returns whether it did.
  template <int A, int B, typename QuorumOf>
  __device__ __forceinline__ bool observe(const Column<B>& col, uint32_t ev_flag,
                                          const int32_t (&ev_bal)[A], const int32_t (&ev_val)[A],
                                          int32_t tick, int extra_viol, QuorumOf quorum_of) {
    uint32_t folds = 0;
#pragma unroll
    for (int a = 0; a < A; ++a) folds |= (((ev_flag >> a) & 1u) && ev_bal[a] > 0 ? 1u : 0u) << a;
    if (folds == 0) {
      quiet(extra_viol);
      return false;
    }
    Learner<K> lrn;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      lrn.bal[k] = col[ROW + k];
      lrn.val[k] = col[ROW + K + k];
      lrn.mask[k] = col[ROW + 2 * K + k];
    }
    lrn.chosen = chosen;
    lrn.chosen_val = chosen_val;
    lrn.chosen_tick = chosen_tick;
    lrn.violations = violations;
    lrn.evictions = evictions;
    lrn.template observe<A>(ev_flag, ev_bal, ev_val, tick, extra_viol, quorum_of);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      col[ROW + k] = lrn.bal[k];
      col[ROW + K + k] = lrn.val[k];
      col[ROW + 2 * K + k] = lrn.mask[k];
    }
    chosen = lrn.chosen;
    chosen_val = lrn.chosen_val;
    chosen_tick = lrn.chosen_tick;
    violations = lrn.violations;
    evictions = lrn.evictions;
    return true;
  }
};

// ---- The gray-failure and partition arms of K1 to K3 and K5 (Gray): what
// an arms instantiation does at each site of the tick, where the default
// instantiations compile none of it (ARMS false).  Messages on edge e = p
// * A + a; a buffer's slot j is on edge j % E.  The stream ids default to
// the single-decree ones; K5 passes Multi-Paxos'. ----

// A lane's partition window, the links that cross its cut, the cut's
// direction and the proposers' timeout skew, read once a chunk.
template <int P, int A>
struct GrayLane {
  static constexpr int E = P * A;
  int32_t part_start = kInt32Max, part_end = kInt32Max, part_dir = 0;
  uint32_t cross = 0;  // bit e: proposer and acceptor of edge e on opposite sides
  int32_t ptimeout[P];

  __device__ __forceinline__ void load(const Gray& gray, int64_t n, int64_t i) {
#pragma unroll
    for (int p = 0; p < P; ++p) ptimeout[p] = 0;
    if (gray.partition) {
      part_start = gray.part_start[i];
      part_end = gray.part_end[i];
      if (gray.asym) part_dir = gray.part_dir[i];
#pragma unroll
      for (int e = 0; e < E; ++e)
        cross |= (gray.pside[(e / A) * n + i] != gray.aside[(e % A) * n + i] ? 1u : 0u) << e;
    }
    if (gray.timeout_skew) {
#pragma unroll
      for (int p = 0; p < P; ++p) ptimeout[p] = gray.ptimeout[p * n + i];
    }
  }

  // The edges cut at `tick`, per direction (bit e): a message on a cut
  // edge stays in flight.  part_dir 1 cuts requests only, 2 replies only.
  __device__ __forceinline__ void cuts(int32_t tick, uint32_t& cut_req, uint32_t& cut_rep) const {
    cut_req = cut_rep = 0;
    if (part_start <= tick && tick < part_end) {
      cut_req = part_dir != 2 ? cross : 0;
      cut_rep = part_dir != 1 ? cross : 0;
    }
  }

  // Proposer p's timeout with its skew (0 without timeout_skew).
  __device__ __forceinline__ int32_t timeout(int32_t base, int p) const {
    return wrap_add(base, ptimeout[p]);
  }
};

// Proposer p's backoff draw `backoff`, times the plan's multiplier under
// backoff_skew.
template <bool ARMS>
__device__ __forceinline__ uint32_t skewed_backoff(uint32_t backoff, const Gray& gray, int p,
                                                   int64_t n, int64_t i) {
  if (ARMS && gray.backoff_skew) backoff *= static_cast<uint32_t>(gray.pboff[p * n + i]);
  return backoff;
}

// Proposer p's backoff from its draw `r` (BACKOFF's bits, sign masked):
// r mod backoff_n, times the plan's multiplier under backoff_skew.
template <bool ARMS>
__device__ __forceinline__ int32_t backoff_of(uint32_t r, const Params& prm, const Gray& gray,
                                              int p, int64_t n, int64_t i) {
  return -static_cast<int32_t>(
      skewed_backoff<ARMS>(r % static_cast<uint32_t>(prm.backoff_n), gray, p, n, i));
}

// Whether a message of kind `kind` (0 PROMISE / VOTE, 1 ACCEPTED / ACK, 2
// PREPARE / REQVOTE, 3 ACCEPT / APPEND: LINK_BITS' axis) sent on edge e is
// kept: on a flaky link against the link's own drop threshold (LINK, the
// protocol's LINK_BITS stream), else the uniform p_drop mask of `stream`.
template <bool ARMS, int E, uint32_t LINK = kLinkBits>
__device__ __forceinline__ bool kept(const TickStream& ts, const Params& prm, const Gray& gray,
                                     uint32_t stream, int kind, int e, int64_t n, int64_t i) {
  if (ARMS && gray.flaky) return !ts.below_at(gray.link_drop[e * n + i], LINK, kind * E + e);
  return ts.survives_at(prm.drop, stream, e);
}

// Whether duplication is live: the flaky links' dup thresholds, or p_dup.
template <bool ARMS>
__device__ __forceinline__ bool dup_live(const Params& prm, const Gray& gray) {
  if (ARMS && gray.flaky) return gray.flaky_dup != 0;
  return prm.dup.mode != 0;
}

// Whether slot j of buffer `buf` (0 requests, selected; 1 replies,
// delivered) is duplicated, so that it stays: on a flaky link against the
// link's own dup threshold (DUP, the protocol's DUP_BITS stream), else the
// uniform p_dup mask of `stream`.  Call only where dup_live.
template <bool ARMS, int S, int E, uint32_t DUP = kDupBits>
__device__ __forceinline__ bool duplicated(const TickStream& ts, const Params& prm,
                                           const Gray& gray, uint32_t stream, int buf, int j,
                                           int64_t n, int64_t i) {
  if (ARMS && gray.flaky) return ts.below_at(gray.link_dup[(j % E) * n + i], DUP, buf * S + j);
  return ts.fires_at(prm.dup, stream, j);
}

// Payload corruption (p_corrupt) of the request acceptor a processes this
// tick, drawn only there (CORRUPT, the protocol's stream): a kind-1
// request's v1 (an ACCEPT's or APPEND's value) flips a bit, a kind-0
// request's ballot (a PREPARE's or REQVOTE's) moves up one.
template <bool ARMS, uint32_t CORRUPT = kCorrupt>
__device__ __forceinline__ void corrupt(const TickStream& ts, const Gray& gray, int a,
                                        bool kind1, int32_t& mb, int32_t& mv) {
  if (ARMS && gray.corrupt.mode != 0 && ts.fires_at(gray.corrupt, CORRUPT, a)) {
    if (kind1) mv ^= 64;
    else mb = wrap_add(mb, 1);
  }
}

// Stale-snapshot recovery (stale_k) or amnesia at `tick`, before the
// acceptor half-tick: an acceptor (voter) recovering this tick (its crash
// ends at `tick`) restores its durable fields from their snapshot shadows
// in global memory (`restore(a)`), or forgets them (`forget(a)`), and on a
// snapshot tick every acceptor's shadows take its fields after the restore
// (`snapshot(a)`).  The shadows are read on a recovery tick and written on
// a snapshot tick only.
template <bool ARMS, int A, typename Restore, typename Snapshot, typename Forget>
__device__ __forceinline__ void recover_with(const Gray& gray, int32_t tick,
                                             const int32_t (&crash_end)[A], Restore restore,
                                             Snapshot snapshot, Forget forget) {
  if constexpr (ARMS) {
    if (gray.stale_k > 0) {
      const bool snap = floor_mod(tick, gray.stale_k) == 0;
#pragma unroll
      for (int a = 0; a < A; ++a) {
        if (crash_end[a] == tick) restore(a);
        if (snap) snapshot(a);
      }
    } else if (gray.amnesia) {
#pragma unroll
      for (int a = 0; a < A; ++a)
        if (crash_end[a] == tick) forget(a);
    }
  }
}

// recover_with for K1 to K3: an acceptor's three durable fields f0, f1, f2
// and their shadows (SnapLeaf); `restored(a)` follows each restore.
template <bool ARMS, int A, typename Restored>
__device__ __forceinline__ void recover(const Gray& gray, const Leaves& L, int32_t tick,
                                        const int32_t (&crash_end)[A], int32_t (&f0)[A],
                                        int32_t (&f1)[A], int32_t (&f2)[A], int64_t n, int64_t i,
                                        Restored restored) {
  recover_with<ARMS, A>(
      gray, tick, crash_end,
      [&](int a) {
        f0[a] = load<int32_t>(L, kSnap0, a, n, i);
        f1[a] = load<int32_t>(L, kSnap1, a, n, i);
        f2[a] = load<int32_t>(L, kSnap2, a, n, i);
        restored(a);
      },
      [&](int a) {
        store<int32_t>(L, kSnap0, a, n, i, f0[a]);
        store<int32_t>(L, kSnap1, a, n, i, f1[a]);
        store<int32_t>(L, kSnap2, a, n, i, f2[a]);
      },
      [&](int a) {
        f0[a] = f1[a] = f2[a] = 0;
        restored(a);
      });
}

}  // namespace sd

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

#ifdef FUSED_PHASE_CLOCKS
// Copies the per-phase cycle sums of the launches since the last call to
// out[0..kMaxPhases) (fused_draws' signature; a kernel with fewer phases
// leaves the rest 0) and clears them; call after the launches are
// complete.  Returns a cudaError_t.
extern "C" int fused_phase_clocks(unsigned long long* out) {
  const unsigned long long zero[kMaxPhases] = {};
  cudaError_t rc = cudaMemcpyFromSymbol(out, g_phase, sizeof(zero));
  if (rc == cudaSuccess) rc = cudaMemcpyToSymbol(g_phase, zero, sizeof(zero));
  return rc;
}
#endif
