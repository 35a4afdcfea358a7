// Shared pieces of the fused engine's kernels (fused_<protocol>_tick.cu):
// the counter PRNG, the Bernoulli knobs, the state-leaf, plan and parameter
// layouts of the C entry points, the learner table that the single-decree
// ticks have in common, the shared-memory column and launch of the kernels
// that keep one per lane, the rolled selection, fenced row copy, message
// column, column learner and bounded-delay channel of the single-decree
// kernels and the pieces of the gray-failure and partition arms of K1 to
// K5 (namespace sd), and the phase clocks.
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
// elements it touches (Multi-Paxos its slot arrays, every kernel its delay
// stamps), for the same reason.  The timed build compiles none of it.
//
// Semantics follow the plain PyTorch version bit for bit:
//  - random bits are uint32 (wrapping mul/add, logical shifts); Bernoulli
//    masks are unsigned compares against host-rounded thresholds;
//  - lane i draws from stream seed mix(seed, tick, blk0 + i / block), and a
//    mask element (prefix..., i) hashes position prefix * block + i % block,
//    where `block` is the stream block (not the CUDA block size).

#pragma once

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

namespace {

constexpr int kLeaves = 28;        // state leaves of a single-decree protocol, tick excluded
constexpr int kStampedLeaves = 30;  // the same with the two buffers' delay stamps
constexpr int kMaxLeaves = 34;     // room for every protocol's leaves, stamps and shadows
constexpr int kParams = 37;
constexpr int kPlanLeaves = 15;
constexpr int32_t kInt32Max = 2147483647;
constexpr int32_t kInt32Min = -2147483647 - 1;
constexpr int32_t kBallotLimit = (1 << 15) - 1;  // report-time ballot limit
constexpr int kMaxProposers = 8;                 // core/ballot.py

// The ablated builds of K1 and K5 (nvcc -DFUSED_ABLATE=<bitmask>,
// fused_tick.ablate_defines): the tick without the components whose bits
// are set, in fused_tick.ABLATE_FLAGS' order, each removed at compile
// time (`if constexpr`, or a condition that folds to a constant): the
// counter-PRNG draws (constant masks: every score the lane's in-block
// index, no idling, hold, duplication or drop, a 0 backoff and jitter),
// the acceptors' selection, every send, the consume of delivered and
// selected messages, the learner with the acceptor invariants, the
// proposers.  Such a build instantiates config2's or config3's key only
// and is not the protocol.  Every other build sets no bit, and compiles
// none of it.
#ifdef FUSED_ABLATE
constexpr int kAblate = FUSED_ABLATE;
#else
constexpr int kAblate = 0;
#endif
constexpr int kNoPrng = 1, kNoSelect = 2, kNoSends = 4, kNoConsume = 8, kNoLearner = 16,
              kNoProposer = 32;
__host__ __device__ constexpr bool ablated(int flag) { return (kAblate & flag) != 0; }

// Stream ids (core/streams.py).
constexpr uint32_t kSel = 0, kBusy = 1, kDeliver = 2, kDupReq = 3,
                   kDupRep = 4, kKeepProm = 5, kKeepAccd = 6, kKeepP1 = 7,
                   kKeepP2 = 8, kBackoff = 9, kLinkBits = 10, kDupBits = 11,
                   kCorrupt = 12, kDelayBits = 13, kLatBits = 14, kArrival = 15;

// The leaves every single-decree protocol shares, in flatten order after
// its 12 role leaves (3 acceptor, 9 proposer): learner, requests, replies.
// A state with delay stamps has each buffer's `until` after its four
// leaves; its entry point moves the two stamp leaves last (move_last, at
// kSdStampAt), so these indices hold for both layouts.
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
  const int32_t* link_delay;    // (P, A, I) per-link latency cap (p_delay), or null
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

// The gray-failure and partition arms of K1 to K5 (fused_paxos_tick.cu,
// fused_fastpaxos_tick.cu, fused_raftcore_tick.cu, fused_synchpaxos_tick.cu,
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

// A single-decree state with snapshot shadows (stale_k > 0) arrives with
// them after the three acceptor (voter) leaves, in flatten order; its entry
// point moves them after the state's other leaves (move_snapshots_last), so
// that SharedLeaf's indices hold, and the shadows of the three durable
// fields are at kSnap0 + 0..2: kLeaves, or kStampedLeaves in a state with
// delay stamps.  A Multi-Paxos state carries two, after its two acceptor
// leaves, moved after its own leaves alike.
constexpr int kSnap0 = kLeaves;
constexpr int kMaxSnaps = 3;

// Moves the n_snaps shadow leaves at index `at` after the state's other
// n_base leaves.
void move_snapshots_last(Leaves* L, int n_base = kLeaves, int at = 3, int n_snaps = 3) {
  void* snaps[kMaxSnaps];
  for (int k = 0; k < n_snaps; ++k) snaps[k] = L->p[at + k];
  for (int j = at; j < n_base; ++j) L->p[j] = L->p[j + n_snaps];
  for (int k = 0; k < n_snaps; ++k) L->p[n_base + k] = snaps[k];
}

// Moves the N leaves at the ascending indices `at` of the first n after the
// others, in their order.
template <int N>
void move_last(Leaves* L, int n, const int (&at)[N]) {
  void* moved[N];
  int k = 0, w = 0;
  for (int j = 0; j < n; ++j) {
    if (k < N && j == at[k]) moved[k++] = L->p[j];
    else L->p[w++] = L->p[j];
  }
  for (k = 0; k < N; ++k) L->p[w++] = moved[k];
}

// Where a stamped single-decree state's two stamp leaves arrive in flatten
// order: each buffer's `until` after its four leaves (requests, replies).
constexpr int kSdStampAt[2] = {kRqBal + 4, kRpUntil};

// read_args for a kernel with an arms instantiation (K1 to K5): the
// state's leaves are n_base (K1 to K4: kLeaves), plus the delay stamps
// where `stamped`, which arrive at the N indices `stamp_at` (K1 to K4:
// kSdStampAt), plus n_snaps snapshot shadows at index `at`, which move
// after the rest, then the stamps last (move_last); `arms` is the
// instantiation the wrapper picked, which must be the arms' exactly when a
// knob of theirs is on, stale_k needs the shadows, and p_delay a stamped
// instantiation.  Returns cudaSuccess or cudaErrorInvalidValue.
template <int N = 2>
cudaError_t read_gray_args(bool arms, void** leaves, int n_leaves, void** plan,
                           const long long* params, int n_params, Leaves* L, Plan* pl,
                           Params* prm, Gray* gray, int n_base = kLeaves, int at = 3,
                           int n_snaps = 3, bool stamped = false,
                           const int (&stamp_at)[N] = kSdStampAt) {
  if (n_snaps > kMaxSnaps) return cudaErrorInvalidValue;
  const int n_state = n_base + (stamped ? N : 0);
  const bool snapshots = n_leaves == n_state + n_snaps;
  const cudaError_t bad = read_args(leaves, n_leaves, snapshots ? n_state + n_snaps : n_state,
                                    plan, params, n_params, L, pl, prm, stamped, gray);
  if (bad != cudaSuccess) return bad;
  if (gray->on() != arms || (gray->stale_k > 0 && !snapshots)) return cudaErrorInvalidValue;
  if (snapshots) move_snapshots_last(L, n_state, at, n_snaps);
  if (stamped) move_last(L, n_state, stamp_at);
  return cudaSuccess;
}

// Whether the trailing arguments of a kernel (its instantiation's pack:
// none, a Gray, an obs::Obs, or both) hold one of type T, and that
// argument (a zero T where there is none).
template <typename T, typename... Ts>
constexpr bool has_arg = (std::is_same_v<T, Ts> || ...);

template <typename T, typename X>
__device__ __forceinline__ void take_arg(T& out, const X& x) {
  if constexpr (std::is_same_v<T, X>) out = x;
}

template <typename T, typename... Ts>
__device__ __forceinline__ T pick_arg(const Ts&... xs) {
  T out{};
  (take_arg(out, xs), ...);
  return out;
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
constexpr int kMaxPhases = 9;  // fused_tick.PHASE_SLOTS

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

// The request acceptor a selects where every score is the same (a tick
// ablated of its PRNG draws, every score the lane's in-block index): the
// plain select_from_scores puts the slot id kp in a score's low bits, so
// the present slot with the highest kp wins, or -1 where none is present.
template <int P, int A>
__device__ __forceinline__ int select_last(uint32_t present, int a) {
  int win = -1;
#pragma unroll
  for (int kp = 0; kp < 2 * P; ++kp)
    if ((present >> (kp * A + a)) & 1u) win = kp;
  return win;
}

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

// A single-decree lane's staged rows, in column order (mirrored by
// fused_tick.FR_STAGED_LEAVES and SP_STAGED_LEAVES).  Slot j = (kind * P +
// p) * A + a of a buffer, E = P * A slots a kind.  A request's v1 is staged
// for every slot where RV_V1 (Raft-core: a REQVOTE carries the candidate's
// entry term), else for the kind-1 slots only; a reply's v2 for the kind-0
// slots only (row j); both buffers' delay stamps where STAMPED (Paxos and
// SynchPaxos with p_delay).  The words the tick only ever writes as 0 get
// no row (fused_tick.FR_ZERO_WORDS, SP_ZERO_WORDS).
template <int P, int A, int K, bool RV_V1, bool STAMPED = false>
struct SdStaged {
  static constexpr int S = 2 * P * A, E = P * A;
  static constexpr int kRqV1From = RV_V1 ? 0 : E;     // the first slot whose v1 is staged
  static constexpr int kRqBal = 0;                     // requests.bal (2, P, A)
  static constexpr int kRqV1 = kRqBal + S;             // requests.v1 from slot kRqV1From
  static constexpr int kRpBal = kRqV1 + S - kRqV1From;  // replies.bal (2, P, A)
  static constexpr int kRpV1 = kRpBal + S;             // replies.v1 (2, P, A)
  static constexpr int kRpV2 = kRpV1 + S;              // replies.v2, kind 0
  static constexpr int kRqUntil = kRpV2 + E;                     // requests.until, if STAMPED
  static constexpr int kRpUntil = kRqUntil + (STAMPED ? S : 0);  // replies.until, if STAMPED
  static constexpr int kLtBal = kRpUntil + (STAMPED ? S : 0);    // learner.lt_bal (K)
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
template <int P, int A, int K, bool RV_V1, int UNROLL, int B, bool STAMPED = false>
__device__ __forceinline__ void load_column(const Column<B>& col, const Leaves& L, int64_t n,
                                            int64_t i) {
  using G = SdStaged<P, A, K, RV_V1, STAMPED>;
  load_rows<G::S, 0, G::kRqBal, UNROLL>(col, L, kRqBal, n, i);
  load_rows<G::S - G::kRqV1From, G::kRqV1From, G::kRqV1, UNROLL>(col, L, kRqV1, n, i);
  load_rows<G::S, 0, G::kRpBal, UNROLL>(col, L, kRpBal, n, i);
  load_rows<G::S, 0, G::kRpV1, UNROLL>(col, L, kRpV1, n, i);
  load_rows<G::E, 0, G::kRpV2, UNROLL>(col, L, kRpV2, n, i);
  if constexpr (STAMPED) {
    load_rows<G::S, 0, G::kRqUntil, UNROLL>(col, L, kRqUntil, n, i);
    load_rows<G::S, 0, G::kRpUntil, UNROLL>(col, L, kRpUntil, n, i);
  }
  load_rows<K, 0, G::kLtBal, UNROLL>(col, L, kLtBal, n, i);
  load_rows<K, 0, G::kLtVal, UNROLL>(col, L, kLtVal, n, i);
  load_rows<K, 0, G::kLtMask, UNROLL>(col, L, kLtMask, n, i);
}

// The column at the end of the chunk: the slots of each buffer that the
// chunk wrote (bitmasks rq_written, rp_written) with their zero-only words
// as 0 and their stamps where STAMPED, and the learner table if an accept
// event reached it.
template <int P, int A, int K, bool RV_V1, int B, bool STAMPED = false>
__device__ __forceinline__ void store_column(const Column<B>& col, const Leaves& L, int64_t n,
                                             int64_t i, uint32_t rq_written, uint32_t rp_written,
                                             bool lt_written) {
  using G = SdStaged<P, A, K, RV_V1, STAMPED>;
  for (uint32_t m = rq_written; m != 0; m &= m - 1) {
    const int j = __ffs(m) - 1;
    store<int32_t>(L, kRqBal, j, n, i, col[G::kRqBal + j]);
    store<int32_t>(L, kRqV1, j, n, i, j >= G::kRqV1From ? col[G::rq_v1(j)] : 0);
    store<int32_t>(L, kRqV2, j, n, i, 0);
    if constexpr (STAMPED) store<int32_t>(L, kRqUntil, j, n, i, col[G::kRqUntil + j]);
  }
  for (uint32_t m = rp_written; m != 0; m &= m - 1) {
    const int j = __ffs(m) - 1;
    store<int32_t>(L, kRpBal, j, n, i, col[G::kRpBal + j]);
    store<int32_t>(L, kRpV1, j, n, i, col[G::kRpV1 + j]);
    store<int32_t>(L, kRpV2, j, n, i, j < G::E ? col[G::kRpV2 + j] : 0);
    if constexpr (STAMPED) store<int32_t>(L, kRpUntil, j, n, i, col[G::kRpUntil + j]);
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

// The bounded-delay channel of a lane (transport.ready / send(until=) and
// protocols.paxos.delay_stamps) over the stamps in its column, the 2PA
// request stamps from row RQ_ROW and the 2PA reply stamps from row RP_ROW
// (SdStaged with STAMPED in the stamped instantiations of K1 to K4; K5's
// column, whose reply stamps are its PROMISEs' then its ACCEPTEDs'): per
// buffer a bitmask of the slots whose stamp is still ahead of the tick, and
// the earliest such stamp; a slot is ready (deliverable, selectable) where
// its bit is clear.  The plan's latency caps are read once as the links
// whose cap is above 0 (`slow`, the only links a send can be delayed on),
// and a cap again only where a send on its link is delayed.  Every stamp
// read or written counts as a touch.  The stamp draws of a request of kind
// k sit at kind REQ_KIND + k of the draws' kind axis, those of a reply at
// 2 - REQ_KIND + k (the single-decree ticks: requests first; Multi-Paxos:
// replies first), on the streams DELAY and LAT.
template <int P, int A, int B, int RQ_ROW, int RP_ROW, uint32_t DELAY = kDelayBits,
          uint32_t LAT = kLatBits, int REQ_KIND = 0>
struct Channel {
  struct G {
    static constexpr int S = 2 * P * A, E = P * A, kRqUntil = RQ_ROW, kRpUntil = RP_ROW;
  };
  uint32_t rq_wait = 0, rp_wait = 0;
  int32_t next_due = kInt32Max;  // earliest stamp of a waiting slot; kInt32Max if none
  uint32_t slow = 0;

  __device__ __forceinline__ void load(const Column<B>& col, const Params& prm, const Plan& plan,
                                       int64_t n, int64_t i, int32_t tick) {
#pragma unroll
    for (int j = 0; j < G::S; ++j) {
      const int32_t uq = col[G::kRqUntil + j], up = col[G::kRpUntil + j];
      if (uq > tick) {
        rq_wait |= 1u << j;
        next_due = min(next_due, uq);
      }
      if (up > tick) {
        rp_wait |= 1u << j;
        next_due = min(next_due, up);
      }
    }
    if (prm.delay.mode == 0) return;
#pragma unroll
    for (int e = 0; e < G::E; ++e) slow |= (plan.link_delay[e * n + i] > 0 ? 1u : 0u) << e;
  }

  // At the start of tick `tick` (readiness is tick >= until): release the
  // waiting slots whose stamp has come.
  __device__ __forceinline__ void refresh(const Column<B>& col, int32_t tick, DrawCount* draws) {
    if (tick < next_due) return;
    next_due = kInt32Max;
    for (uint32_t m = rq_wait; m != 0; m &= m - 1) {
      const int j = __ffs(m) - 1;
      draws->touch(1);
      const int32_t u = col[G::kRqUntil + j];
      if (u > tick) next_due = min(next_due, u); else rq_wait &= ~(1u << j);
    }
    for (uint32_t m = rp_wait; m != 0; m &= m - 1) {
      const int j = __ffs(m) - 1;
      draws->touch(1);
      const int32_t u = col[G::kRpUntil + j];
      if (u > tick) next_due = min(next_due, u); else rp_wait &= ~(1u << j);
    }
  }

  // The delay stamp of a send on edge (p, a) at `tick` (delay_stamps): kind
  // `kind` of direction `dir` (0 requests, 1 replies) draws at prefix
  // (axis kind * P + p) * A + a (the axis kind: REQ_KIND + kind for a
  // request, 2 - REQ_KIND + kind for a reply).  tick + 1 + min(latency, cap)
  // where the link is slow and the delay draw fires, else 0; the latency is
  // 1 + (bits & 0x7FFFFFFF) % delay_max.  A link that never delays draws
  // nothing: its stamp is 0 whatever the draws.
  // PRE: the delay draws of the tick were made already (an observed
  // instantiation's exposure census), bit `pos` of `fired` each.
  template <bool PRE = false>
  __device__ __forceinline__ int32_t stamp(const Params& prm, const Plan& plan,
                                           const TickStream& ts, int dir, int kind, int p, int a,
                                           int64_t n, int64_t i, int32_t tick,
                                           uint64_t fired = 0) const {
    const int e = p * A + a;
    if (prm.delay.mode == 0 || !((slow >> e) & 1u)) return 0;
    const int pos = (((dir == 0 ? REQ_KIND : 2 - REQ_KIND) + kind) * P + p) * A + a;
    if (PRE ? !((fired >> pos) & 1u) : ts.bits(DELAY, pos) >= prm.delay.thr) return 0;
    const uint32_t lat =
        1u + (ts.bits(LAT, pos) & 0x7FFFFFFFu) % static_cast<uint32_t>(prm.delay_max);
    const int32_t cap = plan.link_delay[e * n + i];
    return wrap_add(wrap_add(tick, 1), min(static_cast<int32_t>(lat), cap));
  }

  // The slots `sent` of direction `dir`'s buffer (stamps from row `row`,
  // G::kRqUntil or G::kRpUntil; waiting slots `wait`), written at `tick`:
  // each gets its stamp (0: deliverable at once).  The stamp draws are keyed
  // by the slot, so one rolled loop serves every send site of a buffer.
  template <bool PRE = false>
  __device__ __forceinline__ void stamp_sends(const Column<B>& col, int row, uint32_t& wait,
                                              int dir, uint32_t sent, const Params& prm,
                                              const Plan& plan, const TickStream& ts, int64_t n,
                                              int64_t i, int32_t tick, DrawCount* draws,
                                              uint64_t fired = 0) {
    for (uint32_t m = sent; m != 0; m &= m - 1) {
      const int j = __ffs(m) - 1;
      const int e = j % G::E;
      const int32_t u =
          stamp<PRE>(prm, plan, ts, dir, j / G::E, e / A, e % A, n, i, tick, fired);
      draws->touch(1);
      col[row + j] = u;
      if (u > tick) {
        wait |= 1u << j;
        next_due = min(next_due, u);
      } else {
        wait &= ~(1u << j);
      }
    }
  }
};

// ---- The gray-failure and partition arms of K1 to K5 (Gray): what
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

// recover_with for K1 to K4: an acceptor's three durable fields f0, f1, f2
// and their shadows at leaves SNAP + 0..2 (kSnap0, or kStampedLeaves in a
// stamped state); `restored(a)` follows each restore.
template <bool ARMS, int A, int SNAP = kSnap0, typename Restored>
__device__ __forceinline__ void recover(const Gray& gray, const Leaves& L, int32_t tick,
                                        const int32_t (&crash_end)[A], int32_t (&f0)[A],
                                        int32_t (&f1)[A], int32_t (&f2)[A], int64_t n, int64_t i,
                                        Restored restored) {
  recover_with<ARMS, A>(
      gray, tick, crash_end,
      [&](int a) {
        f0[a] = load<int32_t>(L, SNAP, a, n, i);
        f1[a] = load<int32_t>(L, SNAP + 1, a, n, i);
        f2[a] = load<int32_t>(L, SNAP + 2, a, n, i);
        restored(a);
      },
      [&](int a) {
        store<int32_t>(L, SNAP, a, n, i, f0[a]);
        store<int32_t>(L, SNAP + 1, a, n, i, f1[a]);
        store<int32_t>(L, SNAP + 2, a, n, i, f2[a]);
      },
      [&](int a) {
        f0[a] = f1[a] = f2[a] = 0;
        restored(a);
      });
}

}  // namespace sd

// ---- The observer planes (core/telemetry.py, obs/coverage.py,
// obs/exposure.py, obs/margin.py, workload/generator.py): what an observed
// instantiation (of any of K1 to K5) computes beside the tick.  Every plane is switched
// by whether its leaves were passed (Obs), a branch the whole warp takes
// alike.  A lane's counters sit in its column from row R0 on (Rows), the
// rest of a plane (the event ring and histogram, the coverage bitmap, the
// client queue's stamps and histogram) in global memory at [row * n + i].
// None of it draws but the client arrivals (ARRIVAL). ----
namespace obs {

constexpr int kEvents = 12;    // core/telemetry.py EVENTS
constexpr int kClasses = 7;    // obs/exposure.py CLASSES
constexpr int kWlClasses = 3;  // workload/generator.py CLASSES
constexpr int kLeaves = 23;    // the observer leaves Obs takes
constexpr int kParams = 13;    // and its sizes and flags
constexpr int32_t kSentinel = 0x7FFFFFFF;  // obs/margin.py SENTINEL
constexpr int kEventShift = 16;  // a ring word: events << 16 | (tick & 0xFFFF)

enum Event {
  kEvPromise, kEvAccept, kEvDecide, kEvConflict, kEvLeader, kEvTimeout, kEvDrop, kEvDup,
  kEvCorrupt, kEvPartCut, kEvPartHeal, kEvRecover,
};
enum Class { kClDrop, kClDup, kClCorrupt, kClPartition, kClTimeout, kClStale, kClDelay };

// The observer leaves in the state's flatten order, each null where its
// plane (or the ring, the histogram) is off.
enum Leaf {
  kTelCounters, kTelRing, kTelCursor, kTelSeq, kTelHist, kCovBitmap, kCovNewBits,
  kExpInjected, kExpEffective, kMarQslack, kMarNear, kMarGap, kMarPslack,
  kWlMode, kWlPhase, kWlRing, kWlHead, kWlDepth, kWlPeak, kWlOffered, kWlDone, kWlShed,
  kWlHist,
};

struct Obs {
  int32_t* p[kLeaves];
  int32_t ring_depth, tel_bins, cov_words;
  int32_t wl_cap, wl_bins, wl_period, wl_burst_len;
  uint32_t wl_t_lo, wl_t_hi;
  int32_t wl_step;
  int32_t rec_acc, rec_prop;  // telemetry's recover events: p_crash > 0, p_crash_prop > 0
  int32_t snaps;              // the state carries snapshot shadows (the digest folds them)

  __host__ __device__ bool tel() const { return p[kTelCounters] != nullptr; }
  __host__ __device__ bool cov() const { return p[kCovBitmap] != nullptr; }
  __host__ __device__ bool exp() const { return p[kExpInjected] != nullptr; }
  __host__ __device__ bool mar() const { return p[kMarQslack] != nullptr; }
  __host__ __device__ bool wl() const { return p[kWlMode] != nullptr; }
};

// Unpack the observer arguments: kLeaves leaf pointers (null where off)
// and kParams integers (fused_tick._obs_args: ring depth, telemetry
// histogram bins, coverage words, the workload's cap, bins, period, burst,
// low and high thresholds and diurnal step, the two recover flags, and
// whether the state carries snapshot shadows).  A wrong count, a plane
// whose leaves are passed in part, a size that does not fit its leaves
// or no plane at all is cudaErrorInvalidValue.
inline cudaError_t read_obs_args(void** leaves, int n_leaves, const long long* params,
                                 int n_params, Obs* o) {
  if (leaves == nullptr || params == nullptr || n_leaves != kLeaves || n_params != kParams)
    return cudaErrorInvalidValue;
  for (int j = 0; j < kLeaves; ++j) o->p[j] = static_cast<int32_t*>(leaves[j]);
  const auto v = [&](int k) { return static_cast<int32_t>(params[k]); };
  o->ring_depth = v(0);
  o->tel_bins = v(1);
  o->cov_words = v(2);
  o->wl_cap = v(3);
  o->wl_bins = v(4);
  o->wl_period = v(5);
  o->wl_burst_len = v(6);
  o->wl_t_lo = static_cast<uint32_t>(params[7]);
  o->wl_t_hi = static_cast<uint32_t>(params[8]);
  o->wl_step = v(9);
  o->rec_acc = v(10);
  o->rec_prop = v(11);
  o->snaps = v(12);
  const auto all = [&](int from, int to, bool on) {
    for (int j = from; j < to; ++j)
      if ((o->p[j] != nullptr) != on) return false;
    return true;
  };
  const bool tel = o->tel(), ring = o->p[kTelRing] != nullptr, hist = o->p[kTelHist] != nullptr;
  if (!(all(kTelCounters, kTelCounters + 1, tel) && all(kTelRing, kTelSeq + 1, ring) &&
        (tel || (!ring && !hist)) && (ring == (o->ring_depth > 0)) &&
        (hist == (o->tel_bins > 0)) && o->ring_depth >= 0 && o->tel_bins >= 0))
    return cudaErrorInvalidValue;
  if (!all(kCovBitmap, kCovNewBits + 1, o->cov()) ||
      (o->cov() != (o->cov_words > 0)) || (o->cov_words & (o->cov_words - 1)) != 0)
    return cudaErrorInvalidValue;
  if (!all(kExpInjected, kExpEffective + 1, o->exp()) || !all(kMarQslack, kMarPslack + 1, o->mar()))
    return cudaErrorInvalidValue;
  if (!all(kWlMode, kWlHist + 1, o->wl())) return cudaErrorInvalidValue;
  if (o->wl() && (o->wl_cap < 1 || o->wl_cap > 64 || o->wl_bins < 2 || o->wl_bins > 24 ||
                  o->wl_period < 2 || o->wl_burst_len < 1 || o->wl_burst_len > o->wl_period))
    return cudaErrorInvalidValue;
  if (!(o->tel() || o->cov() || o->exp() || o->mar() || o->wl())) return cudaErrorInvalidValue;
  return cudaSuccess;
}

// A lane's counters in its column, from row R0 on: the event counters,
// the ring's cursor and word count, exposure's injected and effective
// counts, the four margins, coverage's new bits, and the client queue's
// eight fields a proposer (mode, phase, head, depth, depth_peak, offered,
// done, shed; field f of proposer p at kWl + f * P + p).
template <int P>
struct Rows {
  static constexpr int kTel = 0, kCursor = kEvents, kSeq = kCursor + 1, kInj = kSeq + 1,
                       kEff = kInj + kClasses, kMar = kEff + kClasses, kNewBits = kMar + 4,
                       kWl = kNewBits + 1, kRows = kWl + 8 * P;
};
// The leaf of the client queue's field f (the ring, leaf kWlRing, sits
// between the phase and the head).
__host__ __device__ constexpr int wl_column_leaf(int f) { return f < 2 ? kWlMode + f : kWlHead + f - 2; }

// The counters of the planes that are on, between global memory and the
// column (to_column: at the start of a chunk; else at its end).
template <int P, int R0, int B>
__device__ __forceinline__ void move_counters(const Column<B>& col, const Obs& o, int64_t n,
                                              int64_t i, bool to_column) {
  using Rw = Rows<P>;
  const auto mv = [&](int row, int32_t* g) {
    if (to_column) col[R0 + row] = g[i];
    else g[i] = col[R0 + row];
  };
  if (o.tel()) {
#pragma unroll 1
    for (int e = 0; e < kEvents; ++e) mv(Rw::kTel + e, o.p[kTelCounters] + e * n);
    if (o.ring_depth > 0) {
      mv(Rw::kCursor, o.p[kTelCursor]);
      mv(Rw::kSeq, o.p[kTelSeq]);
    }
  }
  if (o.exp()) {
#pragma unroll 1
    for (int c = 0; c < kClasses; ++c) {
      mv(Rw::kInj + c, o.p[kExpInjected] + c * n);
      mv(Rw::kEff + c, o.p[kExpEffective] + c * n);
    }
  }
  if (o.mar()) {
#pragma unroll
    for (int k = 0; k < 4; ++k) mv(Rw::kMar + k, o.p[kMarQslack + k]);
  }
  if (o.cov()) mv(Rw::kNewBits, o.p[kCovNewBits]);
  if (o.wl()) {  // unrolled: a leaf index known at compile time keeps Obs out of local memory
#pragma unroll
    for (int f = 0; f < 8; ++f)
#pragma unroll
      for (int p = 0; p < P; ++p) mv(Rw::kWl + f * P + p, o.p[wl_column_leaf(f)] + p * n);
  }
}

// telemetry.record: the tick's event counts into the counters, one ring
// word where any event happened (the OR of their bits with the tick), the
// decides into the latency histogram.
template <int P, int R0, int B>
__device__ __forceinline__ void telemetry(const Column<B>& col, const Obs& o, int32_t tick,
                                          const int (&c)[kEvents], int64_t n, int64_t i) {
  using Rw = Rows<P>;
  int32_t word_bits = 0;
#pragma unroll
  for (int e = 0; e < kEvents; ++e) {
    if (c[e] != 0) col[R0 + Rw::kTel + e] = wrap_add(col[R0 + Rw::kTel + e], c[e]);
    word_bits |= (c[e] > 0 ? 1 : 0) << e;
  }
  if (o.ring_depth > 0 && word_bits != 0) {
    const int32_t cur = col[R0 + Rw::kCursor];
    if (cur >= 0 && cur < o.ring_depth)
      o.p[kTelRing][static_cast<int64_t>(cur) * n + i] =
          (word_bits << kEventShift) | (tick & ((1 << kEventShift) - 1));
    col[R0 + Rw::kCursor] = cur + 1 >= o.ring_depth ? 0 : cur + 1;
    col[R0 + Rw::kSeq] = wrap_add(col[R0 + Rw::kSeq], 1);
  }
  if (o.tel_bins > 0 && c[kEvDecide] != 0) {
    const int32_t b = min(tick >> 3, o.tel_bins - 1);  // tick // kHistTicksPerBin, floored
    int32_t* h = o.p[kTelHist] + static_cast<int64_t>(b) * n + i;
    *h = wrap_add(*h, c[kEvDecide]);
  }
}

// exposure.record: the tick's injected and effective counts per class.
template <int P, int R0, int B>
__device__ __forceinline__ void exposure(const Column<B>& col, const int (&inj)[kClasses],
                                         const int (&eff)[kClasses]) {
  using Rw = Rows<P>;
#pragma unroll
  for (int c = 0; c < kClasses; ++c) {
    if (inj[c] != 0) col[R0 + Rw::kInj + c] = wrap_add(col[R0 + Rw::kInj + c], inj[c]);
    if (eff[c] != 0) col[R0 + Rw::kEff + c] = wrap_add(col[R0 + Rw::kEff + c], eff[c]);
  }
}

// check.safety.margin_observe over a single-decree learner table of K
// rows in the column from row LT (ballots, values, voter masks), each row
// at the quorum quorum_of(its ballot) (the learner's: Fast Paxos' fast
// quorum on a round-0 ballot), a decide edge `decided_now`, the chosen
// value, and the acceptors' (voters') post-tick fence (honest acceptors:
// bit a of `honest`).  Returns `near`, whether this tick is a near split
// (what a tick that changes none of it adds again).
template <int P, int R0, int K, int A, int LT, int B, typename QuorumOf>
__device__ __forceinline__ bool margin(const Column<B>& col, QuorumOf quorum_of, bool chosen,
                                       int32_t chosen_val, bool decided_now,
                                       const int32_t (&promised)[A], const int32_t (&acc_bal)[A],
                                       uint32_t honest) {
  using Rw = Rows<P>;
  int32_t tick_slack = kSentinel, vmin = kSentinel, vmax = 0, win_bal = 0, rival_bal = 0;
  int hot = 0;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int32_t bal = col[LT + k], val = col[LT + K + k];
    const int votes = __popc(static_cast<uint32_t>(col[LT + 2 * K + k]));
    const int32_t quorum = quorum_of(bal);
    const bool live = bal > 0;
    if (live && chosen && val != chosen_val) tick_slack = min(tick_slack, max(quorum - votes, 0));
    if (live && votes >= quorum - 1) {
      ++hot;
      vmin = min(vmin, val);
      vmax = max(vmax, val);
    }
    const bool win = votes >= quorum && live && val == chosen_val;
    if (win) win_bal = max(win_bal, bal);
    if (live && !win) rival_bal = max(rival_bal, bal);
  }
  const bool near = hot >= 2 && vmin != vmax;
  col[R0 + Rw::kMar] = min(col[R0 + Rw::kMar], tick_slack);
  if (near) col[R0 + Rw::kMar + 1] = wrap_add(col[R0 + Rw::kMar + 1], 1);
  if (decided_now && rival_bal > 0)
    col[R0 + Rw::kMar + 2] = min(col[R0 + Rw::kMar + 2], max(wrap_add(win_bal, -rival_bal), 0));
  int32_t pslack = kSentinel;
#pragma unroll
  for (int a = 0; a < A; ++a)
    if (((honest >> a) & 1u) && acc_bal[a] > 0) pslack = min(pslack, wrap_add(promised[a], -acc_bal[a]));
  col[R0 + Rw::kMar + 3] = min(col[R0 + Rw::kMar + 3], pslack);
  return near;
}

// check.mp_safety.mp_margin_observe: the margin lifted to a Multi-Paxos
// lane's (LOG, K) learner table in the column (packed (ballot, value)
// pairs from row LT_BV, a slot's K voter masks packed in one word from row
// LT_MASK, the chosen values from row CHOSEN_VAL), the chosen slots before
// (`chosen0`) and after (`chosen`) the tick, the acceptors' post-tick
// promise fence and, as its slack partner, each acceptor's highest
// accepted ballot over its log (from row LOG_ROW, (A, LOG)); honest
// acceptors: bit a of `honest`.
template <int P, int R0, int LOG, int K, int A, int LT_BV, int LT_MASK, int CHOSEN_VAL,
          int LOG_ROW, int B>
__device__ __forceinline__ void mp_margin(const Column<B>& col, uint32_t chosen, uint32_t chosen0,
                                          const int32_t (&promised)[A], uint32_t honest,
                                          int quorum) {
  using Rw = Rows<P>;
  int32_t tick_slack = kSentinel, tick_gap = kSentinel;
  bool near = false;
#pragma unroll 1
  for (int l = 0; l < LOG; ++l) {
    const bool ch = (chosen >> l) & 1u;
    const int32_t cv = col[CHOSEN_VAL + l];
    const uint32_t masks = static_cast<uint32_t>(col[LT_MASK + l]);
    int32_t vmin = kSentinel, vmax = 0, win_bal = 0, rival_bal = 0;
    int hot = 0;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int32_t bv = col[LT_BV + l * K + k];
      const int32_t bal = bv >> 16, val = bv & 0xFFFF;
      const int votes = __popc((masks >> (8 * k)) & 0xFFu);
      const bool live = bv > 0;
      if (live && ch && val != cv) tick_slack = min(tick_slack, max(quorum - votes, 0));
      if (live && votes >= quorum - 1) {
        ++hot;
        vmin = min(vmin, val);
        vmax = max(vmax, val);
      }
      const bool win = votes >= quorum && live && val == cv;
      if (win) win_bal = max(win_bal, bal);
      if (live && !win) rival_bal = max(rival_bal, bal);
    }
    near = near || (hot >= 2 && vmin != vmax);
    if (ch && !((chosen0 >> l) & 1u) && rival_bal > 0)
      tick_gap = min(tick_gap, max(wrap_add(win_bal, -rival_bal), 0));
  }
  col[R0 + Rw::kMar] = min(col[R0 + Rw::kMar], tick_slack);
  if (near) col[R0 + Rw::kMar + 1] = wrap_add(col[R0 + Rw::kMar + 1], 1);
  col[R0 + Rw::kMar + 2] = min(col[R0 + Rw::kMar + 2], tick_gap);
  int32_t pslack = kSentinel;
#pragma unroll 1
  for (int a = 0; a < A; ++a) {
    int32_t top = kInt32Min;
    for (int l = 0; l < LOG; ++l) top = max(top, col[LOG_ROW + a * LOG + l] >> 16);
    if (((honest >> a) & 1u) && top > 0) pslack = min(pslack, wrap_add(promised[a], -top));
  }
  col[R0 + Rw::kMar + 3] = min(col[R0 + Rw::kMar + 3], pslack);
}

// workload.observe for each proposer p: serve first (bit p of `serve`, the
// commit edge, pops the head stamp and banks its latency into the class's
// log2 histogram), then this tick's arrival (one draw of stream ARRIVAL,
// the protocol's, against the class's threshold) joins the queue or is
// shed.
template <int P, int R0, uint32_t ARRIVAL = kArrival, int B>
__device__ __forceinline__ void workload(const Column<B>& col, const Obs& o, const TickStream& ts,
                                         int32_t tick, uint32_t serve, int64_t n, int64_t i) {
  using Rw = Rows<P>;
  const int cap = o.wl_cap;
#pragma unroll 1
  for (int p = 0; p < P; ++p) {
    const auto f = [&](int field) -> int32_t& { return col[R0 + Rw::kWl + field * P + p]; };
    const int32_t mode = f(0);
    int32_t head = f(2), depth = f(3);
    if (((serve >> p) & 1u) && depth > 0) {
      const bool in_ring = head >= 0 && head < cap;
      const int32_t stamp =
          in_ring ? o.p[kWlRing][(static_cast<int64_t>(head) * P + p) * n + i] : 0;
      const int32_t latency = wrap_add(tick, -stamp);
      int32_t bucket = 0;
      for (int k = 1; k < o.wl_bins; ++k) bucket += latency >= (1 << k) ? 1 : 0;
      if (mode >= 0 && mode < kWlClasses) {
        int32_t* h = o.p[kWlHist] + static_cast<int64_t>(mode * o.wl_bins + bucket) * n + i;
        *h = wrap_add(*h, 1);
      }
      head = head + 1 >= cap ? head + 1 - cap : head + 1;
      depth -= 1;
      f(6) = wrap_add(f(6), 1);
    }
    // arrival_threshold: the class's uint32 threshold at this tick.
    const int32_t pos = floor_mod(wrap_add(tick, f(1)), o.wl_period);
    uint32_t thr = o.wl_t_lo;
    if (mode == 1 && pos < o.wl_burst_len) thr = o.wl_t_hi;
    if (mode == 2) {
      const int32_t tri = min(pos, o.wl_period - pos);
      thr = o.wl_t_lo + static_cast<uint32_t>(o.wl_step) * static_cast<uint32_t>(tri);
    }
    const bool arrival = ts.bits(ARRIVAL, p) < thr;
    if (arrival) {
      f(5) = wrap_add(f(5), 1);
      if (depth < cap) {
        const int32_t slot = head + depth >= cap ? head + depth - cap : head + depth;
        if (slot >= 0 && slot < cap) o.p[kWlRing][(static_cast<int64_t>(slot) * P + p) * n + i] = tick;
        depth += 1;
      } else {
        f(7) = wrap_add(f(7), 1);
      }
    }
    f(2) = head;
    f(3) = depth;
    f(4) = max(f(4), depth);
  }
}

// The coverage digest (obs/coverage.py lane_digest): an FNV-1a-style fold
// of the lane's state words in the reference's leaf order, then a
// splitmix32 finalizer; Bloom hash j of it (_hash_pos).
struct Digest {
  uint32_t h = 0x811C9DC5u;
  __device__ __forceinline__ void fold(int32_t x) {
    h = (h ^ static_cast<uint32_t>(x)) * 0x01000193u;
  }
  __device__ __forceinline__ uint32_t value() const {
    uint32_t x = h;
    x ^= x >> 16;
    x *= 0x7FEB352Du;
    x ^= x >> 15;
    x *= 0x846CA68Bu;
    x ^= x >> 16;
    return x;
  }
};

__device__ __forceinline__ uint32_t hash_pos(uint32_t digest, int j, uint32_t m) {
  uint32_t x = digest ^ (j == 0 ? 0x2545F491u : 0x8B7F1C35u);
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x & (m - 1u);
}

// coverage.observe of a digest: its two Bloom bits into the lane's bitmap
// (global memory), the bits newly set into new_bits.
template <int P, int R0, int B>
__device__ __forceinline__ void coverage(const Column<B>& col, const Obs& o, uint32_t digest,
                                         int64_t n, int64_t i) {
  using Rw = Rows<P>;
  const uint32_t m = 32u * static_cast<uint32_t>(o.cov_words);
  int newly = 0;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const uint32_t pos = hash_pos(digest, j, m);
    int32_t* w = o.p[kCovBitmap] + static_cast<int64_t>(pos >> 5) * n + i;
    const uint32_t old = static_cast<uint32_t>(*w), now = old | (1u << (pos & 31u));
    if (now != old) {
      *w = static_cast<int32_t>(now);
      newly += __popc(now ^ old);
    }
  }
  if (newly != 0) col[R0 + Rw::kNewBits] = wrap_add(col[R0 + Rw::kNewBits], newly);
}


// The exposure plane's draws of a tick, made at its start where `on` (an
// observed instantiation with exposure on): the drop decisions of the four
// send kinds (bit kind * E + e, LINK_BITS' kind order), the duplications of
// both buffers (bit buf * S + j), the corruptions (bit a) and the delay
// draws (bit axis * E + e of delay_stamps' kind axis, slow links only).
// The tick's own sites read these bits where they would draw (keep_at,
// dup_at, stamp_sends, corrupt_fires), which take it by value: a kernel
// that is not observed passes its empty one, which adds nothing to its
// code.
struct PreDraw {
  bool on = false;
  uint64_t drop = 0, dup = 0, fire = 0;
  uint32_t corrupt = 0;
};

// The stream ids a kernel's exposure draws come from (core/streams.py):
// the single-decree ones (K5 passes Multi-Paxos', whose duplications hit
// the requests only).
struct SdStreams {
  // The uniform drop mask of send kind `kind` (LINK_BITS' kind order).
  __host__ __device__ static constexpr uint32_t keep(int kind) {
    return kind == 0 ? kKeepProm : kind == 1 ? kKeepAccd : kind == 2 ? kKeepP1 : kKeepP2;
  }
  static constexpr uint32_t link = kLinkBits, dup_req = kDupReq, dup_rep = kDupRep,
                            dup = kDupBits, corrupt = kCorrupt, delay = kDelayBits;
  static constexpr int dup_bufs = 2;  // both buffers' slots are duplicated
};

// sd::kept, read from exposure's draws of the tick where it made them.
template <bool OBS, bool ARMS, int E, typename ST = SdStreams>
__device__ __forceinline__ bool keep_at(PreDraw pd, const TickStream& ts, const Params& prm,
                                        const Gray& gray, uint32_t stream, int kind, int e,
                                        int64_t n, int64_t i) {
  if constexpr (OBS) {
    if (pd.on) return ((pd.drop >> (kind * E + e)) & 1ull) == 0;
  }
  return sd::kept<ARMS, E, ST::link>(ts, prm, gray, stream, kind, e, n, i);
}

// sd::duplicated (slot j of buffer `buf`), read from exposure's draws of
// the tick where it made them.
template <bool OBS, bool ARMS, int S, int E, typename ST = SdStreams>
__device__ __forceinline__ bool dup_at(PreDraw pd, const TickStream& ts, const Params& prm,
                                       const Gray& gray, int buf, int j, uint32_t stream,
                                       int64_t n, int64_t i) {
  if constexpr (OBS) {
    if (pd.on) return ((pd.dup >> (buf * S + j)) & 1ull) != 0;
  }
  return sd::duplicated<ARMS, S, E, ST::dup>(ts, prm, gray, stream, buf, j, n, i);
}

// The delay stamps of the slots `sent` (sd::Channel::stamp_sends), their
// delay draws read from exposure's draws of the tick where it made them.
template <bool OBS, typename Ch, int B>
__device__ __forceinline__ void stamp_sends(Ch& ch, PreDraw pd, const Column<B>& col, int row,
                                            uint32_t& wait, int dir, uint32_t sent,
                                            const Params& prm, const Plan& plan,
                                            const TickStream& ts, int64_t n, int64_t i,
                                            int32_t tick, DrawCount* draws) {
  if constexpr (OBS) {
    if (pd.on) {
      ch.template stamp_sends<true>(col, row, wait, dir, sent, prm, plan, ts, n, i, tick, draws,
                                    pd.fire);
      return;
    }
  }
  ch.stamp_sends(col, row, wait, dir, sent, prm, plan, ts, n, i, tick, draws);
}

// Exposure's draws of a tick (PreDraw), each where its knob is on, and
// their injected counts into `inj` (obs/exposure.py: every fault sampled
// this tick); `slow`: the stamped channel's links that delay (STAMPED).
template <bool OBS, bool ARMS, bool STAMPED, int P, int A, typename ST = SdStreams>
__device__ __forceinline__ PreDraw predraw(const Obs& ob, const TickStream& ts, const Params& prm,
                                           const Gray& gray, uint32_t slow, int64_t n, int64_t i,
                                           int (&inj)[kClasses]) {
  constexpr int E = P * A, S = 2 * E;
  PreDraw pd;
  if constexpr (OBS) {
    if (!ob.exp()) return pd;
    pd.on = true;
    const bool flaky = ARMS && gray.flaky;
    if (flaky || prm.drop.mode != 0) {
#pragma unroll 1
      for (int e = 0; e < E; ++e) {
        const int32_t thr = flaky ? gray.link_drop[e * n + i] : 0;
#pragma unroll
        for (int kind = 0; kind < 4; ++kind) {
          const bool dropped = flaky ? ts.below_at(thr, ST::link, kind * E + e)
                                     : ts.fires_at(prm.drop, ST::keep(kind), e);
          pd.drop |= (dropped ? 1ull : 0ull) << (kind * E + e);
        }
      }
      inj[kClDrop] = __popcll(pd.drop);
    }
    if (sd::dup_live<ARMS>(prm, gray)) {
#pragma unroll 1
      for (int j = 0; j < S; ++j) {
        const int32_t thr = flaky ? gray.link_dup[(j % E) * n + i] : 0;
#pragma unroll
        for (int buf = 0; buf < ST::dup_bufs; ++buf) {
          const bool d = flaky ? ts.below_at(thr, ST::dup, buf * S + j)
                               : ts.fires_at(prm.dup, buf == 0 ? ST::dup_req : ST::dup_rep, j);
          pd.dup |= (d ? 1ull : 0ull) << (buf * S + j);
        }
      }
      inj[kClDup] = __popcll(pd.dup);
    }
    if (ARMS && gray.corrupt.mode != 0) {
#pragma unroll
      for (int a = 0; a < A; ++a)
        pd.corrupt |= (ts.fires_at(gray.corrupt, ST::corrupt, a) ? 1u : 0u) << a;
      inj[kClCorrupt] = __popc(pd.corrupt);
    }
    if constexpr (STAMPED) {
      if (prm.delay.mode != 0) {
#pragma unroll 1
        for (int x = 0; x < 4; ++x) {
          for (uint32_t m = slow; m != 0; m &= m - 1) {
            const int e = __ffs(m) - 1;
            if (ts.bits(ST::delay, x * E + e) < prm.delay.thr) pd.fire |= 1ull << (x * E + e);
          }
        }
        inj[kClDelay] = __popcll(pd.fire);
      }
    }
  }
  return pd;
}

// A corruption of acceptor a's request this tick (p_corrupt, the arms):
// exposure's draw where it made them, else drawn here.
template <bool ARMS, typename ST = SdStreams>
__device__ __forceinline__ bool corrupt_fires(PreDraw pd, const TickStream& ts, const Gray& gray,
                                              int a) {
  if (!(ARMS && gray.corrupt.mode != 0)) return false;
  return pd.on ? ((pd.corrupt >> a) & 1u) != 0 : ts.fires_at(gray.corrupt, ST::corrupt, a);
}

// The plan's events at `tick` (telemetry's part_cut, part_heal and
// recover; exposure's stale restores and skewed timers).
template <bool OBS, bool ARMS, int P, int A>
__device__ __forceinline__ void fault_events(const Obs& ob, const Gray& gray,
                                             const sd::GrayLane<P, A>& glane,
                                             const int32_t (&crash_end)[A], const Plan& plan,
                                             int32_t tick, int64_t n, int64_t i,
                                             int (&ev)[kEvents], int (&inj)[kClasses],
                                             int (&eff)[kClasses]) {
  if constexpr (OBS) {
    if (ARMS && gray.partition) {
      ev[kEvPartCut] = glane.part_start == tick ? 1 : 0;
      ev[kEvPartHeal] = glane.part_end == tick ? 1 : 0;
    }
    int rec = 0;
#pragma unroll
    for (int a = 0; a < A; ++a) rec += crash_end[a] == tick ? 1 : 0;
    int recovered = ob.rec_acc ? rec : 0;
    if (ob.rec_prop) {
#pragma unroll
      for (int p = 0; p < P; ++p) recovered += plan.pcrash_end[p * n + i] == tick ? 1 : 0;
    }
    ev[kEvRecover] = recovered;
    if (ARMS && gray.stale_k > 0) inj[kClStale] = eff[kClStale] = rec;
    if (ARMS && gray.timeout_skew) {
      int skewed = 0;
#pragma unroll
      for (int p = 0; p < P; ++p) skewed += glane.ptimeout[p] != 0 ? 1 : 0;
      inj[kClTimeout] = skewed;
    }
  }
}

// The zero-only payload words of a single-decree lane (no column row,
// SdStaged G) that are not 0 in global memory, which the coverage digest
// folds where the chunk has not written their slot: bit j a request's v1
// (j < G::kRqV1From), E + j a request's v2, S + j a reply's v2 (j >= E).
template <typename G>
__device__ __forceinline__ uint64_t zero_words(const Leaves& L, int64_t n, int64_t i) {
  uint64_t zo = 0;
#pragma unroll 1
  for (int j = 0; j < G::S; ++j) {
    if (j < G::kRqV1From && load<int32_t>(L, kRqV1, j, n, i) != 0) zo |= 1ull << j;
    if (load<int32_t>(L, kRqV2, j, n, i) != 0) zo |= 1ull << (G::E + j);
    if (j >= G::E && load<int32_t>(L, kRpV2, j, n, i) != 0) zo |= 1ull << (G::S + j);
  }
  return zo;
}

// The digest's fold of an acceptor's (voter's) three snapshot shadows, at
// leaves SNAP + 0..2, where the state carries them.
template <int A, int SNAP>
__device__ __forceinline__ void fold_shadows(Digest& d, const Obs& ob, const Leaves& L, int64_t n,
                                             int64_t i) {
  if (ob.snaps) {
#pragma unroll 1
    for (int f = 0; f < 3; ++f)
      for (int a = 0; a < A; ++a) d.fold(load<int32_t>(L, SNAP + f, a, n, i));
  }
}

// The digest's fold of a single-decree lane's two message buffers
// (requests, then replies: ballots, first and second payloads, presence,
// the stamps where STAMPED), in the reference's leaf and row order, from
// the column (SdStaged G) and the presence masks; a zero-only payload word
// is 0 where the chunk wrote its slot (`rq_written`, `rp_written`), else
// what global memory holds (zero_words' mask `zo_nz`).
template <typename G, bool STAMPED, int B>
__device__ __forceinline__ void fold_buffers(Digest& d, const Column<B>& col, const Leaves& L,
                                             int64_t n, int64_t i, uint64_t zo_nz,
                                             uint32_t rq_written, uint32_t rp_written,
                                             uint32_t rq_present, uint32_t rp_present) {
  constexpr int S = G::S, E = G::E;
  const auto zero_only = [&](int leaf, int j, uint32_t written, int bit) {
    return ((written >> j) & 1u) || !((zo_nz >> bit) & 1ull) ? 0 : load<int32_t>(L, leaf, j, n, i);
  };
#pragma unroll 1
  for (int j = 0; j < S; ++j) d.fold(col[G::kRqBal + j]);
#pragma unroll 1
  for (int j = 0; j < S; ++j)
    d.fold(j < G::kRqV1From ? zero_only(kRqV1, j, rq_written, j) : col[G::rq_v1(j)]);
#pragma unroll 1
  for (int j = 0; j < S; ++j) d.fold(zero_only(kRqV2, j, rq_written, E + j));
#pragma unroll 1
  for (int j = 0; j < S; ++j) d.fold((rq_present >> j) & 1u);
  if constexpr (STAMPED) {
#pragma unroll 1
    for (int j = 0; j < S; ++j) d.fold(col[G::kRqUntil + j]);
  }
#pragma unroll 1
  for (int j = 0; j < S; ++j) d.fold(col[G::kRpBal + j]);
#pragma unroll 1
  for (int j = 0; j < S; ++j) d.fold(col[G::kRpV1 + j]);
#pragma unroll 1
  for (int j = 0; j < S; ++j) d.fold(j < E ? col[G::kRpV2 + j] : zero_only(kRpV2, j, rp_written, S + j));
#pragma unroll 1
  for (int j = 0; j < S; ++j) d.fold((rp_present >> j) & 1u);
  if constexpr (STAMPED) {
#pragma unroll 1
    for (int j = 0; j < S; ++j) d.fold(col[G::kRpUntil + j]);
  }
}

}  // namespace obs

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
