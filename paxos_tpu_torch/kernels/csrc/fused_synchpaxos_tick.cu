// Fused SynchPaxos engine for Hopper (sm_90a): n_ticks ticks of
// counter_masks + apply_tick_sp for every instance in one launch, with the
// bounded-delay channel (delay stamps on every send, readiness gates on
// delivery and request selection).
//
// Replaces: paxos_tpu/kernels/fused_tick.py::_kernel bound to the
// SynchPaxos tick (fused_fns("synchpaxos"), launched by fused_chunk
// through pl.pallas_call), the Pallas kernel that keeps a block of
// instances' state resident in VMEM for a whole chunk.
//
// Bound on this card: ~925 B/lane of state (765 without the stamps) moved
// once each way per chunk, against a few thousand int32 operations per
// lane-tick, so at 64 ticks per chunk it is bound by integer operations,
// not bytes.
//
// Design: one thread per instance (lane), as K1 to K3 and K5.  A lane's
// tick is one long chain of dependent integer operations and branches, so
// the time falls with the warps an SM holds; the state is split by access
// pattern so that a thread's registers allow 12 warps an SM, and each part
// stays where it is for the whole chunk:
//  - registers: the role scalars, the learner's scalars, the presence
//    bitmasks of both buffers, the bitmasks of the slots whose stamp is
//    still ahead of the tick with the earliest such stamp, the slow-link
//    mask, and a bitmask per buffer of the slots the chunk wrote;
//  - shared memory, a column per lane (word r at smem[r * B + t], B the
//    block's lane count, as K5 keeps its slot windows; SpStaged below): the
//    message payloads a tick reads, the delay stamps and the learner's
//    (ballot, value, voters) table.  A dynamic index (the selected request,
//    a reply's slot, a waiting stamp) is one shared load or store, where in
//    registers it was a chain of selects, and nothing on the tick's chain
//    touches global memory but a link's latency cap, read where a send on
//    it is delayed;
//  - no row at all: the payload words the tick only ever writes as 0 (a
//    PREPARE's v1, every request's v2, an ACCEPTED's v2;
//    protocols/synchpaxos.py).
// The column is loaded once at the start of the chunk from
// [row * n_inst + lane].  At the end the kernel stores only the slots the
// chunk wrote (their staged words, 0 to their zero-only words, their
// stamp), the learner table if an accept event reached it, and every
// presence byte: the state comes back byte for byte, stale payloads and
// stamps of consumed slots included.  A thread touches only its own column,
// so the kernel needs no barrier, and lanes past n_inst return at once.
//
// What sets the pace: as in K5, a lane's tick is a chain of dependent
// operations and the time falls with the warps an SM holds, and with the
// code on the chain.  So the sites that draw or stamp are few and rolled:
// a tick's sends write their payloads and collect their slots, and one
// rolled loop per buffer then stamps them (the stamp draws are keyed by the
// slot, so the order of the stamps changes nothing); an acceptor's request
// is selected over its present slots only (select_present); the proposers'
// sends loop over the acceptors only for a proposer that sends.  Unrolled,
// the fourteen stamp sites and the selection made a steady chunk 1.6 times
// longer (PERF.md).
//
// What differs from the Paxos tick (protocols/synchpaxos.py):
//  - the leader (proposer 0) opens in FAST at the round-0 ballot, sends
//    Accept(ballot, own_val) at its pre-tick timer 0 (keep_p2 and the ACCEPT
//    stamp, like the classic ACCEPT), collects ACCEPTED in FAST as in P2,
//    and decides own_val on a q2 quorum while timer <= delta, the timer
//    advancing first; FAST's deadline is delta, not the timeout;
//  - sp_unsafe_fast, the planted bug: FAST decides on the first ACCEPTED;
//  - delivery and selection see only slots with tick >= until (the pre-tick
//    tick), and every send stamps the slot it writes (0 when not delayed).
// Masks that a tick only ANDs in are drawn lazily, as in K1; so are the
// delay and latency draws, made only for a send on a slow link.  The
// measuring build counts every stamp read or written inside the tick loop
// as a touch.

#include "fused_common.cuh"

namespace {

// Proposer phases (core/state.py, core/sp_state.py).
constexpr int32_t kP1 = 0, kP2 = 1, kDone = 2, kFast = 3;

// The tick's phases in order, as the phase-clock build splits a lane's
// cycles (fused_tick.PHASES["synchpaxos"]).
enum Phase {
  kPhLoad, kPhRefresh, kPhDeliver, kPhFold, kPhAcceptor, kPhLearner, kPhSends, kPhStore,
  kPhases,
};

#ifdef FUSED_PHASE_CLOCKS
// Read and cleared by fused_phase_clocks(): clock64() cycles per phase,
// summed over lanes and ticks.
__device__ unsigned long long g_phase[kPhases];
#endif

// The phase-clock measuring build (nvcc -DFUSED_PHASE_CLOCKS): a lane sums
// the clock64() cycles between consecutive phase boundaries (its own
// cycles, which include the time other warps hold the SM) and adds them
// to g_phase at the end; empty in every other build.
struct PhaseClock {
#ifdef FUSED_PHASE_CLOCKS
  long long t;
  uint32_t sum[kPhases];
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
    for (int k = 0; k < kPhases; ++k) atomicAdd(&g_phase[k], static_cast<unsigned long long>(sum[k]));
  }
#else
  __device__ __forceinline__ void mark(int) {}
  __device__ __forceinline__ void flush() const {}
#endif
};

// The role leaves in the reference's flatten order; the learner and the
// message buffers follow (SharedLeaf).
enum Leaf {
  kPromised, kAccBal, kAccVal,
  kBal, kPhase, kOwnVal, kPropVal, kHeard, kBestBal, kBestVal, kTimer,
  kDecidedVal,
};

// A lane's staged rows, in column order (mirrored by
// fused_tick.SP_STAGED_LEAVES).  Slot j = (kind * P + p) * A + a of a
// buffer, E = P * A slots a kind: a request's v1 is staged for the ACCEPT
// slots only (row j - E), a reply's v2 for the PROMISE slots only (row j).
template <int P, int A, int K, bool STAMPED>
struct SpStaged {
  static constexpr int S = 2 * P * A, E = P * A;
  static constexpr int kRqBal = 0;                               // requests.bal (2, P, A)
  static constexpr int kRqV1 = kRqBal + S;                       // requests.v1, ACCEPT
  static constexpr int kRpBal = kRqV1 + E;                       // replies.bal (2, P, A)
  static constexpr int kRpV1 = kRpBal + S;                       // replies.v1 (2, P, A)
  static constexpr int kRpV2 = kRpV1 + S;                        // replies.v2, PROMISE
  static constexpr int kRqUntil = kRpV2 + E;                     // requests.until, if STAMPED
  static constexpr int kRpUntil = kRqUntil + (STAMPED ? S : 0);  // replies.until, if STAMPED
  static constexpr int kLtBal = kRpUntil + (STAMPED ? S : 0);    // learner.lt_bal (K)
  static constexpr int kLtVal = kLtBal + K;                      // learner.lt_val (K)
  static constexpr int kLtMask = kLtVal + K;                     // learner.lt_mask (K)
  static constexpr int kRows = kLtMask + K;
};

// ROWS rows of a leaf from its row FROM on, to (from) the column from row
// OFF on.  A load ends with a compiler fence, so that one leaf's loads are
// in flight at a time: without it the compiler issues all the column's
// loads at once and spills the registers they need.
template <int ROWS, int FROM, int OFF, int B>
__device__ __forceinline__ void load_rows(const Column<B>& col, const Leaves& L, int leaf,
                                          int64_t n, int64_t i) {
  const int32_t* g = static_cast<const int32_t*>(L.p[leaf]) + i;
#pragma unroll
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

// The column at the start of the chunk: every staged row.
template <int P, int A, int K, bool STAMPED, int B>
__device__ __forceinline__ void load_column(const Column<B>& col, const Leaves& L, int64_t n,
                                            int64_t i) {
  using G = SpStaged<P, A, K, STAMPED>;
  load_rows<G::S, 0, G::kRqBal>(col, L, kRqBal, n, i);
  load_rows<G::E, G::E, G::kRqV1>(col, L, kRqV1, n, i);
  load_rows<G::S, 0, G::kRpBal>(col, L, kRpBal, n, i);
  load_rows<G::S, 0, G::kRpV1>(col, L, kRpV1, n, i);
  load_rows<G::E, 0, G::kRpV2>(col, L, kRpV2, n, i);
  if constexpr (STAMPED) {
    load_rows<G::S, 0, G::kRqUntil>(col, L, kRqUntil, n, i);
    load_rows<G::S, 0, G::kRpUntil>(col, L, kRpUntil, n, i);
  }
  load_rows<K, 0, G::kLtBal>(col, L, kLtBal, n, i);
  load_rows<K, 0, G::kLtVal>(col, L, kLtVal, n, i);
  load_rows<K, 0, G::kLtMask>(col, L, kLtMask, n, i);
}

// The column at the end of the chunk: the slots of each buffer that the
// chunk wrote (bitmasks rq_written, rp_written) with their zero-only words
// as 0, and the learner table if an accept event reached it.
template <int P, int A, int K, bool STAMPED, int B>
__device__ __forceinline__ void store_column(const Column<B>& col, const Leaves& L, int64_t n,
                                             int64_t i, uint32_t rq_written, uint32_t rp_written,
                                             bool lt_written) {
  using G = SpStaged<P, A, K, STAMPED>;
  for (uint32_t m = rq_written; m != 0; m &= m - 1) {
    const int j = __ffs(m) - 1;
    store<int32_t>(L, kRqBal, j, n, i, col[G::kRqBal + j]);
    store<int32_t>(L, kRqV1, j, n, i, j >= G::E ? col[G::kRqV1 + j - G::E] : 0);
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

// The bounded-delay channel of a lane (transport.ready / send(until=) and
// protocols.paxos.delay_stamps) over the stamps in the column: per buffer a
// bitmask of the slots whose stamp is still ahead of the tick, and the
// earliest such stamp; a slot is ready (deliverable, selectable) where its
// bit is clear.  The plan's latency caps are read once as the links whose
// cap is above 0 (`slow`, the only links a send can be delayed on), and a
// cap again only where a send on its link is delayed.  Every stamp read or
// written counts as a touch.
template <int P, int A, int K, bool STAMPED, int B>
struct Channel {
  using G = SpStaged<P, A, K, STAMPED>;
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
  // ((dir * 2 + kind) * P + p) * A + a.  tick + 1 + min(latency, cap) where
  // the link is slow and the delay draw fires, else 0; the latency is
  // 1 + (bits & 0x7FFFFFFF) % delay_max.  A link that never delays draws
  // nothing: its stamp is 0 whatever the draws.
  __device__ __forceinline__ int32_t stamp(const Params& prm, const Plan& plan,
                                           const TickStream& ts, int dir, int kind, int p, int a,
                                           int64_t n, int64_t i, int32_t tick) const {
    const int e = p * A + a;
    if (prm.delay.mode == 0 || !((slow >> e) & 1u)) return 0;
    const int pos = ((dir * 2 + kind) * P + p) * A + a;
    if (ts.bits(kDelayBits, pos) >= prm.delay.thr) return 0;
    const uint32_t lat =
        1u + (ts.bits(kLatBits, pos) & 0x7FFFFFFFu) % static_cast<uint32_t>(prm.delay_max);
    const int32_t cap = plan.link_delay[e * n + i];
    return wrap_add(wrap_add(tick, 1), min(static_cast<int32_t>(lat), cap));
  }

  // The slots `sent` of direction `dir`'s buffer (stamps from row `row`,
  // kRqUntil or kRpUntil; waiting slots `wait`), written at `tick`: each
  // gets its stamp (0: deliverable at once).  Slot j = (kind * P + p) * A + a.
  __device__ __forceinline__ void stamp_sends(const Column<B>& col, int row, uint32_t& wait,
                                              int dir, uint32_t sent, const Params& prm,
                                              const Plan& plan, const TickStream& ts, int64_t n,
                                              int64_t i, int32_t tick, DrawCount* draws) {
    for (uint32_t m = sent; m != 0; m &= m - 1) {
      const int j = __ffs(m) - 1;
      const int e = j % G::E;
      const int32_t u = stamp(prm, plan, ts, dir, j / G::E, e / A, e % A, n, i, tick);
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

// select_request for acceptor a, drawing over its present request slots
// only: the scores are distinct (kp in the low bits), so the order of the
// draws does not change the winner.
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

template <int P, int A, int K, bool STAMPED, int B, int MIN_BLOCKS>
__global__ void __launch_bounds__(B, MIN_BLOCKS)
fused_synchpaxos_kernel(Leaves L, Plan plan, const int32_t* __restrict__ tick_ptr, Params prm) {
  static_assert(B % 32 == 0, "a block is whole warps");
  using G = SpStaged<P, A, K, STAMPED>;
  constexpr int S = G::S;  // message slots per buffer, index (kind * P + p) * A + a
  static_assert(S <= 32, "slot presence must fit one 32-bit mask");
  extern __shared__ int32_t smem[];  // G::kRows * B words

  const int64_t n = prm.n_inst;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * B + threadIdx.x;
  if (i >= n) return;
  PhaseClock clk;
  const Column<B> col{smem + threadIdx.x};
  load_column<P, A, K, STAMPED, B>(col, L, n, i);

  // ---- Load the lane's register-resident state once. ----
  int32_t promised[A], acc_bal[A], acc_val[A], crash_start[A], crash_end[A];
  uint32_t equiv = 0;
#pragma unroll
  for (int a = 0; a < A; ++a) {
    promised[a] = load<int32_t>(L, kPromised, a, n, i);
    acc_bal[a] = load<int32_t>(L, kAccBal, a, n, i);
    acc_val[a] = load<int32_t>(L, kAccVal, a, n, i);
    crash_start[a] = plan.crash_start[a * n + i];
    crash_end[a] = plan.crash_end[a * n + i];
    equiv |= (plan.equivocate[a * n + i] != 0 ? 1u : 0u) << a;
  }
  int32_t bal[P], phase[P], own_val[P], prop_val[P], heard[P], best_bal[P],
      best_val[P], timer[P], decided_val[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    bal[p] = load<int32_t>(L, kBal, p, n, i);
    phase[p] = load<int32_t>(L, kPhase, p, n, i);
    own_val[p] = load<int32_t>(L, kOwnVal, p, n, i);
    prop_val[p] = load<int32_t>(L, kPropVal, p, n, i);
    heard[p] = load<int32_t>(L, kHeard, p, n, i);
    best_bal[p] = load<int32_t>(L, kBestBal, p, n, i);
    best_val[p] = load<int32_t>(L, kBestVal, p, n, i);
    timer[p] = load<int32_t>(L, kTimer, p, n, i);
    decided_val[p] = load<int32_t>(L, kDecidedVal, p, n, i);
  }
  bool chosen = load<uint8_t>(L, kChosen, 0, n, i) != 0;
  int32_t chosen_val = load<int32_t>(L, kChosenVal, 0, n, i);
  int32_t chosen_tick = load<int32_t>(L, kChosenTick, 0, n, i);
  int32_t violations = load<int32_t>(L, kViolations, 0, n, i);
  int32_t evictions = load<int32_t>(L, kEvictions, 0, n, i);
  uint32_t rq_present = 0, rp_present = 0;
#pragma unroll
  for (int j = 0; j < S; ++j) {
    rq_present |= (load<uint8_t>(L, kRqPresent, j, n, i) != 0 ? 1u : 0u) << j;
    rp_present |= (load<uint8_t>(L, kRpPresent, j, n, i) != 0 ? 1u : 0u) << j;
  }
  uint32_t rq_written = 0, rp_written = 0;  // the slots the chunk wrote
  bool lt_written = false;                  // an accept event reached the learner table

  const int32_t tick0 = *tick_ptr;
  Channel<P, A, K, STAMPED, B> ch;
  if constexpr (STAMPED) ch.load(col, prm, plan, n, i, tick0);
  clk.mark(kPhLoad);

  const uint32_t blk = static_cast<uint32_t>(prm.blk0) + static_cast<uint32_t>(i / prm.block);
  const uint32_t lane = static_cast<uint32_t>(i % prm.block);
  const auto quorum_of = [&](int32_t) { return prm.q2; };

  DrawCount draws;
  for (int t = 0; t < prm.n_ticks; ++t) {
    const int32_t tick = wrap_add(tick0, t);
    const TickStream ts{mix32(prm.seed, static_cast<uint32_t>(tick), blk),
                        static_cast<uint32_t>(prm.block), lane, &draws};
    if constexpr (STAMPED) ch.refresh(col, tick, &draws);
    const uint32_t rq_ready = rq_present & (STAMPED ? ~ch.rq_wait : ~0u);
    clk.mark(kPhRefresh);

    // ---- Reply delivery (pre-tick buffer): the replies that have arrived
    //      and are not held; consumed unless duplicated. ----
    uint32_t delivered = rp_present & (STAMPED ? ~ch.rp_wait : ~0u);
    if (prm.hold.mode != 0) {
      for (uint32_t m = delivered; m != 0; m &= m - 1) {
        const int j = __ffs(m) - 1;
        if (ts.fires_at(prm.hold, kDeliver, j)) delivered &= ~(1u << j);
      }
    }
    uint32_t taken = delivered;
    if (prm.dup.mode != 0) {
      for (uint32_t m = delivered; m != 0; m &= m - 1) {
        const int j = __ffs(m) - 1;
        if (ts.fires_at(prm.dup, kDupRep, j)) taken &= ~(1u << j);
      }
    }
    uint32_t rp_next = rp_present & ~taken;
    clk.mark(kPhDeliver);

    // ---- Proposer fold over the pre-tick replies. ----
    uint32_t accept = 0, expired = 0;  // proposers that send ACCEPT / PREPARE
    int32_t old_bal[P], accept_val[P];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int32_t cur = bal[p];
      const bool fast = phase[p] == kFast;
      int32_t h = heard[p];
      int32_t prev[A];
      int32_t cand_bal = kInt32Min;
#pragma unroll
      for (int a = 0; a < A; ++a) {
        const int j0 = (0 * P + p) * A + a;  // PROMISE slot
        const int j1 = (1 * P + p) * A + a;  // ACCEPTED slot
        const bool prom_ok =
            ((delivered >> j0) & 1u) && phase[p] == kP1 && col[G::kRpBal + j0] == cur;
        const bool accd_ok =
            ((delivered >> j1) & 1u) && (phase[p] == kP2 || fast) && col[G::kRpBal + j1] == cur;
        if (prom_ok || accd_ok) h |= 1 << a;
        prev[a] = prom_ok ? col[G::kRpV1 + j0] : 0;
        cand_bal = max(cand_bal, prev[a]);
      }
      // The recovered value is read only where it is taken.
      const bool upgrade = cand_bal > best_bal[p];
      int32_t bb = best_bal[p], bv = best_val[p];
      if (upgrade) {
        int32_t cand_val = kInt32Min;
#pragma unroll
        for (int a = 0; a < A; ++a)
          cand_val = max(cand_val, prev[a] == cand_bal ? col[G::kRpV2 + p * A + a] : 0);
        bb = cand_bal;
        bv = cand_val;
      }

      const int votes = __popc(static_cast<uint32_t>(h));
      // The timer advances first, so the window test sees this tick's age.
      int32_t tm = phase[p] == kDone ? timer[p] : wrap_add(timer[p], 1);
      const bool fast_done =
          fast && (prm.sp_unsafe_fast ? votes >= 1 : (votes >= prm.q2 && tm <= prm.delta));
      const bool p1 = phase[p] == kP1 && votes >= prm.q1;
      const bool p2 = phase[p] == kP2 && votes >= prm.q2;
      const int32_t v_by_p1 = bb > 0 ? bv : own_val[p];
      const int32_t deadline = fast ? prm.delta : prm.timeout;
      const bool exp = phase[p] != kDone && !p1 && !p2 && !fast_done && tm > deadline;
      // The round-0 broadcast: FAST at the pre-tick timer 0 (never with p1).
      const bool kick = fast && timer[p] == 0;

      int32_t ph = phase[p];
      if (p1) ph = kP2;
      if (p2 || fast_done) ph = kDone;
      if (exp) ph = kP1;
      const int32_t pv = p1 ? v_by_p1 : prop_val[p];
      if (p2) decided_val[p] = prop_val[p];
      if (fast_done) decided_val[p] = own_val[p];
      if (p1 || exp) h = 0;
      if (exp) {
        bb = 0;
        bv = 0;
      }
      if (p1) tm = 0;
      if (exp) {
        const uint32_t r = ts.bits(kBackoff, p) & 0x7FFFFFFFu;
        tm = -static_cast<int32_t>(r % static_cast<uint32_t>(prm.backoff_n));
      }
      old_bal[p] = cur;
      accept_val[p] = kick ? own_val[p] : pv;
      bal[p] = exp ? next_ballot(cur, prm.stride, p) : cur;
      phase[p] = ph;
      prop_val[p] = pv;
      heard[p] = h;
      best_bal[p] = bb;
      best_val[p] = bv;
      timer[p] = tm;
      accept |= (p1 || kick ? 1u : 0u) << p;
      expired |= (exp ? 1u : 0u) << p;
    }
    clk.mark(kPhFold);

    // ---- Acceptor half-tick: select at most one arrived request per acceptor. ----
    uint32_t rq_next = rq_present;
    uint32_t rp_sent = 0;  // the reply slots written this tick
    uint32_t ev_flag = 0;
    int32_t ev_bal[A], ev_val[A];
    int inv_viol = 0;
#pragma unroll
    for (int a = 0; a < A; ++a) {
      const bool alive = !(crash_start[a] <= tick && tick < crash_end[a]);
      const bool busy = ts.survives_at(prm.idle, kBusy, a);
      const int win = select_present<P, A>(ts, rq_ready, a);
      const int sel = (win >= 0 && busy && alive) ? win : -1;

      // The selected request's ballot, and an ACCEPT's value (a PREPARE's
      // v1 is 0, and only an accepting acceptor reads it).
      const bool is_prep = sel >= 0 && sel < P;
      const bool is_acc = sel >= P;
      const int32_t mb = sel >= 0 ? col[G::kRqBal + sel * A + a] : 0;
      const int32_t mv = is_acc ? col[G::kRqV1 + (sel - P) * A + a] : 0;
      const bool eq = (equiv >> a) & 1u;
      const bool ok_prep_h = is_prep && !eq && mb > promised[a];
      const bool ok_prep = ok_prep_h || (is_prep && eq);
      const bool ok_acc_h = is_acc && !eq && mb >= promised[a];
      const bool ok_acc = ok_acc_h || (is_acc && eq);

      const int32_t pr_old = promised[a], ab_old = acc_bal[a], av_old = acc_val[a];
      int32_t pr = ok_prep_h ? mb : pr_old;
      if (ok_acc_h) pr = max(pr, mb);
      const int32_t ab = ok_acc ? mb : ab_old;
      const int32_t av = ok_acc ? mv : av_old;

      // The reply into the selected sender's slot (post-consume buffer):
      // PROMISE for proposer sel, ACCEPTED for proposer sel - P.
      if (ok_prep && ts.survives_at(prm.drop, kKeepProm, sel * A + a)) {
        const int jr = sel * A + a;
        col[G::kRpBal + jr] = mb;
        col[G::kRpV1 + jr] = eq ? 0 : ab_old;
        col[G::kRpV2 + jr] = eq ? 0 : av_old;
        rp_sent |= 1u << jr;
      }
      if (ok_acc && ts.survives_at(prm.drop, kKeepAccd, (sel - P) * A + a)) {
        const int jr = sel * A + a;
        col[G::kRpBal + jr] = mb;
        col[G::kRpV1 + jr] = mv;
        rp_sent |= 1u << jr;
      }
      // Consume the selected request unless it is duplicated.
      if (sel >= 0) {
        const int j = sel * A + a;
        if (!(prm.dup.mode != 0 && ts.fires_at(prm.dup, kDupReq, j))) rq_next &= ~(1u << j);
      }

      // Acceptor-local invariants (honest acceptors only).
      const bool bad = pr < pr_old || ab > pr || (ab == 0 && av != 0);
      if (bad && !eq) ++inv_viol;
      promised[a] = pr;
      acc_bal[a] = ab;
      acc_val[a] = av;
      ev_flag |= (ok_acc ? 1u : 0u) << a;
      ev_bal[a] = mb;
      ev_val[a] = mv;
    }
    // The replies' delay stamps (the stamp draws are keyed by the slot, so
    // one rolled loop serves every reply site).
    if constexpr (STAMPED)
      ch.stamp_sends(col, G::kRpUntil, ch.rp_wait, 1, rp_sent, prm, plan, ts, n, i, tick, &draws);
    rp_present = rp_next | rp_sent;
    rp_written |= rp_sent;
    rq_present = rq_next;
    clk.mark(kPhAcceptor);

    // ---- Learner: fold accept events into the (ballot, value) table. ----
    // An event folds where it carries a ballot.  A tick without one leaves
    // the table as it is, and the fold's other writes reduce to these.
    uint32_t folds = 0;
#pragma unroll
    for (int a = 0; a < A; ++a) folds |= (((ev_flag >> a) & 1u) && ev_bal[a] > 0 ? 1u : 0u) << a;
    if (folds == 0) {
      chosen_val = chosen ? chosen_val : 0;
      chosen_tick = chosen ? chosen_tick : -1;
      violations = wrap_add(violations, inv_viol);
    } else {
      Learner<K> lrn;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        lrn.bal[k] = col[G::kLtBal + k];
        lrn.val[k] = col[G::kLtVal + k];
        lrn.mask[k] = col[G::kLtMask + k];
      }
      lrn.chosen = chosen;
      lrn.chosen_val = chosen_val;
      lrn.chosen_tick = chosen_tick;
      lrn.violations = violations;
      lrn.evictions = evictions;
      lrn.template observe<A>(ev_flag, ev_bal, ev_val, tick, inv_viol, quorum_of);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        col[G::kLtBal + k] = lrn.bal[k];
        col[G::kLtVal + k] = lrn.val[k];
        col[G::kLtMask + k] = lrn.mask[k];
      }
      chosen = lrn.chosen;
      chosen_val = lrn.chosen_val;
      chosen_tick = lrn.chosen_tick;
      violations = lrn.violations;
      evictions = lrn.evictions;
      lt_written = true;
    }
    clk.mark(kPhLearner);

    // ---- Proposer sends into the consumed request buffer, then their
    //      delay stamps. ----
    uint32_t rq_sent = 0;  // the request slots written this tick
#pragma unroll
    for (int p = 0; p < P; ++p) {
      if ((accept | expired) >> p & 1u) {
#pragma unroll 1
        for (int a = 0; a < A; ++a) {
          if (((accept >> p) & 1u) && ts.survives_at(prm.drop, kKeepP2, p * A + a)) {
            const int j = (1 * P + p) * A + a;  // ACCEPT(old ballot, own or phase-1 value)
            col[G::kRqBal + j] = old_bal[p];
            col[G::kRqV1 + p * A + a] = accept_val[p];
            rq_sent |= 1u << j;
          }
          if (((expired >> p) & 1u) && ts.survives_at(prm.drop, kKeepP1, p * A + a)) {
            const int j = (0 * P + p) * A + a;  // PREPARE(next ballot)
            col[G::kRqBal + j] = bal[p];
            rq_sent |= 1u << j;
          }
        }
      }
      if (prm.clamp_per_tick) bal[p] = min(bal[p], kBallotLimit);
    }
    if constexpr (STAMPED)
      ch.stamp_sends(col, G::kRqUntil, ch.rq_wait, 0, rq_sent, prm, plan, ts, n, i, tick, &draws);
    rq_present |= rq_sent;
    rq_written |= rq_sent;
    clk.mark(kPhSends);
  }

  draws.flush();

  // ---- Store the lane's state once. ----
#pragma unroll
  for (int a = 0; a < A; ++a) {
    store<int32_t>(L, kPromised, a, n, i, promised[a]);
    store<int32_t>(L, kAccBal, a, n, i, acc_bal[a]);
    store<int32_t>(L, kAccVal, a, n, i, acc_val[a]);
  }
#pragma unroll
  for (int p = 0; p < P; ++p) {
    store<int32_t>(L, kBal, p, n, i, bal[p]);
    store<int32_t>(L, kPhase, p, n, i, phase[p]);
    store<int32_t>(L, kPropVal, p, n, i, prop_val[p]);
    store<int32_t>(L, kHeard, p, n, i, heard[p]);
    store<int32_t>(L, kBestBal, p, n, i, best_bal[p]);
    store<int32_t>(L, kBestVal, p, n, i, best_val[p]);
    store<int32_t>(L, kTimer, p, n, i, timer[p]);
    store<int32_t>(L, kDecidedVal, p, n, i, decided_val[p]);
  }
  store<uint8_t>(L, kChosen, 0, n, i, chosen ? 1 : 0);
  store<int32_t>(L, kChosenVal, 0, n, i, chosen_val);
  store<int32_t>(L, kChosenTick, 0, n, i, chosen_tick);
  store<int32_t>(L, kViolations, 0, n, i, violations);
  store<int32_t>(L, kEvictions, 0, n, i, evictions);
#pragma unroll
  for (int j = 0; j < S; ++j) {
    store<uint8_t>(L, kRqPresent, j, n, i, ((rq_present >> j) & 1u) ? 1 : 0);
    store<uint8_t>(L, kRpPresent, j, n, i, ((rp_present >> j) & 1u) ? 1 : 0);
  }
  store_column<P, A, K, STAMPED, B>(col, L, n, i, rq_written, rp_written, lt_written);
  clk.mark(kPhStore);
  clk.flush();
}

// One instantiation, ready to launch (SmemInst in fused_common.cuh).
template <int P, int A, int K, bool STAMPED, int B, int MIN_BLOCKS>
using Inst = SmemInst<fused_synchpaxos_kernel<P, A, K, STAMPED, B, MIN_BLOCKS>, B,
                      SpStaged<P, A, K, STAMPED>::kRows * B * 4>;

// The instantiations, (n_prop, n_acc, k_slots, stamped, B, MIN_BLOCKS): one
// per shape, at the geometry fused_tick.SP_STAGING gives it; MIN_BLOCKS, the
// blocks an SM is to hold, caps a thread's registers.
#define K4_INSTANCES(X)          \
  X(2, 5, 8, true, 128, 3)       \
  X(2, 5, 8, false, 128, 3)      \
  X(2, 3, 8, true, 128, 3)

// Calls `fn(Inst<...>{})` for the shape `dims` names
// (n_prop, n_acc, k_slots, stamped), or returns cudaErrorInvalidValue.
template <typename Fn>
cudaError_t dispatch(const int* dims, Fn&& fn) {
#define K4_MATCH(P_, A_, K_, S_, B_, M_)                                              \
  if (dims[0] == P_ && dims[1] == A_ && dims[2] == K_ && (dims[3] != 0) == S_) \
    return fn(Inst<P_, A_, K_, S_, B_, M_>{});
  K4_INSTANCES(K4_MATCH)
#undef K4_MATCH
  return cudaErrorInvalidValue;
}

}  // namespace

// C entry point, loaded with ctypes (arguments: read_args in
// fused_common.cuh; `dims` = n_prop, n_acc, k_slots, stamped, where stamped
// is 1 when the state's buffers carry delay stamps (30 leaves, else 28),
// then the dynamic shared bytes a block, fused_tick.SP_STAGING's); `tick`
// is the device int32 tick scalar, read by the kernel and advanced by the
// caller.  p_delay > 0 needs the plan's link_delay.  Returns cudaSuccess or
// the first error: an unknown shape or too few shared bytes
// (cudaErrorInvalidValue), a shared-memory request the card refuses, or
// the launch's cudaGetLastError().
extern "C" int fused_synchpaxos_launch(const int* dims, int n_dims, void** leaves, int n_leaves,
                                       void** plan, void* tick, const long long* params,
                                       int n_params, void* stream) {
  if (n_dims != 5) return cudaErrorInvalidValue;
  const int stamped = dims[3];
  Leaves L;
  Plan pl;
  Params prm;
  const cudaError_t bad = read_args(leaves, n_leaves, stamped ? kStampedLeaves : kLeaves, plan,
                                    params, n_params, &L, &pl, &prm, true);
  if (bad != cudaSuccess) return bad;
  if (stamped) move_stamps_last(&L);
  const auto* t = static_cast<const int32_t*>(tick);
  auto s = static_cast<cudaStream_t>(stream);
  const int smem = dims[4];
  return dispatch(dims, [&](auto inst) { return decltype(inst)::launch(L, pl, t, prm, smem, s); });
}

// The blocks of instantiation `dims` (as for fused_synchpaxos_launch) that
// one SM of the current device holds at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), into *blocks_per_sm.
extern "C" int fused_synchpaxos_occupancy(const int* dims, int n_dims, int* blocks_per_sm) {
  if (n_dims != 5) return cudaErrorInvalidValue;
  const int smem = dims[4];
  return dispatch(dims, [&](auto inst) { return decltype(inst)::occupancy(smem, blocks_per_sm); });
}

#ifdef FUSED_PHASE_CLOCKS
// Copies the per-phase cycle sums of the launches since the last call to
// out[0..kPhases) (fused_draws' signature) and clears them; call after the
// launches are complete.  Returns a cudaError_t.
extern "C" int fused_phase_clocks(unsigned long long* out) {
  const unsigned long long zero[kPhases] = {};
  cudaError_t rc = cudaMemcpyFromSymbol(out, g_phase, sizeof(zero));
  if (rc == cudaSuccess) rc = cudaMemcpyToSymbol(g_phase, zero, sizeof(zero));
  return rc;
}
#endif
