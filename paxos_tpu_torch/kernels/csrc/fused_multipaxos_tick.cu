// Fused Multi-Paxos engine for Hopper (sm_90a): n_ticks ticks of
// mp_counter_masks + apply_tick_mp for every instance in one launch.
//
// Replaces: paxos_tpu/kernels/fused_tick.py::_kernel bound to the
// Multi-Paxos tick (fused_fns("multipaxos")), the Pallas kernel that keeps
// a block of instances' state resident in VMEM for a whole chunk.
//
// Bound on this card: a lane's state is 1400 B unpacked at an 8-slot
// window (2272 B at 16 slots), read and written once per chunk: about
// 0.9 ms per 1<<20 lanes at 3.35 TB/s.  The reference's census counts
// about 6800 int32 operations per lane-tick with every mask drawn, so at 64
// ticks per chunk the kernel is bound by integer operations, not bytes.
//
// Design: one thread per instance (lane), as K1 to K4, but the state does
// not fit in registers (about 350 32-bit words at 8 slots, 570 at 16), so
// it is split by access pattern, and each part stays where it is for the
// whole chunk:
//  - registers: the per-lane scalars (promises, the proposers' fields, the
//    request buffer, the PROMISE ballots, the ACCEPTED buffer, the
//    chosen-slot bitmask and the counters);
//  - shared memory: the slot-indexed arrays that a tick reads or writes at
//    a data-dependent slot (acceptor log, recovery rows, the learner's
//    per-slot tables, the voter masks packed four to a word, chosen values
//    and ticks) and, where the occupancy allows, the PROMISE payloads
//    (Staged; the instantiations' table K5_INSTANCES below).  Each
//    thread owns one column of the block's buffer: its word r sits at
//    smem[r * B + t], B the block's lane count (a multiple of 32), so a
//    row picked by the lane's own slot falls in bank t % 32 and a warp's
//    accesses are free of bank conflicts whatever slot each lane is on.
//    The column is loaded once at the start of the chunk and stored once
//    at its end, from and to [row * n_inst + lane] (one 128-B line per row
//    across a warp).  A thread touches only its own column, so the kernel
//    needs no barrier, and lanes past n_inst return at once;
//  - global memory, in place: the PROMISE payloads where they are not
//    staged, read and written in loops over the slots only (an election's
//    copy and fold), so a warp's accesses coalesce.
// A slot array is touched only where the tick reads or writes it: a PROMISE
// payload when one is sent or delivered to a candidate, the learner rows of
// the slots this tick's accept events hit, the recovery row a leader
// proposes from.  The reference writes whole arrays every tick because a
// branch costs more than a masked write on the TPU; on this card a per-lane
// branch is cheap.
//
// What sets the pace on the card: a lane's tick is one long chain of
// dependent integer operations and branches, so the time falls with the
// warps an SM holds (at most 8 at 255 registers a thread) and with the
// length of the chain, not with bytes.  Hence the packed voter masks (8
// warps at a 16-slot window, where shared memory would allow 6), loops over
// the slots that stay rolled (a row index costs nothing in shared memory,
// and unrolled they made the code larger than the instruction cache), and
// fewer, shorter draw sites: draws grouped where they are independent
// (survivors, firing) with the knob's mode tested once, loops over the set
// bits only (firing, select_present), and one reply draw an acceptor.
//
// Semantics follow the plain PyTorch version (protocols/multipaxos.py and
// check/mp_safety.py) exactly; the PRNG, stream positions and argument
// layout are in fused_common.cuh.  Stream positions are keyed by the global
// lane index, whatever the CUDA block's size.
//  - masks are drawn lazily, where they can change the outcome (the
//    election jitter only when the lease timer sits inside the jitter's
//    range); the result is the same as drawing them all.  The measuring
//    build counts the draws and the slot-array elements each tick touches,
//    wherever the element lives.
//  - reply delivery and consume come first; candidates fold the pre-tick
//    PROMISE payloads before this tick's PROMISEs overwrite them; PROMISE
//    carries the log as it stood before this tick's accept write; the
//    learner reads the pre-tick chosen slots for its re-confirmation skip
//    and the proposers the new chosen count; sends go into the consumed
//    request buffer.
//  - the learner fold is sequential per acceptor within a slot; events on
//    different slots touch different rows, so the kernel folds slot by
//    slot.  Rows of slots no event hits are unchanged, as are the chosen
//    values and ticks of unchosen slots, which the plain version rewrites
//    to 0 and -1: in every state the engine reaches they already hold
//    those values.
//  - the per-tick clamp pins proposer ballots at 2047, the report limit.
//
// The gray-failure and partition arms (partition cuts, one-way cuts,
// per-link loss and duplication thresholds, payload corruption, timer skew,
// stale-snapshot recovery and amnesia) compile into an instantiation of
// their own (ARMS, at (2,5,8,4), config3's shape), which the C entry picks
// when a knob of theirs is on; the default instantiations compile none of
// their code.  They follow K1 to K3's (the pieces in fused_common.cuh, sd::,
// with Multi-Paxos' stream ids): a cut masks the delivered replies and the
// selected request after the draws that select them, which are keyed by
// position, so they are made as before; LINK_BITS (where a message is
// sent), DUP_BITS (where a request is selected) and CORRUPT (where an
// acceptor processes a request) are drawn only at the site that reads
// them, each per-link threshold read from the plan there; the snapshot
// shadows of promised and the slot log stay in global memory, read on a
// recovery tick and written on a snapshot tick, the log's from and to the
// lane's column.
//
// The bounded-delay channel (p_delay: delay stamps on every send, readiness
// gates on PROMISE and ACCEPTED delivery and on the request selection)
// compiles into the stamped instantiations (STAMPED, at (2,5,8,4), without
// and with the arms), for a state whose three buffers carry `until`
// stamps: K1's design (sd::Channel in fused_common.cuh), with Multi-Paxos'
// stream ids and kind order (0 PROMISE, 1 ACCEPTED, 2 PREPARE, 3 ACCEPT).
// The 4PA stamps of a lane (the requests' 2PA, then the PROMISEs' and the
// ACCEPTEDs' PA each) join its column; the slots still waiting for theirs
// sit in a bitmask per direction (the replies' PROMISEs first), refreshed
// at the tick's start, and a tick's sends are stamped by one rolled loop a
// direction, at exactly the plain tick's send sites: a leader's ACCEPT,
// re-sent every tick, takes a new stamp every tick.  To keep 2 blocks of
// 128 lanes an SM with the stamps in the column, the stamped
// instantiations leave the PROMISE payloads in global memory (Staged).
//
// The observer planes (telemetry, coverage, exposure, margin, the client
// workload) compile into observed instantiations of their own (OBS, at
// (2,5,8,4), without and with the stamps and the arms), as K1's to K4's:
// the kernel takes an obs::Obs after the Gray (if any), keeps the planes'
// counters in the lane's column after the staged rows (obs::Rows; with
// the PROMISE payloads staged, 241 words, 281 stamped, 2 blocks of 96 lanes
// an SM: fused_tick.MP_STAGING), draws
// exposure's whole masks at the tick's start with Multi-Paxos' stream ids
// (obs::predraw over MpStreams: four send kinds, requests-only
// duplication) and reads them at the lazy sites.  What is Multi-Paxos' own:
// the margin runs over the (L, K) learner table (obs::mp_margin) with each
// acceptor's highest accepted ballot over its log as the promise fence's
// partner; a timeout is a candidacy failure; a committed log slot serves a
// client request; and the coverage digest folds the whole lane (the log,
// the recovery rows, three buffers with the PROMISE payloads, `base`) in the
// reference's leaf order, 296 words a tick (336 stamped).  The other
// instantiations call the sd:: sites directly, as before the planes.  The
// long log's observed instantiation (at (2,5,16,4), no arms or stamps)
// is the same code at LOG 16: its column (433 words with the counters and
// the PROMISE payloads; fused_tick.MP_STAGING) takes 2 blocks of 64 lanes,
// 4 warps an SM (leaving the payloads in global memory, 273 words at 96
// lanes, ran the chunk 1.5 times as long: the digest folds 432 words a
// tick, 160 of them payloads).  Every plane
// value is loaded at a launch's start and stored at its end, so the
// compaction between chunks (which shifts the window) sees them all.
//
// The ablated builds (-DFUSED_ABLATE, fused_common.cuh) instantiate
// config3's key only and remove their components where the tick runs
// them: no draw, the highest present slot selected and no jitter or
// backoff (prng), no acceptor awake (select), no PROMISE, ACCEPTED,
// PREPARE or ACCEPT written (sends), delivered replies and selected
// requests left present (consume), no learner fold, and a chosen count of
// 0 for the proposers, as the plain ablated tick gives them (learner), no
// proposer fold or half-tick but the per-tick clamp (proposer).

#include <type_traits>

#include "fused_common.cuh"

namespace {

// Proposer phases (core/mp_state.py).
constexpr int32_t kFollow = 0, kCandidate = 1, kLead = 2;
constexpr int32_t kMpBallotLimit = (1 << 11) - 1;  // Multi-Paxos report-time limit
constexpr int kMpLeaves = 29;                      // per-lane state leaves
constexpr int kMpStampedLeaves = 32;               // the same with the three buffers' stamps
constexpr int32_t kValMask = 0xFFFF;               // bv_val of a packed pair

// Multi-Paxos stream ids (core/streams.py MULTI_PAXOS_STREAMS); SEL and
// BUSY share the single-decree ids.
constexpr uint32_t kMpDupReq = 2, kPromDeliver = 3, kAccdDeliver = 4, kMpKeepProm = 5,
                   kMpKeepAccd = 6, kKeepPrep = 7, kKeepAcc = 8, kJitter = 9, kMpBackoff = 10,
                   kMpLinkBits = 11, kMpDupBits = 12, kMpCorrupt = 13, kMpDelayBits = 14,
                   kMpLatBits = 15, kMpArrival = 16;

// The stream ids exposure's draws come from (obs::predraw): the four send
// kinds in LINK_BITS' order, and the requests' duplication only.
struct MpStreams {
  __host__ __device__ static constexpr uint32_t keep(int kind) {
    return kind == 0 ? kMpKeepProm : kind == 1 ? kMpKeepAccd : kind == 2 ? kKeepPrep : kKeepAcc;
  }
  static constexpr uint32_t link = kMpLinkBits, dup_req = kMpDupReq, dup_rep = kMpDupReq,
                            dup = kMpDupBits, corrupt = kMpCorrupt, delay = kMpDelayBits;
  static constexpr int dup_bufs = 1;
};

// The tick's phases in order, as the phase-clock build splits a lane's
// cycles (fused_tick.PHASES["multipaxos"]).
enum Phase {
  kPhLoad, kPhDeliver, kPhFold, kPhAcceptor, kPhLearner, kPhProposer, kPhObs, kPhStore,
  kPhases,
};

// The state leaves in the reference's flatten order, tick excluded; a
// state with delay stamps has each buffer's `until` after its own leaves
// (at kMpStampAt), and one with snapshot shadows (stale_k: promised (A),
// the log (A, L)) has them after the two acceptor leaves; the C entry
// moves the shadows after the rest, then the stamps last (read_gray_args),
// so the stamps sit at kRqUntil on and the shadows at kMpLeaves, or at
// kMpStampedLeaves in a stamped state.
struct Mp {
  enum Leaf : int {
    kPromised, kLog,
    kBal, kPhase, kHeard, kCommitIdx, kRecov, kLeaseTimer, kLastCount, kCandTimer,
    kLtBv, kLtMask, kChosen, kChosenVal, kChosenTick, kViolations, kEvictions,
    kRqBal, kRqV1, kRqV2, kRqPresent,
    kPromPresent, kPromBal, kPromBv,
    kAccdPresent, kAccdBal, kAccdSlot, kAccdVal,
    kBase,
    kRqUntil, kPromUntil, kAccdUntil,  // (2, P, A), (P, A), (P, A), with stamps only
  };
};
constexpr int kMpSnapAt = Mp::kLog + 1, kMpSnaps = 2;  // where the shadows arrive, and how many
// Where a stamped state's three stamp leaves arrive in flatten order.
constexpr int kMpStampAt[3] = {Mp::kRqPresent + 1, Mp::kPromBv + 2, Mp::kAccdVal + 3};

// Element (row, lane) of a state leaf in global memory.
template <typename T>
__device__ __forceinline__ T& at(const Leaves& L, int leaf, int row, int64_t n, int64_t i) {
  return reinterpret_cast<T*>(L.p[leaf])[row * n + i];
}

// pack_bv(bal, val) = bal << 16 | val, with the shift done unsigned.
__device__ __forceinline__ int32_t pack_bv(int32_t bal, int32_t val) {
  return static_cast<int32_t>((static_cast<uint32_t>(bal) << 16) | static_cast<uint32_t>(val));
}

// A lane's staged rows, in column order: each leaf's rows in the leaf's own
// row order (the slot index minor), the three buffers' delay stamps where
// STAMPED, the PROMISE payloads last where PROM.
// The learner's voter masks are acceptor bitmasks, below 2^A <= 2^8 in
// every state the engine reaches, so the K <= 4 masks of a slot share one
// word, mask k in bits [8k, 8k + 8): a slot's masks are read and written
// at once, and the column is L * (K - 1) words shorter.  Mirrored by
// fused_tick.mp_staged_rows.
template <int P, int A, int LOG, int K, bool STAMPED, bool PROM>
struct Staged {
  static_assert(K <= 4 && A <= 8, "a slot's voter masks must fit one word");
  static constexpr int kLog = 0;                        // acceptor.log (A, L)
  static constexpr int kRecov = kLog + A * LOG;         // proposer.recov_bv (P, L)
  static constexpr int kLtBv = kRecov + P * LOG;        // learner.lt_bv (L, K)
  static constexpr int kLtMask = kLtBv + LOG * K;       // learner.lt_mask (L, K), packed
  static constexpr int kChosenVal = kLtMask + LOG;      // learner.chosen_val (L)
  static constexpr int kChosenTick = kChosenVal + LOG;  // learner.chosen_tick (L)
  static constexpr int kRqUntil = kChosenTick + LOG;    // requests.until (2, P, A), if STAMPED
  static constexpr int kPromUntil = kRqUntil + (STAMPED ? 2 * P * A : 0);  // promises.until (P, A)
  static constexpr int kAccdUntil = kPromUntil + (STAMPED ? P * A : 0);    // accepted.until (P, A)
  static constexpr int kPromBv = kAccdUntil + (STAMPED ? P * A : 0);  // promises.p_bv (P, A, L), if PROM
  static constexpr int kRows = kPromBv + (PROM ? P * A * LOG : 0);
};

// The bits of `eligible` (bit a: prefix base + a, a < N) at which
// bern_not(knob) survives: each draws once when the knob draws, all survive
// when it is off, none when it always fires.  The knob's mode is tested
// once, so the draws are independent of one another and may overlap.
template <int N>
__device__ __forceinline__ uint32_t survivors(const TickStream& ts, const Knob& k, uint32_t stream,
                                              int base, uint32_t eligible) {
  if (k.mode == 0) return eligible;
  uint32_t out = 0;
  if (k.mode == 1) {
#pragma unroll
    for (int a = 0; a < N; ++a)
      if ((eligible >> a) & 1u) out |= (ts.bits(stream, base + a) >= k.thr ? 1u : 0u) << a;
  }
  return out;
}

// The bits of `present` at which bern(knob) fires (prefix = bit index), the
// knob on: one draw a set bit when it draws, all when it always fires.
__device__ __forceinline__ uint32_t firing(const TickStream& ts, const Knob& k, uint32_t stream,
                                           uint32_t present) {
  if (k.mode == 2) return present;
  uint32_t out = 0;
  for (uint32_t m = present; m != 0; m &= m - 1) {
    const int j = __ffs(m) - 1;
    if (ts.bits(stream, j) < k.thr) out |= 1u << j;
  }
  return out;
}

// The acceptors that keep proposer p's broadcast of kind `kind` (2
// PREPARE, 3 ACCEPT: LINK_BITS' axis): on flaky links each against its own
// drop threshold, else the uniform p_drop mask of `stream`.
template <bool ARMS, int P, int A>
__device__ __forceinline__ uint32_t sends_kept(const TickStream& ts, const Params& prm,
                                               const Gray& gray, uint32_t stream, int kind, int p,
                                               int64_t n, int64_t i) {
  if (ARMS && gray.flaky) {
    uint32_t out = 0;
#pragma unroll
    for (int a = 0; a < A; ++a)
      out |= (sd::kept<ARMS, P * A, kMpLinkBits>(ts, prm, gray, stream, kind, p * A + a, n, i)
                  ? 1u : 0u) << a;
    return out;
  }
  return survivors<A>(ts, prm.drop, stream, p * A, (1u << A) - 1);
}

// Request selection for acceptor a (the plain select_from_scores),
// drawing over its present request slots only: the scores are distinct
// (kp in the low bits), so the order of the draws does not change the
// winner.
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

// Rows [0, ROWS) of a leaf to (from) the column from row OFF on.
template <int ROWS, int OFF, int B>
__device__ __forceinline__ void load_rows(const Column<B>& col, const Leaves& L, int leaf,
                                          int64_t n, int64_t i) {
  const int32_t* g = static_cast<const int32_t*>(L.p[leaf]) + i;
#pragma unroll 8
  for (int r = 0; r < ROWS; ++r) col[OFF + r] = g[r * n];
}

template <int ROWS, int OFF, int B>
__device__ __forceinline__ void store_rows(const Column<B>& col, const Leaves& L, int leaf,
                                           int64_t n, int64_t i) {
  int32_t* g = static_cast<int32_t*>(L.p[leaf]) + i;
#pragma unroll 8
  for (int r = 0; r < ROWS; ++r) g[r * n] = col[OFF + r];
}

// The (LOG, K) voter masks to (from) one packed word a slot from row OFF on.
template <int LOG, int K, int OFF, int B>
__device__ __forceinline__ void load_masks(const Column<B>& col, const Leaves& L, int leaf,
                                           int64_t n, int64_t i) {
  const int32_t* g = static_cast<const int32_t*>(L.p[leaf]) + i;
#pragma unroll 4
  for (int s = 0; s < LOG; ++s) {
    uint32_t w = 0;
#pragma unroll
    for (int k = 0; k < K; ++k) w |= (static_cast<uint32_t>(g[(s * K + k) * n]) & 0xFFu) << (8 * k);
    col[OFF + s] = static_cast<int32_t>(w);
  }
}

template <int LOG, int K, int OFF, int B>
__device__ __forceinline__ void store_masks(const Column<B>& col, const Leaves& L, int leaf,
                                            int64_t n, int64_t i) {
  int32_t* g = static_cast<int32_t*>(L.p[leaf]) + i;
#pragma unroll 4
  for (int s = 0; s < LOG; ++s) {
    const uint32_t w = static_cast<uint32_t>(col[OFF + s]);
#pragma unroll
    for (int k = 0; k < K; ++k) g[(s * K + k) * n] = static_cast<int32_t>((w >> (8 * k)) & 0xFFu);
  }
}

template <int P, int A, int LOG, int K, int B, bool STAMPED, bool PROM>
__device__ __forceinline__ void load_column(const Column<B>& col, const Leaves& L, int64_t n,
                                            int64_t i) {
  using G = Staged<P, A, LOG, K, STAMPED, PROM>;
  load_rows<A * LOG, G::kLog>(col, L, Mp::kLog, n, i);
  load_rows<P * LOG, G::kRecov>(col, L, Mp::kRecov, n, i);
  load_rows<LOG * K, G::kLtBv>(col, L, Mp::kLtBv, n, i);
  load_masks<LOG, K, G::kLtMask>(col, L, Mp::kLtMask, n, i);
  load_rows<LOG, G::kChosenVal>(col, L, Mp::kChosenVal, n, i);
  load_rows<LOG, G::kChosenTick>(col, L, Mp::kChosenTick, n, i);
  if constexpr (STAMPED) {
    load_rows<2 * P * A, G::kRqUntil>(col, L, Mp::kRqUntil, n, i);
    load_rows<P * A, G::kPromUntil>(col, L, Mp::kPromUntil, n, i);
    load_rows<P * A, G::kAccdUntil>(col, L, Mp::kAccdUntil, n, i);
  }
  if constexpr (PROM) load_rows<P * A * LOG, G::kPromBv>(col, L, Mp::kPromBv, n, i);
}

template <int P, int A, int LOG, int K, int B, bool STAMPED, bool PROM>
__device__ __forceinline__ void store_column(const Column<B>& col, const Leaves& L, int64_t n,
                                             int64_t i) {
  using G = Staged<P, A, LOG, K, STAMPED, PROM>;
  store_rows<A * LOG, G::kLog>(col, L, Mp::kLog, n, i);
  store_rows<P * LOG, G::kRecov>(col, L, Mp::kRecov, n, i);
  store_rows<LOG * K, G::kLtBv>(col, L, Mp::kLtBv, n, i);
  store_masks<LOG, K, G::kLtMask>(col, L, Mp::kLtMask, n, i);
  store_rows<LOG, G::kChosenVal>(col, L, Mp::kChosenVal, n, i);
  store_rows<LOG, G::kChosenTick>(col, L, Mp::kChosenTick, n, i);
  if constexpr (STAMPED) {
    store_rows<2 * P * A, G::kRqUntil>(col, L, Mp::kRqUntil, n, i);
    store_rows<P * A, G::kPromUntil>(col, L, Mp::kPromUntil, n, i);
    store_rows<P * A, G::kAccdUntil>(col, L, Mp::kAccdUntil, n, i);
  }
  if constexpr (PROM) store_rows<P * A * LOG, G::kPromBv>(col, L, Mp::kPromBv, n, i);
}

// Row `row` (= j * LOG + l) of the PROMISE payloads: in the column where
// staged, else in place in global memory.
template <int P, int A, int LOG, int K, int B, bool STAMPED, bool PROM>
__device__ __forceinline__ int32_t& prom_word(const Column<B>& col, const Leaves& L, int row,
                                              int64_t n, int64_t i) {
  if constexpr (PROM) {
    return col[Staged<P, A, LOG, K, STAMPED, PROM>::kPromBv + row];
  } else {
    return at<int32_t>(L, Mp::kPromBv, row, n, i);
  }
}

// The kernel; `Arms` is empty for the default instantiations, whose
// signature and code are those of K5 without the arms, a `Gray` for the
// arms instantiations (ARMS), which take the arms' knobs and plan leaves,
// and an obs::Obs (after the Gray, if any) for the observed ones (OBS),
// which compute the observer planes whose leaves it holds.
// STAMPED: the state's buffers carry delay stamps.
template <int P, int A, int LOG, int K, bool STAMPED, int B, bool PROM, typename... Arms>
__global__ void __launch_bounds__(B)
fused_multipaxos_kernel(Leaves L, Plan plan, const int32_t* __restrict__ tick_ptr, Params prm,
                        Arms... arms) {
  constexpr bool ARMS = has_arg<Gray, Arms...>;
  constexpr bool OBS = has_arg<obs::Obs, Arms...>;
  const Gray gray = pick_arg<Gray>(arms...);
  const obs::Obs ob = pick_arg<obs::Obs>(arms...);
  static_assert(B % 32 == 0, "a block is whole warps");
  using G = Staged<P, A, LOG, K, STAMPED, PROM>;
  constexpr int R0 = G::kRows;  // the observer counters' first row (OBS)
  // The snapshot shadows' first leaf (after the stamps in a stamped state).
  constexpr int SNAP = STAMPED ? kMpStampedLeaves : kMpLeaves;
  constexpr int S = 2 * P * A;  // request slots, index (kind * P + p) * A + a
  constexpr int E = P * A;      // reply slots, index p * A + a
  constexpr int kQuorum = A / 2 + 1;
  static_assert(S <= 32 && LOG <= 32 && K <= 32, "bitmasks must fit 32 bits");
  static_assert(!OBS || 4 * E <= 64, "exposure's drop draws fit 64 bits");
  constexpr uint32_t kAccs = (1u << A) - 1;
  extern __shared__ int32_t smem[];  // G::kRows * B words (OBS: and the counters)

  const int64_t n = prm.n_inst;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * B + threadIdx.x;
  if (i >= n) return;
  PhaseClock<kPhases> clk;
  // A build ablated of the PRNG draws: every mask off.
  if constexpr (ablated(kNoPrng)) prm.idle.mode = prm.hold.mode = prm.dup.mode = prm.drop.mode = 0;
  const Column<B> col{smem + threadIdx.x};
  load_column<P, A, LOG, K, B, STAMPED, PROM>(col, L, n, i);
  if constexpr (OBS) obs::move_counters<P, R0>(col, ob, n, i, true);
  auto prom_bv = [&](int row) -> int32_t& {
    return prom_word<P, A, LOG, K, B, STAMPED, PROM>(col, L, row, n, i);
  };
  // The bounded-delay channel's waiting slots (STAMPED), as the column: the
  // replies' slot j < E is PROMISE j, E + j ACCEPTED j.
  sd::Channel<P, A, B, G::kRqUntil, G::kPromUntil, kMpDelayBits, kMpLatBits, 2> ch;
  if constexpr (STAMPED) ch.load(col, prm, plan, n, i, *tick_ptr);

  // ---- Load the lane's register-resident state once. ----
  int32_t promised[A], crash_start[A], crash_end[A];
  uint32_t equiv = 0;
#pragma unroll
  for (int a = 0; a < A; ++a) {
    promised[a] = at<int32_t>(L, Mp::kPromised, a, n, i);
    crash_start[a] = plan.crash_start[a * n + i];
    crash_end[a] = plan.crash_end[a * n + i];
    equiv |= (plan.equivocate[a * n + i] != 0 ? 1u : 0u) << a;
  }
  int32_t bal[P], phase[P], heard[P], commit_idx[P], lease_timer[P], last_count[P],
      cand_timer[P], pcrash_start[P], pcrash_end[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    bal[p] = at<int32_t>(L, Mp::kBal, p, n, i);
    phase[p] = at<int32_t>(L, Mp::kPhase, p, n, i);
    heard[p] = at<int32_t>(L, Mp::kHeard, p, n, i);
    commit_idx[p] = at<int32_t>(L, Mp::kCommitIdx, p, n, i);
    lease_timer[p] = at<int32_t>(L, Mp::kLeaseTimer, p, n, i);
    last_count[p] = at<int32_t>(L, Mp::kLastCount, p, n, i);
    cand_timer[p] = at<int32_t>(L, Mp::kCandTimer, p, n, i);
    pcrash_start[p] = plan.pcrash_start[p * n + i];
    pcrash_end[p] = plan.pcrash_end[p * n + i];
  }
  uint32_t chosen = 0;  // bit l: window slot l is chosen
#pragma unroll
  for (int l = 0; l < LOG; ++l) chosen |= (at<uint8_t>(L, Mp::kChosen, l, n, i) != 0 ? 1u : 0u) << l;
  int32_t violations = at<int32_t>(L, Mp::kViolations, 0, n, i);
  int32_t evictions = at<int32_t>(L, Mp::kEvictions, 0, n, i);
  int32_t rq_bal[S], rq_v1[S], rq_v2[S];
  uint32_t rq_present = 0;
#pragma unroll
  for (int j = 0; j < S; ++j) {
    rq_bal[j] = at<int32_t>(L, Mp::kRqBal, j, n, i);
    rq_v1[j] = at<int32_t>(L, Mp::kRqV1, j, n, i);
    rq_v2[j] = at<int32_t>(L, Mp::kRqV2, j, n, i);
    rq_present |= (at<uint8_t>(L, Mp::kRqPresent, j, n, i) != 0 ? 1u : 0u) << j;
  }
  int32_t prom_bal[E], accd_bal[E], accd_slot[E], accd_val[E];
  uint32_t prom_present = 0, accd_present = 0;
#pragma unroll
  for (int j = 0; j < E; ++j) {
    prom_present |= (at<uint8_t>(L, Mp::kPromPresent, j, n, i) != 0 ? 1u : 0u) << j;
    prom_bal[j] = at<int32_t>(L, Mp::kPromBal, j, n, i);
    accd_present |= (at<uint8_t>(L, Mp::kAccdPresent, j, n, i) != 0 ? 1u : 0u) << j;
    accd_bal[j] = at<int32_t>(L, Mp::kAccdBal, j, n, i);
    accd_slot[j] = at<int32_t>(L, Mp::kAccdSlot, j, n, i);
    accd_val[j] = at<int32_t>(L, Mp::kAccdVal, j, n, i);
  }
  const int32_t base = at<int32_t>(L, Mp::kBase, 0, n, i);
  // The arms: the lane's partition window, the links that cross its cut,
  // the cut's direction, the timeout skew.
  sd::GrayLane<P, A> glane;
  if constexpr (ARMS) glane.load(gray, n, i);

  const int32_t tick0 = *tick_ptr;
  const uint32_t blk = static_cast<uint32_t>(prm.blk0) + static_cast<uint32_t>(i / prm.block);
  const uint32_t lane = static_cast<uint32_t>(i % prm.block);
  clk.mark(kPhLoad);

  DrawCount draws;
  for (int t = 0; t < prm.n_ticks; ++t) {
    const int32_t tick = wrap_add(tick0, t);
    const TickStream ts{mix32(prm.seed, static_cast<uint32_t>(tick), blk),
                        static_cast<uint32_t>(prm.block), lane, &draws};
    // What the planes read of the pre-tick state (OBS).
    const uint32_t rq_p0 = rq_present, rp_p0 = prom_present | (accd_present << E);
    const uint32_t chosen0 = chosen;
    const int32_t viol0 = violations;
    // The slots whose stamp has come (STAMPED): a slot waiting for its
    // stamp is neither delivered nor selected.
    if constexpr (STAMPED) ch.refresh(col, tick, &draws);
    const uint32_t rq_ready = rq_present & (STAMPED ? ~ch.rq_wait : ~0u);

    // The links cut this tick, per direction (bit e: edge e).
    uint32_t cut_req = 0, cut_rep = 0;
    if constexpr (ARMS) glane.cuts(tick, cut_req, cut_rep);

    // The planes' counts of the tick (OBS), exposure's draws (an observed
    // instantiation's sites that draw read them instead where exposure made
    // them), and what the cuts and the stamps hold back of the pre-tick
    // buffers.
    int ev[obs::kEvents] = {}, inj[obs::kClasses] = {}, eff[obs::kClasses] = {};
    const obs::PreDraw pd =
        obs::predraw<OBS, ARMS, STAMPED, P, A, MpStreams>(ob, ts, prm, gray, ch.slow, n, i, inj);
    int n_drop = 0, n_dup = 0;
    uint32_t prom_m = 0, corrupt_m = 0, serve_m = 0, leader_m = 0, fail_m = 0, plain_fail = 0;
    if constexpr (OBS) {
      if (ARMS && gray.partition) {
        inj[obs::kClPartition] = __popc(cut_req) + __popc(cut_rep);
        eff[obs::kClPartition] = __popc(rq_p0 & (cut_req | (cut_req << E))) +
                                 __popc(rp_p0 & (cut_rep | (cut_rep << E)));
      }
      if constexpr (STAMPED) {
        if (prm.delay.mode != 0)
          eff[obs::kClDelay] = __popc(rq_p0 & ch.rq_wait) + __popc(rp_p0 & ch.rp_wait);
      }
    }

    // ---- Reply delivery decided and cleared before any new send; a reply
    //      still delayed, or on a cut link, stays in flight. ----
    uint32_t prom_del = prom_present, accd_del = accd_present;
    if constexpr (STAMPED) {
      prom_del &= ~ch.rp_wait;
      accd_del &= ~(ch.rp_wait >> E);
    }
    if constexpr (ARMS) {
      prom_del &= ~cut_rep;
      accd_del &= ~cut_rep;
    }
    if (prm.hold.mode != 0) {
      prom_del &= ~firing(ts, prm.hold, kPromDeliver, prom_del);
      accd_del &= ~firing(ts, prm.hold, kAccdDeliver, accd_del);
    }
    if constexpr (!ablated(kNoConsume)) {
      prom_present &= ~prom_del;
      accd_present &= ~accd_del;
    }
    clk.mark(kPhDeliver);

    // ---- Proposer folds over the pre-tick replies: voter bits, and the
    //      candidates' per-slot max over the PROMISE payloads. ----
#pragma unroll
    for (int p = 0; p < P; ++p) {
      if (ablated(kNoProposer)) break;
      uint32_t pv = 0;
#pragma unroll
      for (int a = 0; a < A; ++a) {
        const int j = p * A + a;
        if (phase[p] == kCandidate && ((prom_del >> j) & 1u) && prom_bal[j] == bal[p]) pv |= 1u << a;
        if (phase[p] == kLead && ((accd_del >> j) & 1u) && accd_bal[j] == bal[p] &&
            accd_slot[j] == commit_idx[p])
          heard[p] |= 1 << a;
      }
      heard[p] |= static_cast<int32_t>(pv);
      if (pv != 0) {
        draws.touch(LOG * (1 + __popc(pv)));  // recovery row, the voters' payloads
#pragma unroll 4
        for (int l = 0; l < LOG; ++l) {
          int32_t r = col[G::kRecov + p * LOG + l];
#pragma unroll
          for (int a = 0; a < A; ++a)
            if ((pv >> a) & 1u) r = max(r, prom_bv((p * A + a) * LOG + l));
          col[G::kRecov + p * LOG + l] = r;
        }
      }
    }

    // ---- Stale-snapshot recovery or amnesia of promised and the slot log
    //      (the column's rows), before the acceptor half-tick. ----
    sd::recover_with<ARMS, A>(
        gray, tick, crash_end,
        [&](int a) {
          draws.touch(2 * LOG);  // the log's shadow, read into the log
          promised[a] = at<int32_t>(L, SNAP, a, n, i);
#pragma unroll 1
          for (int l = 0; l < LOG; ++l)
            col[G::kLog + a * LOG + l] = at<int32_t>(L, SNAP + 1, a * LOG + l, n, i);
        },
        [&](int a) {
          draws.touch(2 * LOG);  // the log, read into its shadow
          at<int32_t>(L, SNAP, a, n, i) = promised[a];
#pragma unroll 1
          for (int l = 0; l < LOG; ++l)
            at<int32_t>(L, SNAP + 1, a * LOG + l, n, i) = col[G::kLog + a * LOG + l];
        },
        [&](int a) {
          draws.touch(LOG);
          promised[a] = 0;
#pragma unroll 1
          for (int l = 0; l < LOG; ++l) col[G::kLog + a * LOG + l] = 0;
        });

    clk.mark(kPhFold);

    // ---- Acceptor half-tick: at most one request per acceptor. ----
    uint32_t rq_next = rq_present, ev_flag = 0, alive = 0;
    uint32_t rp_sent = 0;  // the reply slots written this tick (PROMISE j, ACCEPTED E + j)
    int32_t ev_bal[A], ev_slot[A], ev_val[A];
#pragma unroll
    for (int a = 0; a < A; ++a) alive |= (!(crash_start[a] <= tick && tick < crash_end[a]) ? 1u : 0u) << a;
    // The acceptors that take a request this tick: alive and not idle.
    const uint32_t awake = ablated(kNoSelect) ? 0u : survivors<A>(ts, prm.idle, kBusy, 0, alive);
#pragma unroll
    for (int a = 0; a < A; ++a) {
      int sel = -1;
      if ((awake >> a) & 1u)  // an arrived request
        sel = ablated(kNoPrng) ? sd::select_last<P, A>(rq_ready, a)
                               : select_present<P, A>(ts, rq_ready, a);
      // A request on a cut link stays in flight: the acceptor processes
      // nothing this tick.
      if constexpr (ARMS) {
        if (sel >= 0 && ((cut_req >> ((sel * A + a) % E)) & 1u)) sel = -1;
      }
      int32_t mb = 0, mv = 0, ms = 0;
#pragma unroll
      for (int kp = 0; kp < 2 * P; ++kp) {
        if (kp == sel) {
          mb = rq_bal[kp * A + a];
          mv = rq_v1[kp * A + a];
          ms = rq_v2[kp * A + a];
        }
      }
      const bool is_prep = sel >= 0 && sel < P;
      const bool is_acc = sel >= P;
      // A corrupted ACCEPT's value flips a bit, a corrupted PREPARE's
      // ballot moves up one.
      if constexpr (OBS) {
        if (sel >= 0 && obs::corrupt_fires<ARMS, MpStreams>(pd, ts, gray, a)) {
          if (is_acc) mv ^= 64;
          else mb = wrap_add(mb, 1);
          corrupt_m |= 1u << a;
        }
      } else if constexpr (ARMS) {
        if (sel >= 0) sd::corrupt<ARMS, kMpCorrupt>(ts, gray, a, is_acc, mb, mv);
      }
      const bool eq = (equiv >> a) & 1u;
      const bool ok_prep_h = is_prep && !eq && mb > promised[a];
      const bool ok_prep = ok_prep_h || (is_prep && eq);
      const bool ok_acc_h = is_acc && !eq && mb >= promised[a];
      const bool ok_acc = ok_acc_h || (is_acc && eq);
      int32_t pr = ok_prep_h ? mb : promised[a];
      if (ok_acc_h) pr = max(pr, mb);

      // Replies to the selected sender (post-consume buffers), edge
      // rj = sender * A + a: one drop draw where a reply is due (on a flaky
      // link against its own threshold).  A PROMISE carries the log before
      // any accept write: an acceptor that takes a PREPARE this tick writes
      // no log slot.
      const int rj = (is_prep ? sel : sel - P) * A + a;
      const bool keep_prom =
          !ablated(kNoSends) && ok_prep &&
          (OBS ? obs::keep_at<OBS, ARMS, E, MpStreams>(pd, ts, prm, gray, kMpKeepProm, 0, rj, n, i)
               : sd::kept<ARMS, E, kMpLinkBits>(ts, prm, gray, kMpKeepProm, 0, rj, n, i));
      const bool keep_accd =
          !ablated(kNoSends) && ok_acc &&
          (OBS ? obs::keep_at<OBS, ARMS, E, MpStreams>(pd, ts, prm, gray, kMpKeepAccd, 1, rj, n, i)
               : sd::kept<ARMS, E, kMpLinkBits>(ts, prm, gray, kMpKeepAccd, 1, rj, n, i));
      if constexpr (STAMPED) {
        if (keep_prom) rp_sent |= 1u << rj;
        if (keep_accd) rp_sent |= 1u << (E + rj);
      }
      if (keep_prom) {
        draws.touch(eq ? LOG : 2 * LOG);  // the payload, and the log it copies
#pragma unroll 1
        for (int l = 0; l < LOG; ++l) prom_bv(rj * LOG + l) = eq ? 0 : col[G::kLog + a * LOG + l];
      }
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const int j = p * A + a;
        if (keep_prom && j == rj) {
          prom_present |= 1u << j;
          prom_bal[j] = mb;
        }
        if (keep_accd && j == rj) {
          accd_present |= 1u << j;
          accd_bal[j] = mb;
          accd_slot[j] = ms;
          accd_val[j] = mv;
        }
      }
      if (ok_acc && ms >= 0 && ms < LOG) {
        col[G::kLog + a * LOG + ms] = pack_bv(mb, mv);
        draws.touch(1);
      }
      // Consume the selected request unless it is duplicated (on a flaky
      // link, against its own threshold).
      if (sel >= 0) {
        const int j = sel * A + a;
        const bool dup =
            !ablated(kNoConsume) && sd::dup_live<ARMS>(prm, gray) &&
            (OBS ? obs::dup_at<OBS, ARMS, S, E, MpStreams>(pd, ts, prm, gray, 0, j, kMpDupReq, n, i)
                 : sd::duplicated<ARMS, S, E, kMpDupBits>(ts, prm, gray, kMpDupReq, 0, j, n, i));
        if (!ablated(kNoConsume) && !dup) rq_next &= ~(1u << j);
        if constexpr (OBS) {
          n_dup += dup ? 1 : 0;
          n_drop += (ok_prep && !keep_prom ? 1 : 0) + (ok_acc && !keep_accd ? 1 : 0);
        }
      }
      if constexpr (OBS) prom_m |= (ok_prep ? 1u : 0u) << a;
      promised[a] = pr;
      ev_flag |= (ok_acc ? 1u : 0u) << a;
      ev_bal[a] = mb;
      ev_slot[a] = ms;
      ev_val[a] = mv;
    }
    rq_present = rq_next;
    // The replies' delay stamps (the stamp draws are keyed by the slot, so
    // one rolled loop serves both reply sites).
    if constexpr (STAMPED && OBS) {
      obs::stamp_sends<OBS>(ch, pd, col, G::kPromUntil, ch.rp_wait, 1, rp_sent, prm, plan, ts, n,
                            i, tick, &draws);
    } else if constexpr (STAMPED) {
      ch.stamp_sends(col, G::kPromUntil, ch.rp_wait, 1, rp_sent, prm, plan, ts, n, i, tick, &draws);
    }
    clk.mark(kPhAcceptor);

    // ---- Learner: fold the accept events into the per-slot tables. ----
    // The events that reach the fold: in the window, with a ballot, and
    // not re-confirming the slot's (pre-tick) chosen value.
    uint32_t fold = 0;
#pragma unroll
    for (int a = 0; a < A; ++a) {
      const int32_t s = ev_slot[a];
      if (ablated(kNoLearner) || !(((ev_flag >> a) & 1u) && ev_bal[a] > 0 && s >= 0 && s < LOG))
        continue;
      if ((chosen >> s) & 1u) {
        draws.touch(1);
        if (ev_val[a] == col[G::kChosenVal + s]) continue;
      }
      fold |= 1u << a;
    }
    int viol = 0;
    uint32_t folded = 0;
#pragma unroll
    for (int a = 0; a < A; ++a) {
      if (!((fold >> a) & 1u) || ((folded >> a) & 1u)) continue;
      const int32_t s = ev_slot[a];
      int32_t rbv[K], rmask[K];
      uint32_t pre = 0;
      draws.touch(2 * K);  // the slot's table rows, read and written back
      const uint32_t masks = static_cast<uint32_t>(col[G::kLtMask + s]);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        rbv[k] = col[G::kLtBv + s * K + k];
        rmask[k] = static_cast<int32_t>((masks >> (8 * k)) & 0xFFu);
        pre |= (__popc(static_cast<uint32_t>(rmask[k])) >= kQuorum ? 1u : 0u) << k;
      }
      // This slot's events, in acceptor order (earlier acceptors hit other
      // slots: their slots were folded already).
#pragma unroll
      for (int b = 0; b < A; ++b) {
        if (b < a || !((fold >> b) & 1u) || ev_slot[b] != s) continue;
        folded |= 1u << b;
        const int32_t bv = pack_bv(ev_bal[b], ev_val[b]);
        const int32_t bit = 1 << b;
        bool any_match = false;
#pragma unroll
        for (int k = 0; k < K; ++k) {
          if (rbv[k] == bv) {
            rmask[k] |= bit;
            any_match = true;
          }
        }
        if (any_match) continue;
        int32_t min_bv = rbv[0];
#pragma unroll
        for (int k = 1; k < K; ++k) min_bv = min(min_bv, rbv[k]);
        if (min_bv == 0 || ev_bal[b] > (min_bv >> 16)) {
          bool done = false;
#pragma unroll
          for (int k = 0; k < K; ++k) {
            if (!done && rbv[k] == min_bv) {
              rbv[k] = bv;
              rmask[k] = bit;
              done = true;
            }
          }
          if (min_bv != 0) ++evictions;
        } else {
          ++evictions;
        }
      }
      uint32_t newly = 0, packed = 0;
      int32_t first_val = 0;
#pragma unroll
      for (int k = K - 1; k >= 0; --k) {
        if (__popc(static_cast<uint32_t>(rmask[k])) >= kQuorum && !((pre >> k) & 1u)) {
          newly |= 1u << k;
          first_val = rbv[k] & kValMask;
        }
        col[G::kLtBv + s * K + k] = rbv[k];
        packed |= static_cast<uint32_t>(rmask[k]) << (8 * k);
      }
      col[G::kLtMask + s] = static_cast<int32_t>(packed);
      if (newly != 0) {
        int32_t cv = first_val;
        if ((chosen >> s) & 1u) {
          cv = col[G::kChosenVal + s];
          draws.touch(1);
        } else {
          draws.touch(2);
          chosen |= 1u << s;
          col[G::kChosenVal + s] = first_val;
          col[G::kChosenTick + s] = tick;
        }
#pragma unroll
        for (int k = 0; k < K; ++k)
          if (((newly >> k) & 1u) && (rbv[k] & kValMask) != cv) ++viol;
      }
    }
    violations = wrap_add(violations, viol);
    const int32_t chosen_count = ablated(kNoLearner) ? 0 : __popc(chosen);
    clk.mark(kPhLearner);

    // ---- Proposer half-tick. ----
    uint32_t rq_sent = 0;  // the request slots written this tick
    const bool log_full = chosen_count >= LOG ||
                          (prm.log_total != 0 && wrap_add(base, chosen_count) >= prm.log_total);
#pragma unroll
    for (int p = 0; p < P; ++p) {
      if (ablated(kNoProposer)) {
        if (prm.clamp_per_tick) bal[p] = min(bal[p], kMpBallotLimit);
        continue;
      }
      const int32_t ph = phase[p];
      const int votes = __popc(static_cast<uint32_t>(heard[p]));
      const bool p1_done = ph == kCandidate && votes >= kQuorum;
      const bool slot_done = ph == kLead && votes >= kQuorum && commit_idx[p] < LOG;
      // Progress lease: a newly chosen slot resets every proposer's timer.
      int32_t lt = chosen_count > last_count[p] ? 0 : wrap_add(lease_timer[p], 1);
      last_count[p] = max(last_count[p], chosen_count);
      const bool lease_out = lt > prm.lease_len;
      const bool p_alive = !(pcrash_start[p] <= tick && tick < pcrash_end[p]);

      // Election: staggered by pid and jittered by a draw in [0, backoff_n).
      bool start_elec = false;
      if (ph == kFollow && p_alive && !log_full) {
        const int32_t thr = prm.lease_len + p * 3;
        if (lt > thr + prm.backoff_n - 1) {
          start_elec = true;
        } else if (lt > thr) {
          const uint32_t r = ablated(kNoPrng) ? 0u : ts.bits(kJitter, p) & 0x7FFFFFFFu;
          start_elec = lt > thr + static_cast<int32_t>(r % static_cast<uint32_t>(prm.backoff_n));
        }
      }
      const int32_t ct = ph == kCandidate ? wrap_add(cand_timer[p], 1) : 0;
      const int32_t timeout = ARMS ? glane.timeout(prm.timeout, p) : prm.timeout;
      const bool cand_fail = ph == kCandidate && ct > timeout && !p1_done;
      const bool demote = ph == kLead && lease_out && !slot_done && !log_full;
      if constexpr (OBS) {  // the commit and leader edges, and the failure under the unskewed timeout
        serve_m |= (slot_done ? 1u : 0u) << p;
        leader_m |= (p1_done || demote ? 1u : 0u) << p;
        fail_m |= (cand_fail ? 1u : 0u) << p;
        plain_fail |= (ph == kCandidate && ct > prm.timeout && !p1_done ? 1u : 0u) << p;
      }

      // Phase writes in precedence order: the last one wins.
      int32_t nph = ph;
      if (start_elec) nph = kCandidate;
      if (p1_done) nph = kLead;
      if (cand_fail || demote) nph = kFollow;
      if (!p_alive) nph = kFollow;  // crashed -> follower on recovery

      const int32_t bal_next = start_elec ? next_ballot(bal[p], prm.stride, p) : bal[p];
      int32_t ci = p1_done ? 0 : commit_idx[p];
      if (slot_done) ci = ci + 1;
      if (p1_done || slot_done || start_elec || cand_fail || demote) heard[p] = 0;
      if (start_elec) {
        draws.touch(LOG);
#pragma unroll 1
        for (int l = 0; l < LOG; ++l) col[G::kRecov + p * LOG + l] = 0;
      }
      if (start_elec || p1_done || slot_done) lt = 0;
      if (cand_fail || demote) {
        // Retreat below the election threshold (the timer may go negative),
        // stretched by the backoff skew.
        const uint32_t r = ablated(kNoPrng) ? 0u : ts.bits(kMpBackoff, p) & 0x7FFFFFFFu;
        lt = prm.lease_len - static_cast<int32_t>(sd::skewed_backoff<ARMS>(
                                 r % static_cast<uint32_t>(2 * prm.backoff_n), gray, p, n, i));
      }

      // New candidates broadcast Prepare(b) once.
      if (!ablated(kNoSends) && start_elec) {
        const uint32_t kept =
            OBS && pd.on ? ~static_cast<uint32_t>(pd.drop >> (2 * E + p * A)) & kAccs
                         : sends_kept<ARMS, P, A>(ts, prm, gray, kKeepPrep, 2, p, n, i);
        if constexpr (OBS) n_drop += A - __popc(kept);
#pragma unroll
        for (int a = 0; a < A; ++a) {
          if ((kept >> a) & 1u) {
            const int j = (0 * P + p) * A + a;
            rq_bal[j] = bal_next;
            rq_v1[j] = 0;
            rq_v2[j] = 0;
            rq_present |= 1u << j;
            rq_sent |= 1u << j;
          }
        }
      }
      // Leaders re-broadcast the current slot's Accept every tick, never
      // past the global log end.
      const bool is_lead = nph == kLead && p_alive && ci < LOG &&
                           (prm.log_total == 0 || wrap_add(base, ci) < prm.log_total);
      if (!ablated(kNoSends) && is_lead) {
        const int32_t slot = min(ci, LOG - 1);
        const int32_t rbv = slot >= 0 ? col[G::kRecov + p * LOG + slot] : 0;
        draws.touch(slot >= 0 ? 1 : 0);
        // Commands are keyed by global slot: own_slot_value(pid, base + slot).
        const int32_t pval = rbv > 0 ? (rbv & kValMask) : (p + 1) * 1000 + wrap_add(base, slot);
        const uint32_t kept =
            OBS && pd.on ? ~static_cast<uint32_t>(pd.drop >> (3 * E + p * A)) & kAccs
                         : sends_kept<ARMS, P, A>(ts, prm, gray, kKeepAcc, 3, p, n, i);
        if constexpr (OBS) n_drop += A - __popc(kept);
#pragma unroll
        for (int a = 0; a < A; ++a) {
          if ((kept >> a) & 1u) {
            const int j = (1 * P + p) * A + a;
            rq_bal[j] = bal_next;
            rq_v1[j] = pval;
            rq_v2[j] = slot;
            rq_present |= 1u << j;
            rq_sent |= 1u << j;
          }
        }
      }
      // (An observed tick clamps after the planes: the digest reads the
      // ballots as the tick left them.)
      bal[p] = !OBS && prm.clamp_per_tick ? min(bal_next, kMpBallotLimit) : bal_next;
      phase[p] = nph;
      commit_idx[p] = ci;
      lease_timer[p] = lt;
      cand_timer[p] = start_elec ? 0 : ct;
    }
    // The requests' delay stamps.
    if constexpr (STAMPED && OBS) {
      obs::stamp_sends<OBS>(ch, pd, col, G::kRqUntil, ch.rq_wait, 0, rq_sent, prm, plan, ts, n, i,
                            tick, &draws);
    } else if constexpr (STAMPED) {
      ch.stamp_sends(col, G::kRqUntil, ch.rq_wait, 0, rq_sent, prm, plan, ts, n, i, tick, &draws);
    }
    clk.mark(kPhProposer);

    // ---- The observer planes (OBS), from the tick's events, in the plain
    //      tick's order: telemetry, exposure, margin, workload, coverage. ----
    if constexpr (OBS) {
      ev[obs::kEvPromise] = __popc(prom_m);
      ev[obs::kEvAccept] = __popc(ev_flag);
      ev[obs::kEvDecide] = __popc(chosen & ~chosen0);
      ev[obs::kEvConflict] = wrap_add(violations, -viol0);
      ev[obs::kEvLeader] = __popc(leader_m);
      ev[obs::kEvTimeout] = __popc(fail_m);
      ev[obs::kEvDrop] = n_drop;
      ev[obs::kEvDup] = n_dup;
      ev[obs::kEvCorrupt] = __popc(corrupt_m);
      eff[obs::kClDrop] = n_drop;
      eff[obs::kClDup] = n_dup;
      eff[obs::kClCorrupt] = __popc(corrupt_m);
      if (ARMS && gray.timeout_skew) eff[obs::kClTimeout] = __popc(fail_m ^ plain_fail);
      obs::fault_events<OBS, ARMS, P, A>(ob, gray, glane, crash_end, plan, tick, n, i, ev, inj, eff);
      if (ob.tel()) obs::telemetry<P, R0>(col, ob, tick, ev, n, i);
      if (ob.exp()) obs::exposure<P, R0>(col, inj, eff);
      if (ob.mar()) {
        obs::mp_margin<P, R0, LOG, K, A, G::kLtBv, G::kLtMask, G::kChosenVal, G::kLog>(
            col, chosen, chosen0, promised, ~equiv & kAccs, kQuorum);
      }
      if (ob.wl()) obs::workload<P, R0, kMpArrival>(col, ob, ts, tick, serve_m, n, i);
      if (ob.cov()) {
        // The coverage digest of the lane's state (obs/coverage.py
        // digest_tree: the acceptors with their shadows, the proposers with
        // their recovery rows, the three buffers with their stamps, base),
        // in the reference's leaf and row order.
        obs::Digest d;
#pragma unroll
        for (int a = 0; a < A; ++a) d.fold(promised[a]);
#pragma unroll 1
        for (int r = 0; r < A * LOG; ++r) d.fold(col[G::kLog + r]);
        if (ob.snaps) {
#pragma unroll 1
          for (int a = 0; a < A; ++a) d.fold(at<int32_t>(L, SNAP, a, n, i));
#pragma unroll 1
          for (int r = 0; r < A * LOG; ++r) d.fold(at<int32_t>(L, SNAP + 1, r, n, i));
        }
#pragma unroll
        for (int p = 0; p < P; ++p) d.fold(bal[p]);
#pragma unroll
        for (int p = 0; p < P; ++p) d.fold(phase[p]);
#pragma unroll
        for (int p = 0; p < P; ++p) d.fold(heard[p]);
#pragma unroll
        for (int p = 0; p < P; ++p) d.fold(commit_idx[p]);
#pragma unroll 1
        for (int r = 0; r < P * LOG; ++r) d.fold(col[G::kRecov + r]);
#pragma unroll
        for (int p = 0; p < P; ++p) d.fold(lease_timer[p]);
#pragma unroll
        for (int p = 0; p < P; ++p) d.fold(last_count[p]);
#pragma unroll
        for (int p = 0; p < P; ++p) d.fold(cand_timer[p]);
#pragma unroll
        for (int j = 0; j < S; ++j) d.fold(rq_bal[j]);
#pragma unroll
        for (int j = 0; j < S; ++j) d.fold(rq_v1[j]);
#pragma unroll
        for (int j = 0; j < S; ++j) d.fold(rq_v2[j]);
#pragma unroll 1
        for (int j = 0; j < S; ++j) d.fold((rq_present >> j) & 1u);
        if constexpr (STAMPED) {
#pragma unroll 1
          for (int j = 0; j < S; ++j) d.fold(col[G::kRqUntil + j]);
        }
#pragma unroll 1
        for (int j = 0; j < E; ++j) d.fold((prom_present >> j) & 1u);
#pragma unroll
        for (int j = 0; j < E; ++j) d.fold(prom_bal[j]);
#pragma unroll 1
        for (int r = 0; r < E * LOG; ++r) d.fold(prom_bv(r));
        if constexpr (STAMPED) {
#pragma unroll 1
          for (int j = 0; j < E; ++j) d.fold(col[G::kPromUntil + j]);
        }
#pragma unroll 1
        for (int j = 0; j < E; ++j) d.fold((accd_present >> j) & 1u);
#pragma unroll
        for (int j = 0; j < E; ++j) d.fold(accd_bal[j]);
#pragma unroll
        for (int j = 0; j < E; ++j) d.fold(accd_slot[j]);
#pragma unroll
        for (int j = 0; j < E; ++j) d.fold(accd_val[j]);
        if constexpr (STAMPED) {
#pragma unroll 1
          for (int j = 0; j < E; ++j) d.fold(col[G::kAccdUntil + j]);
        }
        d.fold(base);
        obs::coverage<P, R0>(col, ob, d.value(), n, i);
      }
      if (prm.clamp_per_tick) {
#pragma unroll
        for (int p = 0; p < P; ++p) bal[p] = min(bal[p], kMpBallotLimit);
      }
      clk.mark(kPhObs);
    }
  }

  draws.flush();
  if constexpr (OBS) obs::move_counters<P, R0>(col, ob, n, i, false);

  // ---- Store the register-resident state once. ----
#pragma unroll
  for (int a = 0; a < A; ++a) at<int32_t>(L, Mp::kPromised, a, n, i) = promised[a];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    at<int32_t>(L, Mp::kBal, p, n, i) = bal[p];
    at<int32_t>(L, Mp::kPhase, p, n, i) = phase[p];
    at<int32_t>(L, Mp::kHeard, p, n, i) = heard[p];
    at<int32_t>(L, Mp::kCommitIdx, p, n, i) = commit_idx[p];
    at<int32_t>(L, Mp::kLeaseTimer, p, n, i) = lease_timer[p];
    at<int32_t>(L, Mp::kLastCount, p, n, i) = last_count[p];
    at<int32_t>(L, Mp::kCandTimer, p, n, i) = cand_timer[p];
  }
#pragma unroll
  for (int l = 0; l < LOG; ++l) at<uint8_t>(L, Mp::kChosen, l, n, i) = (chosen >> l) & 1u;
  at<int32_t>(L, Mp::kViolations, 0, n, i) = violations;
  at<int32_t>(L, Mp::kEvictions, 0, n, i) = evictions;
#pragma unroll
  for (int j = 0; j < S; ++j) {
    at<int32_t>(L, Mp::kRqBal, j, n, i) = rq_bal[j];
    at<int32_t>(L, Mp::kRqV1, j, n, i) = rq_v1[j];
    at<int32_t>(L, Mp::kRqV2, j, n, i) = rq_v2[j];
    at<uint8_t>(L, Mp::kRqPresent, j, n, i) = (rq_present >> j) & 1u;
  }
#pragma unroll
  for (int j = 0; j < E; ++j) {
    at<uint8_t>(L, Mp::kPromPresent, j, n, i) = (prom_present >> j) & 1u;
    at<int32_t>(L, Mp::kPromBal, j, n, i) = prom_bal[j];
    at<uint8_t>(L, Mp::kAccdPresent, j, n, i) = (accd_present >> j) & 1u;
    at<int32_t>(L, Mp::kAccdBal, j, n, i) = accd_bal[j];
    at<int32_t>(L, Mp::kAccdSlot, j, n, i) = accd_slot[j];
    at<int32_t>(L, Mp::kAccdVal, j, n, i) = accd_val[j];
  }
  store_column<P, A, LOG, K, B, STAMPED, PROM>(col, L, n, i);
  clk.mark(kPhStore);
  clk.flush();
}

// One instantiation, ready to launch (SmemInst in fused_common.cuh): an
// arms instantiation's kernel takes a Gray after Params, an observed one an
// obs::Obs after that, and its column holds the planes' counters
// (obs::Rows) after the staged rows.
template <int P, int A, int LOG, int K, bool STAMPED, int B, bool PROM, typename... Arms>
using InstWith = SmemInst<
    fused_multipaxos_kernel<P, A, LOG, K, STAMPED, B, PROM, Arms...>, B,
    (Staged<P, A, LOG, K, STAMPED, PROM>::kRows +
     (has_arg<obs::Obs, Arms...> ? obs::Rows<P>::kRows : 0)) * B * 4>;
template <int P, int A, int LOG, int K, bool STAMPED, bool ARMS, bool OBS, int B, bool PROM>
struct InstOf {
  using type = InstWith<P, A, LOG, K, STAMPED, B, PROM>;
};
template <int P, int A, int LOG, int K, bool STAMPED, int B, bool PROM>
struct InstOf<P, A, LOG, K, STAMPED, true, false, B, PROM> {
  using type = InstWith<P, A, LOG, K, STAMPED, B, PROM, Gray>;
};
template <int P, int A, int LOG, int K, bool STAMPED, int B, bool PROM>
struct InstOf<P, A, LOG, K, STAMPED, false, true, B, PROM> {
  using type = InstWith<P, A, LOG, K, STAMPED, B, PROM, obs::Obs>;
};
template <int P, int A, int LOG, int K, bool STAMPED, int B, bool PROM>
struct InstOf<P, A, LOG, K, STAMPED, true, true, B, PROM> {
  using type = InstWith<P, A, LOG, K, STAMPED, B, PROM, Gray, obs::Obs>;
};
template <int P, int A, int LOG, int K, bool STAMPED, bool ARMS, bool OBS, int B, bool PROM>
using Inst = typename InstOf<P, A, LOG, K, STAMPED, ARMS, OBS, B, PROM>::type;

// The instantiations, (n_prop, n_acc, log_len, k_slots, STAMPED, ARMS, OBS,
// B, PROM): one per shape, stamps, arms and observer flag, at the geometry
// fused_tick.MP_STAGING gives it.  An ablated build instantiates config3's
// only (fused_tick.ABLATE_KEYS).
#define K5_INSTANCES(X)                \
  X(2, 5, 8, 4, 0, 0, 0, 128, true)    \
  X(2, 5, 16, 4, 0, 0, 0, 128, false)  \
  X(2, 5, 4, 4, 0, 0, 0, 128, true)    \
  X(2, 3, 8, 4, 0, 0, 0, 128, true)    \
  X(2, 5, 8, 4, 0, 1, 0, 128, true)    \
  X(2, 5, 8, 4, 1, 0, 0, 128, false)   \
  X(2, 5, 8, 4, 1, 1, 0, 128, false)   \
  X(2, 5, 8, 4, 0, 0, 1, 96, true)     \
  X(2, 5, 8, 4, 0, 1, 1, 96, true)     \
  X(2, 5, 8, 4, 1, 0, 1, 96, true)     \
  X(2, 5, 8, 4, 1, 1, 1, 96, true)     \
  X(2, 5, 16, 4, 0, 0, 1, 64, true)

// The ablated builds' one instantiation, a row of the table above.
#define K5_ABLATED_INSTANCES(X) X(2, 5, 8, 4, 0, 0, 0, 128, true)

// Calls `fn(Inst<...>{}, std::bool_constant<ARMS>{}, std::bool_constant<OBS>{})`
// for the instantiation `dims` names (n_prop, n_acc, log_len, k_slots,
// stamped, arms, observed), or returns cudaErrorInvalidValue.
template <typename Fn>
cudaError_t dispatch(const int* dims, Fn&& fn) {
#define K5_MATCH(P_, A_, L_, K_, S_, R_, O_, B_, G_)                                     \
  if (dims[0] == P_ && dims[1] == A_ && dims[2] == L_ && dims[3] == K_ && dims[4] == S_ && \
      dims[5] == R_ && dims[6] == O_)                                                    \
    return fn(Inst<P_, A_, L_, K_, S_ != 0, R_ != 0, O_ != 0, B_, G_>{},                 \
              std::bool_constant<R_ != 0>{}, std::bool_constant<O_ != 0>{});
#ifdef FUSED_ABLATE
  K5_ABLATED_INSTANCES(K5_MATCH)
#else
  K5_INSTANCES(K5_MATCH)
#endif
#undef K5_MATCH
  return cudaErrorInvalidValue;
}

}  // namespace

// C entry point, loaded with ctypes (arguments: read_gray_args in
// fused_common.cuh; `dims` = n_prop, n_acc, log_len, k_slots, stamped (1:
// the state's buffers carry delay stamps, which p_delay > 0 needs), arms
// (1: the instantiation with the gray-failure and partition arms, which a
// knob of theirs needs), observed (1: the instantiation with the observer
// planes, which a state carrying one needs), then the dynamic shared bytes
// a block, fused_tick.MP_STAGING's); the state's leaves are 29, 32 with the
// stamps, and 2 more with snapshot shadows, which stale_k > 0 needs; `tick`
// is the device int32 tick scalar, read by the kernel and advanced by the
// caller; the observer leaves and their sizes (obs::read_obs_args) come
// last, none for an instantiation that is not observed.  Returns
// cudaSuccess or the first error: an unknown instantiation (a stamped
// state at a shape other than (2,5,8,4), an observed one at a shape other
// than (2,5,8,4) or (2,5,16,4)), a leaf count that is not
// its state's (a stamped state on an unstamped one), a knob on without its
// arms, stale_k without snapshots, p_delay without the stamps or the plan's
// link_delay, observer arguments that do not fit the instantiation or each
// other, or too few shared bytes (cudaErrorInvalidValue), a shared-memory
// request the card refuses, or the launch's cudaGetLastError().
extern "C" int fused_multipaxos_launch(const int* dims, int n_dims, void** leaves, int n_leaves,
                                       void** plan, void* tick, const long long* params,
                                       int n_params, void* stream, void** obs_leaves, int n_obs,
                                       const long long* obs_params, int n_obs_params) {
  if (n_dims != 8) return cudaErrorInvalidValue;
  Leaves L;
  Plan pl;
  Params prm;
  Gray gray;
  cudaError_t bad =
      read_gray_args(dims[5] != 0, leaves, n_leaves, plan, params, n_params, &L, &pl, &prm, &gray,
                     kMpLeaves, kMpSnapAt, kMpSnaps, dims[4] != 0, kMpStampAt);
  if (bad != cudaSuccess) return bad;
  obs::Obs ob{};
  if (dims[6] != 0) {
    bad = obs::read_obs_args(obs_leaves, n_obs, obs_params, n_obs_params, &ob);
    if (bad != cudaSuccess) return bad;
    const bool snaps = n_leaves == kMpLeaves + (dims[4] != 0 ? 3 : 0) + kMpSnaps;
    if ((ob.snaps != 0) != snaps) return cudaErrorInvalidValue;
  } else if (n_obs != 0 || n_obs_params != 0) {
    return cudaErrorInvalidValue;
  }
  const auto* t = static_cast<const int32_t*>(tick);
  auto s = static_cast<cudaStream_t>(stream);
  const int smem = dims[7];
  return dispatch(dims, [&](auto inst, auto with_arms, auto with_obs) {
    constexpr bool R = decltype(with_arms)::value, O = decltype(with_obs)::value;
    using I = decltype(inst);
    if constexpr (R && O) return I::launch(L, pl, t, prm, smem, s, gray, ob);
    else if constexpr (R) return I::launch(L, pl, t, prm, smem, s, gray);
    else if constexpr (O) return I::launch(L, pl, t, prm, smem, s, ob);
    else return I::launch(L, pl, t, prm, smem, s);
  });
}

// The blocks of instantiation `dims` (as for fused_multipaxos_launch) that
// one SM of the current device holds at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), into *blocks_per_sm.
extern "C" int fused_multipaxos_occupancy(const int* dims, int n_dims, int* blocks_per_sm) {
  if (n_dims != 8) return cudaErrorInvalidValue;
  const int smem = dims[7];
  return dispatch(dims, [&](auto inst, auto, auto) {
    return decltype(inst)::occupancy(smem, blocks_per_sm);
  });
}
