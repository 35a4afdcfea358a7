// Fused Raft-core engine for Hopper (sm_90a): n_ticks ticks of
// counter_masks + apply_tick_raft for every instance in one launch.
//
// Replaces: paxos_tpu/kernels/fused_tick.py::_kernel bound to the
// Raft-core tick (fused_fns("raftcore"), launched by fused_chunk through
// pl.pallas_call), the Pallas kernel that keeps a block of instances'
// state resident in VMEM for a whole chunk.
//
// Bound on this card: ~765 B/lane of state moved once each way per chunk,
// against a few thousand int32 operations per lane-tick; but a lane's tick
// is one long chain of dependent integer operations and branches, so the
// time falls with the warps an SM holds and with the code on the chain,
// and both bounds are far below it.  The leader's APPEND re-broadcast
// draws A drop masks per leader per tick, which K1 draws only on a phase
// change, so its sends are the heaviest of the single-decree ticks.
//
// Design: K4's (fused_synchpaxos_tick.cu) without the delay stamps, as K2
// (fused_fastpaxos_tick.cu).  One thread per instance (lane), the state
// split by access pattern so that a thread's registers allow 12 warps an
// SM, each part where it stays for the whole chunk:
//  - registers: the role scalars, the learner's scalars, the presence
//    bitmasks of both buffers, and a bitmask per buffer of the slots the
//    chunk wrote;
//  - shared memory, a column per lane (word r at smem[r * B + t], B the
//    block's lane count; sd::SdStaged in fused_common.cuh): the message
//    payloads a tick reads (a REQVOTE's v1, the candidate's entry term, and
//    a VOTE's v2 among them) and the learner's (ballot, value, voters)
//    table.  A dynamic index (the selected request, a reply's slot) is one
//    shared load or store, where in registers it was a chain of selects;
//  - no row at all: the payload words the tick only ever writes as 0
//    (every request's v2, an ACK's v2; protocols/raftcore.py).
// The column is loaded once at the start of the chunk from
// [row * n_inst + lane].  At the end the kernel stores only the slots the
// chunk wrote (their staged words, 0 to their zero-only words), the
// learner table if an accept event reached it, and every presence byte:
// the state comes back byte for byte, stale payloads of consumed slots
// included.  A thread touches only its own column, so the kernel needs no
// barrier, and lanes past n_inst return at once.
//
// The code on the chain is short: the sites that draw are rolled loops over
// set bits (delivery's hold and dup draws over the delivered slots, the
// selection over a voter's present slots, sd::select_present, the sends
// over the voters only for a leader or a timed-out candidate), and the
// vote fold visits a candidate's delivered slots only.  Every draw is keyed
// by its position, so the order of the draws changes nothing, and a mask is
// drawn only where the outcome depends on it, as in K1.
//
// The gray-failure and partition arms (partition cuts, one-way cuts,
// per-link loss and duplication thresholds, payload corruption, timer skew,
// stale-snapshot recovery and amnesia) compile into an instantiation of
// their own (ARMS, at (2,5,8), the shape of every config that sets them),
// which the C entry picks when a knob of theirs is on, as K1's do
// (fused_paxos_tick.cu), through the pieces the three kernels share
// (sd::GrayLane, sd::recover and the other helpers in fused_common.cuh);
// the default instantiations compile none of their code.  A cut masks the
// delivered replies and the selected request after the draws that select
// them, so those draws are made as before; the per-link draws (LINK_BITS
// where a message is sent, DUP_BITS where one is delivered or selected) and
// the corruption draw (a voter that processes a request) are made only at
// the site that reads them; the snapshot shadows stay in global memory,
// read on a recovery tick and written on a snapshot tick, the restore
// coming before the tick's invariant check.
//
// The observer planes (telemetry, coverage, exposure, margin, the client
// workload) compile into the observed instantiations (OBS, at (2,5,8), each
// without and with the stamps and the arms), for a state that carries a
// plane, through the pieces in obs:: (fused_common.cuh), as K2's
// (fused_fastpaxos_tick.cu); with exposure on, the tick's drop, dup,
// corrupt and delay decisions are drawn at its start (obs::predraw) and
// the lazy sites read those bits, so no position is drawn twice and the
// schedule is the planes-off one; every tick then runs the planes (there
// is no settled lane to skip) on the post-tick state, before the per-tick
// ballot clamp.  An observed tick runs at the occupancy its column allows,
// where little hides a latency, so its planes keep off the tick's chain
// what they can, each exactly as the plain tick computes it:
//  - the coverage digest (193 words a tick at (2,5,8)) folds batches of
//    column words loaded ahead (obs::fold_buffers_ahead), so the FNV chain,
//    which cannot be split, waits on its multiplies only; a run of
//    zero-only words that holds no nonzero word is one multiply;
//  - the coverage insert completes a tick late (obs::DeferredCoverage),
//    the launch's last after its loop;
//  - the counters stay in registers for the launch (obs::Tally), the
//    margins and the client queue in the column (obs::TallyRows: 134 words
//    at 3 blocks of 128 without the arms or the stamps, 174 stamped, and
//    either with the arms, at 2);
//  - the margin walks the learner table only where an append reached it
//    (obs::sd_margin), else counts the last walk's near split again, and
//    takes the fence slack over the voters the tick changed.
// Raft-core's signals: grants are
// telemetry's promises, acks its accepts, elections its leaders; a VOTE
// dropped counts wherever a REQVOTE was selected (every one is answered),
// an APPEND dropped for every leader (it re-sends every tick); a commit
// serves a client request; the margin reads the vote fence and the entry's
// term against the majority.
//
// What differs from the Paxos tick (protocols/raftcore.py), with the
// message roles REQVOTE/APPEND (requests) and VOTE/ACK (replies):
//  - voters grant a vote only to a term above their vote fence and to a
//    candidate whose entry term is at least their own (the election
//    restriction); appends raise the fence;
//  - every REQVOTE is answered, grant or denial, with v1 = 2 * entry term
//    + granted, so the candidate's // 2 and % 2 are a shift and a mask;
//  - a candidate adopts the highest-term entry it hears (value by a max);
//    a leader re-sends APPEND to every voter on every tick while LEAD;
//    REQVOTE carries the candidate's entry term;
//  - every quorum is the majority, and the learner counts appends.
//
// The bounded-delay channel (p_delay: delay stamps on every send, readiness
// gates on delivery and request selection) compiles into the stamped
// instantiations (STAMPED, at (2,5,8), without and with the arms), for a
// state whose buffers carry `until` stamps, as K1's (fused_paxos_tick.cu):
// the stamp rows of sd::SdStaged and sd::Channel in fused_common.cuh.  The
// stamps sit in the lane's column, the slots still waiting for theirs in a
// bitmask per buffer, refreshed at the tick's start, and a tick's sends are
// stamped by one rolled loop per buffer; delivery and the selection read
// the slots that have arrived only.  A cut (ARMS) masks after the readiness
// gate and never touches a stamp.  The stamped column (154 words, every
// request's v1 staged) leaves an SM room for 2 blocks of 128 lanes; the
// stamped instantiations run 32 lanes a block, 11 blocks (11 warps) an SM.

#include <type_traits>

#include "fused_common.cuh"

namespace {

// Candidate phases (core/raft_state.py).
constexpr int32_t kCand = 0, kLead = 1, kDone = 2;
// Message kinds: REQVOTE/VOTE = 0, APPEND/ACK = 1.
constexpr int kReqVote = 0, kAppend = 1, kVote = 0, kAck = 1;

using sd::ColumnLearner;
using sd::select_present;
using sd::SdStaged;

// The tick's phases in order, each with its name in the phase-clock build's
// split of a lane's cycles (fused_tick.PHASES["raftcore"]): an observed
// tick's planes take the four before the store.
enum Phase {
  kPhLoad,      // column load
  kPhDeliver,   // reply delivery
  kPhFold,      // candidate fold
  kPhAcceptor,  // voter half-tick
  kPhLearner,   // learner
  kPhSends,     // candidate sends
  kPhCounters,  // observer counters
  kPhMargin,    // margin
  kPhDigest,    // digest
  kPhCoverage,  // coverage insert
  kPhStore,     // column store
  kPhases,
};

// The role leaves in the reference's flatten order; the learner and the
// message buffers follow (SharedLeaf).
enum Leaf {
  kVoted, kEntTerm, kEntVal,
  kBal, kPhase, kOwnVal, kPropVal, kHeard, kCandEntTerm, kCandEntVal, kTimer,
  kDecidedVal,
};

// The kernel; `Arms` is empty for the default instantiations, whose
// signature and code are those of the kernel without the arms, a `Gray`
// for the arms instantiations (ARMS), which take the arms' knobs and plan
// leaves, and an obs::Obs (after the Gray, if any) for the observed ones
// (OBS), which compute the observer planes whose leaves it holds.
template <int P, int A, int K, bool STAMPED, int B, int MIN_BLOCKS, typename... Arms>
__global__ void __launch_bounds__(B, MIN_BLOCKS)
fused_raftcore_kernel(Leaves L, Plan plan, const int32_t* __restrict__ tick_ptr, Params prm,
                      Arms... arms) {
  constexpr bool ARMS = has_arg<Gray, Arms...>;
  constexpr bool OBS = has_arg<obs::Obs, Arms...>;
  const Gray gray = pick_arg<Gray>(arms...);
  const obs::Obs ob = pick_arg<obs::Obs>(arms...);
  static_assert(B % 32 == 0, "a block is whole warps");
  using G = SdStaged<P, A, K, true, STAMPED>;
  // The planes' counters (OBS): in registers for the launch (obs::Tally,
  // with the arms every one), the margins and the client queue in the
  // column (obs::TallyRows), from row R0.
  using CR = obs::TallyRows<P>;
  constexpr int R0 = G::kRows;
  // The snapshot shadows' first leaf (after the stamps in a stamped state).
  constexpr int SNAP = STAMPED ? kStampedLeaves : kSnap0;
  constexpr int S = G::S;  // message slots per buffer, index (kind * P + p) * A + a
  constexpr int E = G::E;  // links (edges), index p * A + a; slot j is on edge j % E
  static_assert(S <= 32, "slot presence must fit one 32-bit mask");
  constexpr int kQuorum = A / 2 + 1;
  constexpr uint32_t kVoters = (1u << A) - 1;
  extern __shared__ int32_t smem[];  // G::kRows * B words (OBS: and CR::kRows)

  const int64_t n = prm.n_inst;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * B + threadIdx.x;
  if (i >= n) return;
  PhaseClock<kPhases> clk;
  const Column<B> col{smem + threadIdx.x};
  sd::load_column<P, A, K, true, sd::kCopyUnroll<MIN_BLOCKS>, B, STAMPED>(col, L, n, i);
  // The bounded-delay channel's waiting slots (STAMPED), as the column.
  sd::Channel<P, A, B, G::kRqUntil, G::kRpUntil> ch;
  if constexpr (STAMPED) ch.load(col, prm, plan, n, i, *tick_ptr);
  obs::Tally<STAMPED, ARMS> tally;
  // The planes' counters into the registers and the column, and the
  // zero-only payload words that are not 0 in global memory
  // (obs::zero_words), which the coverage digest folds where the chunk has
  // not written their slot.
  uint64_t zo_nz = 0;
  if constexpr (OBS) {
    obs::move_tally_rows<P, R0>(col, ob, n, i, true);
    tally.move(ob, n, i, true);
    if (ob.cov()) zo_nz = obs::zero_words<G>(L, n, i);
  }

  // ---- Load the lane's register-resident state once. ----
  int32_t voted[A], ent_term[A], ent_val[A], crash_start[A], crash_end[A];
  uint32_t equiv = 0;
#pragma unroll
  for (int a = 0; a < A; ++a) {
    voted[a] = load<int32_t>(L, kVoted, a, n, i);
    ent_term[a] = load<int32_t>(L, kEntTerm, a, n, i);
    ent_val[a] = load<int32_t>(L, kEntVal, a, n, i);
    crash_start[a] = plan.crash_start[a * n + i];
    crash_end[a] = plan.crash_end[a * n + i];
    equiv |= (plan.equivocate[a * n + i] != 0 ? 1u : 0u) << a;
  }
  int32_t bal[P], phase[P], own_val[P], prop_val[P], heard[P], c_term[P], c_val[P], timer[P],
      decided_val[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    bal[p] = load<int32_t>(L, kBal, p, n, i);
    phase[p] = load<int32_t>(L, kPhase, p, n, i);
    own_val[p] = load<int32_t>(L, kOwnVal, p, n, i);
    prop_val[p] = load<int32_t>(L, kPropVal, p, n, i);
    heard[p] = load<int32_t>(L, kHeard, p, n, i);
    c_term[p] = load<int32_t>(L, kCandEntTerm, p, n, i);
    c_val[p] = load<int32_t>(L, kCandEntVal, p, n, i);
    timer[p] = load<int32_t>(L, kTimer, p, n, i);
    decided_val[p] = load<int32_t>(L, kDecidedVal, p, n, i);
  }
  ColumnLearner<K, G::kLtBal> lrn;
  lrn.load_from(L, n, i);
  uint32_t rq_present = 0, rp_present = 0;
#pragma unroll
  for (int j = 0; j < S; ++j) {
    rq_present |= (load<uint8_t>(L, kRqPresent, j, n, i) != 0 ? 1u : 0u) << j;
    rp_present |= (load<uint8_t>(L, kRpPresent, j, n, i) != 0 ? 1u : 0u) << j;
  }
  uint32_t rq_written = 0, rp_written = 0;  // the slots the chunk wrote
  bool lt_written = false;                  // an accept event reached the learner table
  // The arms' per-lane plan: the partition window, the links that cross the
  // cut, the cut's direction, the timeout skew.
  sd::GrayLane<P, A> glane;
  if constexpr (ARMS) glane.load(gray, n, i);

  const int32_t tick0 = *tick_ptr;
  const uint32_t blk = static_cast<uint32_t>(prm.blk0) + static_cast<uint32_t>(i / prm.block);
  const uint32_t lane = static_cast<uint32_t>(i % prm.block);
  const auto quorum_of = [](int32_t) { return kQuorum; };
  clk.mark(kPhLoad);

  DrawCount draws;
  obs::DeferredCoverage cov;  // the coverage insert in flight (OBS)
  bool near = false;          // the last margin walk's near split (OBS, obs::sd_margin)
  for (int t = 0; t < prm.n_ticks; ++t) {
    const int32_t tick = wrap_add(tick0, t);
    // The words of the previous tick's insert, loaded while this tick runs.
    if constexpr (OBS) cov.load(ob, n, i);
    const TickStream ts{mix32(prm.seed, static_cast<uint32_t>(tick), blk),
                        static_cast<uint32_t>(prm.block), lane, &draws};
    // What the planes read of the pre-tick state (OBS).
    const uint32_t rq_p0 = rq_present, rp_p0 = rp_present;
    const bool chosen0 = lrn.chosen;
    const int32_t viol0 = lrn.violations;
    // Stale-snapshot recovery or amnesia (the arms), before the voter
    // half-tick and its invariant check.
    // The voters whose fence or entry term the tick changes (OBS: the
    // margin's fence slack; every one at a launch's first tick).
    uint32_t acc_dirty = t == 0 ? kVoters : 0u;
    if constexpr (OBS) {
      sd::recover<ARMS, A, SNAP>(gray, L, tick, crash_end, voted, ent_term, ent_val, n, i,
                                 [&](int a) { acc_dirty |= 1u << a; });
    } else {
      sd::recover<ARMS, A, SNAP>(gray, L, tick, crash_end, voted, ent_term, ent_val, n, i,
                                 [](int) {});
    }
    // The slots whose stamp has come (STAMPED): a slot waiting for its
    // stamp is neither delivered nor selected.
    if constexpr (STAMPED) ch.refresh(col, tick, &draws);
    const uint32_t rq_ready = rq_present & (STAMPED ? ~ch.rq_wait : ~0u);
    // The links cut this tick, per direction (bit e: edge e).
    uint32_t cut_req = 0, cut_rep = 0;
    if constexpr (ARMS) glane.cuts(tick, cut_req, cut_rep);

    // The planes' counts of the tick (OBS), exposure's draws (an observed
    // instantiation's sites that draw read them instead where exposure made
    // them: obs::keep_at, obs::dup_at, obs::stamp_sends, the corruption
    // site; the other instantiations call sd:: at those sites, as before the
    // planes, since even a forwarding layer there slowed K2's arms by 2.8%,
    // PERF.md section 6), and what the cuts and the stamps hold back of the
    // pre-tick buffers.
    int ev[obs::kEvents] = {}, inj[obs::kClasses] = {}, eff[obs::kClasses] = {};
    const obs::PreDraw pd =
        obs::predraw<OBS, ARMS, STAMPED, P, A>(ob, ts, prm, gray, ch.slow, n, i, inj);
    int n_drop = 0, n_dup = 0;
    uint32_t grant_m = 0, corrupt_m = 0, elected_m = 0, serve_m = 0, plain_exp = 0;
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

    // ---- Reply delivery (pre-tick buffer): the replies on a link not cut
    //      and not held this tick; consumed unless duplicated. ----
    uint32_t delivered = rp_present & (STAMPED ? ~ch.rp_wait : ~0u);
    if constexpr (ARMS) delivered &= ~(cut_rep | (cut_rep << E));
    if (prm.hold.mode != 0) {
      for (uint32_t m = delivered; m != 0; m &= m - 1) {
        const int j = __ffs(m) - 1;
        if (ts.fires_at(prm.hold, kDeliver, j)) delivered &= ~(1u << j);
      }
    }
    uint32_t taken = delivered;
    if (sd::dup_live<ARMS>(prm, gray)) {
      for (uint32_t m = delivered; m != 0; m &= m - 1) {
        const int j = __ffs(m) - 1;
        if (OBS ? obs::dup_at<OBS, ARMS, S, E>(pd, ts, prm, gray, 1, j, kDupRep, n, i)
                : sd::duplicated<ARMS, S, E>(ts, prm, gray, kDupRep, 1, j, n, i))
          taken &= ~(1u << j);
      }
      if constexpr (OBS) n_dup += __popc(delivered & ~taken);
    }
    uint32_t rp_next = rp_present & ~taken;
    clk.mark(kPhDeliver);

    // ---- Candidate fold over the pre-tick replies. ----
    uint32_t leading = 0, expired = 0;  // proposers that send APPEND / REQVOTE
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int32_t cur = bal[p];
      int32_t h = heard[p];
      // ACK in LEAD at the current term.
      if (phase[p] == kLead) {
        for (uint32_t m = (delivered >> ((kAck * P + p) * A)) & kVoters; m != 0; m &= m - 1) {
          const int a = __ffs(m) - 1;
          if (col[G::kRpBal + (kAck * P + p) * A + a] == cur) h |= 1 << a;
        }
      }
      // VOTE in CAND at the current term: a granted one counts, and every
      // one reports its voter's entry.  The entry adopted is the highest
      // term's (the reference's max over every voter, 0 for one whose VOTE
      // does not count), its value the max over that term's voters (0
      // likewise); the value is read only where it is taken.
      uint32_t vote_ok = 0;
      int32_t cand_t = 0, cand_v = 0;
      if (phase[p] == kCand) {
        int32_t t_max = kInt32Min;
        for (uint32_t m = (delivered >> ((kVote * P + p) * A)) & kVoters; m != 0; m &= m - 1) {
          const int a = __ffs(m) - 1;
          const int j0 = (kVote * P + p) * A + a;
          if (col[G::kRpBal + j0] != cur) continue;
          const int32_t v1 = col[G::kRpV1 + j0];
          if ((v1 & 1) == 1) h |= 1 << a;
          vote_ok |= 1u << a;
          t_max = max(t_max, v1 >> 1);  // floor division by 2
        }
        cand_t = vote_ok == kVoters ? t_max : max(t_max, 0);
      }
      const bool upgrade = cand_t > c_term[p];
      if (upgrade && vote_ok != 0) {
        uint32_t top = 0;
        cand_v = kInt32Min;
        for (uint32_t m = vote_ok; m != 0; m &= m - 1) {
          const int a = __ffs(m) - 1;
          const int j0 = (kVote * P + p) * A + a;
          if ((col[G::kRpV1 + j0] >> 1) == cand_t) {
            top |= 1u << a;
            cand_v = max(cand_v, col[G::kRpV2 + j0]);
          }
        }
        if (top != kVoters) cand_v = max(cand_v, 0);
      }
      int32_t et = upgrade ? cand_t : c_term[p];
      int32_t ev = upgrade ? cand_v : c_val[p];

      const int votes = __popc(static_cast<uint32_t>(h));
      const bool elected = phase[p] == kCand && votes >= kQuorum;
      const bool committed = phase[p] == kLead && votes >= kQuorum;
      int32_t tm = phase[p] == kDone ? timer[p] : wrap_add(timer[p], 1);
      const int32_t timeout = ARMS ? glane.timeout(prm.timeout, p) : prm.timeout;
      const bool exp = phase[p] != kDone && !elected && !committed && tm > timeout;
      if constexpr (OBS) {  // the elections, commits, and the expiry without the skew
        elected_m |= (elected ? 1u : 0u) << p;
        serve_m |= (committed ? 1u : 0u) << p;
        plain_exp |= (phase[p] != kDone && !elected && !committed && tm > prm.timeout ? 1u : 0u)
                     << p;
      }

      // A new leader proposes its adopted entry if it has one, else its
      // own value, and records it as its own entry at its term.
      const int32_t v_lead = et > 0 ? ev : own_val[p];
      int32_t ph = phase[p];
      if (elected) ph = kLead;
      if (committed) ph = kDone;
      if (exp) ph = kCand;
      if (committed) decided_val[p] = prop_val[p];
      if (elected) {
        prop_val[p] = v_lead;
        et = cur;
        ev = v_lead;
      }
      if (elected || exp) h = 0;
      if (elected) tm = 0;
      if (exp) {
        tm = sd::backoff_of<ARMS>(ts.bits(kBackoff, p) & 0x7FFFFFFFu, prm, gray, p, n, i);
      }
      bal[p] = exp ? next_ballot(cur, prm.stride, p) : cur;
      phase[p] = ph;
      heard[p] = h;
      c_term[p] = et;
      c_val[p] = ev;
      timer[p] = tm;
      leading |= (ph == kLead ? 1u : 0u) << p;
      expired |= (exp ? 1u : 0u) << p;
    }
    clk.mark(kPhFold);

    // ---- Voter half-tick: select at most one request per voter. ----
    uint32_t rq_next = rq_present;
    uint32_t rp_sent = 0;  // the reply slots written this tick
    uint32_t ev_flag = 0;
    int32_t ev_bal[A], ev_val[A];
    int inv_viol = 0;
#pragma unroll
    for (int a = 0; a < A; ++a) {
      const bool alive = !(crash_start[a] <= tick && tick < crash_end[a]);
      const bool busy = ts.survives_at(prm.idle, kBusy, a);
      const int win = select_present<P, A>(ts, rq_ready, a);  // a request has arrived
      int sel = (win >= 0 && busy && alive) ? win : -1;
      // A request on a cut link stays in flight: the voter processes
      // nothing this tick.
      if (ARMS && sel >= 0 && ((cut_req >> ((sel * A + a) % E)) & 1u)) sel = -1;

      // The selected request: its term, and its v1 (a REQVOTE's entry
      // term, an APPEND's value); a corrupted APPEND's value flips a bit, a
      // corrupted REQVOTE's term moves up one.
      const bool is_rv = sel >= 0 && sel < P;
      const bool is_ap = sel >= P;
      int32_t mb = sel >= 0 ? col[G::kRqBal + sel * A + a] : 0;
      int32_t mv = sel >= 0 ? col[G::rq_v1(sel * A + a)] : 0;
      if constexpr (OBS) {
        if (sel >= 0 && obs::corrupt_fires<ARMS>(pd, ts, gray, a)) {
          if (is_ap) mv ^= 64;
          else mb = wrap_add(mb, 1);
          corrupt_m |= 1u << a;
        }
      } else if (sel >= 0) {
        sd::corrupt<ARMS>(ts, gray, a, is_ap, mb, mv);
      }
      const bool eq = (equiv >> a) & 1u;
      const int32_t vo_old = voted[a], et_old = ent_term[a], ev_old = ent_val[a];
      // One vote per term plus the election restriction; equivocators
      // grant everything and hide their entry.
      const bool grant_h = is_rv && !eq && mb > vo_old && mv >= et_old;
      const bool grant = grant_h || (is_rv && eq);
      // AppendEntries from any term not below the vote fence.
      const bool ok_ap_h = is_ap && !eq && mb >= vo_old;
      const bool ok_ap = ok_ap_h || (is_ap && eq);

      int32_t vo = grant_h ? mb : vo_old;
      if (ok_ap_h) vo = max(vo, mb);
      const int32_t et = ok_ap ? mb : et_old;
      const int32_t ev = ok_ap ? mv : ev_old;

      // The reply into the selected sender's slot (post-consume buffer):
      // every REQVOTE is answered with the pre-update entry (VOTE for
      // candidate sel); accepted APPENDs are acknowledged (ACK for leader
      // sel - P); a flaky link drops either against its own threshold.
      if (is_rv &&
          (OBS ? obs::keep_at<OBS, ARMS, E>(pd, ts, prm, gray, kKeepProm, 0, sel * A + a, n, i)
               : sd::kept<ARMS, E>(ts, prm, gray, kKeepProm, 0, sel * A + a, n, i))) {
        const int jr = sel * A + a;
        col[G::kRpBal + jr] = mb;
        col[G::kRpV1 + jr] = wrap_add(
            static_cast<int32_t>(static_cast<uint32_t>(eq ? 0 : et_old) * 2u), grant ? 1 : 0);
        col[G::kRpV2 + jr] = eq ? 0 : ev_old;
        rp_sent |= 1u << jr;
      }
      if (ok_ap &&
          (OBS ? obs::keep_at<OBS, ARMS, E>(pd, ts, prm, gray, kKeepAccd, 1, (sel - P) * A + a, n, i)
               : sd::kept<ARMS, E>(ts, prm, gray, kKeepAccd, 1, (sel - P) * A + a, n, i))) {
        const int jr = sel * A + a;
        col[G::kRpBal + jr] = mb;
        col[G::kRpV1 + jr] = mv;
        rp_sent |= 1u << jr;
      }
      // Consume the selected request unless it is duplicated (on a flaky
      // link, against its own threshold).
      if (sel >= 0) {
        const int j = sel * A + a;
        if (!(sd::dup_live<ARMS>(prm, gray) &&
              (OBS ? obs::dup_at<OBS, ARMS, S, E>(pd, ts, prm, gray, 0, j, kDupReq, n, i)
                   : sd::duplicated<ARMS, S, E>(ts, prm, gray, kDupReq, 0, j, n, i))))
          rq_next &= ~(1u << j);
      }
      // The planes' counts (OBS): a voter that answers and whose reply slot
      // was not written dropped its reply; a selected request that stays
      // was duplicated.
      if constexpr (OBS) {
        grant_m |= (grant ? 1u : 0u) << a;
        if (sel >= 0) {
          const int j = sel * A + a;
          n_drop += (is_rv || ok_ap) && !((rp_sent >> j) & 1u) ? 1 : 0;
          n_dup += (rq_next >> j) & 1u;
        }
      }

      // Voter-local invariants (honest voters only).
      const bool bad = vo < vo_old || et > vo || et < et_old || (et == 0 && ev != 0);
      if (bad && !eq) ++inv_viol;
      voted[a] = vo;
      ent_term[a] = et;
      ent_val[a] = ev;
      ev_flag |= (ok_ap ? 1u : 0u) << a;
      if constexpr (OBS) acc_dirty |= (vo != vo_old || et != et_old ? 1u : 0u) << a;
      ev_bal[a] = mb;
      ev_val[a] = mv;
    }
    // The replies' delay stamps (the stamp draws are keyed by the slot, so
    // one rolled loop serves every reply site).
    if constexpr (STAMPED && OBS) {
      obs::stamp_sends<OBS>(ch, pd, col, G::kRpUntil, ch.rp_wait, 1, rp_sent, prm, plan, ts, n, i,
                            tick, &draws);
    } else if constexpr (STAMPED) {
      ch.stamp_sends(col, G::kRpUntil, ch.rp_wait, 1, rp_sent, prm, plan, ts, n, i, tick, &draws);
    }
    rp_present = rp_next | rp_sent;
    rp_written |= rp_sent;
    rq_present = rq_next;
    clk.mark(kPhAcceptor);

    // ---- Learner: append-accept events, majority commit. ----
    bool lt_tick = false;  // the table changed this tick (OBS: the margin walks it)
    if (lrn.template observe<A>(col, ev_flag, ev_bal, ev_val, tick, inv_viol, quorum_of)) {
      lt_written = true;
      lt_tick = true;
    }
    clk.mark(kPhLearner);

    // ---- Candidate sends into the consumed request buffer. ----
    uint32_t rq_sent = 0;  // the request slots written this tick
#pragma unroll
    for (int p = 0; p < P; ++p) {
      if ((leading | expired) >> p & 1u) {
#pragma unroll 1
        for (int a = 0; a < A; ++a) {
          if (((leading >> p) & 1u) &&
              (OBS ? obs::keep_at<OBS, ARMS, E>(pd, ts, prm, gray, kKeepP2, 3, p * A + a, n, i)
                   : sd::kept<ARMS, E>(ts, prm, gray, kKeepP2, 3, p * A + a, n, i))) {
            const int j = (kAppend * P + p) * A + a;  // APPEND(term, value), every tick
            col[G::kRqBal + j] = bal[p];
            col[G::rq_v1(j)] = prop_val[p];
            rq_sent |= 1u << j;
          }
          if (((expired >> p) & 1u) &&
              (OBS ? obs::keep_at<OBS, ARMS, E>(pd, ts, prm, gray, kKeepP1, 2, p * A + a, n, i)
                   : sd::kept<ARMS, E>(ts, prm, gray, kKeepP1, 2, p * A + a, n, i))) {
            const int j = (kReqVote * P + p) * A + a;  // REQVOTE(next term, entry term)
            col[G::kRqBal + j] = bal[p];
            col[G::rq_v1(j)] = c_term[p];
            rq_sent |= 1u << j;
          }
        }
        if constexpr (OBS) {  // the broadcasts' dropped sends: the slots not written
          const uint32_t app = (rq_sent >> ((kAppend * P + p) * A)) & kVoters;
          const uint32_t rv = (rq_sent >> ((kReqVote * P + p) * A)) & kVoters;
          n_drop += ((leading >> p) & 1u ? A - __popc(app) : 0) +
                    ((expired >> p) & 1u ? A - __popc(rv) : 0);
        }
      }
      // (An observed tick clamps after the planes: the digest reads the
      // terms as the tick left them.)
      if (!OBS && prm.clamp_per_tick) bal[p] = min(bal[p], kBallotLimit);
    }
    if constexpr (STAMPED && OBS) {
      obs::stamp_sends<OBS>(ch, pd, col, G::kRqUntil, ch.rq_wait, 0, rq_sent, prm, plan, ts, n, i,
                            tick, &draws);
    } else if constexpr (STAMPED) {
      ch.stamp_sends(col, G::kRqUntil, ch.rq_wait, 0, rq_sent, prm, plan, ts, n, i, tick, &draws);
    }
    rq_present |= rq_sent;
    rq_written |= rq_sent;
    clk.mark(kPhSends);

    // ---- The observer planes (OBS), from the tick's events: the counters
    //      (telemetry, exposure, the client workload), the margin, the
    //      coverage digest and its insert, each plane's writes its own. ----
    if constexpr (OBS) {
      const bool decided_now = lrn.chosen && !chosen0;
      ev[obs::kEvPromise] = __popc(grant_m);
      ev[obs::kEvAccept] = __popc(ev_flag);
      ev[obs::kEvDecide] = decided_now ? 1 : 0;
      ev[obs::kEvConflict] = wrap_add(lrn.violations, -viol0);
      ev[obs::kEvLeader] = __popc(elected_m);
      ev[obs::kEvTimeout] = __popc(expired);
      ev[obs::kEvDrop] = n_drop;
      ev[obs::kEvDup] = n_dup;
      ev[obs::kEvCorrupt] = __popc(corrupt_m);
      eff[obs::kClDrop] = n_drop;
      eff[obs::kClDup] = n_dup;
      eff[obs::kClCorrupt] = __popc(corrupt_m);
      if (ARMS && gray.timeout_skew) eff[obs::kClTimeout] = __popc(expired ^ plain_exp);
      obs::fault_events<OBS, ARMS, P, A>(ob, gray, glane, crash_end, plan, tick, n, i, ev, inj, eff);
      if (ob.tel()) tally.telemetry(ob, tick, ev, n, i);
      if (ob.exp()) tally.exposure(inj, eff);
      if (ob.wl()) obs::mp_workload<P, R0 + CR::kWl, kArrival>(col, ob, ts, tick, serve_m, n, i);
      clk.mark(kPhCounters);
      // The learner table and the chosen bit change only where an append
      // reaches the table; the margin reads the fence against the entry's
      // term at the majority.
      if (ob.mar()) {
        obs::sd_margin<K, A, G::kLtBal, R0 + CR::kMar>(
            col, quorum_of, t == 0 || lt_tick, lrn.chosen, lrn.chosen_val, decided_now, voted,
            ent_term, acc_dirty & ~equiv & kVoters, near);
      }
      clk.mark(kPhMargin);
      obs::Digest d;
      if (ob.cov()) {
        // The coverage digest of the lane's state (obs/coverage.py digest_tree:
        // the voters with their shadows, the candidates, both buffers with their
        // stamps), in the reference's leaf and row order.
#pragma unroll
        for (int a = 0; a < A; ++a) d.fold(voted[a]);
#pragma unroll
        for (int a = 0; a < A; ++a) d.fold(ent_term[a]);
#pragma unroll
        for (int a = 0; a < A; ++a) d.fold(ent_val[a]);
        obs::fold_shadows_ahead<A, SNAP>(d, ob, L, n, i);
#pragma unroll
        for (int p = 0; p < P; ++p) d.fold(bal[p]);
#pragma unroll
        for (int p = 0; p < P; ++p) d.fold(phase[p]);
#pragma unroll
        for (int p = 0; p < P; ++p) d.fold(own_val[p]);
#pragma unroll
        for (int p = 0; p < P; ++p) d.fold(prop_val[p]);
#pragma unroll
        for (int p = 0; p < P; ++p) d.fold(heard[p]);
#pragma unroll
        for (int p = 0; p < P; ++p) d.fold(c_term[p]);
#pragma unroll
        for (int p = 0; p < P; ++p) d.fold(c_val[p]);
#pragma unroll
        for (int p = 0; p < P; ++p) d.fold(timer[p]);
#pragma unroll
        for (int p = 0; p < P; ++p) d.fold(decided_val[p]);
        obs::fold_buffers_ahead<G, STAMPED>(d, col, L, n, i, zo_nz, rq_written, rp_written,
                                            rq_present, rp_present);
      }
      clk.mark(kPhDigest);
      // The previous tick's insert completes, this tick's starts.
      if (ob.cov()) {
        tally.new_bits = wrap_add(tally.new_bits, cov.finish(ob, n, i));
        cov.start(ob, d.value(), n, i);
      }
      if (prm.clamp_per_tick) {
#pragma unroll
        for (int p = 0; p < P; ++p) bal[p] = min(bal[p], kBallotLimit);
      }
      clk.mark(kPhCoverage);
    }
  }

  draws.flush();
  if constexpr (OBS) {
    // The last tick's insert.
    cov.load(ob, n, i);
    tally.new_bits = wrap_add(tally.new_bits, cov.finish(ob, n, i));
    tally.move(ob, n, i, false);
    obs::move_tally_rows<P, R0>(col, ob, n, i, false);
  }

  // ---- Store the lane's state once. ----
#pragma unroll
  for (int a = 0; a < A; ++a) {
    store<int32_t>(L, kVoted, a, n, i, voted[a]);
    store<int32_t>(L, kEntTerm, a, n, i, ent_term[a]);
    store<int32_t>(L, kEntVal, a, n, i, ent_val[a]);
  }
#pragma unroll
  for (int p = 0; p < P; ++p) {
    store<int32_t>(L, kBal, p, n, i, bal[p]);
    store<int32_t>(L, kPhase, p, n, i, phase[p]);
    store<int32_t>(L, kPropVal, p, n, i, prop_val[p]);
    store<int32_t>(L, kHeard, p, n, i, heard[p]);
    store<int32_t>(L, kCandEntTerm, p, n, i, c_term[p]);
    store<int32_t>(L, kCandEntVal, p, n, i, c_val[p]);
    store<int32_t>(L, kTimer, p, n, i, timer[p]);
    store<int32_t>(L, kDecidedVal, p, n, i, decided_val[p]);
  }
  lrn.store_to(L, n, i);
#pragma unroll
  for (int j = 0; j < S; ++j) {
    store<uint8_t>(L, kRqPresent, j, n, i, ((rq_present >> j) & 1u) ? 1 : 0);
    store<uint8_t>(L, kRpPresent, j, n, i, ((rp_present >> j) & 1u) ? 1 : 0);
  }
  sd::store_column<P, A, K, true, B, STAMPED>(col, L, n, i, rq_written, rp_written, lt_written);
  clk.mark(kPhStore);
  clk.flush();
}

// One instantiation, ready to launch (SmemInst in fused_common.cuh): an
// arms instantiation's kernel takes a Gray after Params, an observed one an
// obs::Obs after that, and its column holds the planes' counter rows after
// the staged rows (obs::TallyRows).
template <int P, int A, int K, bool STAMPED, int B, int MIN_BLOCKS, typename... Arms>
using InstWith = SmemInst<
    fused_raftcore_kernel<P, A, K, STAMPED, B, MIN_BLOCKS, Arms...>, B,
    (SdStaged<P, A, K, true, STAMPED>::kRows +
     (has_arg<obs::Obs, Arms...> ? obs::TallyRows<P>::kRows : 0)) * B * 4>;
template <int P, int A, int K, bool STAMPED, bool ARMS, bool OBS, int B, int MIN_BLOCKS>
struct InstOf {
  using type = InstWith<P, A, K, STAMPED, B, MIN_BLOCKS>;
};
template <int P, int A, int K, bool STAMPED, int B, int MIN_BLOCKS>
struct InstOf<P, A, K, STAMPED, true, false, B, MIN_BLOCKS> {
  using type = InstWith<P, A, K, STAMPED, B, MIN_BLOCKS, Gray>;
};
template <int P, int A, int K, bool STAMPED, int B, int MIN_BLOCKS>
struct InstOf<P, A, K, STAMPED, false, true, B, MIN_BLOCKS> {
  using type = InstWith<P, A, K, STAMPED, B, MIN_BLOCKS, obs::Obs>;
};
template <int P, int A, int K, bool STAMPED, int B, int MIN_BLOCKS>
struct InstOf<P, A, K, STAMPED, true, true, B, MIN_BLOCKS> {
  using type = InstWith<P, A, K, STAMPED, B, MIN_BLOCKS, Gray, obs::Obs>;
};
template <int P, int A, int K, bool STAMPED, bool ARMS, bool OBS, int B, int MIN_BLOCKS>
using Inst = typename InstOf<P, A, K, STAMPED, ARMS, OBS, B, MIN_BLOCKS>::type;

// The instantiations, (n_prop, n_acc, k_slots, STAMPED, ARMS, OBS, B,
// MIN_BLOCKS): one per shape, stamps, arms and observer flag, at the
// geometry fused_tick.FR_STAGING["raftcore"] gives it; MIN_BLOCKS, the
// blocks an SM is to hold, caps a thread's registers.  The arms, the stamps
// and the planes run at (2,5,8), the shape of every config that sets them;
// the stamped column (154 words) leaves room for 2 blocks of 128 lanes or
// 11 of 32, which hold 11 warps and ran faster (fused_tick.FR_STAGING);
// the observed one without the arms or the stamps (134 words,
// obs::TallyRows) takes 3 blocks of 128, the stamped one (174 words) 3 of
// 96, which ran faster than 2 of 128 at the 168 registers 9 warps leave a
// thread, the arms keys 2 of 128 (their counters need more registers than
// 3 blocks leave).
#define K3_INSTANCES(X)         \
  X(2, 5, 8, 0, 0, 0, 128, 3)   \
  X(2, 3, 8, 0, 0, 0, 128, 3)   \
  X(2, 5, 8, 0, 1, 0, 128, 3)   \
  X(2, 5, 8, 1, 0, 0, 32, 11)   \
  X(2, 5, 8, 1, 1, 0, 32, 11)   \
  X(2, 5, 8, 0, 0, 1, 128, 3)   \
  X(2, 5, 8, 0, 1, 1, 128, 2)   \
  X(2, 5, 8, 1, 0, 1, 96, 3)    \
  X(2, 5, 8, 1, 1, 1, 128, 2)

// Calls `fn(Inst<...>{}, std::bool_constant<ARMS>{}, std::bool_constant<OBS>{})`
// for the instantiation `dims` names (n_prop, n_acc, k_slots, stamped,
// arms, observed), or returns cudaErrorInvalidValue.
template <typename Fn>
cudaError_t dispatch(const int* dims, Fn&& fn) {
#define K3_MATCH(P_, A_, K_, S_, R_, O_, B_, M_)                                              \
  if (dims[0] == P_ && dims[1] == A_ && dims[2] == K_ && dims[3] == S_ && dims[4] == R_ && \
      dims[5] == O_)                                                                       \
    return fn(Inst<P_, A_, K_, S_ != 0, R_ != 0, O_ != 0, B_, M_>{},                       \
              std::bool_constant<R_ != 0>{}, std::bool_constant<O_ != 0>{});
  K3_INSTANCES(K3_MATCH)
#undef K3_MATCH
  return cudaErrorInvalidValue;
}

}  // namespace

// C entry point, loaded with ctypes (arguments: read_gray_args in
// fused_common.cuh; `dims` = n_prop, n_acc, k_slots, stamped (1: the
// state's buffers carry delay stamps, which p_delay > 0 needs), arms (1:
// the instantiation with the gray-failure and partition arms, which a knob
// of theirs needs), observed (1: the instantiation with the observer
// planes, which a state carrying one needs), then the dynamic shared bytes
// a block, fused_tick.FR_STAGING's); the state's leaves are 28, 30 with the
// stamps, and 3 more with snapshot shadows, which stale_k > 0 needs; `tick`
// is the device int32 tick scalar, read by the kernel and advanced by the
// caller; the observer leaves and their sizes (obs::read_obs_args) come
// last, none for an instantiation that is not observed.  Returns
// cudaSuccess or the first error: an unknown instantiation, a leaf count
// that is not its state's (a stamped state on an unstamped one), a knob on
// without its arms or its arms without a knob, stale_k without snapshots,
// p_delay without the stamps or the plan's link_delay, observer arguments
// that do not fit the instantiation or each other, or too few shared bytes
// (cudaErrorInvalidValue), a shared-memory request the card refuses, or the
// launch's cudaGetLastError().
extern "C" int fused_raftcore_launch(const int* dims, int n_dims, void** leaves, int n_leaves,
                                     void** plan, void* tick, const long long* params, int n_params,
                                     void* stream, void** obs_leaves, int n_obs,
                                     const long long* obs_params, int n_obs_params) {
  if (n_dims != 7) return cudaErrorInvalidValue;
  Leaves L;
  Plan pl;
  Params prm;
  Gray gray;
  cudaError_t bad = read_gray_args(dims[4] != 0, leaves, n_leaves, plan, params, n_params, &L,
                                   &pl, &prm, &gray, kLeaves, 3, 3, dims[3] != 0);
  if (bad != cudaSuccess) return bad;
  obs::Obs ob{};
  if (dims[5] != 0) {
    bad = obs::read_obs_args(obs_leaves, n_obs, obs_params, n_obs_params, &ob);
    if (bad != cudaSuccess) return bad;
    const bool snaps = n_leaves == kLeaves + (dims[3] != 0 ? 2 : 0) + 3;
    if ((ob.snaps != 0) != snaps) return cudaErrorInvalidValue;
  } else if (n_obs != 0 || n_obs_params != 0) {
    return cudaErrorInvalidValue;
  }
  const auto* t = static_cast<const int32_t*>(tick);
  auto s = static_cast<cudaStream_t>(stream);
  const int smem = dims[6];
  return dispatch(dims, [&](auto inst, auto with_arms, auto with_obs) {
    constexpr bool R = decltype(with_arms)::value, O = decltype(with_obs)::value;
    using I = decltype(inst);
    if constexpr (R && O) return I::launch(L, pl, t, prm, smem, s, gray, ob);
    else if constexpr (R) return I::launch(L, pl, t, prm, smem, s, gray);
    else if constexpr (O) return I::launch(L, pl, t, prm, smem, s, ob);
    else return I::launch(L, pl, t, prm, smem, s);
  });
}

// The blocks of instantiation `dims` (as for fused_raftcore_launch) that
// one SM of the current device holds at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), into *blocks_per_sm.
extern "C" int fused_raftcore_occupancy(const int* dims, int n_dims, int* blocks_per_sm) {
  if (n_dims != 7) return cudaErrorInvalidValue;
  const int smem = dims[6];
  return dispatch(dims, [&](auto inst, auto, auto) {
    return decltype(inst)::occupancy(smem, blocks_per_sm);
  });
}
