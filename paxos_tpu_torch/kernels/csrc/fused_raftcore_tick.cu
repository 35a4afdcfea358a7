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

// The tick's phases in order, as the phase-clock build splits a lane's
// cycles (fused_tick.PHASES["raftcore"]).
enum Phase {
  kPhLoad, kPhDeliver, kPhFold, kPhAcceptor, kPhLearner, kPhSends, kPhStore,
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
// signature and code are those of the kernel without the arms, and `Gray`
// for the arms instantiation (ARMS), which takes the arms' knobs and plan
// leaves.
template <int P, int A, int K, int B, int MIN_BLOCKS, typename... Arms>
__global__ void __launch_bounds__(B, MIN_BLOCKS)
fused_raftcore_kernel(Leaves L, Plan plan, const int32_t* __restrict__ tick_ptr, Params prm,
                      Arms... arms) {
  constexpr bool ARMS = sizeof...(Arms) > 0;
  const Gray gray{arms...};
  static_assert(B % 32 == 0, "a block is whole warps");
  using G = SdStaged<P, A, K, true>;
  constexpr int S = G::S;  // message slots per buffer, index (kind * P + p) * A + a
  constexpr int E = G::E;  // links (edges), index p * A + a; slot j is on edge j % E
  static_assert(S <= 32, "slot presence must fit one 32-bit mask");
  constexpr int kQuorum = A / 2 + 1;
  constexpr uint32_t kVoters = (1u << A) - 1;
  extern __shared__ int32_t smem[];  // G::kRows * B words

  const int64_t n = prm.n_inst;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * B + threadIdx.x;
  if (i >= n) return;
  PhaseClock<kPhases> clk;
  const Column<B> col{smem + threadIdx.x};
  sd::load_column<P, A, K, true, sd::kCopyUnroll<MIN_BLOCKS>>(col, L, n, i);

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
  for (int t = 0; t < prm.n_ticks; ++t) {
    const int32_t tick = wrap_add(tick0, t);
    const TickStream ts{mix32(prm.seed, static_cast<uint32_t>(tick), blk),
                        static_cast<uint32_t>(prm.block), lane, &draws};
    // Stale-snapshot recovery or amnesia (the arms), before the voter
    // half-tick and its invariant check.
    sd::recover<ARMS, A>(gray, L, tick, crash_end, voted, ent_term, ent_val, n, i, [](int) {});
    // The links cut this tick, per direction (bit e: edge e).
    uint32_t cut_req = 0, cut_rep = 0;
    if constexpr (ARMS) glane.cuts(tick, cut_req, cut_rep);

    // ---- Reply delivery (pre-tick buffer): the replies on a link not cut
    //      and not held this tick; consumed unless duplicated. ----
    uint32_t delivered = rp_present;
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
        if (sd::duplicated<ARMS, S, E>(ts, prm, gray, kDupRep, 1, j, n, i)) taken &= ~(1u << j);
      }
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
      const int win = select_present<P, A>(ts, rq_present, a);
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
      if (sel >= 0) sd::corrupt<ARMS>(ts, gray, a, is_ap, mb, mv);
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
      if (is_rv && sd::kept<ARMS, E>(ts, prm, gray, kKeepProm, 0, sel * A + a, n, i)) {
        const int jr = sel * A + a;
        col[G::kRpBal + jr] = mb;
        col[G::kRpV1 + jr] = wrap_add(
            static_cast<int32_t>(static_cast<uint32_t>(eq ? 0 : et_old) * 2u), grant ? 1 : 0);
        col[G::kRpV2 + jr] = eq ? 0 : ev_old;
        rp_sent |= 1u << jr;
      }
      if (ok_ap && sd::kept<ARMS, E>(ts, prm, gray, kKeepAccd, 1, (sel - P) * A + a, n, i)) {
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
              sd::duplicated<ARMS, S, E>(ts, prm, gray, kDupReq, 0, j, n, i)))
          rq_next &= ~(1u << j);
      }

      // Voter-local invariants (honest voters only).
      const bool bad = vo < vo_old || et > vo || et < et_old || (et == 0 && ev != 0);
      if (bad && !eq) ++inv_viol;
      voted[a] = vo;
      ent_term[a] = et;
      ent_val[a] = ev;
      ev_flag |= (ok_ap ? 1u : 0u) << a;
      ev_bal[a] = mb;
      ev_val[a] = mv;
    }
    rp_present = rp_next | rp_sent;
    rp_written |= rp_sent;
    rq_present = rq_next;
    clk.mark(kPhAcceptor);

    // ---- Learner: append-accept events, majority commit. ----
    if (lrn.template observe<A>(col, ev_flag, ev_bal, ev_val, tick, inv_viol, quorum_of))
      lt_written = true;
    clk.mark(kPhLearner);

    // ---- Candidate sends into the consumed request buffer. ----
    uint32_t rq_sent = 0;  // the request slots written this tick
#pragma unroll
    for (int p = 0; p < P; ++p) {
      if ((leading | expired) >> p & 1u) {
#pragma unroll 1
        for (int a = 0; a < A; ++a) {
          if (((leading >> p) & 1u) && sd::kept<ARMS, E>(ts, prm, gray, kKeepP2, 3, p * A + a, n, i)) {
            const int j = (kAppend * P + p) * A + a;  // APPEND(term, value), every tick
            col[G::kRqBal + j] = bal[p];
            col[G::rq_v1(j)] = prop_val[p];
            rq_sent |= 1u << j;
          }
          if (((expired >> p) & 1u) && sd::kept<ARMS, E>(ts, prm, gray, kKeepP1, 2, p * A + a, n, i)) {
            const int j = (kReqVote * P + p) * A + a;  // REQVOTE(next term, entry term)
            col[G::kRqBal + j] = bal[p];
            col[G::rq_v1(j)] = c_term[p];
            rq_sent |= 1u << j;
          }
        }
      }
      if (prm.clamp_per_tick) bal[p] = min(bal[p], kBallotLimit);
    }
    rq_present |= rq_sent;
    rq_written |= rq_sent;
    clk.mark(kPhSends);
  }

  draws.flush();

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
  sd::store_column<P, A, K, true, B>(col, L, n, i, rq_written, rp_written, lt_written);
  clk.mark(kPhStore);
  clk.flush();
}

// One instantiation, ready to launch (SmemInst in fused_common.cuh): the
// arms instantiation's kernel takes a Gray after Params.
template <int P, int A, int K, bool ARMS, int B, int MIN_BLOCKS>
struct InstOf {
  using type = SmemInst<fused_raftcore_kernel<P, A, K, B, MIN_BLOCKS>, B,
                        SdStaged<P, A, K, true>::kRows * B * 4>;
};
template <int P, int A, int K, int B, int MIN_BLOCKS>
struct InstOf<P, A, K, true, B, MIN_BLOCKS> {
  using type = SmemInst<fused_raftcore_kernel<P, A, K, B, MIN_BLOCKS, Gray>, B,
                        SdStaged<P, A, K, true>::kRows * B * 4>;
};
template <int P, int A, int K, bool ARMS, int B, int MIN_BLOCKS>
using Inst = typename InstOf<P, A, K, ARMS, B, MIN_BLOCKS>::type;

// The instantiations, (n_prop, n_acc, k_slots, ARMS, B, MIN_BLOCKS): one per
// shape and arms flag, at the geometry fused_tick.FR_STAGING["raftcore"]
// gives it; MIN_BLOCKS, the blocks an SM is to hold, caps a thread's
// registers.  The arms run at (2,5,8), the shape of every config that sets
// them.
#define K3_INSTANCES(X) \
  X(2, 5, 8, 0, 128, 3)   \
  X(2, 3, 8, 0, 128, 3)   \
  X(2, 5, 8, 1, 128, 3)

// Calls `fn(Inst<...>{}, std::bool_constant<ARMS>{})` for the
// instantiation `dims` names (n_prop, n_acc, k_slots, arms), or returns
// cudaErrorInvalidValue.
template <typename Fn>
cudaError_t dispatch(const int* dims, Fn&& fn) {
#define K3_MATCH(P_, A_, K_, R_, B_, M_)                                     \
  if (dims[0] == P_ && dims[1] == A_ && dims[2] == K_ && dims[3] == R_) \
    return fn(Inst<P_, A_, K_, R_ != 0, B_, M_>{}, std::bool_constant<R_ != 0>{});
  K3_INSTANCES(K3_MATCH)
#undef K3_MATCH
  return cudaErrorInvalidValue;
}

}  // namespace

// C entry point, loaded with ctypes (arguments: read_args in
// fused_common.cuh; `dims` = n_prop, n_acc, k_slots, arms (1: the
// instantiation with the gray-failure and partition arms, which a knob of
// theirs needs), then the dynamic shared bytes a block,
// fused_tick.FR_STAGING's); the state's leaves are 28, or 31 with snapshot
// shadows, which stale_k > 0 needs; `tick` is the device int32 tick
// scalar, read by the kernel and advanced by the caller.  Returns
// cudaSuccess or the first error: an unknown instantiation, a knob on
// without its arms or its arms without a knob, stale_k without snapshots
// or too few shared bytes (cudaErrorInvalidValue), a shared-memory request
// the card refuses, or the launch's cudaGetLastError().
extern "C" int fused_raftcore_launch(const int* dims, int n_dims, void** leaves, int n_leaves,
                                     void** plan, void* tick, const long long* params, int n_params,
                                     void* stream) {
  if (n_dims != 5) return cudaErrorInvalidValue;
  Leaves L;
  Plan pl;
  Params prm;
  Gray gray;
  const cudaError_t bad =
      read_gray_args(dims[3] != 0, leaves, n_leaves, plan, params, n_params, &L, &pl, &prm, &gray);
  if (bad != cudaSuccess) return bad;
  const auto* t = static_cast<const int32_t*>(tick);
  auto s = static_cast<cudaStream_t>(stream);
  const int smem = dims[4];
  return dispatch(dims, [&](auto inst, auto with_arms) {
    if constexpr (decltype(with_arms)::value) return decltype(inst)::launch(L, pl, t, prm, smem, s, gray);
    else return decltype(inst)::launch(L, pl, t, prm, smem, s);
  });
}

// The blocks of instantiation `dims` (as for fused_raftcore_launch) that
// one SM of the current device holds at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), into *blocks_per_sm.
extern "C" int fused_raftcore_occupancy(const int* dims, int n_dims, int* blocks_per_sm) {
  if (n_dims != 5) return cudaErrorInvalidValue;
  const int smem = dims[4];
  return dispatch(dims, [&](auto inst, auto) { return decltype(inst)::occupancy(smem, blocks_per_sm); });
}
