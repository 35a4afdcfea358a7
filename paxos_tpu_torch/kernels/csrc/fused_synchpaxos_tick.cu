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
//    block's lane count, as K5 keeps its slot windows; sd::SdStaged in
//    fused_common.cuh, whose stamp rows K1's stamped instantiations share): the
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
// rolled loop per buffer then stamps them (sd::Channel; the stamp draws are
// keyed by the slot, so the order of the stamps changes nothing); an acceptor's request
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
//
// The gray-failure and partition arms (partition cuts, one-way cuts,
// per-link loss and duplication thresholds, payload corruption, timer skew,
// stale-snapshot recovery and amnesia) compile into instantiations of their
// own at (2,5,8), without and with the stamps, as K1's to K3's and K5's:
// the kernel takes a trailing `Gray` that the default instantiations do
// not, and the pieces are K1's (sd::GrayLane, sd::recover, sd::kept,
// sd::duplicated, sd::corrupt, sd::backoff_of).  A cut masks the selected
// request and the delivered replies after the draws that select them and
// after the readiness gate, so it stalls a stamped message as it stalls
// any other and never touches a stamp (delay and cuts lose nothing); the
// per-link and corruption draws are made only at the site that reads them;
// the snapshot shadows stay in global memory; the timeout skew moves the
// classic deadline only (FAST's stays delta), the backoff skew scales the
// expiry backoff.
//
// The observer planes (telemetry, coverage, exposure, margin, the client
// workload) compile into observed instantiations of their own (OBS, at
// (2,5,8), without and with the stamps and the arms), as K1's to K3's: the
// kernel takes an obs::Obs after the Gray (if any), keeps the planes'
// counters in the lane's column after the staged rows (obs::Rows), draws
// exposure's whole masks at the tick's start and reads them at the lazy
// sites (obs::predraw), and folds the coverage digest from registers, the
// column and global memory (obs::fold_shadows, obs::fold_buffers).  What
// is SynchPaxos' own: a fast decide is a leader event and serves a client
// request as a classic one does; the FAST round's kick sends ACCEPTs that
// telemetry does not count as dropped sends (as the reference's tick); and
// a skewed timeout is effective where the expiry differs from that under
// the unskewed deadline, FAST's delta in the fast round.  The other
// instantiations call the sd:: sites directly, as before the planes.

#include <type_traits>

#include "fused_common.cuh"

namespace {

// Proposer phases (core/state.py, core/sp_state.py).
constexpr int32_t kP1 = 0, kP2 = 1, kDone = 2, kFast = 3;

using sd::ColumnLearner;
using sd::SdStaged;
using sd::select_present;

// The tick's phases in order, as the phase-clock build splits a lane's
// cycles (fused_tick.PHASES["synchpaxos"]).
enum Phase {
  kPhLoad, kPhRefresh, kPhDeliver, kPhFold, kPhAcceptor, kPhLearner, kPhSends, kPhObs,
  kPhStore, kPhases,
};

// The role leaves in the reference's flatten order; the learner and the
// message buffers follow (SharedLeaf).
enum Leaf {
  kPromised, kAccBal, kAccVal,
  kBal, kPhase, kOwnVal, kPropVal, kHeard, kBestBal, kBestVal, kTimer,
  kDecidedVal,
};

// The kernel; `Arms` is empty for the default instantiations, whose
// signature and code are those of K4 without the arms, a `Gray` for the
// arms instantiations (ARMS), which take the arms' knobs and plan leaves,
// and an obs::Obs (after the Gray, if any) for the observed ones (OBS),
// which compute the observer planes whose leaves it holds.
template <int P, int A, int K, bool STAMPED, int B, int MIN_BLOCKS, typename... Arms>
__global__ void __launch_bounds__(B, MIN_BLOCKS)
fused_synchpaxos_kernel(Leaves L, Plan plan, const int32_t* __restrict__ tick_ptr, Params prm,
                        Arms... arms) {
  constexpr bool ARMS = has_arg<Gray, Arms...>;
  constexpr bool OBS = has_arg<obs::Obs, Arms...>;
  const Gray gray = pick_arg<Gray>(arms...);
  const obs::Obs ob = pick_arg<obs::Obs>(arms...);
  static_assert(B % 32 == 0, "a block is whole warps");
  using G = SdStaged<P, A, K, false, STAMPED>;
  constexpr int R0 = G::kRows;  // the observer counters' first row (OBS)
  constexpr int S = G::S;  // message slots per buffer, index (kind * P + p) * A + a
  constexpr int E = G::E;  // links (edges), index p * A + a; slot j is on edge j % E
  // The snapshot shadows' first leaf (after the stamps in a stamped state).
  constexpr int SNAP = STAMPED ? kStampedLeaves : kSnap0;
  static_assert(S <= 32, "slot presence must fit one 32-bit mask");
  constexpr uint32_t kAccs = (1u << A) - 1;
  extern __shared__ int32_t smem[];  // G::kRows * B words (OBS: and the counters)

  const int64_t n = prm.n_inst;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * B + threadIdx.x;
  if (i >= n) return;
  PhaseClock<kPhases> clk;
  const Column<B> col{smem + threadIdx.x};
  sd::load_column<P, A, K, false, 0, B, STAMPED>(col, L, n, i);
  // The planes' counters into the column, and the zero-only payload words
  // that are not 0 in global memory (obs::zero_words), which the coverage
  // digest folds where the chunk has not written their slot.
  uint64_t zo_nz = 0;
  if constexpr (OBS) {
    obs::move_counters<P, R0>(col, ob, n, i, true);
    if (ob.cov()) zo_nz = obs::zero_words<G>(L, n, i);
  }

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

  const int32_t tick0 = *tick_ptr;
  sd::Channel<P, A, B, G::kRqUntil, G::kRpUntil> ch;
  if constexpr (STAMPED) ch.load(col, prm, plan, n, i, tick0);

  // ---- The arms' per-lane plan: the partition window, the links that
  //      cross the cut, the cut's direction, the timeout skew. ----
  sd::GrayLane<P, A> glane;
  if constexpr (ARMS) glane.load(gray, n, i);
  clk.mark(kPhLoad);

  const uint32_t blk = static_cast<uint32_t>(prm.blk0) + static_cast<uint32_t>(i / prm.block);
  const uint32_t lane = static_cast<uint32_t>(i % prm.block);
  const auto quorum_of = [&](int32_t) { return prm.q2; };

  DrawCount draws;
  for (int t = 0; t < prm.n_ticks; ++t) {
    const int32_t tick = wrap_add(tick0, t);
    const TickStream ts{mix32(prm.seed, static_cast<uint32_t>(tick), blk),
                        static_cast<uint32_t>(prm.block), lane, &draws};
    // What the planes read of the pre-tick state (OBS).
    const uint32_t rq_p0 = rq_present, rp_p0 = rp_present;
    const bool chosen0 = lrn.chosen;
    const int32_t viol0 = lrn.violations;
    // Stale-snapshot recovery or amnesia, before the acceptor half-tick
    // (the restored state is the one the invariant check starts from).
    sd::recover<ARMS, A, SNAP>(gray, L, tick, crash_end, promised, acc_bal, acc_val, n, i,
                               [](int) {});
    if constexpr (STAMPED) ch.refresh(col, tick, &draws);
    const uint32_t rq_ready = rq_present & (STAMPED ? ~ch.rq_wait : ~0u);
    // The links cut this tick, per direction (bit e: edge e).
    uint32_t cut_req = 0, cut_rep = 0;
    if constexpr (ARMS) glane.cuts(tick, cut_req, cut_rep);

    // The planes' counts of the tick (OBS), exposure's draws (an observed
    // instantiation's sites that draw read them instead where exposure made
    // them: obs::keep_at, obs::dup_at, obs::stamp_sends, the corruption
    // site), and what the cuts and the stamps hold back of the pre-tick
    // buffers.
    int ev[obs::kEvents] = {}, inj[obs::kClasses] = {}, eff[obs::kClasses] = {};
    const obs::PreDraw pd =
        obs::predraw<OBS, ARMS, STAMPED, P, A>(ob, ts, prm, gray, ch.slow, n, i, inj);
    int n_drop = 0, n_dup = 0;
    uint32_t prom_m = 0, corrupt_m = 0, serve_m = 0, leader_m = 0, plain_exp = 0;
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
    clk.mark(kPhRefresh);

    // ---- Reply delivery (pre-tick buffer): the replies that have arrived,
    //      are on a link not cut and are not held; consumed unless
    //      duplicated (on a flaky link, against its own threshold). ----
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

    // ---- Proposer fold over the pre-tick replies. ----
    uint32_t accept = 0, expired = 0;  // proposers that send ACCEPT / PREPARE
    uint32_t p1_done = 0;              // of them, the classic ACCEPTs (OBS)
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
      // FAST's deadline is delta; the timeout skew moves the classic one.
      const int32_t deadline =
          fast ? prm.delta : (ARMS ? glane.timeout(prm.timeout, p) : prm.timeout);
      const bool exp = phase[p] != kDone && !p1 && !p2 && !fast_done && tm > deadline;
      // The round-0 broadcast: FAST at the pre-tick timer 0 (never with p1).
      const bool kick = fast && timer[p] == 0;
      if constexpr (OBS) {  // the decide edges, and the expiry under the unskewed deadline
        serve_m |= (p2 || fast_done ? 1u : 0u) << p;
        leader_m |= (p1 || fast_done ? 1u : 0u) << p;
        plain_exp |= (phase[p] != kDone && !p1 && !p2 && !fast_done &&
                              tm > (fast ? prm.delta : prm.timeout)
                          ? 1u : 0u)
                     << p;
      }

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
        tm = sd::backoff_of<ARMS>(ts.bits(kBackoff, p) & 0x7FFFFFFFu, prm, gray, p, n, i);
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
      p1_done |= (p1 ? 1u : 0u) << p;
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
      int sel = (win >= 0 && busy && alive) ? win : -1;
      // A request on a cut link stays in flight: the acceptor processes
      // nothing this tick.
      if (ARMS && sel >= 0 && ((cut_req >> ((sel * A + a) % E)) & 1u)) sel = -1;

      // The selected request's ballot, and an ACCEPT's value (a PREPARE's
      // v1 is 0, and only an accepting acceptor reads it); a corrupted
      // ACCEPT's value flips a bit, a corrupted PREPARE's ballot moves up.
      const bool is_prep = sel >= 0 && sel < P;
      const bool is_acc = sel >= P;
      int32_t mb = sel >= 0 ? col[G::kRqBal + sel * A + a] : 0;
      int32_t mv = is_acc ? col[G::rq_v1(sel * A + a)] : 0;
      if constexpr (OBS) {
        if (sel >= 0 && obs::corrupt_fires<ARMS>(pd, ts, gray, a)) {
          if (is_acc) mv ^= 64;
          else mb = wrap_add(mb, 1);
          corrupt_m |= 1u << a;
        }
      } else if (sel >= 0) {
        sd::corrupt<ARMS>(ts, gray, a, is_acc, mb, mv);
      }
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
      // PROMISE for proposer sel, ACCEPTED for proposer sel - P; a flaky
      // link drops it against its own threshold.
      const int jr = sel * A + a;
      if (ok_prep &&
          (OBS ? obs::keep_at<OBS, ARMS, E>(pd, ts, prm, gray, kKeepProm, 0, jr, n, i)
               : sd::kept<ARMS, E>(ts, prm, gray, kKeepProm, 0, jr, n, i))) {
        col[G::kRpBal + jr] = mb;
        col[G::kRpV1 + jr] = eq ? 0 : ab_old;
        col[G::kRpV2 + jr] = eq ? 0 : av_old;
        rp_sent |= 1u << jr;
      }
      if (ok_acc &&
          (OBS ? obs::keep_at<OBS, ARMS, E>(pd, ts, prm, gray, kKeepAccd, 1, jr - E, n, i)
               : sd::kept<ARMS, E>(ts, prm, gray, kKeepAccd, 1, jr - E, n, i))) {
        col[G::kRpBal + jr] = mb;
        col[G::kRpV1 + jr] = mv;
        rp_sent |= 1u << jr;
      }
      // Consume the selected request unless it is duplicated (on a flaky
      // link, against its own threshold).
      if (sel >= 0 &&
          !(sd::dup_live<ARMS>(prm, gray) &&
            (OBS ? obs::dup_at<OBS, ARMS, S, E>(pd, ts, prm, gray, 0, jr, kDupReq, n, i)
                 : sd::duplicated<ARMS, S, E>(ts, prm, gray, kDupReq, 0, jr, n, i))))
        rq_next &= ~(1u << jr);
      if constexpr (OBS) {
        prom_m |= (ok_prep ? 1u : 0u) << a;
        if (sel >= 0) {
          n_drop += (ok_prep || ok_acc) && !((rp_sent >> jr) & 1u) ? 1 : 0;
          n_dup += (rq_next >> jr) & 1u;
        }
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

    // ---- Learner: fold accept events into the (ballot, value) table. ----
    if (lrn.template observe<A>(col, ev_flag, ev_bal, ev_val, tick, inv_viol, quorum_of))
      lt_written = true;
    clk.mark(kPhLearner);

    // ---- Proposer sends into the consumed request buffer, then their
    //      delay stamps. ----
    uint32_t rq_sent = 0;  // the request slots written this tick
#pragma unroll
    for (int p = 0; p < P; ++p) {
      if ((accept | expired) >> p & 1u) {
#pragma unroll 1
        for (int a = 0; a < A; ++a) {
          const int e = p * A + a;
          if (((accept >> p) & 1u) &&
              (OBS ? obs::keep_at<OBS, ARMS, E>(pd, ts, prm, gray, kKeepP2, 3, e, n, i)
                   : sd::kept<ARMS, E>(ts, prm, gray, kKeepP2, 3, e, n, i))) {
            const int j = (1 * P + p) * A + a;  // ACCEPT(old ballot, own or phase-1 value)
            col[G::kRqBal + j] = old_bal[p];
            col[G::rq_v1(j)] = accept_val[p];
            rq_sent |= 1u << j;
          }
          if (((expired >> p) & 1u) &&
              (OBS ? obs::keep_at<OBS, ARMS, E>(pd, ts, prm, gray, kKeepP1, 2, e, n, i)
                   : sd::kept<ARMS, E>(ts, prm, gray, kKeepP1, 2, e, n, i))) {
            const int j = (0 * P + p) * A + a;  // PREPARE(next ballot)
            col[G::kRqBal + j] = bal[p];
            rq_sent |= 1u << j;
          }
        }
        if constexpr (OBS) {  // the dropped sends: the classic ACCEPTs' and PREPAREs' slots not written
          const uint32_t acc = (rq_sent >> ((1 * P + p) * A)) & kAccs;
          const uint32_t prep = (rq_sent >> ((0 * P + p) * A)) & kAccs;
          n_drop += ((p1_done >> p) & 1u ? A - __popc(acc) : 0) +
                    ((expired >> p) & 1u ? A - __popc(prep) : 0);
        }
      }
      // (An observed tick clamps after the planes: the digest reads the
      // ballots as the tick left them.)
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

    // ---- The observer planes (OBS), from the tick's events, in the plain
    //      tick's order: telemetry, exposure, margin, workload, coverage. ----
    if constexpr (OBS) {
      const bool decided_now = lrn.chosen && !chosen0;
      ev[obs::kEvPromise] = __popc(prom_m);
      ev[obs::kEvAccept] = __popc(ev_flag);
      ev[obs::kEvDecide] = decided_now ? 1 : 0;
      ev[obs::kEvConflict] = wrap_add(lrn.violations, -viol0);
      ev[obs::kEvLeader] = __popc(leader_m);
      ev[obs::kEvTimeout] = __popc(expired);
      ev[obs::kEvDrop] = n_drop;
      ev[obs::kEvDup] = n_dup;
      ev[obs::kEvCorrupt] = __popc(corrupt_m);
      eff[obs::kClDrop] = n_drop;
      eff[obs::kClDup] = n_dup;
      eff[obs::kClCorrupt] = __popc(corrupt_m);
      if (ARMS && gray.timeout_skew) eff[obs::kClTimeout] = __popc(expired ^ plain_exp);
      obs::fault_events<OBS, ARMS, P, A>(ob, gray, glane, crash_end, plan, tick, n, i, ev, inj, eff);
      if (ob.tel()) obs::telemetry<P, R0>(col, ob, tick, ev, n, i);
      if (ob.exp()) obs::exposure<P, R0>(col, inj, eff);
      if (ob.mar()) {
        obs::margin<P, R0, K, A, G::kLtBal>(col, quorum_of, lrn.chosen, lrn.chosen_val,
                                            decided_now, promised, acc_bal, ~equiv & kAccs);
      }
      if (ob.wl()) obs::workload<P, R0>(col, ob, ts, tick, serve_m, n, i);
      if (ob.cov()) {
        // The coverage digest of the lane's state (obs/coverage.py digest_tree:
        // the acceptors with their shadows, the proposers, both buffers with
        // their stamps), in the reference's leaf and row order.
        obs::Digest d;
#pragma unroll
        for (int a = 0; a < A; ++a) d.fold(promised[a]);
#pragma unroll
        for (int a = 0; a < A; ++a) d.fold(acc_bal[a]);
#pragma unroll
        for (int a = 0; a < A; ++a) d.fold(acc_val[a]);
        obs::fold_shadows<A, SNAP>(d, ob, L, n, i);
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
        for (int p = 0; p < P; ++p) d.fold(best_bal[p]);
#pragma unroll
        for (int p = 0; p < P; ++p) d.fold(best_val[p]);
#pragma unroll
        for (int p = 0; p < P; ++p) d.fold(timer[p]);
#pragma unroll
        for (int p = 0; p < P; ++p) d.fold(decided_val[p]);
        obs::fold_buffers<G, STAMPED>(d, col, L, n, i, zo_nz, rq_written, rp_written, rq_present,
                                      rp_present);
        obs::coverage<P, R0>(col, ob, d.value(), n, i);
      }
      if (prm.clamp_per_tick) {
#pragma unroll
        for (int p = 0; p < P; ++p) bal[p] = min(bal[p], kBallotLimit);
      }
      clk.mark(kPhObs);
    }
  }

  draws.flush();
  if constexpr (OBS) obs::move_counters<P, R0>(col, ob, n, i, false);

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
  lrn.store_to(L, n, i);
#pragma unroll
  for (int j = 0; j < S; ++j) {
    store<uint8_t>(L, kRqPresent, j, n, i, ((rq_present >> j) & 1u) ? 1 : 0);
    store<uint8_t>(L, kRpPresent, j, n, i, ((rp_present >> j) & 1u) ? 1 : 0);
  }
  sd::store_column<P, A, K, false, B, STAMPED>(col, L, n, i, rq_written, rp_written, lt_written);
  clk.mark(kPhStore);
  clk.flush();
}

// One instantiation, ready to launch (SmemInst in fused_common.cuh): an
// arms instantiation's kernel takes a Gray after Params, an observed one an
// obs::Obs after that, and its column holds the planes' counters
// (obs::Rows) after the staged rows.
template <int P, int A, int K, bool STAMPED, int B, int MIN_BLOCKS, typename... Arms>
using InstWith = SmemInst<
    fused_synchpaxos_kernel<P, A, K, STAMPED, B, MIN_BLOCKS, Arms...>, B,
    (SdStaged<P, A, K, false, STAMPED>::kRows +
     (has_arg<obs::Obs, Arms...> ? obs::Rows<P>::kRows : 0)) * B * 4>;
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

// The instantiations, (n_prop, n_acc, k_slots, stamped, arms, observed, B,
// MIN_BLOCKS): one per shape, stamps, arms and observer flag, at the
// geometry fused_tick.SP_STAGING gives it; MIN_BLOCKS, the blocks an SM is
// to hold, caps a thread's registers.  The observed columns (153 and 193
// words) leave room for 2 blocks.
#define K4_INSTANCES(X)            \
  X(2, 5, 8, 1, 0, 0, 128, 3)      \
  X(2, 5, 8, 0, 0, 0, 128, 3)      \
  X(2, 3, 8, 1, 0, 0, 128, 3)      \
  X(2, 5, 8, 0, 1, 0, 128, 3)      \
  X(2, 5, 8, 1, 1, 0, 128, 3)      \
  X(2, 5, 8, 0, 0, 1, 128, 2)      \
  X(2, 5, 8, 0, 1, 1, 128, 2)      \
  X(2, 5, 8, 1, 0, 1, 128, 2)      \
  X(2, 5, 8, 1, 1, 1, 128, 2)

// Calls `fn(Inst<...>{}, std::bool_constant<ARMS>{}, std::bool_constant<OBS>{})`
// for the instantiation `dims` names (n_prop, n_acc, k_slots, stamped,
// arms, observed), or returns cudaErrorInvalidValue.
template <typename Fn>
cudaError_t dispatch(const int* dims, Fn&& fn) {
#define K4_MATCH(P_, A_, K_, S_, R_, O_, B_, M_)                                              \
  if (dims[0] == P_ && dims[1] == A_ && dims[2] == K_ && dims[3] == S_ && dims[4] == R_ && \
      dims[5] == O_)                                                                       \
    return fn(Inst<P_, A_, K_, S_ != 0, R_ != 0, O_ != 0, B_, M_>{},                       \
              std::bool_constant<R_ != 0>{}, std::bool_constant<O_ != 0>{});
  K4_INSTANCES(K4_MATCH)
#undef K4_MATCH
  return cudaErrorInvalidValue;
}

}  // namespace

// C entry point, loaded with ctypes (arguments: read_gray_args in
// fused_common.cuh; `dims` = n_prop, n_acc, k_slots, stamped (1: the
// state's buffers carry delay stamps, 30 leaves, else 28; 3 more with
// snapshot shadows, which stale_k > 0 needs), arms (1: the instantiation
// with the gray-failure and partition arms, which a knob of theirs needs),
// observed (1: the instantiation with the observer planes, which a state
// carrying one needs), then the dynamic shared bytes a block,
// fused_tick.SP_STAGING's); `tick` is the device int32 tick scalar, read by
// the kernel and advanced by the caller; the observer leaves and their
// sizes (obs::read_obs_args) come last, none for an instantiation that is
// not observed.  p_delay > 0 needs a stamped instantiation and the plan's
// link_delay.  Returns cudaSuccess or the first error: an unknown
// instantiation, a leaf count that is not its state's, a knob on without
// its arms, observer arguments that do not fit the instantiation or each
// other, or too few shared bytes (cudaErrorInvalidValue), a shared-memory
// request the card refuses, or the launch's cudaGetLastError().
extern "C" int fused_synchpaxos_launch(const int* dims, int n_dims, void** leaves, int n_leaves,
                                       void** plan, void* tick, const long long* params,
                                       int n_params, void* stream, void** obs_leaves, int n_obs,
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

// The blocks of instantiation `dims` (as for fused_synchpaxos_launch) that
// one SM of the current device holds at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), into *blocks_per_sm.
extern "C" int fused_synchpaxos_occupancy(const int* dims, int n_dims, int* blocks_per_sm) {
  if (n_dims != 7) return cudaErrorInvalidValue;
  const int smem = dims[6];
  return dispatch(dims, [&](auto inst, auto, auto) {
    return decltype(inst)::occupancy(smem, blocks_per_sm);
  });
}
