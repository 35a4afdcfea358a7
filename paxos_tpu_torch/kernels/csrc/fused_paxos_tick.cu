// Fused single-decree Paxos engine for Hopper (sm_90a): n_ticks ticks of
// counter_masks + apply_tick for every instance in one launch.
//
// Replaces: paxos_tpu/kernels/fused_tick.py::_kernel bound to the paxos
// tick (packed_fns("paxos")), the Pallas kernel that keeps a block of
// instances' state resident in VMEM for a whole chunk.
//
// Bound on this card: ~765 B/lane of state moved once each way per chunk
// (a settled lane, below, needs 122 B read at (2,5,8)), against a few
// thousand int32 operations per lane-tick; but a lane's tick
// is one long chain of dependent integer operations and branches, so the
// time falls with the warps an SM holds and with the code on the chain,
// and both bounds are far below it.
//
// Design: K2's (fused_fastpaxos_tick.cu), whose message layout Paxos
// shares.  One thread per instance (lane), the state split by access
// pattern so that a thread's registers allow 16 warps an SM, each part
// where it stays for the whole chunk:
//  - registers: the role scalars, the crash windows and equivocation bits,
//    the learner's scalars, the presence bitmasks of both buffers, and a
//    bitmask per buffer of the slots the chunk wrote;
//  - shared memory, a column per lane (word r at smem[r * B + t], B the
//    block's lane count; sd::SdStaged in fused_common.cuh): the message
//    payloads a tick reads and the learner's (ballot, value, voters) table.
//    A dynamic index (the selected request, a reply's slot) is one shared
//    load or store, where in registers it was a chain of selects;
//  - no row at all: the payload words the tick only ever writes as 0 (a
//    PREPARE's v1, every request's v2, an ACCEPTED's v2;
//    protocols/paxos.py).
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
// selection over an acceptor's present slots, sd::select_present, the
// sends over the acceptors only for a proposer that sends), the fold
// visits a proposer's delivered slots only, and an acceptor with nothing
// to select (crashed this tick, or no request present) is skipped before
// its idle mask is drawn.  Every draw is keyed by its position, so the
// order of the draws changes nothing, and a mask is drawn only where the
// outcome depends on it.  A settled lane (every proposer done, nothing in
// flight), whose ticks change nothing but the learner's scalars, gets the
// rest of the chunk at once, and a lane settled at entry no column load:
// a decided campaign's chunk costs little more than its scalars' loads
// and stores.
//
// The gray-failure and partition arms (partition cuts, one-way cuts,
// per-link loss and duplication thresholds, payload corruption, timer skew,
// stale-snapshot recovery and amnesia) compile into an instantiation of
// their own (ARMS, at (2,5,8), the shape of every config that sets them),
// which the C entry picks when a knob of theirs is on; the default
// instantiations compile none of their code.  K2 and K3 share the arms'
// pieces (sd::GrayLane, sd::recover and the other helpers in
// fused_common.cuh).  Each arm keeps to the
// design above: a cut masks the selected request and the delivered replies
// after the draws that select them, which are keyed by position, so they
// are made as before; the per-link draws (LINK_BITS where a message is
// sent, DUP_BITS where one is delivered or selected) and the corruption
// draw (an acceptor that processes a request) are made only at the site
// that reads them, each per-link threshold read from the plan there; the
// snapshot shadows stay in global memory, read on a recovery tick and
// written on a snapshot tick, and a settled lane still takes its restores
// and snapshots, one tick at a time.
//
// The bounded-delay channel (p_delay: delay stamps on every send, readiness
// gates on delivery and request selection) compiles into the stamped
// instantiations (STAMPED, at (2,5,8), without and with the arms), for a
// state whose buffers carry `until` stamps: K4's design, whose pieces the
// two kernels share (the stamp rows of sd::SdStaged and sd::Channel in
// fused_common.cuh).  The stamps sit in the lane's column, the slots still
// waiting for theirs in a bitmask per buffer, and a tick's sends are
// stamped by one rolled loop per buffer.  Both levers stay exact: a lane
// with a message in flight, waiting or not, is never settled (the test
// reads presence), and an acceptor's "nothing to select" skip, like the
// selection itself and the delivery loop, reads the slots that have
// arrived only.  A cut (ARMS) masks after the readiness gate and never
// touches a stamp.
//
// The observer planes (telemetry, coverage, exposure, margin, the client
// workload) compile into the observed instantiations (OBS, at (2,5,8), each
// without and with the stamps and the arms), for a state that carries a
// plane, through the pieces in obs:: (fused_common.cuh) that K2 to K5
// share: with exposure on, the tick's drop, dup, corrupt and delay
// decisions are drawn at its start (obs::predraw) and the lazy sites read
// those bits, so the schedule is the planes-off one; the planes run on the
// post-tick state, before the per-tick ballot clamp, each exactly as the
// plain tick computes it and off the tick's chain where it can: the
// coverage digest from batches of column words loaded ahead
// (obs::fold_buffers_ahead), its insert a tick late (obs::DeferredCoverage),
// the counters in registers (obs::Tally; obs::TallyRows in the column: 124
// words at 3 blocks of 128 without the arms or the stamps, 164 stamped,
// either with the arms at 2), the margin's walk of the learner table only
// where an accept event folded (obs::sd_margin).  A settled lane's planes
// still draw and count every tick, so it cannot take the rest of its chunk
// at once: its digest is folded again only where a restore, a snapshot or
// the clamp changed its state, and until every lane of its warp is settled
// it ticks in step with them (quiet: the tick's own work skipped), since
// lanes of one warp that left the tick loop at different ticks would run
// the settled ticks apart, one group after another (a first 1024-tick
// launch of observed-paxos ran 5.6 times as long as the same ticks in
// 64-tick launches, PERF.md section 6); then the warp runs a loop of the
// settled ticks alone.
//
// The ablated builds (-DFUSED_ABLATE, fused_common.cuh) instantiate
// config2's key only and remove their components where the tick runs
// them: no draw and the highest present slot selected (prng), no acceptor
// visited (select), no reply or request written (sends), delivered and
// selected slots left present (consume), no learner fold and no invariant
// count, settled lanes' included (learner), no proposer fold or send
// (proposer).  The settled-lane skip stays exact in each: a settled lane
// has nothing in flight and every proposer done, so no removed component
// moves it.
//
// Semantics follow the plain PyTorch version (protocols/paxos.py) exactly;
// the PRNG, stream positions and argument layout are in fused_common.cuh.
//  - reply delivery and consume precede the acceptor's new replies;
//    proposers fold the pre-tick reply payloads; requests are consumed
//    before the proposers send; ACCEPT carries the old ballot, PREPARE the
//    next one; chosen_tick is the pre-increment tick.

#include <type_traits>

#include "fused_common.cuh"

namespace {

// Proposer phases (core/state.py).
constexpr int32_t kP1 = 0, kP2 = 1, kDone = 2;

using sd::ColumnLearner;
using sd::select_present;
using sd::SdStaged;

// The tick's phases in order, each with its name in the phase-clock build's
// split of a lane's cycles (fused_tick.PHASES["paxos"]): an observed tick's
// planes take the four before the store.
enum Phase {
  kPhLoad,      // column load
  kPhDeliver,   // reply delivery
  kPhFold,      // proposer fold
  kPhAcceptor,  // acceptor half-tick
  kPhLearner,   // learner
  kPhSends,     // proposer sends
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
  kPromised, kAccBal, kAccVal,
  kBal, kPhase, kOwnVal, kPropVal, kHeard, kBestBal, kBestVal, kTimer,
  kDecidedVal,
};
// An acceptor's state breaks an acceptor-local invariant on its own: its
// accepted ballot above its promise, or a nil ballot with a value.
__device__ __forceinline__ bool breaks_alone(int32_t pr, int32_t ab, int32_t av) {
  return ab > pr || (ab == 0 && av != 0);
}

// The kernel; `Arms` is empty for the default instantiations, whose
// signature and code are those of K1 without the arms, a `Gray` for the
// arms instantiations (ARMS), which take the arms' knobs and plan leaves,
// and an obs::Obs (after the Gray, if any) for the observed ones (OBS),
// which compute the observer planes whose leaves it holds.
// STAMPED: the state's buffers carry delay stamps.
template <int P, int A, int K, bool STAMPED, int B, int MIN_BLOCKS, typename... Arms>
__global__ void __launch_bounds__(B, MIN_BLOCKS)
fused_paxos_kernel(Leaves L, Plan plan, const int32_t* __restrict__ tick_ptr, Params prm,
                   Arms... arms) {
  constexpr bool ARMS = has_arg<Gray, Arms...>;
  constexpr bool OBS = has_arg<obs::Obs, Arms...>;
  const Gray gray = pick_arg<Gray>(arms...);
  const obs::Obs ob = pick_arg<obs::Obs>(arms...);
  static_assert(B % 32 == 0, "a block is whole warps");
  using G = SdStaged<P, A, K, false, STAMPED>;
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
  constexpr uint32_t kAccs = (1u << A) - 1;
  extern __shared__ int32_t smem[];  // G::kRows * B words (OBS: and CR::kRows)

  const int64_t n = prm.n_inst;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * B + threadIdx.x;
  if (i >= n) return;
  PhaseClock<kPhases> clk;
  // A build ablated of the PRNG draws: every mask off.
  if constexpr (ablated(kNoPrng)) prm.idle.mode = prm.hold.mode = prm.dup.mode = prm.drop.mode = 0;

  // ---- Load the lane's register-resident state once: first what says
  //      whether the lane is settled (below), whose column no tick reads,
  //      so that it is not loaded. ----
  int32_t bal[P], phase[P], own_val[P], prop_val[P], heard[P], best_bal[P], best_val[P],
      timer[P], decided_val[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    phase[p] = load<int32_t>(L, kPhase, p, n, i);
    best_bal[p] = load<int32_t>(L, kBestBal, p, n, i);
  }
  uint32_t rq_present = 0, rp_present = 0;
#pragma unroll
  for (int j = 0; j < S; ++j) {
    rq_present |= (load<uint8_t>(L, kRqPresent, j, n, i) != 0 ? 1u : 0u) << j;
    rp_present |= (load<uint8_t>(L, kRpPresent, j, n, i) != 0 ? 1u : 0u) << j;
  }
  // A settled lane: every proposer done (with best_bal >= 0, as in every
  // state the ticks reach) and no message in flight.  Each of its ticks
  // draws nothing, reads no column word and changes nothing but the
  // learner's scalars (ColumnLearner::quiet, with the invariant breaks of
  // the unchanged acceptors) and, under the per-tick clamp, the ballots.
  const auto settled = [&] {
    bool s = rq_present == 0 && rp_present == 0;
#pragma unroll
    for (int p = 0; p < P; ++p) s = s && phase[p] == kDone && best_bal[p] >= 0;
    return s;
  };
  const Column<B> col{smem + threadIdx.x};
  // The bounded-delay channel's waiting slots (STAMPED), as the column.
  sd::Channel<P, A, B, G::kRqUntil, G::kRpUntil> ch;
  // An observed lane loads its column settled or not: the planes read
  // the learner table and the payloads.
  if (OBS || !settled()) {
    sd::load_column<P, A, K, false, sd::kCopyUnroll<MIN_BLOCKS>, B, STAMPED>(col, L, n, i);
    if constexpr (STAMPED) ch.load(col, prm, plan, n, i, *tick_ptr);
  }
  obs::Tally<STAMPED, ARMS> tally;
  // The planes' counters into the registers and the column, and the
  // zero-only payload words (no row) that are not 0 in global memory, which
  // the coverage digest folds where the chunk has not written their slot
  // (bit j: a PREPARE's v1; E + j: a request's v2; E + S + j: an
  // ACCEPTED's v2).
  uint64_t zo_nz = 0;
  if constexpr (OBS) {
    obs::move_tally_rows<P, R0>(col, ob, n, i, true);
    tally.move(ob, n, i, true);
    if (ob.cov()) zo_nz = obs::zero_words<G>(L, n, i);
  }

  int32_t promised[A], acc_bal[A], acc_val[A], crash_start[A], crash_end[A];
  uint32_t equiv = 0;
  // The honest acceptors whose state, left as it is, breaks an invariant:
  // the plain tick counts each of them every tick it does not change it
  // (none, from any state the ticks reach).
  uint32_t bad_alone = 0;
#pragma unroll
  for (int a = 0; a < A; ++a) {
    promised[a] = load<int32_t>(L, kPromised, a, n, i);
    acc_bal[a] = load<int32_t>(L, kAccBal, a, n, i);
    acc_val[a] = load<int32_t>(L, kAccVal, a, n, i);
    crash_start[a] = plan.crash_start[a * n + i];
    crash_end[a] = plan.crash_end[a * n + i];
    const bool eq = plan.equivocate[a * n + i] != 0;
    equiv |= (eq ? 1u : 0u) << a;
    bad_alone |= (!eq && breaks_alone(promised[a], acc_bal[a], acc_val[a]) ? 1u : 0u) << a;
  }
#pragma unroll
  for (int p = 0; p < P; ++p) {
    bal[p] = load<int32_t>(L, kBal, p, n, i);
    own_val[p] = load<int32_t>(L, kOwnVal, p, n, i);
    prop_val[p] = load<int32_t>(L, kPropVal, p, n, i);
    heard[p] = load<int32_t>(L, kHeard, p, n, i);
    best_val[p] = load<int32_t>(L, kBestVal, p, n, i);
    timer[p] = load<int32_t>(L, kTimer, p, n, i);
    decided_val[p] = load<int32_t>(L, kDecidedVal, p, n, i);
  }
  ColumnLearner<K, G::kLtBal> lrn;
  lrn.load_from(L, n, i);
  uint32_t rq_written = 0, rp_written = 0;  // the slots the chunk wrote
  bool lt_written = false;                  // an accept event reached the learner table

  // ---- The arms' per-lane plan: the partition window, the links that
  //      cross the cut, the cut's direction, the timeout skew. ----
  sd::GrayLane<P, A> glane;
  if constexpr (ARMS) glane.load(gray, n, i);

  const int32_t tick0 = *tick_ptr;
  const uint32_t blk = static_cast<uint32_t>(prm.blk0) + static_cast<uint32_t>(i / prm.block);
  const uint32_t lane = static_cast<uint32_t>(i % prm.block);
  const auto quorum_of = [&](int32_t) { return prm.q2; };

  // The acceptors whose promise or accepted ballot the tick changes (OBS:
  // the margin's promise slack; every one at a launch's first tick).
  uint32_t acc_dirty = 0;
  // Stale-snapshot recovery (stale_k) or amnesia at `tick`, before the
  // acceptor half-tick: an acceptor recovering this tick restores its
  // snapshot (is wiped), and on a snapshot tick every acceptor's snapshot
  // takes its state after the restore; the restored acceptors' invariant
  // breaks are recomputed.
  const auto recover = [&](int32_t tick) {
    sd::recover<ARMS, A, SNAP>(gray, L, tick, crash_end, promised, acc_bal, acc_val, n, i, [&](int a) {
      const bool bad = !((equiv >> a) & 1u) && breaks_alone(promised[a], acc_bal[a], acc_val[a]);
      bad_alone = (bad_alone & ~(1u << a)) | ((bad ? 1u : 0u) << a);
      if constexpr (OBS) acc_dirty |= 1u << a;
    });
  };
  clk.mark(kPhLoad);

  DrawCount draws;

  // ---- The observer planes (OBS; the default instantiations compile none
  //      of it), through the pieces K1, K2 and K3 share (obs:: in
  //      fused_common.cuh).  A site that draws reads exposure's draws of the
  //      tick instead where exposure made them (keep_at, dup_at,
  //      stamp_sends). ----
  const auto keep_at = [&](const TickStream& ts, const obs::PreDraw& pd, uint32_t stream, int kind,
                           int e) {
    return obs::keep_at<OBS, ARMS, E>(pd, ts, prm, gray, stream, kind, e, n, i);
  };
  const auto dup_at = [&](const TickStream& ts, const obs::PreDraw& pd, int buf, int j,
                          uint32_t stream) {
    return obs::dup_at<OBS, ARMS, S, E>(pd, ts, prm, gray, buf, j, stream, n, i);
  };
  const auto stamp_sends = [&](const TickStream& ts, const obs::PreDraw& pd, int row, uint32_t& wait,
                               int dir, uint32_t sent, int32_t tick) {
    obs::stamp_sends<OBS>(ch, pd, col, row, wait, dir, sent, prm, plan, ts, n, i, tick, &draws);
  };
  const auto predraw = [&](const TickStream& ts, int (&inj)[obs::kClasses]) {
    return obs::predraw<OBS, ARMS, STAMPED, P, A>(ob, ts, prm, gray, ch.slow, n, i, inj);
  };
  const auto fault_events = [&](int32_t tick, int (&ev)[obs::kEvents], int (&inj)[obs::kClasses],
                                int (&eff)[obs::kClasses]) {
    obs::fault_events<OBS, ARMS, P, A>(ob, gray, glane, crash_end, plan, tick, n, i, ev, inj, eff);
  };
  // The coverage digest of the lane's state (obs/coverage.py digest_tree:
  // the acceptors with their shadows, the proposers, both buffers with
  // their stamps), in the reference's leaf and row order.  A zero-only
  // payload word is 0 where the chunk wrote its slot, else what global
  // memory holds.
  const auto digest = [&]() {
    obs::Digest d;
#pragma unroll
    for (int a = 0; a < A; ++a) d.fold(promised[a]);
#pragma unroll
    for (int a = 0; a < A; ++a) d.fold(acc_bal[a]);
#pragma unroll
    for (int a = 0; a < A; ++a) d.fold(acc_val[a]);
    if constexpr (OBS) obs::fold_shadows_ahead<A, SNAP>(d, ob, L, n, i);
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
    obs::fold_buffers_ahead<G, STAMPED>(d, col, L, n, i, zo_nz, rq_written, rp_written,
                                        rq_present, rp_present);
    return d.value();
  };
  // The planes' update of a tick: its events (ev), exposure's counts, the
  // commit edges (serve) and the decide edge; the margin's walk of the
  // learner table where `walk` (else the last walk's near split again) and
  // its promise slack over the acceptors in acc_dirty; the digest of the
  // post-tick state where `digest_due`, its insert completed a tick late
  // (the insert of the tick before completes here, due or not).
  bool near = false;          // the last margin walk's near split (obs::sd_margin)
  obs::DeferredCoverage cov;  // the coverage insert in flight
  const auto planes = [&](const TickStream& ts, int32_t tick, const int (&ev)[obs::kEvents],
                          const int (&inj)[obs::kClasses], const int (&eff)[obs::kClasses],
                          uint32_t serve, bool decided_now, bool walk, bool digest_due) {
    if constexpr (OBS) {
      if (ob.tel()) tally.telemetry(ob, tick, ev, n, i);
      if (ob.exp()) tally.exposure(inj, eff);
      if (ob.wl()) obs::mp_workload<P, R0 + CR::kWl, kArrival>(col, ob, ts, tick, serve, n, i);
      clk.mark(kPhCounters);
      if (ob.mar()) {
        obs::sd_margin<K, A, G::kLtBal, R0 + CR::kMar>(col, quorum_of, walk, lrn.chosen,
                                                       lrn.chosen_val, decided_now, promised,
                                                       acc_bal, acc_dirty & ~equiv & kAccs, near);
      }
      clk.mark(kPhMargin);
      const uint32_t dg = ob.cov() && digest_due ? digest() : 0u;
      clk.mark(kPhDigest);
      if (ob.cov()) {
        tally.new_bits = wrap_add(tally.new_bits, cov.finish(ob, n, i));
        if (digest_due) cov.start(ob, dg, n, i);
      }
    }
    clk.mark(kPhCoverage);
  };

  // OBS: a settled lane's digest is due (its first settled tick; after a
  // clamp) and restores or snapshots may change its acceptors every tick.
  bool quiet_due = true;
  // OBS: every lane of the warp that is still running is settled (a vote of
  // the lanes that reach it together; one that votes alone decides for
  // itself, which is exact all the same).
  const auto warp_settled = [&] { return __all_sync(__activemask(), settled()) != 0; };
  const bool restores = ARMS && (gray.stale_k > 0 || gray.amnesia);
  for (int t = 0; t < prm.n_ticks; ++t) {
    // ---- A settled lane: the rest of the chunk at once (under stale
    //      recovery or amnesia, one tick at a time: its acceptors still
    //      restore and snapshot).  An observed one ticks on, its planes
    //      drawing and counting every tick: in a loop of its own once every
    //      lane of its warp is settled, else in step with its warp below
    //      (quiet), since lanes of one warp that left the tick loop at
    //      different ticks would run that loop apart, one group after
    //      another. ----
    if (OBS ? warp_settled() : settled()) {
      if constexpr (OBS) {
        for (; t < prm.n_ticks; ++t) {
          const int32_t tick = wrap_add(tick0, t);
          const TickStream ts{mix32(prm.seed, static_cast<uint32_t>(tick), blk),
                              static_cast<uint32_t>(prm.block), lane, &draws};
          cov.load(ob, n, i);
          acc_dirty = t == 0 ? kAccs : 0u;
          recover(tick);
          const int viol = __popc(bad_alone);
          lrn.quiet(viol);
          int ev[obs::kEvents] = {}, inj[obs::kClasses] = {}, eff[obs::kClasses] = {};
          ev[obs::kEvConflict] = viol;
          predraw(ts, inj);
          if constexpr (ARMS) {
            uint32_t cut_req = 0, cut_rep = 0;
            glane.cuts(tick, cut_req, cut_rep);
            if (gray.partition) inj[obs::kClPartition] = __popc(cut_req) + __popc(cut_rep);
          }
          fault_events(tick, ev, inj, eff);
          planes(ts, tick, ev, inj, eff, 0u, false, t == 0, quiet_due || restores);
          quiet_due = false;
          if (prm.clamp_per_tick) {
#pragma unroll
            for (int p = 0; p < P; ++p) {
              quiet_due = quiet_due || bal[p] > kBallotLimit;
              bal[p] = min(bal[p], kBallotLimit);
            }
          }
        }
      } else {
        if constexpr (ARMS) {
          if (gray.stale_k > 0 || gray.amnesia) {
            for (; t < prm.n_ticks; ++t) {
              recover(wrap_add(tick0, t));
              lrn.quiet(__popc(bad_alone));
            }
          }
        }
        const uint32_t rest = static_cast<uint32_t>(prm.n_ticks - t);
        if constexpr (!ablated(kNoLearner))
          lrn.quiet(static_cast<int>(rest * static_cast<uint32_t>(__popc(bad_alone))));
        if (prm.clamp_per_tick) {
#pragma unroll
          for (int p = 0; p < P; ++p) bal[p] = min(bal[p], kBallotLimit);
        }
      }
      break;
    }
    // A quiet lane (OBS, settled) skips only the tick's own work (delivery
    // to the sends), which changes nothing but the learner's scalars.  Its
    // digest changes only where a restore, a snapshot or the clamp changed
    // the state, so it is folded again only then, and the learner table and
    // the chosen bit not at all.
    const bool quiet = OBS && settled();
    const int32_t tick = wrap_add(tick0, t);
    const TickStream ts{mix32(prm.seed, static_cast<uint32_t>(tick), blk),
                        static_cast<uint32_t>(prm.block), lane, &draws};
    // The words of the previous tick's insert, loaded while this tick runs.
    if constexpr (OBS) cov.load(ob, n, i);
    // What the planes read of the pre-tick state (OBS).
    const uint32_t rq_p0 = rq_present, rp_p0 = rp_present;
    const bool chosen0 = lrn.chosen;
    const int32_t viol0 = lrn.violations;
    if constexpr (OBS) acc_dirty = t == 0 ? kAccs : 0u;
    recover(tick);
    // The slots whose stamp has come (STAMPED): a slot waiting for its
    // stamp is neither delivered nor selected.
    if constexpr (STAMPED) {
      if (!quiet) ch.refresh(col, tick, &draws);
    }
    const uint32_t rq_ready = rq_present & (STAMPED ? ~ch.rq_wait : ~0u);

    // The links cut this tick, per direction (bit e: edge e).
    uint32_t cut_req = 0, cut_rep = 0;
    if constexpr (ARMS) glane.cuts(tick, cut_req, cut_rep);

    // The planes' counts of the tick (OBS), exposure's draws, and what the
    // cuts and the stamps hold back of the pre-tick buffers.
    int ev[obs::kEvents] = {}, inj[obs::kClasses] = {}, eff[obs::kClasses] = {};
    const obs::PreDraw pd = predraw(ts, inj);
    int n_drop = 0, n_dup = 0;
    uint32_t prom_m = 0, corrupt_m = 0, p2_m = 0, plain_exp = 0;
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

    bool lt_tick = false;  // the learner table changed this tick (OBS: the margin walks it)
    if (quiet) {
      lrn.quiet(__popc(bad_alone));
    } else {
      // ---- Reply delivery (pre-tick buffer): the replies that have arrived,
      //      on a link not cut and not held this tick; consumed unless
      //      duplicated. ----
      uint32_t delivered = rp_present & (STAMPED ? ~ch.rp_wait : ~0u);
      if constexpr (ARMS) delivered &= ~(cut_rep | (cut_rep << E));
      if (prm.hold.mode != 0) {
        for (uint32_t m = delivered; m != 0; m &= m - 1) {
          const int j = __ffs(m) - 1;
          if (ts.fires_at(prm.hold, kDeliver, j)) delivered &= ~(1u << j);
        }
      }
      uint32_t taken = ablated(kNoConsume) ? 0u : delivered;
      if (!ablated(kNoConsume) && sd::dup_live<ARMS>(prm, gray)) {
        for (uint32_t m = delivered; m != 0; m &= m - 1) {
          const int j = __ffs(m) - 1;
          if (dup_at(ts, pd, 1, j, kDupRep)) taken &= ~(1u << j);
        }
        if constexpr (OBS) n_dup += __popc(delivered & ~taken);
      }
      const uint32_t rp_next = rp_present & ~taken;
      clk.mark(kPhDeliver);

      // ---- Proposer fold over the pre-tick replies. ----
      uint32_t p1_done = 0, expired = 0;  // proposers that send ACCEPT / PREPARE
      int32_t old_bal[P];
#pragma unroll
      for (int p = 0; p < P; ++p) {
        if (ablated(kNoProposer)) break;
        const int32_t cur = bal[p];
        int32_t h = heard[p];
        int32_t bb = best_bal[p], bv = best_val[p];
        // ACCEPTED in P2 at the current ballot.
        if (phase[p] == kP2) {
          for (uint32_t m = (delivered >> ((P + p) * A)) & kAccs; m != 0; m &= m - 1) {
            const int a = __ffs(m) - 1;
            if (col[G::kRpBal + (P + p) * A + a] == cur) h |= 1 << a;
          }
        }
        // PROMISE in P1 at the current ballot (a valid promise): the highest
        // previously-accepted ballot cb among them, the largest value
        // reported with it, and how many report it.
        int32_t cb = kInt32Min, cv = kInt32Min;
        int n_cb = 0;
        if (phase[p] == kP1) {
          for (uint32_t m = (delivered >> (p * A)) & kAccs; m != 0; m &= m - 1) {
            const int a = __ffs(m) - 1;
            const int j0 = p * A + a;
            if (col[G::kRpBal + j0] != cur) continue;
            h |= 1 << a;
            const int32_t pb = col[G::kRpV1 + j0];
            if (pb >= cb) {
              const int32_t pv = col[G::kRpV2 + j0];
              cv = pb > cb ? pv : max(cv, pv);
              n_cb = pb > cb ? 1 : n_cb + 1;
              cb = pb;
            }
          }
        }
        // The plain fold takes its max over every acceptor, in every phase,
        // with 0 for a slot that holds no valid promise (stale payloads
        // included): the candidate ballot is max(cb, 0 if a slot is not
        // valid), its value the max of the values of the slots at it, and 0
        // where a slot is not at it.  Where cb > 0 that is cb, and cv with a
        // 0 unless all A valid promises report cb: the delivered slots
        // suffice.  Otherwise the candidate is at most 0 and can upgrade only
        // a negative best_bal, which no state the ticks reach holds (it starts
        // at 0 and takes only a candidate above it, or 0 on expiry); for such
        // a state the fold runs over every slot, as the plain one does.
        if (cb > 0) {
          if (cb > bb) {
            bb = cb;
            bv = n_cb == A ? cv : max(cv, 0);
          }
        } else if (bb < 0) {
          int32_t fb = kInt32Min;
#pragma unroll 1
          for (int a = 0; a < A; ++a) {
            const int j0 = p * A + a;
            const bool ok =
                phase[p] == kP1 && ((delivered >> j0) & 1u) && col[G::kRpBal + j0] == cur;
            fb = max(fb, ok ? col[G::kRpV1 + j0] : 0);
          }
          if (fb > bb) {
            int32_t fv = kInt32Min;
#pragma unroll 1
            for (int a = 0; a < A; ++a) {
              const int j0 = p * A + a;
              const bool ok =
                  phase[p] == kP1 && ((delivered >> j0) & 1u) && col[G::kRpBal + j0] == cur;
              fv = max(fv, (ok ? col[G::kRpV1 + j0] : 0) == fb ? col[G::kRpV2 + j0] : 0);
            }
            bb = fb;
            bv = fv;
          }
        }

        const int votes = __popc(static_cast<uint32_t>(h));
        const bool p1 = phase[p] == kP1 && votes >= prm.q1;
        const bool p2 = phase[p] == kP2 && votes >= prm.q2;
        const int32_t v_by_p1 = bb > 0 ? bv : own_val[p];
        int32_t tm = phase[p] == kDone ? timer[p] : wrap_add(timer[p], 1);
        const int32_t timeout = ARMS ? glane.timeout(prm.timeout, p) : prm.timeout;
        const bool exp = phase[p] != kDone && !p1 && !p2 && tm > timeout;
        if constexpr (OBS) {  // the commit edge, and the expiry without the skew
          p2_m |= (p2 ? 1u : 0u) << p;
          plain_exp |= (phase[p] != kDone && !p1 && !p2 && tm > prm.timeout ? 1u : 0u) << p;
        }

        int32_t ph = phase[p];
        if (p1) ph = kP2;
        if (p2) ph = kDone;
        if (exp) ph = kP1;
        if (p2) decided_val[p] = prop_val[p];
        const int32_t pv = p1 ? v_by_p1 : prop_val[p];
        if (p1 || exp) h = 0;
        if (exp) {
          bb = 0;
          bv = 0;
        }
        if (p1) tm = 0;
        if (exp) {
          tm = ablated(kNoPrng)
                   ? 0
                   : sd::backoff_of<ARMS>(ts.bits(kBackoff, p) & 0x7FFFFFFFu, prm, gray, p, n, i);
        }
        old_bal[p] = cur;
        bal[p] = exp ? next_ballot(cur, prm.stride, p) : cur;
        phase[p] = ph;
        prop_val[p] = pv;
        heard[p] = h;
        best_bal[p] = bb;
        best_val[p] = bv;
        timer[p] = tm;
        p1_done |= (p1 ? 1u : 0u) << p;
        expired |= (exp ? 1u : 0u) << p;
      }
      clk.mark(kPhFold);

      // ---- Acceptor half-tick: select at most one request per acceptor. ----
      // Only an acceptor alive this tick with a request present (and arrived)
      // can select one; the others are skipped before their idle mask is
      // drawn, and contribute what the plain tick gives them: no reply, no
      // consume, no accept event, their state as it is, and its invariant
      // check (bad_alone).
      uint32_t asked = 0;
#pragma unroll
      for (int kp = 0; kp < 2 * P; ++kp) asked |= (rq_ready >> (kp * A)) & kAccs;
      uint32_t visit = 0;
#pragma unroll
      for (int a = 0; a < A; ++a)
        visit |= (crash_start[a] <= tick && tick < crash_end[a] ? 0u : 1u) << a;
      visit &= ablated(kNoSelect) ? 0u : asked;
      uint32_t rq_next = rq_present;
      uint32_t rp_sent = 0;  // the reply slots written this tick
      uint32_t ev_flag = 0;
      uint32_t acted = 0;    // the acceptors that selected a request
      int32_t ev_bal[A], ev_val[A];
      int inv_viol = 0;
#pragma unroll
      for (int a = 0; a < A; ++a) {
        ev_bal[a] = 0;
        ev_val[a] = 0;
        if (!((visit >> a) & 1u) || !ts.survives_at(prm.idle, kBusy, a)) continue;
        // (One has arrived.)
        const int sel = ablated(kNoPrng) ? sd::select_last<P, A>(rq_ready, a)
                                         : select_present<P, A>(ts, rq_ready, a);
        // A request on a cut link stays in flight: the acceptor processes
        // nothing this tick.
        if (ARMS && ((cut_req >> ((sel * A + a) % E)) & 1u)) continue;
        acted |= 1u << a;

        // The selected request's ballot, and an ACCEPT's value (a PREPARE's
        // v1 is 0, and only an accepting acceptor reads it); a corrupted
        // ACCEPT's value flips a bit, a corrupted PREPARE's ballot moves up.
        const bool is_prep = sel < P;
        const bool is_acc = !is_prep;
        int32_t mb = col[G::kRqBal + sel * A + a];
        int32_t mv = is_acc ? col[G::rq_v1(sel * A + a)] : 0;
        if constexpr (OBS) {
          if (obs::corrupt_fires<ARMS>(pd, ts, gray, a)) {
            if (is_acc) mv ^= 64;
            else mb = wrap_add(mb, 1);
            corrupt_m |= 1u << a;
          }
        } else {
          sd::corrupt<ARMS>(ts, gray, a, is_acc, mb, mv);
        }
        const bool eq = (equiv >> a) & 1u;
        const int32_t pr_old = promised[a], ab_old = acc_bal[a], av_old = acc_val[a];
        const bool ok_prep_h = is_prep && !eq && mb > pr_old;
        const bool ok_prep = ok_prep_h || (is_prep && eq);
        const bool ok_acc_h = is_acc && !eq && mb >= pr_old;
        const bool ok_acc = ok_acc_h || (is_acc && eq);

        int32_t pr = ok_prep_h ? mb : pr_old;
        if (ok_acc_h) pr = max(pr, mb);
        const int32_t ab = ok_acc ? mb : ab_old;
        const int32_t av = ok_acc ? mv : av_old;

        // The reply into the selected sender's slot (post-consume buffer):
        // PROMISE for proposer sel, ACCEPTED for proposer sel - P; a flaky
        // link drops it against its own threshold.
        const int jr = sel * A + a;
        const bool prom_kept = !ablated(kNoSends) && ok_prep && keep_at(ts, pd, kKeepProm, 0, jr);
        if (prom_kept) {
          col[G::kRpBal + jr] = mb;
          col[G::kRpV1 + jr] = eq ? 0 : ab_old;
          col[G::kRpV2 + jr] = eq ? 0 : av_old;
          rp_sent |= 1u << jr;
        }
        const bool accd_kept =
            !ablated(kNoSends) && ok_acc && keep_at(ts, pd, kKeepAccd, 1, jr - E);
        if (accd_kept) {
          col[G::kRpBal + jr] = mb;
          col[G::kRpV1 + jr] = mv;
          rp_sent |= 1u << jr;
        }
        // Consume the selected request unless it is duplicated (on a flaky
        // link, against its own threshold).
        const bool dup_req = !ablated(kNoConsume) && sd::dup_live<ARMS>(prm, gray) &&
                             dup_at(ts, pd, 0, jr, kDupReq);
        if (!ablated(kNoConsume) && !dup_req) rq_next &= ~(1u << jr);
        if constexpr (OBS) {
          prom_m |= (ok_prep ? 1u : 0u) << a;
          n_drop += (ok_prep && !prom_kept ? 1 : 0) + (ok_acc && !accd_kept ? 1 : 0);
          n_dup += dup_req ? 1 : 0;
        }

        // Acceptor-local invariants (honest acceptors only).
        if (!eq && (pr < pr_old || breaks_alone(pr, ab, av))) ++inv_viol;
        bad_alone = (bad_alone & ~(1u << a)) | ((!eq && breaks_alone(pr, ab, av) ? 1u : 0u) << a);
        if constexpr (OBS) acc_dirty |= (pr != pr_old || ab != ab_old ? 1u : 0u) << a;
        promised[a] = pr;
        acc_bal[a] = ab;
        acc_val[a] = av;
        ev_flag |= (ok_acc ? 1u : 0u) << a;
        ev_bal[a] = mb;
        ev_val[a] = mv;
      }
      inv_viol += __popc(bad_alone & ~acted);
      // The replies' delay stamps (the stamp draws are keyed by the slot, so
      // one rolled loop serves every reply site).
      if constexpr (STAMPED) stamp_sends(ts, pd, G::kRpUntil, ch.rp_wait, 1, rp_sent, tick);
      rp_present = rp_next | rp_sent;
      rp_written |= rp_sent;
      rq_present = rq_next;
      clk.mark(kPhAcceptor);

      // ---- Learner: fold accept events into the (ballot, value) table. ----
      if constexpr (!ablated(kNoLearner)) {
        if (lrn.template observe<A>(col, ev_flag, ev_bal, ev_val, tick, inv_viol, quorum_of)) {
          lt_written = true;
          lt_tick = true;
        }
      }
      clk.mark(kPhLearner);

      // ---- Proposer sends into the consumed request buffer, then their
      //      delay stamps (STAMPED). ----
      uint32_t rq_sent = 0;  // the request slots written this tick
#pragma unroll
      for (int p = 0; p < P; ++p) {
        if ((p1_done | expired) >> p & 1u) {
#pragma unroll 1
          for (int a = 0; a < A; ++a) {
            const int e = p * A + a;
            const bool acc_sent =
                !ablated(kNoSends) && ((p1_done >> p) & 1u) && keep_at(ts, pd, kKeepP2, 3, e);
            if (acc_sent) {
              const int j = (1 * P + p) * A + a;  // ACCEPT(old ballot, value)
              col[G::kRqBal + j] = old_bal[p];
              col[G::rq_v1(j)] = prop_val[p];
              rq_sent |= 1u << j;
            }
            const bool prep_sent =
                !ablated(kNoSends) && ((expired >> p) & 1u) && keep_at(ts, pd, kKeepP1, 2, e);
            if (prep_sent) {
              const int j = (0 * P + p) * A + a;  // PREPARE(next ballot)
              col[G::kRqBal + j] = bal[p];
              rq_sent |= 1u << j;
            }
            if constexpr (OBS) {
              n_drop += (((p1_done >> p) & 1u) && !acc_sent ? 1 : 0) +
                        (((expired >> p) & 1u) && !prep_sent ? 1 : 0);
            }
          }
        }
        // (An observed tick clamps after the planes: the digest reads the
        // ballots as the tick left them.)
        if (!OBS && prm.clamp_per_tick) bal[p] = min(bal[p], kBallotLimit);
      }
      if constexpr (STAMPED) stamp_sends(ts, pd, G::kRqUntil, ch.rq_wait, 0, rq_sent, tick);
      rq_present |= rq_sent;
      rq_written |= rq_sent;
      clk.mark(kPhSends);

      // The tick's events (OBS).
      if constexpr (OBS) {
        ev[obs::kEvPromise] = __popc(prom_m);
        ev[obs::kEvAccept] = __popc(ev_flag);
        ev[obs::kEvLeader] = __popc(p1_done);
        ev[obs::kEvTimeout] = __popc(expired);
        ev[obs::kEvDrop] = n_drop;
        ev[obs::kEvDup] = n_dup;
        ev[obs::kEvCorrupt] = __popc(corrupt_m);
        eff[obs::kClDrop] = n_drop;
        eff[obs::kClDup] = n_dup;
        eff[obs::kClCorrupt] = __popc(corrupt_m);
        if (ARMS && gray.timeout_skew) eff[obs::kClTimeout] = __popc(expired ^ plain_exp);
      }
    }

    // ---- The observer planes (OBS), from the tick's events, every lane of
    //      a warp together. ----
    if constexpr (OBS) {
      const bool decided_now = lrn.chosen && !chosen0;
      ev[obs::kEvDecide] = decided_now ? 1 : 0;
      ev[obs::kEvConflict] = wrap_add(lrn.violations, -viol0);
      fault_events(tick, ev, inj, eff);
      planes(ts, tick, ev, inj, eff, p2_m, decided_now, t == 0 || lt_tick,
             !quiet || quiet_due || restores);
      // A quiet tick's digest is due again after a tick that was not quiet
      // or where the clamp changed a ballot.
      quiet_due = !quiet;
      if (prm.clamp_per_tick) {
#pragma unroll
        for (int p = 0; p < P; ++p) {
          quiet_due = quiet_due || bal[p] > kBallotLimit;
          bal[p] = min(bal[p], kBallotLimit);
        }
      }
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
// obs::Obs after that, and its column holds the planes' counter rows after
// the staged rows (obs::TallyRows).
template <int P, int A, int K, bool STAMPED, int B, int MIN_BLOCKS, typename... Arms>
using InstWith = SmemInst<
    fused_paxos_kernel<P, A, K, STAMPED, B, MIN_BLOCKS, Arms...>, B,
    (SdStaged<P, A, K, false, STAMPED>::kRows +
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
// geometry fused_tick.FR_STAGING["paxos"] gives it; MIN_BLOCKS, the blocks
// an SM is to hold, caps a thread's registers.  The observed one without
// the arms or the stamps (124 words) takes 3 blocks of 128, the others 2
// (the stamped one spilled 44 B at 3 of 96).  An ablated build
// instantiates config2's only (fused_tick.ABLATE_KEYS).
#define K1_INSTANCES(X)         \
  X(2, 5, 8, 0, 0, 0, 128, 4)   \
  X(1, 3, 8, 0, 0, 0, 128, 4)   \
  X(2, 5, 8, 0, 1, 0, 128, 3)   \
  X(2, 5, 8, 1, 0, 0, 128, 3)   \
  X(2, 5, 8, 1, 1, 0, 128, 3)   \
  X(2, 5, 8, 0, 0, 1, 128, 3)   \
  X(2, 5, 8, 0, 1, 1, 128, 2)   \
  X(2, 5, 8, 1, 0, 1, 128, 2)   \
  X(2, 5, 8, 1, 1, 1, 128, 2)

// The ablated builds' one instantiation, a row of the table above.
#define K1_ABLATED_INSTANCES(X) X(2, 5, 8, 0, 0, 0, 128, 4)

// Calls `fn(Inst<...>{}, std::bool_constant<ARMS>{}, std::bool_constant<OBS>{})`
// for the instantiation `dims` names (n_prop, n_acc, k_slots, stamped,
// arms, observed), or returns cudaErrorInvalidValue.
template <typename Fn>
cudaError_t dispatch(const int* dims, Fn&& fn) {
#define K1_MATCH(P_, A_, K_, S_, R_, O_, B_, M_)                                              \
  if (dims[0] == P_ && dims[1] == A_ && dims[2] == K_ && dims[3] == S_ && dims[4] == R_ && \
      dims[5] == O_)                                                                       \
    return fn(Inst<P_, A_, K_, S_ != 0, R_ != 0, O_ != 0, B_, M_>{},                       \
              std::bool_constant<R_ != 0>{}, std::bool_constant<O_ != 0>{});
#ifdef FUSED_ABLATE
  K1_ABLATED_INSTANCES(K1_MATCH)
#else
  K1_INSTANCES(K1_MATCH)
#endif
#undef K1_MATCH
  return cudaErrorInvalidValue;
}

}  // namespace

// C entry point, loaded with ctypes (arguments: read_gray_args in
// fused_common.cuh; `dims` = n_prop, n_acc, k_slots, stamped (1: the
// state's buffers carry delay stamps, which p_delay > 0 needs), arms (1:
// the instantiation with the gray-failure and partition arms, which a knob
// of theirs needs), observed (1: the instantiation with the observer
// planes, which a state carrying one needs), then the dynamic shared bytes
// a block, fused_tick.FR_STAGING's); the state's leaves are 28, 30 with
// the stamps, and 3 more with snapshot shadows, which stale_k > 0 needs;
// `tick` is the device int32 tick scalar, read by the kernel and advanced
// by the caller; the observer leaves and their sizes
// (obs::read_obs_args) come last, none for an instantiation that is not
// observed.  Returns cudaSuccess or the first error: an unknown
// instantiation, a leaf count that is not its state's (a stamped state on
// an unstamped one), a knob on without its arms, p_delay without the
// stamps or the plan's link_delay, observer arguments that do not fit the
// instantiation or each other, or too few shared bytes
// (cudaErrorInvalidValue), a shared-memory request the card refuses, or
// the launch's cudaGetLastError().
extern "C" int fused_paxos_launch(const int* dims, int n_dims, void** leaves, int n_leaves,
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

// The blocks of instantiation `dims` (as for fused_paxos_launch) that one
// SM of the current device holds at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), into *blocks_per_sm.
extern "C" int fused_paxos_occupancy(const int* dims, int n_dims, int* blocks_per_sm) {
  if (n_dims != 7) return cudaErrorInvalidValue;
  const int smem = dims[6];
  return dispatch(dims, [&](auto inst, auto, auto) {
    return decltype(inst)::occupancy(smem, blocks_per_sm);
  });
}
