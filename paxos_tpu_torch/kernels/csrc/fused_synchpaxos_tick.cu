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
// Design: K1's (fused_paxos_tick.cu).  One thread per lane loads the lane's
// scalars into registers once, runs all n_ticks ticks and stores once, in
// place; the PRNG, reply delivery, request selection and the learner table
// are the shared helpers of fused_common.cuh.  The delay stamps (`until`,
// 2 buffers x 2 kinds x P x A int32 a lane) would add 40 live registers
// to a kernel that already spills at (2,5,8), so they stay in global
// memory (Stamps in fused_common.cuh): a register bitmask of the slots
// still waiting and the earliest stamp among them gate delivery and
// selection, a stamp is read back only when it may have come due, and is
// written only where a send writes its slot.  The plan's link_delay is
// read as a bitmask of slow links once, and a cap only where a send is
// delayed.
//
// Bound on this card: ~925 B/lane of state (765 without the stamps) moved
// once each way per chunk, against a few thousand int32 operations per
// lane-tick, so at 64 ticks per chunk it is bound by integer operations,
// not bytes.
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
// delay and latency draws, made only for a send on a slow link.

#include "fused_common.cuh"

namespace {

// Proposer phases (core/state.py, core/sp_state.py).
constexpr int32_t kP1 = 0, kP2 = 1, kDone = 2, kFast = 3;

// The role leaves in the reference's flatten order; the learner and the
// message buffers follow (SharedLeaf).
enum Leaf {
  kPromised, kAccBal, kAccVal,
  kBal, kPhase, kOwnVal, kPropVal, kHeard, kBestBal, kBestVal, kTimer,
  kDecidedVal,
};

template <int P, int A, int K, bool kStamped>
__global__ void __launch_bounds__(kThreads)
fused_synchpaxos_kernel(Leaves L, Plan plan, const int32_t* __restrict__ tick_ptr, Params prm) {
  constexpr int S = 2 * P * A;  // message slots per buffer, index (kind*P + p)*A + a

  const int64_t n = prm.n_inst;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;

  // ---- Load the lane's state once. ----
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
  Learner<K> lrn;
  lrn.load_from(L, n, i);
  MsgBufs<S> m;
  m.load_from(L, n, i);

  const int32_t tick0 = *tick_ptr;
  // Links whose latency cap is above 0: the only edges a send can be delayed on.
  uint32_t slow = 0;
  if (kStamped && prm.delay.mode != 0) {
#pragma unroll
    for (int e = 0; e < P * A; ++e) slow |= (plan.link_delay[e * n + i] > 0 ? 1u : 0u) << e;
  }
  Stamps<S> st;
  if (kStamped) st.load_from(L, n, i, tick0);

  const uint32_t blk = static_cast<uint32_t>(prm.blk0) + static_cast<uint32_t>(i / prm.block);
  const uint32_t lane = static_cast<uint32_t>(i % prm.block);
  const auto quorum_of = [&](int32_t) { return prm.q2; };

  DrawCount draws;
  for (int t = 0; t < prm.n_ticks; ++t) {
    const int32_t tick = wrap_add(tick0, t);
    const TickStream ts{mix32(prm.seed, static_cast<uint32_t>(tick), blk),
                        static_cast<uint32_t>(prm.block), lane, &draws};
    if (kStamped) st.refresh(L, n, i, tick, &draws);
    const uint32_t rp_ready = kStamped ? ~st.rp_wait : ~0u;
    const uint32_t rq_ready = m.rq_present & (kStamped ? ~st.rq_wait : ~0u);

    // ---- Reply delivery (pre-tick buffer, arrived replies) and consume. ----
    uint32_t rp_next;
    const uint32_t delivered = m.deliver(prm, ts, &rp_next, rp_ready);

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
        const bool prom_ok = ((delivered >> j0) & 1u) && m.rp_bal[j0] == cur && phase[p] == kP1;
        const bool accd_ok =
            ((delivered >> j1) & 1u) && m.rp_bal[j1] == cur && (phase[p] == kP2 || fast);
        if (prom_ok || accd_ok) h |= 1 << a;
        prev[a] = prom_ok ? m.rp_v1[j0] : 0;
        cand_bal = max(cand_bal, prev[a]);
      }
      int32_t cand_val = kInt32Min;
#pragma unroll
      for (int a = 0; a < A; ++a)
        cand_val = max(cand_val, prev[a] == cand_bal ? m.rp_v2[(0 * P + p) * A + a] : 0);
      const bool upgrade = cand_bal > best_bal[p];
      int32_t bb = upgrade ? cand_bal : best_bal[p];
      int32_t bv = upgrade ? cand_val : best_val[p];

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

    // ---- Acceptor half-tick: select at most one arrived request per acceptor. ----
    uint32_t rq_next = m.rq_present;
    uint32_t ev_flag = 0;
    int32_t ev_bal[A], ev_val[A];
    int inv_viol = 0;
#pragma unroll
    for (int a = 0; a < A; ++a) {
      const bool alive = !(crash_start[a] <= tick && tick < crash_end[a]);
      const bool busy = ts.survives_at(prm.idle, kBusy, a);
      const int win = select_request<P, A>(ts, rq_ready, a);
      const int sel = (win >= 0 && busy && alive) ? win : -1;

      int32_t mb = 0, mv = 0;
#pragma unroll
      for (int kp = 0; kp < 2 * P; ++kp) {
        if (kp == sel) {
          mb = m.rq_bal[kp * A + a];
          mv = m.rq_v1[kp * A + a];
        }
      }
      const bool is_prep = sel >= 0 && sel < P;
      const bool is_acc = sel >= P;
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

      // Replies to the selected sender's slot (post-consume buffer), stamped.
#pragma unroll
      for (int p = 0; p < P; ++p) {
        if (sel == p && ok_prep && ts.survives_at(prm.drop, kKeepProm, p * A + a)) {
          const int jr = (0 * P + p) * A + a;
          m.rp_bal[jr] = mb;
          m.rp_v1[jr] = eq ? 0 : ab_old;
          m.rp_v2[jr] = eq ? 0 : av_old;
          rp_next |= 1u << jr;
          if (kStamped)
            st.write(L, kRpUntil, jr, n, i, tick,
                     delay_stamp<P, A>(prm, plan, ts, slow, 1, 0, p, a, n, i, tick), &draws);
        }
        if (sel == P + p && ok_acc && ts.survives_at(prm.drop, kKeepAccd, p * A + a)) {
          const int jr = (1 * P + p) * A + a;
          m.rp_bal[jr] = mb;
          m.rp_v1[jr] = mv;
          m.rp_v2[jr] = 0;
          rp_next |= 1u << jr;
          if (kStamped)
            st.write(L, kRpUntil, jr, n, i, tick,
                     delay_stamp<P, A>(prm, plan, ts, slow, 1, 1, p, a, n, i, tick), &draws);
        }
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
    m.rp_present = rp_next;
    m.rq_present = rq_next;

    // ---- Learner: fold accept events into the (ballot, value) table. ----
    lrn.template observe<A>(ev_flag, ev_bal, ev_val, tick, inv_viol, quorum_of);

    // ---- Proposer sends into the consumed request buffer, stamped. ----
#pragma unroll
    for (int p = 0; p < P; ++p) {
#pragma unroll
      for (int a = 0; a < A; ++a) {
        if (((accept >> p) & 1u) && ts.survives_at(prm.drop, kKeepP2, p * A + a)) {
          const int j = (1 * P + p) * A + a;  // ACCEPT(old ballot, own or phase-1 value)
          m.rq_bal[j] = old_bal[p];
          m.rq_v1[j] = accept_val[p];
          m.rq_v2[j] = 0;
          m.rq_present |= 1u << j;
          if (kStamped)
            st.write(L, kRqUntil, j, n, i, tick,
                     delay_stamp<P, A>(prm, plan, ts, slow, 0, 1, p, a, n, i, tick), &draws);
        }
        if (((expired >> p) & 1u) && ts.survives_at(prm.drop, kKeepP1, p * A + a)) {
          const int j = (0 * P + p) * A + a;  // PREPARE(next ballot)
          m.rq_bal[j] = bal[p];
          m.rq_v1[j] = 0;
          m.rq_v2[j] = 0;
          m.rq_present |= 1u << j;
          if (kStamped)
            st.write(L, kRqUntil, j, n, i, tick,
                     delay_stamp<P, A>(prm, plan, ts, slow, 0, 0, p, a, n, i, tick), &draws);
        }
      }
      if (prm.clamp_per_tick) bal[p] = min(bal[p], kBallotLimit);
    }
  }

  draws.flush();

  // ---- Store the lane's state once (the stamps are written in place). ----
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
  m.store_to(L, n, i);
}

template <int P, int A, int K, bool kStamped>
cudaError_t launch(const Leaves& L, const Plan& plan, const int32_t* tick, const Params& prm,
                   cudaStream_t stream) {
  fused_synchpaxos_kernel<P, A, K, kStamped>
      <<<grid_for(prm.n_inst), kThreads, 0, stream>>>(L, plan, tick, prm);
  return cudaGetLastError();
}

}  // namespace

// C entry point, loaded with ctypes (arguments: read_args in
// fused_common.cuh; `dims` = n_prop, n_acc, k_slots, stamped, where stamped
// is 1 when the state's buffers carry delay stamps: 30 leaves, else 28);
// `tick` is the device int32 tick scalar, read by the kernel and advanced
// by the caller.  p_delay > 0 needs the plan's link_delay.  Returns the
// launch's cudaGetLastError().
extern "C" int fused_synchpaxos_launch(const int* dims, int n_dims, void** leaves, int n_leaves,
                                       void** plan, void* tick, const long long* params,
                                       int n_params, void* stream) {
  if (n_dims != 4) return cudaErrorInvalidValue;
  const int n_prop = dims[0], n_acc = dims[1], k_slots = dims[2], stamped = dims[3];
  Leaves L;
  Plan pl;
  Params prm;
  const cudaError_t bad = read_args(leaves, n_leaves, stamped ? kStampedLeaves : kLeaves, plan,
                                    params, n_params, &L, &pl, &prm, true);
  if (bad != cudaSuccess) return bad;
  if (stamped) move_stamps_last(&L);
  const auto* t = static_cast<const int32_t*>(tick);
  auto s = static_cast<cudaStream_t>(stream);
  if (n_prop == 2 && n_acc == 5 && k_slots == 8)
    return stamped ? launch<2, 5, 8, true>(L, pl, t, prm, s) : launch<2, 5, 8, false>(L, pl, t, prm, s);
  if (n_prop == 2 && n_acc == 3 && k_slots == 8 && stamped)
    return launch<2, 3, 8, true>(L, pl, t, prm, s);
  return cudaErrorInvalidValue;
}
