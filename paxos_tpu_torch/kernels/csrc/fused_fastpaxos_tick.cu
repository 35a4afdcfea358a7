// Fused Fast Paxos engine for Hopper (sm_90a): n_ticks ticks of
// counter_masks + apply_tick_fast for every instance in one launch.
//
// Replaces: paxos_tpu/kernels/fused_tick.py::_kernel bound to the Fast
// Paxos tick (fused_fns("fastpaxos"), launched by fused_chunk through
// pl.pallas_call), the Pallas kernel that keeps a block of instances'
// state resident in VMEM for a whole chunk.
//
// Design: K1's (fused_paxos_tick.cu).  One thread per lane loads the lane's
// state into registers once, runs all n_ticks ticks and stores once, in
// place; the PRNG, reply delivery, request selection and the learner table
// are the shared helpers of fused_common.cuh.
//
// Bound on this card: ~773 B/lane of state moved twice per chunk against a
// few thousand int32 operations per lane-tick, so at 64 ticks per chunk it
// is bound by integer operations, not bytes.  Fast Paxos adds the P x P
// recovery masks (rep_mask) to the live state, so (2,5,8) spills a little
// more than K1 (ptxas -v); packing the state and tuning occupancy are
// later work.
//
// What differs from the Paxos tick (protocols/fastpaxos.py):
//  - acceptors vote at most once per ballot (the revote rule);
//  - the learner's threshold is per slot: q_fast for a fast-round ballot
//    (ballot_round == 0), q2 otherwise;
//  - proposers start in FAST and collect ACCEPTED at the shared fast
//    ballot; a timed-out proposer runs classic recovery, folding each
//    PROMISE's prev-accepted (ballot, value) into rep_mask in acceptor
//    order, and adopts the first choosable value (cnt + unheard >= q_fast)
//    when the highest reported ballot is of the fast round;
//  - fast_done decides own_val.

#include "fused_common.cuh"

namespace {

// Proposer phases (core/state.py, core/fp_state.py).
constexpr int32_t kP1 = 0, kP2 = 1, kDone = 2, kFast = 3;
constexpr int32_t kValueBase = 100;  // proposer p proposes kValueBase + p

// The role leaves in the reference's flatten order; the learner and the
// message buffers follow (SharedLeaf).
enum Leaf {
  kPromised, kAccBal, kAccVal,
  kBal, kPhase, kOwnVal, kPropVal, kHeard, kBestBal, kRepMask, kTimer,
  kDecidedVal,
};

template <int P, int A, int K>
__global__ void __launch_bounds__(kThreads)
fused_fastpaxos_kernel(Leaves L, Plan plan, const int32_t* __restrict__ tick_ptr, Params prm) {
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
  int32_t bal[P], phase[P], own_val[P], prop_val[P], heard[P], best_bal[P], timer[P],
      decided_val[P], rep_mask[P][P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    bal[p] = load<int32_t>(L, kBal, p, n, i);
    phase[p] = load<int32_t>(L, kPhase, p, n, i);
    own_val[p] = load<int32_t>(L, kOwnVal, p, n, i);
    prop_val[p] = load<int32_t>(L, kPropVal, p, n, i);
    heard[p] = load<int32_t>(L, kHeard, p, n, i);
    best_bal[p] = load<int32_t>(L, kBestBal, p, n, i);
    timer[p] = load<int32_t>(L, kTimer, p, n, i);
    decided_val[p] = load<int32_t>(L, kDecidedVal, p, n, i);
#pragma unroll
    for (int v = 0; v < P; ++v) rep_mask[p][v] = load<int32_t>(L, kRepMask, p * P + v, n, i);
  }
  Learner<K> lrn;
  lrn.load_from(L, n, i);
  MsgBufs<S> m;
  m.load_from(L, n, i);

  const int32_t tick0 = *tick_ptr;
  const uint32_t blk = static_cast<uint32_t>(prm.blk0) + static_cast<uint32_t>(i / prm.block);
  const uint32_t lane = static_cast<uint32_t>(i % prm.block);
  const auto quorum_of = [&](int32_t b) { return ballot_round(b) == 0 ? prm.q_fast : prm.q2; };

  DrawCount draws;
  for (int t = 0; t < prm.n_ticks; ++t) {
    const int32_t tick = wrap_add(tick0, t);
    const TickStream ts{mix32(prm.seed, static_cast<uint32_t>(tick), blk),
                        static_cast<uint32_t>(prm.block), lane, &draws};

    // ---- Reply delivery (pre-tick buffer) and consume. ----
    uint32_t rp_next;
    const uint32_t delivered = m.deliver(prm, ts, &rp_next);

    // ---- Proposer fold over the pre-tick replies. ----
    uint32_t p1_done = 0, expired = 0;
    int32_t old_bal[P];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int32_t cur = bal[p];
      int32_t h = heard[p];
      int32_t bb = best_bal[p];
#pragma unroll
      for (int a = 0; a < A; ++a) {
        const int j0 = (0 * P + p) * A + a;  // PROMISE slot
        const int j1 = (1 * P + p) * A + a;  // ACCEPTED slot
        const bool prom_ok = ((delivered >> j0) & 1u) && m.rp_bal[j0] == cur && phase[p] == kP1;
        const bool accd_ok = ((delivered >> j1) & 1u) && m.rp_bal[j1] == cur &&
                             (phase[p] == kP2 || phase[p] == kFast);
        if (prom_ok || accd_ok) h |= 1 << a;
        // Recovery fold: the PROMISE's prev-accepted (ballot, value).
        const int32_t pb = m.rp_v1[j0], pv = m.rp_v2[j0];
        const bool valid = prom_ok && pb > 0 && pv >= kValueBase && pv < kValueBase + P;
        if (valid && pb > bb) {
#pragma unroll
          for (int v = 0; v < P; ++v) rep_mask[p][v] = 0;
          bb = pb;
        }
        if (valid && pb == bb) {
#pragma unroll
          for (int v = 0; v < P; ++v)
            if (pv - kValueBase == v) rep_mask[p][v] |= 1 << a;
        }
      }

      const int votes = __popc(static_cast<uint32_t>(h));
      const bool fast_done = phase[p] == kFast && votes >= prm.q_fast;
      const bool p1 = phase[p] == kP1 && votes >= prm.q1;
      const bool p2 = phase[p] == kP2 && votes >= prm.q2;

      // Recovery value by the round kind of the highest reported ballot.
      const int unheard = A - votes;
      int pick_fast = 0, pick_classic = 0;
      bool any_ch = false, any_rep = false;
#pragma unroll
      for (int v = 0; v < P; ++v) {
        const int32_t r = rep_mask[p][v];
        const bool choosable = r != 0 && __popc(static_cast<uint32_t>(r)) + unheard >= prm.q_fast;
        if (choosable && !any_ch) {
          pick_fast = v;
          any_ch = true;
        }
        if (r != 0 && !any_rep) {
          pick_classic = v;
          any_rep = true;
        }
      }
      const int32_t v_fast = any_ch ? kValueBase + pick_fast : own_val[p];
      const int32_t v_recover =
          bb > 0 ? (ballot_round(bb) == 0 ? v_fast : kValueBase + pick_classic) : own_val[p];

      int32_t tm = phase[p] == kDone ? timer[p] : wrap_add(timer[p], 1);
      const bool exp = phase[p] != kDone && !p1 && !p2 && !fast_done && tm > prm.timeout;

      int32_t ph = phase[p];
      if (p1) ph = kP2;
      if (p2 || fast_done) ph = kDone;
      if (exp) ph = kP1;
      if (p2) decided_val[p] = prop_val[p];
      if (fast_done) decided_val[p] = own_val[p];
      const int32_t pv_new = p1 ? v_recover : prop_val[p];
      if (p1 || exp) h = 0;
      if (exp) {
        bb = 0;
#pragma unroll
        for (int v = 0; v < P; ++v) rep_mask[p][v] = 0;
      }
      if (p1) tm = 0;
      if (exp) {
        const uint32_t r = ts.bits(kBackoff, p) & 0x7FFFFFFFu;
        tm = -static_cast<int32_t>(r % static_cast<uint32_t>(prm.backoff_n));
      }
      old_bal[p] = cur;
      bal[p] = exp ? next_ballot(cur, prm.stride, p) : cur;
      phase[p] = ph;
      prop_val[p] = pv_new;
      heard[p] = h;
      best_bal[p] = bb;
      timer[p] = tm;
      p1_done |= (p1 ? 1u : 0u) << p;
      expired |= (exp ? 1u : 0u) << p;
    }

    // ---- Acceptor half-tick: select at most one request per acceptor. ----
    uint32_t rq_next = m.rq_present;
    uint32_t ev_flag = 0;
    int32_t ev_bal[A], ev_val[A];
    int inv_viol = 0;
#pragma unroll
    for (int a = 0; a < A; ++a) {
      const bool alive = !(crash_start[a] <= tick && tick < crash_end[a]);
      const bool busy = ts.survives_at(prm.idle, kBusy, a);
      const int win = m.template select<P, A>(ts, a);
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
      const int32_t pr_old = promised[a], ab_old = acc_bal[a], av_old = acc_val[a];
      const bool ok_prep_h = is_prep && !eq && mb > pr_old;
      const bool ok_prep = ok_prep_h || (is_prep && eq);
      // Vote at most once per ballot; the identical pair stays idempotent.
      const bool revote = mb > ab_old || (mb == ab_old && mv == av_old);
      const bool ok_acc_h = is_acc && !eq && mb >= pr_old && revote;
      const bool ok_acc = ok_acc_h || (is_acc && eq);

      int32_t pr = ok_prep_h ? mb : pr_old;
      if (ok_acc_h) pr = max(pr, mb);
      const int32_t ab = ok_acc ? mb : ab_old;
      const int32_t av = ok_acc ? mv : av_old;

      // Replies to the selected sender's slot (post-consume buffer).
#pragma unroll
      for (int p = 0; p < P; ++p) {
        if (sel == p && ok_prep && ts.survives_at(prm.drop, kKeepProm, p * A + a)) {
          const int jr = (0 * P + p) * A + a;
          m.rp_bal[jr] = mb;
          m.rp_v1[jr] = eq ? 0 : ab_old;
          m.rp_v2[jr] = eq ? 0 : av_old;
          rp_next |= 1u << jr;
        }
        if (sel == P + p && ok_acc && ts.survives_at(prm.drop, kKeepAccd, p * A + a)) {
          const int jr = (1 * P + p) * A + a;
          m.rp_bal[jr] = mb;
          m.rp_v1[jr] = mv;
          m.rp_v2[jr] = 0;
          rp_next |= 1u << jr;
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

    // ---- Learner: fast-quorum-aware thresholds per slot. ----
    lrn.template observe<A>(ev_flag, ev_bal, ev_val, tick, inv_viol, quorum_of);

    // ---- Proposer sends into the consumed request buffer. ----
#pragma unroll
    for (int p = 0; p < P; ++p) {
#pragma unroll
      for (int a = 0; a < A; ++a) {
        if (((p1_done >> p) & 1u) && ts.survives_at(prm.drop, kKeepP2, p * A + a)) {
          const int j = (1 * P + p) * A + a;  // ACCEPT(old ballot, recovery value)
          m.rq_bal[j] = old_bal[p];
          m.rq_v1[j] = prop_val[p];
          m.rq_v2[j] = 0;
          m.rq_present |= 1u << j;
        }
        if (((expired >> p) & 1u) && ts.survives_at(prm.drop, kKeepP1, p * A + a)) {
          const int j = (0 * P + p) * A + a;  // PREPARE(next ballot)
          m.rq_bal[j] = bal[p];
          m.rq_v1[j] = 0;
          m.rq_v2[j] = 0;
          m.rq_present |= 1u << j;
        }
      }
      if (prm.clamp_per_tick) bal[p] = min(bal[p], kBallotLimit);
    }
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
    store<int32_t>(L, kTimer, p, n, i, timer[p]);
    store<int32_t>(L, kDecidedVal, p, n, i, decided_val[p]);
#pragma unroll
    for (int v = 0; v < P; ++v) store<int32_t>(L, kRepMask, p * P + v, n, i, rep_mask[p][v]);
  }
  lrn.store_to(L, n, i);
  m.store_to(L, n, i);
}

template <int P, int A, int K>
cudaError_t launch(const Leaves& L, const Plan& plan, const int32_t* tick, const Params& prm,
                   cudaStream_t stream) {
  fused_fastpaxos_kernel<P, A, K><<<grid_for(prm.n_inst), kThreads, 0, stream>>>(L, plan, tick, prm);
  return cudaGetLastError();
}

}  // namespace

// C entry point, loaded with ctypes (arguments: read_args in
// fused_common.cuh; `dims` = n_prop, n_acc, k_slots); `tick` is the device int32 tick scalar, read by the
// kernel and advanced by the caller.  Returns the launch's
// cudaGetLastError().
extern "C" int fused_fastpaxos_launch(const int* dims, int n_dims, void** leaves, int n_leaves,
                                      void** plan, void* tick, const long long* params, int n_params,
                                      void* stream) {
  if (n_dims != 3) return cudaErrorInvalidValue;
  const int n_prop = dims[0], n_acc = dims[1], k_slots = dims[2];
  Leaves L;
  Plan pl;
  Params prm;
  const cudaError_t bad = read_args(leaves, n_leaves, kLeaves, plan, params, n_params, &L, &pl, &prm);
  if (bad != cudaSuccess) return bad;
  const auto* t = static_cast<const int32_t*>(tick);
  auto s = static_cast<cudaStream_t>(stream);
  if (n_prop == 2 && n_acc == 5 && k_slots == 8) return launch<2, 5, 8>(L, pl, t, prm, s);
  if (n_prop == 2 && n_acc == 3 && k_slots == 8) return launch<2, 3, 8>(L, pl, t, prm, s);
  return cudaErrorInvalidValue;
}
