// Fused Raft-core engine for Hopper (sm_90a): n_ticks ticks of
// counter_masks + apply_tick_raft for every instance in one launch.
//
// Replaces: paxos_tpu/kernels/fused_tick.py::_kernel bound to the
// Raft-core tick (fused_fns("raftcore"), launched by fused_chunk through
// pl.pallas_call), the Pallas kernel that keeps a block of instances'
// state resident in VMEM for a whole chunk.
//
// Design: K1's (fused_paxos_tick.cu).  One thread per lane loads the lane's
// state into registers once, runs all n_ticks ticks and stores once, in
// place; the PRNG, reply delivery, request selection and the learner table
// are the shared helpers of fused_common.cuh.
//
// Bound on this card: ~765 B/lane of state moved twice per chunk against a
// few thousand int32 operations per lane-tick, so at 64 ticks per chunk it
// is bound by integer operations, not bytes.  The leader's APPEND
// re-broadcast draws A drop masks per leader per tick, which K1 draws only
// on a phase change.
//
// What differs from the Paxos tick (protocols/raftcore.py), with the
// message roles REQVOTE/APPEND (requests) and VOTE/ACK (replies):
//  - voters grant a vote only to a term above their vote fence and to a
//    candidate whose entry term is at least their own (the election
//    restriction); appends raise the fence;
//  - every REQVOTE is answered, grant or denial, with v1 = 2 * entry term
//    + granted, a non-negative payload, so the candidate's // 2 and % 2
//    are a shift and a mask;
//  - a candidate adopts the highest-term entry it hears (value by a max);
//    a leader re-sends APPEND to every voter on every tick while LEAD;
//    REQVOTE carries the candidate's entry term;
//  - every quorum is the majority, and the learner counts appends.

#include "fused_common.cuh"

namespace {

// Candidate phases (core/raft_state.py).
constexpr int32_t kCand = 0, kLead = 1, kDone = 2;
// Message kinds: REQVOTE/VOTE = 0, APPEND/ACK = 1.
constexpr int kReqVote = 0, kAppend = 1, kVote = 0, kAck = 1;

// The role leaves in the reference's flatten order; the learner and the
// message buffers follow (SharedLeaf).
enum Leaf {
  kVoted, kEntTerm, kEntVal,
  kBal, kPhase, kOwnVal, kPropVal, kHeard, kCandEntTerm, kCandEntVal, kTimer,
  kDecidedVal,
};

template <int P, int A, int K>
__global__ void __launch_bounds__(kThreads)
fused_raftcore_kernel(Leaves L, Plan plan, const int32_t* __restrict__ tick_ptr, Params prm) {
  constexpr int S = 2 * P * A;  // message slots per buffer, index (kind*P + p)*A + a
  constexpr int kQuorum = A / 2 + 1;

  const int64_t n = prm.n_inst;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;

  // ---- Load the lane's state once. ----
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
  Learner<K> lrn;
  lrn.load_from(L, n, i);
  MsgBufs<S> m;
  m.load_from(L, n, i);

  const int32_t tick0 = *tick_ptr;
  const uint32_t blk = static_cast<uint32_t>(prm.blk0) + static_cast<uint32_t>(i / prm.block);
  const uint32_t lane = static_cast<uint32_t>(i % prm.block);
  const auto quorum_of = [](int32_t) { return kQuorum; };

  DrawCount draws;
  for (int t = 0; t < prm.n_ticks; ++t) {
    const int32_t tick = wrap_add(tick0, t);
    const TickStream ts{mix32(prm.seed, static_cast<uint32_t>(tick), blk),
                        static_cast<uint32_t>(prm.block), lane, &draws};

    // ---- Reply delivery (pre-tick buffer) and consume. ----
    uint32_t rp_next;
    const uint32_t delivered = m.deliver(prm, ts, &rp_next);

    // ---- Candidate fold over the pre-tick replies. ----
    uint32_t leading = 0, expired = 0;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int32_t cur = bal[p];
      int32_t h = heard[p];
      uint32_t vote_ok = 0;
      int32_t rep_t[A];
      int32_t cand_t = kInt32Min;
#pragma unroll
      for (int a = 0; a < A; ++a) {
        const int j0 = (kVote * P + p) * A + a;
        const int j1 = (kAck * P + p) * A + a;
        const bool v_ok = ((delivered >> j0) & 1u) && m.rp_bal[j0] == cur && phase[p] == kCand;
        const bool granted = v_ok && (m.rp_v1[j0] & 1) == 1;
        const bool ack_ok = ((delivered >> j1) & 1u) && m.rp_bal[j1] == cur && phase[p] == kLead;
        if (granted || ack_ok) h |= 1 << a;
        vote_ok |= (v_ok ? 1u : 0u) << a;
        rep_t[a] = v_ok ? (m.rp_v1[j0] >> 1) : 0;  // floor division by 2
        cand_t = max(cand_t, rep_t[a]);
      }
      int32_t cand_v = kInt32Min;
#pragma unroll
      for (int a = 0; a < A; ++a) {
        const bool top = rep_t[a] == cand_t && ((vote_ok >> a) & 1u);
        cand_v = max(cand_v, top ? m.rp_v2[(kVote * P + p) * A + a] : 0);
      }
      const bool upgrade = cand_t > c_term[p];
      int32_t et = upgrade ? cand_t : c_term[p];
      int32_t ev = upgrade ? cand_v : c_val[p];

      const int votes = __popc(static_cast<uint32_t>(h));
      const bool elected = phase[p] == kCand && votes >= kQuorum;
      const bool committed = phase[p] == kLead && votes >= kQuorum;
      int32_t tm = phase[p] == kDone ? timer[p] : wrap_add(timer[p], 1);
      const bool exp = phase[p] != kDone && !elected && !committed && tm > prm.timeout;

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
        const uint32_t r = ts.bits(kBackoff, p) & 0x7FFFFFFFu;
        tm = -static_cast<int32_t>(r % static_cast<uint32_t>(prm.backoff_n));
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

    // ---- Voter half-tick: select at most one request per voter. ----
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
      const bool is_rv = sel >= 0 && sel < P;
      const bool is_ap = sel >= P;
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

      // Replies to the selected sender's slot (post-consume buffer): every
      // REQVOTE is answered with the pre-update entry; accepted APPENDs
      // are acknowledged.
#pragma unroll
      for (int p = 0; p < P; ++p) {
        if (sel == kReqVote * P + p && ts.survives_at(prm.drop, kKeepProm, p * A + a)) {
          const int jr = (kVote * P + p) * A + a;
          m.rp_bal[jr] = mb;
          m.rp_v1[jr] = wrap_add(static_cast<int32_t>(static_cast<uint32_t>(eq ? 0 : et_old) * 2u),
                                 grant ? 1 : 0);
          m.rp_v2[jr] = eq ? 0 : ev_old;
          rp_next |= 1u << jr;
        }
        if (sel == kAppend * P + p && ok_ap && ts.survives_at(prm.drop, kKeepAccd, p * A + a)) {
          const int jr = (kAck * P + p) * A + a;
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
    m.rp_present = rp_next;
    m.rq_present = rq_next;

    // ---- Learner: append-accept events, majority commit. ----
    lrn.template observe<A>(ev_flag, ev_bal, ev_val, tick, inv_viol, quorum_of);

    // ---- Candidate sends into the consumed request buffer. ----
#pragma unroll
    for (int p = 0; p < P; ++p) {
#pragma unroll
      for (int a = 0; a < A; ++a) {
        if (((leading >> p) & 1u) && ts.survives_at(prm.drop, kKeepP2, p * A + a)) {
          const int j = (kAppend * P + p) * A + a;  // APPEND(term, value), every tick
          m.rq_bal[j] = bal[p];
          m.rq_v1[j] = prop_val[p];
          m.rq_v2[j] = 0;
          m.rq_present |= 1u << j;
        }
        if (((expired >> p) & 1u) && ts.survives_at(prm.drop, kKeepP1, p * A + a)) {
          const int j = (kReqVote * P + p) * A + a;  // REQVOTE(next term, entry term)
          m.rq_bal[j] = bal[p];
          m.rq_v1[j] = c_term[p];
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
  m.store_to(L, n, i);
}

template <int P, int A, int K>
cudaError_t launch(const Leaves& L, const Plan& plan, const int32_t* tick, const Params& prm,
                   cudaStream_t stream) {
  fused_raftcore_kernel<P, A, K><<<grid_for(prm.n_inst), kThreads, 0, stream>>>(L, plan, tick, prm);
  return cudaGetLastError();
}

}  // namespace

// C entry point, loaded with ctypes (arguments: read_args in
// fused_common.cuh; `dims` = n_prop, n_acc, k_slots); `tick` is the device int32 tick scalar, read by the
// kernel and advanced by the caller.  Returns the launch's
// cudaGetLastError().
extern "C" int fused_raftcore_launch(const int* dims, int n_dims, void** leaves, int n_leaves,
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
