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
// Design: one thread per instance (lane), as K1 to K3, but the state does
// not fit in registers (about 350 32-bit words at 8 slots, 570 at 16), so
// it is split by access pattern:
//  - in registers for the whole chunk: the per-lane scalars (promises,
//    the proposers' fields, the request buffer, the PROMISE ballots, the
//    ACCEPTED buffer, the chosen-slot bitmask and the counters);
//  - in global memory, read and written in place at [row * n_inst + lane]
//    (instance-minor, so a warp's accesses coalesce): the slot-indexed
//    arrays (acceptor log, PROMISE payloads, recovery arrays, the learner's
//    per-slot tables, chosen values and ticks).
// A slot array is touched only where the tick reads or writes it: a PROMISE
// payload when one is sent or delivered to a candidate, the learner rows of
// the slots this tick's accept events hit, the recovery row a leader
// proposes from.  The reference writes whole arrays every tick because a
// branch costs more than a masked write on the TPU; on this card a per-lane
// branch is cheap.
//
// Semantics follow the plain PyTorch version (protocols/multipaxos.py and
// check/mp_safety.py) exactly; the PRNG, stream positions and argument
// layout are in fused_common.cuh.
//  - masks are drawn lazily, where they can change the outcome (the
//    election jitter only when the lease timer sits inside the jitter's
//    range); the result is the same as drawing them all.  The measuring
//    build counts the draws and the slot-array elements each tick touches.
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

#include "fused_common.cuh"

namespace {

// Proposer phases (core/mp_state.py).
constexpr int32_t kFollow = 0, kCandidate = 1, kLead = 2;
constexpr int32_t kMpBallotLimit = (1 << 11) - 1;  // Multi-Paxos report-time limit
constexpr int kMpLeaves = 29;                      // per-lane state leaves
constexpr int32_t kValMask = 0xFFFF;               // bv_val of a packed pair

// Multi-Paxos stream ids (core/streams.py MULTI_PAXOS_STREAMS); SEL and
// BUSY share the single-decree ids.
constexpr uint32_t kMpDupReq = 2, kPromDeliver = 3, kAccdDeliver = 4, kMpKeepProm = 5,
                   kMpKeepAccd = 6, kKeepPrep = 7, kKeepAcc = 8, kJitter = 9, kMpBackoff = 10;

// The state leaves in the reference's flatten order, tick excluded.
struct Mp {
  enum Leaf : int {
    kPromised, kLog,
    kBal, kPhase, kHeard, kCommitIdx, kRecov, kLeaseTimer, kLastCount, kCandTimer,
    kLtBv, kLtMask, kChosen, kChosenVal, kChosenTick, kViolations, kEvictions,
    kRqBal, kRqV1, kRqV2, kRqPresent,
    kPromPresent, kPromBal, kPromBv,
    kAccdPresent, kAccdBal, kAccdSlot, kAccdVal,
    kBase,
  };
};

// Element (row, lane) of a state leaf in global memory.
template <typename T>
__device__ __forceinline__ T& at(const Leaves& L, int leaf, int row, int64_t n, int64_t i) {
  return reinterpret_cast<T*>(L.p[leaf])[row * n + i];
}

// pack_bv(bal, val) = bal << 16 | val, with the shift done unsigned.
__device__ __forceinline__ int32_t pack_bv(int32_t bal, int32_t val) {
  return static_cast<int32_t>((static_cast<uint32_t>(bal) << 16) | static_cast<uint32_t>(val));
}

template <int P, int A, int LOG, int K>
__global__ void __launch_bounds__(kThreads)
fused_multipaxos_kernel(Leaves L, Plan plan, const int32_t* __restrict__ tick_ptr, Params prm) {
  constexpr int S = 2 * P * A;  // request slots, index (kind * P + p) * A + a
  constexpr int E = P * A;      // reply slots, index p * A + a
  constexpr int kQuorum = A / 2 + 1;
  static_assert(S <= 32 && LOG <= 32 && K <= 32, "bitmasks must fit 32 bits");

  const int64_t n = prm.n_inst;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;

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

  const int32_t tick0 = *tick_ptr;
  const uint32_t blk = static_cast<uint32_t>(prm.blk0) + static_cast<uint32_t>(i / prm.block);
  const uint32_t lane = static_cast<uint32_t>(i % prm.block);

  DrawCount draws;
  for (int t = 0; t < prm.n_ticks; ++t) {
    const int32_t tick = wrap_add(tick0, t);
    const TickStream ts{mix32(prm.seed, static_cast<uint32_t>(tick), blk),
                        static_cast<uint32_t>(prm.block), lane, &draws};

    // ---- Reply delivery decided and cleared before any new send. ----
    uint32_t prom_del = prom_present, accd_del = accd_present;
    if (prm.hold.mode != 0) {
#pragma unroll
      for (int j = 0; j < E; ++j) {
        if (((prom_del >> j) & 1u) && ts.fires_at(prm.hold, kPromDeliver, j)) prom_del &= ~(1u << j);
        if (((accd_del >> j) & 1u) && ts.fires_at(prm.hold, kAccdDeliver, j)) accd_del &= ~(1u << j);
      }
    }
    prom_present &= ~prom_del;
    accd_present &= ~accd_del;

    // ---- Proposer folds over the pre-tick replies: voter bits, and the
    //      candidates' per-slot max over the PROMISE payloads. ----
#pragma unroll
    for (int p = 0; p < P; ++p) {
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
#pragma unroll
        for (int l = 0; l < LOG; ++l) {
          int32_t r = at<int32_t>(L, Mp::kRecov, p * LOG + l, n, i);
#pragma unroll
          for (int a = 0; a < A; ++a)
            if ((pv >> a) & 1u) r = max(r, at<int32_t>(L, Mp::kPromBv, (p * A + a) * LOG + l, n, i));
          at<int32_t>(L, Mp::kRecov, p * LOG + l, n, i) = r;
        }
      }
    }

    // ---- Acceptor half-tick: at most one request per acceptor. ----
    uint32_t rq_next = rq_present, ev_flag = 0;
    int32_t ev_bal[A], ev_slot[A], ev_val[A];
#pragma unroll
    for (int a = 0; a < A; ++a) {
      const bool alive = !(crash_start[a] <= tick && tick < crash_end[a]);
      int sel = -1;
      if (alive && ts.survives_at(prm.idle, kBusy, a)) sel = select_request<P, A>(ts, rq_present, a);
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
      const bool eq = (equiv >> a) & 1u;
      const bool ok_prep_h = is_prep && !eq && mb > promised[a];
      const bool ok_prep = ok_prep_h || (is_prep && eq);
      const bool ok_acc_h = is_acc && !eq && mb >= promised[a];
      const bool ok_acc = ok_acc_h || (is_acc && eq);
      int32_t pr = ok_prep_h ? mb : promised[a];
      if (ok_acc_h) pr = max(pr, mb);

      // Replies to the selected sender (post-consume buffers).  A PROMISE
      // carries the log before any accept write: an acceptor that takes a
      // PREPARE this tick writes no log slot.
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const int j = p * A + a;
        if (sel == p && ok_prep && ts.survives_at(prm.drop, kMpKeepProm, j)) {
          prom_present |= 1u << j;
          prom_bal[j] = mb;
          draws.touch(eq ? LOG : 2 * LOG);  // the payload, and the log it copies
#pragma unroll
          for (int l = 0; l < LOG; ++l)
            at<int32_t>(L, Mp::kPromBv, j * LOG + l, n, i) =
                eq ? 0 : at<int32_t>(L, Mp::kLog, a * LOG + l, n, i);
        }
        if (sel == P + p && ok_acc && ts.survives_at(prm.drop, kMpKeepAccd, j)) {
          accd_present |= 1u << j;
          accd_bal[j] = mb;
          accd_slot[j] = ms;
          accd_val[j] = mv;
        }
      }
      if (ok_acc && ms >= 0 && ms < LOG) {
        at<int32_t>(L, Mp::kLog, a * LOG + ms, n, i) = pack_bv(mb, mv);
        draws.touch(1);
      }
      // Consume the selected request unless it is duplicated.
      if (sel >= 0) {
        const int j = sel * A + a;
        if (!(prm.dup.mode != 0 && ts.fires_at(prm.dup, kMpDupReq, j))) rq_next &= ~(1u << j);
      }
      promised[a] = pr;
      ev_flag |= (ok_acc ? 1u : 0u) << a;
      ev_bal[a] = mb;
      ev_slot[a] = ms;
      ev_val[a] = mv;
    }
    rq_present = rq_next;

    // ---- Learner: fold the accept events into the per-slot tables. ----
    // The events that reach the fold: in the window, with a ballot, and
    // not re-confirming the slot's (pre-tick) chosen value.
    uint32_t fold = 0;
#pragma unroll
    for (int a = 0; a < A; ++a) {
      const int32_t s = ev_slot[a];
      if (!(((ev_flag >> a) & 1u) && ev_bal[a] > 0 && s >= 0 && s < LOG)) continue;
      if ((chosen >> s) & 1u) {
        draws.touch(1);
        if (ev_val[a] == at<int32_t>(L, Mp::kChosenVal, s, n, i)) continue;
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
#pragma unroll
      for (int k = 0; k < K; ++k) {
        rbv[k] = at<int32_t>(L, Mp::kLtBv, s * K + k, n, i);
        rmask[k] = at<int32_t>(L, Mp::kLtMask, s * K + k, n, i);
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
      uint32_t newly = 0;
      int32_t first_val = 0;
#pragma unroll
      for (int k = K - 1; k >= 0; --k) {
        if (__popc(static_cast<uint32_t>(rmask[k])) >= kQuorum && !((pre >> k) & 1u)) {
          newly |= 1u << k;
          first_val = rbv[k] & kValMask;
        }
        at<int32_t>(L, Mp::kLtBv, s * K + k, n, i) = rbv[k];
        at<int32_t>(L, Mp::kLtMask, s * K + k, n, i) = rmask[k];
      }
      if (newly != 0) {
        int32_t cv = first_val;
        if ((chosen >> s) & 1u) {
          cv = at<int32_t>(L, Mp::kChosenVal, s, n, i);
          draws.touch(1);
        } else {
          draws.touch(2);
          chosen |= 1u << s;
          at<int32_t>(L, Mp::kChosenVal, s, n, i) = first_val;
          at<int32_t>(L, Mp::kChosenTick, s, n, i) = tick;
        }
#pragma unroll
        for (int k = 0; k < K; ++k)
          if (((newly >> k) & 1u) && (rbv[k] & kValMask) != cv) ++viol;
      }
    }
    violations = wrap_add(violations, viol);
    const int32_t chosen_count = __popc(chosen);

    // ---- Proposer half-tick. ----
    const bool log_full = chosen_count >= LOG ||
                          (prm.log_total != 0 && wrap_add(base, chosen_count) >= prm.log_total);
#pragma unroll
    for (int p = 0; p < P; ++p) {
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
          const uint32_t r = ts.bits(kJitter, p) & 0x7FFFFFFFu;
          start_elec = lt > thr + static_cast<int32_t>(r % static_cast<uint32_t>(prm.backoff_n));
        }
      }
      const int32_t ct = ph == kCandidate ? wrap_add(cand_timer[p], 1) : 0;
      const bool cand_fail = ph == kCandidate && ct > prm.timeout && !p1_done;
      const bool demote = ph == kLead && lease_out && !slot_done && !log_full;

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
#pragma unroll
        for (int l = 0; l < LOG; ++l) at<int32_t>(L, Mp::kRecov, p * LOG + l, n, i) = 0;
      }
      if (start_elec || p1_done || slot_done) lt = 0;
      if (cand_fail || demote) {
        // Retreat below the election threshold (the timer may go negative).
        const uint32_t r = ts.bits(kMpBackoff, p) & 0x7FFFFFFFu;
        lt = prm.lease_len - static_cast<int32_t>(r % static_cast<uint32_t>(2 * prm.backoff_n));
      }

      // New candidates broadcast Prepare(b) once.
      if (start_elec) {
#pragma unroll
        for (int a = 0; a < A; ++a) {
          if (ts.survives_at(prm.drop, kKeepPrep, p * A + a)) {
            const int j = (0 * P + p) * A + a;
            rq_bal[j] = bal_next;
            rq_v1[j] = 0;
            rq_v2[j] = 0;
            rq_present |= 1u << j;
          }
        }
      }
      // Leaders re-broadcast the current slot's Accept every tick, never
      // past the global log end.
      const bool is_lead = nph == kLead && p_alive && ci < LOG &&
                           (prm.log_total == 0 || wrap_add(base, ci) < prm.log_total);
      if (is_lead) {
        const int32_t slot = min(ci, LOG - 1);
        const int32_t rbv = slot >= 0 ? at<int32_t>(L, Mp::kRecov, p * LOG + slot, n, i) : 0;
        draws.touch(slot >= 0 ? 1 : 0);
        // Commands are keyed by global slot: own_slot_value(pid, base + slot).
        const int32_t pval = rbv > 0 ? (rbv & kValMask) : (p + 1) * 1000 + wrap_add(base, slot);
#pragma unroll
        for (int a = 0; a < A; ++a) {
          if (ts.survives_at(prm.drop, kKeepAcc, p * A + a)) {
            const int j = (1 * P + p) * A + a;
            rq_bal[j] = bal_next;
            rq_v1[j] = pval;
            rq_v2[j] = slot;
            rq_present |= 1u << j;
          }
        }
      }
      bal[p] = prm.clamp_per_tick ? min(bal_next, kMpBallotLimit) : bal_next;
      phase[p] = nph;
      commit_idx[p] = ci;
      lease_timer[p] = lt;
      cand_timer[p] = start_elec ? 0 : ct;
    }
  }

  draws.flush();

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
}

template <int P, int A, int LOG, int K>
cudaError_t launch(const Leaves& L, const Plan& plan, const int32_t* tick, const Params& prm,
                   cudaStream_t stream) {
  fused_multipaxos_kernel<P, A, LOG, K>
      <<<grid_for(prm.n_inst), kThreads, 0, stream>>>(L, plan, tick, prm);
  return cudaGetLastError();
}

}  // namespace

// C entry point, loaded with ctypes (arguments: read_args in
// fused_common.cuh; `dims` = n_prop, n_acc, log_len, k_slots); `tick` is
// the device int32 tick scalar, read by the kernel and advanced by the
// caller.  Returns the launch's cudaGetLastError().
extern "C" int fused_multipaxos_launch(const int* dims, int n_dims, void** leaves, int n_leaves,
                                       void** plan, void* tick, const long long* params,
                                       int n_params, void* stream) {
  if (n_dims != 4) return cudaErrorInvalidValue;
  const int n_prop = dims[0], n_acc = dims[1], log_len = dims[2], k_slots = dims[3];
  Leaves L;
  Plan pl;
  Params prm;
  const cudaError_t bad =
      read_args(leaves, n_leaves, kMpLeaves, plan, params, n_params, &L, &pl, &prm);
  if (bad != cudaSuccess) return bad;
  const auto* t = static_cast<const int32_t*>(tick);
  auto s = static_cast<cudaStream_t>(stream);
  if (n_prop == 2 && n_acc == 5 && k_slots == 4) {
    if (log_len == 8) return launch<2, 5, 8, 4>(L, pl, t, prm, s);
    if (log_len == 16) return launch<2, 5, 16, 4>(L, pl, t, prm, s);
    if (log_len == 4) return launch<2, 5, 4, 4>(L, pl, t, prm, s);
  }
  if (n_prop == 2 && n_acc == 3 && log_len == 8 && k_slots == 4)
    return launch<2, 3, 8, 4>(L, pl, t, prm, s);
  return cudaErrorInvalidValue;
}
