// Fused single-decree Paxos engine for Hopper (sm_90a): n_ticks ticks of
// counter_masks + apply_tick for every instance in one launch.
//
// Replaces: paxos_tpu/kernels/fused_tick.py::_kernel bound to the paxos
// tick (packed_fns("paxos")), the Pallas kernel that keeps a block of
// instances' state resident in VMEM for a whole chunk.
//
// Design: one thread per instance (lane).  Every reduction of a tick stays
// inside one lane (the reference's lane-independence theorem,
// analysis/flow.py), so a thread loads its lane's state once into
// registers, runs all n_ticks ticks, and stores once.  Every array is
// instance-minor, so the loads and stores of a warp are coalesced.  The
// state is updated in place: the counterpart of the reference's buffer
// donation (the caller's input state is consumed).
//
// Bound on this card: per chunk the kernel must move each state byte twice
// (~765 B/lane unpacked, about 0.5 ms per 1<<20 lanes at 3.35 TB/s) but it
// executes a few thousand int32 operations per lane-tick, so at 64 ticks
// per chunk it is bound by integer operations, not bytes.  This first
// version keeps the state unpacked (~190 live 32-bit values per thread),
// which spills; packing the state into the reference's 32-bit words and
// tuning occupancy are later work.
//
// Semantics follow the plain PyTorch version (protocols/paxos.py) exactly:
//  - random bits are uint32 (wrapping mul/add, logical shifts); Bernoulli
//    masks are unsigned compares against host-rounded thresholds;
//  - lane i draws from stream seed mix(seed, tick, blk0 + i / block), and a
//    mask element (prefix..., i) hashes position prefix * block + i % block,
//    where `block` is the stream block (not the CUDA block size);
//  - masks that a tick only ANDs in are drawn lazily, where they can change
//    the outcome; the result is the same as drawing them all.
//  - reply delivery and consume precede the acceptor's new replies;
//    proposers fold the pre-tick reply payloads; requests are consumed
//    before the proposers send; ACCEPT carries the old ballot, PREPARE the
//    next one; chosen_tick is the pre-increment tick.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kLeaves = 28;
constexpr int kParams = 19;
constexpr int kThreads = 128;
constexpr int32_t kInt32Min = -2147483647 - 1;
constexpr int32_t kBallotLimit = (1 << 15) - 1;  // report-time ballot limit
constexpr int kMaxProposers = 8;                 // core/ballot.py

// Proposer phases (core/state.py).
constexpr int32_t kP1 = 0, kP2 = 1, kDone = 2;

// Stream ids (core/streams.py).
constexpr uint32_t kSel = 0, kBusy = 1, kDeliver = 2, kDupReq = 3,
                   kDupRep = 4, kKeepProm = 5, kKeepAccd = 6, kKeepP1 = 7,
                   kKeepP2 = 8, kBackoff = 9;

// State leaves in the reference's flatten order (tick excluded).
enum Leaf {
  kPromised, kAccBal, kAccVal,
  kBal, kPhase, kOwnVal, kPropVal, kHeard, kBestBal, kBestVal, kTimer,
  kDecidedVal,
  kLtBal, kLtVal, kLtMask, kChosen, kChosenVal, kChosenTick, kViolations,
  kEvictions,
  kRqBal, kRqV1, kRqV2, kRqPresent,
  kRpBal, kRpV1, kRpV2, kRpPresent,
};

struct Leaves {
  void* p[kLeaves];
};

struct Plan {
  const int32_t* crash_start;  // (A, I)
  const int32_t* crash_end;    // (A, I)
  const uint8_t* equivocate;   // (A, I) bool
};

// A Bernoulli knob: mode 0 = off (mask absent), 1 = draw against thr,
// 2 = p >= 1 (always fires).
struct Knob {
  int32_t mode;
  uint32_t thr;
};

struct Params {
  int64_t n_inst;
  int32_t block;  // stream block: lanes per counter-PRNG block id
  int32_t n_ticks;
  uint32_t seed;
  int32_t blk0;
  int32_t clamp_per_tick;
  int32_t timeout;
  int32_t backoff_n;
  int32_t stride;
  int32_t q1, q2;
  Knob idle, hold, dup, drop;
};

__host__ __device__ constexpr int bit_length(int x) {
  return x <= 0 ? 0 : 1 + bit_length(x >> 1);
}

__device__ __forceinline__ int32_t wrap_add(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) + static_cast<uint32_t>(b));
}

__device__ __forceinline__ uint32_t mix32(uint32_t seed, uint32_t tick, uint32_t blk) {
  uint32_t h = seed * 0x9E3779B1u + tick * 0x85EBCA77u + blk * 0xC2B2AE3Du + 0x165667B1u;
  h ^= h >> 16;
  h *= 0x7FEB352Du;
  h ^= h >> 15;
  return h;
}

__device__ __forceinline__ uint32_t counter_bits(uint32_t seed, uint32_t stream, uint32_t pos) {
  uint32_t x = pos + 0x9E3779B9u * (stream + 1u);
  x ^= seed * 0x85EBCA6Bu;
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

// bern(p) for a knob that is on: True w.p. p.
__device__ __forceinline__ bool fires(const Knob& k, uint32_t seed, uint32_t stream, uint32_t pos) {
  return k.mode == 2 || counter_bits(seed, stream, pos) < k.thr;
}

// bern_not(p): True w.p. 1 - p, all True when the knob is off.
__device__ __forceinline__ bool survives(const Knob& k, uint32_t seed, uint32_t stream, uint32_t pos) {
  return k.mode == 0 || !fires(k, seed, stream, pos);
}

template <typename T>
__device__ __forceinline__ T load(const Leaves& L, int leaf, int row, int64_t n, int64_t i) {
  return reinterpret_cast<const T*>(L.p[leaf])[row * n + i];
}

template <typename T>
__device__ __forceinline__ void store(const Leaves& L, int leaf, int row, int64_t n, int64_t i, T v) {
  reinterpret_cast<T*>(L.p[leaf])[row * n + i] = v;
}

template <int P, int A, int K>
__global__ void __launch_bounds__(kThreads)
fused_paxos_kernel(Leaves L, Plan plan, const int32_t* __restrict__ tick_ptr, Params prm) {
  constexpr int S = 2 * P * A;  // message slots per buffer, index (kind*P + p)*A + a
  static_assert(S <= 32, "slot presence must fit one 32-bit mask");
  constexpr int kNbits = bit_length(2 * P - 1) > 1 ? bit_length(2 * P - 1) : 1;
  constexpr int32_t kScoreMask = ~((1 << kNbits) - 1);

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
  int32_t lt_bal[K], lt_val[K], lt_mask[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    lt_bal[k] = load<int32_t>(L, kLtBal, k, n, i);
    lt_val[k] = load<int32_t>(L, kLtVal, k, n, i);
    lt_mask[k] = load<int32_t>(L, kLtMask, k, n, i);
  }
  bool chosen = load<uint8_t>(L, kChosen, 0, n, i) != 0;
  int32_t chosen_val = load<int32_t>(L, kChosenVal, 0, n, i);
  int32_t chosen_tick = load<int32_t>(L, kChosenTick, 0, n, i);
  int32_t violations = load<int32_t>(L, kViolations, 0, n, i);
  int32_t evictions = load<int32_t>(L, kEvictions, 0, n, i);
  int32_t rq_bal[S], rq_v1[S], rq_v2[S], rp_bal[S], rp_v1[S], rp_v2[S];
  uint32_t rq_present = 0, rp_present = 0;
#pragma unroll
  for (int j = 0; j < S; ++j) {
    rq_bal[j] = load<int32_t>(L, kRqBal, j, n, i);
    rq_v1[j] = load<int32_t>(L, kRqV1, j, n, i);
    rq_v2[j] = load<int32_t>(L, kRqV2, j, n, i);
    rq_present |= (load<uint8_t>(L, kRqPresent, j, n, i) != 0 ? 1u : 0u) << j;
    rp_bal[j] = load<int32_t>(L, kRpBal, j, n, i);
    rp_v1[j] = load<int32_t>(L, kRpV1, j, n, i);
    rp_v2[j] = load<int32_t>(L, kRpV2, j, n, i);
    rp_present |= (load<uint8_t>(L, kRpPresent, j, n, i) != 0 ? 1u : 0u) << j;
  }

  const int32_t tick0 = *tick_ptr;
  const uint32_t B = static_cast<uint32_t>(prm.block);
  const uint32_t li = static_cast<uint32_t>(i % prm.block);
  const uint32_t blk = static_cast<uint32_t>(prm.blk0) + static_cast<uint32_t>(i / prm.block);

  for (int t = 0; t < prm.n_ticks; ++t) {
    const int32_t tick = wrap_add(tick0, t);
    const uint32_t s = mix32(prm.seed, static_cast<uint32_t>(tick), blk);
    auto pos = [&](int prefix) { return static_cast<uint32_t>(prefix) * B + li; };

    // ---- Reply delivery (pre-tick buffer) and consume. ----
    uint32_t delivered = rp_present;
    if (prm.hold.mode != 0) {
#pragma unroll
      for (int j = 0; j < S; ++j)
        if (((delivered >> j) & 1u) && fires(prm.hold, s, kDeliver, pos(j)))
          delivered &= ~(1u << j);
    }
    uint32_t rp_taken = delivered;
    if (prm.dup.mode != 0) {
#pragma unroll
      for (int j = 0; j < S; ++j)
        if (((rp_taken >> j) & 1u) && fires(prm.dup, s, kDupRep, pos(j)))
          rp_taken &= ~(1u << j);
    }
    uint32_t rp_next = rp_present & ~rp_taken;

    // ---- Proposer fold over the pre-tick replies. ----
    uint32_t p1_done = 0, expired = 0;
    int32_t old_bal[P];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int32_t cur = bal[p];
      int32_t h = heard[p];
      int32_t prev[A];
      int32_t cand_bal = kInt32Min;
#pragma unroll
      for (int a = 0; a < A; ++a) {
        const int j0 = (0 * P + p) * A + a;  // PROMISE slot
        const int j1 = (1 * P + p) * A + a;  // ACCEPTED slot
        const bool prom_ok = ((delivered >> j0) & 1u) && rp_bal[j0] == cur && phase[p] == kP1;
        const bool accd_ok = ((delivered >> j1) & 1u) && rp_bal[j1] == cur && phase[p] == kP2;
        if (prom_ok || accd_ok) h |= 1 << a;
        prev[a] = prom_ok ? rp_v1[j0] : 0;
        cand_bal = max(cand_bal, prev[a]);
      }
      int32_t cand_val = kInt32Min;
#pragma unroll
      for (int a = 0; a < A; ++a)
        cand_val = max(cand_val, prev[a] == cand_bal ? rp_v2[(0 * P + p) * A + a] : 0);
      const bool upgrade = cand_bal > best_bal[p];
      int32_t bb = upgrade ? cand_bal : best_bal[p];
      int32_t bv = upgrade ? cand_val : best_val[p];

      const int votes = __popc(static_cast<uint32_t>(h));
      const bool p1 = phase[p] == kP1 && votes >= prm.q1;
      const bool p2 = phase[p] == kP2 && votes >= prm.q2;
      const int32_t v_by_p1 = bb > 0 ? bv : own_val[p];
      int32_t tm = phase[p] == kDone ? timer[p] : wrap_add(timer[p], 1);
      const bool exp = phase[p] != kDone && !p1 && !p2 && tm > prm.timeout;
      // ballot_round floors: (bal - 1) >> 3 is the floor division by 8.
      const int32_t rnd = (cur - 1) >> 3;
      const int32_t next_bal = wrap_add(
          static_cast<int32_t>(static_cast<uint32_t>(wrap_add(rnd, prm.stride)) * kMaxProposers),
          p + 1);

      int32_t ph = phase[p];
      if (p1) ph = kP2;
      if (p2) ph = kDone;
      if (exp) ph = kP1;
      const int32_t pv = p1 ? v_by_p1 : prop_val[p];
      if (p2) decided_val[p] = prop_val[p];
      if (p1 || exp) h = 0;
      if (exp) {
        bb = 0;
        bv = 0;
      }
      if (p1) tm = 0;
      if (exp) {
        const uint32_t r = counter_bits(s, kBackoff, pos(p)) & 0x7FFFFFFFu;
        tm = -static_cast<int32_t>(r % static_cast<uint32_t>(prm.backoff_n));
      }
      old_bal[p] = cur;
      bal[p] = exp ? next_bal : cur;
      phase[p] = ph;
      prop_val[p] = pv;
      heard[p] = h;
      best_bal[p] = bb;
      best_val[p] = bv;
      timer[p] = tm;
      p1_done |= (p1 ? 1u : 0u) << p;
      expired |= (exp ? 1u : 0u) << p;
    }

    // ---- Acceptor half-tick: select at most one request per acceptor. ----
    uint32_t rq_next = rq_present;
    uint32_t ev_flag = 0;
    int32_t ev_bal[A], ev_val[A];
    int inv_viol = 0;
#pragma unroll
    for (int a = 0; a < A; ++a) {
      const bool alive = !(crash_start[a] <= tick && tick < crash_end[a]);
      const bool busy = survives(prm.idle, s, kBusy, pos(a));
      int32_t fmax = kInt32Min;
      int win = -1;
#pragma unroll
      for (int kp = 0; kp < 2 * P; ++kp) {
        const int j = kp * A + a;
        if ((rq_present >> j) & 1u) {
          const int32_t score =
              (static_cast<int32_t>(counter_bits(s, kSel, pos(j))) & kScoreMask) | kp;
          if (score > fmax) {
            fmax = score;
            win = kp;
          }
        }
      }
      const int sel = (win >= 0 && busy && alive) ? win : -1;

      int32_t mb = 0, mv = 0;
#pragma unroll
      for (int kp = 0; kp < 2 * P; ++kp) {
        if (kp == sel) {
          mb = rq_bal[kp * A + a];
          mv = rq_v1[kp * A + a];
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

      // Replies to the selected sender's slot (post-consume buffer).
#pragma unroll
      for (int p = 0; p < P; ++p) {
        if (sel == p && ok_prep && survives(prm.drop, s, kKeepProm, pos(p * A + a))) {
          const int jr = (0 * P + p) * A + a;
          rp_bal[jr] = mb;
          rp_v1[jr] = eq ? 0 : ab_old;
          rp_v2[jr] = eq ? 0 : av_old;
          rp_next |= 1u << jr;
        }
        if (sel == P + p && ok_acc && survives(prm.drop, s, kKeepAccd, pos(p * A + a))) {
          const int jr = (1 * P + p) * A + a;
          rp_bal[jr] = mb;
          rp_v1[jr] = mv;
          rp_v2[jr] = 0;
          rp_next |= 1u << jr;
        }
      }
      // Consume the selected request unless it is duplicated.
      if (sel >= 0) {
        const int j = sel * A + a;
        if (!(prm.dup.mode != 0 && fires(prm.dup, s, kDupReq, pos(j)))) rq_next &= ~(1u << j);
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
    rp_present = rp_next;
    rq_present = rq_next;

    // ---- Learner: fold accept events into the (ballot, value) table. ----
    uint32_t pre_chosen = 0;
#pragma unroll
    for (int k = 0; k < K; ++k)
      pre_chosen |= (__popc(static_cast<uint32_t>(lt_mask[k])) >= prm.q2 ? 1u : 0u) << k;
#pragma unroll
    for (int a = 0; a < A; ++a) {
      const int32_t b = ev_bal[a], v = ev_val[a];
      if (!(((ev_flag >> a) & 1u) && b > 0)) continue;
      const int32_t bit = 1 << a;
      bool any_match = false;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (lt_bal[k] == b && lt_val[k] == v) {
          lt_mask[k] |= bit;
          any_match = true;
        }
      }
      if (any_match) continue;
      int32_t min_bal = lt_bal[0];
#pragma unroll
      for (int k = 1; k < K; ++k) min_bal = min(min_bal, lt_bal[k]);
      if (min_bal == 0 || b > min_bal) {
        bool done = false;
#pragma unroll
        for (int k = 0; k < K; ++k) {
          if (!done && lt_bal[k] == min_bal) {
            lt_bal[k] = b;
            lt_val[k] = v;
            lt_mask[k] = bit;
            done = true;
          }
        }
        if (min_bal != 0) ++evictions;
      } else {
        ++evictions;
      }
    }
    uint32_t newly = 0;
    int32_t first_val = 0;
#pragma unroll
    for (int k = K - 1; k >= 0; --k) {
      if (__popc(static_cast<uint32_t>(lt_mask[k])) >= prm.q2 && !((pre_chosen >> k) & 1u)) {
        newly |= 1u << k;
        first_val = lt_val[k];
      }
    }
    const bool any_new = newly != 0;
    const int32_t cv = chosen ? chosen_val : (any_new ? first_val : 0);
    const bool ch = chosen || any_new;
    chosen_tick = chosen ? chosen_tick : (any_new ? tick : -1);
    int viol = 0;
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (((newly >> k) & 1u) && lt_val[k] != cv && ch) ++viol;
    chosen = ch;
    chosen_val = cv;
    violations = wrap_add(violations, viol + inv_viol);

    // ---- Proposer sends into the consumed request buffer. ----
#pragma unroll
    for (int p = 0; p < P; ++p) {
#pragma unroll
      for (int a = 0; a < A; ++a) {
        if (((p1_done >> p) & 1u) && survives(prm.drop, s, kKeepP2, pos(p * A + a))) {
          const int j = (1 * P + p) * A + a;  // ACCEPT(old ballot, value)
          rq_bal[j] = old_bal[p];
          rq_v1[j] = prop_val[p];
          rq_v2[j] = 0;
          rq_present |= 1u << j;
        }
        if (((expired >> p) & 1u) && survives(prm.drop, s, kKeepP1, pos(p * A + a))) {
          const int j = (0 * P + p) * A + a;  // PREPARE(next ballot)
          rq_bal[j] = bal[p];
          rq_v1[j] = 0;
          rq_v2[j] = 0;
          rq_present |= 1u << j;
        }
      }
      if (prm.clamp_per_tick) bal[p] = min(bal[p], kBallotLimit);
    }
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
#pragma unroll
  for (int k = 0; k < K; ++k) {
    store<int32_t>(L, kLtBal, k, n, i, lt_bal[k]);
    store<int32_t>(L, kLtVal, k, n, i, lt_val[k]);
    store<int32_t>(L, kLtMask, k, n, i, lt_mask[k]);
  }
  store<uint8_t>(L, kChosen, 0, n, i, chosen ? 1 : 0);
  store<int32_t>(L, kChosenVal, 0, n, i, chosen_val);
  store<int32_t>(L, kChosenTick, 0, n, i, chosen_tick);
  store<int32_t>(L, kViolations, 0, n, i, violations);
  store<int32_t>(L, kEvictions, 0, n, i, evictions);
#pragma unroll
  for (int j = 0; j < S; ++j) {
    store<int32_t>(L, kRqBal, j, n, i, rq_bal[j]);
    store<int32_t>(L, kRqV1, j, n, i, rq_v1[j]);
    store<int32_t>(L, kRqV2, j, n, i, rq_v2[j]);
    store<uint8_t>(L, kRqPresent, j, n, i, ((rq_present >> j) & 1u) ? 1 : 0);
    store<int32_t>(L, kRpBal, j, n, i, rp_bal[j]);
    store<int32_t>(L, kRpV1, j, n, i, rp_v1[j]);
    store<int32_t>(L, kRpV2, j, n, i, rp_v2[j]);
    store<uint8_t>(L, kRpPresent, j, n, i, ((rp_present >> j) & 1u) ? 1 : 0);
  }
}

template <int P, int A, int K>
cudaError_t launch(const Leaves& L, const Plan& plan, const int32_t* tick, const Params& prm,
                   cudaStream_t stream) {
  const int64_t grid = (prm.n_inst + kThreads - 1) / kThreads;
  fused_paxos_kernel<P, A, K><<<static_cast<unsigned>(grid), kThreads, 0, stream>>>(L, plan, tick, prm);
  return cudaGetLastError();
}

Knob knob(const long long* v) {
  return Knob{static_cast<int32_t>(v[0]), static_cast<uint32_t>(v[1])};
}

}  // namespace

// C entry point, loaded with ctypes.  `leaves` and `plan` are host arrays of
// device pointers (28 state leaves in flatten order; crash_start, crash_end,
// equivocate); `tick` is the device int32 tick scalar, read by the kernel and
// advanced by the caller; `params` holds kParams integers in the order of
// the Python wrapper.  Returns the launch's cudaGetLastError().
extern "C" int fused_paxos_launch(int n_prop, int n_acc, int k_slots, void** leaves, int n_leaves,
                                  void** plan, void* tick, const long long* params, int n_params,
                                  void* stream) {
  if (n_leaves != kLeaves || n_params != kParams) return cudaErrorInvalidValue;
  Leaves L;
  for (int j = 0; j < kLeaves; ++j) L.p[j] = leaves[j];
  const Plan pl{static_cast<const int32_t*>(plan[0]), static_cast<const int32_t*>(plan[1]),
                static_cast<const uint8_t*>(plan[2])};
  Params prm;
  prm.n_inst = params[0];
  prm.block = static_cast<int32_t>(params[1]);
  prm.n_ticks = static_cast<int32_t>(params[2]);
  prm.seed = static_cast<uint32_t>(params[3]);
  prm.blk0 = static_cast<int32_t>(params[4]);
  prm.clamp_per_tick = static_cast<int32_t>(params[5]);
  prm.timeout = static_cast<int32_t>(params[6]);
  prm.backoff_n = static_cast<int32_t>(params[7]);
  prm.stride = static_cast<int32_t>(params[8]);
  prm.q1 = static_cast<int32_t>(params[9]);
  prm.q2 = static_cast<int32_t>(params[10]);
  prm.idle = knob(params + 11);
  prm.hold = knob(params + 13);
  prm.dup = knob(params + 15);
  prm.drop = knob(params + 17);
  if (prm.n_inst <= 0 || prm.block <= 0 || prm.n_inst % prm.block != 0 || prm.backoff_n < 1)
    return cudaErrorInvalidValue;
  const auto* t = static_cast<const int32_t*>(tick);
  auto s = static_cast<cudaStream_t>(stream);
  if (n_prop == 2 && n_acc == 5 && k_slots == 8) return launch<2, 5, 8>(L, pl, t, prm, s);
  if (n_prop == 1 && n_acc == 3 && k_slots == 8) return launch<1, 3, 8>(L, pl, t, prm, s);
  return cudaErrorInvalidValue;
}
