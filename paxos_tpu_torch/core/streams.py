"""Counter-PRNG stream ids (counterpart of ``SINGLE_DECREE.streams`` and
``MULTI_PAXOS.streams`` in ``paxos_tpu/core/streams.py``).

Each mask of a tick draws from its own stream id; the ids are part of the
schedule, so they must equal the reference's.  The single-decree ticks
(paxos, fastpaxos, raftcore, synchpaxos) share one allocation, Multi-Paxos
has its own.  Of the gray-failure streams the per-link loss and
duplication bits and the corruption mask (LINK_BITS, DUP_BITS, CORRUPT:
``p_flaky``, ``p_corrupt``) and the bounded-delay draws (DELAY_BITS,
LAT_BITS: ``p_delay``) are ported for both allocations, and so is the
client workload's ARRIVAL stream; the ticks draw it only where the state
carries the workload plane.
"""

SINGLE_DECREE_STREAMS = dict(
    SEL=0,  # request-selection entropy
    BUSY=1,  # acceptor idling (p_idle)
    DELIVER=2,  # reply holding (p_hold)
    DUP_REQ=3,  # request duplication (p_dup)
    DUP_REP=4,  # reply duplication (p_dup)
    KEEP_PROM=5,  # PROMISE-class drop (p_drop)
    KEEP_ACCD=6,  # ACCEPTED-class drop
    KEEP_P1=7,  # PREPARE-class drop
    KEEP_P2=8,  # ACCEPT-class drop
    BACKOFF=9,  # proposer retry backoff
    LINK_BITS=10,  # per-link loss raw bits (p_flaky)
    DUP_BITS=11,  # per-link duplication raw bits (p_flaky + dup)
    CORRUPT=12,  # in-flight corruption mask (p_corrupt)
    DELAY_BITS=13,  # per-edge delay decision raw bits (p_delay)
    LAT_BITS=14,  # per-edge sampled latency raw bits (delay_max)
    ARRIVAL=15,  # client-arrival raw bits (workload plane)
)

MULTI_PAXOS_STREAMS = dict(
    SEL=0,  # request-selection entropy
    BUSY=1,  # acceptor idling (p_idle)
    DUP_REQ=2,  # request duplication (p_dup)
    PROM_DELIVER=3,  # promise holding (p_hold)
    ACCD_DELIVER=4,  # accepted holding (p_hold)
    KEEP_PROM=5,  # PROMISE drop (p_drop)
    KEEP_ACCD=6,  # ACCEPTED drop
    KEEP_PREP=7,  # PREPARE drop
    KEEP_ACC=8,  # ACCEPT drop
    JITTER=9,  # election-threshold jitter
    BACKOFF=10,  # post-failure retreat
    LINK_BITS=11,  # per-link loss raw bits (p_flaky)
    DUP_BITS=12,  # per-link duplication raw bits (p_flaky + dup)
    CORRUPT=13,  # in-flight corruption mask (p_corrupt)
    DELAY_BITS=14,  # per-edge delay decision raw bits (p_delay)
    LAT_BITS=15,  # per-edge sampled latency raw bits (delay_max)
    ARRIVAL=16,  # client-arrival raw bits (workload plane)
)

# The reference's root fold domain of the workload plan's ``jax.random``
# keys (its lanes' mode and phase; the port takes them as given, ROADMAP
# item 15, and chip_smoke draws them from numpy on a stream of this id).
ROOT_WLOAD = 2
