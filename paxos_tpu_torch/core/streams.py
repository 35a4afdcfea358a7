"""Counter-PRNG stream ids (counterpart of ``SINGLE_DECREE.streams`` in
``paxos_tpu/core/streams.py``).

Each mask of a single-decree tick draws from its own stream id; the ids are
part of the schedule, so they must equal the reference's.  Streams 10 and
up belong to the gray-failure and workload planes, which are not ported.
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
)
