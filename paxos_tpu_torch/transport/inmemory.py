"""In-memory transport (counterpart of ``paxos_tpu/transport/inmemory_tpu.py``).

"In flight" means a populated slot of a :class:`MsgBuf`.  Requests: each
(instance, acceptor) selects at most one present request per tick, by the
highest random score.  Replies: delivered all at once, minus holds.  A
buffer with ``until`` stamps (bounded delay) holds a slot back until its
stamp's tick (:func:`ready`).  The functions are pure and take pre-sampled
masks.
"""

from __future__ import annotations

from typing import Optional

import torch

from paxos_tpu_torch.core.messages import MsgBuf

INT32_MIN = -(1 << 31)


def select_from_scores(
    present: torch.Tensor, score_bits: torch.Tensor, busy: Optional[torch.Tensor]
) -> torch.Tensor:
    """Pick at most one present request per (instance, acceptor).

    The low ``nbits`` bits of each random int32 score are replaced by the
    slot id (kind * P + proposer), so scores in a fiber are distinct and
    ``score == fiber max`` is the one-hot winner.  INT32_MIN marks an absent
    slot; ``busy`` (False = the acceptor idles) applies after the max.
    """
    k, p = present.shape[0], present.shape[1]
    nbits = max((k * p - 1).bit_length(), 1)
    sid = torch.arange(k * p, dtype=torch.int32, device=present.device).view(
        k, p, 1, 1
    )
    score = (score_bits & ~((1 << nbits) - 1)) | sid
    score = torch.where(present, score, INT32_MIN)
    fiber_max = score.amax(dim=(0, 1), keepdim=True)
    sel = present & (score == fiber_max) & (fiber_max > INT32_MIN)
    if busy is not None:
        sel = sel & busy
    return sel


def ready(buf: MsgBuf, tick) -> Optional[torch.Tensor]:
    """(2, P, A, I) bool: the slot's delay window has passed (``tick >=
    until``); None when the buffer carries no stamps (delay off)."""
    if buf.until is None:
        return None
    return tick >= buf.until


def send(
    buf: MsgBuf,
    kind: int,
    send_mask: torch.Tensor,
    bal: torch.Tensor,
    v1: torch.Tensor,
    v2: torch.Tensor,
    keep: Optional[torch.Tensor] = None,
    until: Optional[torch.Tensor] = None,
) -> MsgBuf:
    """Write messages of ``kind`` into their slots (overwriting), minus drops.

    ``send_mask`` is (P, A, I); payloads broadcast against it; ``keep``
    False = the send is dropped.  A buffer with stamps gets ``until`` (P,
    A, I), the earliest delivery tick, on the written slots only, or 0
    (deliverable at once) where no stamp is given; a buffer without stamps
    ignores ``until``.
    """
    if keep is not None:
        send_mask = send_mask & keep
    kind_hot = (
        torch.arange(buf.bal.shape[0], device=buf.bal.device) == kind
    ).view(-1, 1, 1, 1)
    write = kind_hot & send_mask[None]
    new_until = buf.until
    if buf.until is not None:
        new_until = torch.where(write, 0 if until is None else until, buf.until)
    return MsgBuf(
        bal=torch.where(write, bal, buf.bal),
        v1=torch.where(write, v1, buf.v1),
        v2=torch.where(write, v2, buf.v2),
        present=buf.present | write,
        until=new_until,
    )


def consume(
    buf: MsgBuf, taken: torch.Tensor, stay: Optional[torch.Tensor] = None
) -> MsgBuf:
    """Clear slots processed this tick, except duplicated ones (``stay``)."""
    if stay is not None:
        taken = taken & ~stay
    return MsgBuf(buf.bal, buf.v1, buf.v2, buf.present & ~taken, buf.until)
