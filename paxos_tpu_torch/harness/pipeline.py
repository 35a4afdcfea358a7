"""Pipelined dispatch (counterpart of ``paxos_tpu/harness/pipeline.py``).

:func:`pipelined_run` groups up to ``depth`` chunks of ``chunk`` ticks into
one dispatch.  Tick streams derive from the tick counter, never from
dispatch boundaries, so the schedule is the same at any depth.  A
termination probe reads a 0-d done flag with ``.item()`` once per dispatch;
the state itself never crosses to the host mid-run.
"""

from __future__ import annotations

from typing import Callable, Optional


def pipelined_run(
    state,
    advance: Callable,
    *,
    budget: int,
    chunk: int,
    depth: int,
    done_fn: Optional[Callable] = None,
):
    """Drive ``advance(state, n_ticks, groups)`` for ``budget`` ticks, or
    until ``done_fn(state)`` reads true at a dispatch boundary; returns the
    state."""
    done = 0
    while done < budget:
        left = budget - done
        if left < chunk:
            n, g = left, 1
        else:
            n, g = chunk, min(depth, left // chunk)
        state = advance(state, n, g)
        done += n * g
        if done_fn is not None and bool(done_fn(state).item()):
            break
    return state
