"""Fault tolerance, serving subset: the liveness heartbeat helpers the
serving re-install manager stamps its install phases into.  The
reference's train driver (checkpoint/restart, stragglers, preemption)
is not ported yet."""

from repro_torch.ft.heartbeat import read_heartbeat, write_heartbeat

__all__ = ["write_heartbeat", "read_heartbeat"]
