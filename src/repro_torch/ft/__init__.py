"""Fault tolerance: checkpoint/restart driver, stragglers, preemption.

Import :class:`~repro_torch.ft.driver.TrainDriver` from
``repro_torch.ft.driver``; the heartbeat helpers here are shared with
the serving re-install manager.
"""

from repro_torch.ft.heartbeat import read_heartbeat, write_heartbeat

__all__ = ["write_heartbeat", "read_heartbeat"]
