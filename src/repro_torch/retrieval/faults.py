"""Deterministic fault injection for the serving stack.

The fault-tolerance layer (replica failover, retry with backoff, collect
timeouts, crash-safe checkpointing) is only trustworthy if every behavior
is driven by *injected* faults in tests and benchmarks — never by luck.
This module is the single source of those faults: a `FaultPlan` describes,
deterministically and per micro-batch sequence number, which devices die,
which dispatches fail transiently, which collects hang or run slow, and
where a checkpoint save crashes.  `ServingEngine` consults the plan at well-defined hook points; a `None` plan is free (the
healthy path never pays for the hooks).

Fault model:

  * device death — permanent; pairs re-route to surviving replicas
    (Algorithm 1's replication doubles as redundancy), clusters with no
    surviving replica degrade with honest coverage accounting.
  * transient dispatch error — raised a bounded number of times; retried
    with capped exponential backoff, then escalated to failover.
  * hang / slow device — a collect that never (or late) completes; the
    collect timeout converts it into a fault event instead of a stall.
  * crash during checkpoint save — process dies at a named point of the
    atomic rename choreography (`checkpoint_hook`; the port writes no
    checkpoint yet, so nothing calls it: ROADMAP.md queue A item 10).

Everything here is host-side bookkeeping: no torch, no effect on the
shapes the kernels see.
"""

from __future__ import annotations

import dataclasses


class FaultError(RuntimeError):
    """Base class for injected and detected serving faults."""


class TransientFault(FaultError):
    """A dispatch/collect failure that may succeed on retry.

    Attributes:
      device: device id blamed for the failure, or None when the fault is
        not attributable (retries exhaust into a hard error instead of a
        device failover).
    """

    def __init__(self, msg: str, device: int | None = None):
        super().__init__(msg)
        self.device = device


class DeviceHang(FaultError):
    """A collect exceeded its timeout: the owning device is presumed dead.

    Attributes:
      device: the hung device id (failover target).
    """

    def __init__(self, msg: str, device: int):
        super().__init__(msg)
        self.device = device


class InjectedCrash(FaultError):
    """Simulated process death (e.g. mid-checkpoint-save).

    Raised by `FaultPlan.checkpoint_hook` at the configured crash point;
    tests treat it as the process dying at that exact instruction.
    """


@dataclasses.dataclass
class FaultPlan:
    """Deterministic schedule of injected faults, keyed by batch sequence.

    Every `ServingEngine` micro-batch carries a monotonically increasing
    sequence number (`seq`); the plan maps sequence numbers (and, for
    device death, devices) to faults.  All fields default to "no fault",
    so `FaultPlan()` is a no-op plan.

    Attributes:
      device_death: {device: seq} — device `device` is dead for every
        batch whose sequence number is >= `seq`.
      transient_dispatch: {seq: count} — the dispatch of batch `seq`
        raises `TransientFault` `count` times before succeeding.
      transient_device: device blamed by injected transient faults (None
        = unattributable; exhausted retries become a hard error).  The
        fault lives on that device: once the engine fails it over
        (reported via `live` at the dispatch hook), it stops firing.
      hang_collect: {seq: device} — batch `seq`'s collect never completes
        "because of" `device`.  One-shot: consumed when triggered, so the
        refired batch does not re-hang.
      slow_collect: {seq: seconds} — batch `seq`'s result is treated as
        not-ready for `seconds` after dispatch (tests the timeout grace
        window without real sleeps on the device).
      crash_save_at: name of the checkpoint-save crash point
        ("before_commit" | "after_rename_old" | "after_rename_new"), or
        None.  One-shot: cleared when it fires, so the recovery re-save
        in the same test completes.
      events: append-only log of (kind, detail) tuples recording every
        fault the plan actually injected and every recovery action the
        engine reported back — the assertion surface for tests.
    """

    device_death: dict[int, int] = dataclasses.field(default_factory=dict)
    transient_dispatch: dict[int, int] = dataclasses.field(
        default_factory=dict
    )
    transient_device: int | None = None
    hang_collect: dict[int, int] = dataclasses.field(default_factory=dict)
    slow_collect: dict[int, float] = dataclasses.field(default_factory=dict)
    crash_save_at: str | None = None
    events: list[tuple[str, dict]] = dataclasses.field(default_factory=list)

    def note(self, kind: str, **detail) -> None:
        """Record one fault/recovery event (tests assert on this log)."""
        self.events.append((kind, detail))

    def dead_devices(self, seq: int) -> list[int]:
        """Devices that are dead as of batch `seq` (sorted)."""
        return sorted(d for d, s in self.device_death.items() if seq >= s)

    def on_dispatch(self, seq: int, live=None) -> None:
        """Dispatch-time hook: raise the batch's pending transient fault.

        `live` is the caller's live-device mask; an attributed fault
        whose device has already been failed over no longer fires (the
        fault is *on* the device — routing around it fixes it).
        """
        dev = self.transient_device
        if dev is not None and live is not None and not bool(live[dev]):
            return
        left = self.transient_dispatch.get(seq, 0)
        if left > 0:
            self.transient_dispatch[seq] = left - 1
            self.note("transient_dispatch", seq=seq, remaining=left - 1)
            raise TransientFault(
                f"injected transient dispatch failure (batch {seq}, "
                f"{left - 1} more)",
                device=self.transient_device,
            )

    def hang_device(self, seq: int) -> int | None:
        """Collect-time hook: device hanging batch `seq`, if any (one-shot)."""
        dev = self.hang_collect.pop(seq, None)
        if dev is not None:
            self.note("hang_collect", seq=seq, device=dev)
        return dev

    def collect_delay(self, seq: int) -> float:
        """Simulated extra seconds before batch `seq`'s result is ready."""
        return self.slow_collect.get(seq, 0.0)

    def checkpoint_hook(self, point: str) -> None:
        """Checkpoint-save hook: crash if `point` is the configured one."""
        if self.crash_save_at == point:
            self.crash_save_at = None
            self.note("crash_save", point=point)
            raise InjectedCrash(f"injected crash during save at {point!r}")
