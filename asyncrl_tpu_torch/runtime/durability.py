"""The preemption drain, the crash-consistent resume and the divergence
rollback (counterpart of ``asyncrl_tpu/runtime/durability.py``,
framework-free).

A platform's SIGTERM is a routine event on preemptible capacity. With a
grace budget (``config.drain_grace_s``, ``ASYNCRL_DRAIN_GRACE_S`` winning
when set), ``SebulbaTrainer.train`` installs a :class:`DrainCoordinator`
on the main thread that turns SIGTERM/SIGINT into a drain: the gateway and
the serve gate stop admitting, the actors stop, the partial metrics window
goes to the sinks with ``drain_preempt: 1.0``, the flight recorder
records ``supervisor.preempt`` (when tracing is on) and is flushed, one
final checkpoint is written, and ``train`` raises :class:`PreemptedExit` (exit code
:data:`EXIT_DRAINED`). A deadline watchdog exits :data:`EXIT_DEADLINE`
past the grace, and a second signal exits at once.

The chaos grammar's ``preempt`` kind (``utils/faults.py``) reaches the same
coordinator through :func:`scripted_preempt`: a real SIGTERM when the
handler is installed, a direct request otherwise.

:func:`resume_enabled` arms the crash-consistent resume (``resume``,
``ASYNCRL_RESUME``): ``SebulbaTrainer`` restores the run state that every
checkpoint's metadata carries (``run_state``) on top of the learner state.

:class:`RollbackPolicy` (``rollback_bad_windows > 0``) is evaluated at each
window close, before the elastic controller, on the critical learning-health
detectors (:data:`TRIGGER_DETECTORS`). While the run diverges the learner's
NaN guard (``learn/rollout_learner.py``) skips every non-finite update and
every bad window quarantines the fragments in flight (their staging leases
voided). After ``rollback_bad_windows`` consecutive bad windows the trainer
restores the last good checkpoint, folds the actor seed cursor and
republishes; a cooldown of :data:`COOLDOWN_WINDOWS` follows. Past
``rollback_max_attempts`` restores the run aborts.
"""

from __future__ import annotations

import dataclasses
import os
import signal
import sys
import threading
from typing import Any, Callable, Sequence

# Distinct exit codes: a supervisor script can tell a completed drain (the
# final checkpoint is durable) from one that blew its grace (the periodic
# checkpoints still cover a resume, the final window is lost).
EXIT_DRAINED = 86
EXIT_DEADLINE = 87

RESUME_ENV_VAR = "ASYNCRL_RESUME"
GRACE_ENV_VAR = "ASYNCRL_DRAIN_GRACE_S"

# The learning-health detectors whose firing makes a window bad for the
# rollback policy: divergence signals only (a stalled pipeline or an SLO
# breach is no reason to rewind the weights).
TRIGGER_DETECTORS = ("nonfinite_loss", "grad_explosion", "entropy_collapse")

# Windows the policy stays quiet after a rollback (not a config field, as in
# JAX). Poisoned fragments still quarantine during the cooldown; only the
# bad-window count freezes.
COOLDOWN_WINDOWS = 2


def _sigsafe_write(message: str) -> None:
    """Write one line to stderr without the buffered-I/O machinery. This
    runs inside the signal handler's frame: ``print`` would re-enter
    ``sys.stderr``'s buffer lock if the interrupted main-thread frame was
    mid-write, while a raw fd write is async-signal-safe. Best-effort: a
    closed fd 2 must not turn a routine preemption into a crash."""
    try:
        os.write(2, (message + "\n").encode())
    except OSError:
        pass


class PreemptedExit(SystemExit):
    """Raised out of ``train()`` after a completed drain: the final
    checkpoint is durable and the process should exit with
    :data:`EXIT_DRAINED`. A ``SystemExit``, so an unhandled propagation
    exits the interpreter with that code and no traceback, while a harness
    that wants to go on in-process catches it."""

    def __init__(self, signum: int | None = None):
        super().__init__(EXIT_DRAINED)
        self.signum = signum


def resume_enabled(config: Any) -> bool:
    """Resume armed? ``ASYNCRL_RESUME`` wins over ``config.resume`` when
    set."""
    env = os.environ.get(RESUME_ENV_VAR, "")
    if env:
        return env.lower() not in ("0", "false", "no")
    return bool(config.resume)


def drain_grace(config: Any) -> float:
    """The drain's grace budget, seconds (0 disables the handler).
    ``ASYNCRL_DRAIN_GRACE_S`` wins when set; a malformed value raises, so
    an operator's preemption config never silently disables the drain."""
    env = os.environ.get(GRACE_ENV_VAR, "")
    if env:
        try:
            return float(env)
        except ValueError:
            raise ValueError(
                f"{GRACE_ENV_VAR}={env!r} is not a number; the drain "
                "grace must be explicit (0 disables)"
            ) from None
    return float(getattr(config, "drain_grace_s", 0.0))


class DrainCoordinator:
    """One ``train()`` call's drain state machine.

    :meth:`install` replaces the process's SIGTERM/SIGINT handlers (on the
    main thread only; off it the coordinator still works through
    :meth:`request`), the train loop polls :attr:`requested` once an
    iteration, and the drain calls :meth:`finish` once the final checkpoint
    is written, then :meth:`uninstall`.

    The first signal requests the drain and starts the deadline watchdog,
    a daemon thread that exits the process with :data:`EXIT_DEADLINE` if
    the drain has not finished within ``grace_s``. A second signal exits
    at once.

    ``on_request`` (the port's addition) runs once, where the drain is
    requested, possibly inside the signal handler: it must take no lock
    and do no I/O. The trainer passes the gateway's signal-time refusal,
    so no request sent after the signal is admitted while the train loop
    reaches its next poll.
    """

    SIGNALS = (signal.SIGTERM, signal.SIGINT)

    def __init__(self, grace_s: float, exit_fn: Callable[[int], None] = os._exit,
                 on_request: Callable[[], None] | None = None):
        if grace_s <= 0:
            raise ValueError(f"drain grace must be > 0 to drain: {grace_s}")
        self.grace_s = float(grace_s)
        # Injectable for tests: the real watchdog must os._exit (a drain
        # wedged past its grace cannot be trusted to run Python cleanup).
        self._exit = exit_fn
        self._on_request = on_request
        self._requested = threading.Event()
        self._finished = threading.Event()
        self._lock = threading.Lock()
        # lint: thread-shared-ok(reentrancy-latch protocol state: request() writes signum exactly once, strictly before _requested.set(), and every reader is gated on requested being True, so the Event publication edge orders the write before any read)
        self.signum: int | None = None
        # lint: thread-shared-ok(installed-latch protocol state: written only by install/uninstall, which run on the main thread; a cross-thread reader (scripted_preempt) only picks the signal or the direct request, and either route drains)
        self.installed = False
        self._prev: dict[int, Any] = {}
        self._watchdog: threading.Thread | None = None  # guarded-by: _lock

    @property
    def requested(self) -> bool:
        """Has a drain been requested? (Any thread; one Event check.)"""
        return self._requested.is_set()

    # ---------------------------------------------------------- signals

    def install(self) -> bool:
        """Install the SIGTERM/SIGINT handlers. Returns False (a no-op) off
        the main thread: ``signal.signal`` is main-thread-only, and a
        trainer driven from a worker thread still drains through
        :meth:`request`."""
        if threading.current_thread() is not threading.main_thread():
            return False
        for sig in self.SIGNALS:
            self._prev[sig] = signal.signal(sig, self._handle)
        self.installed = True
        return True

    def uninstall(self) -> None:
        """Restore the previous handlers (the train loop's ``finally``)."""
        if not self.installed:
            return
        for sig, prev in self._prev.items():
            try:
                # lint: signal-safe-ok(installed-latch protocol: install() sets self.installed only after registering on the main thread, and the guard above returns unless installed, so this restore runs on that main thread)
                signal.signal(sig, prev)
            except (ValueError, TypeError):  # the interpreter is shutting down
                pass
        self._prev = {}
        self.installed = False

    def _handle(self, signum, frame) -> None:
        del frame
        if self._requested.is_set():
            # A second signal while draining: stop being graceful.
            _sigsafe_write(
                "asyncrl_tpu_torch: second signal during drain; exiting now "
                f"({EXIT_DEADLINE})"
            )
            self._exit(EXIT_DEADLINE)
            return  # reached only with an injected exit_fn
        self.request(signum)

    def request(self, signum: int = signal.SIGTERM, reason: str = "signal") -> None:
        """Request the drain (any thread; reentrant from the handler): sets
        the event the train loop polls and starts the grace watchdog.
        Idempotent.

        The flag flips first, before any I/O and without holding the lock:
        this frame may run in the signal handler on the main thread, and a
        second signal between two of its bytecodes re-enters
        :meth:`_handle`, which must see ``requested`` already set and take
        the hard-exit path rather than deadlock on a lock its own thread
        holds. The worst a non-signal race can produce is a second
        watchdog, and the watchdogs wait on the same event and fire the
        same exit."""
        if self._requested.is_set():
            return
        self.signum = int(signum)
        self._requested.set()
        if self._on_request is not None:
            self._on_request()
        _sigsafe_write(
            f"asyncrl_tpu_torch: drain requested ({reason}, signal "
            f"{self.signum}); finishing within {self.grace_s:.0f}s"
        )
        watchdog = threading.Thread(target=self._deadline, name="drain-watchdog", daemon=True)
        with self._lock:
            self._watchdog = watchdog
        watchdog.start()

    def _deadline(self) -> None:  # thread-entry: drain-watchdog@learner
        if self._finished.wait(timeout=self.grace_s):
            return
        print(
            f"asyncrl_tpu_torch: drain exceeded its {self.grace_s:.0f}s grace; "
            f"hard-killing ({EXIT_DEADLINE}). The periodic checkpoints still "
            "cover a resume; the final window is lost.",
            file=sys.stderr,
        )
        self._exit(EXIT_DEADLINE)

    def finish(self) -> None:
        """The drain completed (the final checkpoint is written): disarm
        the watchdog. Idempotent; also safe when never requested."""
        self._finished.set()


# ------------------------------------------------------- scripted preempt

# The coordinator the current train() call exposes to the chaos layer (the
# `preempt` fault kind): one per process at a time, one train loop per
# process on the host backends.
_ACTIVE_LOCK = threading.Lock()
_ACTIVE: DrainCoordinator | None = None  # guarded-by: _ACTIVE_LOCK


def set_active(coordinator: DrainCoordinator) -> None:
    global _ACTIVE
    with _ACTIVE_LOCK:
        _ACTIVE = coordinator


def clear_active(coordinator: DrainCoordinator) -> None:
    """Clear only if ``coordinator`` is still the active one: a nested or
    racing train() never clears another call's registration."""
    global _ACTIVE
    with _ACTIVE_LOCK:
        if _ACTIVE is coordinator:
            _ACTIVE = None


def active() -> DrainCoordinator | None:
    with _ACTIVE_LOCK:
        return _ACTIVE


def scripted_preempt() -> bool:
    """The ``preempt`` fault kind's payload (utils/faults.py): a SIGTERM
    under load to the active coordinator, through the real signal machinery
    when its handler is installed (the scripted event and a platform kill
    take the same path), else a direct request (train() off the main
    thread). False, and nothing done, when no coordinator is active."""
    coordinator = active()
    if coordinator is None:
        return False
    if coordinator.installed:
        signal.raise_signal(signal.SIGTERM)
    else:
        coordinator.request(signal.SIGTERM, reason="scripted preempt fault")
    return True


# ------------------------------------------------------- rollback policy


@dataclasses.dataclass(frozen=True)
class RollbackAction:
    """The policy's verdict on one bad window. ``kind``:

    - ``"quarantine"``: void the fragments in flight (produced under, or
      poisoned by, the diverging state). Fired on every bad window, during
      the cooldown too.
    - ``"rollback"``: restore the last good checkpoint, fold the actor seed
      cursor, republish. Fired on the ``bad_windows``-th consecutive bad
      window, at most ``max_attempts`` times.
    - ``"abort"``: attempts exhausted; the trainer stops and raises.
    """

    kind: str
    detail: str
    detectors: tuple[str, ...] = ()
    attempts: int = 0

    def event(self) -> dict[str, Any]:
        """The time-series annotation of the action (``kind=event``)."""
        return {
            "event_type": "rollback",
            "action": self.kind,
            "detail": self.detail,
            "detectors": list(self.detectors),
            "attempts": self.attempts,
        }


class RollbackPolicy:
    """The divergence policy of one run, window by window.

    Called on the window-close thread only (the trainer's drain), without
    a lock, as ``HealthMonitor`` and ``ElasticController`` are. The caller
    hands it the health events fired in the window and the checkpointer's
    newest retained step; the policy keeps the newest step retained at a
    clean window (``last_good_step``), so that a rollback never restores a
    checkpoint written while the run already diverged.
    """

    def __init__(self, bad_windows: int, max_attempts: int,
                 cooldown_windows: int = COOLDOWN_WINDOWS,
                 triggers: Sequence[str] = TRIGGER_DETECTORS):
        if bad_windows < 1:
            raise ValueError(f"rollback_bad_windows must be >= 1 to arm: {bad_windows}")
        if max_attempts < 1:
            raise ValueError(f"rollback_max_attempts must be >= 1: {max_attempts}")
        if cooldown_windows < 0:
            raise ValueError(f"cooldown_windows must be >= 0: {cooldown_windows}")
        self.bad_windows = bad_windows
        self.max_attempts = max_attempts
        self.cooldown_windows = cooldown_windows
        self.triggers = frozenset(triggers)
        self.attempts = 0  # restores over the run's life, carried across a resume
        self.last_good_step: int | None = None
        self._bad_run = 0
        self._cooldown = 0

    def on_window(self, events: Sequence[Any],
                  latest_step: int | None = None) -> RollbackAction | None:
        """Judge one closed window by the events fired in it (not the
        monitor's decaying verdict set); ``latest_step`` becomes the last
        good step only on a clean window."""
        fired = sorted({e.detector for e in events
                        if getattr(e, "detector", None) in self.triggers})
        if self._cooldown > 0:
            self._cooldown -= 1
            if fired:
                # Still diverging in the cooldown: the count stays frozen
                # (the restored run needs clean windows before a new verdict
                # means anything), but the poisoned data quarantines.
                return RollbackAction(
                    kind="quarantine",
                    detail=(f"divergence signals during rollback cooldown "
                            f"({self._cooldown + 1} window(s) left): {fired}"),
                    detectors=tuple(fired),
                    attempts=self.attempts,
                )
            return None
        if not fired:
            self._bad_run = 0
            if latest_step is not None:
                # A clean window: every step retained so far is good.
                self.last_good_step = int(latest_step)
            return None
        self._bad_run += 1
        if self._bad_run < self.bad_windows:
            return RollbackAction(
                kind="quarantine",
                detail=(f"bad window {self._bad_run}/{self.bad_windows}: {fired} — "
                        "NaN-guard holds the params, in-flight fragments quarantine"),
                detectors=tuple(fired),
                attempts=self.attempts,
            )
        self._bad_run = 0
        self.attempts += 1
        if self.attempts > self.max_attempts:
            return RollbackAction(
                kind="abort",
                detail=(f"divergence persisted through {self.max_attempts} rollback(s); "
                        f"aborting with forensics: {fired}"),
                detectors=tuple(fired),
                attempts=self.attempts,
            )
        self._cooldown = self.cooldown_windows
        return RollbackAction(
            kind="rollback",
            detail=(f"{self.bad_windows} consecutive bad window(s) ({fired}); rolling back "
                    f"to last-good checkpoint (attempt {self.attempts}/{self.max_attempts})"),
            detectors=tuple(fired),
            attempts=self.attempts,
        )
