"""SoundscapeService — many concurrent jobs, one device.

The multi-tenant executive the ROADMAP's "heavy traffic" north star
asks for: jobs stop being blocking ``run()`` calls that own the device
until they finish and become *schedulable units* — each submission is a
:class:`~repro_torch.api.engine.JobStepper` whose bounded step-quanta the
service interleaves through one scheduling loop.

Design points:

  * **one device, one driver thread** — the service serializes device
    dispatch exactly like a single job does, so per-tenant results are
    bitwise-identical to running each job alone (the step functions
    and their per-job invocation order never change; only wall-clock
    interleaving does).  Host-side overlap still comes from each
    tenant's own async executor machinery (prefetch sources, async
    sinks, in-flight dispatch windows, copy streams).  A tenant's
    stepper starts and steps on the driver thread alone — the thread
    that calls ``run()``, or the background thread of ``start()`` —
    because its copy streams order themselves against that thread's
    current CUDA stream;
  * **shared step functions** — every stepper builds through the
    service's :class:`~repro_torch.serve.compile_cache.CompileCache`, so
    tenants with matching (params, features, payload dtype, device,
    window) configurations reuse one step function and its device
    constants; ``stats()`` exposes the hit/miss counters;
  * **fairness** — a pluggable :class:`~repro_torch.serve.scheduler.Scheduler`
    (round-robin default, deficit-weighted optional) picks whose turn
    it is among *runnable* tenants; live tenants whose ring has no data
    report ``pending`` via the non-blocking ``poll`` and are skipped
    instead of stalling the service;
  * **isolation** — carries, cursors, streams, and sinks are per-tenant
    state on each stepper; a tenant that raises is failed and closed
    (its wav handles, writer threads, pinned staging buffers and device
    carry released) while every other tenant keeps running.

Use it blocking (submit everything, then ``run()``) or as a long-lived
background service (``start()`` / ``submit`` from any thread /
``handle.result()`` blocks / ``stop()``)::

    svc = SoundscapeService(quantum=2)
    a = api.job(m, p).features("welch").to(store_a).submit(svc)
    b = api.job(m, p).features("welch").to(store_b).submit(svc)
    svc.run()
    a.result()["welch"], svc.stats()["compile"]
"""
from __future__ import annotations

import threading
import time
import warnings

from repro_torch.api.job import JobResult

from .compile_cache import CompileCache
from .restart import RestartPolicy
from .scheduler import RoundRobin, Scheduler


class TenantHandle:
    """One submitted job inside a service: identity, scheduling knobs,
    and the observable outcome.

    ``state`` walks ``queued -> running -> done | failed``; under a
    service :class:`~repro_torch.serve.restart.RestartPolicy` a transiently
    failed tenant detours through ``parked`` (waiting out its restart
    backoff) back to ``queued``.  ``result()`` blocks until the tenant
    leaves the running states, then returns its
    :class:`~repro_torch.api.job.JobResult` (or raises the tenant's error).
    ``step_seconds`` records the wall-clock of every dispatched step —
    the service's per-tenant latency observability (the serve benchmark
    reports its p50/p95).  ``restarts`` counts re-admissions,
    ``last_error`` keeps the most recent healed failure, and
    ``close_error`` any secondary teardown failure (also chained onto
    the primary error's ``__context__``).
    """

    def __init__(self, name: str, stepper, weight: float, quantum: int,
                 job=None):
        self.name = name
        self.stepper = stepper
        self.job = job            # retained for restart re-admission
        self.weight = weight
        self.quantum = quantum
        self.state = "queued"
        self.error: BaseException | None = None
        self.last_error: BaseException | None = None
        self.close_error: BaseException | None = None
        self.restarts = 0
        self.steps_run = 0
        self.step_seconds: list[float] = []
        self._retry_at: float | None = None
        self._result: JobResult | None = None
        self._finished = threading.Event()

    @property
    def done(self) -> bool:
        return self.state in ("done", "failed")

    @property
    def records_done(self) -> int:
        return self.stepper.records_done

    def result(self, timeout: float | None = None) -> JobResult:
        """The tenant's JobResult; blocks while the service is still
        driving it, raises its error if it failed."""
        if not self._finished.wait(timeout):
            raise TimeoutError(
                f"tenant {self.name!r} still {self.state} after "
                f"{timeout}s")
        if self.error is not None:
            raise RuntimeError(
                f"tenant {self.name!r} failed") from self.error
        return self._result

    def __repr__(self):
        return (f"TenantHandle({self.name!r}, state={self.state!r}, "
                f"steps={self.steps_run})")


class SoundscapeService:
    """Run many SoundscapeJobs concurrently over one device.

    ``quantum`` is the default number of plan steps one scheduling turn
    may run for a tenant (its starvation bound); ``scheduler`` the
    fairness policy; ``cache`` the shared compiled-step cache.
    ``idle_wait`` is the sleep between scheduling passes when every
    active tenant is blocked on a starved live source.  ``restart``
    (a :class:`~repro_torch.serve.restart.RestartPolicy`) opts into
    self-healing: tenants that die of transient causes are parked and
    re-admitted from their last committed cursor instead of failed;
    ``None`` (the default) keeps fail-fast behaviour.
    """

    def __init__(self, scheduler: Scheduler | None = None,
                 quantum: int = 2, cache: CompileCache | None = None,
                 idle_wait: float = 0.002,
                 restart: RestartPolicy | None = None):
        if quantum < 1:
            raise ValueError(f"quantum must be >= 1, got {quantum}")
        self.scheduler = scheduler or RoundRobin()
        self.quantum = quantum
        self.cache = cache or CompileCache()
        self.idle_wait = idle_wait
        self.restart = restart
        self.restarts = 0         # total re-admissions, all tenants
        self.trace: list[tuple[str, int]] = []   # (tenant, steps) turns
        self._tenants: dict[str, TenantHandle] = {}
        self._lock = threading.RLock()
        self._thread: threading.Thread | None = None
        self._stop = False

    # -- admission ------------------------------------------------------
    def submit(self, job, *, name: str | None = None, weight: float = 1.0,
               quantum: int | None = None) -> TenantHandle:
        """Admit one job (a :class:`~repro_torch.api.job.SoundscapeJob`) as a
        tenant; returns its handle.  Thread-safe; jobs may be submitted
        while the service is running."""
        with self._lock:
            if name is None:
                name = f"tenant-{len(self._tenants)}"
            if name in self._tenants:
                raise ValueError(f"tenant {name!r} already submitted")
            stepper = job._stepper(compiler=self.cache, name=name)
            handle = TenantHandle(name, stepper, weight,
                                  quantum or self.quantum, job=job)
            self.scheduler.add(name, weight)
            self._tenants[name] = handle
            return handle

    @property
    def tenants(self) -> dict[str, TenantHandle]:
        with self._lock:
            return dict(self._tenants)

    # -- the scheduling loop --------------------------------------------
    def step(self) -> str:
        """One scheduling turn: pick a runnable tenant, run up to its
        quantum of plan steps, finalize it if it finished.  Returns
        ``"ran"``, ``"idle"`` (active tenants exist but all are blocked
        on starved live sources), or ``"done"`` (no active tenants)."""
        with self._lock:
            active = [t for t in self._tenants.values() if not t.done]
            if not active:
                return "done"
            now = time.monotonic()
            runnable = []
            for t in active:
                if t.state == "parked":
                    if now < t._retry_at:
                        continue          # still waiting out backoff
                    self._readmit(t)
                    if t.done:
                        continue          # re-admission itself failed
                if t.stepper.poll() != "pending":
                    runnable.append(t)
            if not runnable:
                return "idle"
            name = self.scheduler.pick([t.name for t in runnable])
            tenant = self._tenants[name]
        ran = self._run_quantum(tenant)
        with self._lock:
            self.scheduler.charge(tenant.name, ran)
            self.trace.append((tenant.name, ran))
        return "ran"

    def _readmit(self, tenant: TenantHandle) -> None:
        """Self-healing re-admission: build a fresh stepper from the
        tenant's retained job — it resumes from the last committed
        cursor (carry, quarantine, and event tails ride the commit) so
        the healed run is bitwise-identical to an uninterrupted one.
        Called under the lock, once the parked backoff has elapsed."""
        tenant.last_error, tenant.error = tenant.error, None
        try:
            tenant.stepper = tenant.job._stepper(
                compiler=self.cache, name=tenant.name)
        except BaseException as e:             # noqa: BLE001
            tenant.error = e
            tenant.state = "failed"
            tenant._finished.set()
            if isinstance(e, (KeyboardInterrupt, SystemExit)):
                raise
            return
        tenant.restarts += 1
        self.restarts += 1
        tenant.state = "queued"
        tenant._retry_at = None

    def _run_quantum(self, tenant: TenantHandle) -> int:
        """Drive one tenant for up to ``tenant.quantum`` steps; handle
        start, graceful finish, and failure isolation (park-for-restart
        when the service has a RestartPolicy and the failure is
        transient; terminal ``failed`` otherwise)."""
        ran = 0
        stepper = tenant.stepper
        try:
            if tenant.state == "queued":
                stepper.start()
                tenant.state = "running"
            while ran < tenant.quantum and not stepper.done:
                if stepper.poll() == "pending":
                    break                      # live tenant starved
                t0 = time.perf_counter()
                if not stepper.step_once():
                    break
                tenant.step_seconds.append(time.perf_counter() - t0)
                ran += 1
            if stepper.done:
                out = stepper.finish()
                stepper.close()
                tenant._result = JobResult(
                    features=out[0], epoch=out[1], windows=out[2],
                    window_edges=out[3], n_records=out[4],
                    events=out[5], plan=out[6], quarantine=out[7])
                tenant.state = "done"
                tenant.error = None
                tenant._finished.set()
        except BaseException as e:             # noqa: BLE001
            fatal = isinstance(e, (KeyboardInterrupt, SystemExit))
            tenant.error = e
            if (not fatal and self.restart is not None
                    and self.restart.restartable(e)
                    and tenant.restarts < self.restart.restarts):
                tenant.state = "parked"
                tenant._retry_at = time.monotonic() \
                    + self.restart.delay(tenant.restarts)
            else:
                tenant.state = "failed"
                tenant._finished.set()
            self._close_failed(tenant, e)
            if fatal:
                raise
        finally:
            tenant.steps_run += ran
        return ran

    @staticmethod
    def _close_failed(tenant: TenantHandle, error: BaseException) -> None:
        """Release a failed tenant's resources.  A secondary failure
        during close must not vanish: it is chained onto the primary
        error's ``__context__`` (the traceback shows both), kept on
        ``tenant.close_error``, and warned about."""
        try:
            tenant.stepper.close()
        except BaseException as ce:            # noqa: BLE001
            if isinstance(ce, (KeyboardInterrupt, SystemExit)):
                raise
            tenant.close_error = ce
            # ce was raised while handling `error`, so its implicit
            # context already points back at it — break that link
            # before threading ce onto the END of error's own chain,
            # or the chain becomes a cycle
            ce.__context__ = None
            ce.__cause__ = None
            tail = error
            while tail.__context__ is not None and tail.__context__ is not ce:
                tail = tail.__context__
            if tail.__context__ is None:
                tail.__context__ = ce
            warnings.warn(
                f"tenant {tenant.name!r} also failed to close cleanly "
                f"after its primary error: {ce!r}", RuntimeWarning,
                stacklevel=3)

    def run(self, timeout: float | None = None) -> dict[str, TenantHandle]:
        """Drive every submitted tenant to completion (blocking); live
        tenants may keep being fed from producer threads while this
        loop runs.  ``timeout`` bounds the wall clock — a producer that
        died without ``end()`` then raises instead of idling forever."""
        t = self._thread
        if t is not None and t.is_alive():
            raise RuntimeError(
                "run() while the background thread of start() drives "
                "the service: a tenant's stepper starts and steps on one "
                "thread — stop() first, or wait on handle.result()")
        deadline = None if timeout is None \
            else time.monotonic() + timeout
        while True:
            state = self.step()
            if state == "done":
                return self.tenants
            if deadline is not None and time.monotonic() > deadline:
                stuck = [t.name for t in self.tenants.values()
                         if not t.done]
                raise TimeoutError(
                    f"service run exceeded {timeout}s with tenants "
                    f"{stuck} unfinished (live producer died without "
                    f"end()?)")
            if state == "idle":
                time.sleep(self.idle_wait)

    # -- long-lived background mode -------------------------------------
    def start(self) -> "SoundscapeService":
        """Run the scheduling loop on a background thread until
        ``stop()`` — the long-lived service shape: submit from any
        thread, block on ``handle.result()``."""
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return self
            self._stop = False
            self._thread = threading.Thread(
                target=self._serve_loop, name="SoundscapeService",
                daemon=True)
            self._thread.start()
        return self

    def _serve_loop(self):
        while not self._stop:
            if self.step() in ("idle", "done"):
                time.sleep(self.idle_wait)

    def stop(self, wait: bool = True) -> None:
        self._stop = True
        t = self._thread
        if wait and t is not None and t.is_alive():
            t.join()
        self._thread = None

    # -- observability ---------------------------------------------------
    def stats(self) -> dict:
        """Service-level counters: compile-cache hits/misses, per-tenant
        progress (including each tenant's sink ``describe()`` — output
        format, path, and for timestamped labeled sinks the committed
        UTC high-watermark), and the scheduling trace length."""
        with self._lock:
            tenants = {}
            for name, t in self._tenants.items():
                info = {"state": t.state, "steps": t.steps_run,
                        "records": (t.records_done if t.state != "queued"
                                    else 0),
                        "weight": t.weight, "restarts": t.restarts}
                sink = getattr(t.stepper, "sink", None)
                desc = sink.describe() if sink is not None else {}
                if desc:
                    info["sink"] = desc
                tenants[name] = info
            return {"compile": self.cache.stats(), "tenants": tenants,
                    "turns": len(self.trace), "restarts": self.restarts}
