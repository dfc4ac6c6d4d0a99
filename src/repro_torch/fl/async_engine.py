"""Asynchronous round engine: buffered, staleness-weighted aggregation.

The synchronous path (:meth:`repro_torch.fl.server.FLServer.run_round`) is a
barrier: every round waits for the slowest selected device, and a device
that goes offline mid-round forfeits its work.  The scenario layer knows
when devices come and go, so this engine trains through those gaps — the
FedBuff/FedAsync recipe, as in the reference:

* a **virtual clock** over the scenario's availability windows.  One
  scenario round spans ``tick_s`` simulated seconds; the clock jumps between
  *events* (job completions and availability transitions —
  ``DevicePool.next_transition`` says when the mask can next change), and the
  pool's dynamics are replayed up to the current tick whenever the engine
  consults them (:meth:`AsyncRoundEngine._sync_pool`).  On a trace scenario
  every such consultation is a ``fleet_state`` segment lookup on the card;
* **dispatch on arrival** — whenever concurrency slots are free and
  online+idle devices exist, the policy selects a wave of devices that start
  local training from the *current* global model (version-stamped); probing
  policies probe inside the wave as in the sync engine;
* **pause/resume over availability gaps** — a running job whose device goes
  offline stops consuming time and energy and resumes when it returns;
* **buffered aggregation** — completed updates enter a buffer; every
  ``buffer_size`` arrivals the server merges them with
  :func:`repro_torch.fl.aggregation.buffered_aggregate`, weighting each
  update by data size x a staleness weight of its model-version lag.
  Metrics are recorded per aggregation, wall-clock is the absolute virtual
  clock, and energy is charged per job as it completes (pro-rata for
  mid-job dropouts).

The clock and the job table stay f64 numpy on the host: job state lives in a
struct-of-arrays table (:class:`_JobTable`) keyed by ABSOLUTE times, so a
job's completion time is one vectorized expression and batched and
sequential event processing agree bit for bit.  ``FLConfig.async_events``
picks ``"batched"`` (whole event windows per step) or ``"sequential"`` (one
event instant per step — the parity oracle).  Local training and the merge
run on the server's device.

Reduction anchor: with ``buffer_size = concurrency = K``, an always-available
scenario and ``constant`` weighting, every wave is dispatched at one version,
fully arrives and aggregates: the engine replays the synchronous engine's
selection draws, per-client seeds and FedAvg merge.

An attack (``FLServer.attack``) corrupts adversarial uploads at dispatch,
relative to the model version the wave trained from, and the buffer merge
takes ``FLConfig.aggregator``'s robust kind.  The hierarchical engine
(:class:`repro_torch.fl.topology.HierarchicalAsyncEngine`) overrides
``_dispatch``, ``_fill_need``, ``_fill_unit_of``, ``_ready`` and
``_aggregate`` (and ``_merge_metrics``, its per-merge gauges).

Observability (``FLConfig.observe``): the loop's ``ready_check``,
``aggregate``, ``dispatch`` and ``events`` spans carry the virtual clock
beside host wall time; each merge feeds the ``staleness`` histogram and the
per-merge gauges and flushes one round record; ``events_per_window`` counts
each clock jump's events; a stall or the runaway backstop is logged as an
``async-stall`` / ``async-backstop`` event before it raises.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.fl.aggregation import STALENESS_KINDS, buffered_aggregate
from repro_torch.fl.engine import (
    COMPLETE_SEED_STRIDE,
    PROBE_SEED_STRIDE,
    build_requests,
    build_round_plan,
)

Params = Any

_EPS = 1e-9          # event-time slop: treat |dt| < _EPS as "now"

EVENT_MODES = ("batched", "sequential")


class AsyncStallError(RuntimeError):
    """The event loop can make no further progress (no running jobs, no
    dispatchable devices, no future availability transition) or tripped the
    runaway backstop.  ``fields`` carries the diagnostics."""

    def __init__(self, message: str, **fields):
        super().__init__(message)
        self.fields = dict(fields)


@dataclass
class AsyncJob:
    """One completed update in the merge buffer (in-flight state lives in
    :class:`_JobTable`)."""

    cid: int
    version: int              # global-model version at dispatch
    seq: int                  # global dispatch order (stable merge order)
    cycle: int                # dispatch-wave index (seed base)
    duration_s: float         # total *active* seconds of work
    energy_j: float           # energy if run to completion
    params: Optional[Params]  # None => probe-only job (never uploads)
    loss: float               # final local-epoch loss (revealed on upload)
    fail_at_s: float          # active seconds until mid-job dropout (inf)
    dispatched_at: float = 0.0  # absolute virtual time the wave fired
    adversarial: bool = False  # upload corrupted by the attack at dispatch

    @property
    def end_s(self) -> float:
        """Active seconds at which this job leaves its device."""
        return min(self.duration_s, self.fail_at_s)


def event_groups(times: np.ndarray, eps: float = _EPS) -> List[Tuple[int, int]]:
    """Greedy ``eps``-instants over SORTED event times: each group spans
    ``[t0, t0 + eps]`` from its earliest member — the due-set rule the
    one-at-a-time loop applies per step.  Returns ``(start, end)`` index
    pairs into ``times``."""
    groups: List[Tuple[int, int]] = []
    i, n = 0, len(times)
    while i < n:
        j = int(np.searchsorted(times, times[i] + eps, side="right"))
        groups.append((i, j))
        i = j
    return groups


class _JobTable:
    """Struct-of-arrays store for in-flight jobs, keyed by absolute time.

    Per slot: ``end_active`` active seconds end the job (completion or
    mid-job dropout, whichever is sooner), ``done_active`` seconds were
    banked before the current online stretch, and ``online_since`` is the
    absolute virtual time the stretch began (NaN while the device is
    offline), so every running job's absolute completion time is
    ``online_since + (end_active - done_active)``, paused jobs at ``+inf``.
    """

    _F64 = ("duration", "energy", "fail_at", "end_active", "done_active",
            "online_since", "dispatched_at")
    _I64 = ("cid", "version", "seq", "cycle")
    _BOOL = ("is_upload", "adversarial", "active")

    def __init__(self, capacity: int = 64):
        self.cap = capacity
        for name in self._F64:
            setattr(self, name, np.zeros(capacity))
        for name in self._I64:
            setattr(self, name, np.zeros(capacity, np.int64))
        for name in self._BOOL:
            setattr(self, name, np.zeros(capacity, bool))
        self.payload: Dict[int, Tuple[Optional[Params], Any]] = {}
        self._free = list(range(capacity - 1, -1, -1))
        self._n = 0

    def __len__(self) -> int:
        return self._n

    def _grow(self) -> None:
        old = self.cap
        self.cap = old * 2
        for name in self._F64 + self._I64 + self._BOOL:
            arr = getattr(self, name)
            setattr(self, name, np.concatenate([arr, np.zeros(old, arr.dtype)]))
        self._free.extend(range(self.cap - 1, old - 1, -1))

    def add(self, *, cid: int, version: int, seq: int, cycle: int,
            duration: float, energy: float, fail_at: float, now: float,
            payload, adversarial: bool = False) -> int:
        if not self._free:
            self._grow()
        s = self._free.pop()
        self.cid[s] = cid
        self.version[s] = version
        self.seq[s] = seq
        self.cycle[s] = cycle
        self.duration[s] = duration
        self.energy[s] = energy
        self.fail_at[s] = fail_at
        self.end_active[s] = min(duration, fail_at)
        self.done_active[s] = 0.0
        self.online_since[s] = now       # dispatch requires an online device
        self.dispatched_at[s] = now
        self.is_upload[s] = payload[0] is not None
        self.adversarial[s] = adversarial
        self.active[s] = True
        self.payload[s] = payload
        self._n += 1
        return s

    def free(self, slot: int) -> None:
        self.active[slot] = False
        self.payload.pop(slot, None)
        self._free.append(slot)
        self._n -= 1

    def end_abs(self) -> np.ndarray:
        """(cap,) absolute completion/dropout time per slot; ``+inf`` for
        free slots and jobs paused over an availability gap."""
        out = np.full(self.cap, np.inf)
        run = self.active & ~np.isnan(self.online_since)
        out[run] = (self.online_since[run]
                    + (self.end_active[run] - self.done_active[run]))
        return out

    def apply_mask(self, mask: np.ndarray, t: float) -> None:
        """Pause/resume bookkeeping at an availability-mask change at absolute
        time ``t``: newly offline jobs bank their active seconds, newly
        online jobs restart their stretch."""
        act = np.flatnonzero(self.active)
        if act.size == 0:
            return
        online = mask[self.cid[act]]
        running = ~np.isnan(self.online_since[act])
        pause = act[running & ~online]
        if pause.size:
            self.done_active[pause] += t - self.online_since[pause]
            self.online_since[pause] = np.nan
        resume = act[~running & online]
        if resume.size:
            self.online_since[resume] = t


class AsyncRoundEngine:
    """Event loop driving one :class:`~repro_torch.fl.server.FLServer` in
    asynchronous mode.  Mutates the server's global model and bookkeeping
    and appends one :class:`~repro_torch.fl.server.RoundResult` per
    aggregation to ``server.history``."""

    def __init__(self, server, policy):
        self.srv = server
        self.policy = policy
        cfg = server.cfg
        self.buffer_size = cfg.buffer_size or cfg.k_select
        self.concurrency = cfg.async_concurrency or self.buffer_size
        if self.concurrency < self.buffer_size:
            raise ValueError(
                f"async_concurrency ({self.concurrency}) must be >= "
                f"buffer_size ({self.buffer_size}) — fewer outstanding "
                "updates than the buffer needs means no aggregation can "
                "ever trigger")
        if cfg.staleness not in STALENESS_KINDS:
            raise ValueError(f"unknown staleness kind {cfg.staleness!r}; "
                             f"expected one of {STALENESS_KINDS}")
        self.events_mode = cfg.async_events or "batched"
        if self.events_mode not in EVENT_MODES:
            raise ValueError(f"unknown async_events mode {cfg.async_events!r}; "
                             f"expected one of {EVENT_MODES}")
        est_t, _ = server._static_round_estimates()
        self.tick_s = cfg.async_tick_s or float(np.median(est_t))

        self.now = 0.0
        self.version = 0
        self.cycle = 0
        self._seq = 0
        self.jobs = _JobTable()
        self.buffer: List[AsyncJob] = []
        self._time_offset = server._cum_time   # absolute clock across runs

        # _busy marks devices holding any unfinished obligation (in-flight
        # job or buffered-unmerged update); _upload_slots counts outstanding
        # upload-bound updates (in flight + buffered), kept at dispatch,
        # dropout and merge
        self._busy = np.zeros(cfg.n_devices, bool)
        self._upload_slots = 0

        # scenario clock: pool round r maps to [r*tick, (r+1)*tick) relative
        # to the engine's start round
        self.srv.pool.advance_round()
        self._start_round = self.srv.pool.round_idx
        self._mask = self.srv.pool.available()
        self._next_trans = self.srv.pool.next_transition()

        self._last_agg_t = 0.0
        self._energy_since_agg = 0.0
        self._failed_since_agg: List[int] = []
        self._last_observe = (None, None, None)   # (ctx, probe_ids, states)
        # observability: the server's recorder and logger (the no-op
        # singleton unless FLConfig.observe opted in; every feed is RNG-free)
        self.obs = server.obs
        self.log = server.log
        self._events_since_merge = 0
        self._trans_since_merge = 0
        self._host_last = time.perf_counter()

    def _vclock(self) -> float:
        """Virtual-time source for spans (recorded beside host wall)."""
        return self.now

    # ------------------------------------------------------------------
    # scenario clock
    # ------------------------------------------------------------------
    def _sync_pool(self) -> bool:
        """Fast-forward the scenario dynamics to the virtual clock's current
        round (one round per ``tick_s``).  Load and availability only matter
        at events, so replaying skipped rounds on demand keeps the dynamics
        while the clock jumps.  Returns whether the availability mask
        actually CHANGED (conservative ``next_transition`` hints may be
        no-ops)."""
        r = self._start_round + int(self.now / self.tick_s + 1e-9)
        if r <= self.srv.pool.round_idx:
            return False
        # loss freshness advances with the VIRTUAL clock, one unit per
        # scenario round, so ctx.loss_age means the same in both regimes
        self.srv.loss_age += r - self.srv.pool.round_idx
        self.srv.pool.advance_to(r)
        new_mask = self.srv.pool.available()
        self._next_trans = self.srv.pool.next_transition()
        self._trans_since_merge += 1
        if np.array_equal(new_mask, self._mask):
            return False                 # no-op transition: mask unchanged
        self._mask = new_mask
        return True

    # ------------------------------------------------------------------
    # dispatch
    # ------------------------------------------------------------------
    def _slots_used(self) -> int:
        """Outstanding upload-bound updates: in-flight training jobs plus
        completed-but-unmerged ones.  A slot is held from dispatch until the
        update is MERGED (FedBuff's M outstanding clients); probe-only scouts
        keep their device busy but hold no slot."""
        return self._upload_slots

    def _idle_online(self) -> np.ndarray:
        """Devices that may start new work: online and not busy."""
        return self._mask & ~self._busy

    def _dispatch(self) -> bool:
        """Run one selection wave if slots and online+idle devices exist."""
        srv, cfg = self.srv, self.srv.cfg
        if self._sync_pool():
            self.jobs.apply_mask(self._mask, self.now)
        free = self.concurrency - self._slots_used()
        if free <= 0:
            return False
        idle_online = self._idle_online()
        n_idle = int(idle_online.sum())
        if n_idle == 0:
            return False
        k = min(free, n_idle, cfg.k_select)
        ctx = srv._ctx(k=k, available=idle_online, round_idx=self.cycle)
        return self._run_wave(ctx)

    def _run_wave(self, ctx) -> bool:
        """Probe / select / execute / enqueue one dispatch wave against
        ``ctx``.  Returns whether any work was scheduled."""
        srv, cfg = self.srv, self.srv.cfg
        plan = build_round_plan(self.policy, ctx, cfg.l_ep)
        probe_ids = np.asarray(plan.probe_ids, dtype=np.int64)
        probe_states = None
        probe_params: Dict[int, Params] = {}

        if plan.has_probe:
            srv._check_available(ctx, probe_ids, self.policy, "probed")
            reqs = build_requests(probe_ids, srv._client_data,
                                  plan.probe_epochs, seed=cfg.seed,
                                  round_idx=self.cycle, stride=PROBE_SEED_STRIDE)
            probed = srv._execute(reqs)
            probe_params = probed.params
            probe_losses = np.array([probed.losses[int(i)][-1] for i in probe_ids])
            srv.last_loss[probe_ids] = probe_losses
            srv.loss_age[probe_ids] = 0
            probe_states = ctx.probe_states(probe_ids, probe_losses)

        selected = np.asarray(self.policy.select(
            ctx, probe_ids if plan.has_probe else None, probe_states),
            dtype=np.int64)
        srv._check_available(ctx, selected, self.policy, "selected")
        if plan.has_probe:
            missing = [int(i) for i in selected if int(i) not in probe_params]
            if missing:
                raise ValueError(
                    f"policy {self.policy.name!r} selected devices {missing} "
                    "outside the wave's probe set")

        # local training runs NOW (a pure function of the dispatch-time
        # global model); the virtual clock decides when each result lands
        losses: Dict[int, np.ndarray] = {}
        if plan.completion_epochs > 0 and len(selected):
            reqs = build_requests(selected, srv._client_data,
                                  plan.completion_epochs, seed=cfg.seed,
                                  round_idx=self.cycle,
                                  stride=COMPLETE_SEED_STRIDE,
                                  init_params=probe_params)
            completed = srv._execute(reqs)
            params = completed.params
            losses = completed.losses
        else:
            params = {int(i): probe_params[int(i)] for i in selected}

        # per-device timing/energy from the dispatch-time system state;
        # probing waves pay a probe barrier before the completion work
        sys = ctx.sys
        barrier = (float(sys.t_comp[probe_ids].max()) * plan.probe_epochs
                   if plan.has_probe else 0.0)
        sel_set = set(int(i) for i in selected)
        for i in probe_ids:                    # early exits: probe-only cost
            i = int(i)
            if i in sel_set:
                continue
            self._add_job(i, duration=float(sys.t_comp[i]) * plan.probe_epochs,
                          energy=float(sys.e_comp[i]) * plan.probe_epochs,
                          params=None, loss=float(srv.last_loss[i]),
                          fail_at=np.inf)

        # attack injection: adversarial uploads are corrupted at dispatch,
        # relative to the version the wave trained from (self.cycle is the
        # wave counter, the async analogue of the sync round index), from the
        # attack's own RNG stream
        adv = np.zeros(len(selected), bool)
        if srv.attack is not None and len(selected):
            adv = srv.attack.draw(cfg.n_devices, cfg.seed, self.cycle, selected)
            for i in selected[adv]:
                params[int(i)] = srv.attack.corrupt(
                    params[int(i)], srv.global_params, cid=int(i),
                    seed=cfg.seed, round_idx=self.cycle)

        # mid-job dropout (the scenario failure model's Bernoulli channel;
        # the deadline channel has no meaning without a round barrier)
        p_drop = srv.pool.failures.dropout
        drop = (srv.rng.random(len(selected)) < p_drop if p_drop > 0
                else np.zeros(len(selected), bool))
        for j, i in enumerate(selected):
            i = int(i)
            dur = (barrier + float(sys.t_comm[i])
                   + float(sys.t_comp[i]) * plan.completion_epochs)
            en = (float(sys.e_comp[i]) * plan.probe_epochs * plan.has_probe
                  + float(sys.e_comm[i])
                  + float(sys.e_comp[i]) * plan.completion_epochs)
            fail_at = float(srv.rng.random() * dur) if drop[j] else np.inf
            loss_arr = losses.get(i, np.zeros(0))
            loss = loss_arr[-1] if len(loss_arr) else float(srv.last_loss[i])
            self._add_job(i, duration=dur, energy=en, params=params[i],
                          loss=loss, fail_at=fail_at, adversarial=bool(adv[j]))
        srv.telemetry.observe_selection(selected)   # = srv.selection_count
        self._last_observe = (ctx, probe_ids if plan.has_probe else None,
                              probe_states)
        self.cycle += 1
        # a wave that scheduled no work must not report progress, or the
        # loop would spin dispatching empty waves forever
        return len(selected) > 0 or len(probe_ids) > 0

    def _add_job(self, cid: int, *, duration: float, energy: float, params,
                 loss, fail_at: float, adversarial: bool = False) -> None:
        self.jobs.add(cid=cid, version=self.version, seq=self._seq,
                      cycle=self.cycle, duration=max(duration, _EPS),
                      energy=energy, fail_at=fail_at, now=self.now,
                      payload=(params, loss), adversarial=adversarial)
        self._busy[cid] = True
        if params is not None:
            self._upload_slots += 1
        self._seq += 1

    # ------------------------------------------------------------------
    # event loop
    # ------------------------------------------------------------------
    def _trans_time(self) -> Optional[float]:
        if self._next_trans is None:
            return None
        return (self._next_trans - self._start_round) * self.tick_s

    def _finish_group(self, slots: np.ndarray) -> None:
        """Retire one batch of due jobs (one ``_EPS`` instant, in dispatch
        ``seq`` order): charge energy per job in order, free devices and
        slots, then feed telemetry and the merge buffer with one vectorized
        call per kind (every cid in a batch is unique)."""
        jt, srv = self.jobs, self.srv
        drop_cids: List[int] = []
        comp: List[AsyncJob] = []
        for slot in slots:
            slot = int(slot)
            cid = int(jt.cid[slot])
            if jt.fail_at[slot] < jt.duration[slot]:  # mid-job dropout
                frac = float(jt.fail_at[slot]) / float(jt.duration[slot])
                self._charge(float(jt.energy[slot]) * frac)
                self._failed_since_agg.append(cid)
                drop_cids.append(cid)
                if jt.is_upload[slot]:
                    self._upload_slots -= 1
                self._busy[cid] = False
                jt.free(slot)
                continue
            self._charge(float(jt.energy[slot]))
            if not jt.is_upload[slot]:               # probe-only early exit
                self._busy[cid] = False
                jt.free(slot)
                continue
            # completions stay busy (and keep their slot) until MERGED
            params, loss = jt.payload[slot]
            comp.append(AsyncJob(
                cid=cid, version=int(jt.version[slot]),
                seq=int(jt.seq[slot]), cycle=int(jt.cycle[slot]),
                duration_s=float(jt.duration[slot]),
                energy_j=float(jt.energy[slot]), params=params,
                loss=float(loss), fail_at_s=float(jt.fail_at[slot]),
                dispatched_at=float(jt.dispatched_at[slot]),
                adversarial=bool(jt.adversarial[slot])))
            jt.free(slot)
        if drop_cids:
            srv.telemetry.observe_dropouts(np.asarray(drop_cids, np.int64))
        if comp:
            cids = np.asarray([j.cid for j in comp], np.int64)
            # active seconds only: pauses cost wall-clock, not device time
            srv.telemetry.observe_completions(
                cids, np.asarray([j.duration_s for j in comp]))
            srv.last_loss[cids] = [j.loss for j in comp]
            srv.loss_age[cids] = 0
            self.buffer.extend(comp)

    def _due_order(self, slots: np.ndarray) -> np.ndarray:
        """Due slots in the order the sequential loop retires them."""
        return slots[np.argsort(self.jobs.seq[slots], kind="stable")]

    def _step(self) -> bool:
        """Advance the clock past at least one event.  Returns False when no
        future event exists (the stall condition)."""
        if self.events_mode == "sequential":
            return self._step_sequential()
        return self._step_batched()

    def _step_sequential(self) -> bool:
        """Parity oracle: jump to the single next event instant and retire
        its due set."""
        end_abs = self.jobs.end_abs()
        t_next = float(end_abs.min()) if len(self.jobs) else np.inf
        t_trans = self._trans_time()
        if t_trans is not None:
            t_next = min(t_next, t_trans)
        if not np.isfinite(t_next):
            return False
        self.now = max(t_next, self.now)
        changed = self._sync_pool()
        due = np.flatnonzero(self.jobs.active & (end_abs <= self.now + _EPS))
        self._finish_group(self._due_order(due))
        self._events_since_merge += max(len(due), 1)
        if changed:
            self.jobs.apply_mask(self._mask, self.now)
        return True

    def _fill_need(self) -> np.ndarray:
        """Per merge unit, the completions left before its threshold fills
        (here one unit, the buffer); the batched window stops at the
        completion that fills a unit, since its merge changes the version
        and dispatch eligibility."""
        return np.asarray([self.buffer_size - len(self.buffer)])

    def _fill_unit_of(self, cids: np.ndarray) -> np.ndarray:
        """Merge-unit index of each completing device (here unit 0)."""
        return np.zeros(len(cids), np.int64)

    def _step_batched(self) -> bool:
        """Advance one event WINDOW: every job event before the next
        interesting one — a dropout or probe exit (frees a device or slot), a
        completion that fills the buffer (triggers a merge), or an
        availability transition — plus that event's own ``_EPS`` instant,
        group by group in the oracle's order.  A mask change ends the window
        early because it re-times every later event."""
        jt = self.jobs
        end_abs = jt.end_abs()
        t_trans = self._trans_time()
        slots = np.flatnonzero(np.isfinite(end_abs))
        if slots.size == 0 and t_trans is None:
            return False
        order = np.argsort(end_abs[slots], kind="stable")
        slots = slots[order]
        times = end_abs[slots]
        if t_trans is not None:
            # events inside the transition's instant batch with it
            ncap = int(np.searchsorted(times, t_trans + _EPS, side="right"))
            slots, times = slots[:ncap], times[:ncap]

        groups = event_groups(times)
        need = self._fill_need()
        filled = np.zeros_like(need)
        stop_g = len(groups) - 1
        interesting = False            # did a job event end the window?
        for gi, (i, j) in enumerate(groups):
            g = slots[i:j]
            is_drop = jt.fail_at[g] < jt.duration[g]
            is_probe = ~jt.is_upload[g]
            if bool((is_drop | is_probe).any()):
                stop_g, interesting = gi, True
                break
            np.add.at(filled, self._fill_unit_of(jt.cid[g]), 1)
            if bool((filled >= need).any()):
                stop_g, interesting = gi, True
                break

        hit_transition = False
        for gi in range(stop_g + 1):
            i, j = groups[gi]
            g = self._due_order(slots[i:j])
            self.now = max(float(times[i]), self.now)
            changed = self._sync_pool()
            self._finish_group(g)
            self._events_since_merge += j - i
            if changed:
                # the mask change pauses/resumes jobs: the window is stale
                self.jobs.apply_mask(self._mask, self.now)
                return True
            if t_trans is not None and times[i] >= t_trans - _EPS:
                hit_transition = True
        # when no job event stopped the window, the availability transition
        # is its edge: jump to it (a no-op transition costs this one probe)
        if not interesting and t_trans is not None and not hit_transition:
            self.now = max(t_trans, self.now)
            self._events_since_merge += 1
            if self._sync_pool():
                self.jobs.apply_mask(self._mask, self.now)
        return True

    def _charge(self, joules: float) -> None:
        self._energy_since_agg += joules
        self.srv._cum_energy += joules

    # ------------------------------------------------------------------
    # aggregation
    # ------------------------------------------------------------------
    def _ready(self) -> bool:
        """Whether a merge can fire now (the hierarchical engine folds full
        region buffers and gates on the root buffer)."""
        return len(self.buffer) >= self.buffer_size

    def _aggregate(self):
        from repro_torch.fl.server import RoundResult, paper_reward

        srv, cfg = self.srv, self.srv.cfg
        self.buffer.sort(key=lambda j: j.seq)
        take, self.buffer = (self.buffer[:self.buffer_size],
                             self.buffer[self.buffer_size:])
        lags = np.array([self.version - j.version for j in take])
        weights = [float(srv.data_sizes[j.cid]) for j in take]
        srv.telemetry.observe_staleness(
            np.array([j.cid for j in take], dtype=np.int64), lags)
        self.obs.metrics.observe("staleness", lags)
        srv.global_params = buffered_aggregate(
            srv.global_params, [j.params for j in take], weights, lags,
            kind=cfg.staleness, a=cfg.staleness_a, b=cfg.staleness_b,
            robust=cfg.aggregator, trim=cfg.agg_trim, f=cfg.agg_f,
            m_select=cfg.agg_m or None)
        self.version += 1
        for j in take:                   # merged: devices may work again
            self._busy[j.cid] = False
        self._upload_slots -= len(take)

        acc, test_loss = srv._evaluate()
        d_acc = acc - srv._last_acc
        srv._last_acc = acc
        r_t = self.now - self._last_agg_t
        r_e = self._energy_since_agg
        reward = paper_reward(d_acc, r_t, r_e, srv.t_budget, srv.e_budget,
                              cfg.alpha, cfg.beta)
        srv._cum_time = self._time_offset + self.now
        result = RoundResult(
            round=len(srv.history),
            selected=np.array([j.cid for j in take], dtype=np.int64),
            probe_set=np.empty(0, np.int64), acc=acc, test_loss=test_loss,
            r_t=r_t, r_e=r_e, d_acc=d_acc, reward=reward,
            cum_time=srv._cum_time, cum_energy=srv._cum_energy,
            failed=np.asarray(sorted(self._failed_since_agg), dtype=np.int64),
            adversaries=np.asarray(sorted(j.cid for j in take if j.adversarial),
                                   dtype=np.int64),
            n_available=int(self._mask.sum()),
            mean_staleness=float(lags.mean()), max_staleness=int(lags.max()),
            n_pending=len(self.jobs),
            executor=srv._executor_label)
        srv.history.append(result)
        srv.telemetry.observe_availability(self._mask)   # cadence-aligned
        srv.telemetry.observe_cadence(r_t)
        self._last_agg_t = self.now
        self._energy_since_agg = 0.0
        self._failed_since_agg = []
        # one observe per dispatch wave, consumed on use, so back-to-back
        # merges don't feed the same probe-state transition twice
        ctx, probe_ids, probe_states = self._last_observe
        if ctx is not None:
            self._last_observe = (None, None, None)
            self.policy.observe(ctx, result, probe_ids, probe_states)
        return result

    # ------------------------------------------------------------------
    def _stall_limit(self) -> int:
        """Events allowed between consecutive merges before the runaway
        backstop trips; each availability transition is real progress, so it
        extends the allowance."""
        return (100_000 + 10 * self.srv.cfg.n_devices
                + 1000 * self.buffer_size + 10 * self._trans_since_merge)

    def _flush_aggregation(self, res, verbose: bool) -> None:
        """Per-aggregation reporting: stamp host wall-time on the result,
        emit the structured round log line, and (when observing) flush the
        metrics window into one JSONL round record.  Pure recording: no RNG,
        no engine state beyond the host-time bookkeeping."""
        t = time.perf_counter()
        res.host_time_s = t - self._host_last
        self._host_last = t
        self.log.log("aggregation", force=verbose, policy=self.policy.name,
                     agg=res.round, acc=res.acc, t_virtual_s=res.cum_time,
                     energy_j=res.cum_energy, lag=res.mean_staleness,
                     pending=res.n_pending)
        obs = self.obs
        if not obs.enabled:
            return
        m = obs.metrics
        m.gauge("devices_online", res.n_available)
        m.gauge("buffer_fill", len(self.buffer))
        m.gauge("jobs_in_flight", len(self.jobs))
        m.gauge("upload_slots_used", self._slots_used())
        m.count("adversaries_merged", len(res.adversaries))
        m.count("dropouts", len(res.failed))
        for tier, lag in res.tier_staleness.items():
            m.gauge(f"tier_lag.{tier}", lag)
        self._merge_metrics(m)
        obs.flush_round(round=res.round, mode="async",
                        host_time_s=res.host_time_s, executor=res.executor,
                        virtual_time_s=self.now, r_t=res.r_t, acc=res.acc)

    def _merge_metrics(self, m) -> None:
        """Subclass hook: extra per-merge gauges (hierarchical buffers)."""

    def _stall(self, kind: str, message: str, done: int,
               aggregations: int) -> None:
        """Emit the stall diagnostics as a structured event through the
        recorder and logger, then raise :class:`AsyncStallError`."""
        fields = dict(t_virtual_s=self.now, jobs_in_flight=len(self.jobs),
                      buffer_fill=len(self.buffer),
                      events_since_merge=self._events_since_merge,
                      transitions_since_merge=self._trans_since_merge,
                      aggregations_done=done,
                      aggregations_target=aggregations)
        self.log.error(kind, **fields)
        raise AsyncStallError(message, **fields)

    def run(self, aggregations: int, verbose: bool = False):
        """Drive the event loop until ``aggregations`` buffer merges have
        been applied; returns the per-aggregation history slice."""
        srv, obs = self.srv, self.obs
        start = len(srv.history)
        done = 0
        self._host_last = time.perf_counter()
        while True:
            # 1. drain full buffers (a merge may free the model for the next
            #    wave, so this precedes dispatch)
            while done < aggregations:
                with obs.span("ready_check", clock=self._vclock):
                    ready = self._ready()
                if not ready:
                    break
                with obs.span("aggregate", clock=self._vclock):
                    res = self._aggregate()
                done += 1
                self._events_since_merge = 0
                self._trans_since_merge = 0
                self._flush_aggregation(res, verbose)
            if done >= aggregations:
                break
            # 2. fill free concurrency slots (loop back: there may be several
            #    waves' worth of idle devices)
            with obs.span("dispatch", clock=self._vclock):
                dispatched = self._dispatch()
            if dispatched:
                continue
            # 3. otherwise jump the clock to the next event window
            events_before = self._events_since_merge
            with obs.span("events", clock=self._vclock):
                stepped = self._step()
            if not stepped:
                self._stall(
                    "async-stall",
                    "async engine stalled: no running jobs, no dispatchable "
                    "devices and no future availability transition "
                    f"(t={self.now:.1f}s, {len(self.jobs)} paused jobs, "
                    f"{self._events_since_merge} events and "
                    f"{self._trans_since_merge} transitions since the last "
                    "merge)", done, aggregations)
            obs.metrics.observe("events_per_window",
                                self._events_since_merge - events_before)
            if self._events_since_merge > self._stall_limit():
                self._stall(
                    "async-backstop",
                    f"async engine exceeded {self._stall_limit()} events "
                    "without an aggregation "
                    f"({self._events_since_merge} events and "
                    f"{self._trans_since_merge} transitions since the last "
                    f"merge; {done}/{aggregations} aggregations, "
                    f"t={self.now:.1f}s, {len(self.jobs)} jobs in flight)",
                    done, aggregations)
        return srv.history[start:]
