"""Fleet controllers: the loops that turn live telemetry into fleet
actions (mirrors ``distkeras_tpu/serving/router/controller.py``).

* ``SLOBurnController``: a replica whose largest SLO burn rate exceeds
  ``drain_above`` stops taking traffic (``drain()``; its queued work is
  rebalanced onto the fleet) and resumes once its burn falls to
  ``resume_below``; ``min_serving`` replicas always serve.
* ``AutoscaleController``: sustained burn, a monotone rise of the
  fleet's queue depth or a shed grows the fleet (``add_replica``);
  sustained idleness shrinks it (``remove_replica``: drain, then retire).
  Sustain windows and cool-downs keep it from flapping; every decision
  is counted and recorded.
* ``ControllerChain`` ticks several from the router's one slot.

Wire one with ``router.attach_controller(ctl)`` (ticked every
``Router._CTL_EVERY`` steps) or call ``tick()`` on your own cadence.
Burn rates come from each replica's own ``SLOEngine``
(``ServingEngine(slo=[...])``). A tick reads host state only.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from distkeras_tpu_torch import obs
from distkeras_tpu_torch.obs.recorder import resolve_recorder
from distkeras_tpu_torch.obs.report import _detect_growth
from distkeras_tpu_torch.serving.router.replica import ReplicaState

__all__ = ["AutoscaleController", "ControllerChain", "SLOBurnController"]


class ControllerChain:
    """Drive several controllers from the router's single
    ``attach_controller`` slot, in construction order. Put the
    ``SLOBurnController`` before the ``AutoscaleController``: its
    drains land first, and the autoscaler's same-tick ``draining``
    guard then defers scale-down — drain-for-burn beats scale-down by
    construction."""

    def __init__(self, *controllers):
        self.controllers = list(controllers)

    def tick(self) -> Dict[str, str]:
        out: Dict[str, str] = {}
        for c in self.controllers:
            out.update(c.tick() or {})
        return out


class SLOBurnController:
    """Drain replicas whose max SLO burn rate exceeds ``drain_above``;
    resume them below ``resume_below`` (must be <= ``drain_above``).
    A burn rate of 1.0 means the error budget spends exactly as fast
    as it accrues, so the default 2.0 drains a replica burning at
    twice budget — the SRE-workbook "fast burn" alert shape."""

    def __init__(self, router, *, drain_above: float = 2.0,
                 resume_below: float = 1.0, min_serving: int = 1,
                 rebalance: bool = True):
        if drain_above <= 0:
            raise ValueError(
                f"drain_above must be > 0, got {drain_above}")
        if not 0 <= resume_below <= drain_above:
            raise ValueError(
                f"resume_below must be in [0, drain_above], got "
                f"{resume_below}")
        if min_serving < 1:
            raise ValueError(
                f"min_serving must be >= 1, got {min_serving}")
        self.router = router
        self.drain_above = float(drain_above)
        self.resume_below = float(resume_below)
        self.min_serving = int(min_serving)
        self.rebalance = bool(rebalance)
        self.recorder = resolve_recorder()
        reg = obs.get_registry()
        self._c_drain = reg.counter("router.slo_drains")
        self._c_resume = reg.counter("router.slo_resumes")
        #: replicas THIS controller drained (only these are auto-resumed
        #: — an operator's manual drain() is never overridden)
        self._drained: Dict[str, bool] = {}

    def tick(self) -> Dict[str, str]:
        """One control pass; returns ``{replica name: action}`` for the
        replicas acted on (``"drain"`` / ``"resume"``)."""
        actions: Dict[str, str] = {}
        # prune stale drain ownership: a replica an operator manually
        # resumed (or that died) is no longer "ours" — a LATER manual
        # drain() must stand instead of being auto-resumed against the
        # documented contract
        for name in list(self._drained):
            rep = next((r for r in self.router.replicas
                        if r.name == name), None)
            if rep is None or rep.state is not ReplicaState.DRAINING:
                self._drained.pop(name, None)
        serving = [r for r in self.router.replicas
                   if r.state is ReplicaState.SERVING]
        for r in list(serving):
            burn = r.slo_burn()
            if burn is None or burn <= self.drain_above:
                continue
            if len(serving) - 1 < self.min_serving:
                break                 # never drain below the floor
            r.drain()
            serving.remove(r)
            self._drained[r.name] = True
            self._c_drain.inc(replica=r.name)
            actions[r.name] = "drain"
            if self.recorder.enabled:
                self.recorder.record(
                    "router.slo_drain", replica=r.name,
                    burn_rate=round(burn, 4),
                    threshold=self.drain_above)
            if self.rebalance:
                self.router.rebalance_queued(r)
        for r in self.router.replicas:
            if r.state is not ReplicaState.DRAINING \
                    or not self._drained.get(r.name) \
                    or r.retiring:
                # a retiring replica is leaving the fleet (scale-down /
                # remove_replica): resuming it would race the retire
                # sweep — one replica cannot be both drained and retired
                continue
            burn = self._recovered_burn(r)
            if burn is not None and burn > self.resume_below:
                continue
            r.resume()
            self._drained.pop(r.name, None)
            self._c_resume.inc(replica=r.name)
            actions[r.name] = "resume"
            if self.recorder.enabled:
                self.recorder.record(
                    "router.slo_resume", replica=r.name,
                    burn_rate=None if burn is None else round(burn, 4))
        return actions

    def _recovered_burn(self, replica) -> Optional[float]:
        """Burn rate used for the resume decision. The metrics window
        that breached keeps its bad samples forever (reservoirs are
        windowless), so operators typically swap a fresh
        ``ServingMetrics`` window per reporting interval — with the old
        window still attached the replica simply resumes once the
        breach samples age out of a swapped window or the burn math
        recovers."""
        return replica.slo_burn()


class AutoscaleController:
    """Closed-loop fleet sizing: live saturation signals in,
    ``Router.add_replica``/``remove_replica`` out.

    One ``tick()`` (wire with ``router.attach_controller`` or compose
    under a multiplexer with ``SLOBurnController``) evaluates three
    scale-up signals over the SERVING, non-retiring fleet —

    * **SLO burn**: any replica's live max burn rate (side-effect-free
      ``slo_burn()``) above ``scale_up_burn``;
    * **queue growth**: the fleet-total queue depth sampled every tick
      shows a sustained monotone rise (the exact
      ``obs.report._detect_growth`` predicate the post-hoc saturation
      panel uses, evaluated live over the controller's own window);
    * **shed onset**: the router rejected a request since the last tick
      (fleet-wide shed — every replica refused).

    A signal must persist for ``up_sustain`` consecutive ticks before a
    scale-up fires (``factory()`` → ``add_replica``); a whole-fleet
    idle reading (zero queued, zero occupied) must persist for
    ``idle_sustain`` ticks before a scale-down retires one replica,
    preferring the replicas this controller added (LIFO) so the fleet
    relaxes back to its seed shape. After any action the controller
    holds for ``cooldown`` ticks. ``min_serving``/``max_replicas``
    bound the fleet; an action wanted but denied (bounds, cooldown, or
    a drain-for-burn in progress — drain beats scale-down, one replica
    is never both drained and retired) is counted and ring-recorded as
    ``blocked``. DEAD replicas are garbage-collected through
    ``remove_replica`` every tick.

    Determinism: decisions depend only on tick-ordered fleet state —
    no wall clock — and each one is appended to ``decisions`` stamped
    with the router step, so a seeded replay reproduces the decision
    log byte-identically. Counters: ``autoscale.scale_up`` /
    ``autoscale.scale_down`` / ``autoscale.blocked``.
    """

    #: queue-depth samples kept for the growth predicate
    _QWINDOW = 16

    def __init__(self, router, factory, *, min_serving: int = 1,
                 max_replicas: int = 4, scale_up_burn: float = 2.0,
                 up_sustain: int = 2, idle_sustain: int = 4,
                 cooldown: int = 4, growth_min_run: int = 3,
                 growth_min_rise: float = 1.0,
                 burn_controller: Optional[SLOBurnController] = None,
                 gc_dead: bool = True):
        if min_serving < 1:
            raise ValueError(
                f"min_serving must be >= 1, got {min_serving}")
        if max_replicas < min_serving:
            raise ValueError(
                f"max_replicas ({max_replicas}) must be >= "
                f"min_serving ({min_serving})")
        if up_sustain < 1 or idle_sustain < 1:
            raise ValueError("sustain windows must be >= 1")
        self.router = router
        self.factory = factory
        self.min_serving = int(min_serving)
        self.max_replicas = int(max_replicas)
        self.scale_up_burn = float(scale_up_burn)
        self.up_sustain = int(up_sustain)
        self.idle_sustain = int(idle_sustain)
        self.cooldown = int(cooldown)
        self.growth_min_run = int(growth_min_run)
        self.growth_min_rise = float(growth_min_rise)
        self.burn_controller = burn_controller
        self.gc_dead = bool(gc_dead)
        self.recorder = resolve_recorder()
        reg = obs.get_registry()
        self._c_up = reg.counter("autoscale.scale_up")
        self._c_down = reg.counter("autoscale.scale_down")
        self._c_blocked = reg.counter("autoscale.blocked")
        #: decision log: dicts with step/action/replica/reason —
        #: deterministic under the virtual clock (replay's oracle)
        self.decisions: List[Dict] = []
        self._qhist: List[float] = []
        self._ticks = 0
        self._cool_until = 0
        self._up_streak = 0
        self._idle_streak = 0
        self._last_shed = router.counters().get("rejected", 0)
        #: names this controller added, LIFO scale-down preference
        self._added: List[str] = []

    # -- signal plumbing ---------------------------------------------------

    def _serving(self):
        return [r for r in self.router.replicas
                if r.state is ReplicaState.SERVING and not r.retiring]

    def _live_size(self) -> int:
        """Replicas that count against ``max_replicas``: everything
        not dead and not on its way out."""
        return sum(1 for r in self.router.replicas
                   if r.state is not ReplicaState.DEAD
                   and not r.retiring)

    def signals(self) -> Dict:
        """The live saturation read (also handy for dashboards): burn,
        queue-growth and shed-onset inputs plus the raw numbers they
        came from. Pure observation — no fleet mutation."""
        serving = self._serving()
        burns = [b for b in (r.slo_burn() for r in serving)
                 if b is not None]
        burn = max(burns, default=None)
        qd = float(sum(r.queue_depth for r in serving))
        occ = sum(r.occupied for r in serving)
        shed_now = self.router.counters().get("rejected", 0)
        shed_delta = shed_now - self._last_shed
        growth = _detect_growth(self._qhist + [qd],
                                min_run=self.growth_min_run,
                                min_rise=self.growth_min_rise)
        return {
            "burn": burn, "queue_depth": qd, "occupied": occ,
            "shed_delta": shed_delta, "queue_growth": growth,
            "overload": ((burn is not None and burn > self.scale_up_burn)
                         or shed_delta > 0 or growth),
            "idle": qd == 0 and occ == 0,
        }

    # -- the control pass --------------------------------------------------

    def tick(self) -> Dict[str, str]:
        """One control pass; returns ``{replica name: action}`` for
        fleet mutations made (``"add"`` / ``"remove"`` / ``"gc"``)."""
        actions: Dict[str, str] = {}
        router = self.router
        if self.gc_dead:
            for rep in list(router.replicas):
                if rep.state is ReplicaState.DEAD and not rep.retiring:
                    router.remove_replica(rep.name)
                    self._decide("gc", rep.name, "dead")
                    actions[rep.name] = "gc"
        sig = self.signals()
        self._last_shed = router.counters().get("rejected", 0)
        self._qhist.append(sig["queue_depth"])
        if len(self._qhist) > self._QWINDOW:
            del self._qhist[:len(self._qhist) - self._QWINDOW]
        self._up_streak = self._up_streak + 1 if sig["overload"] else 0
        self._idle_streak = self._idle_streak + 1 if sig["idle"] else 0
        self._ticks += 1
        if self._up_streak >= self.up_sustain:
            self._scale_up(sig, actions)
        elif self._idle_streak >= self.idle_sustain:
            self._scale_down(sig, actions)
        return actions

    def _reason(self, sig: Dict) -> str:
        if sig["burn"] is not None and sig["burn"] > self.scale_up_burn:
            return f"burn:{sig['burn']:.2f}"
        if sig["shed_delta"] > 0:
            return f"shed:{sig['shed_delta']}"
        if sig["queue_growth"]:
            return "queue_growth"
        return "idle"

    def _decide(self, action: str, replica: Optional[str],
                reason: str) -> None:
        self.decisions.append({
            "step": self.router._steps, "tick": self._ticks,
            "action": action, "replica": replica, "reason": reason})
        if self.recorder.enabled:
            self.recorder.record(
                "autoscale.decision", action=action, replica=replica,
                reason=reason, fleet=len(self.router.replicas))

    def _blocked(self, wanted: str, reason: str) -> None:
        self._c_blocked.inc()
        self._decide("blocked", None, f"{wanted}:{reason}")
        # re-arm: the sustain window must refill before the next
        # attempt, so a standing blocker yields a bounded decision log
        # instead of one blocked entry per tick
        self._up_streak = 0
        self._idle_streak = 0

    def _scale_up(self, sig: Dict, actions: Dict[str, str]) -> None:
        reason = self._reason(sig)
        if self._ticks < self._cool_until:
            self._blocked("scale_up", "cooldown")
            return
        if self._live_size() >= self.max_replicas:
            self._blocked("scale_up", "max_replicas")
            return
        rep = self.router.add_replica(self.factory)
        self._added.append(rep.name)
        self._c_up.inc(replica=rep.name)
        self._decide("scale_up", rep.name, reason)
        actions[rep.name] = "add"
        self._up_streak = 0
        self._idle_streak = 0
        self._cool_until = self._ticks + self.cooldown

    def _scale_down(self, sig: Dict, actions: Dict[str, str]) -> None:
        if self._ticks < self._cool_until:
            self._blocked("scale_down", "cooldown")
            return
        serving = self._serving()
        if len(serving) <= self.min_serving:
            self._blocked("scale_down", "min_serving")
            return
        if any(r.state is ReplicaState.DRAINING and not r.retiring
               for r in self.router.replicas):
            # drain-for-burn in progress: the burn controller owns that
            # replica's fate (resume or operator removal) — shrinking
            # the serving pool underneath it double-counts the same
            # pressure relief
            self._blocked("scale_down", "draining")
            return
        victim = None
        names = {r.name: r for r in serving}
        for name in reversed(self._added):        # LIFO: newest first
            if name in names:
                victim = names[name]
                break
        if victim is None:
            # no controller-added replica left: deterministic fallback,
            # lexicographically last name (stable across replays)
            victim = max(serving, key=lambda r: r.name)
        self.router.remove_replica(victim.name)
        if victim.name in self._added:
            self._added.remove(victim.name)
        self._c_down.inc(replica=victim.name)
        self._decide("scale_down", victim.name, "idle")
        actions[victim.name] = "remove"
        self._up_streak = 0
        self._idle_streak = 0
        self._cool_until = self._ticks + self.cooldown

    def counts(self) -> Dict[str, int]:
        """Plain decision totals for bench JSON (the registry carries
        the same series for exporters)."""
        out = {"scale_up": 0, "scale_down": 0, "blocked": 0, "gc": 0}
        for d in self.decisions:
            out[d["action"]] = out.get(d["action"], 0) + 1
        return out
