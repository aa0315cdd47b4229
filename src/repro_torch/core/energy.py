"""Energy / delay accounting model (Fig. 6).

The paper evaluates the *total* energy and wall-clock delay incurred to
reach a target accuracy, under ratios E_D2D/E_Glob and Delta_D2D/
Delta_Glob. Uplink reference: 24 dBm transmit power for 0.25 s per
upload [17] -> E_Glob = P_tx * Delta_Glob per device upload.

We count events, then price them:

  uplinks   : devices transmitting model -> server at a global agg
  downlink  : server broadcast (free for devices, counted separately)
  d2d_msgs  : one per (device, neighbour) per consensus round
"""
from __future__ import annotations

from dataclasses import dataclass, field


DBM24_WATTS = 10 ** ((24 - 30) / 10)      # 24 dBm ~ 0.251 W
DELTA_GLOB_S = 0.25                        # per-upload delay [17]
E_GLOB_J = DBM24_WATTS * DELTA_GLOB_S      # Joules per uplink transmission


@dataclass
class CommLedger:
    """Counts communication events during a run.

    Straggler accounting (``repro.netsim``): the two ``straggler_*``
    fields accumulate EXTRA uplink-equivalents / round-equivalents of
    tail latency beyond the baseline — a consensus round at tail
    multiplier m adds (m - 1) round-equivalents, an uplink from a
    straggling device adds (m - 1) uplink-equivalents. They stay 0
    without dynamics, so historical energy/delay numbers are unchanged.
    Stragglers are slow, not chatty: the tail stretches ``delay`` but
    moves no extra bits, so ``energy`` is untouched.
    """
    uplinks: int = 0
    broadcasts: int = 0
    d2d_msgs: int = 0
    d2d_rounds: int = 0
    local_steps: int = 0
    straggler_uplink_extra: float = 0.0   # uplink-equivalents of tail delay
    straggler_round_extra: float = 0.0    # D2D-round-equivalents
    # level-tagged uplink accounting (repro.hierarchy): tier 1 counts
    # device -> fog uploads, tier l >= 2 counts fog -> fog relays.
    # ``uplinks`` stays the total over all tiers, so flat runs are
    # unchanged and energy/delay keep pricing every transmitted model.
    uplinks_by_level: dict = field(default_factory=dict)
    # per-event attribution (repro.obs, DESIGN.md §13): every record_*
    # call appends rows {"kind", "event", ...} so the totals above can
    # be decomposed per cluster / per level / per event after the run.
    # Attribution never feeds pricing — energy()/delay() read only the
    # counters — and checkpoints persist the counters, not the rows.
    events: list = field(default_factory=list)
    _event_idx: int = 0

    def next_event(self) -> int:
        """Advance the attribution event index (one logical comms
        event: a consensus event, an aggregation, an interval).
        Returns the new index; rows recorded after this call carry it."""
        self._event_idx += 1
        return self._event_idx

    def record_uplinks(self, n: int, level: int = 1,
                       uplink_delay_mults=None) -> None:
        """Count ``n`` model uploads entering a tier-``level``
        aggregate (no broadcast implied — fog tiers relay upward)."""
        self.uplinks += n
        self.uplinks_by_level[level] = \
            self.uplinks_by_level.get(level, 0) + n
        self.events.append({"kind": "uplink", "event": self._event_idx,
                            "level": int(level), "n": int(n)})
        if uplink_delay_mults is not None:
            for m in uplink_delay_mults:
                self.straggler_uplink_extra += max(float(m) - 1.0, 0.0)

    def record_aggregation(self, devices_sampled: int,
                           uplink_delay_mults=None,
                           level: int = 1) -> None:
        """``uplink_delay_mults``: per-sampled-device tail multipliers
        (>= 1); each uplink pays its own device's multiplier."""
        self.record_uplinks(devices_sampled, level, uplink_delay_mults)
        self.broadcasts += 1
        self.events.append({"kind": "broadcast",
                            "event": self._event_idx, "n": 1})

    def record_hierarchy_event(self, uplinks_by_level: dict,
                               uplink_delay_mults=None) -> None:
        """One multi-level aggregation event: tier-1 device uploads
        (one broadcast, straggler multipliers apply) plus the fog ->
        fog relays of every deeper tier. Shared by both trainers so
        sim and scale mode cannot diverge on hierarchy pricing."""
        for level in sorted(uplinks_by_level):
            if level == 1:
                self.record_aggregation(uplinks_by_level[1],
                                        uplink_delay_mults, level=1)
            else:
                self.record_uplinks(uplinks_by_level[level], level=level)

    def record_consensus(self, rounds_per_cluster, edges_per_cluster,
                         tail_mult_per_cluster=None) -> None:
        """rounds/edges: iterables over clusters. ``tail_mult_per_
        cluster``: the slowest active participant's multiplier — every
        round in that cluster completes at the tail's pace."""
        rounds = list(rounds_per_cluster)
        edges = list(edges_per_cluster)
        n = len(rounds)
        for i, (g, e) in enumerate(zip(rounds, edges)):
            self.d2d_rounds += int(g)
            self.d2d_msgs += int(g) * 2 * int(e)   # bidirectional
            if int(g):
                # position within one event's per-cluster vector; a
                # caller replaying repeats must call once per repeat
                # (Billing.charge does) so i stays the cluster index
                self.events.append({
                    "kind": "consensus", "event": self._event_idx,
                    "cluster": i % max(n, 1), "rounds": int(g),
                    "msgs": int(g) * 2 * int(e)})
            if tail_mult_per_cluster is not None:
                mult = float(tail_mult_per_cluster[i])
                self.straggler_round_extra += int(g) * max(mult - 1.0, 0.0)

    def record_local_step(self, devices: int = 1) -> None:
        self.local_steps += devices

    # -- attribution queries (repro.obs) ------------------------------------
    def d2d_by_cluster(self) -> dict[int, dict[str, int]]:
        """{cluster: {rounds, msgs}} summed over every consensus row."""
        out: dict[int, dict[str, int]] = {}
        for ev in self.events:
            if ev["kind"] != "consensus":
                continue
            d = out.setdefault(ev["cluster"], {"rounds": 0, "msgs": 0})
            d["rounds"] += ev["rounds"]
            d["msgs"] += ev["msgs"]
        return out

    def uplinks_by_event(self) -> dict[int, int]:
        out: dict[int, int] = {}
        for ev in self.events:
            if ev["kind"] == "uplink":
                out[ev["event"]] = out.get(ev["event"], 0) + ev["n"]
        return out

    def attribution_totals(self) -> dict:
        """Recompute the headline counters from the attribution rows —
        tests assert these equal the counters the pricing reads."""
        up = sum(e["n"] for e in self.events if e["kind"] == "uplink")
        bc = sum(e["n"] for e in self.events if e["kind"] == "broadcast")
        msgs = sum(e["msgs"] for e in self.events
                   if e["kind"] == "consensus")
        rounds = sum(e["rounds"] for e in self.events
                     if e["kind"] == "consensus")
        by_level: dict[int, int] = {}
        for e in self.events:
            if e["kind"] == "uplink":
                by_level[e["level"]] = by_level.get(e["level"], 0) + e["n"]
        return {"uplinks": up, "broadcasts": bc, "d2d_msgs": msgs,
                "d2d_rounds": rounds, "uplinks_by_level": by_level}

    def attribution_since(self, idx: int) -> list[dict]:
        """Rows appended after ``idx`` (= a previous ``len(events)``) —
        the per-round comms delta the telemetry stream records."""
        return self.events[idx:]

    # -- pricing ------------------------------------------------------------
    def energy(self, e_ratio: float, e_glob: float = E_GLOB_J) -> float:
        """Total J given E_D2D = e_ratio * E_Glob."""
        return self.uplinks * e_glob + self.d2d_msgs * e_ratio * e_glob

    def delay(self, d_ratio: float, delta_glob: float = DELTA_GLOB_S,
              sequential_uplinks: bool = True) -> float:
        """Total seconds given Delta_D2D = d_ratio * Delta_Glob.

        Uplinks are sequential per aggregation (the scarce-uplink premise);
        D2D rounds within a cluster run in parallel across devices but
        rounds are sequential. Straggler tails stretch both terms.
        """
        up = self.uplinks if sequential_uplinks else self.broadcasts
        up = up + self.straggler_uplink_extra
        rounds = self.d2d_rounds + self.straggler_round_extra
        return up * delta_glob + rounds * d_ratio * delta_glob
