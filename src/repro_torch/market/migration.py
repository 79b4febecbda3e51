"""Hysteresis migration advisor: move a running fleet only when it pays.

A submission is a green-field decision; a *running* fleet is not — moving
it costs real money (drain + dual-running during cutover) and a spot
price that dips for one tick will dip back.  ``should_migrate`` therefore
demands that the projected savings over a planning horizon beat the
switch cost by a hysteresis margin before advising a move (DESIGN.md §6).

The cost model: ``mean_norm_cost`` is the fleet's ×-optimal cost factor
for its class, so retargeting from the current config to the ranking's
winner scales the fleet's spend rate by ``mnc(best) / mnc(current)`` at
constant throughput.  Savings are quoted off the current fleet's $/h
under *current* prices (callers with a live price source re-price the
current config and pass it in); the switch itself is priced as
``switch_cost_hours`` of dual-running (old fleet drains while the new
one warms).
"""
from __future__ import annotations

import dataclasses
from typing import Hashable, Optional, Sequence

from repro_torch.selector import Decision, RankedConfig


@dataclasses.dataclass(frozen=True)
class MigrationAdvice:
    """The advisor's verdict for one (placement, ranking) pair."""

    migrate: bool
    current_config_id: Hashable
    target_config_id: Hashable
    saving_per_hour: float      # projected $/h saved after the move
    switch_cost_usd: float      # one-off cost of moving
    horizon_hours: float
    reason: str

    @property
    def net_saving_usd(self) -> float:
        return self.saving_per_hour * self.horizon_hours \
            - self.switch_cost_usd


def should_migrate(current_placement: Decision,
                   ranking: Sequence[RankedConfig],
                   switch_cost_hours: float, *,
                   horizon_hours: float = 24.0,
                   hysteresis: float = 1.25,
                   current_hourly_cost: Optional[float] = None
                   ) -> MigrationAdvice:
    """Advise whether a running fleet should move to the ranking's winner.

    ``hysteresis`` > 1 demands the projected horizon savings exceed the
    switch cost by that margin — the damper that keeps a fleet from
    ping-ponging between two near-equal configs on every price wiggle.

    ``current_hourly_cost`` is the fleet's $/h *under current prices*;
    callers holding a live price source should re-price the current
    config and pass it (as
    :func:`repro_torch.serve.engine.plan_decode_placement` does) so the quoted dollar figures track the market.  It defaults to
    the rate stamped on ``current_placement``, which may predate any
    number of price moves.
    """
    if not ranking:
        raise ValueError("empty ranking")
    if switch_cost_hours < 0 or horizon_hours <= 0 or hysteresis <= 0:
        raise ValueError("switch_cost_hours must be >= 0, horizon_hours "
                         "and hysteresis > 0")
    current_id = current_placement.config_id
    best = ranking[0]
    rate = current_hourly_cost if current_hourly_cost is not None \
        else current_placement.hourly_cost
    if not rate > 0:
        raise ValueError(f"non-positive current hourly cost {rate!r}")
    switch_cost = switch_cost_hours * rate

    if best.config_id == current_id:
        return MigrationAdvice(
            False, current_id, current_id, 0.0, switch_cost, horizon_hours,
            "current placement is already the ranking winner")

    current_rank: Optional[RankedConfig] = next(
        (r for r in ranking if r.config_id == current_id), None)
    if current_rank is None or \
            current_rank.mean_norm_cost == float("inf"):
        # the fleet sits on something the selector can no longer rank
        # (deprovisioned entry, trace rebuilt) — always move
        return MigrationAdvice(
            True, current_id, best.config_id, 0.0, switch_cost,
            horizon_hours, "current placement is no longer rankable")

    ratio = best.mean_norm_cost / current_rank.mean_norm_cost
    saving_per_hour = rate * (1.0 - ratio)
    if saving_per_hour * horizon_hours > hysteresis * switch_cost:
        return MigrationAdvice(
            True, current_id, best.config_id, saving_per_hour, switch_cost,
            horizon_hours,
            f"projected {saving_per_hour * horizon_hours:.2f} USD over "
            f"{horizon_hours:g} h beats {hysteresis:g}x switch cost "
            f"{switch_cost:.2f} USD")
    return MigrationAdvice(
        False, current_id, best.config_id, saving_per_hour, switch_cost,
        horizon_hours,
        f"projected {saving_per_hour * horizon_hours:.2f} USD over "
        f"{horizon_hours:g} h does not beat {hysteresis:g}x switch cost "
        f"{switch_cost:.2f} USD")
