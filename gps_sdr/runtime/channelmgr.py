"""Channel selection and slot assignment policy.

Replaces the reference's worker-pool placement logic (getNewSats,
src/gpsrecv.py:423-440, and the poolWorker table, gpsrecv.py:358-401):
satellites with positive 60 s/1 s correlation quality are kept; the
remaining slots are filled from acquisition results in descending
correlation strength.  Channel "processes" are just slots in the
vmapped state pytree — add/remove is a slot reset, not process
lifecycle.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from gps_sdr.config import ReceiverConfig


def select_sats(active: set[int], found_sats: list, corr_quality: dict,
                max_sat: int) -> tuple[set[int], set[int]]:
    """(to_remove, to_add) given acquisition results and per-sat
    (corr_q, corr_l) quality.  found_sats: [(corr, prn, freq, delay)]
    sorted descending."""
    good = {prn for prn, (q, l) in corr_quality.items() if q > 0 or l > 0}
    candidates = [f for f in found_sats if f[1] not in good]
    target = good | {f[1] for f in candidates[:max_sat - len(good)]}
    common = active & target
    return active - common, target - common


@dataclass
class SlotTable:
    """PRN <-> channel-slot bookkeeping (poolWorker equivalent)."""

    n_slots: int
    slot_prn: list = field(default_factory=list)   # 0 = free

    def __post_init__(self):
        if not self.slot_prn:
            self.slot_prn = [0] * self.n_slots

    def slot_of(self, prn: int) -> int:
        return self.slot_prn.index(prn)

    def free(self, prn: int) -> int:
        slot = self.slot_of(prn)
        self.slot_prn[slot] = 0
        return slot

    def assign(self, prn: int) -> int:
        slot = self.slot_prn.index(0)
        self.slot_prn[slot] = prn
        return slot

    @property
    def active(self) -> set[int]:
        return {p for p in self.slot_prn if p != 0}


def make_config_check(cfg: ReceiverConfig):
    assert cfg.max_sat >= 1
