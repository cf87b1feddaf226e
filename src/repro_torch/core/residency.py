"""Device-residency accounting for control-plane state.

``route_batch`` performs *zero* per-call host↔device transfer of learning
state: the bandit's sufficient statistics (``BanditState`` — tensors on
the router's device) and the k-means centroids (mirrored on the device by
``OnlineKMeans``) stay resident across batches, and the host numpy copies
are synchronized lazily, only when something actually reads them
(``state_dict``, the host reference path).

``TransferLedger`` is the bookkeeping that makes the convention
testable: every deliberate host→device upload or device→host download of
*persistent state* bumps a counter at the exact conversion site.  Steady
-state routing on the device path must leave both counters flat;
per-batch *data* movement — feature ids in, decisions out — is not state
and is never counted.
"""
from __future__ import annotations


class TransferLedger:
    """Counts deliberate host↔device transfers of persistent state."""

    __slots__ = ("h2d", "d2h")

    def __init__(self) -> None:
        self.h2d = 0
        self.d2h = 0

    def count_h2d(self, n: int = 1) -> None:
        self.h2d += n

    def count_d2h(self, n: int = 1) -> None:
        self.d2h += n

    def reset(self) -> None:
        self.h2d = 0
        self.d2h = 0

    def snapshot(self) -> dict:
        return {"h2d": self.h2d, "d2h": self.d2h}

    @property
    def total(self) -> int:
        return self.h2d + self.d2h

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"TransferLedger(h2d={self.h2d}, d2h={self.d2h})"
