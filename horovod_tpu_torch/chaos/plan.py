"""Seeded chaos plans: the deterministic schedule half of the harness.
The port's own copy of ``horovod_tpu/chaos/plan.py``: the same spec gives
the byte-identical schedule in both packages.

A plan is a list of :class:`Injection`\\ s — *when* (seconds since the
monkey started), *what* (``sigterm`` / ``sigkill`` / ``stall`` /
``slow_disk``, or the host-granularity ``host_sigterm`` /
``host_sigkill``), *whom* (a rank draw the injector maps onto the live
processes — or, for host kinds, onto the live *hosts* — with a modulo,
so the plan does not need to know np), and for
the pausing kinds, *how long*. Everything is derived from one
``random.Random(seed)``: the same spec always produces byte-identical
schedules, which is what makes a chaos soak reproducible and a
goodput-under-churn bench comparable across runs.

Spec syntax (``hvdrun --chaos=<spec>``): either a path to a JSON file
(``{"seed": 7, "interval": 5, ...}`` or a pre-expanded
``{"injections": [...]}``), or an inline ``key=value`` comma list::

    --chaos "seed=7,interval=2.5,kinds=sigterm+sigkill,count=6"

Keys: ``seed`` (int, default 0), ``interval`` (mean seconds between
injections, default 5), ``jitter`` (0..1 fraction of interval, default
0.5), ``kinds`` (``+``-separated subset of the kinds above, default
``sigterm``), ``count`` (default 8), ``duration`` (stall/slow-disk
seconds, default 2).
"""

import dataclasses
import json
import os
import random

KINDS = ("sigterm", "sigkill", "stall", "slow_disk",
         # host granularity: the draw picks a HOST and every rank on
         # it gets the signal — a spot eviction (host_sigterm) or
         # outright loss (host_sigkill) of a whole machine, which is
         # how preemption actually arrives on multi-host clusters
         "host_sigterm", "host_sigkill")

_DEFAULTS = {"seed": 0, "interval": 5.0, "jitter": 0.5,
             "kinds": ("sigterm",), "count": 8, "duration": 2.0}

# the raw rank draw's range; the injector maps it onto live processes
# with a modulo (plans are np-agnostic)
_RANK_DRAW = 1 << 16


@dataclasses.dataclass(frozen=True)
class Injection:
    """One scheduled fault."""

    at: float           # seconds after the monkey starts
    kind: str           # one of KINDS
    rank: int           # raw draw; target = rank % len(live processes)
    duration: float = 0.0   # stall / slow_disk only

    def as_dict(self):
        return dataclasses.asdict(self)


class ChaosPlan:
    """An immutable, seeded injection schedule."""

    def __init__(self, injections, spec=None):
        self.injections = tuple(sorted(injections, key=lambda i: i.at))
        self.spec = spec
        for inj in self.injections:
            if inj.kind not in KINDS:
                raise ValueError(
                    f"chaos: unknown injection kind {inj.kind!r} "
                    f"(expected one of {KINDS})")

    @classmethod
    def generate(cls, seed=0, interval=5.0, jitter=0.5, kinds=("sigterm",),
                 count=8, duration=2.0, spec=None):
        """Expand knobs into a schedule with one ``random.Random(seed)``
        — fully deterministic per (seed, knobs)."""
        kinds = tuple(kinds)
        for k in kinds:
            if k not in KINDS:
                raise ValueError(f"chaos: unknown kind {k!r} "
                                 f"(expected one of {KINDS})")
        if interval <= 0:
            raise ValueError("chaos: interval must be > 0")
        if not 0 <= jitter <= 1:
            raise ValueError("chaos: jitter must be in [0, 1]")
        rng = random.Random(seed)
        injections = []
        t = 0.0
        for _ in range(max(0, int(count))):
            t += interval * (1.0 + jitter * (2.0 * rng.random() - 1.0))
            kind = rng.choice(kinds)
            injections.append(Injection(
                at=round(t, 6), kind=kind, rank=rng.randrange(_RANK_DRAW),
                duration=float(duration) if kind in ("stall", "slow_disk")
                else 0.0))
        return cls(injections, spec=spec)

    def describe(self):
        kinds = sorted({i.kind for i in self.injections})
        last = self.injections[-1].at if self.injections else 0.0
        return (f"{len(self.injections)} injection(s) of {kinds} "
                f"over {last:.1f}s"
                + (f" [{self.spec}]" if self.spec else ""))

    def as_dict(self):
        return {"injections": [i.as_dict() for i in self.injections],
                "spec": self.spec}


def _parse_inline(spec):
    knobs = dict(_DEFAULTS)
    for item in spec.split(","):
        item = item.strip()
        if not item:
            continue
        if "=" not in item:
            raise ValueError(f"chaos: expected key=value, got {item!r}")
        key, _, val = item.partition("=")
        key = key.strip()
        val = val.strip()
        if key not in _DEFAULTS:
            raise ValueError(
                f"chaos: unknown spec key {key!r} "
                f"(expected one of {sorted(_DEFAULTS)})")
        try:
            if key in ("seed", "count"):
                knobs[key] = int(val)
            elif key == "kinds":
                knobs[key] = tuple(k for k in val.split("+") if k)
            else:
                knobs[key] = float(val)
        except ValueError as e:
            raise ValueError(f"chaos: bad value for {key}: {val!r}") from e
    return knobs


def parse_spec(spec):
    """``--chaos`` spec -> :class:`ChaosPlan` (module docstring syntax).
    Raises ``ValueError`` on anything malformed, so the CLI can reject
    the flag before launching workers."""
    if not spec or not str(spec).strip():
        raise ValueError("chaos: empty spec")
    spec = str(spec).strip()
    if os.path.isfile(spec):
        with open(spec) as f:
            try:
                data = json.load(f)
            except ValueError as e:
                raise ValueError(f"chaos: {spec} is not valid JSON: {e}") \
                    from e
        if not isinstance(data, dict):
            raise ValueError(f"chaos: {spec} must hold a JSON object")
        if "injections" in data:
            injections = [Injection(
                at=float(i["at"]), kind=str(i["kind"]),
                rank=int(i.get("rank", 0)),
                duration=float(i.get("duration", 0.0)))
                for i in data["injections"]]
            return ChaosPlan(injections, spec=spec)
        knobs = dict(_DEFAULTS)
        for key, val in data.items():
            if key not in _DEFAULTS:
                raise ValueError(f"chaos: unknown spec key {key!r} in "
                                 f"{spec}")
            knobs[key] = tuple(val) if key == "kinds" else val
        return ChaosPlan.generate(spec=spec, **knobs)
    return ChaosPlan.generate(spec=spec, **_parse_inline(spec))
