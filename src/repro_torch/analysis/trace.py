"""The port's program text: a plan's kernels, collectives and steps, as it
runs them.

The JAX package reads a plan's program from its lowered StableHLO
(`repro.analysis.hlo`).  PyTorch runs eagerly and emits no StableHLO, so the
port has no counterpart of that parser.  It records the program instead:
`FactorizationPlan.lowered_text("trace")` runs the plan once, on a
deterministic input of its shape on its own device, under `recording()`, and
returns one JSON line per event:

- `{"ev": "kernel", "name", "body", "shapes", "dtypes"}`: a kernel-wrapper
  call, with the body its launch took (the wrapper's `.mode`; "cpu" for the
  plain version on CPU tensors);
- `{"ev": "all_reduce" | "broadcast", "site", "axes", "ranks", "shape",
  "dtype", "bytes", "root"}`: a collective this rank issued, with the
  schedule's call site, the group's ranks and the payload;
- `{"ev": "step", "t"}`: the boundary before step t of a hot loop.

`analyze_trace` turns the text into wire bytes per device (ring all-reduce
2 S (g - 1) / g per member, a broadcast's payload per member), the
collective sites in order and the launches per kernel.

One recorder is active at a time, process-wide: the hooks in
`core/collectives.py`, the kernel wrappers and the step loops read
`collectives.RECORDER`, and cost one `is None` test when it is None.
"""

from __future__ import annotations

import contextlib
import json
import threading

from repro_torch.core import collectives

_lock = threading.Lock()


class Recorder:
    """The events of one recording, in the order they happened."""

    def __init__(self):
        self.events: list[dict] = []

    def kernel(self, *, name: str, body: str, shapes: list, dtypes: list) -> None:
        self.events.append({"ev": "kernel", "name": name, "body": body, "shapes": shapes,
                            "dtypes": dtypes})

    def collective(self, *, kind: str, site: str, axes: list, ranks: list, shape: list,
                   dtype: str, nbytes: int, root) -> None:
        self.events.append({"ev": kind, "site": site, "axes": axes, "ranks": ranks,
                            "shape": shape, "dtype": dtype, "bytes": nbytes, "root": root})

    def step(self, t: int) -> None:
        self.events.append({"ev": "step", "t": t})

    def text(self) -> str:
        return "\n".join(json.dumps(e, sort_keys=True) for e in self.events)


@contextlib.contextmanager
def recording():
    """Record every kernel-wrapper call, collective and step boundary of the
    code run inside, in this process, on a new `Recorder`.  Recordings do not
    nest: a second one waits for the first to end."""
    with _lock:
        rec = Recorder()
        collectives.RECORDER = rec
        try:
            yield rec
        finally:
            collectives.RECORDER = None


def _ar(bytes_: float, g: int) -> float:
    """Ring all-reduce wire bytes per member (0 for a single-member group,
    which issues no collective); `audit`'s models use it too."""
    return 2.0 * bytes_ * (g - 1) / g if g > 1 else 0.0


def parse_trace(text: str) -> list[dict]:
    """The events of a trace text, in order."""
    return [json.loads(line) for line in text.splitlines() if line.strip()]


def wire_bytes(event: dict) -> float:
    """Wire bytes per member of one collective event."""
    if event["ev"] == "all_reduce":
        return _ar(event["bytes"], len(event["ranks"]))
    return float(event["bytes"])  # a broadcast: the payload, sent or received


def analyze_trace(text: str) -> dict:
    """Wire bytes per device and the program's shape, from a trace text.

    Returns {"wire_bytes": total, "by_site": {site: bytes}, "sites": [(kind,
    site, axes, ranks) of each collective, in order], "collectives": count,
    "launches": {kernel: calls}, "bodies": {kernel: {body: calls}},
    "steps": step boundaries}."""
    by_site: dict[str, float] = {}
    sites: list[tuple] = []
    launches: dict[str, int] = {}
    bodies: dict[str, dict[str, int]] = {}
    steps = 0
    for e in parse_trace(text):
        if e["ev"] == "kernel":
            launches[e["name"]] = launches.get(e["name"], 0) + 1
            per = bodies.setdefault(e["name"], {})
            per[e["body"]] = per.get(e["body"], 0) + 1
        elif e["ev"] == "step":
            steps += 1
        else:
            by_site[e["site"]] = by_site.get(e["site"], 0.0) + wire_bytes(e)
            sites.append((e["ev"], e["site"], tuple(e["axes"]), tuple(e["ranks"])))
    return {"wire_bytes": sum(by_site.values()), "by_site": by_site, "sites": sites,
            "collectives": len(sites), "launches": launches, "bodies": bodies, "steps": steps}
