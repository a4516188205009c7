"""The benchmark's frame: find a cell by name, run it, judge it, print it.

Everything that belongs to one configuration, traffic mix or metric sits in
a file of its own, found by the name ``BENCHMARK.json`` gives it:

* ``sortbench/configs/<config>.json`` -- the deployment; its ``client``
  names ``sortbench/clients/<client>.py`` (how a job is submitted to the
  program; a module name) and its ``reference`` names ``sortbench/reference/<name>.py``
  (the plain reference, its control and its limits);
* ``sortbench/traffic/<mix>.json`` -- the parameters of the one generator,
  :mod:`sortbench.generate`;
* ``sortbench/metrics/<metric>.py`` -- a reader, ``read(r: Readings)``,
  that returns the metric's value or None when it finds nothing to read.

A client's ``run(ctx)`` sets up, warms up, runs the closed loop for the
window and judges the jobs it kept; whichever process ran the window then
calls :func:`report`, which prints the compared numbers on standard error
and the result as the last line of standard output.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import sys
from pathlib import Path

#: Top-level module names that no process of the benchmark may hold.
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
#: The judged early job is drawn from the seed among this many first jobs.
JUDGED_FROM = 4


class Refused(Exception):
    """A run that cannot give a result (no card, wrong directory)."""


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict
    metrics: list  # the cell's metric entries of BENCHMARK.json, both kinds
    root: Path  # the checkout


@dataclasses.dataclass
class Context:
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    t0_wall: float  # when the process started its set-up (time.time())
    device: str = "cuda"  # "cpu" only in the CPU tests
    keys: int | None = None  # keys a job (a rank); None: the configuration's
    patch: str | None = None  # "module:function" run in every process (tests)
    control: bool = False  # the reference's control in the program's place


@dataclasses.dataclass
class Readings:
    """What a window left for the metric readers."""

    cell: Cell
    jobs: int
    keys: int  # keys of all jobs completed in the window
    window_s: float
    setup_s: float
    peak_bytes: int  # on the fullest card
    stages: dict | None = None  # stage clock: name -> seconds over the window
    server_s: list | None = None  # PipelineResult.server_seconds a job
    traces: list | None = None  # a DeviceTrace a card (traced runs)
    work: dict | None = None  # "<kernel>_least_s": least seconds of the window's work


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(root: Path, kind: str, name: str):
    """``sortbench/<kind>/<name>.py`` of the checkout at ``root``."""
    path = root / "sortbench" / kind / f"{name}.py"
    if not path.is_file():
        raise Refused(f"no {kind} file {path}")
    spec = importlib.util.spec_from_file_location(f"sortbench_{kind}_{name.replace('.', '_').replace('-', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_cell(root: Path, workload: str) -> Cell:
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise Refused(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = load_json(root / conf["file"])
    mix = load_json(root / "sortbench" / "traffic" / f"{w['traffic']}.json")
    metrics = []
    for kind in ("end_to_end", "per_layer"):
        for m in bench[kind]:
            if "workloads" in m and workload not in m["workloads"]:
                continue
            metrics.append(dict(m, kind=kind))
    return Cell(name=workload, chips=int(w["chips"]), config=config, mix=mix, metrics=metrics, root=root)


def check_card(chips: int) -> None:
    """Refuse a run without the cards the cell asks for."""
    import torch

    if not torch.cuda.is_available():
        raise Refused("no CUDA device is available")
    if torch.cuda.device_count() < chips:
        raise Refused(f"the cell needs {chips} cards; {torch.cuda.device_count()} are visible")


def sync(dev) -> None:
    """Wait for the card (a no-op on the CPU)."""
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize()


def forbidden_loaded() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def apply_patch(spec: str | None) -> None:
    """Run a test's ``module:function`` (a fault planted in the program)."""
    if spec:
        mod, fn = spec.split(":")
        getattr(importlib.import_module(mod), fn)()


def prepare_paths(root: Path) -> None:
    """The program's package and this folder's modules on ``sys.path``;
    every cache the program might write kept inside the checkout, at fixed
    paths."""
    for p in (str(root / "src"), str(root)):
        if p not in sys.path:
            sys.path.insert(0, p)
    cache = root / "build" / "sortbench-cache"
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))


def job_summary(seconds: list) -> str:
    """Count, least, median and most of the window's job seconds."""
    srt = sorted(seconds)
    return (f"{len(srt)} jobs of {srt[0]:.4f} / {srt[len(srt) // 2]:.4f} / {srt[-1]:.4f} s "
            f"(least / median / most)")


def read_metrics(r: Readings, kind: str) -> dict:
    out = {}
    for m in r.cell.metrics:
        if m["kind"] != kind:
            continue
        value = load_module(r.cell.root, "metrics", m["name"]).read(r)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def report(ctx: Context, r: Readings, compared: dict, limits: dict, judged: int, *, device_name: str,
           count: int, attempted: int, failed: int) -> int:
    """Print the compared numbers and the result line; the exit code."""
    bad = forbidden_loaded()
    if bad:
        print(f"sortbench: refused: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 4
    numbers = {k: {"value": v, "limit": limits[k]} for k, v in compared.items()}
    correct = judged > 0 and all(v <= limits[k] for k, v in compared.items())
    line = {"correct": correct, "attempted": attempted, "failed": failed,
            "metrics": read_metrics(r, "per_layer" if ctx.trace else "end_to_end"),
            "device": {"platform": "gpu" if ctx.device == "cuda" else ctx.device, "kind": device_name,
                       "count": count, "memory_peak_bytes": r.peak_bytes}}
    if ctx.trace and r.traces:
        print(f"sortbench: traced {sum(len(t.device) for t in r.traces)} device intervals; busy "
              f"{[round(t.busy_s(), 4) for t in r.traces]} s of {[round(t.window_s, 4) for t in r.traces]} s",
              file=sys.stderr)
        line["device"]["busy_s"] = sum(t.busy_s() for t in r.traces) / len(r.traces)
        line["device"]["window_s"] = sum(t.window_s for t in r.traces) / len(r.traces)
        first = r.traces[0]
        line["breakdown"] = {"device_ops": first.top_ops(), "idle_gaps": first.idle_gaps()}
    line["compared"] = numbers
    sys.stdout.flush()
    print(f"sortbench: {r.jobs} jobs, {r.keys} keys in {r.window_s:.6f} s; judged {judged} jobs",
          file=sys.stderr)
    for k, v in numbers.items():
        print(f"{k} {v['value']} limit {v['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


def run(ctx: Context) -> int:
    """Hand the cell to its client, ``sortbench.clients.<client>`` (an
    importable module, so that a client's spawned processes can find it)."""
    client = importlib.import_module(f"sortbench.clients.{ctx.cell.config['client']}")
    return client.run(ctx)
