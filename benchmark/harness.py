"""One run of one cell: set-up, the measured window, the trace, the check.

Everything that belongs to one cell is found by name: the cell in
``BENCHMARK.json`` names its configuration (``configs/<config>.json``: the
frames, their checksum and the program's settings) and its traffic mix
(``traffic/<mix>.json``: parameters, and the names of its ``order``,
``orders/<order>.py``, which draws the requests from the seed, and of its
``client``, ``clients/<client>.py``, which hands them to the program and
owns the arrival loop); its limits are ``limits/<cell>.json`` and each
metric is ``metrics/<metric>.py``.  A later cell, mix, order, client or
metric is a new file, never an edit.

A request whose counts exceed a capacity of the configuration, or that
raises, has failed.  The window is timed from its start to the end of the
last request begun inside it.
"""

from __future__ import annotations

import contextlib
import gc
import hashlib
import importlib.util
import json
import statistics
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch

from benchmark import judge, traffic
from benchmark.reference import sift_plain

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "sift_tpu")
# The traced run: the requests of the window's first TRACE_LEAD share give
# the host-clock metrics; then the profiler is prepared over one request and
# records whole requests for TRACE_SECONDS; the rest of the window is read
# by nothing.
TRACE_LEAD = 0.4
TRACE_SECONDS = 3.0


_MODULES: dict = {}


def load_module(here: Path, kind: str, name: str):
    """``<here>/<kind>/<name>.py``, loaded once."""
    key = (str(here), kind, name)
    if key not in _MODULES:
        spec = importlib.util.spec_from_file_location(
            f"benchmark_{kind}_{len(_MODULES)}", here / kind / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _MODULES[key] = mod
    return _MODULES[key]


def requests(cell: "Cell", n_frames: int, seed: int):
    """The cell's requests from ``seed``: its mix's order."""
    return load_module(cell.here, "orders", cell.mix["order"]).requests(cell.mix, n_frames, seed)


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


def forbidden_modules() -> list[str]:
    """Modules loaded whose top-level name is JAX's or the JAX package's."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


class Cell:
    """A workload of ``BENCHMARK.json`` with every file it names."""

    def __init__(self, name: str, root: Path = ROOT):
        spec = load_json(root / "BENCHMARK.json")
        self.root, self.here = root, root / "benchmark"
        cells = {w["name"]: w for w in spec["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json: {sorted(cells)}")
        self.name = name
        self.cell = cells[name]
        self.config = load_json(root / {c["name"]: c for c in spec["configs"]}[
            self.cell["config"]]["file"])
        self.mix = load_json(self.here / "traffic" / f"{self.cell['traffic']}.json")
        self.limits = load_json(self.here / "limits" / f"{name}.json")

        def mine(m):
            return name in m.get("workloads", [name])

        self.end_to_end = [m for m in spec["end_to_end"] if mine(m)]
        e2e_names = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in spec["per_layer"]
                          if mine(m) and ("workloads" in m or m["moves"] in e2e_names)]


def load_frames(config: dict, root: Path = ROOT) -> list[np.ndarray]:
    """The configuration's frames, (H, W, 3) uint8 each, held to its
    checksum (SHA-256 over the frames' bytes in order)."""
    spec = config["frames"]
    frames = [np.ascontiguousarray(np.load(root / spec["npz"].format(i))[spec["key"]])
              for i in spec["indices"]]
    h = hashlib.sha256()
    for f in frames:
        h.update(f.tobytes())
    if h.hexdigest() != spec["sha256"]:
        raise RuntimeError(f"frames of {spec['npz']} do not match their checksum")
    return frames


class Spans:
    """Host-clock spans around the calls into the program (traced runs
    only), also marked in the profiler's trace."""

    def __init__(self, on: bool):
        self.on = on
        self.items: list[tuple] = []
        self.request = -1

    @contextlib.contextmanager
    def __call__(self, name: str, count: int = 0):
        if not self.on:
            yield
            return
        t0 = time.perf_counter()
        with torch.profiler.record_function(name):
            yield
        self.items.append((name, t0, time.perf_counter(), count, self.request))


class Reference:
    """The plain reference's keypoints of (frame index, flip), computed once
    per key on ``dev``."""

    def __init__(self, frames, config: dict, dev):
        self.frames, self.params, self.dev = frames, config["sift"], dev
        self.cache: dict = {}

    def __call__(self, key):
        if key not in self.cache:
            i, flip = key
            img = torch.from_numpy(traffic.flipped(self.frames[i], flip)).to(self.dev)
            kp = sift_plain.describe(img, self.params)
            out = {k: kp[k].cpu().numpy() for k in judge.FIELDS + ("desc",)}
            out["desc_t"] = kp["desc"]
            self.cache[key] = out
        return self.cache[key]


class Run:
    """What the metric readers read: the window's requests, the set-up and
    window seconds, the spans and, in a traced run, the device trace."""

    def __init__(self, cell, records, setup_s, window_s, spans, trace, work):
        self.cell, self.records, self.setup_s, self.window_s = cell, records, setup_s, window_s
        self.spans, self.trace, self.work = spans, trace, work

    def untraced(self, name: str) -> list[tuple]:
        """Spans ``name`` of the requests before the profiler started."""
        pre = {r["index"] for r in self.records if r["phase"] == "pre"}
        return [s for s in self.spans if s[0] == name and s[4] in pre]

    def latencies_ms(self, phase: str | None = None) -> list[float]:
        """Every request's latency, or those of one ``phase`` ("pre":
        before the profiler started)."""
        return [1e3 * (r["t1"] - r["t0"]) for r in self.records
                if phase is None or r["phase"] == phase]


def p95(values) -> float | None:
    if len(values) < 2:
        return None
    return statistics.quantiles(values, n=100, method="inclusive")[94]


def read_metric(name: str, run: Run):
    return load_module(run.cell.here, "metrics", name).read(run)


def choose_samples(seed: int, k: int):
    """Reservoir sampling of ``k`` window requests, drawn from the seed."""
    draw = traffic.rng(seed, 7)
    kept: list = []
    seen = 0

    def offer(item):
        nonlocal seen
        seen += 1
        if len(kept) < k:
            kept.append(item)
        else:
            j = int(draw.integers(seen))
            if j < k:
                kept[j] = item
    return kept, offer


class Window:
    """The measured window.  ``send`` hands a request to the program, times
    it from ``t0`` (its arrival; now by default) to its answers on the
    host and records it; in a traced run it also starts the profiler once
    ``TRACE_LEAD`` of the window has passed, prepares it over one request
    and records whole requests for ``TRACE_SECONDS``."""

    def __init__(self, seconds: float, trace: bool, dev, spans: Spans, offer, prev_req):
        self.seconds, self.trace, self.dev, self.spans, self.offer = seconds, trace, dev, spans, offer
        self.prev_req = prev_req
        self.records: list[dict] = []
        self.done: list = []
        self.prof = None
        self.phase = "pre"
        self.trace_t0 = None
        self.t_begin = time.perf_counter()

    def elapsed(self) -> float:
        return time.perf_counter() - self.t_begin

    def running(self) -> bool:
        return self.elapsed() < self.seconds

    def send(self, req, handle, t0: float | None = None):
        if self.trace and self.phase == "pre" and self.elapsed() >= TRACE_LEAD * self.seconds:
            # step 0 prepares the profiler over one request, step 1 records
            self.prof = torch.profiler.profile(
                activities=profiler_activities(self.dev),
                schedule=torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1),
                on_trace_ready=self.done.append)
            self.prof.start()
            self.phase = "warming"
        elif self.phase == "warming":
            self.prof.step()
            self.phase, self.trace_t0 = "recording", time.perf_counter()
        self.spans.request = req["index"]
        t0 = time.perf_counter() if t0 is None else t0
        try:
            with self.spans("request"):
                out = handle(req)
            ok = not out["bad"]
            if out["bad"]:
                print(f"request {req['index']} clipped: " + "; ".join(out["bad"]), file=sys.stderr)
        except Exception:  # a request that raises has failed; the run goes on
            traceback.print_exc()
            out, ok = None, False
        t1 = time.perf_counter()
        self.records.append(dict(index=req["index"], t0=t0, t1=t1, ok=ok, phase=self.phase,
                                 traced=self.phase == "recording",
                                 frames=out["frames"] if out else 0,
                                 pairs=out["pairs"] if out else 0, req=req))
        if out is not None:
            self.offer(dict(req=req, prev_req=self.prev_req,
                            **{k: v for k, v in out.items() if k != "bad"}))
        self.prev_req = req
        if self.phase == "recording" and time.perf_counter() - self.trace_t0 >= TRACE_SECONDS:
            sync(self.dev)
            self.prof.step()
            self.phase = "post"

    def close(self):
        if self.prof is not None:
            sync(self.dev)
            self.prof.stop()
        if self.elapsed() < self.seconds:
            print(f"the requests ran out {self.elapsed():.3f} s into the window", file=sys.stderr)


def run_cell(name: str, seed: int, seconds: float, trace: bool, device="cuda",
             t_start: float | None = None, hooks=None) -> tuple[dict, list[str]]:
    """One run; returns (result line, check lines).  ``hooks``: overrides
    for the control and the tests: ``frames`` (a function of the loaded
    frames), ``program`` (a (detect, match) pair in the entry points'
    place) and ``root`` (the checkout whose ``BENCHMARK.json`` and
    ``benchmark/`` files to read)."""
    t_start = time.perf_counter() if t_start is None else t_start
    hooks = hooks or {}
    cell = Cell(name, hooks.get("root", ROOT))
    dev = torch.device(device)
    frames = load_frames(cell.config, cell.root)
    if "frames" in hooks:
        frames = hooks["frames"](frames)
    spans = Spans(trace)
    client = load_module(cell.here, "clients", cell.mix["client"]).Client(
        cell, frames, dev, spans, seconds, hooks.get("program"))
    reqs = client.setup(requests(cell, len(frames), seed))
    warm = next(reqs)
    out = client.request(dict(warm))
    if out["bad"]:
        raise RuntimeError("warm-up request clipped: " + "; ".join(out["bad"]))
    del out
    sync(dev)

    samples, offer = choose_samples(seed, cell.mix["check_requests"])
    window = Window(seconds, trace, dev, spans, offer, warm)
    setup_s = window.t_begin - t_start
    client.drive(reqs, window)
    window.close()
    records = window.records
    window_s = records[-1]["t1"] - window.t_begin
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    tr = None
    if window.done:
        from benchmark import trace as tracemod

        tr = tracemod.read(window.done[0])
    if trace:
        traced = [r for r in records if r["traced"]]
        print(f"traced {len(traced)} of {len(records)} requests, "
              f"{sum(r['t1'] - r['t0'] for r in traced):.3f} s of them on the host clock, "
              f"{tr.window_s if tr else 0:.3f} s traced window", file=sys.stderr)
    run = Run(cell, records, setup_s, window_s, spans.items, tr,
              client.work([r for r in records if r["traced"]]))
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = read_metric(m["name"], run)
        if v is not None:
            metrics[m["name"]] = dict(value=float(v), unit=m["unit"])

    # The check, once the window has closed and the program's state is freed.
    client.close()
    del window, run
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    tally = client.judge(samples, Reference(frames, cell.config, dev))
    numbers = tally.numbers()
    good, lines = judge.verdict(numbers, cell.limits)
    lines.insert(0, tally.compared())
    failed = sum(not r["ok"] for r in records)
    result = dict(correct=bool(good and failed == 0), attempted=len(records), failed=failed,
                  metrics=metrics, device=device_info(dev, peak, tr))
    if tr is not None:
        result["breakdown"] = tr.breakdown()
    result["checks"] = {k: dict(value=numbers.get(k), limit=cell.limits.get(k))
                        for k in sorted(set(numbers) | set(cell.limits))}
    return result, lines


def device_info(dev, peak: int, tr) -> dict:
    if dev.type == "cuda":
        info = dict(platform="gpu", kind=torch.cuda.get_device_name(dev), count=1,
                    memory_peak_bytes=int(peak), power_limit=power_limit(dev))
    else:
        info = dict(platform="cpu", kind="cpu", count=1, memory_peak_bytes=0)
    if tr is not None:
        info.update(busy_s=tr.busy_s, window_s=tr.window_s)
    return info


def power_limit(dev) -> str:
    """The card's name and power limit as nvidia-smi reads them."""
    import subprocess

    index = dev.index if dev.index is not None else torch.cuda.current_device()
    try:
        return subprocess.run(["nvidia-smi", "-i", str(index), "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip() or "not read"
    except (OSError, subprocess.SubprocessError):
        return "not read"


def profiler_activities(dev):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
