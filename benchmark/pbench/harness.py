"""One run of one cell: set-up, the measured window, the metrics, the check
of the outputs, and the result line.

``run_cell`` is what ``benchmark/run.py`` calls; a test calls it with
``device="cpu"`` and ``require_card=False`` to drive the rest of a run on
the CPU at a small size.
"""

from __future__ import annotations

import gc
import sys
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType
from typing import Callable, Dict, List, Optional

import torch

from pbench import check, derive, registry, systems, traffic
from pbench.load import Record, run_closed, run_open
from pbench.trace import DeviceTrace, Profiler, summarize
from pbench.weights import make_weights

__all__ = ["Run", "run_cell", "FORBIDDEN_MODULES"]

# Whole top-level module names that may not be loaded in a run.
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "go_pocket_tts_tpu")


@dataclass
class Run:
    """What a metric reader reads."""

    cell: str
    config: Dict
    # The configuration's reference module: its layout and operation counts.
    reference: ModuleType
    workload: Dict
    seconds: float
    setup_s: float
    t0: float = 0.0
    t1: float = 0.0
    records: List[Record] = field(default_factory=list)
    captures0: int = 0
    captures1: int = 0
    counts0: Dict = field(default_factory=dict)
    counts1: Dict = field(default_factory=dict)
    trace: Optional[DeviceTrace] = None
    trace_summary: Optional[Dict] = None
    card: str = ""


def forbidden_loaded(names=None) -> List[str]:
    """The forbidden top-level names among ``names`` (default: the loaded
    modules), each compared whole."""
    tops = {name.split(".", 1)[0] for name in (list(sys.modules) if names is None else names)}
    return sorted(tops & set(FORBIDDEN_MODULES))


def _refuse_forbidden() -> None:
    found = forbidden_loaded()
    if found:
        raise registry.BenchError("modules that a run may not load are loaded: " + ", ".join(found))


def _sub_seed(seed: int, k: int) -> int:
    return (int(seed) * 1_000_003 + k) % (2**63 - 1)


def _device_info(device: torch.device, memory_peak: int, summary: Optional[Dict]) -> Dict:
    if device.type == "cuda":
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1}
    else:
        info = {"platform": "cpu", "kind": "cpu", "count": 1}
    info["memory_peak_bytes"] = int(memory_peak)
    if summary is not None:
        info["busy_s"] = summary["busy_s"]
        info["window_s"] = summary["window_s"]
    return info


def run_cell(
    root: Path,
    spec_path: Path,
    cell: str,
    seed: int,
    seconds: float,
    trace: bool,
    t_start: float,
    device: str = "cuda",
    require_card: bool = True,
    log: Callable[[str], None] = lambda s: print(s, file=sys.stderr, flush=True),
    hook: Optional[Callable] = None,
    keep: Optional[Dict] = None,
) -> Dict:
    """Run ``cell`` and return its result (the last line's object).
    ``hook(system)``, where given, is applied to the system before the
    window: a test breaks the timed path with it. ``keep``, where given,
    receives the run (``keep["run"]``) for a tool that reads more of it."""
    root = Path(root)
    spec = registry.load_spec(spec_path)
    entry = registry.cell_entry(spec, cell)
    workload = registry.load_workload(root, cell)
    config = registry.load_config(root, workload["config"])
    readers = [(m, registry.load_metric(root, m["name"])) for m in registry.cell_metrics(spec, cell, trace)]
    reference = registry.load_reference(root, config["reference_impl"])

    dev = torch.device(device)
    if require_card:
        if not torch.cuda.is_available():
            raise registry.BenchError("no CUDA device: torch.cuda.is_available() is false")
        if torch.cuda.device_count() < int(entry["chips"]):
            raise registry.BenchError(f"cell {cell!r} needs {entry['chips']} cards, {torch.cuda.device_count()} found")
    card = registry.card_line() if dev.type == "cuda" else "cpu"
    if dev.type == "cuda":
        registry.use_build_dirs()

    # -- set-up: weights from the seed, the system, the cell's shapes ------
    weights = make_weights(reference, config, _sub_seed(seed, 1), dev)
    host = systems.host_copy(weights)
    del weights
    system = systems.build_system(config, host, dev, _sub_seed(seed, 2))
    lengths = traffic.block_lengths(workload)
    system.warm(lengths, [traffic.frames_for_tokens(n) for n in lengths], set(workload["routes"]))
    if hook is not None:
        hook(system)
    if trace:
        Profiler.warm()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    # What set-up made lives on: no collection walks it inside the window.
    gc.collect()
    gc.freeze()
    run = Run(cell=cell, config=config, reference=reference, workload=workload, seconds=seconds,
              setup_s=time.perf_counter() - t_start, card=card)

    # -- the window --------------------------------------------------------
    requests = traffic.draw(workload, _sub_seed(seed, 3))
    run.captures0, run.counts0 = system.captures(), system.kernel_counts()
    run.t0 = time.perf_counter()
    run.t1 = run.t0 + seconds
    result: Dict = {}

    def load() -> None:
        if workload["loop"] == "open":
            result["records"] = run_open(system, requests, int(workload.get("workers", 64)), run.t0, seconds)
        else:
            result["records"] = run_closed(system, requests, int(workload["clients"]), run.t0, seconds)

    loader = threading.Thread(target=load, name="bench-load")
    loader.start()
    prof = None
    if trace:
        trace_s = float(workload.get("trace", {}).get("seconds", 1.0))
        time.sleep(max(run.t1 - trace_s - time.perf_counter(), 0.0))
        prof = Profiler(system.kernel_counts, system.quiesce)
        prof.start()
    time.sleep(max(run.t1 - time.perf_counter(), 0.0))
    run.captures1, run.counts1 = system.captures(), system.kernel_counts()
    if prof is not None:
        run.trace = prof.stop()
    loader.join()
    run.records = result["records"]
    memory_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    if run.trace is not None:
        run.trace_summary = summarize(run.trace, run.records)

    _refuse_forbidden()
    metrics: Dict[str, Dict] = {}
    for m, read in readers:
        value = read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    # -- the output check, once the program's state is freed ---------------
    probe = system.probe
    system.close()
    del system
    gc.unfreeze()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    if keep is not None:
        keep["run"] = run
    verdict = check.check_outputs(run, reference, host, dev, _sub_seed(seed, 4), probe)
    _refuse_forbidden()

    failed = sum(1 for r in run.records if r.error is not None)
    out = {
        "correct": verdict["correct"],
        "attempted": len(run.records),
        "failed": failed,
        "metrics": metrics,
        "device": _device_info(dev, memory_peak, run.trace_summary),
    }
    if run.trace_summary is not None:
        out["breakdown"] = {k: run.trace_summary[k] for k in ("device_ops", "idle_gaps")}
    log(f"card: {card}; cell {cell}; seed {seed}; setup_s {run.setup_s:.3f}; window {seconds} s; "
        f"requests {len(run.records)}, failed {failed}; captures in window {run.captures1 - run.captures0}")
    for name, values in (("ttfa", derive.first_block_latencies(run)), ("request", derive.request_latencies(run))):
        if values:
            log(f"{name}: n {len(values)}, p50 {derive.median(values) * 1e3:.3f} ms, "
                f"p90 {derive.percentile_ms(values, 90.0):.3f} ms, p95 {derive.p95_ms(values):.3f} ms, "
                f"p99 {derive.percentile_ms(values, 99.0):.3f} ms")
    for line in verdict["lines"]:
        log(line)
    out["checks"] = verdict["numbers"]
    return out

