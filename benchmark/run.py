"""Run one cell of the benchmark once and print its result line.

    python benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout. The cell, its configuration and its traffic
mix are found by name (``BENCHMARK.json``, ``benchmark/configs/``,
``benchmark/traffic/``); the traffic names its driver
(``benchmark/drivers/``), the configuration its architecture
(``benchmark/models/``), and each per-layer metric has a reader of its own
(``benchmark/metrics/``). Set-up (weights from the seed, the program's
loader, warm-up) is timed as ``setup_s``; then the window runs for
``--seconds``; then, with the program freed, the reference checks what
the window produced. ``--trace 1`` profiles a few steps of the window and
prints the per-layer metrics instead of the end-to-end ones.

Exits non-zero, printing no result, without a CUDA card (or with fewer
than the cell asks for), and if JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "comfyui_gguf_tpu")


def _paths(bench: Path) -> None:
    for p in (str(bench.parent), str(bench), str(bench / "models")):
        if p in sys.path:
            sys.path.remove(p)
        sys.path.insert(0, p)


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


class Cell:
    """A cell of ``BENCHMARK.json`` with its configuration, traffic mix,
    limits and the metrics it reports."""

    def __init__(self, root: Path, workload: str):
        self.bench = root / "benchmark"
        self.spec = _json(root / "BENCHMARK.json")
        cells = {w["name"]: w for w in self.spec["workloads"]}
        if workload not in cells:
            raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
        self.cell = cells[workload]
        conf = {c["name"]: c for c in self.spec["configs"]}[
            self.cell["config"]]
        self.config = _json(root / conf["file"])
        self.traffic = _json(self.bench / "traffic" /
                             f"{self.cell['traffic']}.json")
        self.limits = _json(self.bench / "limits" / f"{workload}.json")
        self.e2e = [m for m in self.spec["end_to_end"]
                    if workload in m.get("workloads", [workload])]
        names = {m["name"] for m in self.e2e}
        self.per_layer = [m for m in self.spec["per_layer"]
                          if (workload in m["workloads"] if "workloads" in m
                              else m["moves"] in names)]


class Context:
    """What a driver gets: the architecture's module, the configuration,
    the traffic, the device, the seed, a hook on the built model (the w8a8
    control switches the program's int8 path on there) and the control
    the check computes beside the program (``"fp8"``, or None)."""

    def __init__(self, cell: Cell, seed: int, device, tree_hook=None,
                 control=None):
        import torch

        self.arch = _load(cell.bench / "models" /
                          f"{cell.config['arch']}.py",
                          f"bench_arch_{cell.config['arch']}")
        self.config, self.traffic = cell.config, cell.traffic
        self.device = torch.device(device)
        self.seed = seed % (1 << 63)
        self.tree_hook = tree_hook
        self.control = control

    def sync(self):
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


class MetricInputs:
    """What a per-layer metric's reader gets: the traced timeline, the
    window's host-clock numbers, the work of each traced step (per kind, a
    list of (FLOPs, bytes)), the card's peaks, and the traced steps."""

    def __init__(self, timeline, host, work, peaks, traced_steps):
        self.timeline, self.host, self.work = timeline, host, work
        self.peaks, self.traced_steps = peaks, traced_steps

    def least_s(self, item) -> float:
        """The least time of one call's (FLOPs, bytes) on the card, at
        the bf16 peak the configurations compute at."""
        return max(item[0] / self.peaks["bf16_flops"],
                   item[1] / self.peaks["hbm_bytes_per_s"])

    def roofline_share(self, kind: str):
        t = self.timeline
        if t is None or self.peaks is None or not self.work:
            return None
        spent = t.class_s.get(kind, 0.0)
        if spent <= 0:
            return None
        least = sum(self.least_s(item) for w in self.work
                    for item in w.get(kind, ()))
        return 100.0 * least / spent


def _reader(bench: Path, name: str):
    """``metrics/<name>.py``, else the reader of the name without its
    last dotted part (``kernel.linear_roofline.serve`` ->
    ``kernel.linear_roofline``)."""
    parts = name.split(".")
    while parts:
        path = bench / "metrics" / (".".join(parts) + ".py")
        if path.exists():
            return _load(path, "bench_metric_" + "_".join(parts))
        parts.pop()
    raise FileNotFoundError(f"no reader for metric {name}")


def _peaks(bench: Path, kind: str):
    return _json(bench / "peaks.json").get(kind)


def _power_limit():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=20)
        return float(out.stdout.split()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def run_cell(root: Path, workload: str, seed: int, seconds: float,
             trace: bool, device="cuda", tree_hook=None, t0=None,
             control=None) -> dict:
    """One run of a cell; the result as a dict (``checks`` last). With
    ``control`` the control's numbers take the program's place in the
    check, and the program's go to ``info["program"]``."""
    import torch

    cell = Cell(root, workload)
    _paths(cell.bench)
    ctx = Context(cell, seed, device, tree_hook, control)
    driver = _load(cell.bench / "drivers" / f"{cell.traffic['driver']}.py",
                   f"bench_driver_{cell.traffic['driver']}")
    start = T0 if t0 is None else t0
    t_driver = time.perf_counter() - start
    with torch.no_grad():
        sess = driver.setup(ctx)
    setup_s = time.perf_counter() - start
    # set-up's phases, each the seconds since the process started
    phases = {"imports": t_driver, **{k: t_driver + v for k, v in
                                       sess.setup_marks.items()}}
    on_card = ctx.device.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(ctx.device)
    tr = cell.traffic
    timeline, work, traced = None, [], 0
    with torch.no_grad():
        if trace:
            import devtrace

            # the window unprofiled, for the host-clock metrics; then a few
            # profiled steps past it, for the device metrics
            host = driver.window(sess, seconds)
            skip, active = tr["trace_skip"], tr["trace_steps"]
            prof = devtrace.profiler(skip, active)
            with prof:
                extra = driver.window(sess, 0.0, on_tick=prof.step,
                                      min_ticks=skip + active + 2)
            timeline = devtrace.read(prof)
            lanes = extra["lanes_per_tick"][skip + 1: skip + 1 + active]
            work = [ctx.arch.work(cell.config, tr, n) for n in lanes]
            traced = timeline.steps
        else:
            host = driver.window(sess, seconds)
    peak = torch.cuda.max_memory_allocated(ctx.device) if on_card else 0
    kind = torch.cuda.get_device_name(ctx.device) if on_card else "cpu"
    t_check = time.perf_counter()
    checks = driver.check(sess)
    del sess
    swapped = checks.pop("control", {})
    info = {"setup_phases_s": phases}
    if swapped:
        info["program"] = {k: checks[k] for k in swapped}
    checks.update(swapped)
    print(f"[run] setup {setup_s:.2f}s, window {host['window_s']:.2f}s "
          f"({host['ticks']} steps), check {time.perf_counter() - t_check:.2f}s",
          file=sys.stderr, flush=True)
    rows = {k: {"value": float(checks[k]), "limit": float(cell.limits[k])}
            for k in cell.limits}
    correct = (all(r["value"] <= r["limit"] for r in rows.values())
               and host["failed"] == 0)
    metrics = {}
    if trace:
        inputs = MetricInputs(timeline, host, work,
                              _peaks(cell.bench, kind), traced)
        for m in cell.per_layer:
            v = _reader(cell.bench, m["name"]).read(inputs)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        values = dict(host, setup_s=setup_s)
        for m in cell.e2e:
            metrics[m["name"]] = {"value": float(values[m["name"]]),
                                  "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else "cpu", "kind": kind,
           "count": 1, "memory_peak_bytes": int(peak)}
    if trace:
        dev.update(busy_s=timeline.busy_s, window_s=timeline.window_s)
    if on_card:
        dev["power_limit_w"] = _power_limit()
    out = {"correct": bool(correct), "attempted": int(host["lane_steps"]),
           "failed": int(host["failed"]), "metrics": metrics, "device": dev}
    if trace:
        out["breakdown"] = timeline.breakdown()
    info.update((k, v) for k, v in checks.items() if k not in rows)
    out["info"] = info
    out["checks"] = rows
    return out


def forbidden_modules() -> list[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def _cache_dirs(root: Path) -> None:
    """Every build and kernel cache inside the checkout, at fixed paths."""
    cache = root / ".bench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(cache / "inductor")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _cache_dirs(ROOT)
    import torch

    cell = Cell(ROOT, args.workload)
    want = int(cell.cell.get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < want:
        print(f"refused: the cell needs {want} CUDA card(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}",
              file=sys.stderr)
        return 3
    _paths(BENCH)
    import program

    program.enable_build_cache(str(ROOT / ".bench_cache" / "kernels"))
    res = run_cell(ROOT, args.workload, args.seed, args.seconds,
                   bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f"refused: loaded {', '.join(bad)}", file=sys.stderr)
        return 4
    for k, r in res["checks"].items():
        print(f"check {k} {r['value']!r} limit {r['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
