"""The benchmark of lettuce_tpu_torch: one run of one cell.

A cell (an entry of ``workloads`` in ``BENCHMARK.json``) names a
configuration and a traffic mix. Everything else is found by name:

* ``configs/<config>.json``: the flow's numbers; its ``flow`` names the
  module ``flows/<flow>.py`` that makes the seeded initial state, builds
  the program's simulation and gives the reference step;
* the configuration's ``collision``, a name (``"bgk"``) or an object
  ``{"name": ..., <parameters>}``, names two modules:
  ``flows/collisions/<name>.py``, whose ``program(lt, flow, params)``
  returns the port's ``Collision``, and
  ``reference/collisions/<name>.py``, whose ``collide(f, st, tau,
  params)`` is the reference's, in plain torch; a missing one stops the
  run (nothing falls back to BGK);
* ``traffic/<mix>.json``: how the window drives the program; its ``kind``
  is ``rollout`` (a closed loop of ``Simulation.__call__``) or ``adam``
  (a closed loop of Adam iterations through ``make_segment_fn``); an
  ``n_sub`` asks for the program's temporal blocking at that span
  (``LETTUCE_NSUB``, set only while the program is built), and a program
  that runs another span stops the run;
* ``metrics/<metric>.py``: one reader per metric, ``read(record)``; a
  reader that sets ``SPANS = True`` has a traced run record the program's
  own spans over the window (``lettuce_tpu_torch.tracing.recording()``),
  and every traced record carries the deltas of the program's launch
  counters over the window;
* ``kernels/*.json``: the kernel families, their profiler names, bytes
  and operations per lattice update;
* ``limits/<cell>.json``: the limit of each number the check compares.

All of them are found under the benchmark's folder of the ``root`` that
holds ``BENCHMARK.json``.

One run: build the program and the cell's inputs from the seed, warm up
the cell's own shapes, measure for ``seconds``, compare what the window
produced with the plain reference (``reference/lbm.py``), print the
result. With ``trace`` one ``torch.profiler`` session covers a steady
stretch of the window and host spans time the calls the harness makes
into the program's layers; the run then reports the per-layer metrics.
"""

from __future__ import annotations

import contextlib
import functools
import importlib.util
import json
import math
import os
import random
import re
import subprocess
import sys
import tempfile
import time
from collections import Counter
from pathlib import Path
from types import SimpleNamespace

import torch

from torch_bench import trace as tr
from torch_bench.reference import lbm

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# what a profiler trace records of the device's own work
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
DTYPES = {"float32": torch.float32, "float64": torch.float64,
          "bfloat16": torch.bfloat16, "float16": torch.float16}
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]*")
# the JAX stack and the JAX package, by whole top-level name: the process
# that prints a result holds none of them
FORBIDDEN = ("jax", "jaxlib", "flax", "lettuce_tpu")


# ----------------------------------------------------------------------
# finding a cell's pieces
# ----------------------------------------------------------------------
def _json(path: Path):
    return json.loads(path.read_text())


def _module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _applies(metric: dict, cell: str, reported: set) -> bool:
    """Whether ``cell`` reports ``metric``: it is listed under the metric's
    ``workloads``, or, without that key, it reports what the metric
    ``moves`` (every cell, for an end-to-end metric)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in reported


def load_cell(name: str, root: Path = ROOT) -> SimpleNamespace:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its configuration,
    traffic, limits, kernel families and metric entries; ``home`` is the
    benchmark's folder under ``root``, where every piece is found."""
    spec = _json(root / "BENCHMARK.json")
    work = {w["name"]: w for w in spec["workloads"]}.get(name)
    if work is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    entry = {c["name"]: c for c in spec["configs"]}[work["config"]]
    home = root / HERE.name
    limits = home / "limits" / f"{name}.json"
    end_to_end = [m for m in spec["end_to_end"] if _applies(m, name, set())]
    reported = {m["name"] for m in end_to_end}
    return SimpleNamespace(
        name=name, chips=work["chips"], home=home,
        config=_json(root / entry["file"]),
        traffic=_json(home / "traffic" / f"{work['traffic']}.json"),
        limits=_json(limits) if limits.exists() else {},
        families=[_json(p) for p in sorted((home / "kernels").glob("*.json"))],
        peaks=_json(home / "peaks.json"),
        end_to_end=end_to_end,
        per_layer=[m for m in spec["per_layer"]
                   if _applies(m, name, reported)])


def reader(name: str, home: Path = HERE):
    """The reader module of the metric ``name`` (``metrics/<name>.py``)."""
    return _module(home / "metrics" / f"{name}.py",
                   f"torch_bench_metric_{name}")


def read_metrics(entries, record, home: Path = HERE) -> dict:
    """``{name: {"value", "unit"}}`` of each metric whose reader
    (``metrics/<name>.py``) finds something to read."""
    out = {}
    for m in entries:
        value = reader(m["name"], home).read(record)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def asks_for_spans(cell) -> bool:
    """Whether a per-layer reader of ``cell`` reads the program's spans
    (its module sets ``SPANS = True``)."""
    return any(getattr(reader(m["name"], cell.home), "SPANS", False)
               for m in cell.per_layer)


def collision_of(config) -> tuple:
    """``(name, params)`` of a configuration's ``collision``: a name, or an
    object ``{"name": ..., <parameters>}``."""
    collision = config["collision"]
    if isinstance(collision, str):
        return collision, {}
    params = dict(collision)
    return params.pop("name"), params


def collision_module(home: Path, side: str, name: str):
    """The module of the collision ``name`` on one side: ``flows`` (the
    program's) or ``reference``; raises SystemExit, naming the module,
    when there is none."""
    path = home / side / "collisions" / f"{name}.py"
    if not NAME.fullmatch(name) or not path.is_file():
        raise SystemExit(f"collision {name!r}: no module "
                         f"{HERE.name}/{side}/collisions/{name}.py")
    return _module(path, f"torch_bench_{side}_collision_{name}")


# ----------------------------------------------------------------------
# the card
# ----------------------------------------------------------------------
def process_age() -> float:
    """Seconds since this process started (``/proc``)."""
    with open("/proc/self/stat") as fh:
        start = int(fh.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as fh:
        uptime = float(fh.read().split()[0])
    return uptime - start / os.sysconf("SC_CLK_TCK")


def card_lines(chips: int) -> list:
    """The card's name and power limit, the device count and the versions;
    raises SystemExit when there is no card or too few."""
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: torch.cuda.is_available() is "
                         "False; the benchmark runs on the card only")
    if torch.cuda.device_count() < chips:
        raise SystemExit(f"the cell needs {chips} CUDA devices, "
                         f"{torch.cuda.device_count()} present")
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        smi = "nvidia-smi not readable"
    return [f"card: {smi}",
            f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
            f"{torch.cuda.device_count()} device(s), device 0 "
            f"{torch.cuda.get_device_name(0)}"]


# ----------------------------------------------------------------------
# host spans
# ----------------------------------------------------------------------
class Spans:
    """Host durations of the harness's calls into the program, by name.
    While the profiler runs they are labels in its trace instead
    (``tb:<name>``), so no timer runs inside the profiled stretch."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.profiling = False
        self.seconds = {}

    def span(self, name: str, sync: bool = False):
        return _Span(self, name, sync)

    def wrap(self, name: str, fn):
        def wrapped(*args, **kwargs):
            with self.span(name):
                return fn(*args, **kwargs)
        return wrapped


class _Span:
    def __init__(self, spans: Spans, name: str, sync: bool):
        self.spans, self.name, self.sync = spans, name, sync
        self.label = None

    def __enter__(self):
        if not self.spans.enabled:
            return self
        if self.spans.profiling:
            self.label = torch.profiler.record_function("tb:" + self.name)
            self.label.__enter__()
            return self
        if self.sync:
            torch.cuda.synchronize()
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.label is not None:
            self.label.__exit__(*exc)
        elif self.spans.enabled:
            if self.sync:
                torch.cuda.synchronize()
            self.spans.seconds.setdefault(self.name, []).append(
                time.perf_counter() - self.start)
        return False


class ProgramWindow:
    """What the program's own tracing saw over the window: the deltas of
    its launch counters (``tracing.counts``, always on), and with
    ``spans`` its spans, recorded inside ``tracing.recording()`` from the
    window's start to its end. Off (``enabled`` False, an untraced run) it
    does nothing."""

    def __init__(self, enabled: bool, spans: bool):
        self.enabled, self.recorded = enabled, enabled and spans
        self.spans, self.counts, self.window = [], Counter(), None
        self._recording = self._record = self._before = None

    def open(self):
        if not self.enabled:
            return
        from lettuce_tpu_torch import tracing
        self._before = Counter(tracing.counts)
        if self.recorded:
            self._recording = tracing.recording()
            self._record = self._recording.__enter__()
        self.window = [time.perf_counter_ns(), None]

    def close(self):
        """End the window (once; a window never opened stays unread)."""
        if self.window is None or self.window[1] is not None:
            return
        self.window[1] = time.perf_counter_ns()
        from lettuce_tpu_torch import tracing
        if self._recording is not None:
            self._recording.__exit__(None, None, None)
            self.spans = self._record.spans
        self.counts = Counter(tracing.counts) - self._before

    def reading(self, stretch, steps):
        """The readers' ``record.program``: ``spans`` (``(name, parent,
        start_ns, end_ns)``, empty unless recorded), ``window`` and
        ``stretch`` (``(start_ns, end_ns)`` of the window and of the
        profiled stretch, or None), ``counts`` and the window's ``steps``;
        None when off."""
        if self.window is None or self.window[1] is None:
            return None
        return SimpleNamespace(spans=self.spans, window=tuple(self.window),
                               stretch=stretch, counts=self.counts,
                               steps=steps)


@contextlib.contextmanager
def blocking_span(n_sub):
    """``LETTUCE_NSUB`` set to ``n_sub`` inside the ``with`` block (the
    program reads it while a ``Simulation`` is built), then put back as it
    was; with ``n_sub`` None nothing is set."""
    if n_sub is None:
        yield
        return
    before = os.environ.get("LETTUCE_NSUB")
    os.environ["LETTUCE_NSUB"] = str(int(n_sub))
    try:
        yield
    finally:
        if before is None:
            os.environ.pop("LETTUCE_NSUB", None)
        else:
            os.environ["LETTUCE_NSUB"] = before


def refuse_other_span(sim, n_sub):
    """Raise SystemExit when the traffic asks for ``n_sub`` steps a launch
    and the program's step path runs another span: a blocked cell is
    never measured on the single-step kernel."""
    if n_sub is not None and not sim.step_path.endswith(f" x{n_sub}"):
        raise SystemExit(
            f"the traffic asks for temporal blocking at span {n_sub} "
            f"(n_sub) and the program runs {sim.step_path!r} (its reasons, "
            f"if it refused, are printed above)")


class Profiled:
    """One ``torch.profiler`` session over a stretch of the window: started
    at the first boundary past ``at`` of the window, over ``length``
    calls or iterations. ``stretch_ns`` marks it on the program's clock
    (``time.perf_counter_ns``)."""

    def __init__(self, spans: Spans, at: float, length: int):
        self.spans, self.at, self.left = spans, at, length
        self.prof = self.label = None
        self.done = False
        self.stretch_ns = None

    @property
    def active(self) -> bool:
        return self.prof is not None and not self.done

    def before(self, elapsed: float, seconds: float):
        if (not self.spans.enabled or self.done or self.prof is not None
                or elapsed < self.at * seconds):
            return
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.spans.profiling = True
        self.label = torch.profiler.record_function("tb:window")
        self.label.__enter__()
        self.stretch_ns = [time.perf_counter_ns(), None]

    def after(self):
        if self.prof is None or self.done:
            return
        self.left -= 1
        if self.left > 0:
            return
        torch.cuda.synchronize()
        self.label.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)
        self.spans.profiling = False
        self.done = True
        self.stretch_ns[1] = time.perf_counter_ns()

    def stretch(self):
        """``(start_ns, end_ns)`` of the profiled stretch, or None."""
        done = self.stretch_ns is not None and self.stretch_ns[1] is not None
        return tuple(self.stretch_ns) if done else None

    def export(self) -> list:
        """The session's trace events, from the one export it allows."""
        with tempfile.TemporaryDirectory() as tmp:
            path = Path(tmp) / "trace.json"
            self.prof.export_chrome_trace(str(path))
            return _json(path)["traceEvents"]

    def events(self):
        """:func:`parse_events` of the session's trace; None without a
        session."""
        if self.prof is None:
            return None
        return parse_events(self.export())


def parse_events(events):
    """(device operations ``(name, start, end)``: kernels, copies and fills,
    host spans ``(label, start, end)``: the harness's ``tb:`` labels
    without their prefix and the program's ``lt:`` labels with it, the
    stretch ``(start, end)``), in seconds on the profiler's clock, from an
    exported trace's events (which tell a kernel from an annotation)."""
    device, spans, stretch = [], [], None
    for e in events:
        if e.get("ph") != "X":
            continue
        name, category = e.get("name", ""), e.get("cat", "")
        start = float(e["ts"]) / 1e6
        end = start + float(e.get("dur", 0)) / 1e6
        if category in DEVICE_CATEGORIES:
            device.append((name, start, end))
        elif category != "user_annotation":
            continue
        elif name == "tb:window":
            stretch = (start, end)
        elif name.startswith("tb:"):
            spans.append((name[3:], start, end))
        elif name.startswith("lt:"):
            spans.append((name, start, end))
    return device, spans, stretch


def trace_record(profiled: Profiled, cell, sizes: dict, updates: int):
    """What the per-layer readers read of the profiled stretch, and the
    ``breakdown`` of the result line; None without device activity."""
    events = profiled.events()
    if events is None or events[2] is None or not events[0]:
        return None, None
    device, spans, (lo, hi) = events
    inside = [(n, max(s, lo), min(e, hi)) for n, s, e in device
              if min(e, hi) > max(s, lo)]
    intervals = [(s, e) for _, s, e in inside]
    busy = tr.busy_seconds(intervals, lo, hi)
    ops = {}
    for name, s, e in inside:
        family = tr.family_of(name, cell.families)
        key = family["name"] if family else tr.template_name(name)
        ops[key] = ops.get(key, 0.0) + (e - s)
    gaps = tr.label_gaps(tr.idle_gaps(intervals, lo, hi), spans)
    top = lambda d: [[k, v] for k, v in sorted(d.items(),  # noqa: E731
                                               key=lambda kv: -kv[1])[:10]]
    share, unknown = tr.roofline_share(
        [(n, e - s) for n, s, e in inside], cell.families, sizes, updates,
        cell.peaks)
    if unknown:
        print(f"kernels of no family (zero bound): {', '.join(unknown)}")
    lt_names = {}
    for n, _, _ in inside:
        if cell.peaks["kernel_prefix"] in n:
            lt_names[n] = lt_names.get(n, 0) + 1
    for n, count in sorted(lt_names.items()):
        print(f"program kernel recorded {count} times: {n}")
    lt_launches = sum(lt_names.values())
    print(f"profiled stretch: {hi - lo:.6f} s, {len(inside)} device "
          f"operations ({lt_launches} of the program's kernels), busy "
          f"{busy:.6f} s")
    record = SimpleNamespace(busy_s=busy, window_s=hi - lo,
                             roofline=share)
    return record, {"device_ops": top(ops), "idle_gaps": top(gaps)}


# ----------------------------------------------------------------------
# the two traffic kinds
# ----------------------------------------------------------------------
def _generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed))


def _host_buffer(like: torch.Tensor) -> torch.Tensor:
    return torch.empty(like.shape, dtype=like.dtype,
                       pin_memory=like.is_cuda)


def _print_pace(what, t0, ends):
    """The window's pace: milliseconds of each call or iteration, the
    slowest, median and fastest, and of each quarter of the window."""
    ms = sorted(1e3 * (b - a) for a, b in zip([t0] + ends, ends))
    quarters = [len(ends) * k // 4 for k in range(5)]
    pace = [1e3 * (ends[b - 1] - (t0 if a == 0 else ends[a - 1])) / (b - a)
            for a, b in zip(quarters, quarters[1:]) if b > a]
    print(f"window: {len(ends)} {what}s, ms each: fastest {ms[0]:.3f}, "
          f"median {ms[len(ms) // 2]:.3f}, slowest {ms[-1]:.3f}; by "
          f"quarter {', '.join(f'{p:.3f}' for p in pace)}")


def rollout(run):
    """A closed loop of ``simulation(steps_per_call)`` calls. One call,
    drawn from the seed among the first ``check_calls``, has its input and
    output copied to the host (on a side stream, beside the next call);
    the check replays it. Past the flow's horizon the state starts again
    from the seeded one, in place."""
    sim, traffic, seconds = run.sim, run.cell.traffic, run.seconds
    steps = traffic["steps_per_call"]
    checked = random.Random(run.seed).randrange(traffic["check_calls"])
    horizon = run.flow.horizon_steps(run.config)
    cuda = run.device != "cpu"
    side = torch.cuda.Stream() if cuda else None
    host_in, host_out = _host_buffer(sim.flow.f), _host_buffer(sim.flow.f)

    def copy(host, state):
        if not cuda:
            host.copy_(state)
            return
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            host.copy_(state, non_blocking=True)

    spans = run.spans
    import lettuce_tpu_torch.simulation as simulation_module
    launch = simulation_module.stream_collide
    simulation_module.stream_collide = spans.wrap("wrapper", launch)
    profiled = Profiled(spans, traffic["profile_at"],
                        traffic["profile_calls"])
    try:
        sim(steps)  # the warm-up call: every shape of the window
        since_seed = steps
        spans.seconds.clear()
        run.synchronize()
        run.reset_peak()
        run.program.open()
        t0 = time.perf_counter()
        run.window_start = t0
        calls, held = 0, None
        ends = []
        while True:
            profiled.before(time.perf_counter() - t0, seconds)
            if horizon is not None and since_seed + steps > horizon:
                run.synchronize()  # no copy of the state is in flight
                run.flow.initial(run.config, run.device, sim.flow.f.dtype,
                                 _generator(run.seed, run.device),
                                 out=sim.flow.f)
                since_seed = 0
            if calls == checked:
                copy(host_in, sim.flow.f)
                held = sim.flow.f
            with spans.span("call"):
                sim(steps)
            since_seed += steps
            if calls == checked:
                # the input's copy ended with the call's synchronize
                copy(host_out, sim.flow.f)
                held = sim.flow.f
            elif calls == checked + 1:
                held = None
            calls += 1
            ends.append(time.perf_counter())
            profiled.after()
            if (time.perf_counter() - t0 >= seconds
                    and calls > checked + 1 and not profiled.active):
                break
        t1 = time.perf_counter()
        run.peak = run.read_peak()
    finally:
        run.program.close()
        simulation_module.stream_collide = launch
    del held
    _print_pace("call", t0, ends)
    run.attempted = calls
    run.window_s = t1 - t0
    run.steps = calls * steps
    run.finite = bool(torch.isfinite(sim.flow.f).all())
    run.profiled = profiled
    run.saved = SimpleNamespace(f_in=host_in, f_out=host_out, steps=steps,
                                call=checked)


def adam(run):
    """A closed loop of Adam iterations on the initial state: each runs
    ``make_segment_fn(segment_steps)``, the mean squared distance of the
    rollout's velocity from a seeded target, ``backward()``, Adam's step
    and ``loss.item()``. The first ``check_steps`` iterations run in the
    set-up through the same call, and the check follows them."""
    sim, traffic, seconds = run.sim, run.cell.traffic, run.seconds
    n = traffic["segment_steps"]
    p = run.params
    optimizer = torch.optim.Adam([p], lr=traffic["lr"])
    segment = run.segment_fn(sim, n)
    target = run.target
    spans = run.spans

    def iteration(timed_backward, keep=None):
        optimizer.zero_grad(set_to_none=True)
        with spans.span("segment"):
            x = segment(p)
        if keep is not None:
            keep.copy_(x.detach())
        with spans.span("loss"):
            loss = torch.mean((sim.flow.view(x).u() - target) ** 2)
        with spans.span("backward", sync=timed_backward):
            loss.backward()
        with spans.span("optimizer"):
            optimizer.step()
        return loss.item()

    p0 = p.detach().clone()
    first = _host_buffer(p)
    losses, grad_norm = [], None
    for i in range(traffic["check_steps"]):
        losses.append(iteration(False, first if i == 0 else None))
        if i == 0:
            beta1 = optimizer.param_groups[0]["betas"][0]
            grad_norm = (optimizer.state[p]["exp_avg"].float().norm()
                         / (1 - beta1)).item()
    change = (p.detach().float() - p0.float()).norm().item()
    del p0
    run.saved = SimpleNamespace(losses=losses, grad_norm=grad_norm,
                                change=change, first=first)
    profiled = Profiled(spans, traffic["profile_at"],
                        traffic["profile_calls"])
    spans.seconds.clear()
    run.synchronize()
    run.reset_peak()
    run.program.open()
    t0 = time.perf_counter()
    run.window_start = t0
    iterations = 0
    last = losses[-1]
    ends = []
    try:
        while True:
            profiled.before(time.perf_counter() - t0, seconds)
            last = iteration(timed_backward=not profiled.active)
            iterations += 1
            ends.append(time.perf_counter())
            profiled.after()
            if time.perf_counter() - t0 >= seconds and not profiled.active:
                break
        t1 = time.perf_counter()
        run.peak = run.read_peak()
    finally:
        run.program.close()
    _print_pace("iteration", t0, ends)
    run.attempted = iterations
    run.window_s = t1 - t0
    run.steps = iterations * n
    run.finite = math.isfinite(last)
    run.profiled = profiled
    run.backward_steps = n


KINDS = {"rollout": rollout, "adam": adam}


# ----------------------------------------------------------------------
# the check against the plain reference
# ----------------------------------------------------------------------
def _max_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| / max |want|, population by population."""
    worst = scale = 0.0
    for i in range(want.shape[0]):
        w = want[i].float()
        worst = max(worst, (got[i].float() - w).abs().max().item())
        scale = max(scale, w.abs().max().item())
    return worst / scale


def check_rollout(run) -> dict:
    """The sampled call replayed by the reference from its input, one step
    at a time with the configuration's collision: ``state_gap``, the
    largest population gap over the largest population."""
    saved = run.saved
    st, tau, channel = run.flow.reference(run.config, run.device)
    with torch.no_grad():
        f = saved.f_in.to(run.device, torch.float32)
        f = lbm.run(f, saved.steps, st, tau, channel, collide=run.collide)
        got = saved.f_out.to(run.device)
        return {"state_gap": _max_gap(got, f)}


def check_adam(run) -> dict:
    """The reference's first ``check_steps`` iterations from the same
    seeded state and target: each iteration's loss (``loss_gap``, the
    largest relative gap), the first gradient's norm as Adam holds it
    (``grad_gap``) and the norm of the state's change over the iterations
    (``change_gap``), each as a gap relative to the reference's; and the
    first iteration's rollout (``state_gap``, as a rollout's)."""
    traffic, saved = run.cell.traffic, run.saved
    st, tau, channel = run.flow.reference(run.config, run.device)
    f0, target = run.inputs(torch.float32)
    p, m, v = f0.clone(), torch.zeros_like(f0), torch.zeros_like(f0)
    losses, grad_norm = [], None
    for t in range(1, traffic["check_steps"] + 1):
        x = p.detach().requires_grad_(True)
        out = lbm.run(x, traffic["segment_steps"], st, tau, channel,
                      checkpointed=True, collide=run.collide)
        loss = torch.mean((lbm.velocity(out, st) - target) ** 2)
        loss.backward()
        losses.append(loss.item())
        g = x.grad
        if t == 1:
            grad_norm = g.norm().item()
            state_gap = _max_gap(saved.first.to(run.device), out.detach())
        del x, out, loss
        with torch.no_grad():
            p, m, v = lbm.adam_update(p, g, m, v, t, traffic["lr"])
        del g
    change = (p - f0).norm().item()
    return {
        "loss_gap": max(abs(a - b) / abs(b)
                        for a, b in zip(saved.losses, losses)),
        "grad_gap": abs(saved.grad_norm - grad_norm) / grad_norm,
        "change_gap": abs(saved.change - change) / change,
        "state_gap": state_gap}


CHECKS = {"rollout": check_rollout, "adam": check_adam}


def layout_matches(sim, config) -> bool:
    """Whether the program's velocity table is the reference's, population
    by population (the compared states share one layout)."""
    e = [tuple(int(c) for c in v) for v in sim.flow.stencil.e]
    return e == lbm.Stencil(config["stencil"]).e


# ----------------------------------------------------------------------
# one run
# ----------------------------------------------------------------------
def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", root: Path = ROOT, config=None,
             traffic=None, dtype=None, half_storage=False, fault=None,
             started: float = None) -> dict:
    """One run of the cell ``name``; returns the result line's object.
    ``config`` and ``traffic`` update the cell's (tests shrink them),
    ``dtype`` and ``half_storage`` switch the program to its lower
    precision paths (the check's control), and ``fault(sim)`` breaks the
    program underneath (the check's tests)."""
    import lettuce_tpu_torch as lt

    started = time.perf_counter() if started is None else started
    cell = load_cell(name, root)
    cell.config.update(config or {})
    cell.traffic.update(traffic or {})
    flow = _module(cell.home / "flows" / f"{cell.config['flow']}.py",
                   f"torch_bench_flow_{cell.config['flow']}")
    collision, params = collision_of(cell.config)
    program_side = collision_module(cell.home, "flows", collision)
    reference_side = collision_module(cell.home, "reference", collision)
    wide = DTYPES[cell.config["dtype"]]
    dtype = wide if dtype is None else DTYPES[dtype]
    cuda = device != "cpu"
    run = SimpleNamespace(
        cell=cell, config=cell.config, flow=flow, seed=seed,
        seconds=seconds, device=device, spans=Spans(trace),
        synchronize=(torch.cuda.synchronize if cuda else lambda: None),
        reset_peak=(torch.cuda.reset_peak_memory_stats if cuda
                    else lambda: None),
        read_peak=(torch.cuda.max_memory_allocated if cuda
                   else lambda: 0),
        segment_fn=lambda sim, n: sim.make_segment_fn(n),
        collide=functools.partial(reference_side.collide, params=params),
        program=ProgramWindow(trace, trace and asks_for_spans(cell)))

    def inputs(as_dtype):
        generator = _generator(seed, device)
        f0 = flow.initial(cell.config, device, as_dtype, generator)
        if cell.traffic["kind"] != "adam":
            return f0, None
        target = lbm.velocity(flow.initial(cell.config, device, as_dtype,
                                           generator), lbm.Stencil(
                                               cell.config["stencil"]))
        return f0, target

    run.inputs = inputs
    with blocking_span(cell.traffic.get("n_sub")):
        sim = flow.program(
            lt, cell.config, device, dtype, half_storage,
            collision=lambda built: program_side.program(lt, built, params))
    refuse_other_span(sim, cell.traffic.get("n_sub"))
    if half_storage and not sim.half_storage_engaged:
        raise SystemExit("half storage was asked for and the program "
                         "refused it")
    run.sim = sim
    if fault is not None:
        fault(run)
    f0, target = inputs(wide)
    if cell.traffic["kind"] == "adam":
        run.params = f0.to(dtype).requires_grad_(True)
        run.target = target.to(dtype)
        sim.flow.f = run.params.detach()
    else:
        sim.flow.f = f0.to(dtype)
    del f0, target
    print(f"cell {name}: seed {seed}, step path {sim.step_path}, "
          f"half storage {sim.half_storage_engaged}, state "
          f"{tuple(sim.flow.f.shape)} {sim.flow.f.dtype}")
    KINDS[cell.traffic["kind"]](run)
    setup_s = run.window_start - started
    peak = run.peak

    cells = math.prod(cell.config["resolution"])
    st = lbm.Stencil(cell.config["stencil"])
    sizes = {"q": st.q, "d": st.d, "s": torch.finfo(dtype).bits // 8,
             "c": max(4, torch.finfo(dtype).bits // 8), "m": 1}
    traced, breakdown = (trace_record(run.profiled, cell, sizes, cells)
                         if trace and cuda else (None, None))
    record = SimpleNamespace(
        kind=cell.traffic["kind"], cells=cells, steps=run.steps,
        window_s=run.window_s, setup_s=setup_s, peak_bytes=peak,
        spans=run.spans.seconds, trace=traced,
        segment_steps=cell.traffic.get("segment_steps"),
        program=run.program.reading(run.profiled.stretch(), run.steps))
    metrics = read_metrics(cell.per_layer if trace else cell.end_to_end,
                           record, cell.home)

    layout = layout_matches(sim, cell.config)
    run.sim = sim = None
    if cell.traffic["kind"] == "adam":
        run.params = run.target = None
    if cuda:
        torch.cuda.empty_cache()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    numbers = CHECKS[cell.traffic["kind"]](run) if layout else {}
    checks = {k: {"value": v if math.isfinite(v) else None,
                  "limit": cell.limits.get(k)} for k, v in numbers.items()}
    correct = (layout and run.finite and bool(checks) and all(
        c["limit"] is not None and c["value"] is not None
        and c["value"] <= c["limit"] for c in checks.values()))
    if not layout:
        checks["layout"] = {"value": 1, "limit": 0}
    checks["finite"] = {"value": int(run.finite), "limit": 1}
    result = {"correct": correct, "attempted": run.attempted,
              "failed": 0 if correct else 1, "metrics": metrics,
              "device": {"platform": "gpu",
                         "kind": (torch.cuda.get_device_name(0) if cuda
                                  else "cpu"),
                         "count": cell.chips, "memory_peak_bytes": peak}}
    if traced is not None:
        result["device"]["busy_s"] = traced.busy_s
        result["device"]["window_s"] = traced.window_s
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result


def forbidden_modules() -> list:
    """The names of :data:`FORBIDDEN` that are loaded (``sys.modules``,
    compared by whole top-level names)."""
    return sorted({name.split(".")[0] for name in sys.modules}
                  & set(FORBIDDEN))


def main(args) -> int:
    """The command: prints the card, the run's lines, the compared numbers
    on standard error and the result as the last line of standard
    output; exits 1 with no result when the run loaded JAX or the JAX
    package."""
    started = time.perf_counter() - process_age()
    cell = load_cell(args.workload)
    for line in card_lines(cell.chips):
        print(line)
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), started=started)
    found = forbidden_modules()
    if found:
        print(f"the run loaded {', '.join(found)}: the benchmark measures "
              f"lettuce_tpu_torch alone; no result", file=sys.stderr)
        return 1
    for name, c in result["checks"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
