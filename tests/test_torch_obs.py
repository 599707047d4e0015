"""The observability layer of the PyTorch port (``repro_torch.obs``)
against the reference's (``repro.obs``), twin of ``tests/test_obs.py`` and
``tests/test_diagnostics.py`` (minus the tools' own tests).

* Schema: ``SysEvent``'s leading fields and legacy projection, the event
  kinds, the tracer's nesting and clocks, the contextvar, the registry.
* Off and on are bitwise equal: both engines, fedavg and fedepth, with
  and without a lossy codec, ``obs="on"`` and ``"full"``; the legacy
  trace is the projection of the typed events.
* The metric catalog (every name the sources record) is the reference's
  minus :data:`repro_torch.obs.NOT_PORTED_METRICS`; on the same runs
  from the same parameters, every counter the port records equals the
  reference's (deadline misses, spills and disk loads, prefix-cache
  buffers and advances, faults, retries, quarantines, rejections,
  checkpoints, bytes, group dispatches), and so do the dynamics'
  rejection overlay and its per-client update norms (1e-4).
* Exporters: the Chrome trace reads through ``tools/trace_report.py``,
  the Prometheus text and the JSONL lines equal the reference's for the
  same registry.
* The auditor: ``unavailable`` on the CPU without raising; its dedupe,
  predictions, budget checks and table equal the reference's under one
  injected measurement.

Sizes: reduced PreResNet at 16 x 16, 8 clients; the reference's runs
are made once per module.
"""
import dataclasses
import json
import pathlib
import re
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs.preresnet20 import reduced as j_reduced  # noqa: E402
from repro.fl.data import build_federated as j_federated  # noqa: E402
from repro.fl.engine import RoundEngine as JEngine  # noqa: E402
from repro.fl.engine import SimConfig as JSim  # noqa: E402
from repro.fl.engine import build_context as j_context  # noqa: E402
from repro.fl.faults import FaultPlan as JPlan  # noqa: E402
from repro.fl.faults import ResiliencePolicy as JPolicy  # noqa: E402
from repro.fl.registry import get_strategy as j_get_strategy  # noqa: E402
from repro.fl.scale.state_store import SpillStore as JSpill  # noqa: E402
from repro.fl import systime as J  # noqa: E402
import repro.obs as jobs  # noqa: E402
from repro.obs import audit as j_audit  # noqa: E402
from repro.obs import export as j_export  # noqa: E402
from repro_torch.configs.preresnet20 import reduced  # noqa: E402
from repro_torch.fl import systime as T  # noqa: E402
from repro_torch.fl.data import build_federated  # noqa: E402
from repro_torch.fl.engine import (RoundEngine, SimConfig,  # noqa: E402
                                   build_context)
from repro_torch.fl.faults import FaultPlan, ResiliencePolicy  # noqa: E402
from repro_torch.fl.registry import get_strategy  # noqa: E402
from repro_torch.fl.scale import JsonlHistorySink, SpillStore  # noqa: E402
from repro_torch.fl.systime.staleness import polynomial_discount  # noqa: E402
from repro_torch.obs import (LEGACY_FIELDS, NOT_PORTED_METRICS,  # noqa: E402
                             SYS_EVENT_KINDS, DynamicsAnalyzer,
                             MemoryAuditor, Obs, SysEvent, Tracer, activate,
                             active, make_obs, span_if)
from repro_torch.obs.audit import ERROR_RATIO_BOUNDS, Measurement  # noqa: E402
from repro_torch.obs.dynamics import _discount, _gini  # noqa: E402
from repro_torch.obs.export import to_prometheus  # noqa: E402
from repro_torch.obs.metrics import MetricsRegistry  # noqa: E402
from repro_torch.testing.convert import params_to_reference  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402
from torch_helpers import one_torch_thread  # noqa: E402,F401

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools"))
import trace_report  # noqa: E402

DATA = dict(num_clients=8, alpha=1.0, n_train=320, n_test=160,
            image_size=16, seed=0)
SIM = dict(rounds=2, participation=0.5, lr=0.05, local_steps=1,
           batch_size=32, scenario="fair", seed=0)
MIX = {"iot": 0.25, "phone": 0.5, "workstation": 0.25}
HEAVY = dict(seed=7, crash_rate=0.1, drop_rate=0.1, corrupt_rate=0.15,
             diverge_rate=0.1, slowdown_rate=0.1)
TDATA = build_federated(**DATA, device="cpu")
CFG = reduced(num_classes=10, image_size=16)


def _ctx(**sim):
    return build_context(TDATA, SimConfig(**{**SIM, **sim}), model_cfg=CFG,
                         device="cpu")


def _strip(history):
    return [(r.round, r.accuracy, r.comm_bytes, r.sim_seconds,
             r.down_bytes) for r in history]


def _equal(a, b) -> bool:
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


def _slow_profiles(mod):
    slow = mod.DeviceProfile("crawler", flops=float("inf"),
                             mem_bw=float("inf"), link_up=1.0,
                             link_down=float("inf"), mem_bytes=float("inf"))
    return [slow if k < 4 else mod.ZERO_LATENCY for k in range(8)]


# --------------------------------------------------------------------------
# the same three runs on both sides
# --------------------------------------------------------------------------
def _runs(side, tmp):
    """(name, engine) of three instrumented runs, each from the port's
    initial parameters (in the side's layout): a vectorized FeDepth round
    engine under qsgd_int8; an async FedAvg under the HEAVY fault plan
    with quarantine, a spilling store and checkpoints; a sync FedAvg with
    a deadline two slow tiers miss.  Both fedavg runs share one context's
    compiled steps."""
    ref = side == "ref"
    jcfg = j_reduced(num_classes=10, image_size=16)
    data = j_federated(**DATA) if ref else TDATA

    def ctx(**sim):
        if ref:
            return j_context(data, JSim(**{**SIM, **sim}), model_cfg=jcfg)
        return _ctx(**sim)

    S = J if ref else T
    strat = (j_get_strategy if ref else get_strategy)
    obs = (lambda: jobs.Obs(dynamics=jobs.DynamicsAnalyzer())) if ref \
        else (lambda: Obs(dynamics=DynamicsAnalyzer()))
    inits = []
    for name in ("fedepth", "fedavg"):
        st, c = get_strategy(name), _ctx()
        st.setup(c)
        inits.append(st.init_state(c))
    fedepth, fedavg = inits
    if ref:
        fedepth, fedavg = (params_to_reference(fedepth),
                           params_to_reference(fedavg))
    c1 = ctx()
    e1 = (JEngine if ref else RoundEngine)(
        strat("fedepth"), c1, scheduler="vectorized", codec="qsgd_int8",
        obs=obs())
    c2 = ctx(rounds=4)
    e2 = S.AsyncEngine(
        strat("fedavg"), c2,
        system=S.SystemModel(S.mixed_profiles(8, MIX, seed=0)),
        mode="async", faults=(JPlan if ref else FaultPlan)(**HEAVY),
        resilience=(JPolicy if ref else ResiliencePolicy)(),
        state_store=(JSpill if ref else SpillStore)(2, dir=str(tmp / side)),
        checkpoint_every=2, checkpoint_dir=str(tmp / f"ckpt-{side}"),
        obs=obs())
    c3 = ctx(participation=1.0)
    c3.caches = c2.caches
    e3 = S.AsyncEngine(strat("fedavg"), c3,
                       system=S.SystemModel(_slow_profiles(S)), mode="sync",
                       deadline_s=1.0, obs=obs())
    for eng, init in ((e1, fedepth), (e2, fedavg), (e3, fedavg)):
        eng.run(initial_state=init, eval_every=2)
    return {"round": e1, "faulted": e2, "deadline": e3}


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("runs")
    return _runs("ref", tmp), _runs("port", tmp)


def _counters(engine) -> dict:
    return {(m["name"], tuple(sorted(m["labels"].items()))): m["value"]
            for m in engine.obs.metrics.snapshot()
            if m["type"] == "counter"}


@pytest.mark.parametrize("run", ["round", "faulted", "deadline"])
def test_counters_equal_reference(both, run):
    ref, port = both[0][run], both[1][run]
    want = {k: v for k, v in _counters(ref).items()
            if k[0] not in NOT_PORTED_METRICS}
    got = _counters(port)
    assert got == want
    names = {k[0] for k in got}
    expect = {"round": {"prefix_cache_buffer", "prefix_cache_advance",
                        "group_dispatches", "codec_encoded_bytes",
                        "engine_up_bytes"},
              "faulted": {"faults_injected", "fault_retries",
                          "quarantined_updates", "dynamics_rejections",
                          "state_store_evictions", "state_store_disk_loads",
                          "checkpoints_written"},
              "deadline": {"deadline_misses"}}[run]
    assert expect <= names, expect - names
    assert port.trace == ref.trace if run != "round" else True


def test_dynamics_equal_reference(both):
    """The rejection overlay equal; each merge's per-client update norms
    and cosines within 1e-4 of the reference's (float64 on both sides,
    over parameters that agree to the engine tolerance)."""
    ref, port = both[0]["faulted"].obs.dynamics, \
        both[1]["faulted"].obs.dynamics
    assert port.rejections == ref.rejections and port.rejections
    assert port.client_summary()[0].keys() == ref.client_summary()[0].keys()
    assert [r["clients"] and [c["client"] for c in r["clients"]]
            for r in port.rounds] == \
        [r["clients"] and [c["client"] for c in r["clients"]]
         for r in ref.rounds]
    for r, jr in zip(port.rounds, ref.rounds):
        assert r["block_norms"].keys() == jr["block_norms"].keys()
        assert r["participation_gini"] == pytest.approx(
            jr["participation_gini"])
        for c, jc in zip(r["clients"], jr["clients"]):
            assert c["contribution"] == pytest.approx(jc["contribution"])
            assert c["norm"] == pytest.approx(jc["norm"], rel=1e-4)
    for r in both[1]["round"].obs.dynamics.rounds:
        for c in r["clients"]:
            assert -1.0 <= c["cosine"] <= 1.0 and c["norm"] >= 0.0


def _names(pkg: pathlib.Path) -> set:
    """Every metric name the package's sources record (first argument of
    a ``counter`` / ``gauge`` / ``histogram`` call, a literal, or the
    prefix-cache pair chosen by a conditional)."""
    out = set()
    for path in pkg.rglob("*.py"):
        text = path.read_text()
        out |= set(re.findall(
            r"\.(?:counter|gauge|histogram|_count|_obs_counter)\(\s*"
            r"\"([a-z_]+)\"", text))
        out |= set(re.findall(r"\"(prefix_cache_[a-z]+)\" if", text))
        out |= set(re.findall(r"else \"(prefix_cache_[a-z]+)\"", text))
    return out


def test_metric_catalog_is_the_reference_minus_jit_metrics(both):
    ref = _names(ROOT / "src" / "repro")
    port = _names(ROOT / "src" / "repro_torch")
    assert set(NOT_PORTED_METRICS) <= ref
    assert port == ref - set(NOT_PORTED_METRICS)
    recorded = {m["name"] for side in both for run in side.values()
                for m in run.obs.metrics.snapshot()}
    assert recorded - set(NOT_PORTED_METRICS) <= port
    assert (ROOT / "README.md").read_text().count("jit_cache_hits") >= 1


# --------------------------------------------------------------------------
# schema
# --------------------------------------------------------------------------
def test_sys_event_schema_equals_reference():
    names = tuple(f.name for f in dataclasses.fields(SysEvent))
    assert names == tuple(f.name for f in dataclasses.fields(jobs.SysEvent))
    assert names[:5] == LEGACY_FIELDS == jobs.LEGACY_FIELDS
    assert SYS_EVENT_KINDS == jobs.SYS_EVENT_KINDS
    ev = SysEvent("finish", 1.5, 3, 7, 0.25, wall_t=99.0,
                  attrs={"tier": "iot"})
    assert ev.legacy() == ("finish", 1.5, 3, 7, 0.25)
    assert type(ev.legacy()) is tuple


def test_tracer_contextvar_and_registry():
    t = [0.0]
    tr = Tracer(sim_clock=lambda: t[0])
    with tr.span("round", round=0) as outer:
        t[0] = 2.0
        with tr.span("client-update", client=1) as inner:
            t[0] = 5.0
        tr.event("mark")
    assert inner.parent_id == outer.span_id
    assert outer.sim_seconds == 5.0 and inner.sim_seconds == 3.0
    assert outer.wall_seconds >= inner.wall_seconds >= 0.0
    assert tr.events[0].span_id == outer.span_id
    assert active() is None
    obs = make_obs(True)
    with activate(obs):
        assert active() is obs
        with activate(None):
            assert active() is None
    assert active() is None
    assert make_obs(None) is None and make_obs("off") is None
    assert make_obs(obs) is obs and make_obs("on").audit is None
    full = make_obs("full")
    assert full.audit is not None and full.dynamics is not None
    with pytest.raises(ValueError):
        make_obs("loud")
    with span_if(None, "x") as sp:
        assert sp is None
    m = obs.metrics
    c = m.counter("hits", cache="group")
    c.inc(3)
    assert m.counter("hits", cache="group") is c and m.value(
        "hits", cache="group") == 3.0
    with pytest.raises(ValueError):
        c.inc(-1)
    with pytest.raises(TypeError):
        m.gauge("hits", cache="group")


@pytest.mark.parametrize("tau", [0.0, 1.0, 10.0])
@pytest.mark.parametrize("alpha", [0.0, 0.5, 1.5])
def test_dynamics_discount_and_gini(tau, alpha):
    assert _discount(tau, alpha) == polynomial_discount(tau, alpha)
    assert _gini([]) == 0.0 and _gini([5, 5, 5]) == pytest.approx(0.0)
    assert 0.0 <= _gini([0, 0, 10]) <= 1.0


# --------------------------------------------------------------------------
# off == on, bitwise
# --------------------------------------------------------------------------
@pytest.mark.parametrize("method,codec", [
    ("fedavg", "none"), ("fedavg", "qsgd_int8"),
    ("fedepth", "none"), ("fedepth", "qsgd_int8")])
def test_obs_off_on_bitwise(method, codec):
    """Both engines, telemetry off, "on" and "full": the same parameters
    bitwise, the same history rows and (``AsyncEngine``) the same legacy
    trace, which is the projection of the typed events."""
    def round_run(obs):
        eng = RoundEngine(get_strategy(method), _ctx(),
                          scheduler="vectorized", codec=codec, obs=obs)
        return (eng,) + eng.run(eval_every=2)

    def async_run(obs):
        eng = T.AsyncEngine(get_strategy(method), _ctx(),
                            system=T.SystemModel(T.mixed_profiles(
                                8, MIX, seed=0)),
                            mode="async", codec=codec, obs=obs)
        return (eng,) + eng.run(eval_every=2)

    for run in (round_run, async_run):
        e0, s0, h0 = run(None)
        for spec in ("on", "full"):
            e1, s1, h1 = run(spec)
            assert _equal(s0, s1) and repr(_strip(h0)) == repr(_strip(h1))
            assert len(e1.obs.tracer.spans) > 0 and len(e1.obs.metrics)
            if run is async_run:
                assert repr(e0.trace) == repr(e1.trace)
                assert e1.obs.tracer.legacy_trace() == e1.trace
    kinds = {s.kind for s in e1.obs.tracer.spans}
    assert {"client-update", "aggregate"} <= kinds


def test_sync_events_carry_phase_lanes_and_spans():
    eng = RoundEngine(get_strategy("fedepth"), _ctx(), obs="on")
    eng.run(eval_every=1)
    kinds = [s.kind for s in eng.obs.tracer.spans]
    assert {"round", "client-update", "block", "eval"} <= set(kinds)
    assert kinds.count("round") == kinds.count("eval") == 2
    e = T.AsyncEngine(get_strategy("fedavg"), _ctx(participation=1.0),
                      system=T.SystemModel(_slow_profiles(T)), mode="sync",
                      deadline_s=1.0, obs="on")
    e.run(eval_every=1)
    opened = [ev for ev in e.obs.tracer.sys_events
              if ev.kind in ("finish", "miss")]
    assert opened and all("start" in ev.attrs and "tier" in ev.attrs
                          and "compute" in ev.attrs for ev in opened)


def test_obs_reset_isolates_sequential_runs():
    obs = make_obs("full")
    RoundEngine(get_strategy("fedavg"), _ctx(), obs=obs).run(eval_every=2)
    rounds1 = obs.metrics.value("engine_rounds", engine="round")
    spans1 = len(obs.tracer.spans)
    assert rounds1 == 2 and spans1 > 0
    obs.reset()
    assert len(obs.tracer.spans) == 0 and len(obs.metrics) == 0
    RoundEngine(get_strategy("fedavg"), _ctx(), obs=obs).run(eval_every=2)
    assert obs.metrics.value("engine_rounds", engine="round") == rounds1
    assert len(obs.tracer.spans) == spans1


# --------------------------------------------------------------------------
# exporters
# --------------------------------------------------------------------------
def test_chrome_trace_reads_through_trace_report(both, tmp_path):
    cap = both[1]["faulted"].obs
    path = tmp_path / "trace.json"
    doc = cap.export_chrome_trace(str(path))
    assert json.loads(path.read_text()) == doc
    report = trace_report.summarize(trace_report.load_events(str(path)))
    assert set(report["tiers"]) == set(MIX)
    for tier in report["tiers"].values():
        assert tier["total_s"] > 0.0 and tier["intervals"] > 0
    assert trace_report.main([str(path), "--json",
                              str(tmp_path / "r.json")]) == 0
    jdoc = j_export.to_chrome_trace(both[0]["faulted"].obs)
    sim = [(e["ph"], e.get("tid"), e["name"], e.get("ts"), e.get("dur"))
           for e in doc["traceEvents"] if e.get("pid") == 1
           and e.get("cat") != "span"]
    jsim = [(e["ph"], e.get("tid"), e["name"], e.get("ts"), e.get("dur"))
            for e in jdoc["traceEvents"] if e.get("pid") == 1
            and e.get("cat") != "span"]
    assert sim == jsim


def _fill(registry):
    registry.counter("odd", path='a"b\\c\nd').inc(2)
    h = registry.histogram("lat_s", buckets=(1.0, 2.0), tier="iot")
    for v in (0.5, 1.5, 5.0):
        h.observe(v)
    registry.gauge("bytes").set(7)
    registry.histogram("staleness").observe(3.0)
    return registry


def test_prometheus_and_jsonl_equal_reference(both, tmp_path):
    text = to_prometheus(_fill(MetricsRegistry()))
    assert text == j_export.to_prometheus(_fill(jobs.MetricsRegistry()))
    assert 'path="a\\"b\\\\c\\nd"' in text and "\n\n" not in text
    port = both[1]["deadline"].obs
    n = port.export_jsonl(str(tmp_path / "t.jsonl"))
    lines = [json.loads(x) for x in
             (tmp_path / "t.jsonl").read_text().splitlines()]
    assert len(lines) == n and {"span", "sys_event", "metric"} <= {
        x["kind"] for x in lines}
    ref = both[0]["deadline"].obs
    j_export.to_jsonl(ref, str(tmp_path / "j.jsonl"))
    jlines = [json.loads(x) for x in
              (tmp_path / "j.jsonl").read_text().splitlines()]

    def sys_lines(ls):
        return [{k: v for k, v in x.items() if k != "wall_t"}
                for x in ls if x["kind"] == "sys_event"]
    assert sys_lines(lines) == sys_lines(jlines)
    with JsonlHistorySink(str(tmp_path / "mixed.jsonl")) as sink:
        sink.write({"round": 1, "accuracy": 0.5})
        port.export_jsonl(sink)
    first = (tmp_path / "mixed.jsonl").read_text().splitlines()[0]
    assert json.loads(first)["kind"] == "round"


# --------------------------------------------------------------------------
# the memory auditor
# --------------------------------------------------------------------------
def test_audit_unavailable_on_the_cpu_never_raises():
    obs = make_obs("full")
    eng = RoundEngine(get_strategy("fedepth"), _ctx(), obs=obs)
    eng.run(eval_every=2)
    cells = obs.audit.table()
    assert cells and all(c["status"] == "unavailable" and c["detail"]
                         for c in cells)
    assert obs.metrics.value("audit_cells", status="unavailable") == \
        len(cells)
    blocks = {b for k in range(8) for b in eng.ctx.decomps[k].blocks}
    assert {(c["lo"], c["hi"]) for c in cells} <= blocks
    # an error of the step itself propagates; a measurement's does not
    aud = MemoryAuditor()
    with pytest.raises(ZeroDivisionError):
        aud.audit_block_step(lambda b: 1 / 0, ({"x": torch.ones(2)},),
                             family="resnet", lo=0, hi=1,
                             variant="buffered")


def _fake_xla(stats):
    """An object the reference's auditor lowers and compiles, whose
    memory analysis reports ``stats``."""
    analysis = types.SimpleNamespace(**stats)
    compiled = types.SimpleNamespace(memory_analysis=lambda: analysis)
    lowered = types.SimpleNamespace(compile=lambda: compiled)
    return types.SimpleNamespace(lower=lambda *a: lowered)


@pytest.mark.parametrize("temp", [1_000, 3_000_000, 10 ** 9])
def test_audit_logic_equals_reference_under_one_measurement(temp):
    """The same measured bytes into both auditors, bound to the same
    experiment: the same cells (dedupe per (family, lo, hi, variant,
    batch)), predictions, error ratios, budget bounds and violated
    tiers, and the same counters."""
    ctx = _ctx()
    jctx = j_context(j_federated(**DATA), JSim(**SIM),
                     model_cfg=j_reduced(num_classes=10, image_size=16))
    stats = dict(temp_size_in_bytes=temp, argument_size_in_bytes=40_000,
                 output_size_in_bytes=0, generated_code_size_in_bytes=0)
    tm, jm = MetricsRegistry(), jobs.MetricsRegistry()
    port = MemoryAuditor(measure=lambda fn, args: (fn(*args), Measurement(
        temp=temp, argument=40_000, output=0, code=0), 0)).bind(ctx, tm)
    ref = j_audit.MemoryAuditor().bind(jctx, jm)
    batch = {"images": np.ones((32, 16, 16, 3), np.float32)}
    cells = [(lo, hi) for d in ctx.decomps for lo, hi in d.blocks]
    for lo, hi in cells + cells[:2]:
        for variant in ("buffered", "recompute"):
            port.audit_block_step(lambda b: b, (batch,), family="resnet",
                                  lo=lo, hi=hi, variant=variant)
            ref.audit_block_step(_fake_xla(stats), (batch,),
                                 family="resnet", lo=lo, hi=hi,
                                 variant=variant)
    assert port.table() == ref.table()
    assert port.query(violated_only=True) == ref.query(violated_only=True)
    assert to_prometheus(tm) == j_export.to_prometheus(jm)
    ratios = [c["error_ratio"] for c in port.table()]
    assert all(r is not None and r > 0 for r in ratios)
    assert ERROR_RATIO_BOUNDS == j_audit.ERROR_RATIO_BOUNDS
