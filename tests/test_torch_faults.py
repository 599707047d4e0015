"""Faults, quarantine and checkpoint / resume of the PyTorch port
(``repro_torch.fl.faults``, ``repro_torch.train.checkpoint``,
``repro_torch.fl.scale.state_store``) against the reference and against
the reference tests' contracts (tests/test_faults.py).

* Fault decisions equal the reference's over a grid of (round, client,
  attempt); the damage of a fault hits the same coordinates as the
  reference's in the reference's layout.
* The validator's three checks in order, the backoff pricing, the
  degradation policies.
* The checkpoint files: atomic, a corrupt or torn pair skipped, the
  ``.npz`` layout shared with the reference both ways (bf16 too), the
  aux blob with and without ``msgpack`` (128-bit ints included).
* The kill-and-resume contract, bitwise: ``RoundEngine`` under fp16,
  ``AsyncEngine`` with dispatches in flight, the HEAVY-faulted sync run.
* A faulted ``RoundEngine`` against the reference's, and no false
  quarantine on healthy runs (every method, both engines)."""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs.preresnet20 import reduced as j_reduced  # noqa: E402
from repro.fl.data import build_federated as j_federated  # noqa: E402
from repro.fl.engine import RoundEngine as JEngine  # noqa: E402
from repro.fl.engine import SimConfig as JSim  # noqa: E402
from repro.fl.engine import build_context as j_context  # noqa: E402
from repro.fl.faults import FaultInjector as JInjector  # noqa: E402
from repro.fl.faults import FaultPlan as JPlan  # noqa: E402
from repro.fl.faults import ResiliencePolicy as JPolicy  # noqa: E402
from repro.fl.registry import get_strategy as j_get_strategy  # noqa: E402
from repro.fl.faults import Fault as JFault  # noqa: E402
from repro.train import checkpoint as j_ckpt  # noqa: E402
from repro_torch.configs import get_reduced_config  # noqa: E402
from repro_torch.configs.preresnet20 import reduced  # noqa: E402
from repro_torch.fl.comm import CommChannel  # noqa: E402
from repro_torch.fl.data import build_federated  # noqa: E402
from repro_torch.fl.engine import (RoundEngine, SimConfig,  # noqa: E402
                                   build_context, resolve_checkpointing)
from repro_torch.fl.faults import (AttemptOutcome,  # noqa: E402
                                   EngineCheckpointer, Fault, FaultInjector,
                                   FaultPlan, FaultRuntime,
                                   ResiliencePolicy, UpdateValidator,
                                   tree_finite_max, update_norm)
from repro_torch.fl.faults.checkpointing import (device_tree,  # noqa: E402
                                                 host_tree)
from repro_torch.fl.registry import available, get_strategy  # noqa: E402
from repro_torch.fl.scale import state_store  # noqa: E402
from repro_torch.fl.systime import (DEVICE_TIERS, AsyncEngine,  # noqa: E402
                                    SystemModel, uniform_profiles)
from repro_torch.models import resnet  # noqa: E402
from repro_torch.models.api import build  # noqa: E402
from repro_torch.testing.convert import (params_from_reference,  # noqa: E402
                                        params_to_reference)
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402
from torch_helpers import assert_trees_close, one_torch_thread  # noqa: E402,F401

DATA = dict(num_clients=8, alpha=1.0, n_train=320, n_test=160,
            image_size=16, seed=0)
SIM = dict(rounds=4, participation=0.5, lr=0.05, local_steps=1,
           batch_size=32, scenario="fair", seed=0)
HEAVY_KW = dict(seed=7, crash_rate=0.1, drop_rate=0.1, corrupt_rate=0.15,
                diverge_rate=0.1, slowdown_rate=0.1)
HEAVY = FaultPlan(**HEAVY_KW)
SYS = SystemModel(uniform_profiles(8, DEVICE_TIERS["phone"]))
CFG = reduced(num_classes=10, image_size=16)


@pytest.fixture(scope="module")
def data():
    return build_federated(**DATA, device="cpu")


def _ctx(data, **sim):
    return build_context(data, SimConfig(**{**SIM, **sim}), model_cfg=CFG,
                         device="cpu")


def _equal(a, b) -> bool:
    a, b = getattr(a, "bases", a), getattr(b, "bases", b)
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


def _rows(h):
    # wall seconds are never bitwise; everything else must be
    return [(r.round, r.accuracy, r.comm_bytes, r.sim_seconds,
             r.down_bytes) for r in h]


# ------------------------------------------------------------------ plan
def test_knob_validation(data):
    with pytest.raises(ValueError):
        FaultPlan(crash_rate=-0.1)
    with pytest.raises(ValueError):
        FaultPlan(crash_rate=0.6, drop_rate=0.6)
    with pytest.raises(ValueError):
        ResiliencePolicy(degradation="nope")
    with pytest.raises(ValueError, match="checkpoint_dir"):
        RoundEngine(get_strategy("fedavg"), _ctx(data), checkpoint_every=2)
    with pytest.raises(ValueError, match="resume"):
        resolve_checkpointing(None, None, 3, True)
    with pytest.raises(ValueError, match="FaultPlan"):
        RoundEngine(get_strategy("fedavg"), _ctx(data), faults=object())
    with pytest.raises(ValueError, match="ResiliencePolicy"):
        RoundEngine(get_strategy("fedavg"), _ctx(data), resilience=3)
    assert resolve_checkpointing(None, None, 3, None) == (None, None)


def test_fault_decisions_equal_reference():
    """A decision is a pure function of (seed, round, client, attempt):
    the reference's, in any query order; a different seed draws other
    faults."""
    kw = dict(seed=3, crash_rate=0.2, drop_rate=0.2, corrupt_rate=0.2,
              diverge_rate=0.2, slowdown_rate=0.1, slowdown_factor=3.0)
    port, ref = FaultInjector(FaultPlan(**kw)), JInjector(JPlan(**kw))
    ids = [(r, k, t) for r in range(12) for k in range(10)
           for t in range(3)]
    fwd = [port.decide(*i) for i in ids]
    assert [ref.decide(*i) for i in reversed(ids)][::-1] == [
        None if f is None else JFault(**f.__dict__) for f in fwd]
    assert {f.kind for f in fwd if f is not None} == {
        "crash", "drop", "corrupt", "diverge", "slowdown"}
    other = FaultInjector(FaultPlan(**{**kw, "seed": 4}))
    assert [other.decide(*i) for i in ids] != fwd
    assert FaultPlan(**kw).total_rate == pytest.approx(0.9)


def test_damage_equals_reference_and_leaves_the_original():
    """corrupt: finite ~1e38 garbage; diverge: NaN; non-float leaves and
    the original untouched; the same fault identity the same damage, on
    the same coordinates as the reference's (its layout: conv weights
    HWIO)."""
    params = resnet.init(0, CFG, device="cpu")
    tree = {"p": params, "n": torch.arange(4, dtype=torch.int32)}
    before = [t.clone() for t in tree_leaves(tree)]
    inj = FaultInjector(FaultPlan(seed=0, corrupt_frac=0.01))
    jinj = JInjector(JPlan(seed=0, corrupt_frac=0.01))
    jtree = {"p": params_to_reference(params), "n": np.arange(4,
                                                               dtype=np.int32)}
    for kind in ("corrupt", "diverge"):
        bad = inj.damage_tree(tree, Fault(kind, 1, 2, 0))
        want = jinj.damage_tree(jtree, JFault(kind, 1, 2, 0))
        got = params_to_reference(bad["p"])
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want["p"])):
            assert np.array_equal(a, b, equal_nan=True)
        assert torch.equal(bad["n"], tree["n"])
        assert all(torch.equal(a, b) for a, b in
                   zip(tree_leaves(tree), before))
        w, w0 = bad["p"]["classifier"]["w"], params["classifier"]["w"]
        hit = ~(w == w0)
        assert hit.any()
        if kind == "corrupt":
            assert bool(torch.isfinite(w).all())
            assert float(w[hit].abs().min()) > 1e30
        else:
            assert bool(torch.isnan(w).any())
    again = inj.damage_tree(tree, Fault("corrupt", 1, 2, 0))
    assert _equal(again["p"], inj.damage_tree(tree, Fault("corrupt", 1, 2,
                                                           0))["p"])


@pytest.mark.parametrize("arch", ["mamba2-370m", "zamba2-1.2b",
                                  "qwen3-moe-235b-a22b"])
def test_lm_damage_equals_reference(arch):
    """On an LM tree the wire leaves stack the port's layers (zamba2's as
    (G, M) groups, a transformer's units under ``sub_0``): the damage
    lands on the reference's coordinates, scattered back into the
    right layer, and a bf16 payload stays bf16 with the same values as
    the reference's damage rounded to bf16."""
    params = build(get_reduced_config(arch)).init(0, device="cpu")
    jtree = params_to_reference(params)
    inj = FaultInjector(FaultPlan(seed=5, corrupt_frac=0.01))
    jinj = JInjector(JPlan(seed=5, corrupt_frac=0.01))
    for kind in ("corrupt", "diverge"):
        bad = inj.damage_tree(params, Fault(kind, 3, 1, 1))
        want = jinj.damage_tree(jtree, JFault(kind, 3, 1, 1))
        for a, b in zip(jax.tree.leaves(params_to_reference(bad)),
                        jax.tree.leaves(want)):
            assert np.array_equal(a, np.asarray(b), equal_nan=True)
    half = tree_map(lambda t: t.to(torch.bfloat16), params)
    bad = inj.damage_tree(half, Fault("corrupt", 3, 1, 1))
    want = jinj.damage_tree(params_to_reference(
        tree_map(lambda t: t.float(), half)), JFault("corrupt", 3, 1, 1))
    want = params_from_reference(jax.tree.map(np.asarray, want),
                                 device="cpu")
    for a, b in zip(tree_leaves(bad), tree_leaves(want)):
        assert a.dtype == torch.bfloat16
        assert torch.equal(a, b.to(torch.bfloat16))


# ------------------------------------------------------------- pricing
class _Lat:
    download, compute, upload = 2.0, 10.0, 3.0


def test_retry_backoff_pricing():
    pol = ResiliencePolicy(backoff_base_s=5.0, backoff_mult=2.0)
    assert pol.backoff_s(1) == 5.0 and pol.backoff_s(2) == 10.0
    out = AttemptOutcome(result=object(), attempts=3,
                         kinds=("crash", "drop"), crash_fracs=(0.4,),
                         drops=1, backoff_s=15.0, slowdown=1.0)
    assert out.total_seconds(_Lat()) == pytest.approx(
        2.0 + 15.0 + 4.0 + 13.0 + 13.0)
    out = AttemptOutcome(result=None, attempts=3, kinds=("drop",) * 3,
                         drops=3, backoff_s=15.0)
    assert not out.delivered
    assert out.total_seconds(_Lat()) == pytest.approx(2.0 + 15.0 + 39.0)
    out = AttemptOutcome(result=object(), kinds=("slowdown",),
                         slowdown=4.0)
    assert out.total_seconds(_Lat()) == pytest.approx(2.0 + 40.0 + 3.0)
    # a runtime over a plan that always drops retries max_retries times
    rt = FaultRuntime(FaultPlan(seed=0, drop_rate=1.0),
                      ResiliencePolicy(max_retries=2))
    calls = []
    out = rt.resolve(0, 3, "r0", lambda: calls.append(1) or "again")
    assert out.result is None and out.attempts == 3 and len(calls) == 2
    assert out.backoff_s == 5.0 + 10.0


def test_degradation_policies(data):
    ctx = _ctx(data)
    rt = FaultRuntime(None, ResiliencePolicy(degradation="overprovision",
                                             over_frac=0.5))
    grown = rt.overprovision(ctx, [0, 1, 2, 3])
    assert grown[:4] == [0, 1, 2, 3] and len(set(grown)) == 6
    rt = FaultRuntime(None, ResiliencePolicy(degradation="resample"))
    extra = rt.resample(ctx, [0, 1, 2, 3], 2)
    assert len(extra) == 2 and not set(extra) & {0, 1, 2, 3}
    assert FaultRuntime(None, ResiliencePolicy()).resample(ctx, [0], 1) \
        == []


# ---------------------------------------------------------- validator
def test_validator_three_checks_in_order():
    v = UpdateValidator(abs_limit=1e6, norm_factor=10.0, min_history=2)
    state = {"w": torch.zeros(4)}
    ok = {"w": torch.full((4,), 0.1)}
    # non-finite first, even where a coordinate is also over the limit
    nan = {"w": torch.tensor([np.nan, 1e9, 0.0, 0.0])}
    assert v.validate_one(nan, state).reason == "nonfinite"
    assert v.validate_one({"w": torch.full((4,), 1e9)},
                          state).reason == "abs"
    assert v.validate_one(ok, state) is None        # warm-up
    assert v.validate_one(ok, state) is None
    big = {"w": torch.full((4,), 50.0)}             # 500x the median
    verdict = v.validate_one(big, state)
    assert verdict.reason == "norm" and verdict.detail == pytest.approx(500)
    assert v.validate_one(ok, state) is None        # calibration intact
    v2 = UpdateValidator(abs_limit=1e6, norm_factor=10.0, min_history=2)
    v2.import_state(v.export_state())
    assert v2.validate_one(big, state).reason == "norm"
    # incongruent payloads skip the norm check (checks 1-2 only)
    assert v.validate_one({"other": torch.ones(2)}, state) is None
    assert update_norm((state, state), state) is None
    assert tree_finite_max({"w": torch.tensor([1.0, -np.inf, -3.0]),
                            "i": torch.arange(3)}) == (False, 3.0)
    assert update_norm(ok, state) == pytest.approx(0.2)


# -------------------------------------------------------- checkpoints
def _tree():
    return {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": torch.tensor([1.5, -2.25], dtype=torch.bfloat16),
            "blocks": [{"k": torch.ones(2, 2)}, {"k": torch.zeros(1)}],
            "pair": (torch.tensor(3, dtype=torch.int64),
                     torch.full((2,), 0.5))}


def test_npz_layout_shared_with_reference(tmp_path):
    """A file the port writes loads in the reference, and one the
    reference writes loads in the port: same structure (tuples stay
    tuples), values and dtypes (bf16 through its tag)."""
    tree = _tree()
    ckpt.save(str(tmp_path / "port.npz"), tree, {"round": 4})
    jtree, meta = j_ckpt.load(str(tmp_path / "port.npz"))
    assert meta == {"round": 4}
    assert isinstance(jtree["pair"], tuple) and isinstance(jtree["blocks"],
                                                           list)
    assert str(jtree["b"].dtype) == "bfloat16"
    j_ckpt.save(str(tmp_path / "ref.npz"), jtree, {"round": 5})
    back, meta = ckpt.load(str(tmp_path / "ref.npz"), device="cpu")
    assert meta == {"round": 5}
    assert isinstance(back["pair"], tuple) and back["b"].dtype == \
        torch.bfloat16
    assert _equal(back, tree)
    with np.load(str(tmp_path / "port.npz")) as a, \
            np.load(str(tmp_path / "ref.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        assert "blocks::#1::k" in a.files and "__dtype__::b" in a.files
    # the port's own file keeps int64 (JAX's default makes it int32); a
    # dtype casts the floating leaves only
    wide, _ = ckpt.load(str(tmp_path / "port.npz"), device="cpu",
                        dtype=torch.float64)
    assert wide["b"].dtype == torch.float64
    assert wide["pair"][0].dtype == torch.int64
    with pytest.raises(TypeError, match="no array"):
        ckpt.save(str(tmp_path / "x.npz"), {"a": object()})


@pytest.mark.parametrize("what", ["load", "load_latest",
                                  "EngineCheckpointer.load_latest"])
def test_checkpoint_loads_default_to_the_gpu(tmp_path, monkeypatch, what):
    """Without a device, every loader resolves the GPU, as the rest of the
    port does: with no GPU it raises instead of loading onto the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    d = str(tmp_path)
    ck = EngineCheckpointer(d, every=1)
    ck.save(0, {"w": torch.ones(3)}, {"rng": 1})
    path = os.path.join(d, "round_000000.npz")
    call = {"load": lambda: ckpt.load(path),
            "load_latest": lambda: ckpt.load_latest(d),
            "EngineCheckpointer.load_latest": ck.load_latest}[what]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call()
    assert ckpt.load(path, device="cpu")[0]["w"].device.type == "cpu"


def test_checkpointer_atomic_and_corrupt_fallback(tmp_path):
    d = str(tmp_path)
    ck = EngineCheckpointer(d, every=1, keep=10)
    ck.save(0, {"w": torch.ones(3)}, {"rng": 1})
    ck.save(1, {"w": torch.full((3,), 2.0)}, {"rng": 2})
    assert not [f for f in os.listdir(d) if "tmp" in f]
    assert ck.due(0) and not EngineCheckpointer(d, every=2).due(0)
    with open(os.path.join(d, "round_000001.npz"), "wb") as f:
        f.write(b"not a zipfile")
    with pytest.warns(UserWarning, match="skipping unusable"):
        rd, tree, aux = ck.load_latest(device="cpu")
    assert rd == 0 and aux["rng"] == 1
    assert torch.equal(tree["w"], torch.ones(3))
    os.remove(os.path.join(d, "round_000000.aux"))       # a torn pair
    with pytest.warns(UserWarning):
        assert ck.load_latest(device="cpu") is None
    # retention keeps the newest `keep` pairs, aux halves included
    k2 = EngineCheckpointer(str(tmp_path / "k"), every=1, keep=2)
    for rd in range(4):
        k2.save(rd, {"w": torch.ones(1)}, {"rng": rd})
    assert sorted(os.listdir(str(tmp_path / "k"))) == [
        "round_000002.aux", "round_000002.npz", "round_000003.aux",
        "round_000003.npz"]
    with pytest.raises(ValueError):
        EngineCheckpointer(d, every=0)


@pytest.mark.parametrize("codec", ["msgpack", "pickle"])
def test_state_store_blobs_round_trip(tmp_path, monkeypatch, codec):
    """The rng state carries 128-bit ints (past msgpack's 64-bit cap);
    tensors go in as host numpy with their dtype and come back tensors;
    with ``msgpack`` gone the blob is a pickle, with the same result."""
    if codec == "pickle":
        monkeypatch.setattr(state_store, "msgpack", None)
    else:
        assert state_store.msgpack is not None
    rng = np.random.default_rng(9)
    rng.integers(0, 10, size=100)
    aux = {"rng": rng.bit_generator.state, "big": 2 ** 100,
           "t": (1, [2.5, None], "s"), "tree": _tree(),
           "ef": [[3, ((1, 2), {"w": torch.ones(2)})]]}
    p = str(tmp_path / "x.aux")
    state_store.dump_blob(p, host_tree(aux))
    with open(p, "rb") as f:
        raw = f.read()
    assert b"_rebuild_tensor" not in raw          # no tensor is pickled
    back = device_tree(state_store.load_blob(p), "cpu")
    assert back["big"] == 2 ** 100 and back["t"] == (1, [2.5, None], "s")
    assert _equal(back["tree"], aux["tree"])
    assert back["tree"]["b"].dtype == torch.bfloat16
    assert isinstance(back["tree"]["pair"], tuple)
    assert back["ef"][0][1][0] == (1, 2)
    r2 = np.random.default_rng(0)
    r2.bit_generator.state = back["rng"]
    assert np.array_equal(rng.integers(0, 10, 5), r2.integers(0, 10, 5))


def test_spill_store_bounds_its_hot_set(tmp_path):
    with state_store.SpillStore(2, dir=str(tmp_path / "s")) as s:
        for k in range(5):
            s[("c", k)] = {"v": np.full(3, k)}
            assert s.resident() <= 2
        assert len(s) == 5 and s.spill_count == 3
        assert np.array_equal(s.get(("c", 0))["v"], np.zeros(3))
        assert s.load_count == 1 and s.resident() <= 2
        assert s.pop(("c", 4))["v"][0] == 4 and ("c", 4) not in s
        assert s.get("missing", 7) == 7


def test_channel_snapshot_rollback_and_export(data):
    """The EF residual reverts to its pre-encode value on rollback; the
    channel's export / import restores residuals and the delta tracker."""
    ctx = _ctx(data)
    strat = get_strategy("fedavg")
    strat.setup(ctx)
    state = strat.init_state(ctx)
    chan = CommChannel("fp16", "delta")
    batch = [ctx.data.client_batch(1, 32, ctx.rng)]
    snap = chan.snapshot_uplink(1)
    assert snap is None
    chan.encode_result(strat, ctx, state, 1,
                       strat.client_update(ctx, state, 1, batch))
    assert chan.ef.residual(1) is not None
    chan.rollback_uplink(1, snap)
    assert chan.ef.residual(1) is None
    chan.encode_result(strat, ctx, state, 1,
                       strat.client_update(ctx, state, 1, batch))
    chan.downlink_bytes(strat, ctx, state, 1)
    other = CommChannel("fp16", "delta")
    other.import_state(device_tree(host_tree(chan.export_state()), "cpu"))
    assert _equal(other.ef.residual(1), chan.ef.residual(1))
    assert other.downlink_bytes(strat, ctx, state, 1) == 0


# ------------------------------------------------- kill and resume
def _kill_latest(d):
    top = sorted(f for f in os.listdir(d) if f.endswith(".npz"))[-1]
    os.remove(os.path.join(d, top))
    os.remove(os.path.join(d, top[:-4] + ".aux"))


def test_round_engine_kill_resume_bitwise(data, tmp_path):
    """Checkpointing does not perturb the run, and a killed-then-resumed
    run equals the uninterrupted one bitwise, under fp16 (the
    error-feedback residuals travel in the aux blob)."""
    sA, hA = RoundEngine(get_strategy("fedavg"), _ctx(data),
                         codec="fp16").run(eval_every=2)
    d = str(tmp_path / "ck")
    kw = dict(codec="fp16", checkpoint_every=1, checkpoint_dir=d,
              checkpoint_keep=10)
    sB, hB = RoundEngine(get_strategy("fedavg"), _ctx(data),
                         **kw).run(eval_every=2)
    assert _equal(sA, sB) and _rows(hA) == _rows(hB)
    _kill_latest(d)
    sC, hC = RoundEngine(get_strategy("fedavg"), _ctx(data), **kw,
                         resume=True).run(eval_every=2)
    assert _equal(sA, sC) and _rows(hA) == _rows(hC)
    # resume= with an empty directory is a fresh start
    e = str(tmp_path / "empty")
    sD, _ = RoundEngine(get_strategy("fedavg"), _ctx(data), codec="fp16",
                        resume=e).run(eval_every=2)
    assert _equal(sA, sD)


@pytest.mark.parametrize("method", ["fedavg", "fedepth"])
def test_async_inflight_kill_resume_bitwise(data, tmp_path, method):
    """An async checkpoint carries the live event heap: resuming
    restores the in-flight dispatches and replays the tail bitwise —
    history, parameters and the trace."""
    eA = AsyncEngine(get_strategy(method), _ctx(data), mode="async",
                     system=SYS)
    sA, hA = eA.run(eval_every=2)
    d = str(tmp_path / "ck")
    kw = dict(mode="async", system=SYS, checkpoint_every=2,
              checkpoint_dir=d)
    eB = AsyncEngine(get_strategy(method), _ctx(data), **kw)
    sB, hB = eB.run(eval_every=2)
    assert _equal(sA, sB) and _rows(hA) == _rows(hB)
    assert eA.trace == [t for t in eB.trace if t[0] != "checkpoint"]
    _kill_latest(d)
    eC = AsyncEngine(get_strategy(method), _ctx(data), **kw, resume=True)
    sC, hC = eC.run(eval_every=2)
    assert _equal(sA, sC) and _rows(hA) == _rows(hC)
    assert eB.trace == eC.trace


def test_sync_faulted_kill_resume_bitwise(data, tmp_path):
    """Faults + resilience + latency, killed and resumed: the fault draws
    key on dispatch identity and the validator's calibration travels in
    the aux blob, so the tail replays bitwise."""
    kw = dict(mode="sync", system=SYS, faults=HEAVY,
              resilience=ResiliencePolicy(degradation="resample"))
    eA = AsyncEngine(get_strategy("fedavg"), _ctx(data), **kw)
    sA, hA = eA.run(eval_every=2)
    assert {t[0] for t in eA.trace} & {"quarantine", "fail"}
    d = str(tmp_path / "ck")
    eB = AsyncEngine(get_strategy("fedavg"), _ctx(data), **kw,
                     checkpoint_every=2, checkpoint_dir=d)
    sB, hB = eB.run(eval_every=2)
    assert _equal(sA, sB)
    _kill_latest(d)
    eC = AsyncEngine(get_strategy("fedavg"), _ctx(data), **kw,
                     checkpoint_every=2, checkpoint_dir=d, resume=True)
    sC, hC = eC.run(eval_every=2)
    assert _equal(sA, sC) and _rows(hA) == _rows(hC)
    assert eB.trace == eC.trace
    assert all(bool(torch.isfinite(t).all()) for t in tree_leaves(sC))


# ------------------------------------------------- faulted vs reference
@pytest.mark.parametrize("method", ["fedavg", "fedepth"])
def test_faulted_round_engine_matches_reference(data, method):
    """The HEAVY plan with resampling through both ``RoundEngine``s from
    the same initial parameters: the same bytes a round, the final state
    within the engine-parity tolerance (atol 1e-4, rtol 1e-3) and
    finite."""
    ctx = _ctx(data)
    strat = get_strategy(method)
    strat.setup(ctx)
    init = strat.init_state(ctx)
    jctx = j_context(j_federated(**DATA), JSim(**SIM),
                     model_cfg=j_reduced(num_classes=10, image_size=16))
    s, h = RoundEngine(strat, ctx, faults=HEAVY, resilience=ResiliencePolicy(
        degradation="resample")).run(initial_state=init, eval_every=2)
    js, jh = JEngine(j_get_strategy(method), jctx, faults=JPlan(**HEAVY_KW),
                     resilience=JPolicy(degradation="resample")).run(
        initial_state=jax.tree.map(jax.numpy.asarray,
                                   params_to_reference(init)), eval_every=2)
    assert [(r.comm_bytes, r.down_bytes) for r in h] == \
        [(r.comm_bytes, r.down_bytes) for r in jh]
    assert_trees_close(params_to_reference(s), jax.tree.map(np.asarray, js),
                       f"{method} faulted")
    assert all(bool(torch.isfinite(t).all()) for t in tree_leaves(s))


# --------------------------------------------- no false quarantine
@pytest.mark.parametrize("method", available())
def test_quarantine_zero_false_positives(data, method):
    """Healthy runs with the whole resilience stack on: the round engine
    equals the plain engine bitwise, and the sync systime engine records
    no quarantine and no failure."""
    s0, h0 = RoundEngine(get_strategy(method), _ctx(data, rounds=2)).run(
        eval_every=10)
    s1, h1 = RoundEngine(get_strategy(method), _ctx(data, rounds=2),
                         resilience=ResiliencePolicy()).run(eval_every=10)
    assert _equal(s0, s1) and _rows(h0) == _rows(h1)
    eng = AsyncEngine(get_strategy(method), _ctx(data, rounds=2),
                      mode="sync", system=SYS,
                      resilience=ResiliencePolicy())
    eng.run(eval_every=10)
    kinds = [t[0] for t in eng.trace]
    assert "quarantine" not in kinds and "fail" not in kinds
    assert kinds.count("finish") == 8
