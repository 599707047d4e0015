"""The wire layer (``repro_torch.fl.comm``) vs the reference's
``repro.fl.comm`` (PyTorch port), on the CPU.

- every codec on the same update: the exact encoded bytes, ``size_bytes``
  and the decoded values bitwise (qsgd_int8's quantised levels and
  scales, topk's kept indices too), over a reduced PreResNet tree (its
  HWIO conv weights on the reference's side), the same under HeteroFL's
  width mask, and reduced qwen3-moe (4 layers) and llama4 (two sublayers a
  unit) trees, whose per-layer lists the wire stacks as the reference
  does;
- error feedback: three rounds of residuals bitwise, the tag and
  structure resets, snapshot / restore, export / import;
- the downlink's bytes in each mode on the same trees;
- the port of ``tests/test_seq_fl.py::
  test_moe_learns_through_fedepth_with_qsgd_codec``.

The engines' runs under each codec are in ``test_torch_comm_engine.py``.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import get_reduced_config as j_lm_reduced  # noqa: E402
from repro.configs.preresnet20 import reduced as j_reduced  # noqa: E402
from repro.fl.comm import CommChannel as JChannel  # noqa: E402
from repro.fl.comm import ErrorFeedback as JEF  # noqa: E402
from repro.fl.comm import get_codec as j_get_codec  # noqa: E402
from repro.fl.width import pad_resnet as j_pad  # noqa: E402
from repro.fl.width import slice_resnet as j_slice  # noqa: E402
from repro.models import build as j_build  # noqa: E402
from repro_torch.configs import get_reduced_config  # noqa: E402
from repro_torch.configs.preresnet20 import reduced  # noqa: E402
from repro_torch.fl import registry  # noqa: E402
from repro_torch.fl.comm import (CODECS, CommChannel,  # noqa: E402
                                 ErrorFeedback, get_codec)
from repro_torch.fl.engine import RoundEngine, SimConfig  # noqa: E402
from repro_torch.fl.seq import build_lm_context, build_seq_data  # noqa: E402
from repro_torch.fl.strategy import wire_bytes  # noqa: E402
from repro_torch.models import build, resnet  # noqa: E402
from repro_torch.testing.convert import (params_from_reference,  # noqa: E402
                                         params_to_reference)
from repro_torch.tree import tree_leaves  # noqa: E402

from torch_helpers import one_torch_thread  # noqa: E402,F401

CODEC_NAMES = ("none", "fp16", "qsgd_int8", "topk")


def _host(tree):
    return jax.tree.map(np.asarray, tree)


# The trees' values only shape the updates drawn over them (and the
# HeteroFL slice's mask): the port's own init, crossed into the
# reference's layout, serves both sides without compiling the reference's.
@functools.lru_cache(maxsize=None)
def _resnet_tree(seed=0):
    cfg = j_reduced(num_classes=10, image_size=16)
    params = resnet.init(seed, reduced(num_classes=10, image_size=16),
                         device="cpu")
    return cfg, params_to_reference(params)


@functools.lru_cache(maxsize=None)
def _lm_tree(arch, seed=0):
    cfg = dataclasses.replace(get_reduced_config(arch), num_layers=4)
    tree = params_to_reference(build(cfg).init(seed, device="cpu"))
    ref = dataclasses.replace(j_lm_reduced(arch), num_layers=4)
    assert jax.tree.structure(tree) == jax.tree.structure(
        jax.eval_shape(j_build(ref).init, jax.random.PRNGKey(seed)))
    return tree


def _update(tree, seed):
    """A client update's shape: small deltas, a few exact zeros (an
    untouched leaf), one leaf all zero."""
    rng = np.random.default_rng(seed)
    leaves, treedef = jax.tree.flatten(tree)
    out = [(1e-2 * rng.standard_normal(a.shape)).astype(np.float32)
           for a in leaves]
    out[1] = np.zeros_like(out[1])
    out[2][..., 0] = 0.0
    return jax.tree.unflatten(treedef, out)


def _trees(kind):
    """(reference tree, its mask or None, the port's tree, its mask)."""
    if kind in ("resnet", "resnet masked"):
        cfg, params = _resnet_tree()
        tree = _update(params, 1)
        mask = None
        if kind == "resnet masked":
            sub, sub_cfg = j_slice(params, cfg, 0.5)
            _, mask = j_pad(sub, cfg, sub_cfg)
            mask = _host(mask)
    else:
        tree, mask = _update(_lm_tree(kind), 2), None
    port = params_from_reference(tree, device="cpu")
    pmask = None if mask is None else params_from_reference(mask,
                                                            device="cpu")
    return tree, mask, port, pmask


def _assert_same_tree(port, ref, msg, exact=True):
    got = params_to_reference(port)
    fa = jax.tree_util.tree_flatten_with_path(got)[0]
    fb = dict(jax.tree_util.tree_flatten_with_path(ref)[0])
    assert len(fa) == len(fb), msg
    for path, a in fa:
        b = np.asarray(fb[path])
        assert a.shape == b.shape and a.dtype == b.dtype, (msg, path)
        if exact:
            assert np.array_equal(a, b), (msg, jax.tree_util.keystr(path))
        else:
            np.testing.assert_allclose(a, b, atol=1e-4, rtol=1e-3,
                                       err_msg=msg)


@pytest.mark.parametrize("codec", CODEC_NAMES)
@pytest.mark.parametrize("kind", ["resnet", "resnet masked",
                                  "qwen3-moe-235b-a22b",
                                  "llama4-maverick-400b-a17b"])
def test_codec_matches_reference(codec, kind):
    """Encoded bytes, ``size_bytes`` and decoded values equal the
    reference's bitwise on the same update (qsgd_int8 from the same seed
    draws the same stream over the same coordinates)."""
    tree, mask, port, pmask = _trees(kind)
    jc, tc = j_get_codec(codec), get_codec(codec)
    jw = jc.encode(tree, mask=mask)
    tw = tc.encode(port, mask=pmask)
    assert tw.nbytes == jw.nbytes > 0
    assert len(tw.blobs) == len(jw.blobs)
    for a, b in zip(tw.blobs, jw.blobs):
        assert a[0] == b[0]
        if a[0] in ("q8", "q8m"):           # levels and scale
            assert np.array_equal(a[1], b[1]) and a[2] == b[2]
        if a[0] == "topk":                  # kept values and indices
            assert np.array_equal(a[1], b[1]) and np.array_equal(a[2], b[2])
    decoded = tc.decode(tw)
    assert all(isinstance(t, torch.Tensor) and t.device.type == "cpu"
               for t in tree_leaves(decoded))
    _assert_same_tree(decoded, _host(jc.decode(jw)), f"{codec} {kind}")
    if mask is None:
        assert tc.size_bytes(port) == jc.size_bytes(tree) == \
            wire_bytes(port, codec=codec)
    else:
        n = int(sum(np.count_nonzero(m) for m in jax.tree.leaves(mask)))
        assert tc.size_bytes(port, n_coords=n) == \
            jc.size_bytes(tree, n_coords=n)
    assert codec in CODECS


def test_error_feedback_matches_reference():
    """Three rounds of one client's updates through topk behind error
    feedback (then qsgd_int8): residuals bitwise the reference's each
    round; a changed tag or structure drops the residual; snapshot /
    restore and export / import round-trip it."""
    arch = "qwen3-moe-235b-a22b"
    base = _lm_tree(arch)
    for codec in ("topk", "qsgd_int8"):
        jc, tc = j_get_codec(codec), get_codec(codec)
        jef, tef = JEF(), ErrorFeedback()
        for rd in range(3):
            delta = _update(base, 10 + rd)
            pdelta = params_from_reference(delta, device="cpu")
            jcorr = jef.correct(7, delta, tag="t")
            tcorr = tef.correct(7, pdelta, tag="t")
            _assert_same_tree(tcorr, _host(jcorr), f"{codec} corrected")
            jw, tw = jc.encode(jcorr), tc.encode(tcorr)
            jef.update(7, jcorr, jc.decode(jw), tag="t")
            tef.update(7, tcorr, tc.decode(tw), tag="t")
            _assert_same_tree(tef.residual(7), _host(jef.residual(7)),
                              f"{codec} residual round {rd}")
        assert any(bool(t.abs().sum() > 0)
                   for t in tree_leaves(tef.residual(7)))
    snap = tef.snapshot(7)
    state = tef.export_state()
    assert tef.correct(7, pdelta, tag="other") is pdelta
    assert tef.residual(7) is None
    tef.restore(7, snap)
    assert tef.residual(7) is snap[1]
    other = {**pdelta, "units": pdelta["units"][:1]}
    assert tef.correct(7, other, tag="t") is other
    assert tef.residual(7) is None
    tef.import_state(state)
    assert tef.residual(7) is snap[1]


class _Prefix:
    """A downlink hook that ships units [0, 1) and the head (each side's
    own layout)."""

    def downlink_tree(self, ctx, state, client_id):
        units = state["units"]
        first = units[:1] if isinstance(units, list) else \
            jax.tree.map(lambda a: a[:1], units)
        return {"units": first, "final_norm": state["final_norm"]}


@pytest.mark.parametrize("mode", ["full", "sliced", "delta"])
def test_downlink_bytes_match_reference(mode):
    """Each mode's bytes for two dispatches to one client (and one to
    another) on the same LM states: the second state changes one layer's
    ``wq`` wholly and a few coordinates of another's, leaves the rest.
    The delta mode caps a stacked leaf's changed bytes at its dense size
    on the reference's side: the port's per-layer lists price as the
    stacked leaf does."""
    s0 = _lm_tree("qwen3-moe-235b-a22b")
    s1 = jax.tree.map(np.copy, s0)
    wq = s1["units"]["sub_0"]["attn"]["wq"]
    wq[0] += 1.0
    wq[1, :3, :2] += 1.0
    s1["embed"][5] += 1.0
    p0, p1 = (params_from_reference(s, device="cpu") for s in (s0, s1))
    for hook in (None, _Prefix()):
        jch, tch = JChannel("none", mode), CommChannel("none", mode)
        got, want = [], []
        for (js, ts), k in (((s0, p0), 1), ((s1, p1), 1), ((s1, p1), 2)):
            want.append(jch.downlink_bytes(hook, None, js, k))
            got.append(tch.downlink_bytes(hook, None, ts, k))
        assert got == want, (mode, hook)
        if mode == "delta":
            assert want[1] < want[0] == want[2]


def test_moe_learns_through_fedepth_with_qsgd_codec():
    """Port of the reference's learning target: reduced qwen3-moe
    federated depth-wise (8 clients, 10 rounds) with the lossy int8
    uplink codec behind error feedback beats chance (1/32) decisively:
    the mean of the last three evaluations is above 0.5 (the bigram
    task's Bayes accuracy is ~0.9)."""
    cfg = get_reduced_config("qwen3-moe-235b-a22b")
    data = build_seq_data(8, n_per_client=64, n_test=128, vocab_size=32,
                          seq_len=16, seed=0, device="cpu")
    sim = SimConfig(rounds=10, participation=0.5, lr=0.3, local_steps=2,
                    batch_size=32, scenario="fair", seed=0)
    ctx = build_lm_context(data, sim, cfg, device="cpu")
    engine = RoundEngine(registry.get_strategy("fedepth"), ctx,
                         codec="qsgd_int8")
    state, history = engine.run(eval_every=2)
    accs = [r.accuracy for r in history if r.accuracy is not None]
    assert len(accs) >= 3, history
    # each record: 2 rounds x 4 clients, each a whole model in int8 plus
    # one fp32 scale a stacked leaf
    assert all(r.comm_bytes == 8 * wire_bytes(state, codec="qsgd_int8")
               for r in history)
    assert float(np.mean(accs[-3:])) > 0.5, accs
