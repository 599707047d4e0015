"""Port package contracts (PyTorch port): parameter conversion round
trip, independence from JAX and the reference package, and where entry
points run (the GPU unless the caller passes ``device="cpu"``)."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import get_reduced_config as j_reduced  # noqa: E402
from repro.models import build as j_build  # noqa: E402
from repro_torch.configs import get_reduced_config  # noqa: E402
from repro_torch.configs.preresnet20 import reduced  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.fl.baselines import SplitMixState, depthfl_init_aux  # noqa: E402
from repro_torch.fl.data import build_federated  # noqa: E402
from repro_torch.fl.engine import SimConfig, build_context  # noqa: E402
from repro_torch.fl.scale import Population  # noqa: E402
from repro_torch.launch.mesh import make_data_mesh  # noqa: E402
from repro_torch.fl.seq import build_lm_context, build_seq_data  # noqa: E402
from repro_torch.configs.vit_t16 import reduced as vit_reduced  # noqa: E402
from repro_torch.launch.serve import main as serve_main  # noqa: E402
from repro_torch.launch.train import main as train_main  # noqa: E402
from repro_torch.launch.train import stub_inputs  # noqa: E402
from repro_torch.models import build, init_cache, resnet, vit  # noqa: E402
from repro_torch.testing.convert import (params_from_reference,  # noqa: E402
                                         params_to_reference)
from repro_torch.tree import tree_leaves  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"


# (arch, the port's list of layers, a stacked leaf's path in the reference)
TREES = [("qwen2-7b", "units", ("units", "sub_0", "attn", "wq")),
         ("mamba2-370m", "layers", ("layers", "in_proj")),
         ("rwkv6-7b", "layers", ("layers", "w_lora_a")),
         ("qwen2-vl-2b", "units", ("units", "sub_0", "attn", "bq")),
         ("zamba2-1.2b", "mamba_groups", ("mamba_groups", "in_proj")),
         ("whisper-small", "enc_layers", ("enc_layers", "mlp", "w1")),
         ("whisper-small", "dec_layers", ("dec_layers", "cross_attn", "wk")),
         ("qwen3-moe-235b-a22b", "units", ("units", "sub_0", "moe",
                                           "w_gate"))]


@pytest.mark.parametrize("arch,key,leaf", TREES)
def test_convert_round_trip(arch, key, leaf):
    """reference -> port -> reference is exact, and so is port ->
    reference -> port, for the dense ``units.sub_0`` tree, the ssm
    ``layers`` tree, zamba2's ``mamba_groups`` (G, M, ...) as lists of
    lists (with ``shared``, ``invocation_norms`` and m-FeDepth's
    ``aux_norms`` as they are) and whisper's ``enc_layers`` /
    ``dec_layers``; per-layer entries are the stacked rows."""
    # jitted: the eager init compiles every random draw on its own
    jparams = jax.tree.map(np.asarray, jax.jit(j_build(j_reduced(arch)).init)(
        jax.random.PRNGKey(1)))
    jparams["aux_norms"] = np.random.default_rng(0).standard_normal(
        (2, 8)).astype(np.float32)
    params = params_from_reference(jparams, device="cpu")
    assert isinstance(params[key], list) and len(params[key]) == 2
    stacked, layer = jparams, params[key][1]
    for name in leaf:
        stacked = stacked[name]
    stacked = stacked[1]
    if key == "mamba_groups":          # group 1, its mamba layer 0
        assert all(isinstance(g, list) and len(g) == 1
                   for g in params[key])
        layer, stacked = layer[0], stacked[0]
    for name in leaf[1 + (key == "units"):]:
        layer = layer[name]
    np.testing.assert_array_equal(layer.numpy(), stacked)
    np.testing.assert_array_equal(params["aux_norms"].numpy(),
                                  jparams["aux_norms"])
    back = params_to_reference(params)
    fa = jax.tree_util.tree_flatten_with_path(back)[0]
    fb = dict(jax.tree_util.tree_flatten_with_path(jparams)[0])
    assert len(fa) == len(fb)
    for path, a in fa:
        assert a.shape == fb[path].shape and np.array_equal(a, fb[path])

    own = build(get_reduced_config(arch)).init(7, device="cpu")
    again = params_from_reference(params_to_reference(own), device="cpu")
    for a, b in zip(tree_leaves(own), tree_leaves(again)):
        assert torch.equal(a, b)
    # converted tensors are copies: writing one leaves the source alone
    params["embed"].add_(1.0)
    assert not np.array_equal(params["embed"].numpy(), jparams["embed"])


_BLOCKER = r"""
import importlib, pkgutil, sys

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "repro"):
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Block())
import repro_torch
names = ["repro_torch"]
for mod in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(mod.name)
    names.append(mod.name)
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "repro"))
assert not loaded, loaded
print(" ".join(names))
"""

# the image path's, the baselines', the ViT's and the vectorized
# scheduler's modules: each must be among those imported above
IMAGE_PATH = ("configs.preresnet20", "models.resnet", "core.mkd",
              "core.fedepth", "fl.data", "fl.width", "fl.baselines",
              "fl.strategies.fedavg", "fl.strategies.heterofl",
              "fl.strategies.splitmix", "fl.strategies.depthfl",
              "fl.sampling", "fl.registry", "testing.convert",
              "configs.vit_t16", "models.vit", "models.common",
              "models.api", "core.memory_model", "core.blockwise",
              "fl.strategy", "fl.engine", "fl.strategies.fedepth",
              "fl.strategies.common")
# the serving path's modules, the hybrid's and the encoder-decoder's
SERVING_PATH = ("configs.shapes", "configs.yi_6b", "configs.h2o_danube3_4b",
                "configs.minicpm_2b", "configs.qwen2_vl_2b", "launch",
                "launch.serve", "models.attention", "models.transformer",
                "models.mamba2", "models.mamba2_lm", "models.rwkv6",
                "configs.zamba2_1_2b", "configs.whisper_small",
                "models.zamba2", "models.whisper")
# the MoE family's modules and the wire layer's
MOE_COMM_PATH = ("configs.qwen3_moe_235b_a22b",
                 "configs.llama4_maverick_400b_a17b", "models.moe",
                 "fl.comm", "fl.comm.codecs", "fl.comm.error_feedback",
                 "fl.comm.payload", "layout")
# system time, faults and checkpoints
SYSTIME_FAULTS_PATH = ("fl.systime", "fl.systime.clock",
                       "fl.systime.availability", "fl.systime.staleness",
                       "fl.systime.profiles", "fl.systime.engine",
                       "fl.faults", "fl.faults.plan", "fl.faults.quarantine",
                       "fl.faults.resilience", "fl.faults.checkpointing",
                       "fl.scale", "fl.scale.state_store", "train",
                       "train.checkpoint")
# the scale layer and the observability layer
SCALE_OBS_PATH = ("fl.scale.history", "fl.scale.population",
                  "fl.scale.executor", "launch.mesh", "obs", "obs.trace",
                  "obs.metrics", "obs.export", "obs.audit", "obs.dynamics")
# the training launch path
TRAIN_LAUNCH_PATH = ("data", "data.tokens", "train.optim", "launch.steps",
                     "launch.train", "kernels.flash_chunked")
# the sharded layer: DTensor helpers, sharding rules, the expert-parallel
# MoE, the roofline, the dry run and the many-rank test helper
SHARDED_PATH = ("dtensor", "launch.sharding", "launch.dryrun",
                "models.moe_ep", "roofline", "roofline.hw",
                "roofline.analysis", "testing.dist")


def test_port_imports_neither_jax_nor_reference():
    """Every ``repro_torch`` module imports with ``jax`` and ``repro``
    blocked, and neither ends up loaded."""
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    out = subprocess.run([sys.executable, "-c", _BLOCKER], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    names = out.stdout.split()
    assert len(names) >= 28
    missing = [m for m in IMAGE_PATH + SERVING_PATH + MOE_COMM_PATH
               + SYSTIME_FAULTS_PATH + SCALE_OBS_PATH + TRAIN_LAUNCH_PATH
               + SHARDED_PATH
               if f"repro_torch.{m}" not in names]
    assert not missing, missing


def test_runtime_modules_do_not_import_testing():
    """The training, wire, system-time, fault, serving, launch and sharded
    modules stand without ``repro_torch.testing`` (the parity helpers and
    the many-rank spawner): the wire format is the program's, not the
    tests'."""
    code = ("import sys, repro_torch.fl.engine, repro_torch.fl.comm, "
            "repro_torch.fl.registry, repro_torch.launch.serve, "
            "repro_torch.launch.steps, repro_torch.launch.train, "
            "repro_torch.fl.systime, repro_torch.fl.faults, "
            "repro_torch.train.checkpoint, repro_torch.fl.scale, "
            "repro_torch.obs, repro_torch.obs.export, "
            "repro_torch.launch.sharding, repro_torch.launch.dryrun, "
            "repro_torch.models.moe_ep, repro_torch.roofline; "
            "print(sorted(m for m in sys.modules "
            "if m.startswith('repro_torch.testing')))")
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


def test_entry_points_need_cuda_unless_cpu(monkeypatch):
    """With no GPU, entry points raise unless ``device="cpu"`` is passed;
    they never carry on quietly on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_reduced_config("qwen2-7b")
    sim = SimConfig(rounds=1, participation=0.5, batch_size=4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_seq_data(2, vocab_size=cfg.vocab_size)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build(cfg).init(0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params_from_reference({"embed": np.zeros((2, 2), np.float32),
                               "units": {"sub_0": {}}})
    data = build_seq_data(2, vocab_size=cfg.vocab_size, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_lm_context(data, sim, cfg)
    ctx = build_lm_context(data, sim, cfg, device="cpu")
    assert ctx.device.type == "cpu"
    assert build(cfg).init(0, device="cpu")["embed"].device.type == "cpu"

    # the image path: data, context, PreResNet init, a ResNet tree
    rcfg = reduced(num_classes=10, image_size=8)
    kw = dict(num_clients=2, n_train=40, n_test=8, image_size=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_federated(**kw)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resnet.init(0, rcfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params_from_reference(params_to_reference(
            resnet.init(0, rcfg, device="cpu")))
    images = build_federated(**kw, device="cpu")
    assert images.x.device.type == images.y_test.device.type == "cpu"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_context(images, sim, model_cfg=rcfg)
    assert build_context(images, sim, model_cfg=rcfg,
                         device="cpu").device.type == "cpu"
    # a lazily drawn population: its context and its synthesized data
    pop = Population(num_clients=10, image_size=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_context(None, sim, model_cfg=rcfg, population=pop)
    pctx = build_context(None, sim, model_cfg=rcfg, population=pop,
                         device="cpu")
    assert pctx.device.type == pctx.data.x_test.device.type == "cpu"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_data_mesh()
    assert make_data_mesh("cpu") == [torch.device("cpu")]
    # the baselines' own state: SplitMix's base nets, DepthFL's aux heads
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SplitMixState(rcfg, 1 / 6, 0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        depthfl_init_aux(rcfg, torch.Generator())
    assert SplitMixState(rcfg, 1 / 6, 0, device="cpu").bases[0][
        "stem"].device.type == "cpu"
    # the ViT: init and a ViT tree
    vcfg = vit_reduced()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        vit.init(0, vcfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params_from_reference(params_to_reference(
            vit.init(0, vcfg, device="cpu")))
    assert vit.init(0, vcfg, device="cpu")["blocks"][0][
        "wqkv"].device.type == "cpu"
    # serving: the decode cache and the serve driver
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_cache(cfg, 1, 4)
    assert all(t.device.type == "cpu"
               for t in init_cache(cfg, 1, 4, device="cpu").values())
    args = ["--arch", "qwen2-7b", "--reduced", "--batch", "1",
            "--prompt-len", "2", "--gen", "1"]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_main(args)
    assert serve_main(args + ["--device", "cpu"]).tokens.device.type == "cpu"
    # the train CLI, which moves TokenPipeline's numpy batches and the
    # stubbed frontends' inputs to its device
    args = ["--arch", "qwen2-vl-2b", "--reduced", "--steps", "1",
            "--batch", "2", "--seq", "4"]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_main(args)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_main(args + ["--fedepth", "--budget-mb", "8"])
    res = train_main(args + ["--device", "cpu"])
    assert all(t.device.type == "cpu" for t in tree_leaves(res.params))
    vcfg2 = get_reduced_config("qwen2-vl-2b")
    assert all(t.device.type == "cpu" for t in stub_inputs(
        vcfg2, 2, 4, 0, resolve_device("cpu")).values())


def test_cuda_device_turns_tf32_off(monkeypatch):
    """Resolving a CUDA device sets the port's fp32 policy: TF32 off for
    cuDNN's convolutions (on by PyTorch's default) and cuBLAS's matmuls,
    process-wide, so that a convolution's backward, run later by
    autograd, is fp32 too.  The CPU leaves the flags alone."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    try:
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
        assert resolve_device("cpu").type == "cpu"
        assert torch.backends.cudnn.allow_tf32
        assert resolve_device(None).type == "cuda"
        assert not torch.backends.cudnn.allow_tf32
        assert not torch.backends.cuda.matmul.allow_tf32
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags


def test_chip_smoke_refuses_without_a_card():
    """``chip_smoke.py`` exits non-zero and prints no result line when no
    CUDA device is present."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    root = SRC.parent
    out = subprocess.run([sys.executable, str(root / "chip_smoke.py")],
                         cwd=root, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
