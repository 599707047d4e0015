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
from repro_torch.fl.engine import SimConfig  # noqa: E402
from repro_torch.fl.seq import build_lm_context, build_seq_data  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.testing.convert import (params_from_reference,  # noqa: E402
                                         params_to_reference)
from repro_torch.tree import tree_leaves  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"


def test_convert_round_trip():
    """reference -> port -> reference is exact, and so is port ->
    reference -> port; per-layer entries are the stacked rows."""
    jparams = jax.tree.map(np.asarray, j_build(j_reduced("qwen2-7b")).init(
        jax.random.PRNGKey(1)))
    params = params_from_reference(jparams, device="cpu")
    assert len(params["units"]) == 2
    np.testing.assert_array_equal(
        params["units"][1]["attn"]["wq"].numpy(),
        jparams["units"]["sub_0"]["attn"]["wq"][1])
    back = params_to_reference(params)
    fa = jax.tree_util.tree_flatten_with_path(back)[0]
    fb = dict(jax.tree_util.tree_flatten_with_path(jparams)[0])
    assert len(fa) == len(fb)
    for path, a in fa:
        assert a.shape == fb[path].shape and np.array_equal(a, fb[path])

    own = build(get_reduced_config("qwen2-7b")).init(7, device="cpu")
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
print(len(names))
"""


def test_port_imports_neither_jax_nor_reference():
    """Every ``repro_torch`` module imports with ``jax`` and ``repro``
    blocked, and neither ends up loaded."""
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    out = subprocess.run([sys.executable, "-c", _BLOCKER], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20


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
