"""Port ``FedepthServer`` vs the reference's (PyTorch port).

``core.fedepth.FedepthServer`` drives the same round engine and FeDepth
strategy as the registered methods, over an explicit runner: here the
reduced PreResNet's, with per-client budgets (partial-training,
multi-block and surplus clients), the generic MKD path through
``mkd_fns``, masked aggregation and FedProx.  Two rounds from the
reference's parameters and the same numpy batches; server parameters
within atol 1e-4, rtol 1e-3, as in the engine parity tests.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs.preresnet20 import reduced as j_reduced  # noqa: E402
from repro.core import blockwise as jbw  # noqa: E402
from repro.core.decomposition import decompose as j_decompose  # noqa: E402
from repro.core.fedepth import ClientSpec as JSpec  # noqa: E402
from repro.core.fedepth import FedepthConfig as JFedCfg  # noqa: E402
from repro.core.fedepth import FedepthServer as JServer  # noqa: E402
from repro.core.memory_model import resnet_memory as j_memory  # noqa: E402
from repro.models import resnet as jresnet  # noqa: E402
from repro_torch.configs.preresnet20 import reduced  # noqa: E402
from repro_torch.core import blockwise  # noqa: E402
from repro_torch.core.fedepth import (ClientSpec, FedepthConfig,  # noqa: E402
                                      FedepthServer)
from repro_torch.core.memory_model import resnet_memory  # noqa: E402
from repro_torch.models import resnet  # noqa: E402
from repro_torch.testing.convert import (params_from_reference,  # noqa: E402
                                         params_to_reference)
from torch_helpers import assert_trees_close, one_torch_thread  # noqa: E402,F401


def test_fedepth_server_matches_reference():
    """``FedepthServer`` over an explicit ResNet runner: per-client
    budgets (a partial-training client and a surplus client running the
    generic MKD path through ``mkd_fns``), masked aggregation and
    FedProx, two rounds against the reference's server from the same
    parameters and batches."""
    jcfg, cfg = j_reduced(num_classes=4, image_size=16), reduced(4, 16)
    # priced at batch 64, where block 0 costs the most: the first two
    # budgets skip a prefix (partial training), the third trains two
    # blocks, the fourth (the surplus client) the whole model
    jmem, tmem = j_memory(jcfg, 64), resnet_memory(cfg, 64)
    budgets = [1_000_000, 1_300_000, 2_500_000, 4_000_000]
    blocks = [((2, 3),), ((1, 2), (2, 3)), ((0, 1), (1, 3)), ((0, 3),)]
    assert [j_decompose(jmem, b).blocks for b in budgets] == blocks
    assert [d.blocks for d in FedepthServer(
        blockwise.resnet_runner(cfg), tmem,
        [ClientSpec(i, b, 16) for i, b in enumerate(budgets)],
        FedepthConfig(), device="cpu").decomps.values()] == blocks
    rng = np.random.default_rng(0)
    batches = {k: [{"images": rng.normal(size=(8, 16, 16, 3))
                    .astype(np.float32),
                    "labels": rng.integers(0, 4, 8).astype(np.int32)}
                   for _ in range(2)] for k in range(4)}
    init = jax.tree.map(np.asarray, jax.jit(jresnet.init, static_argnums=1)(
        jax.random.PRNGKey(7), jcfg))
    fcfg = dict(rounds=2, participation=0.75, lr=0.05, prox_mu=0.01,
                masked_aggregation=True, seed=3)
    spec = [(i, b, 16 + 8 * i, 2 if i == 3 else 1)
            for i, b in enumerate(budgets)]

    # jitted, so that the reference's eager autodiff compiles once
    jlogits = jax.jit(lambda p, b: jresnet.apply(p, jcfg, b["images"]))
    jtask = jax.jit(lambda p, b: jbw._ce_logits(jlogits(p, b), b["labels"]))

    def tlogits(p, b):
        return resnet.apply(p, cfg, b["images"])

    def ttask(p, b):
        return blockwise._ce_logits(tlogits(p, b), b["labels"])

    jserver = JServer(jbw.resnet_runner(jcfg), jmem,
                      [JSpec(*s) for s in spec], JFedCfg(**fcfg),
                      mkd_fns=(jlogits, jtask))
    tserver = FedepthServer(blockwise.resnet_runner(cfg), tmem,
                            [ClientSpec(*s) for s in spec],
                            FedepthConfig(**fcfg), mkd_fns=(tlogits, ttask),
                            device="cpu")
    tbatches = {k: [{"images": torch.tensor(b["images"]),
                     "labels": torch.tensor(b["labels"], dtype=torch.int64)}
                    for b in bs] for k, bs in batches.items()}
    jstate, jh = jserver.fit(init, lambda k: batches[k])
    tstate, th = tserver.fit(params_from_reference(init, device="cpu"),
                             lambda k: tbatches[k])
    assert len(th) == len(jh) == 2
    assert [r.comm_bytes for r in th] == [r.comm_bytes for r in jh]
    assert_trees_close(params_to_reference(tstate),
                        jax.tree.map(np.asarray, jstate), "FedepthServer")
