"""ReLU inputs of a forward, for comparing two runs of a ReLU network.

A ReLU is not differentiable at 0.  Where a pre-activation lies within
rounding of 0, two runs of the same network (on two devices, or through
two libraries) can put it on opposite sides of 0 and then take different,
equally valid, subgradients: their gradients differ there by design, not
by a fault.  :func:`recording_relu` records every ``F.relu`` input of the
forwards run inside it, and :func:`branch_flips` counts the inputs on
which two recordings take different branches, so that a gradient check
can require inputs on which both runs take the same branch everywhere;
:func:`resnet_gradients_on` picks such a batch for PreResNet on two
devices.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.preresnet20 import ResNetConfig
from repro_torch.core.blockwise import _ce_logits
from repro_torch.models import resnet
from repro_torch.tree import tree_leaves, tree_map

DEVICES = ("cpu", "cuda")     # compared by :func:`resnet_gradients_on`


@contextlib.contextmanager
def recording_relu() -> Iterator[List[torch.Tensor]]:
    """Within the block, ``F.relu`` also appends its (detached) input to
    the yielded list."""
    seen: List[torch.Tensor] = []
    relu = F.relu

    def recorded(x, inplace=False):
        seen.append(x.detach().clone())
        return relu(x, inplace)

    F.relu = recorded
    try:
        yield seen
    finally:
        F.relu = relu


def branch_flips(a: Sequence[torch.Tensor],
                 b: Sequence[torch.Tensor]) -> int:
    """Inputs that are positive in one recording and not in the other."""
    if len(a) != len(b):
        raise ValueError(f"{len(a)} ReLU calls against {len(b)}")
    return sum(int(((x > 0) != (y.to(x.device) > 0)).sum())
               for x, y in zip(a, b))


def _logits_and_ce(cfg: ResNetConfig):
    def fn(p, images, labels):
        logits = resnet.apply(p, cfg, images)
        return logits, _ce_logits(logits, labels)
    return fn


def resnet_gradients_on(params, cfg: ResNetConfig,
                        log: Optional[Callable[[str], None]] = None,
                        loss_fn: Optional[Callable] = None
                        ) -> Tuple[int, Dict[str, List[torch.Tensor]]]:
    """Outputs, loss and every parameter's gradient of a PreResNet
    ``loss_fn(params, images, labels) -> (outputs, loss)`` (by default
    the logits and their CE) from ``params`` (a tree of CPU tensors) on
    each of :data:`DEVICES`, from the first of ten seeded batches of four
    whose ReLU inputs take the same branch on both.  Returns ``(seed,
    {device: [outputs, loss, *grads]})``, all on the CPU; raises when no
    batch does.  ``log`` hears of each batch passed over."""
    loss_fn = loss_fn or _logits_and_ce(cfg)
    for seed in range(10):
        gen = torch.Generator().manual_seed(seed)
        images = torch.randn(4, cfg.image_size, cfg.image_size,
                             cfg.in_channels, generator=gen)
        labels = torch.randint(0, cfg.num_classes, (4,), generator=gen)
        out, seen = {}, []
        for dev in DEVICES:
            p = tree_map(lambda t: t.to(dev).requires_grad_(), params)
            with recording_relu() as relu_in:
                outputs, loss = loss_fn(p, images.to(dev), labels.to(dev))
            grads = torch.autograd.grad(loss, tree_leaves(p))
            out[dev] = [t.detach().cpu() for t in (outputs, loss, *grads)]
            seen.append(relu_in)
        flips = branch_flips(*seen)
        if not flips:
            return seed, out
        if log is not None:
            log(f"batch seed {seed}: {flips} ReLU inputs on opposite sides "
                f"of 0 (a kink): next seed")
    raise AssertionError(f"{cfg.name}: each of ten batches put a ReLU "
                         "input on opposite sides of 0")
