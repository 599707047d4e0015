"""Federated image datasets + non-IID partitions (port of
``repro.fl.data``; paper §Experimental Setups).

No dataset ships with the repo, so the task is *structured* synthetic
image classification (class-conditional low-frequency pattern + noise,
spatially correlated so convs have signal), partitioned with exactly the
paper's protocols:

  * ``dirichlet(alpha)``      — balanced α(λ): per-class Dirichlet split,
    then per-client subsampling to equal |D_k| (paper default).
  * ``dirichlet_unbalanced``  — α_u(λ): clients keep their raw Dirichlet
    share (different sample counts).
  * ``pathological(Lambda)``  — β(Λ): each client holds exactly Λ labels.

Every draw is numpy's, identical to the reference's; the images and
labels then live on the device (NHWC fp32 images, int64 labels), and a
client batch picks its rows with the shared numpy stream and gathers them
there.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device


@dataclasses.dataclass
class FederatedData:
    x: torch.Tensor                  # (N, H, W, C) fp32, on the device
    y: torch.Tensor                  # (N,) int64
    client_indices: List[np.ndarray]
    x_test: torch.Tensor
    y_test: torch.Tensor
    num_classes: int

    @property
    def device(self) -> torch.device:
        return self.x.device

    def client_batch(self, k: int, batch_size: int, rng: np.random.Generator):
        idx = self.client_indices[k]
        take = rng.choice(idx, size=min(batch_size, len(idx)), replace=False)
        rows = torch.as_tensor(take, device=self.device)
        return {"images": self.x[rows], "labels": self.y[rows]}

    def client_sizes(self) -> np.ndarray:
        return np.array([len(i) for i in self.client_indices])


# --------------------------------------------------------------------------
# synthetic structured image task
# --------------------------------------------------------------------------
def synth_images(n_train: int, n_test: int, num_classes: int = 10,
                 image_size: int = 16, channels: int = 3,
                 noise: float = 0.5, seed: int = 0):
    """Class-conditional low-frequency templates + per-sample noise, as
    numpy arrays (x, y, x_test, y_test)."""
    rng = np.random.default_rng(seed)
    H = W = image_size
    # low-frequency class templates
    fx = rng.normal(size=(num_classes, 4, 4, channels))
    templates = np.zeros((num_classes, H, W, channels), np.float32)
    for c in range(num_classes):
        templates[c] = np.kron(fx[c], np.ones((H // 4, W // 4, 1)))
    # second-order signal: class-specific channel correlation
    mixers = rng.normal(size=(num_classes, channels, channels)) * 0.5

    def make(n, seed2):
        r = np.random.default_rng(seed2)
        y = r.integers(0, num_classes, size=n)
        eps = r.normal(size=(n, H, W, channels)).astype(np.float32)
        x = templates[y] + noise * np.einsum("nhwc,ncd->nhwd", eps,
                                             mixers[y]).astype(np.float32) \
            + noise * eps
        return x.astype(np.float32), y.astype(np.int32)

    x, y = make(n_train, seed + 1)
    xt, yt = make(n_test, seed + 2)
    return x, y, xt, yt


# --------------------------------------------------------------------------
# partitions
# --------------------------------------------------------------------------
def dirichlet_partition(y: np.ndarray, num_clients: int, alpha: float,
                        *, balanced: bool = True,
                        seed: int = 0) -> List[np.ndarray]:
    """α(λ) balanced / α_u(λ) unbalanced Dirichlet label partition."""
    rng = np.random.default_rng(seed)
    classes = np.unique(y)
    buckets: List[List[int]] = [[] for _ in range(num_clients)]
    for c in classes:
        idx = np.flatnonzero(y == c)
        rng.shuffle(idx)
        props = rng.dirichlet(np.full(num_clients, alpha))
        cuts = (np.cumsum(props) * len(idx)).astype(int)[:-1]
        for k, part in enumerate(np.split(idx, cuts)):
            buckets[k].extend(part.tolist())
    parts = [np.asarray(sorted(b), np.int64) for b in buckets]
    if balanced:
        per = len(y) // num_clients
        out = []
        for p in parts:
            if len(p) >= per:
                out.append(rng.choice(p, size=per, replace=False))
            else:  # top up from the client's own labels (resample)
                extra = rng.choice(p, size=per - len(p), replace=True) \
                    if len(p) else rng.choice(len(y), size=per)
                out.append(np.concatenate([p, extra]))
        parts = [np.sort(o) for o in out]
    return parts


def pathological_partition(y: np.ndarray, num_clients: int, labels_per: int,
                           *, seed: int = 0) -> List[np.ndarray]:
    """β(Λ): each client gets shards from exactly Λ labels."""
    rng = np.random.default_rng(seed)
    classes = np.unique(y)
    shards_per_class = num_clients * labels_per // len(classes) + 1
    class_shards: Dict[int, List[np.ndarray]] = {}
    for c in classes:
        idx = np.flatnonzero(y == c)
        rng.shuffle(idx)
        class_shards[int(c)] = [s for s in
                                np.array_split(idx, shards_per_class) if len(s)]
    parts = []
    for _ in range(num_clients):
        labs = rng.choice(classes, size=labels_per, replace=False)
        chunk = []
        for c in labs:
            pool = class_shards[int(c)]
            if pool:
                chunk.append(pool.pop())
            else:  # exhausted: resample from the class
                idx = np.flatnonzero(y == c)
                chunk.append(rng.choice(idx, size=max(1, len(idx) //
                                                      num_clients)))
        parts.append(np.sort(np.concatenate(chunk)))
    return parts


def build_federated(num_clients: int = 100, partition: str = "dirichlet",
                    alpha: float = 1.0, labels_per: int = 3,
                    balanced: bool = True, n_train: int = 40_000,
                    n_test: int = 4_000, num_classes: int = 10,
                    image_size: int = 16, seed: int = 0, *,
                    device: DeviceLike = None) -> FederatedData:
    """The reference's federated image task, its images and labels on
    ``device`` (the GPU unless ``"cpu"``)."""
    dev = resolve_device(device)
    x, y, xt, yt = synth_images(n_train, n_test, num_classes, image_size,
                                seed=seed)
    if partition == "dirichlet":
        parts = dirichlet_partition(y, num_clients, alpha,
                                    balanced=balanced, seed=seed)
    elif partition == "pathological":
        parts = pathological_partition(y, num_clients, labels_per, seed=seed)
    else:
        raise ValueError(partition)

    def put(a, dtype):
        return torch.as_tensor(a, dtype=dtype, device=dev)

    return FederatedData(put(x, torch.float32), put(y, torch.int64), parts,
                         put(xt, torch.float32), put(yt, torch.int64),
                         num_classes)
