"""Training substrate (port of ``repro.train``): optimizers, schedules,
checkpointing."""
from repro_torch.train.optim import adamw, cosine, sgd, wsd  # noqa: F401
