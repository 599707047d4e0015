"""Depth-wise FeDepth core: memory model, decomposition, client update,
aggregation.

The reference's ``core/jit_utils.py`` is not ported, by decision: its
``donate`` gates ``jax.jit``'s buffer donation on the backend, and
eager PyTorch has no jit to donate to.  Donation's role, reusing the
step's buffers in place instead of allocating a new tree each dispatch,
is the in-place updates of the port's steps (``launch/steps.py``,
``core/blockwise.py``: ``torch._foreach_*`` into the caller's own
tensors).  The three jit-cache metrics stay in
``repro_torch.obs.NOT_PORTED_METRICS``."""
