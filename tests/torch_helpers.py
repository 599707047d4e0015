"""Helpers shared by the port's parity tests (not a test module)."""
import jax
import numpy as np
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while the importing module runs: the suite
    runs several test processes at once, and a full torch thread pool in
    each would oversubscribe the cores (these tensors are small; one
    thread is no slower alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def assert_trees_close(a, b, msg, atol=1e-4, rtol=1e-3):
    """Two reference-layout trees hold the same leaves within
    ``atol`` / ``rtol``; a failure names the leaf."""
    fa = jax.tree_util.tree_flatten_with_path(a)[0]
    fb = dict(jax.tree_util.tree_flatten_with_path(b)[0])
    assert len(fa) == len(fb), msg
    for path, x in fa:
        np.testing.assert_allclose(
            x, fb[path], atol=atol, rtol=rtol,
            err_msg=f"{msg} {jax.tree_util.keystr(path)}")
