"""``k2_roofline``: K2 (``csrc/flash_attention.cu``: ``attn_fwd_kernel``)
against its roofline, in percent (``metrics/_roofline.py``,
``counts.k2_call``)."""

from fedbench.metrics._roofline import share


def read(run):
    return share(run, "k2", r"attn_fwd_kernel", r"attn_fwd_kernel")
