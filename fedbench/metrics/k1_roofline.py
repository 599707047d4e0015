"""``k1_roofline``: K1 (``csrc/chunked_ce.cu``: ``ce_partial_kernel``
then ``ce_combine_kernel`` a call) against its roofline, in percent
(``metrics/_roofline.py``, ``counts.k1_call``)."""

from fedbench.metrics._roofline import share


def read(run):
    return share(run, "k1", r"ce_partial_kernel",
                 r"ce_partial_kernel|ce_combine_kernel")
