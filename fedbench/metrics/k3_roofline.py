"""``k3_roofline``: K3 (``csrc/mamba2_ssd.cu``: ``ssd_scan_kernel``)
against its roofline, in percent (``metrics/_roofline.py``,
``counts.k3_call``)."""

from fedbench.metrics._roofline import share


def read(run):
    return share(run, "k3", r"ssd_scan_kernel", r"ssd_scan_kernel")
