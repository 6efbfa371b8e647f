"""bgt_tpu_torch: the genotype-matrix engine on PyTorch and CUDA.

A port of ``bgt_tpu`` beside it.  The host layers (file formats, import,
site tables, tile stores, merges, emitters, the native codec) are
``bgt_tpu``'s own, imported; this package owns what ran on JAX: the count
ops, with hand-written CUDA kernels for Hopper (``csrc/``), the decode and
gather ops, the device count tiers of the query path, the entry points
(``view``, ``server``, the ``api`` and ``open``, ``entry``), the device
trace, and the count-kernel probes (``tools/probe_roofline.py``,
``experiments/narrow_count.py``).  It imports torch and never jax.
"""


def open(prefixes, device=None):  # noqa: A001 - mirrors bgt_tpu.open
    """Open one or more BGT databases for queries counting on ``device``
    (default ``cuda``)."""
    from .api import Dataset
    return Dataset(prefixes, device)
