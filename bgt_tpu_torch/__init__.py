"""bgt_tpu_torch: the genotype-matrix engine on PyTorch and CUDA.

A port of ``bgt_tpu`` beside it.  The host layers (file formats, import,
site tables, tile stores, merges, emitters, the native codec) are
``bgt_tpu``'s own, imported; this package owns what ran on JAX: the count
ops, with hand-written CUDA kernels for Hopper (``csrc/``), the device
count tiers of the query path, the ``view`` entry points, and the
count-kernel probes (``tools/probe_roofline.py``,
``experiments/narrow_count.py``).  It imports torch and never jax.
"""
