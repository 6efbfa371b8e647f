"""bgt_tpu_torch: the genotype-matrix engine on PyTorch and CUDA.

A port of ``bgt_tpu`` beside it, importing torch and nothing of jax or of
``bgt_tpu``.  It keeps its own copies of the host layers (``io/``,
``formats/``, ``core/``, ``native.py`` over the repository's C++ host
runtime, ``ops/tiles.py``, ``query/engine.py``, ``query/importer.py``,
``testing.py``) and owns what ran on JAX: the count ops, with hand-written
CUDA kernels for Hopper (``csrc/``), the decode and gather ops, the device
count tiers of the query path (``query/fastpath.py``), the entry points
(``cli`` with every subcommand, ``view``, ``server``, the ``api`` and
``open``, ``entry``), the PBWT decode scan (``ops/decode.py``, its kernel
``csrc/pbwt_decode.cu``), the device trace, and the count-kernel probes
(``tools/probe_roofline.py``, ``experiments/narrow_count.py``); and copies
of the ``misc/`` metadata converters.
"""


def open(prefixes, device=None):  # noqa: A001 - mirrors bgt_tpu.open
    """Open one or more BGT databases for queries counting on ``device``
    (default ``cuda``)."""
    from .api import Dataset
    return Dataset(prefixes, device)
