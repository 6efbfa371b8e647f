"""A torch array namespace for ``kexpr``'s vector evaluator.

``Kexpr.compile_vector(xp)`` evaluates a site filter over whole columns with
numpy's interface: ``xp.asarray``, ``xp.issubdtype(..., xp.floating)``,
``xp.float64``/``xp.int64``, ``xp.power``, ``xp.trunc``, ``xp.abs``,
``xp.zeros``, the math functions, the arithmetic, logical and comparison
operators, and ``.astype`` on its arrays.  This module supplies them over
torch tensors, so a filter runs on the device that holds the counts
(``entry.dryrun_multichip``); production filters stay numpy on the host.

Where torch differs from numpy, the arrays here follow numpy:

- a Python float becomes float64 (torch's default is float32);
- ``/`` on integers is float64 true division (torch gives its default
  float dtype);
- ``.astype(dtype)`` is ``.to(dtype)``.
"""

from __future__ import annotations

import torch

float64 = torch.float64
int64 = torch.int64
floating = "floating"  # the kind issubdtype tests for


def _f64(x):
    if isinstance(x, torch.Tensor):
        return x if x.is_floating_point() else x.to(torch.float64)
    return float(x)


class Array(torch.Tensor):
    """A tensor with numpy's ``astype`` and numpy's integer division."""

    def astype(self, dtype):
        return self.to(dtype)

    def __truediv__(self, other):
        return torch.true_divide(_f64(self), _f64(other))

    def __rtruediv__(self, other):
        return torch.true_divide(_f64(other), _f64(self))


def asarray(v, dtype=None):
    """``v`` (a tensor, a number or a list) as an :class:`Array`; a tensor
    keeps its device and, without ``dtype``, its type."""
    if isinstance(v, torch.Tensor):
        t = v if dtype is None else v.to(dtype)
    else:
        if dtype is None and isinstance(v, float):
            dtype = torch.float64
        t = torch.as_tensor(v, dtype=dtype)
    return t.as_subclass(Array)


def issubdtype(dtype: torch.dtype, kind) -> bool:
    if kind is not floating:
        raise TypeError(f"issubdtype of kind {kind!r}")
    return dtype.is_floating_point


def zeros(shape, dtype=None):
    return torch.zeros(shape, dtype=dtype).as_subclass(Array)


def power(a, b):
    return torch.pow(a, b)


def where(cond, a, b):
    return torch.where(cond, a, b)


abs = torch.abs  # noqa: A001 - the name the evaluator calls
trunc = torch.trunc
exp = torch.exp
log = torch.log
log10 = torch.log10
sqrt = torch.sqrt
sin = torch.sin
cos = torch.cos
tan = torch.tan
