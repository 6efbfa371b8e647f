"""kexpr-compatible expression engine.

Infix expressions are parsed with a shunting-yard pass into RPN; evaluation
reproduces the reference's tri-typed (int/real/string) stack machine with
C-like coercions (reference kexpr.c): comparisons yield int, ``/`` is always
real with ``i = (int64)(r + .5)``, ``//`` and ``%`` truncate toward zero,
``&&``/``||`` are non-short-circuit int ops, and unknown functions or
unassigned variables flag an error while still evaluating with defaults.

Three evaluators are provided:

- :meth:`Kexpr.eval` — scalar, error-compatible with ``ke_eval``;
- :meth:`Kexpr.compile_vector` — compiles the RPN once into a function over
  numpy/jax arrays so per-site filters (AC/AN/AC#/AN#) evaluate for a whole
  site batch at once instead of re-binding per row (the TPU replacement for
  per-site ``ke_set_int`` + ``ke_eval`` in reference bgt.c:700-719);
- :meth:`Kexpr.eval_rows` — ``eval`` over every row of a table at once,
  both of its lanes kept, for sample groups over the ``.spl``
  (``Fmf.test_all``).
"""

from __future__ import annotations

import math

# error flags (kexpr.h)
KEE_UNQU = 0x01
KEE_UNLP = 0x02
KEE_UNRP = 0x04
KEE_UNOP = 0x08
KEE_FUNC = 0x10
KEE_ARG = 0x20
KEE_NUM = 0x40
KEE_UNFUNC = 0x40 << 1
KEE_UNVAR = 0x40 << 2

KEV_REAL = 1
KEV_INT = 2
KEV_STR = 3

# token types
_VAL, _OP, _FUNC = 1, 2, 3

# operators: name -> (op_id, precedence<<1|right_assoc_or_unary, n_args)
_OPS = {
    "+u": (1, 1 << 1 | 1, 1),
    "-u": (2, 1 << 1 | 1, 1),
    "~": (3, 1 << 1 | 1, 1),
    "!": (4, 1 << 1 | 1, 1),
    "**": (5, 2 << 1 | 1, 2),
    "*": (6, 3 << 1, 2),
    "/": (7, 3 << 1, 2),
    "//": (8, 3 << 1, 2),
    "%": (9, 3 << 1, 2),
    "+": (10, 4 << 1, 2),
    "-": (11, 4 << 1, 2),
    "<<": (12, 5 << 1, 2),
    ">>": (13, 5 << 1, 2),
    "<": (14, 6 << 1, 2),
    "<=": (15, 6 << 1, 2),
    ">": (16, 6 << 1, 2),
    ">=": (17, 6 << 1, 2),
    "==": (18, 7 << 1, 2),
    "!=": (19, 7 << 1, 2),
    "&": (20, 8 << 1, 2),
    "^": (21, 9 << 1, 2),
    "|": (22, 10 << 1, 2),
    "&&": (23, 11 << 1, 2),
    "||": (24, 12 << 1, 2),
}

KEO_DIV = 7


class Tok:
    __slots__ = ("ttype", "op", "prec", "n_args", "name", "vtype", "i", "r", "s",
                 "assigned", "func")

    def __init__(self):
        self.ttype = 0
        self.op = 0
        self.prec = 0
        self.n_args = 0
        self.name = None
        self.vtype = KEV_REAL
        self.i = 0
        self.r = 0.0
        self.s = None
        self.assigned = False
        self.func = None  # bound real-valued function (ke_set_real_func1/2)


INT64_MIN = -(1 << 63)


def _c_pow(x: float, y: float) -> float:
    """libm pow semantics: overflow -> +/-inf, domain error -> the x86
    default (negative) quiet NaN (python's math.pow raises where C
    returns); numpy's float64 ops reproduce both exactly."""
    try:
        return math.pow(x, y)
    except (OverflowError, ValueError):
        import numpy as np
        with np.errstate(all="ignore"):
            return float(np.power(np.float64(x), np.float64(y)))


def fmt_real(r: float) -> str:
    """C printf %g including the x86 -nan sign (glibc prints it)."""
    if r != r and math.copysign(1.0, r) < 0:
        return "-nan"
    return "%g" % r


def _c_div(x: float, y: float) -> float:
    """IEEE float division incl. signed zero divisors and the x86 default
    -nan for 0/0 (C's divsd, which the reference compiles to)."""
    import numpy as np
    with np.errstate(all="ignore"):
        return float(np.float64(x) / np.float64(y))


def _trunc(r: float) -> int:
    """(int64_t)(r + .5): C truncation toward zero; out-of-range/NaN casts
    produce INT64_MIN on x86 (cvttsd2si), which the reference inherits."""
    try:
        v = r + 0.5
    except (OverflowError, ValueError):
        return INT64_MIN
    if v != v or v >= (1 << 63) or v < INT64_MIN:
        return INT64_MIN
    return int(v)


def _c_idiv(a: int, b: int) -> int:
    if b == 0:
        raise ZeroDivisionError
    q = abs(a) // abs(b)
    return q if (a < 0) == (b < 0) else -q


def _c_mod(a: int, b: int) -> int:
    return a - _c_idiv(a, b) * b


def _read_token(s: str, p: int, last_is_val: bool):
    """Parse one token at s[p:]; returns (Tok|None, new_p, err)."""
    q = p
    n = len(s)
    c = s[p]
    e = Tok()
    if c.isalpha() or c == "_":
        while p < n and (s[p] == "_" or s[p].isalnum()):
            p += 1
        if p < n and s[p] == "(":
            e.ttype = _FUNC
            e.n_args = 1
        else:
            e.ttype = _VAL
            e.vtype = KEV_REAL
        e.name = s[q:p]
        return e, p, 0
    if c.isdigit() or c == ".":
        # strtod span
        pd = p
        while pd < n and (s[pd].isdigit() or s[pd] == "."):
            pd += 1
        if pd < n and s[pd] in "eE":
            pe = pd + 1
            if pe < n and s[pe] in "+-":
                pe += 1
            if pe < n and s[pe].isdigit():
                while pe < n and s[pe].isdigit():
                    pe += 1
                pd = pe
        # strtol span (base 0: 0x / octal)
        pi = p
        if s[pi] == "0" and pi + 1 < n and s[pi + 1] in "xX":
            pi += 2
            while pi < n and s[pi] in "0123456789abcdefABCDEF":
                pi += 1
        else:
            while pi < n and s[pi].isdigit():
                pi += 1
        e.ttype = _VAL
        try:
            y = float(s[q:pd])
        except ValueError:
            return None, p, KEE_NUM
        if pd > pi:
            e.vtype = KEV_REAL
            e.r = y
            e.i = _trunc(y)
            return e, pd, 0
        txt = s[q:pi]
        x = int(txt, 0) if txt else 0
        e.vtype = KEV_INT
        e.i = x
        e.r = y
        return e, pi, 0
    if c in "\"'":
        p += 1
        buf = []
        while p < n and s[p] != c:
            if s[p] == "\\":
                p += 1
            if p < n:
                buf.append(s[p])
                p += 1
        if p < n and s[p] == c:
            e.ttype = _VAL
            e.vtype = KEV_STR
            e.s = "".join(buf)
            return e, p + 1, 0
        return None, p, KEE_UNQU
    # operator
    two = s[p:p + 2]
    name = None
    if two in ("**", "//", "==", "!=", "<>", ">=", "<=", ">>", "<<", "||", "&&"):
        name = "!=" if two == "<>" else two
        p += 2
    elif c in "*/%+-=<>|&^~!":
        if c == "+" and not last_is_val:
            name = "+u"
        elif c == "-" and not last_is_val:
            name = "-u"
        elif c == "=":
            return None, p, KEE_UNOP
        else:
            name = c
        p += 1
    else:
        return None, p, KEE_UNOP
    op_id, prec, n_args = _OPS[name]
    e.ttype = _OP
    e.op = op_id
    e.prec = prec
    e.n_args = n_args
    e.name = name
    return e, p, 0


class Kexpr:
    def __init__(self, rpn: list[Tok]):
        self.rpn = rpn

    # --- variable binding --------------------------------------------------

    def set_int(self, var: str, y) -> int:
        y = int(y)  # fmf passes reals through here too; C truncates
        n = 0
        for e in self.rpn:
            if e.ttype == _VAL and e.name == var:
                e.i = y
                e.r = float(y)
                e.vtype = KEV_INT
                e.assigned = True
                n += 1
        return n

    def set_real(self, var: str, x: float) -> int:
        n = 0
        for e in self.rpn:
            if e.ttype == _VAL and e.name == var:
                e.r = x
                e.i = _trunc(x)
                e.vtype = KEV_REAL
                e.assigned = True
                n += 1
        return n

    def set_str(self, var: str, x: str) -> int:
        n = 0
        for e in self.rpn:
            if e.ttype == _VAL and e.name == var:
                e.s = x
                e.i = 0
                e.r = 0.0
                e.vtype = KEV_STR
                e.assigned = True
                n += 1
        return n

    def unset(self) -> None:
        for e in self.rpn:
            if e.ttype == _VAL and e.name is not None:
                e.assigned = False

    # --- function binding (ke_set_real_func1/2 + ke_set_default_func,
    #     reference kexpr.c:472-506; bound only where the reference binds
    #     them, i.e. the standalone kexpr CLI at kexpr.c:556) --------------

    def set_real_func1(self, name: str, func) -> int:
        n = 0
        for e in self.rpn:
            if e.ttype == _FUNC and e.n_args == 1 and e.name == name:
                e.func = func
                n += 1
        return n

    def set_real_func2(self, name: str, func) -> int:
        n = 0
        for e in self.rpn:
            if e.ttype == _FUNC and e.n_args == 2 and e.name == name:
                e.func = func
                n += 1
        return n

    def set_default_func(self) -> int:
        # numpy's float64 funcs follow C libm edge cases (log(0) = -inf,
        # sqrt(-1) = nan, exp(1000) = inf) where python math raises
        import numpy as np

        def _f1(fn):
            def g(x):
                with np.errstate(all="ignore"):
                    return float(fn(np.float64(x)))
            return g

        n = 0
        for name in ("exp", "log", "log10", "sqrt", "sin", "cos", "tan"):
            n += self.set_real_func1(name, _f1(getattr(np, name)))

        def _pow(x, y):
            with np.errstate(all="ignore"):
                return float(np.power(np.float64(x), np.float64(y)))

        n += self.set_real_func2("pow", _pow)
        return n

    @property
    def var_names(self) -> set:
        return {e.name for e in self.rpn if e.ttype == _VAL and e.name}

    # --- scalar evaluation (ke_eval, kexpr.c:366-399) ----------------------

    def eval(self):
        """Returns (err, i, r, s, vtype)."""
        err = 0
        for e in self.rpn:
            if e.ttype == _FUNC and e.func is None and e.name not in ("abs",):
                err |= KEE_UNFUNC
            elif e.ttype == _VAL and e.name is not None and not e.assigned:
                err |= KEE_UNVAR
        stack: list[list] = []  # [vtype, i, r, s]
        for e in self.rpn:
            if e.ttype == _OP:
                if e.n_args == 2:
                    qv = stack.pop()
                    pv = stack[-1]
                    _apply2(e.op, pv, qv)
                else:
                    _apply1(e.op, stack[-1])
            elif e.ttype == _FUNC:
                if e.func is not None and e.n_args in (1, 2):
                    # user real funcs: p.r = f(...); p.i = (int64)(p.r + .5)
                    # (reference kexpr.c:381-391)
                    if e.n_args == 2:
                        qv = stack.pop()
                        pv = stack[-1]
                        pv[2] = e.func(pv[2], qv[2])
                    else:
                        pv = stack[-1]
                        pv[2] = e.func(pv[2])
                    pv[1] = _trunc(pv[2])
                    pv[0] = KEV_REAL
                elif e.name == "abs" and e.n_args == 1:
                    pv = stack[-1]
                    if pv[0] == KEV_INT:
                        pv[1] = abs(pv[1])
                        pv[2] = float(pv[1])
                    else:
                        pv[2] = abs(pv[2])
                        pv[1] = _trunc(pv[2])
                else:  # unknown function: keep first arg (stack adjusts)
                    for _ in range(e.n_args - 1):
                        stack.pop()
            else:
                stack.append([e.vtype, e.i, e.r, e.s])
        top = stack[-1] if stack else [KEV_INT, 0, 0.0, None]
        return err, top[1], top[2], top[3], top[0]

    def eval_int(self):
        err, i, _r, _s, _t = self.eval()
        return err, i

    # --- vectorized compilation -------------------------------------------

    def compile_vector(self, xp=None):
        """Compile into f(env) -> (vtype, array) evaluating all sites at once.

        ``env`` maps variable names to arrays (or scalars).  String columns
        are supported as :class:`Categorical` (interned ids + unique values):
        comparisons against string literals evaluate on the small unique
        array and gather by id.  Other string uses raise TypeError (caller
        falls back to scalar).  ``xp`` is the array namespace (numpy by
        default; pass jax.numpy to trace into an XLA computation).
        """
        if xp is None:
            import numpy as xp  # noqa: PLC0415
        rpn = self.rpn

        def run(env):
            stack = []
            for e in rpn:
                if e.ttype == _OP:
                    if e.n_args == 2:
                        tq, q = stack.pop()
                        tp, p = stack.pop()
                        stack.append(_vec_apply2(xp, e.op, tp, p, tq, q))
                    else:
                        tp, p = stack.pop()
                        stack.append(_vec_apply1(xp, e.op, tp, p))
                elif e.ttype == _FUNC:
                    if e.name == "abs" and e.n_args == 1:
                        tp, p = stack.pop()
                        stack.append((tp, xp.abs(p)))
                    elif (e.func is not None and e.n_args == 1
                          and e.name in _VEC_FUNCS1):
                        _tp, p = stack.pop()
                        stack.append((KEV_REAL,
                                      getattr(xp, e.name)(xp.asarray(p, xp.float64))))
                    elif (e.func is not None and e.n_args == 2
                          and e.name == "pow"):
                        _tq, q = stack.pop()
                        _tp, p = stack.pop()
                        stack.append((KEV_REAL,
                                      xp.power(xp.asarray(p, xp.float64), q)))
                    else:
                        for _ in range(e.n_args - 1):
                            stack.pop()
                else:
                    if e.name is not None:
                        v = env[e.name]
                        if isinstance(v, str):
                            raise TypeError("string variable in vector mode")
                        if isinstance(v, Categorical):
                            stack.append((KEV_STR, v))
                            continue
                        arr = xp.asarray(v)
                        t = KEV_REAL if xp.issubdtype(arr.dtype, xp.floating) else KEV_INT
                        stack.append((t, arr))
                    elif e.vtype == KEV_STR:
                        stack.append((KEV_STR, e.s))
                    elif e.vtype == KEV_REAL:
                        stack.append((KEV_REAL, xp.asarray(e.r)))
                    else:
                        stack.append((KEV_INT, xp.asarray(e.i)))
            return stack[-1]

        return run

    # --- row evaluation: ``eval`` over a table's columns --------------------

    def eval_rows(self, env: dict, valid):
        """``eval_int``'s integer for every row of a table at once.

        Each stack value keeps both of :meth:`eval`'s lanes, int64 and
        float64 (and a string's :class:`Categorical`), as arrays over the
        rows or, where no variable feeds them, numpy scalars; each operator
        reads and writes the lanes ``_apply2``/``_apply1`` do, so the result
        is the scalar one wherever the scalar's integers fit int64.  ``env``
        maps each variable to an int64 array (a value bound with ``set_int``)
        or a Categorical whose ``uniq`` is sorted (``set_str``); ``valid``
        marks the rows on which every variable is bound, the only rows whose
        result counts.  Raises :class:`NotExact` where the lanes cannot
        follow: an integer beyond int64 on a valid row; ``//`` or ``%`` where
        the scalar raises (a zero divisor) or may (a divisor that reads a
        variable, on a row that lacks one: the scalar divides by the
        previous row's binding there); ``**`` (libm's ``pow`` against
        numpy's); a bound function.
        """
        import numpy as np
        every_row = bool(valid.all())
        # (lanes, whether no variable feeds them); lanes are (vtype, int,
        # real or None for the int's float, Categorical or None)
        stack = []
        for e in self.rpn:
            if e.ttype == _OP:
                if e.n_args == 2:
                    q, const_q = stack.pop()
                    p, const_p = stack.pop()
                    if e.op in (8, 9) and not (every_row or const_q):
                        raise NotExact("// or % on a row with unbound variables")
                    stack.append((_rows_apply2(e.op, p, q, valid),
                                  const_p and const_q))
                else:
                    p, const = stack.pop()
                    stack.append((_rows_apply1(e.op, p, valid), const))
            elif e.ttype == _FUNC:
                if e.func is not None:
                    raise NotExact("bound function")
                if e.name == "abs" and e.n_args == 1:
                    (t, i, r, s), const = stack.pop()
                    if t == KEV_INT:
                        _fits(i, valid)
                        i, r = np.abs(i), None
                    else:
                        r = np.abs(_real(i, r))
                        i = _trunc_rows(r)
                    stack.append(((t, i, r, s), const))
                else:  # unknown function: keep first arg
                    for _ in range(e.n_args - 1):
                        stack.pop()
            elif e.name is not None:
                v = env[e.name]
                if isinstance(v, Categorical):
                    lanes = KEV_STR, np.int64(0), np.float64(0.0), v
                else:
                    lanes = KEV_INT, v, None, None
                stack.append((lanes, False))
            else:
                if not INT64_MIN <= e.i < -INT64_MIN:
                    raise NotExact("integer literal beyond int64")
                s = Categorical(np.int64(0), [e.s]) if e.vtype == KEV_STR \
                    else None
                stack.append(((e.vtype, np.int64(e.i), np.float64(e.r), s),
                              True))
        return stack[-1][0][1] if stack else np.int64(0)


class NotExact(Exception):
    """:meth:`Kexpr.eval_rows` cannot match the scalar machine here."""


def _real(i, r):
    """A value's real lane (None: ``float`` of its int lane)."""
    import numpy as np
    return i.astype(np.float64) if r is None else r


def _fits(i, valid) -> None:
    """Raise where negating ``i`` leaves int64 on a valid row."""
    if ((i == INT64_MIN) & valid).any():
        raise NotExact("integer beyond int64")


def _trunc_rows(r):
    """``_trunc`` of float64 lanes."""
    import numpy as np
    v = r + 0.5
    bad = ~(v < 2.0 ** 63) | (v < -2.0 ** 63)  # NaN is bad too
    return np.where(bad, INT64_MIN, np.trunc(np.where(bad, 0.0, v))
                    .astype(np.int64))


def _str_sign(p: "Categorical", q: "Categorical"):
    """Each row's strcmp sign of two string lanes (``uniq`` sorted)."""
    import bisect

    import numpy as np
    if len(q.uniq) == 1:
        lo = bisect.bisect_left(p.uniq, q.uniq[0])
        hi = bisect.bisect_right(p.uniq, q.uniq[0])
        return (p.ids >= hi).astype(np.int64) - (p.ids < lo)
    if len(p.uniq) == 1:
        return -_str_sign(q, p)
    rank = {u: k for k, u in enumerate(sorted(set(p.uniq).union(q.uniq)))}
    a = np.array([rank[u] for u in p.uniq], np.int64)[p.ids]
    b = np.array([rank[u] for u in q.uniq], np.int64)[q.ids]
    return np.sign(a - b)


def _rows_apply2(op: int, p: tuple, q: tuple, valid) -> tuple:
    """``_apply2`` on lanes."""
    import numpy as np
    tp, ip, rp, sp = p
    tq, iq, rq, sq = q
    either_real = tp == KEV_REAL or tq == KEV_REAL
    if 14 <= op <= 19:  # comparisons
        if tp == KEV_STR and tq == KEV_STR:
            v = _CMP[op](_str_sign(sp, sq), 0)
        elif either_real:
            v = _CMP[op](_real(ip, rp), _real(iq, rq))
        else:
            v = _CMP[op](ip, iq)
    elif op in (20, 22, 21, 12, 13, 9, 8):  # & | ^ << >> % //
        if op == 20:
            v = ip & iq
        elif op == 22:
            v = ip | iq
        elif op == 21:
            v = ip ^ iq
        elif op == 12:  # the 6-bit count of x86, wrapped on uint64
            v = (ip.view(np.uint64) << (iq & 63).view(np.uint64)).view(np.int64)
        elif op == 13:
            v = ip >> (iq & 63)
        else:  # the scalar raises on 0; INT64_MIN // -1 leaves int64
            if not iq.all() or ((ip == INT64_MIN) & (iq == -1) & valid).any():
                raise NotExact("// or % by 0, or beyond int64")
            v = ip // iq  # floor; C truncates toward zero
            v = v + ((ip % iq != 0) & ((ip < 0) != (iq < 0)))
            if op == 9:
                v = ip - v * iq
    elif op in (10, 11, 6):  # + - * (int lane wraps like int64)
        rp, rq = _real(ip, rp), _real(iq, rq)
        if op == 10:
            i, r = ip + iq, rp + rq
        elif op == 11:
            i, r = ip - iq, rp - rq
        else:
            i, r = ip * iq, rp * rq
        return KEV_REAL if either_real else KEV_INT, i, r, sp
    elif op == KEO_DIV:
        r = _real(ip, rp) / _real(iq, rq)
        return KEV_REAL, _trunc_rows(r), r, sp
    elif op == 23:  # &&
        v = (ip != 0) & (iq != 0)
    elif op == 24:  # ||
        v = (ip != 0) | (iq != 0)
    else:  # ** (op 5)
        raise NotExact("**")
    return KEV_INT, v.astype(np.int64), None, sp


def _rows_apply1(op: int, p: tuple, valid) -> tuple:
    """``_apply1`` on lanes."""
    import numpy as np
    t, i, r, s = p
    if op == 1:  # unary +
        return p
    if op == 2:  # unary -: -0.0 in the real lane, so it is kept
        _fits(i, valid)
        return t, -i, -_real(i, r), s
    i = ~i if op == 3 else (i == 0).astype(np.int64)  # ~ or !
    return KEV_INT, i, None, s


def _apply2(op: int, p: list, q: list) -> None:
    tp, tq = p[0], q[0]
    either_real = tp == KEV_REAL or tq == KEV_REAL
    if 14 <= op <= 19:  # comparisons
        if tp == KEV_STR and tq == KEV_STR:
            c = (p[3] > q[3]) - (p[3] < q[3])
            val = _CMP[op](c, 0)
        elif either_real:
            val = _CMP[op](p[2], q[2])
        else:
            val = _CMP[op](p[1], q[1])
        p[1] = int(val)
        p[2] = float(p[1])
        p[0] = KEV_INT
    elif op in (20, 22, 21, 12, 13, 9, 8):  # & | ^ << >> % //
        a, b = p[1], q[1]
        if op == 20:
            p[1] = a & b
        elif op == 22:
            p[1] = a | b
        elif op == 21:
            p[1] = a ^ b
        elif op == 12:
            # x86 shifts mask the count to 6 bits, negative counts included
            p[1] = _wrap64(a << (b & 63))
        elif op == 13:
            p[1] = a >> (b & 63)
        elif op == 9:
            p[1] = _c_mod(a, b)
        else:
            p[1] = _c_idiv(a, b)
        p[2] = float(p[1])
        p[0] = KEV_INT
    elif op in (10, 11, 6):  # + - * (int lane wraps like int64)
        if op == 10:
            p[1] = _wrap64(p[1] + q[1])
            p[2] = p[2] + q[2]
        elif op == 11:
            p[1] = _wrap64(p[1] - q[1])
            p[2] = p[2] - q[2]
        else:
            p[1] = _wrap64(p[1] * q[1])
            p[2] = p[2] * q[2]
        p[0] = KEV_REAL if either_real else KEV_INT
    elif op == KEO_DIV:
        p[2] = p[2] / q[2] if q[2] != 0 else _c_div(p[2], q[2])
        p[1] = _trunc(p[2])
        p[0] = KEV_REAL
    elif op == 23:  # &&
        p[1] = int(bool(p[1]) and bool(q[1]))
        p[2] = float(p[1])
        p[0] = KEV_INT
    elif op == 24:  # ||
        p[1] = int(bool(p[1]) or bool(q[1]))
        p[2] = float(p[1])
        p[0] = KEV_INT
    elif op == 5:  # **
        p[2] = _c_pow(p[2], q[2])
        p[1] = _trunc(p[2])
        p[0] = KEV_REAL if either_real else KEV_INT


def _apply1(op: int, p: list) -> None:
    if op == 1:  # unary +
        return
    if op == 2:  # unary -
        p[1] = -p[1]
        p[2] = -p[2]
    elif op == 3:  # ~
        p[1] = ~p[1]
        p[2] = float(p[1])
        p[0] = KEV_INT
    elif op == 4:  # !
        p[1] = int(not p[1])
        p[2] = float(p[1])
        p[0] = KEV_INT


_VEC_FUNCS1 = frozenset(("exp", "log", "log10", "sqrt", "sin", "cos", "tan"))

_CMP = {
    14: lambda a, b: a < b,
    15: lambda a, b: a <= b,
    16: lambda a, b: a > b,
    17: lambda a, b: a >= b,
    18: lambda a, b: a == b,
    19: lambda a, b: a != b,
}


def _wrap64(x: int) -> int:
    x &= (1 << 64) - 1
    return x - (1 << 64) if x >= 1 << 63 else x


class Categorical:
    """A string column as interned ids + unique values for vector eval.

    ``ids``: int array of indices into ``uniq`` (entries for absent rows may
    be any valid index; callers mask them out).  Comparisons against a
    string literal evaluate the predicate on ``uniq`` (tiny) and gather by
    id — O(n_uniq) string work for n rows.
    """

    __slots__ = ("ids", "uniq")

    def __init__(self, ids, uniq):
        self.ids = ids
        self.uniq = list(uniq)


def _vec_apply2(xp, op, tp, p, tq, q):
    either_real = tp == KEV_REAL or tq == KEV_REAL
    if 14 <= op <= 19:
        if tp == KEV_STR or tq == KEV_STR:
            if not (tp == KEV_STR and tq == KEV_STR):
                raise TypeError("string/number comparison in vector mode")
            if isinstance(p, Categorical) and isinstance(q, str):
                # strcmp semantics (kexpr.c: cmp sign vs 0)
                per = xp.asarray([_CMP[op]((u > q) - (u < q), 0)
                                  for u in p.uniq], dtype=xp.int64)
                return (KEV_INT, per[p.ids] if len(p.uniq) else
                        xp.zeros(p.ids.shape, xp.int64))
            if isinstance(q, Categorical) and isinstance(p, str):
                per = xp.asarray([_CMP[op]((p > u) - (p < u), 0)
                                  for u in q.uniq], dtype=xp.int64)
                return (KEV_INT, per[q.ids] if len(q.uniq) else
                        xp.zeros(q.ids.shape, xp.int64))
            if isinstance(p, str) and isinstance(q, str):
                return (KEV_INT, xp.asarray(
                    int(_CMP[op]((p > q) - (p < q), 0)), xp.int64))
            raise TypeError("unsupported string comparison in vector mode")
        a, b = (p, q)
        r = _CMP[op](a, b)
        return (KEV_INT, r.astype(xp.int64) if hasattr(r, "astype") else xp.asarray(r, xp.int64))
    if tp == KEV_STR or tq == KEV_STR:
        raise TypeError("string operand in vector arithmetic")
    if op in (20, 22, 21, 12, 13, 9, 8):
        a = p.astype(xp.int64)
        b = q.astype(xp.int64)
        if op == 20:
            r = a & b
        elif op == 22:
            r = a | b
        elif op == 21:
            r = a ^ b
        elif op == 12:
            r = a << b
        elif op == 13:
            r = a >> b
        elif op == 9:
            r = a - xp.trunc(a / b).astype(xp.int64) * b
        else:
            r = xp.trunc(a / b).astype(xp.int64)
        return (KEV_INT, r)
    if op in (10, 11, 6):
        r = p + q if op == 10 else p - q if op == 11 else p * q
        return (KEV_REAL if either_real else KEV_INT, r)
    if op == KEO_DIV:
        return (KEV_REAL, p / q)
    if op == 23:
        return (KEV_INT, ((p != 0) & (q != 0)).astype(xp.int64))
    if op == 24:
        return (KEV_INT, ((p != 0) | (q != 0)).astype(xp.int64))
    if op == 5:
        r = xp.power(p.astype(xp.float64) if hasattr(p, "astype") else p, q)
        if either_real:
            return (KEV_REAL, r)
        return (KEV_INT, xp.trunc(r + 0.5).astype(xp.int64))
    raise ValueError(f"bad op {op}")


def _vec_apply1(xp, op, tp, p):
    if tp == KEV_STR:
        raise TypeError("string operand in vector unary op")
    if op == 1:
        return (tp, p)
    if op == 2:
        return (tp, -p)
    if op == 3:
        return (KEV_INT, ~p.astype(xp.int64))
    if op == 4:
        return (KEV_INT, (p == 0).astype(xp.int64))
    raise ValueError(f"bad op {op}")


def parse(expr: str):
    """Parse an infix expression; returns (Kexpr|None, err)."""
    s = "".join(ch for ch in expr if not ch.isspace())
    out: list[Tok] = []
    ops: list[Tok] = []
    err = 0
    last_is_val = False
    p = 0
    n = len(s)
    while p < n:
        c = s[p]
        if c == "(":
            t = Tok()
            t.op = -1
            t.ttype = 0
            ops.append(t)
            p += 1
        elif c == ")":
            while ops and ops[-1].op >= 0:
                out.append(ops.pop())
            if not ops:
                err |= KEE_UNRP
                break
            ops.pop()  # '('
            if ops and ops[-1].ttype == _FUNC:
                out.append(ops.pop())
            p += 1
        elif c == ",":
            while ops and ops[-1].op >= 0:
                out.append(ops.pop())
            if len(ops) < 2 or ops[-2].ttype != _FUNC:
                err |= KEE_FUNC
                break
            ops[-2].n_args += 1
            p += 1
        else:
            v, p, e2 = _read_token(s, p, last_is_val)
            if e2:
                err |= e2
                break
            if v.ttype == _VAL:
                out.append(v)
                last_is_val = True
            elif v.ttype == _FUNC:
                ops.append(v)
                last_is_val = False
            else:
                oi = v.prec
                while ops and ops[-1].ttype == _OP:
                    pre = ops[-1].prec >> 1
                    if (oi & 1 and oi >> 1 <= pre) or (not oi & 1 and oi >> 1 < pre):
                        break
                    out.append(ops.pop())
                ops.append(v)
                last_is_val = False
    if err == 0:
        while ops and ops[-1].op >= 0:
            out.append(ops.pop())
        if ops:
            err |= KEE_UNLP
    if err == 0:
        cnt = 0
        for e in out:
            if e.ttype == _VAL:
                cnt += 1
            else:
                cnt -= e.n_args - 1
        if cnt != 1:
            err |= KEE_ARG
    if err:
        return None, err
    return Kexpr(out), 0
