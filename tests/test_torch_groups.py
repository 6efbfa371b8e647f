"""Sample groups evaluated over the ``.spl``'s columns (``Fmf.test_all``).

``test_all`` must give, row for row, what ``Fmf.test`` gives (``fmf_test``'s
quirks included: a real bound through ``set_int``, a missing variable fails
the row even under ``||``, an unbound function fails every row, the last
typed meta of a key wins), and say which path computed it: ``vector`` (one
evaluation over the columns) or ``scalar`` (the per-row loop, kept for
``_ROW_``, a column of strings and numbers, a value beyond int64, ``**``,
and ``//``/``%`` where the loop may raise).  The port's groups are held to
``bgt_tpu``'s reader on one database, and a column is built once however
many threads ask for it first.
"""

import random
import sys
import threading

import numpy as np
import pytest

from bgt_tpu.query import engine as jax_engine
from bgt_tpu_torch import testing
from bgt_tpu_torch.core import kexpr
from bgt_tpu_torch.formats import fmf
from bgt_tpu_torch.formats.fmf import Fmf
from bgt_tpu_torch.query import engine, importer

SPL = """\
S1\tcohort:Z:C1\tage:i:50\tbmi:f:22.5
S2\tcohort:Z:C3\tage:i:49
S3\tcohort:Z:C3\tage:f:49.9
S4
S5\tcohort:Z:C10\tage:i:10\tage:i:70
S6\tcohort:Z:C2\tage:i:60\tage
S7\tage:i:-75\tflag
S8\tcohort:Z:\tage:i:0\tsex:Z:F
S9\tcohort:Z:C3\tage:i:64\tsex:Z:M
S10\tage:i:80\tsex:Z:C3
S11\tcohort:Z:C20\tage:i:0x40\tage:f:-3.7
"""
MIXED = "S1\tx:i:1\nS2\tx:Z:a\nS3\tx:f:2.5\n"
WIDE = "S1\tage:i:-9223372036854775808\nS2\tage:i:5\n"
HUGE = "S1\tage:i:99999999999999999999\nS2\tage:i:5\n"
ONE_LABEL = "S1\tage:i:5\tsex:Z:F\nS2\tage:i:6\nS3\tage:i:7\tsex:Z:F\n"
INF = "S1\tcohort:Z:C1\tbmi:f:1e999\nS2\tcohort:Z:C2\n"

# (spl, expression, path)
CASES = {
    "str_eq": (SPL, 'cohort=="C3"', "vector"),
    "str_ne": (SPL, 'cohort!="C3"', "vector"),
    "str_lt": (SPL, 'cohort<"C2"', "vector"),
    "str_ge": (SPL, 'cohort>="C10"', "vector"),
    "str_literal_left": (SPL, '"C2">cohort', "vector"),
    "str_two_columns": (SPL, "cohort<=sex", "vector"),
    "str_literals": (SPL, '"a"<"b"&&age>0', "vector"),
    "real_binds_truncated": (SPL, "age>=50", "vector"),
    "missing_under_and": (SPL, 'cohort=="C3"&&age>=50', "vector"),
    "missing_under_or": (SPL, 'cohort=="C3"||age>=50', "vector"),
    "no_meta_constant": (SPL, "1+1", "vector"),
    "no_meta_variable": (SPL, "age>=0", "vector"),
    "repeated_key_last_wins": (SPL, "age>=60", "vector"),
    "row_name": (SPL, '_ROW_=="S2"', "scalar"),
    "row_name_or": (SPL, '_ROW_=="S4"||age>60', "scalar"),
    "mixed_column": (MIXED, "x==1", "scalar"),
    "abs": (SPL, "abs(age-50)<10", "vector"),
    "abs_real": (SPL, "abs(bmi-30.4)>8", "vector"),
    "abs_two_args": (SPL, "abs(age,0)", "vector"),
    "unbound_function": (SPL, "sqrt(age)>1", "vector"),
    "unbound_function_or": (SPL, "foo(1)||age>0", "vector"),
    "real_top": (SPL, "age/100", "vector"),
    "real_top_negative": (SPL, "age/-60", "vector"),
    "div_zero_top": (SPL, "age/0", "vector"),
    "nan_top": (SPL, "(age-age)/0", "vector"),
    "idiv": (SPL, "(age-50)//7", "vector"),
    "mod": (SPL, "(age-50)%7", "vector"),
    "idiv_by_zero": (SPL, "age//0", "scalar"),
    "mod_by_zero": (SPL, "age%0", "scalar"),
    "mod_by_zero_row": (SPL, "age%(age-49)", "scalar"),
    "mod_by_variable_unbound_rows": (SPL, "7%age", "scalar"),
    "mod_by_constant_unbound_rows": (SPL, "age%7==1", "vector"),
    # an unbound row's stale binding may have another type (REAL before the
    # first binding), so a divisor a string feeds is not constant either
    "mod_by_string_unbound_rows": (SPL, "age%(0x10>abs(cohort))", "scalar"),
    "mod_by_one_valued_string": (ONE_LABEL, 'age%("zz"!=sex)', "scalar"),
    "shl_64": (SPL, "age<<64", "vector"),
    "shl_65": (SPL, "(age<<65)==age*2", "vector"),
    "shl_negative": (SPL, "1<<(age-60)", "vector"),
    "shl_wraps": (SPL, "(age<<62)<0", "vector"),
    "shr_70": (SPL, "age>>70", "vector"),
    "shr_negative_65": (SPL, "(-age>>65)==-1", "vector"),
    "real_operand_and": (SPL, "0.3&&age", "vector"),
    "real_operand_half": (SPL, "0.5&&age", "vector"),
    "real_operand_bits": (SPL, "(2.7&3)==3&&age", "vector"),
    "hex_literal_lanes": (SPL, "0x10+age>60", "vector"),
    "hex_literal_real_lane": (SPL, "0x10*1.0+age>60", "vector"),
    "int_wraps": (SPL, "age*9223372036854775807>0", "vector"),
    "real_lane_no_wrap": (SPL, "age*9223372036854775807>0.5", "vector"),
    "string_arithmetic": (SPL, "cohort+1", "vector"),
    "string_vs_number": (SPL, "cohort==0", "vector"),
    "negated_string": (SPL, '-cohort=="C3"', "vector"),
    "not_bits": (SPL, "!age||~age==-1", "vector"),
    "pow": (SPL, "age**2>2500", "scalar"),
    "literal_beyond_int64": (SPL, "age<99999999999999999999", "scalar"),
    "negate_int64_min": (WIDE, "-age>0", "scalar"),
    "abs_int64_min": (WIDE, "abs(age)>0", "scalar"),
    "int64_min_compared": (WIDE, "age<0", "vector"),
    "value_beyond_int64": (HUGE, "age>0", "scalar"),
    "real_that_does_not_bind": (INF, 'cohort=="C1"', "scalar"),
    "stack_underflow": (SPL, "abs()1", "scalar"),  # parses; eval raises
}


def _table(tmp_path, text):
    path = tmp_path / "t.spl"
    path.write_text(text)
    return Fmf.read(str(path))


def _scalar(f, expr):
    """``[f.test(i, ke) ...]``, or the exception it raises."""
    ke, err = kexpr.parse(expr)
    assert not err
    try:
        return [f.test(i, ke) for i in range(f.n_rows)]
    except Exception as e:  # noqa: BLE001 - the loop's own outcome
        return type(e)


def _columns(f, expr):
    """``f.test_all``'s rows and path, or the exception it raises."""
    ke, err = kexpr.parse(expr)
    assert not err
    try:
        mask, path = f.test_all(ke)
    except Exception as e:  # noqa: BLE001
        return type(e), "scalar"
    assert mask.dtype == bool and mask.shape == (f.n_rows,)
    return mask.tolist(), path


@pytest.mark.parametrize("case", sorted(CASES))
def test_test_all_equals_the_row_loop(tmp_path, case):
    text, expr, want_path = CASES[case]
    f = _table(tmp_path, text)
    before = dict(fmf.GROUP_EVAL)
    got, path = _columns(f, expr)
    assert path == want_path
    assert {k: v - before[k] for k, v in fmf.GROUP_EVAL.items()} == {
        "vector": path == "vector", "scalar": path == "scalar"}
    assert got == _scalar(f, expr)


def test_cases_pass_and_fail_rows(tmp_path):
    """The cases are not vacuous: the named ones select a proper subset."""
    f = _table(tmp_path, SPL)
    for case in ("str_eq", "missing_under_or", "repeated_key_last_wins",
                 "abs", "real_top", "mod", "real_operand_half"):
        rows = _scalar(f, CASES[case][1])
        assert 0 < sum(rows) < f.n_rows, case
    assert _scalar(f, "age>=50")[2] is False  # age:f:49.9
    assert _scalar(f, "1+1")[3] is True       # no metadata
    assert _scalar(f, "age>=0")[3] is False
    assert not any(_scalar(f, "sqrt(age)>1"))
    assert _scalar(f, "age//0") is ZeroDivisionError


def _random_spl(rng: random.Random, n: int) -> str:
    labels = ["C1", "C2", "C3", "C10", "", "zz"]
    ints = [0, 1, -1, 2, 7, 49, 50, 63, 64, 65, -64, 2 ** 62, -(2 ** 62)]
    lines = []
    for r in range(n):
        metas = []
        for _ in range(rng.choice([0, 1, 2, 3, 4, 5])):
            key = rng.choice("aabst")
            if key == "a":
                metas.append(f"a:i:{rng.choice(ints + [rng.randint(-99, 99)])}")
            elif key == "b":  # ints and reals in one column
                metas.append(rng.choice([f"b:i:{rng.randint(-9, 99)}",
                                         f"b:f:{rng.uniform(-60, 60):.3f}"]))
            elif key == "s":
                metas.append(f"s:Z:{rng.choice(labels)}")
            else:
                metas.append(rng.choice(["t:Z:C2", "t:Z:C3", "t"]))
        lines.append("\t".join([f"R{r}"] + metas))
    return "\n".join(lines) + "\n"


def _random_expr(rng: random.Random, depth: int) -> str:
    if depth == 0 or rng.random() < 0.25:
        kind = rng.random()
        if kind < 0.45:
            return rng.choice("aabst")
        if kind < 0.7:
            return str(rng.choice([0, 1, 2, 3, 7, 50, 64, 70,
                                   9223372036854775807]))
        if kind < 0.85:
            return rng.choice(["0.3", "0.5", "2.5", "49.9", "1e300", "0x10"])
        return '"%s"' % rng.choice(["C1", "C2", "C3", "", "zz"])
    kind = rng.random()
    if kind < 0.7:
        op = rng.choice(["+", "-", "*", "/", "//", "%", "<<", ">>", "<",
                         "<=", ">", ">=", "==", "!=", "&", "^", "|", "&&",
                         "||", "==", "&&", "||", "**"])
        return "(%s%s%s)" % (_random_expr(rng, depth - 1), op,
                             _random_expr(rng, depth - 1))
    if kind < 0.9:
        return "%s(%s)" % (rng.choice(["-", "!", "~", "+"]),
                           _random_expr(rng, depth - 1))
    return "%s(%s)" % (rng.choice(["abs", "abs", "foo"]),
                       _random_expr(rng, depth - 1))


@pytest.mark.parametrize("seed", range(4))
def test_test_all_equals_the_row_loop_on_random_expressions(tmp_path, seed):
    rng = random.Random(9001 + seed)
    f = _table(tmp_path, _random_spl(rng, 80))
    paths = {"vector": 0, "scalar": 0}
    for _ in range(100):
        expr = _random_expr(rng, 4)
        got, path = _columns(f, expr)
        assert got == _scalar(f, expr), expr
        paths[path] += 1
    assert paths["vector"] >= 60, paths


@pytest.fixture(scope="module")
def dbs(tmp_path_factory):
    """One database, opened by the port and by ``bgt_tpu``, with a ``.spl``
    of strings, ints, reals, missing keys and ``_mgs``."""
    tmp = tmp_path_factory.mktemp("torchgroupsdb")
    n = 24
    (tmp / "in.vcf").write_text(
        testing.random_vcf(n_samples=n, n_sites=60, seed=16))
    importer.import_vcf(str(tmp / "db"), [str(tmp / "in.vcf")], is_vcf=True)
    rng = np.random.default_rng(16)
    lines = []
    for i in range(n):
        metas = [f"population:Z:{rng.choice(['CEU', 'YRI', 'CHB'])}"]
        if i % 5:
            metas.append(f"age:i:{rng.integers(18, 90)}")
        if i % 7 == 3:
            metas.append(f"age:f:{rng.uniform(18, 90):.2f}")
        if i % 4 == 1:
            metas.append(f"_mgs:i:{rng.integers(0, 3)}")
        lines.append("\t".join([f"S{i:04d}"] + metas))
    (tmp / "db.spl").write_text("\n".join(lines) + "\n")
    (tmp / "names.txt").write_text("S0001\nS0005\nS0009\nS0010\nS9999\n")
    return tmp


GROUP_SETS = {
    "expressions": ['population=="CEU"', 'age>=50&&population!="YRI"'],
    "name_list": [":S0001,S0002,S0005,S0013,S9999"],
    "name_file": ["{tmp}/names.txt"],
    "overlapping": ['population=="CEU"', "age<40", ":S0000,S0001",
                    "age>=40||age<40"],
    "row_name": ['_ROW_=="S0003"||age>70'],
    "none": ['population=="XXX"'],
}


@pytest.mark.parametrize("mgs_def", [0, 2])
@pytest.mark.parametrize("name", sorted(GROUP_SETS))
def test_groups_equal_bgt_tpus(dbs, name, mgs_def):
    prefix = str(dbs / "db")
    ours = engine.BgtmReader([engine.BgtFile(prefix)])
    ref = jax_engine.BgtmReader([jax_engine.BgtFile(prefix)])
    before = dict(fmf.GROUP_EVAL)
    for bm in (ours, ref):
        bm.set_mgs(mgs_def)
    paths = []
    for expr in GROUP_SETS[name]:
        expr = expr.format(tmp=dbs)
        assert ours.add_group(expr) == ref.add_group(expr)
        for g, h in zip(ours.bgt, ref.bgt):
            np.testing.assert_array_equal(g.gtag, h.gtag)
        paths.append(ours.group_path)
    ours.prepare()
    ref.prepare()
    for g, h in zip(ours.bgt, ref.bgt):
        np.testing.assert_array_equal(g.out, h.out)
        np.testing.assert_array_equal(g.group, h.group)
    for attr in ("group", "mgs", "sample_idx"):
        np.testing.assert_array_equal(getattr(ours, attr), getattr(ref, attr))
    assert ours.h_out.raw == ref.h_out.raw
    want = [None if e.startswith(("{", ":")) else
            "scalar" if "_ROW_" in e else "vector" for e in GROUP_SETS[name]]
    assert paths == want
    rose = fmf.GROUP_EVAL["vector"] - before["vector"]
    assert rose == want.count("vector")
    ours.close()
    ref.close()


def test_name_rows_matches_every_row_of_a_name(tmp_path):
    f = _table(tmp_path, "A\tx:i:1\nB\nA\tx:i:2\nC\n")
    assert f.name_rows(["A", "C", "Z"]).tolist() == [True, False, True, True]
    assert f.name_rows([]).tolist() == [False] * 4


def test_first_calls_from_threads_build_each_column_once(tmp_path,
                                                         monkeypatch):
    text = "".join(f"S{i}\tcohort:Z:C{i % 5}\tage:i:{i % 90}\n"
                   for i in range(2000))
    f = _table(tmp_path, text)
    built = []
    real = Fmf._build_column

    def counted(self, key):
        built.append(key)
        return real(self, key)

    monkeypatch.setattr(Fmf, "_build_column", counted)
    expr = 'cohort=="C3"&&age>=50'
    want = _scalar(_table(tmp_path, text), expr)
    n = 8
    start = threading.Barrier(n)
    out = [None] * n

    def run(k):
        start.wait()
        out[k] = _columns(f, expr)

    before = fmf.GROUP_EVAL["vector"]
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=run, args=(k,)) for k in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    assert all(o == (want, "vector") for o in out)
    assert sorted(built) == ["age", "cohort"]
    assert fmf.GROUP_EVAL["vector"] - before == n
