"""K16's program (``sail_tpu_torch/ops/chain.py``) on the CPU: its plain
interpreter against the closures it replaces, and the port with fused
chains against the reference.

For each kind of expression (parametrised) a Filter/Project chain over
``torch_chain_common.chain_table`` (every physical type, NULLs, NaN, -0.0,
infinities, zero divisors and decimal edge values) must bind to K16, and
``run_chain_plain`` must give what the chain's closures give on the same
batch: the selection exactly, each column's validity exactly and its data
exactly where valid, float64 included (the interpreter makes the same
IEEE operations, a true division where the closures divide). The answer
with fused chains must equal the answer with every chain forced onto its
closures, and the reference's (``sail_tpu``'s ``ExprCompiler`` through its
``LocalExecutor``) as ``torch_tpch_common.assert_same_result`` compares
them. Dictionary codes out of a lookup table's range in dead rows are
clamped, not read past the table.
"""

import re
import pathlib

import numpy as np
import pyarrow as pa
import pytest
import torch

from sail_tpu_torch.exec import local as xl
from sail_tpu_torch.ops import chain as ch
from sail_tpu_torch.plan import compiler as tcomp
from sail_tpu_torch.plan import rex as rx
from sail_tpu_torch.spec import data_type as dt
from torch_chain_common import (CHAIN_QUERIES, Capture, PerOp, chain_table,
                                same_cv, session)
from torch_tpch_common import assert_same_result, reference_session

TABLE = chain_table()
# the kinds whose every expression the reference computes as Spark does
# (ROADMAP Queue C lists the rest: casts of NaN and infinities to
# integers, logarithms of x <= 0, rounding to negative digits, and IN
# over a list with a NULL or of decimals beside a double, which
# test_torch_cast_in.py holds to Spark)
REFERENCE_QUERIES = {k: v for k, v in CHAIN_QUERIES.items()
                     if k not in ("cast", "math", "in")}
REFERENCE_QUERIES["in"] = (
    "SELECT i32 IN (1, 2, 3, 0), dec IN (1.25, 0.05, 0.0) FROM t")
REFERENCE_QUERIES["cast"] = (
    "SELECT CAST(i32 AS BIGINT), CAST(i64 AS INT), CAST(i32 AS DOUBLE), "
    "CAST(i8 AS BOOLEAN), CAST(b AS INT), CAST(i16 AS DECIMAL(10,2)), "
    "CAST(f32 AS DOUBLE) FROM t")
REFERENCE_QUERIES["math"] = (
    "SELECT sqrt(f64), exp(f64 / 100), power(f64, 2), round(dec, 1), "
    "bround(f64, 2), floor(f64), ceil(dec), abs(i32), i64 & 7, "
    "shiftright(i64, 3), atan2(f64, i32), hypot(f64, f64), sign(f64), "
    "isnan(f64), cbrt(f64) FROM t")


@pytest.fixture(scope="module")
def cpu():
    return session("cpu", TABLE)


@pytest.fixture(scope="module")
def reference():
    return reference_session({"t": TABLE})


@pytest.mark.parametrize("kind", sorted(CHAIN_QUERIES))
def test_program_equals_closures(cpu, kind):
    with Capture() as cap:
        cpu.sql(CHAIN_QUERIES[kind]).toArrow()
    assert [r["route"] for r in cpu.last_chain_routes] == ["K16"], \
        cpu.last_chain_routes
    for stage, child in cap.k16:
        cols, sel = xl.LocalExecutor._cols(child), child.device.sel
        got, got_sel = ch.run_chain_plain(stage.prog, cols, sel)
        want, want_sel = stage.chain_fn(cols, sel)
        assert torch.equal(got_sel, want_sel)
        assert len(got) == len(want)
        for j, (g, w) in enumerate(zip(got, want)):
            same_cv(g, w)


def _rows(t: pa.Table):
    return [[None if v is None else ("nan" if v != v else v) for v in row]
            for row in zip(*(c.to_pylist() for c in t.columns))]


@pytest.mark.parametrize("kind", sorted(CHAIN_QUERIES))
def test_fused_answer_equals_closures(cpu, kind):
    got = cpu.sql(CHAIN_QUERIES[kind]).toArrow()
    with PerOp():
        want = cpu.sql(CHAIN_QUERIES[kind]).toArrow()
    assert got.schema == want.schema
    assert _rows(got) == _rows(want)


@pytest.mark.parametrize("kind", sorted(REFERENCE_QUERIES))
def test_fused_answer_equals_reference(cpu, reference, kind):
    got = cpu.sql(REFERENCE_QUERIES[kind]).toArrow()
    assert [r["route"] for r in cpu.last_chain_routes] == ["K16"]
    assert_same_result(got, reference.sql(REFERENCE_QUERIES[kind]).toArrow())


def test_dead_rows_codes_out_of_range_are_clamped():
    """A lookup over dictionary codes that are out of the table's range in
    dead rows reads the table's ends there; live rows are the closure's."""
    words = pa.array(["AIR", "MAIL", "SHIP"])
    comp = tcomp.ExprCompiler([dt.StringType()], {0: words}, "cpu",
                              column_frags=[ch.col(0, torch.int32, False)])
    ref = rx.BoundRef(0, "s", dt.StringType(), False)
    c = comp.compile(rx.RCall("like", (ref, rx.RLit(_lit("%AI%"))),
                              dt.BooleanType(), False))
    codes = torch.tensor([0, 1, 2, 7, -3, 2], dtype=torch.int32)
    sel = torch.tensor([True, True, True, False, False, True])
    prog = ch.build_program([], [c.frag], "cpu")
    (got, gv), = ch.run_chain_plain(prog, [(codes, None)], sel)[0]
    want, _ = c.fn([(torch.clamp(codes, 0, 2), None)])
    assert gv is None
    assert torch.equal(got, want)
    assert got.tolist() == [True, True, False, False, True, False]


def _lit(s: str):
    from sail_tpu_torch.spec.literal import Literal
    return Literal(dt.StringType(), s)


def test_steady_run_binds_nothing(cpu):
    """A repeated query finds its chain programs in the session's cache:
    no chain is bound again and no dictionary table built."""
    sql = CHAIN_QUERIES["strings"]
    cpu.sql(sql).toArrow()
    binds = []
    bind = xl.LocalExecutor._bind_stage
    xl.LocalExecutor._bind_stage = lambda *a: binds.append(1) or bind(*a)
    try:
        before = cpu.dict_tables.builds
        cpu.sql(sql).toArrow()
    finally:
        xl.LocalExecutor._bind_stage = bind
    assert binds == [] and cpu.dict_tables.builds == before


def test_programs_key_on_subquery_values():
    """A scalar subquery's value is baked into the program, so a program
    built for one value is not reused for another."""
    sql = "SELECT i32 + (SELECT max(i16) FROM t) FROM t WHERE i32 > 0"
    spark = session("cpu", TABLE)
    first = spark.sql(sql).toArrow().column(0).to_pylist()
    other = TABLE.set_column(TABLE.column_names.index("i16"), "i16",
                             pa.array(np.full(TABLE.num_rows, 7,
                                              dtype=np.int16)))
    spark.createDataFrame(other).createOrReplaceTempView("t")
    second = spark.sql(sql).toArrow().column(0).to_pylist()
    base = [v for v in TABLE.column("i32").to_pylist()
            if v is not None and v > 0]
    top = max(TABLE.column("i16").to_pylist())
    assert first == [v + top for v in base]
    assert second == [v + 7 for v in base]


def test_registers_are_reused():
    """Liveness allocation: 90 outputs over one column need a handful of
    registers, not 90."""
    x = ch.col(0, torch.int32, False)
    outs = [ch.strict("add", ch.conv(x, torch.int64),
                      ch.const(k, torch.int64), dtype=torch.int64)
            for k in range(90)]
    prog = ch.build_program([], outs, "cpu")
    assert prog.nreg <= 4
    col = torch.arange(10, dtype=torch.int32)
    got, _ = ch.run_chain_plain(prog, [(col, None)],
                                torch.ones(10, dtype=torch.bool))
    for k, (d, v) in enumerate(got):
        assert v is None and torch.equal(d, col.to(torch.int64) + k)


def _enum(source: str, name: str):
    body = re.search(r"enum %s \{(.*?)\};" % name, source, re.S).group(1)
    return [x.split("=")[0].strip() for x in body.split(",") if x.strip()]


def test_kernel_source_agrees_with_the_encoder():
    """The generator has an emitter for each of the encoder's opcodes,
    and chain.cuh's type and accumulator numbering is the encoder's."""
    from sail_tpu_torch.ops import chain_codegen as cg

    assert set(cg.EMITTERS) == set(ch.OPCODES)
    src = (pathlib.Path(ch.__file__).parents[1] / "csrc" /
           "chain.cuh").read_text()
    names = {"kBool": torch.bool, "kI8": torch.int8, "kI16": torch.int16,
             "kPI32": torch.int32, "kPI64": torch.int64,
             "kF32": torch.float32, "kF64p": torch.float64}
    assert {names[k]: i for i, k in enumerate(_enum(src, "Phys"))} == \
        ch.TYPE_CODE
    acc = _enum(src, "Acc")
    assert [k[1:].lower() for k in acc] == \
        [a.replace("_", "") for a in ch.ACC_KINDS]
    assert list(cg._ACC_ENUM) == acc
