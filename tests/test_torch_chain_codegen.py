"""The generator of K16's and K17's kernels
(``sail_tpu_torch/ops/chain_codegen.py``) on the CPU.

Every opcode of ``chain.OPCODES`` and every accumulator kind has an
emitter, and programs that use each of them generate. A program's source
is deterministic and does not change with the values of its scalar
subqueries (they are kernel arguments), so one compile serves them all.

The generated row bodies of K16's programs are built on the host with
g++ (``csrc/chain.cuh`` under a shim that empties ``__device__`` and
defines the card's bit-cast and conversion intrinsics as the host
computes them: no device function is left out), all in one translation
unit, and run through ctypes on the chains' inputs. Each is held to
``run_chain_plain``: the selection, validities, integers and float64
exactly, except where a chain calls a libm function, whose results the
host's libm and torch's may round apart (within 8 ulp, as on the card).
A program of each K17 query's chain written as K16 (its filters, then its
aggregates' values) is held the same way. Each K18 program of
``SORT_QUERIES`` (a sort's or a sorted grouping's chain with its keys'
tail) is built the same way, its row body run over every row with its
extremes, and held to ``run_chain_sort_plain``: outputs, selection, each
key's word and validity, and the extremes, exactly.
"""

import ctypes
import pathlib
import shutil
import subprocess

import numpy as np
import pyarrow as pa
import pytest
import torch

from sail_tpu_torch.columnar import arrow_interop as ai
from sail_tpu_torch.exec import local as xl
from sail_tpu_torch.ops import chain as ch
from sail_tpu_torch.ops import chain_codegen as cg
from torch_chain_common import (CHAIN_QUERIES, REDUCE_QUERIES, SORT_QUERIES,
                                Capture, chain_table, same_cv, session,
                                ulps_close)

TABLE = chain_table()
CSRC = pathlib.Path(cg.__file__).parents[1] / "csrc"
# the kinds whose chains call libm functions (K12, K14, months_between)
ULPS_KINDS = ("math", "calendar", "keyless_expr")

# chain.cuh on the host: the device qualifiers emptied, the intrinsics the
# card computes in hardware as the host computes them
HOST_SHIM = r"""
#define SAIL_CHAIN_HOST 1
#include <climits>
#include <cmath>
#include <cstring>
#include <algorithm>
#define __host__
#define __device__
#define __forceinline__ inline
#define __constant__
#define CUDART_PI 3.1415926535897931e+0
using std::isnan;
using std::min;
inline double __longlong_as_double(long long w) {
  double x;
  std::memcpy(&x, &w, 8);
  return x;
}
inline long long __double_as_longlong(double x) {
  long long w;
  std::memcpy(&w, &x, 8);
  return w;
}
inline unsigned __float_as_uint(float x) {
  unsigned u;
  std::memcpy(&u, &x, 4);
  return u;
}
inline float __double2float_rn(double x) { return (float)x; }
"""


def _synthetic():
    """A program of the opcodes no test query reaches (float NULLIF, <=>
    and pmod's fix-up, a float cast to bool and to a narrow integer,
    PASSV) over chain_table's float64 and int32 columns."""
    f = ch.col(6, torch.float64, True)
    i = ch.col(3, torch.int32, True)
    g = ch.strict("mul", f, ch.const(0.5, torch.float64),
                  dtype=torch.float64)
    outs = [ch.op("nullif", f, g, dtype=torch.float64, nullable=True),
            ch.op("eqns", f, g, dtype=torch.bool, nullable=False),
            ch.op("pmodfix", ch.strict("smod", f, g, dtype=torch.float64), g,
                  dtype=torch.float64, nullable=True),
            ch.conv(f, torch.bool),
            ch.conv(f, torch.int16),
            ch.op("passv", ch.conv(i, torch.int64), f, dtype=torch.int64,
                  nullable=True)]
    return ch.build_program([], outs, "cpu")


# a float64 column at the edges of Spark's casts, and each cast's answer:
# toward zero, NaN 0, saturated at a long's or an int's limits, SMALLINT
# and TINYINT the int's low bits
CAST_EDGES = [float("nan"), float("inf"), float("-inf"), 1e30, -1e30, 3e9,
              -3e9, 2.7, -2.7, 2147483647.5, -2147483648.9, 9.3e18, -9.3e18,
              65535.0, 128.0, 0.0]
_TOP, _BOTTOM = (1 << 63) - 1, -(1 << 63)
_INT_TOP, _INT_BOTTOM = (1 << 31) - 1, -(1 << 31)
CAST_WANT = {
    torch.int64: [0, _TOP, _BOTTOM, _TOP, _BOTTOM, 3_000_000_000,
                  -3_000_000_000, 2, -2, 2147483647, -2147483648,
                  _TOP, _BOTTOM, 65535, 128, 0],
    torch.int32: [0, _INT_TOP, _INT_BOTTOM, _INT_TOP, _INT_BOTTOM, _INT_TOP,
                  _INT_BOTTOM, 2, -2, _INT_TOP, _INT_BOTTOM, _INT_TOP,
                  _INT_BOTTOM, 65535, 128, 0],
    torch.int16: [0, -1, 0, -1, 0, -1, 0, 2, -2, -1, 0, -1, 0, -1, 128, 0],
    torch.int8: [0, -1, 0, -1, 0, -1, 0, 2, -2, -1, 0, -1, 0, -1, -128, 0],
}


def _float_casts():
    """The program of a float64 column cast to each integer width (F2I,
    F2I32 and WRAP), over CAST_EDGES."""
    f = ch.col(0, torch.float64, False)
    prog = ch.build_program([], [ch.conv(f, t) for t in CAST_WANT], "cpu")
    hb = xl._positional(ai.from_arrow(pa.table({"f": CAST_EDGES}), "cpu"))
    return prog, xl.LocalExecutor._cols(hb), hb.device.sel


def _k16_as_k17_chain(ex, p, stage, child):
    """A K17 aggregate's chain as a K16 program: its filters, then the
    values its aggregates reduce."""
    chain, node = ex._split_chain(p.input)
    _, filters, _, _, _, _ = ex._lower_chain(chain, child, node)
    values = [a.value for a in stage.prog.aggs if a.value is not None]
    return ch.build_program(filters, values, "cpu")


@pytest.fixture(scope="module")
def programs():
    """{case: [(program, cols, sel)]}: each K16 chain of CHAIN_QUERIES,
    each K17 query's chain as K16, and the synthetic program over
    chain_table."""
    spark = session("cpu", TABLE)
    out = {}
    for kind, sql in CHAIN_QUERIES.items():
        with Capture() as cap:
            spark.sql(sql).toArrow()
        out[kind] = [(st.prog, xl.LocalExecutor._cols(c), c.device.sel)
                     for st, c in cap.k16]
    for kind, sql in REDUCE_QUERIES.items():
        with Capture() as cap:
            spark.sql(sql).toArrow()
        out[kind] = [(_k16_as_k17_chain(*x), x[0]._cols(x[3]),
                      x[3].device.sel) for x in cap.k17]
    for kind, sql in SORT_QUERIES.items():
        with Capture() as cap:
            spark.sql(sql).toArrow()
        out[kind] = [(st.prog, xl.LocalExecutor._cols(c), c.device.sel)
                     for st, c, _ in cap.k18]
    hb = xl._positional(ai.from_arrow(TABLE, "cpu"))
    out["synthetic"] = [(_synthetic(), xl.LocalExecutor._cols(hb),
                         hb.device.sel)]
    out["float_casts"] = [_float_casts()]
    return out


def test_every_opcode_and_accumulator_has_an_emitter():
    assert set(cg.EMITTERS) == set(ch.OPCODES)
    assert len(cg._ACC_ENUM) == len(ch.ACC_KINDS)


def test_programs_of_every_opcode_and_kind_generate(programs):
    """The test programs use every opcode and accumulator kind, and each
    (and each K17 program) generates one kernel of its kind."""
    spark = session("cpu", TABLE)
    for sql in REDUCE_QUERIES.values():
        spark.sql(sql).toArrow()
    k17 = [st.prog for st in spark.chain_programs.values()
           if st.route == "K17"]
    used, kinds = set(), set()
    for prog in k17 + [p for rows in programs.values() for p, _, _ in rows]:
        gen = cg.generate(prog)
        assert gen.name == cg.kernel_name(prog)
        assert f"{gen.name}(const Args A)" in gen.source
        used |= {ch.OPCODES[ins[0]] for ins in prog.instrs}
        kinds |= {k for k, _ in prog.slots or ()}
    assert used == set(ch.OPCODES)
    assert kinds == set(range(len(ch.ACC_KINDS)))
    assert any(p.domains for p in k17) and any(not p.domains for p in k17)


def _subquery_program(i16: int):
    table = TABLE.set_column(TABLE.column_names.index("i16"), "i16",
                             pa.array(np.full(TABLE.num_rows, i16,
                                              dtype=np.int16)))
    spark = session("cpu", table)
    with Capture() as cap:
        spark.sql("SELECT i32 + (SELECT max(i16) FROM t) FROM t "
                  "WHERE i32 > (SELECT min(i16) FROM t) - 20").toArrow()
    (stage, _), = cap.k16
    return stage.prog


def test_source_is_deterministic_and_ignores_subquery_values():
    """Two programs that differ only in their subqueries' values generate
    one source; the values travel as arguments."""
    a, b = _subquery_program(7), _subquery_program(-300)
    assert [c[0] for c in a.consts if c[3]] == [7, 7]
    assert [c[0] for c in b.consts if c[3]] == [-300, -300]
    ga, gb = cg.generate(a), cg.generate(b)
    assert ga.source == gb.source == cg.generate(a).source
    assert ga.layout == gb.layout
    assert sum(kind == "arg" for kind, _ in ga.layout) == 2
    assert "0x0000000000000007" not in ga.source


@pytest.fixture(scope="module")
def host_rows(programs, tmp_path_factory):
    """Every program's row body built on the host: {case: [run]}, each
    run(words, n) the row body over rows 0..n-1."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ to build the row bodies on the host")
    parts, names = [HOST_SHIM], {}
    for case, rows in sorted(programs.items()):
        for j, (prog, _, _) in enumerate(rows):
            tag = f"_{len(names)}"
            gen = cg.generate(prog, tag=tag)
            n_args = len(gen.layout)
            parts.append(gen.source)
            if prog.sorts:  # K18: the extremes out, lo and hi a key
                k = len(prog.sort_keys)
                parts.append(
                    f'extern "C" void run{tag}(const unsigned long long* a, '
                    f"long long n, long long* ext) {{ Args{tag} A; "
                    f"std::memcpy(A.a, a, sizeof(A.a)); Ext{tag} e; "
                    f"for (int j = 0; j < {k}; ++j) {{ e.lo[j] = LLONG_MAX; "
                    f"e.hi[j] = LLONG_MIN; }} for (long long i = 0; i < n; "
                    f"++i) row{tag}(A, i, true, e); for (int j = 0; j < {k}; "
                    f"++j) {{ ext[2 * j] = e.lo[j]; ext[2 * j + 1] = "
                    f"e.hi[j]; }} }}\n")
            else:
                parts.append(
                    f'extern "C" void run{tag}(const unsigned long long* a, '
                    f"long long n) {{ Args{tag} A; std::memcpy(A.a, a, "
                    f"sizeof(A.a)); for (long long i = 0; i < n; ++i) "
                    f"row{tag}(A, i, true); }}\n")
            names[(case, j)] = (f"run{tag}", gen, n_args)
    d = tmp_path_factory.mktemp("chain_rows")
    src, lib = d / "rows.cpp", d / "rows.so"
    src.write_text("\n".join(parts))
    subprocess.run(["g++", "-O1", "-std=c++17", "-shared", "-fPIC",
                    "-ffp-contract=off", f"-I{CSRC}", "-o", str(lib),
                    str(src)], check=True, capture_output=True, text=True)
    so = ctypes.CDLL(str(lib))
    out = {}
    for (case, j), (name, gen, _) in names.items():
        fn = getattr(so, name)
        fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong] + (
            [ctypes.c_void_p] if programs[case][j][0].sorts else [])
        fn.restype = None
        out.setdefault(case, []).append((fn, gen))
    return out


def _host_outputs(prog, cols, sel, fn, gen):
    """The row body built on the host over every row: its outputs and
    selection."""
    n = sel.shape[0]
    outs = [(torch.empty(n, dtype=d),
             torch.empty(n, dtype=torch.bool) if nullable else None)
            for d, nullable in prog.outputs]
    sel_out = torch.empty(n, dtype=torch.bool)
    words, keep = cg.arguments(gen, prog, cols, sel, outs, sel_out)
    fn(ctypes.byref(words), n)
    del keep
    return ch._outputs(prog, cols, outs), sel_out


@pytest.mark.parametrize("case", sorted(set(CHAIN_QUERIES) |
                                        set(REDUCE_QUERIES) |
                                        {"synthetic", "float_casts"}))
def test_host_row_bodies_equal_plain(programs, host_rows, case):
    assert programs[case], case
    for (prog, cols, sel), (fn, gen) in zip(programs[case], host_rows[case]):
        got, sel_out = _host_outputs(prog, cols, sel, fn, gen)
        want, want_sel = ch.run_chain_plain(prog, cols, sel)
        assert torch.equal(sel_out, want_sel)
        for g, w in zip(got, want):
            if case in ULPS_KINDS:
                ulps_close(g, w)
            else:
                same_cv(g, w)


def test_generated_float_casts_saturate_as_spark(programs, host_rows):
    """The generated F2I (sat_i64) and F2I32 (sat_i32, then WRAP for
    SMALLINT and TINYINT), built on the host: NaN 0, out of range
    saturated, as Spark casts a double (the card's __double2ll_rz gave
    INT64_MIN at NaN)."""
    (prog, cols, sel), = programs["float_casts"]
    (fn, gen), = host_rows["float_casts"]
    got, _ = _host_outputs(prog, cols, sel, fn, gen)
    names = {ch.OPCODES[ins[0]] for ins in prog.instrs}
    assert {"F2I", "F2I32", "WRAP"} <= names
    for (data, valid), (dtype, want) in zip(got, CAST_WANT.items()):
        assert valid is None and data.dtype == dtype
        assert data.tolist() == want, dtype


@pytest.mark.parametrize("case", sorted(SORT_QUERIES))
def test_host_k18_row_bodies_equal_plain(programs, host_rows, case):
    """Each K18 program's row body, built on the host and run over every
    row: the chain's outputs and selection, each sort key's word and
    validity, and the extremes the rows leave in its registers, equal
    ``run_chain_sort_plain``'s exactly (its keys call no libm function
    whose rounding differs: sqrt and atan2 of SORT_QUERIES' are held to
    it within 8 ulp, as a word of a float64 then is)."""
    assert programs[case], case
    for (prog, cols, sel), (fn, gen) in zip(programs[case], host_rows[case]):
        n = sel.shape[0]
        outs = [(torch.empty(n, dtype=d),
                 torch.empty(n, dtype=torch.bool) if nullable else None)
                for d, nullable in prog.outputs]
        words = [(torch.empty(n, dtype=torch.int64),
                  torch.empty(n, dtype=torch.bool) if nullable else None)
                 for _, nullable, _, _ in prog.sort_keys]
        ext = torch.empty((len(prog.sort_keys), 2), dtype=torch.int64)
        sel_out = torch.empty(n, dtype=torch.bool)
        args, keep = cg.arguments(gen, prog, cols, sel, outs, sel_out, words,
                                  ext)
        fn(ctypes.byref(args), n, ext.data_ptr())
        del keep
        want = ch.run_chain_sort_plain(prog, cols, sel)
        assert torch.equal(sel_out, want.sel)
        for g, w in zip(ch._outputs(prog, cols, outs), want.cols):
            if w is None:
                assert g is None
            elif case == "sort_exprs":
                ulps_close(g, w)
            else:
                same_cv(g, w)
        libm = case == "sort_exprs"
        for (gw, gv), (ww, wv), (dtype, _, desc, _) in zip(
                words, want.words, prog.sort_keys):
            assert (gv is None) == (wv is None)
            if gv is not None:
                assert torch.equal(gv, wv)
            if libm and dtype == torch.float64:
                # the words of two libm results 8 ulp apart differ by 8
                assert bool(((gw - ww).abs() <= 8).all())
            else:
                assert torch.equal(gw, ww)
        if not libm:
            assert torch.equal(ext, want.ext)
