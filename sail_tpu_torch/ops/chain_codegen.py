"""K16, K17 and K18 as generated kernels: each chain program
(``ops/chain.py`` ``ChainProgram``) written out as the CUDA C++ source of
one kernel, compiled with NVRTC when the chain is bound
(``csrc.jit_kernel``), and launched by ``chain.run_chain``,
``chain.run_chain_reduce`` and ``chain.run_chain_sort``.

Every instruction becomes one statement over C++ locals (a 64-bit word and
a validity, as the plain interpreter's registers hold them), so a row
runs the program without an opcode switch or a register file: each input
is loaded at its physical type, its validity only where it is nullable;
each output is stored at its type; the SQL's constants are literals (a
double as its bit pattern). A scalar subquery's value and each lookup
table are kernel arguments, so programs that differ only in them share
one source and one compile: the compiled kernel is keyed by the source's
hash. The device functions and the row loop are ``csrc/chain.cuh``'s.

K17's tail is specialised too: each accumulator's kind and identity are
literals; keyless, each thread keeps its partials in registers across the
row loop and the block combines them once; with direct bins the warp
combines a bin's lanes and one lane adds into the block's accumulators in
shared memory, which the block adds into the global ones once.

K18 is K16's kernel with each sort key's tail after the row's outputs:
the key's K3 word (``csrc/order_keys.cuh``, the bits K3 computes) and its
validity stored, and its least and greatest word over the live rows kept
in registers across the thread's rows, then combined over the warp, the
block, and by one 64-bit atomicMin and atomicMax a key and block.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Dict, List, NamedTuple, Tuple

import torch

from .. import csrc
from ..functions import numeric as NUM
from . import chain as ch

BLOCK = 128  # chain.cuh kBlock
KERNEL_NAME = {"K16": "sail_chain_k16", "K17": "sail_chain_k17",
               "K18": "sail_chain_k18"}


def kernel_name(prog: ch.ChainProgram) -> str:
    """The name of ``prog``'s kernel: K17 reduces, K18 writes sort words,
    K16 does neither."""
    return KERNEL_NAME["K17" if prog.reduces else
                       "K18" if prog.sorts else "K16"]

# each physical type's C type in a generated kernel (float64 travels as
# its bits)
_CTYPE = {torch.bool: "unsigned char", torch.int8: "signed char",
          torch.int16: "short", torch.int32: "int", torch.int64: "long long",
          torch.float32: "float", torch.float64: "long long"}


def _load(dtype: torch.dtype, ptr: str, at: str) -> str:
    """A value of ``dtype`` at ptr[at] as a word."""
    x = f"{ptr}[{at}]"
    if dtype == torch.bool:
        return f"(long long)({x} != 0)"
    if dtype == torch.float32:
        return f"wrd((double){x})"
    return f"(long long){x}"


def _stored(dtype: torch.dtype, w: str) -> str:
    """Word w as a value of ``dtype``."""
    if dtype == torch.bool:
        return f"(unsigned char)({w} != 0)"
    if dtype == torch.float32:
        return f"__double2float_rn(dbl({w}))"
    return f"({_CTYPE[dtype]}){w}"


def _word(w: int) -> str:
    return f"((long long)0x{w & (2 ** 64 - 1):016x}ull)"


def _bool(b) -> str:
    return "true" if b else "false"


class Generated(NamedTuple):
    """A program's kernel source: the kernel's ``name``, what each of its
    argument words holds (``layout``: (kind, index)), the rows a thread
    carries at a time and the dynamic shared bytes it needs."""

    source: str
    name: str
    layout: Tuple[Tuple[str, int], ...]
    rows: int
    smem: int


class _Writer:
    """The statements of one program's row body, and its arguments."""

    def __init__(self, prog: ch.ChainProgram):
        self.prog = prog
        self.layout: List[Tuple[str, int]] = [("n", 0), ("sel", 0),
                                              ("sink", 0)]
        self.decls: List[str] = []
        self.lines: List[str] = []
        self.reg: Dict[int, Tuple[str, str]] = {}
        self.const_args: Dict[int, Tuple[str, str]] = {}
        self.tables: Dict[int, Tuple[str, str]] = {}
        # K17 with direct bins: each ACC's (slot, kind), its row value in
        # p<slot>, combined over the warp's peers once for all of them
        self.accs: List[Tuple[int, int]] = []

    def arg(self, kind: str, index: int) -> str:
        self.layout.append((kind, index))
        return f"A.a[{len(self.layout) - 1}]"

    def pointer(self, kind: str, index: int, ctype: str, name: str) -> str:
        self.decls.append(f"{ctype}* __restrict__ {name} = "
                          f"({ctype}*){self.arg(kind, index)};")
        return name

    def operand(self, i: int) -> Tuple[str, str]:
        """(word, validity) expressions of an instruction's operand: a
        register, a constant (-2 - its index) or none (-1)."""
        if i >= 0:
            return self.reg[i]
        if i == -1:
            return "0LL", "true"
        k = -2 - i
        word, valid, _, is_arg = self.prog.consts[k]
        if not is_arg:
            return _word(word), _bool(valid)
        if k not in self.const_args:
            self.const_args[k] = (
                f"(long long){self.arg('arg', k)}",
                f"({self.arg('arg_valid', k)} != 0)")
        return self.const_args[k]

    def table(self, t: int) -> Tuple[str, str]:
        if t not in self.tables:
            dtype = self.prog.tables[t].dtype
            ptr = self.pointer("table", t, f"const {_CTYPE[dtype]}",
                               f"tab{t}")
            n = f"tlen{t}"
            self.decls.append(f"const long long {n} = "
                              f"(long long){self.arg('table_len', t)};")
            self.tables[t] = (ptr, n)
        return self.tables[t]


# ---------------------------------------------------------------------------
# one emitter an opcode: (writer, instruction) -> the statement that sets
# d and vd (declared before it) from the operands a, b, c and their
# validities va, vb, vc (format fields)
# ---------------------------------------------------------------------------

_CMP = ("==", "!=", "<", "<=", ">", ">=")


def _binary(expr: str, valid: str = "{va} && {vb}"):
    return lambda w, ins: f"{{d}} = {expr}; {{vd}} = {valid};"


def _unary(expr: str):
    return _binary(expr, "{va}")


def _col(w: _Writer, ins) -> str:
    s = ins[5]
    _, dtype, nullable = w.prog.inputs[s]
    ptr = w.pointer("in", s, f"const {_CTYPE[dtype]}", f"in{s}")
    valid = "true"
    if nullable:
        valid = w.pointer("in_valid", s, "const unsigned char", f"vin{s}") + \
            "[at] != 0"
    return f"{{d}} = {_load(dtype, ptr, 'at')}; {{vd}} = {valid};"


def _const(w: _Writer, ins) -> str:
    word, valid = w.operand(-2 - ins[5])
    return f"{{d}} = {word}; {{vd}} = {valid};"


def _wrap(w, ins) -> str:
    ctype = {8: "signed char", 16: "short", 32: "int"}[ins[5]]
    return f"{{d}} = (long long)({ctype}){{a}}; {{vd}} = {{va}};"


def _cmp(fl: bool):
    def emit(w, ins) -> str:
        x, y = ("dbl({a})", "dbl({b})") if fl else ("{a}", "{b}")
        return f"{{d}} = {x} {_CMP[ins[5]]} {y}; {{vd}} = {{va}} && {{vb}};"
    return emit


def _ext(fl: bool):
    def emit(w, ins) -> str:
        op = ">" if ins[5] else "<"
        x, y = ("dbl({a})", "dbl({b})") if fl else ("{a}", "{b}")
        return (f"{{{{ const bool use = {{vb}} && (!{{va}} || {y} {op} {x}); "
                f"{{d}} = use ? {{b}} : {{a}}; {{vd}} = {{va}} || {{vb}}; }}}}")
    return emit


def _sdiv_i(mod: bool):
    def emit(w, ins) -> str:
        over = "0" if mod else "LLONG_MIN"
        q = "%" if mod else "/"
        return ("{{ const bool zero = {b} == 0; const long long safe = "
                "zero ? 1 : {b}; {d} = ({a} == LLONG_MIN && safe == -1) ? "
                f"{over} : {{a}} {q} safe; "
                "{vd} = {va} && {vb} && !zero; }}")
    return emit


def _sdiv_f(mod: bool):
    def emit(w, ins) -> str:
        r = "fmod(dbl({a}), safe)" if mod else "dbl({a}) / safe"
        return ("{{ const double y = dbl({b}); const bool zero = y == 0.0; "
                "const double safe = zero ? 1.0 : y; "
                f"{{d}} = wrd({r}); {{vd}} = {{va}} && {{vb}} && !zero; }}}}")
    return emit


def _num1(w, ins) -> str:
    return (f"{{d}} = num1<{ins[5]}, kernel_type({ins[7]})>({ins[6]}, {{a}}, "
            "{va}, &{vd});")


def _num2(w, ins) -> str:
    i1, i2 = ins[6], ins[7]
    return (f"{{d}} = num2<{ins[5]}, kernel_type({i2 & 0xff}), "
            f"kernel_type({(i2 >> 8) & 0xff}), {_bool((i2 >> 16) & 1)}>("
            f"{i1 & 0xff}, {i1 >> 8}, {{a}}, {{b}}, {{va}}, {{vb}}, &{{vd}});")


def _round(w, ins) -> str:
    i2 = ins[7]
    return (f"{{d}} = round_word<kernel_type({i2 >> 16}), {_bool(ins[5])}>("
            f"{{a}}, {ins[6]}, {i2 & 0xff}, {(i2 >> 8) & 0xff}, dbl({{b}})); "
            "{vd} = {va};")


def _cal(w, ins) -> str:
    op, i1 = ins[5], ins[6]
    call = (f"cal_word<{op}, {_bool(i1 & 1)}, {_bool(i1 & 2)}>({{a}}, "
            f"{{b}})")
    if NUM.CALENDAR_OPS[op] != "months_between":
        call = f"(long long)(int){call}"
    valid = "{va} && {vb}" if i1 & 4 else "{va}"
    return f"{{d}} = {call}; {{vd}} = {valid};"


def _lut(w, ins) -> str:
    ptr, n = w.table(ins[5])
    dtype = w.prog.tables[ins[5]].dtype
    return (f"{{{{ const long long i_ = {{a}} < 0 ? 0 : ({{a}} >= {n} ? "
            f"{n} - 1 : {{a}}); {{d}} = {_load(dtype, ptr, 'i_')}; "
            "{vd} = {va}; }}")


# the statements that set no register: FILTER, STORE, BIN, PEERS, ACC
def _filter(w: _Writer, ins) -> str:
    s = "live = live && {a} != 0 && {va};"
    if w.prog.reduces:  # a warp whose rows are all dead has nothing to add
        s += " if (!warp_any(live)) return;"
    return s


def _store(w: _Writer, ins) -> str:
    j = ins[5]
    dtype, nullable = w.prog.outputs[j]
    ptr = w.pointer("out", j, _CTYPE[dtype], f"out{j}")
    s = f"if (in) {{{{ {ptr}[at] = {_stored(dtype, '{a}')};"
    if nullable:
        vp = w.pointer("out_valid", j, "unsigned char", f"vout{j}")
        s += f" {vp}[at] = {{va}};"
    return s + " }}"


def _bin(w, ins) -> str:
    dom = ins[5]
    return (f"bin = bin * {dom + 1} + ({{va}} ? (int)({{a}} < 0 ? 0 : "
            f"({{a}} > {dom - 1} ? {dom - 1} : {{a}})) : {dom});")


def _peers(w: _Writer, ins) -> str:
    if not w.prog.domains:  # keyless: the live rows into slot 0
        return "q0 += live;"
    ns = len(w.prog.slots)
    return ("const int key = live ? bin : -1; "
            "const unsigned peers = __match_any_sync(SAIL_FULL_MASK, key); "
            "const bool lead = key >= 0 && lane == __ffs(peers) - 1; "
            f"if (lead) atomicAdd(&acc_s[key * {ns}], "
            "(unsigned long long)__popc(peers));")


def _acc(w: _Writer, ins) -> str:
    s, kind = ins[5], ins[6]
    k = _ACC_ENUM[kind]
    value = "1LL" if ch.ACC_KINDS[kind] == "count" else "{a}"
    if not w.prog.domains:
        return (f"if (live && {{va}}) q{s} = combine_word<{k}>(q{s}, "
                f"{value});")
    w.accs.append((s, kind))
    if ch.ACC_KINDS[kind] == "count":
        return f"long long p{s} = key >= 0 && {{va}};"
    return (f"long long p{s} = key >= 0 && {{va}} ? {{a}} : "
            f"{_word(w.prog.slots[s][1])};")


def _peer_combine(w: _Writer) -> List[str]:
    """The row's accumulator values combined over the lanes of each bin
    (common.cuh reduce_peers' tree, its steps shared by every slot), then
    added by each bin's lowest lane into the block's accumulators."""
    ns = len(w.prog.slots)
    out = ["{",
           "  int rel = __popc(peers & ((1u << lane) - 1u));",
           "  unsigned rest = peers & (0xfffffffeu << lane);",
           "  while (__any_sync(SAIL_FULL_MASK, rest != 0)) {",
           "    const int next = __ffs(rest);",
           "    const int src = (next - 1) & 31;"]
    for s, kind in w.accs:
        out.append(f"    {{ const long long t = __shfl_sync(SAIL_FULL_MASK, "
                   f"p{s}, src); if (next) p{s} = combine_word<"
                   f"{_ACC_ENUM[kind]}>(p{s}, t); }}")
    out += ["    rest &= __ballot_sync(SAIL_FULL_MASK, !(rel & 1));",
            "    rel >>= 1;", "  }", "  if (lead) {"]
    out += [f"    atomic_word<{_ACC_ENUM[kind]}>(&acc_s[key * {ns} + {s}], "
            f"p{s});" for s, kind in w.accs]
    return out + ["  }", "}"]


_ACC_ENUM = ("kCount", "kSumI", "kSumF", "kMinI", "kMaxI", "kMinF", "kMaxF")

# each physical type's order bits (csrc/order_keys.cuh) of a register word
_ORDER_BITS = {0: "order_bits_bool({a} != 0)",
               5: "order_bits_f32(__double2float_rn(dbl({a})))",
               6: "order_bits_f64(dbl({a}))"}


def _okey(w: _Writer, ins) -> str:
    """K18's tail of one sort key: its word and validity stored, and the
    word folded into the thread's extremes where the row is live (and, for
    a grouping's key, not NULL)."""
    j, code, flags = ins[5], ins[6], ins[7]
    _, nullable, _, _ = w.prog.sort_keys[j]
    bits = _ORDER_BITS.get(code, "order_bits_int({a})")
    ptr = w.pointer("okey", j, "long long", f"okey{j}")
    store = f"{ptr}[at] = k_;"
    if nullable:
        vp = w.pointer("okey_valid", j, "unsigned char", f"vokey{j}")
        store += f" {vp}[at] = {{va}};"
    keep = "live && {va}" if flags & 2 else "live"
    return (f"{{{{ const long long k_ = order_word({bits}, "
            f"{_bool(flags & 1)}); if (in) {{{{ {store} }}}} "
            f"if ({keep}) {{{{ if (k_ < e.lo[{j}]) e.lo[{j}] = k_; "
            f"if (k_ > e.hi[{j}]) e.hi[{j}] = k_; }}}} }}}}")


EMITTERS: Dict[str, Callable] = {
    "COL": _col,
    "CONST": _const,
    "ADD_I": _binary("wrap_add({a}, {b})"),
    "SUB_I": _binary("wrap_sub({a}, {b})"),
    "MUL_I": _binary("wrap_mul({a}, {b})"),
    "ADD_F": _binary("wrd(dbl({a}) + dbl({b}))"),
    "SUB_F": _binary("wrd(dbl({a}) - dbl({b}))"),
    "MUL_F": _binary("wrd(dbl({a}) * dbl({b}))"),
    "DIV_F": _binary("wrd(dbl({a}) / dbl({b}))"),
    "WRAP": _wrap,
    "I2F": _unary("wrd((double){a})"),
    "I2F32": _unary("wrd((double)(float){a})"),
    "F2F32": _unary("wrd((double)__double2float_rn(dbl({a})))"),
    "F2I": _unary("sat_i64(dbl({a}))"),
    "F2I32": _unary("sat_i32(dbl({a}))"),
    "NE0_I": _unary("(long long)({a} != 0)"),
    "NE0_F": _unary("(long long)(dbl({a}) != 0.0)"),
    "RHA_F": lambda w, ins: (
        "{{ const double y = dbl({a}); "
        "const double s = (double)((y > 0.0) - (y < 0.0)); "
        "{d} = wrd(s * floor(fabs(y) + 0.5)); {vd} = {va}; }}"),
    "CMP_I": _cmp(False),
    "CMP_F": _cmp(True),
    "AND3": lambda w, ins: (
        "{{ const bool ab = {a} != 0, bb = {b} != 0; "
        "const bool af = {va} && !ab, bf = {vb} && !bb; "
        "{vd} = af || bf || ({va} && {vb}); {d} = ab && bb && !af && !bf; }}"),
    "OR3": lambda w, ins: (
        "{{ const bool at_ = {va} && {a} != 0, bt = {vb} && {b} != 0; "
        "{vd} = at_ || bt || ({va} && {vb}); {d} = at_ || bt; }}"),
    "NOT": _unary("(long long)({a} == 0)"),
    "ISNULL": _binary("(long long)!{va}", "true"),
    "ISNOTNULL": _binary("(long long){va}", "true"),
    "SELECT": lambda w, ins: (
        "{{ const bool cond = {a} != 0 && {va}; {d} = cond ? {b} : {c}; "
        "{vd} = cond ? {vb} : {vc}; }}"),
    "SELV": _binary("{va} ? {a} : {b}", "{va} || {vb}"),
    "PASSV": _binary("{a}"),
    "SETV": _binary("{a}", "{vb}"),
    "ANDV": _binary("{a}", "{va} && {b} != 0"),
    "BAND_NV": _binary("(long long)({a} != 0 && {b} != 0)", "true"),
    "BOR": _binary("(long long)({a} != 0 || {b} != 0)"),
    "NULLIF_I": _binary("{a}", "{va} && !({a} == {b} && {va} && {vb})"),
    "NULLIF_F": _binary("{a}",
                        "{va} && !(dbl({a}) == dbl({b}) && {va} && {vb})"),
    "EQNS_I": _binary("(long long)(({va} && {vb} && {a} == {b}) || "
                      "(!{va} && !{vb}))", "true"),
    "EQNS_F": lambda w, ins: (
        "{{ const double x = dbl({a}), y = dbl({b}); "
        "const bool eq = x == y || (isnan(x) && isnan(y)); "
        "{d} = ({va} && {vb} && eq) || (!{va} && !{vb}); {vd} = true; }}"),
    "EXT_I": _ext(False),
    "EXT_F": _ext(True),
    "SDIV_I": _sdiv_i(False),
    "SDIV_F": _sdiv_f(False),
    "SMOD_I": _sdiv_i(True),
    "SMOD_F": _sdiv_f(True),
    "PMODFIX_I": _unary("({a} != 0 && (({a} < 0) != ({b} < 0))) ? "
                        "wrap_add({a}, {b}) : {a}"),
    "PMODFIX_F": lambda w, ins: (
        "{{ const double x = dbl({a}), y = dbl({b}); "
        "{d} = wrd((x != 0.0 && ((x < 0.0) != (y < 0.0))) ? x + y : x); "
        "{vd} = {va}; }}"),
    "RESCALE": lambda w, ins: (  # sign(x) * ((|x| + f / 2) // f), f = b
        "{{ const long long ax = {a} < 0 ? "
        "(long long)(0ull - (unsigned long long){a}) : {a}; "
        "const long long q = floor_div(wrap_add(ax, {b} / 2), {b}); "
        "{d} = (long long)((unsigned long long)(({a} > 0) - ({a} < 0)) * "
        "(unsigned long long)q); {vd} = {va}; }}"),
    "FLOORDIV": _binary("{b} == 0 ? 0 : floor_div({a}, {b})"),
    "FLOORMOD": _binary("{b} == 0 ? 0 : floor_mod({a}, {b})"),
    "DATEFIELD": lambda w, ins: f"{{d}} = date_field<{ins[5]}>({{a}}); "
                                   "{vd} = {va};",
    "TRUNCDAYS": lambda w, ins: f"{{d}} = trunc_days<{ins[5]}>({{a}}); "
                                   "{vd} = {va};",
    "YMADD": lambda w, ins: f"{{d}} = ym_add<{ins[5]}>({{a}}, {{b}}); "
                               "{vd} = {va} && {vb};",
    "NUM1": _num1,
    "NUM2": _num2,
    "ROUND": _round,
    "CAL": _cal,
    "LUT": _lut,
    "FILTER": _filter,
    "STORE": _store,
    "BIN": _bin,
    "PEERS": _peers,
    "ACC": _acc,
    "OKEY": _okey,
}


# a keyless K17 with more partials than this keeps them in registers at
# one row a thread and 2 blocks an SM (Q30's 91 partials: 215 registers,
# no spill); every other program carries 4 rows a thread at 8 blocks an SM
_MANY_PARTIALS = 8


def _shape(prog: ch.ChainProgram) -> Tuple[int, int]:
    """(rows a thread carries at a time, the least resident blocks an SM
    for __launch_bounds__)."""
    if prog.reduces and not prog.domains and \
            len(prog.slots) > _MANY_PARTIALS:
        return 1, 2
    return 4, 8


def _body(w: _Writer) -> None:
    """The row body's statements, one an instruction."""
    for pc, ins in enumerate(w.prog.instrs):
        name = ch.OPCODES[ins[0]]
        (a, va), (b, vb), (c, vc) = (w.operand(i) for i in ins[2:5])
        d, vd = f"x{pc}", f"v{pc}"
        text = EMITTERS[name](w, ins).format(
            a=a, va=va, b=b, vb=vb, c=c, vc=vc, d=d, vd=vd)
        if ins[1] >= 0:
            w.lines.append(f"long long {d}; bool {vd}; {text}")
            w.reg[ins[1]] = (d, vd)
        else:
            w.lines.append(text)


def _sort_tail(w: _Writer, tag: str) -> Tuple[List[str], List[str],
                                               List[str]]:
    """K18's (declarations before the row function, the kernel's lines
    before its row loop, those after it): each key's extremes in a
    thread's registers (``Ext<tag>``), then combined over the warp and the
    block and added into ``ext`` (int64[keys, 2]) by one atomicMin and one
    atomicMax a key."""
    k = len(w.prog.sort_keys)
    ext = w.arg("ext", 0)
    decl = [f"struct Ext{tag} {{", f"  long long lo[{k}], hi[{k}];", "};",
            ""]
    pre = [f"Ext{tag} e;",
           f"for (int j = 0; j < {k}; ++j) {{ e.lo[j] = LLONG_MAX; "
           "e.hi[j] = LLONG_MIN; }"]
    post = [f"unsigned long long* __restrict__ ext = "
            f"(unsigned long long*){ext};",
            f"__shared__ long long red[{2 * k}][kBlock / 32];",
            "const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;"]
    for j in range(k):
        post.append(f"{{ const long long lo = reduce_warp_word<kMinI>("
                    f"e.lo[{j}]), hi = reduce_warp_word<kMaxI>(e.hi[{j}]); "
                    f"if (lane == 0) {{ red[{2 * j}][wid] = lo; "
                    f"red[{2 * j + 1}][wid] = hi; }} }}")
    post.append("__syncthreads();")
    for j in range(k):
        post.append(f"if (threadIdx.x == {2 * j}) block_slot<kMinI>("
                    f"red[{2 * j}], kBlock / 32, LLONG_MAX, ext + "
                    f"{2 * j});")
        post.append(f"if (threadIdx.x == {2 * j + 1}) block_slot<kMaxI>("
                    f"red[{2 * j + 1}], kBlock / 32, LLONG_MIN, ext + "
                    f"{2 * j + 1});")
    return decl, pre, post


def generate(prog: ch.ChainProgram, tag: str = "") -> Generated:
    """The CUDA source of ``prog``'s kernel. ``tag`` suffixes the names of
    K16's and K18's row function and structs (``row<tag>``, ``Args<tag>``,
    ``Ext<tag>``), so several programs' row bodies can share a translation
    unit (the tests build them on the host, where the kernel is left out;
    K18's row function there takes its ``Ext<tag>`` of extremes)."""
    w = _Writer(prog)
    _body(w)
    rows, blocks = _shape(prog)
    name = kernel_name(prog)
    head = ["// generated by sail_tpu_torch/ops/chain_codegen.py",
            '#include "chain.cuh"', ""]
    sel = ["const unsigned char* __restrict__ sel = "
           "(const unsigned char*)A.a[1];"]
    if not prog.reduces:
        args = f"Args{tag}"
        decl, pre, post = _sort_tail(w, tag) if prog.sorts else \
            ([], [], [])
        ext_param, ext_arg = (f", Ext{tag}& e", ", e") if prog.sorts \
            else ("", "")
        src = head + [
            "namespace {", "",
            f"struct {args} {{", f"  unsigned long long a[{len(w.layout)}];",
            "};", "", *decl,
            f"__device__ __forceinline__ void row{tag}(const {args}& A, "
            f"long long at, bool in{ext_param}) {{",
            *("  " + x for x in sel + ["unsigned char* __restrict__ sel_out "
                                       "= (unsigned char*)A.a[2];"] +
              w.decls + ["bool live = in && sel[at] != 0;"] + w.lines +
              ["if (in) sel_out[at] = live;"]),
            "}", "", "}  // namespace", "",
            "#ifndef SAIL_CHAIN_HOST",
            f'extern "C" __global__ void __launch_bounds__(kBlock, {blocks})',
            f"{name}(const {args} A) {{", *("  " + x for x in pre),
            f"  for_rows<{rows}>((long long)A.a[0], [&](long long at, "
            "bool in) {", f"    row{tag}(A, at, in{ext_arg});", "  });",
            *("  " + x for x in post), "}",
            "#endif", ""]
        return Generated("\n".join(src), name, tuple(w.layout), rows, 0)
    slots = prog.slots
    ns = len(slots)
    nb = prog.nbins
    row = ["for_rows<%d>(n, [&](long long at, bool in) {" % rows,
           *("  " + x for x in sel + w.decls +
             ["const int lane = threadIdx.x & 31;", "int bin = 0;",
              "bool live = in && sel[at] != 0;"] + w.lines +
             (_peer_combine(w) if prog.domains else [])),
           "});"]
    if not prog.domains:  # keyless: partials in registers
        pre = [f"long long q{s} = {_word(ident)};"
               for s, (_, ident) in enumerate(slots)]
        post = [f"__shared__ long long red[{ns}][kBlock / 32];",
                "const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;"]
        for s, (kind, ident) in enumerate(slots):
            k = _ACC_ENUM[kind]
            post.append(f"q{s} = reduce_warp_word<{k}>(q{s}); "
                        f"if (lane == 0) red[{s}][wid] = q{s};")
        post.append("__syncthreads();")
        for s, (kind, ident) in enumerate(slots):
            post.append(f"if (threadIdx.x == {s % BLOCK}) "
                        f"block_slot<{_ACC_ENUM[kind]}>(red[{s}], kBlock / 32, "
                        f"{_word(ident)}, acc + {s});")
        smem = 0
    else:  # direct bins: the block's accumulators in shared memory
        pre = ["extern __shared__ __align__(16) unsigned long long acc_s[];",
               f"for (int b = threadIdx.x; b < {nb}; b += kBlock) {{",
               *(f"  acc_s[b * {ns} + {s}] = (unsigned long long)"
                 f"{_word(ident)};" for s, (_, ident) in enumerate(slots)),
               "}", "__syncthreads();"]
        post = ["__syncthreads();",
                f"for (int b = threadIdx.x; b < {nb}; b += kBlock) {{",
                f"  const unsigned long long* s_ = acc_s + b * {ns};",
                f"  unsigned long long* g = acc + (long long)b * {ns};"]
        for s, (kind, ident) in enumerate(slots):
            post.append(f"  if ((long long)s_[{s}] != {_word(ident)}) "
                        f"atomic_word<{_ACC_ENUM[kind]}>(g + {s}, "
                        f"(long long)s_[{s}]);")
        post.append("}")
        smem = nb * ns * 8
    src = head + [
        "namespace {", "", "struct Args {",
        f"  unsigned long long a[{len(w.layout)}];", "};", "",
        "}  // namespace", "",
        f'extern "C" __global__ void __launch_bounds__(kBlock, {blocks})',
        f"{name}(const Args A) {{",
        "  const long long n = (long long)A.a[0];",
        "  unsigned long long* __restrict__ acc = "
        "(unsigned long long*)A.a[2];",
        *("  " + x for x in pre + row + post), "}", ""]
    return Generated("\n".join(src), name, tuple(w.layout), rows, smem)


# ---------------------------------------------------------------------------
# compile and launch
# ---------------------------------------------------------------------------

def kernel(prog: ch.ChainProgram, device: torch.device):
    """(``prog``'s Generated source, its loaded kernel on ``device``):
    generated and compiled (or found in ``csrc.jit_kernel``'s caches) on
    first use, then kept on the program."""
    dev = torch.device(device)
    if dev.index is None:  # "cuda" binds, a tensor's "cuda:0" launches
        dev = torch.device(dev.type, torch.cuda.current_device())
    hit = prog._kernel
    if hit is None or hit[2] != dev:
        gen = generate(prog)
        k = csrc.jit_kernel(gen.source, gen.name, BLOCK, gen.smem, dev)
        hit = prog._kernel = (gen, k, dev)
    return hit[0], hit[1]


def _pointer(t: torch.Tensor, keep: list) -> int:
    t = t.contiguous()
    keep.append(t)
    return t.data_ptr()


def arguments(gen: Generated, prog: ch.ChainProgram, cols, sel: torch.Tensor,
              outs, sink: torch.Tensor, keys=(), ext=None):
    """(the kernel's argument words as a ctypes array, the tensors they
    point into, to be kept until the launch is queued) for ``prog`` over
    the bottom columns ``cols`` and selection ``sel``: K16 writes
    ``outs`` ((data, validity) a STORE) and the selection ``sink``; K17
    adds into the accumulators ``sink``; K18 writes as K16 does, and each
    sort key's (word, validity) into ``keys`` and its extremes into
    ``ext``."""
    keep: list = [sink]
    words = (ctypes.c_uint64 * len(gen.layout))()
    for i, (kind, j) in enumerate(gen.layout):
        if kind == "n":
            v = sel.shape[0]
        elif kind == "sel":
            v = _pointer(sel, keep)
        elif kind == "sink":
            v = sink.data_ptr()
        elif kind in ("in", "in_valid"):
            d, valid = cols[prog.inputs[j][0]]
            v = _pointer(d if kind == "in" else valid, keep)
        elif kind in ("out", "out_valid"):
            v = outs[j][0 if kind == "out" else 1].data_ptr()
        elif kind == "table":
            v = _pointer(prog.tables[j], keep)
        elif kind == "table_len":
            v = prog.tables[j].shape[0]
        elif kind in ("okey", "okey_valid"):
            v = keys[j][0 if kind == "okey" else 1].data_ptr()
        elif kind == "ext":
            v = ext.data_ptr()
        elif kind == "arg":
            v = prog.consts[j][0]
        else:  # arg_valid
            v = int(prog.consts[j][1])
        words[i] = v & (2 ** 64 - 1)
    return words, keep


def launch(prog: ch.ChainProgram, cols, sel: torch.Tensor, outs,
           sink: torch.Tensor, keys=(), ext=None) -> None:
    """One launch of ``prog``'s kernel (``arguments`` says what it
    writes)."""
    dev = sel.device
    gen, k = kernel(prog, dev)
    if k.per_sm < 1:
        raise RuntimeError(f"{gen.name}: no block fits on an SM ({k.regs} "
                           f"registers, {gen.smem} B of shared memory)")
    args, keep = arguments(gen, prog, cols, sel, outs, sink, keys, ext)
    n = sel.shape[0]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    # one wave: every block of the grid-stride loop resident at once (a
    # second, partial wave would leave most SMs idle while it runs)
    grid = max(1, min(-(-n // (gen.rows * BLOCK)), sms * k.per_sm))
    csrc.jit_launch(k, args, grid, dev)
    del keep
