"""K16, K17 and K18: a Filter/Project chain as one program, the chain with
the keyless or direct-grouped aggregate it feeds, and the chain with the
sort words of the sort or sorted grouping above it.

Replaces the device programs XLA compiled for ``sail_tpu/exec/local.py``
``_pipeline_chain``, ``_try_fused_chain``, ``_run_chain``,
``_apply_chain`` and ``_compile_chain`` (:1585-1760), the aggregate's
fused builder (:1765-1930) where its grouping is keyless or direct, and
``_fused_sort`` (:1403-1450: the chain, each sort key with its dictionary
rank table, then the lexsort) up to its sort, as the chain of a sorted
grouping too.

The expression compiler (``plan/compiler.py``) gives each expression it
can lower a ``Frag``: a node of the expression's program form beside its
torch closure. ``build_program`` turns the fragments of one chain (its
filter conditions, then its outputs, or the aggregate's keys and values,
and a sort's keys) into a ``ChainProgram``: a flat list of instructions
over numbered 64-bit registers, each with a validity bit, allocated by
liveness; a constant table; the lookup tables (dictionary LUTs) it reads;
its inputs (column index, physical type) and its outputs. Integers of
every width, dates, dictionary codes, timestamps and unscaled decimals
live in a register as int64 (a narrower result is sign-extended back from
its width, so it wraps as the closure's tensor of that width wraps);
float32 and float64 as float64 (a float32 result is rounded back to
float32).

Two runners a program:

- ``run_chain_plain`` interprets the program one instruction at a time
  with torch ops over whole columns: the plain version, which the CPU
  takes and which the tests hold to the closures.
- ``run_chain`` launches K16, the program's own kernel
  (``ops/chain_codegen.py`` generates it, NVRTC compiles it), on a CUDA
  tensor, or raises; ``run_chain_reduce`` launches K17, the program with
  its aggregate's tail, whose plain version is ``run_chain_plain``'s
  registers reduced by the K1 route's aggregate functions
  (``ops/aggregate.py``); ``run_chain_sort`` launches K18, the program
  with its sort keys' tail (each key's K3 word, ``ops/sort.py``
  ``order_keys``, its validity, and its extremes over the live rows),
  whose plain version is ``run_chain_sort_plain``. Each counts its
  launches in ``.launches``.

No launch is caught to fall back: which route a chain takes (K16, K17,
K18, or the closures one torch op a node) is decided from the plan when
it is bound, by whether every expression has a fragment.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from ..columnar.batch import Column
from ..functions import numeric as NUM
from ..functions.kernels import merge_validity
from . import aggregate as aggk
from . import sort as sortk

# ---------------------------------------------------------------------------
# fragments
# ---------------------------------------------------------------------------

# physical types a program reads and writes, by code (chain.cuh kBool...)
TYPE_CODE = {torch.bool: 0, torch.int8: 1, torch.int16: 2, torch.int32: 3,
             torch.int64: 4, torch.float32: 5, torch.float64: 6}
_CODE_TYPE = {c: t for t, c in TYPE_CODE.items()}
_INT_BITS = {torch.int8: 8, torch.int16: 16, torch.int32: 32}


def is_float(dtype: torch.dtype) -> bool:
    return dtype in (torch.float32, torch.float64)


class Table:
    """A lookup table a fragment reads: compared by identity."""

    __slots__ = ("t",)

    def __init__(self, t: torch.Tensor):
        self.t = t

    def __eq__(self, other):
        return isinstance(other, Table) and other.t is self.t

    def __hash__(self):
        return id(self.t)

    def __repr__(self):
        return f"Table({self.t.dtype}, {self.t.shape[0]})"


@dataclass(frozen=True)
class Frag:
    """One node of an expression's program form: ``op`` over ``args``
    with static operands ``imm``, giving a value of the torch type
    ``dtype`` that the node's closure gives, with a validity exactly when
    ``nullable`` (the closure's validity is not None)."""

    op: str
    args: Tuple["Frag", ...] = ()
    dtype: torch.dtype = torch.int64
    nullable: bool = False
    imm: tuple = ()
    _hash: int = field(default=0, compare=False, repr=False)

    def __post_init__(self):
        object.__setattr__(self, "_hash", hash(
            (self.op, self.args, self.dtype, self.nullable, self.imm)))

    def __hash__(self):
        return self._hash


def col(index: int, dtype: torch.dtype, nullable: bool) -> Frag:
    """Column ``index`` of the chain's bottom batch (a program may pass a
    column of any type through; it reads only those of ``TYPE_CODE``)."""
    return Frag("col", (), dtype, nullable, (index,))


def _word(value, dtype: torch.dtype) -> int:
    """A value as its 64-bit register word (a double's bits for floats)."""
    if is_float(dtype):
        return struct.unpack("<q", struct.pack("<d", float(value)))[0]
    return int(value)


def const_of(data: torch.Tensor, validity: Optional[torch.Tensor],
             arg: Optional[int] = None) -> Optional[Frag]:
    """A literal closure's 0-d value as a constant. ``arg`` (the identity
    of a scalar subquery) makes it an argument of the program's kernel
    instead of a literal in its source, so one kernel serves every value
    of the subquery."""
    if data.dim() != 0 or data.dtype not in TYPE_CODE or \
            (validity is not None and validity.dim() != 0):
        return None
    valid = validity is None or bool(validity)
    return Frag("const", (), data.dtype, validity is not None,
                (_word(data.item(), data.dtype), valid) +
                (() if arg is None else (arg,)))


def host_value(f: Frag):
    """A constant fragment's (0-d host tensor, validity or None): the
    closure's literal, without reading it back from the card."""
    word, valid = f.imm[:2]
    value = struct.unpack("<d", struct.pack("<q", word))[0] \
        if is_float(f.dtype) else word
    return torch.tensor(value, dtype=f.dtype), \
        None if not f.nullable else torch.tensor(valid)


def const(value, dtype: torch.dtype) -> Frag:
    """A non-null constant of ``dtype`` (the value as torch holds it)."""
    return const_of(torch.tensor(value, dtype=dtype), None)


def conv(f: Frag, dtype: torch.dtype) -> Frag:
    """``tensor.to(dtype)`` of f's value."""
    if f.dtype == dtype:
        return f
    return Frag("cast", (f,), dtype, f.nullable)


def op(name: str, *args: Frag, dtype: torch.dtype, nullable: bool,
       imm: tuple = ()) -> Frag:
    return Frag(name, tuple(args), dtype, nullable, imm)


def strict(name: str, *args: Frag, dtype: torch.dtype,
           imm: tuple = ()) -> Frag:
    """An op whose result is NULL where any operand is."""
    return op(name, *args, dtype=dtype,
              nullable=any(a.nullable for a in args), imm=imm)


# ---------------------------------------------------------------------------
# instructions
# ---------------------------------------------------------------------------

# opcodes: each has its emitter in chain_codegen.EMITTERS
OPCODES = (
    "COL", "CONST", "ADD_I", "SUB_I", "MUL_I", "ADD_F", "SUB_F", "MUL_F",
    "DIV_F", "WRAP", "I2F", "I2F32", "F2F32", "F2I", "F2I32", "NE0_I",
    "NE0_F", "RHA_F", "CMP_I", "CMP_F", "AND3", "OR3", "NOT", "ISNULL",
    "ISNOTNULL", "SELECT", "SELV", "PASSV", "SETV", "ANDV", "BAND_NV", "BOR",
    "NULLIF_I", "NULLIF_F", "EQNS_I", "EQNS_F", "EXT_I", "EXT_F", "SDIV_I",
    "SDIV_F", "SMOD_I", "SMOD_F", "PMODFIX_I", "PMODFIX_F", "RESCALE",
    "FLOORDIV", "FLOORMOD", "DATEFIELD", "TRUNCDAYS", "YMADD", "NUM1",
    "NUM2", "ROUND", "CAL", "LUT", "FILTER", "STORE", "BIN", "PEERS", "ACC",
    "OKEY")
_OPC = {name: i for i, name in enumerate(OPCODES)}
CMP_CODES = {"==": 0, "!=": 1, "<": 2, "<=": 3, ">": 4, ">=": 5}
DATE_FIELDS = ("year", "month", "day", "quarter", "dayofweek", "weekday",
               "dayofyear")
TRUNC_FMTS = ("year", "quarter", "month", "week")
# K17's accumulator kinds (chain.cuh enum Acc)
ACC_KINDS = ("count", "sum_i", "sum_f", "min_i", "max_i", "min_f", "max_f")
# a generated kernel takes its program's arguments as one parameter of
# 64-bit words (the row count, the selection and the sink; a pointer and a
# validity pointer for each input and output, a pointer and a length for
# each table, a word and a validity for each subquery value), which must
# stay within the 4 KB a kernel's parameters may take
MAX_ARGUMENT_WORDS = 512
# K17 keeps bins x slots accumulators of 8 bytes in shared memory: at most
# this many (96 KB); a larger aggregate takes K16, then K1
MAX_ACC_SLOTS = 12288


class SortKey(NamedTuple):
    """One key K18 writes a sort word for: ``value``'s K3 word (descending:
    its NOT) and validity. ``canonical``: a grouping's key, whose extremes
    are taken over the live non-null rows (its NULLs pack as one value);
    else a sort's, over the live rows, NULLs with their data bits."""

    value: Frag
    descending: bool = False
    canonical: bool = False


class AggSink(NamedTuple):
    """One aggregate K17 reduces: COUNT (``value`` None: COUNT(*)), SUM,
    MIN or MAX of ``value``, a fragment of the dtype the K1 route reduces
    (SUM: the output's physical type; MIN/MAX: the argument's)."""

    fn: str
    value: Optional[Frag]


@dataclass
class ChainProgram:
    """A compiled chain. ``instrs`` are (op, dst, a, b, c, i0, i1, i2)
    over registers 0..nreg-1; ``consts`` (word, validity, float, whether
    it is a kernel argument: a scalar subquery's value); ``outputs`` (K16)
    the dtype and nullability each STORE writes, ``out_map`` each chain
    output as ("store", j) or ("input", column index) (a column passed
    through);
    ``inputs`` the (column index, dtype, nullable) each COL reads by slot.
    K17: ``domains`` of the direct keys (None: keyless), ``aggs`` and, per
    aggregate, its (value slot, count slot) among ``slots`` (kind, identity
    word), slot 0 counting the live rows of each bin. K18: ``sort_keys``,
    each OKEY's (dtype, nullable, descending, canonical); an output the
    consumer does not read maps to ("none", -1)."""

    instrs: List[tuple]
    consts: List[Tuple[int, bool, bool, bool]]
    tables: List[torch.Tensor]
    inputs: List[Tuple[int, torch.dtype, bool]]
    outputs: List[Tuple[torch.dtype, bool]]
    out_map: List[Tuple[str, int]]
    nreg: int
    device: torch.device
    domains: Optional[List[int]] = None
    key_dtypes: Optional[List[torch.dtype]] = None
    key_nullable: Optional[List[bool]] = None
    aggs: Optional[List[AggSink]] = None
    agg_slots: Optional[List[Tuple[int, int]]] = None
    slots: Optional[List[Tuple[int, int]]] = None
    sort_keys: Optional[List[Tuple[torch.dtype, bool, bool, bool]]] = None
    # its generated source and loaded kernel (chain_codegen.kernel), and
    # K17's identities on the card (uploaded once)
    _kernel: Optional[tuple] = None
    _ident: Optional[torch.Tensor] = None

    @property
    def reduces(self) -> bool:
        return self.aggs is not None

    @property
    def sorts(self) -> bool:
        return self.sort_keys is not None

    @property
    def nbins(self) -> int:
        n = 1
        for d in self.domains or ():
            n *= d + 1
        return n


class _Emitter:
    """Lowers fragments to virtual-register instructions (each fragment
    once: common subexpressions are shared), then allocates registers by
    liveness."""

    def __init__(self):
        self.instrs: List[list] = []
        self.memo: Dict[Frag, int] = {}
        self.const_regs: Dict[int, int] = {}
        self.nv = 0
        self.consts: List[Tuple[int, bool, bool, bool]] = []
        self.const_ix: Dict[tuple, int] = {}
        self.tables: List[torch.Tensor] = []
        self.table_ix: Dict[int, int] = {}
        self.inputs: List[Tuple[int, torch.dtype, bool]] = []
        self.input_ix: Dict[int, int] = {}

    def _new(self) -> int:
        self.nv += 1
        return self.nv - 1

    def ins(self, name: str, a=-1, b=-1, c=-1, i0=0, i1=0, i2=0,
            dst=True) -> int:
        d = self._new() if dst else -1
        self.instrs.append([_OPC[name], d, a, b, c, i0, i1, i2])
        return d

    def _const(self, word: int, valid: bool, fl: bool, arg=None) -> int:
        """A constant as an operand: -2 - its index in the table. A
        kernel argument (``arg``: its subquery) takes an entry of its own
        whatever its value, so the program's shape does not depend on it."""
        k = (word, valid, fl) if arg is None else ("arg", arg, fl)
        if k not in self.const_ix:
            self.const_ix[k] = len(self.consts)
            self.consts.append((word, valid, fl, arg is not None))
        return -2 - self.const_ix[k]

    def operand(self, f: Frag) -> int:
        """f's value as an elementwise instruction's operand: a register,
        or a constant read from the table (no instruction)."""
        hit = self.memo.get(f)
        if hit is None:
            hit = self.memo[f] = self._lower(f)
        return hit

    def emit(self, f: Frag) -> int:
        """f's value in a register (FILTER, STORE, BIN and ACC read
        registers only)."""
        v = self.operand(f)
        if v <= -2:
            if v not in self.const_regs:
                self.const_regs[v] = self.ins("CONST", i0=-2 - v)
            v = self.const_regs[v]
        return v

    def _narrow(self, v: int, dtype: torch.dtype) -> int:
        """An arithmetic result back to ``dtype``'s width."""
        if dtype in _INT_BITS:
            return self.ins("WRAP", v, i0=_INT_BITS[dtype])
        if dtype == torch.float32:
            return self.ins("F2F32", v)
        return v

    def _lower(self, f: Frag) -> int:
        o = f.op
        if o == "col":
            if f.dtype not in TYPE_CODE:
                raise ValueError(f"a program reads no {f.dtype} column")
            k = f.imm[0]
            if k not in self.input_ix:
                self.input_ix[k] = len(self.inputs)
                self.inputs.append((k, f.dtype, f.nullable))
            return self.ins("COL", i0=self.input_ix[k])
        if o == "const":
            return self._const(f.imm[0], f.imm[1], is_float(f.dtype),
                               *f.imm[2:])
        args = [self.operand(a) for a in f.args]
        a = args[0] if args else -1
        b = args[1] if len(args) > 1 else -1
        c = args[2] if len(args) > 2 else -1
        fl = is_float(f.args[0].dtype) if f.args else False
        sfx = "_F" if fl else "_I"
        if o == "cast":
            return self._cast(a, f.args[0].dtype, f.dtype)
        if o in ("add", "sub", "mul"):
            return self._narrow(self.ins(o.upper() + sfx, a, b), f.dtype)
        if o == "div":
            return self._narrow(self.ins("DIV_F", a, b), f.dtype)
        if o == "cmp":
            return self.ins("CMP" + sfx, a, b, i0=CMP_CODES[f.imm[0]])
        if o in ("nullif", "eqns", "sdiv", "smod", "pmodfix"):
            v = self.ins(o.upper() + sfx, a, b)
            return v if o in ("nullif", "eqns") else self._narrow(v, f.dtype)
        if o == "ext":
            return self.ins("EXT" + sfx, a, b, i0=int(f.imm[0]))
        if o in ("ne0",):
            return self.ins("NE0" + sfx, a)
        if o in ("and3", "or3", "not", "isnull", "isnotnull", "select",
                 "selv", "passv", "setv", "andv", "band_nv", "bor", "rha_f", "floordiv", "floormod", "ymadd"):
            return self.ins(o.upper(), a, b, c, i0=int(f.imm[0]) if f.imm
                            else 0)
        if o == "rescale":
            return self.ins("RESCALE", a, self.operand(
                const(10 ** f.imm[0], torch.int64)))
        if o == "datefield":
            return self.ins("DATEFIELD", a, i0=DATE_FIELDS.index(f.imm[0]))
        if o == "truncdays":
            return self.ins("TRUNCDAYS", a, i0=TRUNC_FMTS.index(f.imm[0]))
        if o == "num1":
            name, scale = f.imm
            return self.ins("NUM1", a, i0=NUM.UNARY_OPS.index(name),
                            i1=scale, i2=TYPE_CODE[f.args[0].dtype])
        if o == "num2":
            name, sa, sb = f.imm
            return self.ins("NUM2", a, b, i0=NUM.BINARY_OPS.index(name),
                            i1=sa | sb << 8,
                            i2=TYPE_CODE[f.args[0].dtype] |
                            TYPE_CODE[f.args[1].dtype] << 8 |
                            int(f.args[1].op == "const") << 16)
        if o == "round":
            half_even, digits, s, so = f.imm
            fscale = self.operand(const(10.0 ** digits, torch.float64))
            return self.ins("ROUND", a, fscale, i0=int(half_even), i1=digits,
                            i2=s | so << 8 | TYPE_CODE[f.args[0].dtype] << 16)
        if o == "cal":
            name, xm, ym = f.imm
            two = len(f.args) > 1
            return self.ins(
                "CAL", a, b, i0=NUM.CALENDAR_OPS.index(name),
                i1=int(xm) | int(ym) << 1 | int(two) << 2,
                i2=TYPE_CODE[f.args[0].dtype] |
                (TYPE_CODE[f.args[1].dtype] << 8 if two else 0))
        if o == "lut":
            t = f.imm[0].t
            if id(t) not in self.table_ix:
                self.table_ix[id(t)] = len(self.tables)
                self.tables.append(t)
            return self.ins("LUT", a, i0=self.table_ix[id(t)])
        raise ValueError(f"no instruction for fragment op {o!r}")

    def _cast(self, v: int, src: torch.dtype, dst: torch.dtype) -> int:
        """``tensor.to(dst)`` of a ``src`` value: an alias where the word
        does not change."""
        if dst == torch.bool:
            return self.ins("NE0_F" if is_float(src) else "NE0_I", v)
        if is_float(dst):
            if is_float(src):
                return self.ins("F2F32", v) if dst == torch.float32 and \
                    src == torch.float64 else v
            return self.ins("I2F32" if dst == torch.float32 else "I2F", v)
        if is_float(src):  # Spark's cast: a long's or an int's limits
            if dst == torch.int64:
                return self.ins("F2I", v)
            v = self.ins("F2I32", v)
            return v if dst == torch.int32 else self._narrow(v, dst)
        src_bits = 1 if src == torch.bool else _INT_BITS.get(src, 64)
        dst_bits = _INT_BITS.get(dst, 64)
        return v if src_bits <= dst_bits else self._narrow(v, dst)


def _allocate(instrs: List[list]) -> Tuple[List[tuple], int]:
    """Physical registers for virtual ones, by liveness: a register is
    free again after its value's last read (a result may take the
    register of an operand it reads last)."""
    last: Dict[int, int] = {}
    for i, ins in enumerate(instrs):
        for v in ins[2:5]:
            if v >= 0:
                last[v] = i
    phys: Dict[int, int] = {}
    free: List[int] = []
    nreg = 0
    out = []
    for i, ins in enumerate(instrs):
        opc, d = ins[0], ins[1]
        regs = [phys[v] if v >= 0 else v for v in ins[2:5]]
        for v in set(x for x in ins[2:5] if x >= 0):
            if last[v] == i:
                free.append(phys[v])
        pd = -1
        if d >= 0:
            if free:
                free.sort(reverse=True)
                pd = free.pop()
            else:
                pd, nreg = nreg, nreg + 1
            phys[d] = pd
            if last.get(d, -1) < i:  # never read
                free.append(pd)
        out.append((opc, pd, *regs, *ins[5:]))
    return out, nreg


def build_program(filters: Sequence[Frag], outputs: Sequence[Frag],
                  device, keys: Sequence[Tuple[Frag, int]] = (),
                  aggs: Optional[Sequence[AggSink]] = None,
                  sort_keys: Optional[Sequence[SortKey]] = None
                  ) -> ChainProgram:
    """The program of one chain: its ``filters`` (in plan order), then
    either its ``outputs`` (K16: each stored, or passed through where it is
    a bottom column unchanged; None where the consumer does not read it)
    or, for K17, the direct ``keys`` (fragment, domain) and ``aggs``; K18
    adds ``sort_keys`` after the outputs. Raises ValueError where it
    exceeds the kernel's limits (the caller then takes the closures)."""
    em = _Emitter()
    for f in filters:
        em.ins("FILTER", em.emit(f), dst=False)
    out_specs: List[Tuple[torch.dtype, bool]] = []
    out_map: List[Tuple[str, int]] = []
    prog_kw = {}
    if aggs is None:
        for f in outputs:
            if f is None:
                out_map.append(("none", -1))
                continue
            if f.op == "col":
                out_map.append(("input", f.imm[0]))
                continue
            em.ins("STORE", em.emit(f), i0=len(out_specs), dst=False)
            out_map.append(("store", len(out_specs)))
            out_specs.append((f.dtype, f.nullable))
    else:
        for f, dom in keys:
            em.ins("BIN", em.emit(f), i0=dom, dst=False)
        em.ins("PEERS", dst=False)
        slots = [(0, 0)]  # live rows of each bin
        agg_slots = []
        for a in aggs:
            if a.value is None:
                agg_slots.append((0, 0))
                continue
            v = em.emit(a.value)
            cnt = 0
            if a.value.nullable:
                cnt = len(slots)
                slots.append((ACC_KINDS.index("count"), 0))
                em.ins("ACC", v, i0=cnt, i1=slots[cnt][0], dst=False)
            if a.fn == "count":
                agg_slots.append((cnt, cnt))
                continue
            kind, ident = _acc_kind(a.fn, a.value.dtype)
            slots.append((kind, ident))
            em.ins("ACC", v, i0=len(slots) - 1, i1=kind, dst=False)
            agg_slots.append((len(slots) - 1, cnt))
        prog_kw = dict(domains=[d for _, d in keys],
                       key_dtypes=[f.dtype for f, _ in keys],
                       key_nullable=[f.nullable for f, _ in keys],
                       aggs=list(aggs), agg_slots=agg_slots, slots=slots)
    if sort_keys is not None:
        if aggs is not None:
            raise ValueError("a program with sort keys has no aggregates")
        for j, k in enumerate(sort_keys):
            if k.value.dtype not in TYPE_CODE:
                raise ValueError(f"no sort word of a {k.value.dtype} key")
            em.ins("OKEY", em.emit(k.value), i0=j,
                   i1=TYPE_CODE[k.value.dtype],
                   i2=int(k.descending) | int(k.canonical) << 1, dst=False)
        prog_kw = dict(sort_keys=[(k.value.dtype, k.value.nullable,
                                   k.descending, k.canonical)
                                  for k in sort_keys])
    instrs, nreg = _allocate(em.instrs)
    words = 3 + 2 * (len(em.inputs) + len(out_specs) + len(em.tables) +
                     sum(c[3] for c in em.consts) +
                     len(sort_keys or ())) + (sort_keys is not None)
    if words > MAX_ARGUMENT_WORDS:
        raise ValueError(f"chain program of {words} argument words exceeds "
                         f"the kernel's {MAX_ARGUMENT_WORDS}")
    prog = ChainProgram(instrs, em.consts, em.tables, em.inputs, out_specs,
                        out_map, nreg, torch.device(device), **prog_kw)
    acc = prog.nbins * len(prog.slots) if prog.reduces else 0
    if acc > MAX_ACC_SLOTS:
        raise ValueError(f"{prog.nbins} bins x {len(prog.slots)} "
                         f"accumulators exceed {MAX_ACC_SLOTS}")
    return prog


def _acc_kind(fn: str, dtype: torch.dtype) -> Tuple[int, int]:
    """K17's accumulator for a SUM, MIN or MAX of ``dtype`` values, and
    its identity word: K1's, in the type K1 reduces in."""
    fl = is_float(dtype)
    if fn == "sum":
        return ACC_KINDS.index("sum_f" if fl else "sum_i"), 0
    kind = ACC_KINDS.index(f"{fn}_{'f' if fl else 'i'}")
    if fl:
        return kind, _word(float("inf") if fn == "min" else float("-inf"),
                           torch.float64)
    work = aggk.k1_work_dtype(torch.int8 if dtype == torch.bool else dtype)
    info = torch.iinfo(work)
    return kind, info.max if fn == "min" else info.min


# ---------------------------------------------------------------------------
# the plain interpreter
# ---------------------------------------------------------------------------

def _to_word(t: torch.Tensor) -> torch.Tensor:
    if is_float(t.dtype):
        return t.to(torch.float64)
    return t.to(torch.int64)


def from_word(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A register's words as ``dtype`` (the word already holds a value of
    it)."""
    if dtype == torch.bool:
        return x != 0
    return x.to(dtype)


def _ones_like(x: torch.Tensor) -> torch.Tensor:
    return torch.ones(x.shape, dtype=torch.bool, device=x.device)


def _b(x: torch.Tensor) -> torch.Tensor:
    return x != 0


def _i(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int64)


_CMP_FNS = (torch.eq, torch.ne, torch.lt, torch.le, torch.gt, torch.ge)


def _date_field(days: torch.Tensor, which: int) -> torch.Tensor:
    """``plan/compiler.py`` ``_temporal_field``'s arithmetic."""
    y, m, d = NUM.civil_from_days(days)
    name = DATE_FIELDS[which]
    if name == "year":
        return y
    if name == "month":
        return m
    if name == "day":
        return d
    if name == "quarter":
        return (m - 1) // 3 + 1
    if name == "dayofweek":
        return (days + 4) % 7 + 1
    if name == "weekday":
        return (days + 3) % 7
    return days - NUM.days_from_civil(y, torch.ones_like(m),
                                      torch.ones_like(d)) + 1


def _trunc_days(days: torch.Tensor, fmt: int) -> torch.Tensor:
    """``_trunc_builder``'s date formats over days."""
    y, m, d = NUM.civil_from_days(days)
    name = TRUNC_FMTS[fmt]
    if name == "year":
        return NUM.days_from_civil(y, torch.ones_like(m), torch.ones_like(d))
    if name == "quarter":
        return NUM.days_from_civil(y, ((m - 1) // 3) * 3 + 1,
                                   torch.ones_like(d))
    if name == "month":
        return NUM.days_from_civil(y, m, torch.ones_like(d))
    return days - (days + 3) % 7


def _ym_add(days: torch.Tensor, amt: torch.Tensor, sign: int
            ) -> torch.Tensor:
    """``_date_arith``'s year-month interval over days."""
    y, m, d = NUM.civil_from_days(days)
    months = y * 12 + (m - 1) + sign * amt
    ny, nm = months // 12, months % 12 + 1
    return NUM.days_from_civil(ny, nm, torch.minimum(d, NUM.month_len(ny, nm)))


def _typed(x: torch.Tensor, code: int) -> torch.Tensor:
    """A register as the closure's tensor of type ``code``, in the type the
    K12-K15 plain versions read."""
    return NUM._kernel_type(from_word(x, _CODE_TYPE[code]))


def _interpret(prog: ChainProgram, cols: Sequence, sel: torch.Tensor,
               sinks, state: Optional[dict] = None) -> torch.Tensor:
    """Run ``prog`` over the bottom columns ``cols`` ((data, validity) by
    column index); returns the selection. ``sinks(ins, R, V)`` receives
    each STORE, BIN, PEERS and ACC (with ``state["live"]`` the selection so
    far)."""
    R: List[Optional[torch.Tensor]] = [None] * prog.nreg
    V: List[Optional[torch.Tensor]] = [None] * prog.nreg
    dev = sel.device
    live = sel
    consts = {}

    def const_cv(i: int):
        if i not in consts:
            word, ok, fl, _ = prog.consts[i]
            consts[i] = (torch.tensor(
                struct.unpack("<d", struct.pack("<q", word))[0] if fl
                else word, dtype=torch.float64 if fl else torch.int64,
                device=dev), None if ok else torch.zeros(
                    (), dtype=torch.bool, device=dev))
        return consts[i]

    def fetch(i: int):
        """Operand i: a register, -2 - a constant's index, or -1 none."""
        if i >= 0:
            return R[i], V[i]
        return const_cv(-2 - i) if i <= -2 else (None, None)

    for ins in prog.instrs:
        opc, d, a, b, c, i0, i1, i2 = ins
        name = OPCODES[opc]
        (x, va), (y, vb), (z, vc) = fetch(a), fetch(b), fetch(c)
        out = valid = None
        if name == "COL":
            k = prog.inputs[i0][0]
            out, valid = _to_word(cols[k][0]), cols[k][1]
        elif name == "CONST":
            out, valid = const_cv(i0)
        elif name in ("ADD_I", "ADD_F"):
            out, valid = x + y, merge_validity(va, vb)
        elif name in ("SUB_I", "SUB_F"):
            out, valid = x - y, merge_validity(va, vb)
        elif name in ("MUL_I", "MUL_F"):
            out, valid = x * y, merge_validity(va, vb)
        elif name == "DIV_F":
            out, valid = x / y, merge_validity(va, vb)
        elif name == "WRAP":
            out, valid = _i(x.to({8: torch.int8, 16: torch.int16,
                                  32: torch.int32}[i0])), va
        elif name == "I2F":
            out, valid = x.to(torch.float64), va
        elif name in ("I2F32", "F2F32"):
            out, valid = x.to(torch.float32).to(torch.float64), va
        elif name == "F2I":
            out, valid = NUM.saturating_long(x), va
        elif name == "F2I32":
            out, valid = _i(NUM.saturating_int(x)), va
        elif name in ("NE0_I", "NE0_F"):
            out, valid = _i(x != 0), va
        elif name == "RHA_F":
            out, valid = torch.sign(x) * torch.floor(torch.abs(x) + 0.5), va
        elif name in ("CMP_I", "CMP_F"):
            out, valid = _i(_CMP_FNS[i0](x, y)), merge_validity(va, vb)
        elif name in ("AND3", "OR3"):
            xb, yb = _b(x), _b(y)
            if va is None and vb is None:
                out = _i(xb & yb if name == "AND3" else xb | yb)
            elif name == "AND3":
                a_f = ~xb if va is None else va & ~xb
                b_f = ~yb if vb is None else vb & ~yb
                valid = a_f | b_f | ((_ones_like(xb) if va is None else va) &
                                     (_ones_like(yb) if vb is None else vb))
                out = _i(xb & yb & ~a_f & ~b_f)
            else:
                a_t = xb if va is None else va & xb
                b_t = yb if vb is None else vb & yb
                valid = a_t | b_t | ((_ones_like(xb) if va is None else va) &
                                     (_ones_like(yb) if vb is None else vb))
                out = _i(a_t | b_t)
        elif name == "NOT":
            out, valid = _i(~_b(x)), va
        elif name == "ISNULL":
            out = _i(torch.zeros(x.shape, dtype=torch.bool, device=dev)
                     if va is None else ~va)
        elif name == "ISNOTNULL":
            out = _i(_ones_like(x) if va is None else va)
        elif name == "SELECT":
            cond = _b(x) if va is None else _b(x) & va
            t, tv, f, fv = y, vb, z, vc
            out = torch.where(cond, t, f)
            if tv is not None or fv is not None:
                valid = torch.where(cond, _ones_like(cond) if tv is None
                                    else tv,
                                    _ones_like(cond) if fv is None else fv)
        elif name == "SELV":
            if va is None:
                out = x.expand(torch.broadcast_shapes(x.shape, y.shape))
            else:
                out, valid = torch.where(va, x, y), None if vb is None \
                    else va | vb
        elif name == "PASSV":
            out, valid = x, merge_validity(va, vb)
        elif name == "SETV":
            out, valid = x, vb
        elif name == "ANDV":
            out = x
            valid = _b(y) if va is None else va & _b(y)
        elif name == "BAND_NV":
            out = _i(_b(x) & _b(y))
        elif name == "BOR":
            out, valid = _i(_b(x) | _b(y)), merge_validity(va, vb)
        elif name in ("NULLIF_I", "NULLIF_F"):
            eq = x == y
            ev = merge_validity(va, vb)
            make_null = eq if ev is None else eq & ev
            out = x
            valid = (_ones_like(make_null) if va is None else va) & ~make_null
        elif name in ("EQNS_I", "EQNS_F"):
            eq = x == y
            if name == "EQNS_F":
                eq = eq | (torch.isnan(x) & torch.isnan(y))
            av = _ones_like(x) if va is None else va
            bv = _ones_like(y) if vb is None else vb
            out = _i((av & bv & eq) | (~av & ~bv))
        elif name in ("EXT_I", "EXT_F"):
            pick = (y > x) if i0 else (y < x)
            use = pick if va is None else (~va | pick)
            if vb is not None:
                use = vb & use
            out = torch.where(use, y, x)
            if va is not None or vb is not None:
                valid = (_ones_like(use) if va is None else va) | \
                    (_ones_like(use) if vb is None else vb)
        elif name in ("SDIV_I", "SDIV_F", "SMOD_I", "SMOD_F"):
            zero = y == 0
            safe = torch.where(zero, torch.ones_like(y), y)
            integer = name.endswith("_I")
            if integer:  # INT64_MIN / -1 wraps to INT64_MIN (% -1: 0)
                over = (x == -(1 << 63)) & (y == -1)
                safe = torch.where(over, torch.ones_like(y), safe)
            if name == "SDIV_F":
                out = x / safe
            elif name == "SDIV_I":
                out = torch.div(x, safe, rounding_mode="trunc")
            else:
                out = torch.fmod(x, safe)
            valid = merge_validity(va, vb)
            valid = ~zero if valid is None else valid & ~zero
        elif name in ("PMODFIX_I", "PMODFIX_F"):
            out = torch.where((x != 0) & ((x < 0) != (y < 0)), x + y, x)
            valid = va
        elif name == "RESCALE":
            out = torch.sign(x) * ((torch.abs(x) + y // 2) // y)
            valid = va
        elif name == "FLOORDIV":
            out, valid = torch.floor_divide(x, y), merge_validity(va, vb)
        elif name == "FLOORMOD":
            out, valid = x % y, merge_validity(va, vb)
        elif name == "DATEFIELD":
            out, valid = _date_field(x, i0), va
        elif name == "TRUNCDAYS":
            out, valid = _trunc_days(x, i0), va
        elif name == "YMADD":
            out, valid = _ym_add(x, y, i0), merge_validity(va, vb)
        elif name == "NUM1":
            r, valid = NUM.math_unary_plain(_typed(x, i2), va,
                                            NUM.UNARY_OPS[i0], i1)
            out = _to_word(r)
        elif name == "NUM2":
            r, valid = NUM.math_binary_plain(
                _typed(x, i2 & 0xff), va, _typed(y, (i2 >> 8) & 0xff), vb,
                NUM.BINARY_OPS[i0], i1 & 0xff, i1 >> 8)
            out = _to_word(r)
        elif name == "ROUND":
            r = NUM.round_number_plain(_typed(x, i2 >> 16), bool(i0), i1,
                                       i2 & 0xff, (i2 >> 8) & 0xff)
            out, valid = _to_word(r), va
        elif name == "CAL":
            two = bool(i1 & 4)
            r, valid = NUM.calendar_plain(
                _typed(x, i2 & 0xff), va, NUM.CALENDAR_OPS[i0],
                _typed(y, i2 >> 8) if two else None, vb if two else None,
                bool(i1 & 1), bool(i1 & 2))
            out = _to_word(r)
        elif name == "LUT":
            t = prog.tables[i0]
            idx = torch.clamp(x, 0, t.shape[0] - 1)
            out, valid = _to_word(t[idx]), va
        elif name == "FILTER":
            keep = _b(x) if va is None else _b(x) & va
            live = live & keep
        else:  # STORE, BIN, PEERS, ACC
            if state is not None:
                state["live"] = live
            sinks(ins, R, V)
        if d >= 0:
            R[d], V[d] = out, valid
    return live


def _full(x: torch.Tensor, n: int) -> torch.Tensor:
    return x.expand(n) if x.dim() == 0 else x


def _outputs(prog: ChainProgram, cols: Sequence, stored: List):
    """The chain's output columns: stored ones and passed-through inputs
    (None for one the consumer does not read)."""
    out = []
    for kind, j in prog.out_map:
        out.append(stored[j] if kind == "store" else
                   cols[j] if kind == "input" else None)
    return out


def _stored(prog: ChainProgram, ins, R, V, n: int):
    """A STORE's column as (data, validity)."""
    dtype, nullable = prog.outputs[ins[5]]
    v = V[ins[2]]
    return (_full(from_word(R[ins[2]], dtype), n),
            None if v is None else _full(v, n))


def run_chain_plain(prog: ChainProgram, cols: Sequence, sel: torch.Tensor):
    """(output columns as (data, validity), selection) of ``prog`` over the
    bottom batch's columns ``cols`` and selection ``sel``, one torch op an
    instruction."""
    n = sel.shape[0]
    stored: List = [None] * len(prog.outputs)

    def store(ins, R, V):
        if OPCODES[ins[0]] != "STORE":
            raise ValueError(f"K16 program holds {OPCODES[ins[0]]}")
        stored[ins[5]] = _stored(prog, ins, R, V, n)

    live = _interpret(prog, cols, sel, store)
    return _outputs(prog, cols, stored), live


def _check_inputs(name: str, prog: ChainProgram, cols: Sequence,
                  sel: torch.Tensor):
    n = sel.shape[0]
    for k, dtype, nullable in prog.inputs:
        d, v = cols[k]
        if d.dtype != dtype or d.shape != (n,) or d.device != sel.device or \
                (v is not None) != nullable or \
                (v is not None and (v.dtype != torch.bool or
                                    v.shape != (n,))):
            raise TypeError(f"{name}: column {k} is {d.dtype}{tuple(d.shape)}"
                            f" (validity {v is not None}) on {d.device}; the "
                            f"program reads {dtype}[{n}] (validity "
                            f"{nullable}) on {sel.device}")


def run_chain(prog: ChainProgram, cols: Sequence, sel: torch.Tensor):
    """K16: ``run_chain_plain`` as one pass of the program's own kernel on
    the card (``ops/chain_codegen.py``; compiled once, where the chain is
    bound): every row's program runs in one thread, and the selection and
    each stored column are written once. A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel or raises (an NVRTC or load
    error included)."""
    if sel.device.type == "cpu":
        return run_chain_plain(prog, cols, sel)
    if prog.reduces or prog.sorts:
        raise ValueError("run_chain: a K17 or K18 program")
    _check_inputs("run_chain", prog, cols, sel)
    n, dev = sel.shape[0], sel.device
    outs = [(torch.empty(n, dtype=dt_, device=dev),
             torch.empty(n, dtype=torch.bool, device=dev) if nullable
             else None) for dt_, nullable in prog.outputs]
    sel_out = torch.empty(n, dtype=torch.bool, device=dev)
    if n:
        from .chain_codegen import launch  # it imports this module
        launch(prog, cols, sel, outs, sel_out)
        run_chain.launches += 1
    return _outputs(prog, cols, outs), sel_out


run_chain.launches = 0


# ---------------------------------------------------------------------------
# K17
# ---------------------------------------------------------------------------

class Reduced(NamedTuple):
    """An aggregate's output before compaction: the live bins
    (``group_sel``), the key columns decoded from the bins, one column an
    aggregate (as ``ops/aggregate.py``'s agg_count, agg_sum and
    agg_min_max give them)."""

    group_sel: torch.Tensor
    keys: List[Column]
    aggs: List[Column]


def run_chain_reduce_plain(prog: ChainProgram, cols: Sequence,
                           sel: torch.Tensor, key_types, agg_types
                           ) -> Reduced:
    """K17's plain version: the program's registers (``_interpret``), the
    bins as K2 numbers them (``direct_group_ids_plain``; one bin when
    keyless) and each aggregate through the K1 route's functions, so the
    CPU gives exactly what the unfused route gives. Each aggregate is
    reduced where its ACC stands, so no more of its values are held than
    the program holds."""
    n = sel.shape[0]
    keys: List = []
    state: dict = {}
    out: Dict[int, Column] = {}
    by_slot = {}
    for j, (a, (slot, cnt)) in enumerate(zip(prog.aggs, prog.agg_slots)):
        if a.value is None or (a.fn == "count" and not cnt):
            continue
        by_slot.setdefault(slot if a.fn != "count" else cnt, []).append(j)

    def column(R, V, dtype, t):
        return Column(_full(from_word(R, dtype), n),
                      None if V is None else _full(V, n), t)

    def sink(ins, R, V):
        name = OPCODES[ins[0]]
        if name == "BIN":
            keys.append((_full(R[ins[2]], n),
                         None if V[ins[2]] is None else _full(V[ins[2]], n)))
        elif name == "PEERS":
            live = state["live"]
            if prog.domains:
                codes = [from_word(k, torch.bool if dt_ == torch.bool
                                   else torch.int32)
                         for (k, _), dt_ in zip(keys, prog.key_dtypes)]
                ctx, _ = aggk.group_rows_direct(
                    [Column(c, v, None) for c, (_, v) in zip(codes, keys)],
                    prog.domains, live)
            else:
                ctx, _ = aggk.group_rows([], live, 1)
            state["ctx"] = ctx
        elif name == "ACC":
            ctx = state["ctx"]
            for j in by_slot.get(ins[5], ()):
                a, t = prog.aggs[j], agg_types[j]
                arg = column(R[ins[2]], V[ins[2]], a.value.dtype, t)
                if a.fn == "count":  # reads the argument's validity only
                    out[j] = aggk.agg_count(ctx, arg)
                elif a.fn == "sum":
                    out[j] = aggk.agg_sum(ctx, arg, t)
                else:
                    out[j] = aggk.agg_min_max(ctx, arg, is_min=a.fn == "min")

    state["live"] = None
    _interpret(prog, cols, sel, sink, state)
    ctx = state["ctx"]
    aggs = []
    for j, (a, t) in enumerate(zip(prog.aggs, agg_types)):
        if j in out:
            aggs.append(out[j])
        else:  # COUNT(*), or COUNT of a value without NULLs
            aggs.append(aggk.agg_count(ctx, None))
    return Reduced(aggk.group_sel(ctx),
                   _key_columns(prog, key_types, sel.device), aggs)


def _key_columns(prog: ChainProgram, key_types, dev) -> List[Column]:
    if not prog.domains:
        return []
    return aggk.direct_key_columns(prog.domains, prog.key_dtypes,
                                   prog.key_nullable, key_types, dev)


def run_chain_reduce(prog: ChainProgram, cols: Sequence, sel: torch.Tensor,
                     key_types: Sequence, agg_types: Sequence) -> Reduced:
    """K17: ``run_chain_reduce_plain`` as one pass of the program's own
    kernel on the card (``ops/chain_codegen.py``): the program over every
    row, then its bin, then per aggregate a thread's (keyless, in
    registers) or a warp's, a block's and one global combine a block.
    ``key_types`` and ``agg_types`` are
    the Spark types of the keys and the aggregates' outputs. A CPU tensor
    takes the plain version; a CUDA tensor launches the kernel or raises.
    float64 sums come out in an order that varies between runs, as K1's
    binned sums do."""
    if sel.device.type == "cpu":
        return run_chain_reduce_plain(prog, cols, sel, key_types, agg_types)
    if not prog.reduces:
        raise ValueError("run_chain_reduce: a K16 program")
    _check_inputs("run_chain_reduce", prog, cols, sel)
    n, dev = sel.shape[0], sel.device
    if prog._ident is None or prog._ident.device != dev:
        prog._ident = torch.tensor([w for _, w in prog.slots],
                                   dtype=torch.int64, device=dev)
    acc = prog._ident.repeat(prog.nbins)
    if n:
        from .chain_codegen import launch  # it imports this module
        launch(prog, cols, sel, [], acc)
        run_chain_reduce.launches += 1
    words = acc.view(prog.nbins, len(prog.slots))
    aggs = aggk.chain_agg_columns(
        words, [(a.fn, None if a.value is None else a.value.dtype)
                for a in prog.aggs], prog.agg_slots, agg_types)
    if prog.domains:
        group_sel = words[:, 0] > 0
    else:
        group_sel = torch.ones(1, dtype=torch.bool, device=dev)
    return Reduced(group_sel, _key_columns(prog, key_types, dev), aggs)


run_chain_reduce.launches = 0


# ---------------------------------------------------------------------------
# K18
# ---------------------------------------------------------------------------

class ChainSorted(NamedTuple):
    """K18's outputs: the chain's output columns (None where the consumer
    reads none) and selection; each sort key's K3 word (int64[n]) and
    validity (bool[n] or None); their extremes (int64[keys, 2], least and
    greatest word over the live rows, a grouping's key over its live
    non-null rows; INT64_MAX, INT64_MIN where there is none)."""

    cols: List
    sel: torch.Tensor
    words: List[Tuple[torch.Tensor, Optional[torch.Tensor]]]
    ext: torch.Tensor


def _no_extremes(k: int, dev) -> torch.Tensor:
    """int64[k, 2] of (INT64_MAX, INT64_MIN), filled on the device (a copy
    from the host would make the host wait)."""
    ext = torch.empty((k, 2), dtype=torch.int64, device=dev)
    ext[:, 0] = torch.iinfo(torch.int64).max
    ext[:, 1] = torch.iinfo(torch.int64).min
    return ext


def run_chain_sort_plain(prog: ChainProgram, cols: Sequence,
                         sel: torch.Tensor) -> ChainSorted:
    """K18's plain version: ``run_chain_plain``'s outputs and selection,
    and at each OKEY the key's K3 word (``ops/sort.py``
    ``order_keys_plain`` of its register at its type), its validity and
    its extremes over the rows live after every filter
    (``sort.key_extremes``)."""
    n = sel.shape[0]
    stored: List = [None] * len(prog.outputs)
    words: List = [None] * len(prog.sort_keys)
    ext = _no_extremes(len(prog.sort_keys), sel.device)
    state: dict = {}

    def sink(ins, R, V):
        name = OPCODES[ins[0]]
        if name == "STORE":
            stored[ins[5]] = _stored(prog, ins, R, V, n)
            return
        if name != "OKEY":
            raise ValueError(f"K18 program holds {name}")
        j = ins[5]
        dtype, _, desc, canonical = prog.sort_keys[j]
        word = _full(sortk.order_keys_plain(from_word(R[ins[2]], dtype),
                                            not desc), n)
        v = None if V[ins[2]] is None else _full(V[ins[2]], n)
        words[j] = (word, v)
        if n:
            ext[j] = sortk.key_extremes([(word, v, True)], state["live"],
                                        canonical)[0]

    live = _interpret(prog, cols, sel, sink, state)
    return ChainSorted(_outputs(prog, cols, stored), live, words, ext)


def run_chain_sort(prog: ChainProgram, cols: Sequence,
                   sel: torch.Tensor) -> ChainSorted:
    """K18: ``run_chain_sort_plain`` as one pass of the program's own
    kernel on the card (``ops/chain_codegen.py``): K16's row body, then
    each sort key's K3 word (``csrc/order_keys.cuh``, as K3 computes it)
    and validity stored, and its extremes kept in registers across the
    thread's rows and combined once a block (a warp's, then the block's,
    then one 64-bit atomicMin and atomicMax a key into ``ext``, which the
    wrapper initialises). A CPU tensor takes the plain version; a CUDA
    tensor launches the kernel or raises (an NVRTC or load error
    included)."""
    if sel.device.type == "cpu":
        return run_chain_sort_plain(prog, cols, sel)
    if not prog.sorts:
        raise ValueError("run_chain_sort: a program without sort keys")
    _check_inputs("run_chain_sort", prog, cols, sel)
    n, dev = sel.shape[0], sel.device
    outs = [(torch.empty(n, dtype=dt_, device=dev),
             torch.empty(n, dtype=torch.bool, device=dev) if nullable
             else None) for dt_, nullable in prog.outputs]
    words = [(torch.empty(n, dtype=torch.int64, device=dev),
              torch.empty(n, dtype=torch.bool, device=dev) if nullable
              else None) for _, nullable, _, _ in prog.sort_keys]
    ext = _no_extremes(len(prog.sort_keys), dev)
    sel_out = torch.empty(n, dtype=torch.bool, device=dev)
    if n:
        from .chain_codegen import launch  # it imports this module
        launch(prog, cols, sel, outs, sel_out, keys=words, ext=ext)
        run_chain_sort.launches += 1
    return ChainSorted(_outputs(prog, cols, outs), sel_out, words, ext)


run_chain_sort.launches = 0
