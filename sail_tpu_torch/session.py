"""SparkSession-compatible entry point (thin).

The PyTorch counterpart of ``sail_tpu/session.py``'s query path:
``SparkSession.builder...getOrCreate()``, ``createDataFrame(table)
.createOrReplaceTempView(name)`` and ``sql(query).toArrow()``. A query
parses, resolves and optimizes on the host, then runs on the session's
device.

The device is the config key ``spark.sail.device``: ``cuda`` (the default)
or ``cpu``. A session that asks for ``cuda`` where no card is available
raises; it never carries on on the CPU.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

import pyarrow as pa
import torch

from .catalog import CatalogManager
from .plan.compiler import DictTables
from .spec import plan as sp


def _device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "spark.sail.device is 'cuda' but no CUDA device is available; "
            "set spark.sail.device=cpu to run on the CPU")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"spark.sail.device must be cuda or cpu, got {name!r}")
    return device


class SparkSession:
    _active: Optional["SparkSession"] = None
    _lock = threading.Lock()

    class Builder:
        def __init__(self):
            self._conf: Dict[str, str] = {}

        def appName(self, name: str) -> "SparkSession.Builder":
            self._conf["spark.app.name"] = name
            return self

        def master(self, _: str) -> "SparkSession.Builder":
            return self

        def config(self, key: str, value=None) -> "SparkSession.Builder":
            self._conf[key] = str(value)
            return self

        def getOrCreate(self) -> "SparkSession":
            """The active session when it was built with these options,
            else a new session, which becomes the active one."""
            with SparkSession._lock:
                active = SparkSession._active
                if active is None or active.conf != self._conf:
                    active = SparkSession(self._conf)
                    SparkSession._active = active
                return active

    class _BuilderDescriptor:
        def __get__(self, obj, objtype=None):
            return SparkSession.Builder()

    builder = _BuilderDescriptor()

    def __init__(self, conf: Optional[Dict[str, str]] = None):
        self.conf = dict(conf or {})
        self.device = _device(self.conf.get("spark.sail.device", "cuda"))
        self.catalog_manager = CatalogManager()
        # uploaded memory-table columns, reused by every query
        # (LocalExecutor._exec_ScanExec)
        self._scan_cache: dict = {}
        # each join's last observed runtime-filter prune ratio
        # (LocalExecutor._rtf_finish)
        self._rtf_history: dict = {}
        # the lookup and rank tables made from string dictionaries, reused
        # by every query (plan/compiler.py DictTables)
        self.dict_tables = DictTables()
        # the runtime filters the last query built, with the rows each saw
        # and kept (LocalExecutor.runtime_filters)
        self.last_runtime_filters: list = []
        # the rows each join of the last query put out
        # (LocalExecutor.join_rows)
        self.last_join_rows: list = []
        # each Filter/Project chain's bound program or closures, by
        # (stage fingerprint, dictionaries, subquery values, device, zone)
        # (LocalExecutor._stage)
        self.chain_programs: dict = {}
        # each chain of the last query: its route (K16, K17, per-op, or
        # refs where it only passes columns through), its nodes, the
        # operator it feeds and, for a per-op chain, the first expression
        # without a program fragment (LocalExecutor.chain_routes)
        self.last_chain_routes: list = []
        # each sort and sorted grouping of the last query: its consumer, the
        # route of its words (K18 or K3) and its form (packed or passes)
        # (LocalExecutor.sort_routes)
        self.last_sort_routes: list = []

    def sql(self, query: str) -> "DataFrame":
        from .sql import parse_one
        plan = parse_one(query)
        if isinstance(plan, sp.CommandPlan):
            raise NotImplementedError("SQL commands are not ported yet")
        return DataFrame(plan, self)

    def createDataFrame(self, data) -> "DataFrame":
        if not isinstance(data, pa.Table):
            data = pa.Table.from_pandas(data, preserve_index=False)
        return DataFrame(sp.LocalRelation(data), self)

    def stop(self) -> None:
        self._scan_cache.clear()
        self._rtf_history.clear()
        self.dict_tables.clear()
        self.chain_programs.clear()
        with SparkSession._lock:
            if SparkSession._active is self:
                SparkSession._active = None

    def _execute_query(self, plan: sp.QueryPlan) -> pa.Table:
        from .exec.local import LocalExecutor
        from .plan.optimizer import optimize
        from .plan.resolver import Resolver
        from .utils.tz import reset_session_timezone, set_session_timezone
        token = set_session_timezone(
            self.conf.get("spark.sql.session.timeZone") or "UTC")
        try:
            node = optimize(Resolver(self.catalog_manager).resolve(plan))
            executor = LocalExecutor(self.device, self._scan_cache, self.conf,
                                     self._rtf_history, self.dict_tables,
                                     self.chain_programs)
            try:
                return executor.execute(node)
            finally:
                self.last_runtime_filters = executor.runtime_filters
                self.last_join_rows = executor.join_rows
                self.last_chain_routes = executor.chain_routes
                self.last_sort_routes = executor.sort_routes
        finally:
            reset_session_timezone(token)


class DataFrame:
    def __init__(self, plan: sp.QueryPlan, session: SparkSession):
        self._plan = plan
        self._session = session

    def createOrReplaceTempView(self, name: str) -> None:
        self._session.catalog_manager.register_temp_view(name, self._plan)

    def toArrow(self) -> pa.Table:
        return self._session._execute_query(self._plan)

    def toPandas(self):
        return self.toArrow().to_pandas()
