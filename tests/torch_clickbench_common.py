"""Shared pieces of the port's ClickBench tests: the hits table both
packages run over, sessions of both over it, and the comparison.

Comparison rule (``sail_tpu_torch.benchmarks.clickbench.check_answer``):
the same schema and rows, float64 within a relative 1e-12 (sums are taken
in another order); rows that tie on the ORDER BY keys in any order, and
where a LIMIT cuts through a tie, each row kept must be a row of that tie
in the reference's whole answer (the query without its LIMIT).
"""

import sail_tpu
from sail_tpu_torch import SparkSession
from sail_tpu_torch.benchmarks.clickbench import check_answer, generate_hits

ROWS, SEED = 200_000, 3


def sessions(table, timezone: str = "UTC"):
    """(port on the CPU, reference on its XLA path without the mesh), both
    with ``table`` as hits."""
    port = SparkSession({"spark.sail.device": "cpu",
                         "spark.sql.session.timeZone": timezone})
    ref = sail_tpu.SparkSession({
        "spark.sail.execution.backend.force": "xla",
        "spark.sail.execution.mesh": "off",
        "spark.sql.session.timeZone": timezone})
    for spark in (port, ref):
        spark.createDataFrame(table).createOrReplaceTempView("hits")
    return port, ref


def hits_sessions():
    return sessions(generate_hits(ROWS, SEED))


def check_query(port, ref, sql: str) -> None:
    """The port's answer to ``sql`` against the reference's."""
    check_answer(port.sql(sql).toArrow(), ref, sql)
