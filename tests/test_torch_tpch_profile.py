"""The TPC-H timing and host-split script of the port, run on the CPU at
a small scale factor."""

import json

from sail_tpu_torch.benchmarks import tpch_profile


def test_parse_queries():
    assert tpch_profile.parse_queries("1-4,6,11") == [1, 2, 3, 4, 6, 11]
    assert tpch_profile.parse_queries("2,w3,u1") == [2, "w3", "u1"]


def test_profile_times_window_queries(tmp_path):
    out = tmp_path / "report.json"
    assert tpch_profile.main(["--sf", "0.01", "--queries", "w2,u2,6",
                              "--runs", "2", "--device", "cpu", "--report",
                              str(out)]) == 0
    report = json.loads(out.read_text())
    assert list(report["queries"]) == ["w2", "u2", "q6"]
    assert all(len(e["ms"]) == 2 for e in report["queries"].values())


def test_profile_reports_times_and_host_split(tmp_path):
    out = tmp_path / "report.json"
    assert tpch_profile.main(["--sf", "0.01", "--queries", "6,1", "--runs",
                              "3", "--profile", "1", "--device", "cpu",
                              "--report", str(out)]) == 0
    report = json.loads(out.read_text())
    assert report["device"] == "cpu"
    assert list(report["queries"]) == ["q6", "q1"]
    assert len(report["queries"]["q6"]["ms"]) == 3
    assert "torch" not in report["queries"]["q6"]
    q1 = report["queries"]["q1"]
    assert q1["torch"]["host_ops_ms"] > 0 and q1["torch"]["host_top"]
    assert q1["python"]["calls"] > 0 and q1["python"]["top"]


def test_profile_times_clickbench_queries(tmp_path):
    """ClickBench queries by number, each in a session of its own over a
    small generated hits table; no TPC-H table is generated for them."""
    out = tmp_path / "report.json"
    assert tpch_profile.main(["--queries", "cb1,cb8", "--cb-rows", "3000",
                              "--runs", "2", "--device", "cpu", "--report",
                              str(out)]) == 0
    report = json.loads(out.read_text())
    assert list(report["queries"]) == ["cb1", "cb8"]
    assert all(len(e["ms"]) == 2 for e in report["queries"].values())
