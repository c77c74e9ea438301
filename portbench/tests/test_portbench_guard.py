"""What a run may load, and what it prints."""

import json

import pytest
import torch

from portbench import harness, run


def test_forbidden_compares_top_level_names_whole():
    mods = ["spectrogramgenai_tpu_torch", "spectrogramgenai_tpu_torch.models", "jaxtyping", "flaxen", "numpy"]
    assert harness.forbidden_modules(mods) == []
    bad = ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen", "spectrogramgenai_tpu", "spectrogramgenai_tpu.ops"]
    assert harness.forbidden_modules(mods + bad) == sorted(bad)


def test_a_run_loads_nothing_forbidden():
    import portbench.entries.gen  # noqa: F401
    import portbench.entries.serve  # noqa: F401
    import portbench.entries.train  # noqa: F401

    assert harness.forbidden_modules() == [] or pytest.skip("another test of this process loaded JAX")


def test_no_chip_no_result(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", "gen_ldm27_dpmpp20_b108", "--seed", "1", "--seconds", "1"]) == 2
    assert capsys.readouterr().out == ""


def test_result_line_keys():
    line = json.loads(harness.result_line(True, 3, 0, {"setup_s": {"value": 1.0, "unit": "s"}},
                                          {"platform": "gpu", "kind": "k", "count": 1, "memory_peak_bytes": 1},
                                          {"x": {"value": 0.1, "limit": 0.2}}))
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]


def test_judge_needs_every_number_within_its_limit():
    assert harness.judge({"a": 0.1}, {"a": 0.2})[0]
    assert not harness.judge({"a": 0.3}, {"a": 0.2})[0]
    assert not harness.judge({"a": float("inf")}, {"a": 0.2})[0]
    assert harness.judge({"a": 0.1, "b": 9.0}, {"a": 0.2})[0]  # a reading that no limit names is not compared
    assert not harness.judge({"a": 0.1}, {})[0]  # nothing compared, nothing proven


def test_percentile():
    assert harness.percentile(list(range(101)), 95) == 95.0
    assert harness.percentile([1.0, 2.0], 50) == 1.5
