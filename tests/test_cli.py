"""CLI smoke tests on the CPU test platform (the reference's dispatcher
semantics, main.cu:66-226, exercised end to end through argparse)."""

import numpy as np
import pytest

from qtesla_ntt import cli


def test_info(capsys):
    assert cli.main(["info"]) == 0
    out = capsys.readouterr().out
    assert "qtesla-iii-speed" in out and "backend:" in out


def test_correctness_ramp_fixture(capsys):
    assert cli.main(["correctness", "--param-set", "smallprime",
                     "--algo", "merged,gs_ct"]) == 0
    out = capsys.readouterr().out
    # 2 algos x (oracle check + all-ones closed form)
    assert out.count("Identical.") == 4


def test_correctness_random(capsys):
    assert cli.main(["correctness", "--param-set", "smallprime",
                     "--algo", "stockham", "--random", "-r", "7"]) == 0
    assert "Identical." in capsys.readouterr().out


@pytest.mark.slow
def test_correctness_all_skips_pallas_on_cpu(capsys):
    assert cli.main(["correctness", "--param-set", "smallprime",
                     "--algo", "all"]) == 0
    out = capsys.readouterr().out
    assert "merged" in out and "nussbaumer" in out
    assert "fused" not in out           # 'all' is the jnp family + Nussbaumer


def test_speed_json(capsys):
    assert cli.main(["speed", "--param-set", "smallprime", "--algo",
                     "merged", "--batch", "64", "--iters", "3",
                     "--json"]) == 0
    out = capsys.readouterr().out
    assert "polymuls_per_s" in out


def test_speed_fixed(capsys):
    assert cli.main(["speed", "--param-set", "smallprime", "--algo",
                     "merged", "--batch", "64", "--iters", "3",
                     "--fixed"]) == 0
    assert "polymul_fixed" in capsys.readouterr().out


def test_speed_streamed_json(capsys):
    """Transfer-inclusive bracket (reference NTT.cu:2036-2079 capability)."""
    import json
    assert cli.main(["speed", "--param-set", "smallprime", "--algo",
                     "merged", "--batch", "64", "--iters", "2",
                     "--streamed", "--json"]) == 0
    out = capsys.readouterr().out
    assert "polymul_streamed" in out
    row = json.loads(out.strip().splitlines()[-1])[0]
    assert row["algo"] == "streamed/merged"
    assert row["min_ms_per_iter"] > 0


def test_speed_fixed_streamed_json(capsys):
    """--fixed --streamed: the constant-operand spectrum stays resident
    while each iteration stages a fresh operand batch (the serving-shape
    transfer-inclusive bracket; code-review round 3 found the combination
    silently ignored --streamed)."""
    import json
    assert cli.main(["speed", "--param-set", "smallprime", "--algo",
                     "merged", "--batch", "64", "--iters", "2",
                     "--fixed", "--streamed", "--json"]) == 0
    out = capsys.readouterr().out
    assert "polymul_fixed_streamed" in out
    row = json.loads(out.strip().splitlines()[-1])[0]
    assert row["algo"] == "fixed_streamed/merged"
    assert row["min_ms_per_iter"] > 0


@pytest.mark.slow
def test_scaling_dp(capsys):
    import json
    assert cli.main(["scaling", "--param-set", "smallprime",
                     "--batch-per-device", "32", "--iters", "2",
                     "--json"]) == 0
    out = capsys.readouterr().out
    assert "scaling-eff" in out
    rows = json.loads(out.strip().splitlines()[-1])
    assert rows[0]["mode"] == "dp" and rows[0]["scaling_eff"] == 1.0
    # virtual CPU devices must be labelled as such in the artifact
    assert rows[0]["virtual_devices"] is True
    assert "caveat" in rows[0] and "NOT device scaling" in rows[0]["caveat"]


def test_scaling_fixed_global_batch(capsys):
    """--global-batch: batch fixed and sharded; rows report overhead_eff
    (relative aggregate throughput vs 1 device) instead of scaling_eff."""
    import json
    assert cli.main(["scaling", "--param-set", "smallprime",
                     "--global-batch", "64", "--iters", "2",
                     "--json"]) == 0
    out = capsys.readouterr().out
    rows = json.loads(out.strip().splitlines()[-1])
    assert rows[0]["batch"] == 64 and rows[-1]["batch"] == 64
    assert rows[0]["overhead_eff"] == 1.0
    assert all("scaling_eff" not in r for r in rows)


def test_microbench(capsys):
    assert cli.main(["microbench", "--param-set", "smallprime",
                     "--size", "65536", "--iters", "3"]) == 0
    assert "barrett" in capsys.readouterr().out


def test_unknown_algo_rejected():
    with pytest.raises(SystemExit):
        cli.main(["speed", "--algo", "nope"])


@pytest.mark.slow
def test_register_flag_runs_registered_set(capsys):
    """--register NAME:n:q makes a runtime set usable by every subcommand
    (the CLI face of params.register_param_set; reference compile-time
    ladder main.cu:18-65)."""
    assert cli.main(["--register", "cli-reg-64:64:65537", "speed",
                     "--param-set", "cli-reg-64", "--algo", "merged",
                     "--batch", "8", "--iters", "2"]) == 0
    assert "cli-reg-64" in capsys.readouterr().out


def test_register_flag_rejects_malformed():
    with pytest.raises(SystemExit, match="--register"):
        cli.main(["--register", "oops:notanint:3", "info"])
