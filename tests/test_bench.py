"""bench.py contract tests (CPU): the served pick and JSON emission."""

import importlib.util
import json
from pathlib import Path

import numpy as np

_spec = importlib.util.spec_from_file_location(
    "bench", Path(__file__).resolve().parent.parent / "bench.py")
bench = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(bench)


def test_pick_algo_cpu_falls_back_to_merged(monkeypatch, capsys):
    """bench.py times models.served_algo's pick, which off the GPU is the
    jnp `merged` pipeline; it only gets that far on a GPU."""
    _fake_gpu(monkeypatch)
    assert bench.main() == 0
    doc = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert doc["algo"] == "merged"


class _FakeDevice:
    platform = "gpu"
    device_kind = "fake"


def _fake_gpu(monkeypatch, results=None):
    class FakeResult:
        throughput_best = 1234.5

        def line(self):
            return "fake"

    def fake_benchmark(name, algo, batch, iters, inner=1):
        (results if results is not None else []).append((name, algo, batch))
        return FakeResult()

    monkeypatch.setattr("qtesla_ntt.utils.device.require_gpu",
                        lambda what: _FakeDevice())
    monkeypatch.setattr("qtesla_ntt.utils.timing.benchmark_polymul",
                        fake_benchmark)
    monkeypatch.setattr(bench, "BATCH", 4)


def test_main_emits_one_json_line_last(monkeypatch, capsys):
    """The driver contract: exactly one JSON line on stdout, the last one,
    naming the device, after the sampled oracle check passed."""
    calls = []
    _fake_gpu(monkeypatch, calls)
    assert bench.main() == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1
    doc = json.loads(out[0])
    assert doc["unit"] == "polymuls/s" and doc["value"] == 1234.5
    assert doc["device"]["platform"] == "gpu" and doc["bit_exact"] is True
    assert calls == [("qtesla-iii-speed", "merged", 4)]


def test_main_refuses_wrong_output(monkeypatch, capsys):
    """A sampled row that differs from the oracle: no JSON, exit 1."""
    _fake_gpu(monkeypatch)
    import qtesla_ntt.models as models
    good = models.polymul_fn

    def corrupt(name, algo=None):
        def fn(x, y):
            z = np.array(good(name, algo)(x, y))
            z[-1, 0] ^= 1
            return z
        return fn

    monkeypatch.setattr(models, "polymul_fn", corrupt)
    assert bench.main() == 1
    assert capsys.readouterr().out == ""
