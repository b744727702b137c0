"""The port's measurement tools on the CPU (their numbers here are the
host's, not a device's): the bandwidth probe at a 1 MB buffer, the qmm
sweep's variant list (which split counts fit which weight), its byte count
against the JAX sweep's formula, and its ``main`` at one tiny shape,
checking the JSON layout and the stderr lines."""
import json

import pytest
import torch

from fastllama_tpu_torch.ops.kernels import qmm
from fastllama_tpu_torch.tools import hbm_peak, qmm_sweep
from fastllama_tpu_torch.tools.timing import time_ms


def test_probe_on_the_cpu():
    lines = []
    got = hbm_peak.measure([1, 2], iters=2, device="cpu", log=lines.append)
    assert [mb for mb, _ in got] == [1, 2] and all(g > 0 for _, g in got)
    assert lines[0].startswith("buffer     1 MB, 2 iters:")
    assert lines[0].endswith("GB/s sustained read")
    best = hbm_peak.peak_gbs([1], iters=2, device="cpu")
    assert best > 0


def test_probe_env_and_main(monkeypatch, capsys):
    monkeypatch.setenv("HBM_MB", "1")
    monkeypatch.setenv("HBM_ITERS", "2")
    assert hbm_peak.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "device: cpu (host clock)"
    assert out[1].startswith("buffer     1 MB, 2 iters:")
    assert out[2].startswith("best: ") and out[2].endswith(" GB/s")


def test_timer_on_the_cpu():
    calls = []
    ms = time_ms(lambda: calls.append(1), iters=5, warmup=2, device="cpu")
    assert len(calls) == 7 and ms >= 0


@pytest.mark.parametrize("quant", ["int8", "int4"])
def test_sweep_shapes_and_bytes(quant):
    """The 7B decode shapes (w2 padded to 11264 at int4); weight plus
    scale bytes as ``tools/qmm_sweep.py:109-111`` counts them."""
    shapes = qmm_sweep.default_shapes(quant)
    want_w2 = (11264, 4096) if quant == "int4" else (11008, 4096)
    assert shapes == [(4096, 4096), (4096, 12288), (4096, 22016), want_w2]
    for I, O in shapes:
        for itemsize in (4, 2):
            jax_count = (I * O // 2 if quant == "int4" else I * O) \
                + I * O // 64 * itemsize
            assert qmm_sweep.weight_bytes(I, O, quant, itemsize) == jax_count
    assert qmm_sweep.weight_bytes(4096, 4096, "int8", 4) == 17825792


def test_sweep_variants():
    """Auto and every split count up to 16 that leaves no split empty,
    each in both modes; a count left out is one that does not fit."""
    for quant, I in (("int8", 4096), ("int4", 4096), ("int8", 11008),
                     ("int4", 11264)):
        w = qmm_sweep.make_weights(I, 128, quant, torch.float32, 1,
                                   "cpu")[0]
        assert w.packed == (quant == "int4")
        vs = qmm_sweep.variants(w, 1)
        labels = [v[0] for v in vs]
        assert labels[0] == "auto" and "groupdot_auto" in labels
        counts = {s for _, gd, s in vs if not gd}
        assert counts == {s for _, gd, s in vs if gd}
        for s in range(1, 17):
            if s in counts:
                qmm.split_plan(1, I, 128, w, torch.bfloat16, s)
            else:
                with pytest.raises(ValueError):
                    qmm.split_plan(1, I, 128, w, torch.bfloat16, s)
        assert {1, 2, 16} <= counts
        assert [v[0] for v in qmm_sweep.variants(w, 1, explicit=False)] \
            == ["auto", "groupdot_auto"]
    # 64 stages of 64 rows: 14 and 15 splits would leave one empty
    w = qmm_sweep.make_weights(4096, 128, "int8", torch.float32, 1, "cpu")[0]
    counts = {s for _, _, s in qmm_sweep.variants(w, 1)}
    assert 14 not in counts and 15 not in counts and 13 in counts


@pytest.mark.parametrize("quant", ["int8", "int4"])
def test_sweep_main_on_the_cpu(monkeypatch, capsys, quant):
    monkeypatch.setenv("SWEEP_SHAPES", "256x128")
    monkeypatch.setenv("SWEEP_ITERS", "1")
    monkeypatch.setenv("SWEEP_QUANT", quant)
    monkeypatch.setenv("SWEEP_PEAK_GBS", "10")
    before = (qmm.qmatmul_pallas.launches,
              qmm.qmatmul_pallas.launches_groupdot)
    assert qmm_sweep.main(["--device", "cpu"]) == 0
    cap = capsys.readouterr()
    rows = json.loads(cap.out.strip().splitlines()[-1])
    assert rows and all(set(r) == {"shape", "variant", "gbs", "eff"}
                        for r in rows)
    assert {r["shape"] for r in rows} == {"256x128"}
    assert [r["variant"] for r in rows] == [
        "auto", "splits1", "splits2", "splits4", "groupdot_auto",
        "groupdot_splits1", "groupdot_splits2", "groupdot_splits4"]
    for r in rows:     # gbs rounded to 0.1 and eff to 0.001, as in JAX
        assert r["gbs"] >= 0 and r["eff"] == pytest.approx(r["gbs"] / 10,
                                                          abs=6e-3)
    err = cap.err.splitlines()
    assert err[0] == "# device: cpu (host clock)"
    assert err[1] == "# peak 10.0 GB/s"
    assert err[2].startswith("# 256x128 T=1 auto: ")
    assert err[2].endswith("% of 10)")
    # the CPU runs the plain versions: nothing is counted
    assert (qmm.qmatmul_pallas.launches,
            qmm.qmatmul_pallas.launches_groupdot) == before


def test_sweep_probes_when_no_peak_is_given(monkeypatch, capsys):
    monkeypatch.setenv("SWEEP_SHAPES", "128x128")
    monkeypatch.setenv("SWEEP_ITERS", "1")
    monkeypatch.delenv("SWEEP_PEAK_GBS", raising=False)
    monkeypatch.setenv("HBM_MB", "1")
    monkeypatch.setenv("HBM_ITERS", "1")
    assert qmm_sweep.main(["--device", "cpu"]) == 0
    err = capsys.readouterr().err.splitlines()
    assert err[1].startswith("# buffer     1 MB, 1 iters:")
    assert err[2].startswith("# peak ")


def test_tools_need_a_card_or_cpu(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None is valid here")
    monkeypatch.setenv("SWEEP_PEAK_GBS", "10")
    for call in (lambda: hbm_peak.read_gbs(1, 1),
                 lambda: hbm_peak.main([]),
                 lambda: qmm_sweep.main([]),
                 lambda: qmm_sweep.sweep([(128, 128)], peak=1.0)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
