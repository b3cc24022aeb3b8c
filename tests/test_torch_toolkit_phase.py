"""``chip_smoke.py`` phase 27 ("toolkit") rehearsed on the host.

The phase is imported and run with its card calls patched
(``mx.gpu``/``context.gpu`` give ``cpu(0)``, ``torch.cuda.synchronize``
and ``empty_cache`` do nothing, TF32 off as ``phase_device`` sets it),
inside ``with mx.cpu():``, at shrunken
sizes: SVRG over 2 048 rows, 3 000 tokens, the oracles at a few rows,
a resnet18_v1 of 10 classes at 32x32 for the Module and TrainStep, and
16 PNGs of 32x32 for the file tools (which run as ``python -m`` children,
as on the card). ``check`` records instead of raising: the one check
that fails on the host by construction is the oracles' launch count
(the host takes the kernels' plain version), and every other passes.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mx

torch.set_num_threads(2)


def _small_resnet(seed=0, dtype=None):
    from mxnet_tpu_torch import autograd, nd
    from mxnet_tpu_torch.gluon.model_zoo import vision

    mx.random.seed(seed)
    net = vision.resnet18_v1(classes=10)
    net.initialize(mx.init.Xavier(rnd_type="gaussian", factor_type="in",
                                  magnitude=2), ctx=mx.cpu())
    with autograd.pause():
        net(nd.zeros((1, 3, 32, 32), ctx=mx.cpu()))
    net.hybridize()
    return net


def test_phase_27_rehearses_on_the_host(monkeypatch):
    import chip_smoke

    failed, lines = [], []
    monkeypatch.setattr(chip_smoke, "check",
                        lambda cond, msg: cond or failed.append(msg))
    monkeypatch.setattr(chip_smoke, "log", lambda *a: lines.append(a))
    monkeypatch.setattr(mx, "gpu", lambda i=0: mx.cpu(0))
    monkeypatch.setattr(mx.context, "gpu", lambda i=0: mx.cpu(0))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda *a: None)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(chip_smoke, "_resnet50", _small_resnet)
    monkeypatch.setitem(chip_smoke.SVRG_MSD, "rows", 2048)
    monkeypatch.setattr(chip_smoke, "TEXT", dict(
        chip_smoke.TEXT, tokens=3000, corpus_tokens=30000, probe_tokens=64))
    monkeypatch.setattr(chip_smoke, "ORACLE", {
        "consistency": (1, 2, 64, 16), "gradient": (1, 1, 4, 8),
        "eps": 1e-2, "speed": (1, 2, 32, 16), "speed_n": 2})
    monkeypatch.setattr(chip_smoke, "MONITOR", {
        "batch": 2, "batches": 3, "item": (3, 32, 32)})
    monkeypatch.setattr(chip_smoke, "FILE_TOOLS", dict(
        chip_smoke.FILE_TOOLS, images=16, classes=4, side=32, steps=1,
        batch=4, network="resnet18", outputs=10))
    with mx.cpu():
        reads = chip_smoke.phase_toolkit("host, rehearsal",
                                         {"k1": 0.0, "k2": 0.0, "k3": 0.0})
    assert failed == ["oracles launched K1-K3 (0, 0, 0)"], failed
    assert sorted(reads) == ["test_utils_oracles", "toolkit_file_tools",
                             "toolkit_monitor_viz", "toolkit_svrg",
                             "toolkit_text"]
    for launches in reads.values():
        assert launches["k1_k2_k3"] == (0, 0, 0)
    readings = {}
    for parts in lines:
        if parts and isinstance(parts[0], str) and '"reading"' in parts[0]:
            row = __import__("json").loads(parts[0])
            readings[row["reading"]] = row[row["reading"]]
    sv = readings["svrg"]
    assert sv["mse_by_epoch"][-1] < sv["mse_by_epoch"][0]
    assert sv["first_vs_full_rel_l2"] == 0.0
    assert sv["batches_per_epoch"] == 2048 // 128
    assert readings["text"]["vocab"] > 1000
    assert all(readings["text"]["checks"].values())
    mv = readings["monitor_viz"]
    assert mv["reported"] == [["softmax_output"]] * 3
    assert mv["summary_total_params"] == mv["module_params"]
    ft = readings["file_tools"]
    assert ft["shard_records"] == [4, 4, 4, 4]
    assert ft["decoded_mismatches"] == 0 and ft["idx_byte_for_byte"]
    assert np.isfinite(ft["losses"]).all()
    speed = readings["oracles"]["speed"]
    assert speed["whole_ms"] > 0 and speed["forward_ms"] > 0


def test_the_oracles_catch_a_wrong_kernel(monkeypatch):
    """Part 3's oracles fail where the op's answer on the second context
    is off by more than the kernel tolerance: a planted error of 10 atol
    on the second context's output is caught by ``check_consistency``."""
    import chip_smoke

    real = mx.nd.contrib.flash_attention
    calls = []

    def second_context_skews(q, k, v, **kw):
        calls.append(1)
        out = real(q, k, v, **kw)
        return out + 10 * 2e-5 if len(calls) == 2 else out

    monkeypatch.setattr(mx, "gpu", lambda i=0: mx.cpu(0))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(chip_smoke, "ORACLE", {
        "consistency": (1, 2, 64, 16), "gradient": (1, 1, 4, 8),
        "eps": 1e-2, "speed": (1, 2, 32, 16), "speed_n": 2})
    monkeypatch.setattr(mx.nd.contrib, "flash_attention",
                        second_context_skews)
    with mx.cpu(), pytest.raises(AssertionError, match="differ"):
        chip_smoke._toolkit_oracles(mx, "host", {"k1": 0.0})
    assert len(calls) == 2
