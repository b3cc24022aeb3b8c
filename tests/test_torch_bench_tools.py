"""The port's benches (``python -m mxnet_tpu_torch.tools.{dispatch_bench,
quantized_bench,decode_bench,bandwidth.measure}``) at small sizes on the
host, each asked for the CPU:

- every JSON line holds the keys of the repo's tool (read from its
  source), its metric names and units, plus the port's additions;
- with the device left to its default the benches run on ``gpu(0)``,
  which raises here: no bench falls back to the host;
- the int8 conv and FC at the tool's weights equal the JAX package's
  ``_quantized_conv``/``_quantized_fc`` on the same numpy inputs;
- JPEG records and a resize without cv2 raise, naming cv2 (cv2 is
  hidden from the import system for that test, so it runs here too);
- ``measure`` on the host pulls back what it pushed, and refuses two
  devices where one exists; ``measure_dist`` runs one size, one round
  and one server on the host within its own time limit;
- each tool starts through ``python -m`` (``--help``).
"""
import ast
import json
import os
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import env
from mxnet_tpu_torch.tools import decode_bench, dispatch_bench, \
    quantized_bench
from mxnet_tpu_torch.tools.bandwidth import measure

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_keys(relpath):
    """The string keys of every dict literal given to ``json.dumps`` in
    a script of the repo's tools/."""
    with open(os.path.join(ROOT, "tools", relpath)) as f:
        tree = ast.parse(f.read())
    keys = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and getattr(node.func, "attr", "") \
                == "dumps" and node.args and isinstance(node.args[0],
                                                         ast.Dict):
            keys |= {k.value for k in node.args[0].keys
                     if isinstance(k, ast.Constant)}
    assert keys, relpath
    return keys


def _lines(capsys):
    return [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith("{")]


def _card_or_raises(fn):
    """Run `fn` where the default context is the card: on a machine
    without one it must raise, naming CUDA."""
    if torch.cuda.is_available():
        return fn()
    with pytest.raises(RuntimeError, match="CUDA"):
        fn()


# -- dispatch_bench ------------------------------------------------------------

def test_dispatch_bench_prints_the_jax_tools_keys(monkeypatch, capsys):
    monkeypatch.setenv("MXNET_DEVICE", "cpu")
    assert dispatch_bench.main(["--iters", "3", "--size", "16"]) == 0
    rows = _lines(capsys)
    assert [r["mode"] for r in rows] == ["eager", "cached_op"]
    for r in rows:
        assert set(r) == _jax_keys("dispatch_bench.py")
        assert r["metric"] == "dispatch_op_per_s" and r["unit"] == "op/s"
        assert r["value"] > 0 and r["chain_ops"] == 10 and r["iters"] == 3


def test_dispatch_bench_eager_and_cached_sums_are_equal():
    with mx.cpu():
        rows = dispatch_bench.run(iters=2, size=16)
    (_, _, eager), (_, _, cached) = rows
    assert eager.context == mx.cpu() and cached.context == mx.cpu()
    assert eager.asnumpy().tobytes() == cached.asnumpy().tobytes()
    x = np.random.RandomState(0).rand(16, 16).astype(np.float32)
    y = np.maximum(x, 0) + np.float32(1.0)
    y = np.tanh(y * np.float32(0.5)) - np.float32(0.1)
    y = 1 / (1 + np.exp(-y))
    want = (np.exp(-(y * y)) / 2).sum()
    np.testing.assert_allclose(eager.asnumpy(), want, rtol=1e-5)


def test_dispatch_bench_reads_mxnet_device(monkeypatch):
    monkeypatch.delenv("MXNET_DEVICE", raising=False)
    _card_or_raises(lambda: dispatch_bench.main(["--iters", "1",
                                                 "--size", "4"]))
    monkeypatch.setenv("MXNET_DEVICE", "tpu")
    with pytest.raises(ValueError, match="auto/cpu/gpu"):
        dispatch_bench.main(["--iters", "1", "--size", "4"])
    knob = [k for k in env.CATALOGUE if k.name == "MXNET_DEVICE"]
    assert knob and "auto | cpu | gpu" in knob[0].doc


# -- quantized_bench -----------------------------------------------------------

def test_quantized_bench_prints_the_jax_tools_keys(capsys):
    assert quantized_bench.main(["--device", "cpu", "--batch", "2",
                                 "--channels", "8", "--iters", "2"]) == 0
    rows = _lines(capsys)
    assert [r["metric"] for r in rows] == ["conv3x3_int8_speedup",
                                           "fc2048x1000_int8_speedup"]
    for r in rows:
        assert _jax_keys("quantized_bench.py") <= set(r)
        assert r["unit"] == "x" and r["value"] > 0 and r["fp32_ms"] > 0
        assert r["int8_ms"] > 0 and r["tf32"] is False
        assert r["device"] == "cpu(0)"


def test_quantized_bench_leaves_tf32_as_it_found_it():
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    with quantized_bench.tf32_off():
        assert not torch.backends.cudnn.allow_tf32
        assert not torch.backends.cuda.matmul.allow_tf32
    assert (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32) == saved


def test_quantized_bench_defaults_to_the_card():
    _card_or_raises(lambda: quantized_bench.main(
        ["--batch", "2", "--channels", "8", "--iters", "1"]))


# The two contractions are exact in int32 in both packages; the outputs
# differ at most by the float32 rescale: the int32 sum converted to
# float32 (one rounding) times the float32 reciprocal of the scales (one
# rounding), which the JAX package may compute as a division. Two float32
# roundings: 2 * 2^-24 relative.
INT8_RTOL = 2.0 ** -23


def test_int8_layers_equal_the_jax_packages():
    import jax.numpy as jnp
    from mxnet_tpu.ops import quantization_ops as jq

    data = quantized_bench.layers(batch=2, channels=8, seed=3)
    conv_f32, conv_i8 = quantized_bench.conv_fns(8)
    _, fc_i8 = quantized_bench.fc_fns()
    x, wf, wq = data["conv"]
    assert wq.dtype == np.int8 and np.abs(wq).max() == 127
    got = conv_i8(torch.from_numpy(x), torch.from_numpy(wq)).numpy()
    want = np.asarray(jq._quantized_conv(
        jnp.asarray(x), jnp.asarray(wq), kernel=(3, 3), pad=(1, 1),
        num_filter=8, no_bias=True, min_data=-3.0, max_data=3.0,
        w_scale=127.0 / 0.25))
    assert got.shape == want.shape == (2, 8, 14, 14)
    np.testing.assert_allclose(got, want, rtol=INT8_RTOL, atol=0)
    f32 = conv_f32(torch.from_numpy(x), torch.from_numpy(wf)).numpy()
    assert f32.shape == got.shape and np.isfinite(f32).all()
    xf, _, wq2 = data["fc"]
    got = fc_i8(torch.from_numpy(xf), torch.from_numpy(wq2)).numpy()
    want = np.asarray(jq._quantized_fc(
        jnp.asarray(xf), jnp.asarray(wq2), num_hidden=1000, no_bias=True,
        min_data=-3.0, max_data=3.0, w_scale=127.0 / 0.25))
    assert got.shape == want.shape == (2, 1000)
    np.testing.assert_allclose(got, want, rtol=INT8_RTOL, atol=0)


# -- decode_bench --------------------------------------------------------------

def test_decode_bench_prints_the_jax_tools_keys(capsys):
    assert decode_bench.main(["--device", "cpu", "--img-fmt", ".png",
                              "--resize", "0", "--n", "8", "--size", "32",
                              "--batch-size", "4", "--batches", "2",
                              "--threads", "0,2"]) == 0
    rows = _lines(capsys)
    assert [r["preprocess_threads"] for r in rows] == [0, 2]
    for r in rows:
        assert set(r) == _jax_keys("decode_bench.py") | {
            "img_fmt", "resize", "device"}
        assert r["metric"] == "decode_img_per_s" and r["unit"] == "img/s"
        assert r["value"] > 0 and np.isfinite(r["value"])
        assert (r["img_fmt"], r["resize"], r["device"]) == (".png", 0,
                                                            "cpu(0)")


def test_decode_bench_batches_land_on_the_context(tmp_path):
    rec, idx = decode_bench.make_dataset(str(tmp_path), 8, 32, ".png")
    seen = []
    rate = decode_bench.bench(rec, idx, 32, 4, 3, 2, resize=0,
                              ctx=mx.cpu(), seen=seen)
    assert rate > 0 and seen == [mx.cpu()] * 3


def test_jpeg_and_resize_without_cv2_name_cv2(monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, "cv2", None)
    base = ["--device", "cpu", "--n", "4", "--size", "32",
            "--batch-size", "2", "--batches", "1", "--threads", "0"]
    with pytest.raises(ImportError, match="cv2"):
        decode_bench.main(base)                     # the JPEG default
    with pytest.raises(ImportError, match="cv2"):
        decode_bench.main(base + ["--img-fmt", ".png", "--resize", "40"])
    rec, idx = decode_bench.make_dataset(str(tmp_path), 4, 32, ".png")
    assert decode_bench.bench(rec, idx, 32, 2, 1, 0, resize=0,
                              ctx=mx.cpu()) > 0


def test_decode_bench_defaults_to_the_card():
    _card_or_raises(lambda: decode_bench.main(
        ["--img-fmt", ".png", "--resize", "0", "--n", "4", "--size", "32",
         "--batch-size", "2", "--batches", "1", "--threads", "0"]))


# -- bandwidth/measure ---------------------------------------------------------

def test_measure_device_kvstore_on_the_host(capsys):
    proof = []
    with mx.cpu():
        rows = measure.measure("device", 1, sizes=(1024, 4096), repeat=2,
                               warmup=1, proof=proof)
    assert [r[0] for r in rows] == [1024, 4096]
    assert all(dt > 0 and gbs > 0 for _, dt, gbs in rows)
    assert proof == [1.0] * 4
    assert measure.main(["--device", "cpu", "--sizes", "1024",
                         "--repeat", "1"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "%12s %12s %10s" % ("elements", "sec/round", "GB/s")
    assert out[1].split()[0] == "1024" and len(out) == 2


def test_measure_refuses_more_devices_than_exist():
    with mx.cpu(), pytest.raises(SystemExit, match="only 1 cpu device"):
        measure.measure("device", 2, sizes=(16,))
    with pytest.raises(SystemExit, match="only 1 cpu device"):
        measure.main(["--device", "cpu", "--num-devices", "2",
                      "--sizes", "16"])


def test_measure_dist_one_round_on_the_host():
    def expired(*_):
        raise TimeoutError("measure_dist outlived its 120 s")

    old = signal.signal(signal.SIGALRM, expired)
    signal.alarm(120)
    try:
        proof = []
        with mx.cpu():
            rows = measure.measure_dist(sizes=(4096,), repeat=1, warmup=1,
                                        num_servers=1, proof=proof)
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)
    (size, dt, gbs), = rows
    assert size == 4096 and dt > 0 and gbs > 0
    assert proof == [1.0]
    assert "DMLC_ROLE" not in os.environ or \
        os.environ["DMLC_ROLE"] != "worker"


@pytest.mark.parametrize("name", [
    "diagnose", "goodput_report", "flame_diff", "profile_tool",
    "dispatch_bench", "quantized_bench", "decode_bench",
    "bandwidth.measure"])
def test_each_tool_starts_through_python_m(name):
    proc = subprocess.run(
        [sys.executable, "-m", "mxnet_tpu_torch.tools." + name, "--help"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("usage:")
