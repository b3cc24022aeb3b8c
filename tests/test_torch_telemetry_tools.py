"""The port's telemetry tools (``python -m mxnet_tpu_torch.tools.
{diagnose,goodput_report,flame_diff,profile_tool}``) against the repo's
``tools/`` over the JAX package, run over the same files:

- diagnostic bundles committed by the JAX package's ``FlightRecorder``
  and by the port's, alone, in the ``rank<R>/`` layout and mixed under
  ``--merge``: the same text, except the ``env:`` line, which names
  ``torch``, ``cuda`` and the card for a port bundle and ``jax`` for a
  JAX one; a card's memory entry without a buffer count (``buffers``
  None) prints without one;
- goodput ledgers of both packages' ``GoodputLedger`` (booked seconds
  drawn from a seed with numpy, a fake clock): ``summary``, ``merge``
  and ``compare``, the same text;
- collapsed captures of both packages' ``dump_collapsed`` (spans of
  seeded lengths) and a hand-written capture with ``trace:<id>``
  leaves: ``flame_diff``, ``profile_tool top``/``diff``/``merge`` (to
  stdout and through ``-o``, the same bytes), the same text.
"""
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from mxnet_tpu_torch import telemetry as pt
from mxnet_tpu_torch.telemetry import flamegraph as pflame
from mxnet_tpu_torch.telemetry import goodput as pgood
from mxnet_tpu_torch.telemetry import metrics as pmetrics
from mxnet_tpu_torch.telemetry import trace as ptrace
from mxnet_tpu_torch.tools import (diagnose, flame_diff, goodput_report,
                                   profile_tool)

from mxnet_tpu import telemetry as jt
from mxnet_tpu.telemetry import flamegraph as jflame
from mxnet_tpu.telemetry import goodput as jgood
from mxnet_tpu.telemetry import metrics as jmetrics
from mxnet_tpu.telemetry import trace as jtrace

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_tool(name):
    """Import a script of the repo's tools/ as a module."""
    spec = importlib.util.spec_from_file_location(
        "jax_tool_" + name, os.path.join(ROOT, "tools", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _both(name, port_tool, argv, capsys):
    """(port text, JAX text) of one command line run by each tool."""
    assert port_tool.main(list(argv)) == 0
    port = capsys.readouterr().out
    assert _jax_tool(name).main(list(argv)) == 0
    return port, capsys.readouterr().out


def _without_env(text):
    return [line for line in text.splitlines()
            if not line.startswith("env:")]


# -- diagnose ------------------------------------------------------------------

def _bundles(pkg, directory, rank, ids):
    """Two bundles of `pkg`'s FlightRecorder at `rank`: a NaN loss with
    batch `ids` in flight, then a manual capture."""
    os.makedirs(directory, exist_ok=True)
    mon = pkg.StepMonitor(warn_interval_s=1e9)
    rec = pkg.FlightRecorder(str(directory), rank=rank, rate_limit_s=0.0)
    rec.attach(mon)
    guard = pkg.NumericGuard(monitor=mon, every=1)
    guard.observe_batch(step=5, batch_ids=ids)
    guard.check_loss(float("nan"))
    rec.capture("manual", "seeded capture %d" % rank)
    return rec.bundles


def test_diagnose_port_bundles_read_alike_but_the_env_line(tmp_path, capsys):
    paths = _bundles(pt, tmp_path / "diag", 0, [3, 4])
    assert len(paths) == 2
    port, ref = _both("diagnose", diagnose, [str(tmp_path / "diag")], capsys)
    assert _without_env(port) == _without_env(ref)
    assert "2 bundle(s) summarized" in port
    env = [line for line in port.splitlines() if line.startswith("env:")]
    assert len(env) == 2
    assert all("torch %s" % torch.__version__ in line for line in env)
    assert all("jax" not in line for line in env)
    assert all(", jax ?," in line for line in ref.splitlines()
               if line.startswith("env:"))


def test_diagnose_jax_bundles_read_as_the_jax_tool(tmp_path, capsys):
    paths = _bundles(jt, tmp_path / "diag", 0, [1, 2])
    assert len(paths) == 2
    for argv in ([str(tmp_path / "diag")],
                 ["--verbose", paths[0]],
                 ["--merge", "--window", "30", str(tmp_path / "diag")]):
        port, ref = _both("diagnose", diagnose, argv, capsys)
        assert port == ref, argv
    assert "env: python" in port and ", jax " in port


def test_diagnose_merges_rank_directories_of_both_packages(tmp_path, capsys):
    """The DiagCollector layout (rank<R>/), rank 0 from the JAX package
    and rank 1 from the port: one incident of both ranks."""
    _bundles(jt, tmp_path / "pod" / "rank0", 0, [1, 2])
    _bundles(pt, tmp_path / "pod" / "rank1", 1, [7, 8])
    port, ref = _both("diagnose", diagnose,
                      ["--merge", str(tmp_path / "pod")], capsys)
    assert _without_env(port) == _without_env(ref)
    assert "INCIDENT kind=nonfinite" in port
    assert "rank(s) [0, 1]" in port
    # Each rank's section names its own in-flight ids (in its message).
    assert "[1, 2]" in port and "[7, 8]" in port
    assert "4 bundle(s) summarized" in port
    env = [line for line in port.splitlines() if line.startswith("env:")]
    assert sum(", jax " in line for line in env) == 2
    assert sum(", torch " in line for line in env) == 2


def test_diagnose_names_the_card_and_omits_a_missing_buffer_count(
        tmp_path, capsys):
    (path,) = [p for p in _bundles(pt, tmp_path / "b", 0, [5])
               if "000002" in p]
    with open(path) as f:
        bundle = json.load(f)
    bundle["env"].update(cuda="12.8", device="NVIDIA H100 80GB HBM3")
    bundle["device_memory"] = {"cuda:0": {
        "buffers": None, "bytes": 123456789, "peak_bytes": 223456789,
        "limit_bytes": 85000000000}}
    card = str(tmp_path / "card" / os.path.basename(path))
    os.makedirs(os.path.dirname(card))
    with open(card, "w") as f:
        json.dump(bundle, f)
    port, ref = _both("diagnose", diagnose, [card], capsys)
    assert "device cuda:0: 117.7MB live, peak 213.1MB" in port
    assert "device cuda:0: 117.7MB live (None buffers), peak 213.1MB" in ref
    env = [line for line in port.splitlines() if line.startswith("env:")]
    assert env == ["env: python %s, torch %s, cuda 12.8, device NVIDIA "
                   "H100 80GB HBM3, %s" % (bundle["env"]["python"],
                                          torch.__version__,
                                          bundle["env"]["platform"])]
    assert [line for line in port.splitlines() if "cuda:0" not in line
            and not line.startswith("env:")] == \
        [line for line in ref.splitlines() if "cuda:0" not in line
         and not line.startswith("env:")]


def test_diagnose_without_bundles_returns_one(tmp_path, capsys):
    (tmp_path / "empty").mkdir()
    (tmp_path / "empty" / "diag.rank0.000001.json").write_text("not json")
    assert diagnose.main([str(tmp_path / "empty")]) == 1
    assert "no readable diagnostic bundles" in capsys.readouterr().out


# -- goodput_report ------------------------------------------------------------

def _ledger(good, metrics, directory, rank, seed):
    """One committed ledger of `good`'s GoodputLedger: seeded steps and
    badput on a fake clock. Returns its path."""
    rng = np.random.RandomState(seed)
    os.makedirs(str(directory), exist_ok=True)
    clock = [100.0]
    ledger = good.GoodputLedger(str(directory), rank=rank, interval_s=0.0,
                                registry=metrics.Registry(),
                                clock=lambda: clock[0])
    for step in range(1, 7):
        secs = float(rng.uniform(0.1, 0.5))
        stall = float(rng.uniform(0.0, 0.08))
        save = float(rng.uniform(0.0, 0.05))
        clock[0] += secs + stall + save + float(rng.uniform(0.0, 0.02))
        ledger.observe_step(step, secs)
        ledger.book("input_stall", stall)
        ledger.book("checkpoint", save)
        ledger.tick(step)
    ledger.close()
    path = os.path.join(str(directory), good.ledger_name(rank))
    assert os.path.exists(path)
    return path


@pytest.fixture
def ledgers(tmp_path):
    return {"jax": _ledger(jgood, jmetrics, tmp_path / "jax", 0, 0),
            "port": _ledger(pgood, pmetrics, tmp_path / "port", 1, 1)}


@pytest.mark.parametrize("argv", [
    ("summary", "jax"), ("summary", "port"), ("merge", "jax", "port"),
    ("compare", "jax", "port"), ("compare", "port", "jax")])
def test_goodput_report_prints_the_jax_tools_text(ledgers, argv, capsys):
    line = [argv[0]] + [ledgers[k] for k in argv[1:]]
    port, ref = _both("goodput_report", goodput_report, line, capsys)
    assert port == ref
    if argv[0] == "summary":
        snap = pgood.load_ledger(ledgers[argv[1]])
        assert "wall-clock       %12.3f s" % snap["wall_s"] in port
        assert "goodput ratio    %11.1f %%" % (
            snap["goodput_ratio"] * 100.0) in port
        cats = [row.split()[0] for row in port.splitlines()[5:]
                if row.startswith("  ") and "%" in row]
        assert cats == [c for c in pgood.CATEGORIES if c in cats]


def test_goodput_report_compare_of_a_ledger_with_itself_is_zero(
        ledgers, capsys):
    port, ref = _both("goodput_report", goodput_report,
                      ["compare", ledgers["port"], ledgers["port"]], capsys)
    assert port == ref
    deltas = [row.split()[-2] for row in port.splitlines()
              if row.endswith(" pp") and not row.startswith("  goodput")]
    assert deltas and all(float(d) == 0.0 for d in deltas)


# -- flame_diff, profile_tool ---------------------------------------------------

TRACE_CAPTURE = (
    "MainThread;step;conv;trace:abc123 1500\n"
    "MainThread;step;conv 2500\n"
    "MainThread;step;relu;trace:abc123 300\n"
    "MainThread;step;relu;trace:def456 700\n"
    "MainThread;step;relu;trace:0f0f0f 100\n"
    "worker;decode 4000\n"
    "worker;decode;trace:def456 250\n"
    "not a valid line\n")


def _capture(trace, flame, path, seed, names):
    """A collapsed capture of `trace`'s rings: nested spans of seeded
    lengths (retroactive ``complete`` events), folded by `flame`."""
    rng = np.random.RandomState(seed)
    trace.clear()
    t = 1000.0
    for _ in range(4):
        outer = float(rng.uniform(0.010, 0.020))
        trace.complete("step", t, t + outer)
        inner = t + 0.0005
        for name in names:
            d = float(rng.uniform(0.0005, 0.003))
            trace.complete(name, inner, inner + d)
            inner += d + 0.0001
        t += outer + 0.001
    flame.dump_collapsed(str(path))
    trace.clear()
    return str(path)


@pytest.fixture
def captures(tmp_path):
    hand = tmp_path / "hand.collapsed"
    hand.write_text(TRACE_CAPTURE)
    return {"jax": _capture(jtrace, jflame, tmp_path / "jax.collapsed", 0,
                            ("conv", "bn", "relu")),
            "port": _capture(ptrace, pflame, tmp_path / "port.collapsed",
                             1, ("conv", "relu", "pool", "fc")),
            "hand": str(hand)}


@pytest.mark.parametrize("argv", [
    ("jax", "port"), ("port", "jax"), ("port", "hand"),
    ("jax", "port", "-k", "2"), ("hand", "port", "--min-share", "0.05")])
def test_flame_diff_prints_the_jax_tools_text(captures, argv, capsys):
    line = [captures.get(a, a) for a in argv]
    port, ref = _both("flame_diff", flame_diff, line, capsys)
    assert port == ref
    assert port.startswith("Self-time share diff")


@pytest.mark.parametrize("argv", [
    ("top", "jax"), ("top", "port"), ("top", "hand"), ("top", "hand", "-k",
                                                       "2"),
    ("diff", "jax", "port"), ("diff", "hand", "jax", "-k", "3"),
    ("merge", "jax", "port", "hand")])
def test_profile_tool_prints_the_jax_tools_text(captures, argv, capsys):
    line = [captures.get(a, a) for a in argv]
    port, ref = _both("profile_tool", profile_tool, line, capsys)
    assert port == ref
    if argv == ("top", "hand"):
        assert "exemplars: trace:def456, trace:abc123, trace:0f0f0f" \
            in port
        assert "exemplars: trace:abc123\n" in port
        shares = [float(row.split()[-1].rstrip("%"))
                  for row in port.splitlines()[2:]
                  if row.endswith("%")]
        assert sum(shares) <= 100.0 + 0.05 * len(shares)


def test_profile_tool_merge_writes_the_same_bytes(captures, tmp_path,
                                                  capsys):
    out = str(tmp_path / "merged.collapsed")
    argv = ["merge", "-o", out, captures["jax"], captures["port"],
            captures["hand"]]
    assert _jax_tool("profile_tool").main(list(argv)) == 0
    ref = capsys.readouterr().out
    with open(out, "rb") as f:
        ref_bytes = f.read()
    os.remove(out)
    assert profile_tool.main(list(argv)) == 0
    assert capsys.readouterr().out == ref
    with open(out, "rb") as f:
        merged = f.read()
    assert merged == ref_bytes
    total = sum(pflame._parse_collapsed(merged.decode()).values())
    want = sum(sum(pflame._parse_collapsed(open(p).read()).values())
               for p in (captures["jax"], captures["port"],
                         captures["hand"]))
    assert total == pytest.approx(want, abs=3.0)


def test_the_tools_read_a_crashed_jobs_leftovers(tmp_path, capsys):
    """A directory that holds only what committed: an empty capture and
    a ledger without categories."""
    empty = tmp_path / "empty.collapsed"
    empty.write_text("")
    port, ref = _both("profile_tool", profile_tool, ["top", str(empty)],
                      capsys)
    assert port == ref and "(empty capture)" in port
    bad = tmp_path / "goodput.rank0.json"
    bad.write_text(json.dumps({"rank": 0}))
    with pytest.raises(SystemExit) as exc:
        goodput_report.main(["summary", str(bad)])
    assert exc.value.code == 2
    assert "not a goodput ledger" in capsys.readouterr().err
