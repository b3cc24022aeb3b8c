"""The port's RecordIO file tools (``python -m mxnet_tpu_torch.tools.
{im2rec,rec2idx,rec_shard}``) against the repo's ``tools/`` over the JAX
package, on the same image trees and record files.

- ``im2rec --list``: the same ``.lst``, byte for byte;
- ``im2rec --encoding .jpg`` (cv2 is installed here): the same ``.rec``
  and ``.idx``, byte for byte, from JPEG and PNG sources;
- ``im2rec --encoding .png``: the port encodes PNG with its own codec,
  so the bytes may differ; every record's header is equal and its
  image decodes to the same pixels, exactly;
- the port packs a PNG tree with cv2 absent (the card machine has no
  OpenCV), the same records as with it; JPEG and ``--resize`` then
  raise naming cv2;
- ``rec2idx``: the same ``.idx``, native scanner and pure Python;
- ``rec_shard split``: the same shard files, byte for byte, and the
  same manifest (it holds basenames only, so no path needs normalising
  beyond that); ``inspect`` the same summary of a ``.rec`` and of a
  manifest.
"""
import argparse
import filecmp
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.tools import im2rec, rec2idx, rec_shard

torch.set_num_threads(2)

cv2 = pytest.importorskip("cv2")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(
        "jax_tool_" + name, os.path.join(ROOT, "tools", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _tree(root, exts=(".png",), per_class=3, size=(20, 24)):
    rng = np.random.RandomState(0)
    for c, cls in enumerate(("cat", "dog", "emu")):
        os.makedirs(os.path.join(root, cls, "sub"))
        for i in range(per_class):
            img = (rng.rand(*size, 3) * 255).astype(np.uint8)
            ext = exts[(c + i) % len(exts)]
            where = "sub" if i == 2 else ""
            cv2.imwrite(os.path.join(root, cls, where, "%d%s" % (i, ext)),
                        img)
    with open(os.path.join(root, "cat", "notes.txt"), "w") as f:
        f.write("not an image")
    return str(root)


def _args(prefix, root, **kw):
    base = dict(prefix=str(prefix), root=root, list=False,
                exts=".jpg,.jpeg,.png", shuffle=1, seed=0, resize=0,
                center_crop=False, quality=95, encoding=".jpg")
    base.update(kw)
    return argparse.Namespace(**base)


def _records(prefix):
    reader = mx.recordio.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec",
                                           "r")
    try:
        return [reader.read_idx(k) for k in sorted(reader.keys)]
    finally:
        reader.close()


def test_list_is_the_repo_tools_byte_for_byte(tmp_path):
    root = _tree(tmp_path / "imgs", exts=(".png", ".jpg", ".jpeg"))
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    res = subprocess.run(
        [sys.executable, "-m", "mxnet_tpu_torch.tools.im2rec",
         str(tmp_path / "port"), root, "--list", "--seed", "3"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "wrote 9 entries" in res.stdout
    _jax_tool("im2rec").make_list(_args(tmp_path / "jax", root, seed=3))
    assert filecmp.cmp(str(tmp_path / "port.lst"), str(tmp_path / "jax.lst"),
                       shallow=False)
    for shuffle in (0, 1):
        im2rec.make_list(_args(tmp_path / "p2", root, shuffle=shuffle))
        _jax_tool("im2rec").make_list(_args(tmp_path / "j2", root,
                                            shuffle=shuffle))
        assert filecmp.cmp(str(tmp_path / "p2.lst"),
                           str(tmp_path / "j2.lst"), shallow=False)


@pytest.mark.parametrize("exts", [(".jpg",), (".png", ".jpg")])
@pytest.mark.parametrize("crop", [False, True])
def test_jpeg_encoding_is_byte_identical(tmp_path, exts, crop):
    root = _tree(tmp_path / "imgs", exts=exts)
    jax_im2rec = _jax_tool("im2rec")
    for tool, name in ((im2rec, "port"), (jax_im2rec, "jax")):
        args = _args(tmp_path / name, root, center_crop=crop, quality=90)
        tool.make_list(args)
        tool.pack(args)
    for ext in (".lst", ".rec", ".idx"):
        assert filecmp.cmp(str(tmp_path / ("port" + ext)),
                           str(tmp_path / ("jax" + ext)), shallow=False), ext


def test_resize_matches_the_repo_tool(tmp_path):
    root = _tree(tmp_path / "imgs", exts=(".png",), size=(30, 40))
    for tool, name in ((im2rec, "port"), (_jax_tool("im2rec"), "jax")):
        args = _args(tmp_path / name, root, resize=16)
        tool.make_list(args)
        tool.pack(args)
    assert filecmp.cmp(str(tmp_path / "port.rec"), str(tmp_path / "jax.rec"),
                       shallow=False)


def _png_records(prefix):
    out = []
    for rec in _records(prefix):
        header, img = mx.recordio.unpack_img(rec, iscolor=1)
        out.append((header, np.asarray(img)))
    return out


def test_png_encoding_decodes_to_the_same_images(tmp_path, monkeypatch):
    root = _tree(tmp_path / "imgs", exts=(".png",))
    jax_im2rec = _jax_tool("im2rec")
    for tool, name in ((im2rec, "port"), (jax_im2rec, "jax")):
        args = _args(tmp_path / name, root, encoding=".png")
        tool.make_list(args)
        tool.pack(args)
    port, jax = _png_records(str(tmp_path / "port")), \
        _png_records(str(tmp_path / "jax"))
    assert len(port) == len(jax) == 9
    for (ph, pimg), (jh, jimg) in zip(port, jax):
        assert ph == jh
        np.testing.assert_array_equal(pimg, jimg)
    # Each record holds its source's pixels, as cv2 reads them.
    lines = [l.split("\t") for l in open(str(tmp_path / "port.lst"))]
    for (ph, pimg), line in zip(port, lines):
        src = cv2.imread(os.path.join(root, line[-1].strip()))
        np.testing.assert_array_equal(pimg, src)
        assert ph.label == float(line[1])
    # With cv2 absent, the port packs the same PNG records.
    monkeypatch.setitem(sys.modules, "cv2", None)
    args = _args(tmp_path / "port", root, encoding=".png")
    os.rename(str(tmp_path / "port.rec"), str(tmp_path / "before.rec"))
    im2rec.pack(args)
    assert filecmp.cmp(str(tmp_path / "port.rec"),
                       str(tmp_path / "before.rec"), shallow=False)
    with pytest.raises(ImportError, match="cv2"):
        im2rec.pack(_args(tmp_path / "port", root, encoding=".jpg"))
    with pytest.raises(ImportError, match="cv2"):
        im2rec.pack(_args(tmp_path / "port", root, encoding=".png",
                          resize=8))


def test_unreadable_images_are_skipped_in_both(tmp_path, capsys):
    root = _tree(tmp_path / "imgs", exts=(".png",))
    with open(os.path.join(root, "dog", "broken.png"), "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + b"\0" * 10)
    jax_im2rec = _jax_tool("im2rec")
    for tool, name in ((im2rec, "port"), (jax_im2rec, "jax")):
        args = _args(tmp_path / name, root, encoding=".png")
        tool.make_list(args)
        tool.pack(args)
    err = capsys.readouterr().err
    assert err.count("skipping unreadable image") == 2
    assert [h for h, _ in _png_records(str(tmp_path / "port"))] == \
        [h for h, _ in _png_records(str(tmp_path / "jax"))]


def _write_rec(path, n=23, seed=0):
    rng = np.random.RandomState(seed)
    w = mx.recordio.MXIndexedRecordIO(path[:-4] + ".idx", path, "w")
    payloads = [rng.bytes(int(rng.randint(1, 300))) for _ in range(n)]
    for i, p in enumerate(payloads):
        w.write_idx(i, p)
    w.close()
    return payloads


@pytest.mark.parametrize("native", [True, False])
def test_rec2idx_writes_the_same_index(tmp_path, native, capsys):
    rec = str(tmp_path / "data.rec")
    _write_rec(rec)
    extra = [] if native else ["--no-native"]
    rec2idx.main([rec, str(tmp_path / "port.idx")] + extra)
    argv = sys.argv
    try:
        sys.argv = ["rec2idx.py", rec, str(tmp_path / "jax.idx")] + extra
        _jax_tool("rec2idx").main()
    finally:
        sys.argv = argv
    assert filecmp.cmp(str(tmp_path / "port.idx"), str(tmp_path / "jax.idx"),
                       shallow=False)
    assert filecmp.cmp(str(tmp_path / "port.idx"), str(tmp_path / "data.idx"),
                       shallow=False)
    out = capsys.readouterr().out
    assert out.count("(23 records)") == 2


@pytest.mark.parametrize("shards", [1, 4])
def test_rec_shard_split_and_inspect_are_the_repo_tools(tmp_path, shards,
                                                        capsys):
    rec = str(tmp_path / "full.rec")
    payloads = _write_rec(rec, n=30, seed=shards)
    jax_rec_shard = _jax_tool("rec_shard")
    outs = {}
    for tool, name in ((rec_shard, "port"), (jax_rec_shard, "jax")):
        prefix = str(tmp_path / name / "part")
        assert tool.main(["split", rec, "--num-shards", str(shards),
                          "--out-prefix", prefix]) == 0
        outs[name] = json.loads(capsys.readouterr().out)
    assert outs["port"] == outs["jax"]
    counts = [s["records"] for s in outs["port"]["shards"]]
    assert sum(counts) == 30 and max(counts) - min(counts) <= 1
    for s in outs["port"]["shards"]:
        for key in ("rec", "idx"):
            assert filecmp.cmp(str(tmp_path / "port" / s[key]),
                               str(tmp_path / "jax" / s[key]), shallow=False)
    with open(str(tmp_path / "port" / "part-manifest.json")) as f:
        pm = json.load(f)
    with open(str(tmp_path / "jax" / "part-manifest.json")) as f:
        assert pm == json.load(f)
    got = []
    for s in pm["shards"]:
        got += _records(str(tmp_path / "port" / s["rec"])[:-4])
    assert sorted(got) == sorted(payloads)
    for path in (rec, str(tmp_path / "port" / "part-manifest.json")):
        rec_shard.main(["inspect", path])
        port = capsys.readouterr().out
        jax_rec_shard.main(["inspect", path])
        assert port == capsys.readouterr().out
    with pytest.raises(ValueError, match="num-shards"):
        rec_shard.split(rec, 0, str(tmp_path / "x"))
