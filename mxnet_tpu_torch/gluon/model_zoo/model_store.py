"""Pretrained weight store.

Counterpart of ``mxnet_tpu/gluon/model_zoo/model_store.py`` (reference:
python/mxnet/gluon/model_zoo/model_store.py, which fetches sha1-pinned
weight files from the MXNet S3 bucket). This package downloads nothing:
pretrained weights are local files, ``<model_name>.params`` written by
``Block.save_parameters`` (of either package), in the directory that
``MXNET_TPU_MODEL_ZOO_DIR`` names (default ``~/.mxnet_tpu/models``).
"""
from __future__ import annotations

import os

__all__ = ["get_model_file"]


def get_model_file(name, root=None):
    """The path of `name`'s ``.params`` file under `root`; raises
    FileNotFoundError naming the path if there is none."""
    root = root or os.environ.get("MXNET_TPU_MODEL_ZOO_DIR") or \
        os.path.expanduser("~/.mxnet_tpu/models")
    path = os.path.join(root, name + ".params")
    if os.path.exists(path):
        return path
    raise FileNotFoundError(
        "Pretrained weights for %r not found at %s. This package cannot "
        "download weights; place a .params file there "
        "(Block.save_parameters format) or use pretrained=False."
        % (name, path))
