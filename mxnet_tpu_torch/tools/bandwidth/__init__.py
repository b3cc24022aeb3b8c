"""The kvstore communication benchmark (``python -m
mxnet_tpu_torch.tools.bandwidth.measure``), counterpart of the repo's
``tools/bandwidth/``."""
