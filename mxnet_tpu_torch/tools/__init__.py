"""Tools of the port (counterparts of the repo's ``tools/``), run as
``python -m mxnet_tpu_torch.tools.<name>``."""
