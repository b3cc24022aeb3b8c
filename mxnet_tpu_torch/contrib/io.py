"""mx.contrib.io — adapters between Gluon data loaders and the DataIter
API.

Counterpart of ``mxnet_tpu/contrib/io.py`` (reference:
python/mxnet/contrib/io.py:DataLoaderIter). The batches are the
loader's own NDArrays, on the context the loader puts them on.
``provide_data``/``provide_label`` are taken once from the first batch,
which is drawn only for them; the iterator then starts over, as
upstream's ``__init__`` ends with ``reset()``. (The JAX package hands
that first batch out again, so a ``reset`` before the first ``next``
serves it twice, and its descriptors raise once it has been handed out.)
"""
from __future__ import annotations

from ..io import DataIter, DataBatch, DataDesc

__all__ = ["DataLoaderIter"]


class DataLoaderIter(DataIter):
    """Expose a gluon.data.DataLoader as a Module-compatible DataIter
    (reference contrib/io.py:DataLoaderIter). `provide_data` and
    `provide_label` come from the first batch, which is drawn here and
    drawn again by the first `next`."""

    def __init__(self, loader, data_name="data", label_name="softmax_label",
                 dtype="float32"):
        super().__init__(batch_size=getattr(loader, "_batch_sampler", None)
                         and loader._batch_sampler._batch_size or 0)
        self._loader = loader
        self._iter = iter(loader)
        data, label = self._split(next(self._iter))
        self._provide_data = [DataDesc(data_name, data.shape, dtype)]
        self._provide_label = [] if label is None else \
            [DataDesc(label_name, label.shape, dtype)]
        self.reset()

    def _split(self, batch):
        if isinstance(batch, (list, tuple)):
            data, label = batch[0], batch[1] if len(batch) > 1 else None
        else:
            data, label = batch, None
        return data, label

    @property
    def provide_data(self):
        return list(self._provide_data)

    @property
    def provide_label(self):
        return list(self._provide_label)

    def reset(self):
        self._iter = iter(self._loader)

    def next(self):
        batch = next(self._iter, None)
        if batch is None:
            raise StopIteration
        return self._wrap(batch)

    def _wrap(self, batch):
        data, label = self._split(batch)
        return DataBatch(data=[data],
                         label=[label] if label is not None else [])
