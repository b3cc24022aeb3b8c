"""Evaluation metrics.

Reference: python/mxnet/metric.py — the EvalMetric registry updated by
the training loop (module/base_module.py:966). The metric computation is
host-side numpy over batch outputs: each NDArray is fetched with
``asnumpy()`` once per update (a single device→host transfer per batch;
keep metrics cheap relative to the step).

A copy of ``mxnet_tpu/metric.py`` over the port's NDArray.
"""
from __future__ import annotations

import math

import numpy

from .registry_util import Registry
from .ndarray.ndarray import NDArray

__all__ = [
    "EvalMetric", "CompositeEvalMetric", "Accuracy", "TopKAccuracy", "F1",
    "MCC", "MAE", "MSE", "RMSE", "CrossEntropy", "NegativeLogLikelihood",
    "Perplexity", "PearsonCorrelation", "Loss", "Torch", "Caffe",
    "CustomMetric", "np", "create", "register",
]

_REG = Registry("metric")
register = _REG.register


def _as_numpy(x):
    if isinstance(x, NDArray):
        return x.asnumpy()
    return numpy.asarray(x)


def _as_list(x):
    return list(x) if isinstance(x, (list, tuple)) else [x]


def create(metric, *args, **kwargs):
    """Create a metric by name, callable, or list (reference metric.py:create)."""
    if callable(metric):
        return CustomMetric(metric, *args, **kwargs)
    if isinstance(metric, (list, tuple)):
        composite = CompositeEvalMetric()
        for m in metric:
            composite.add(create(m, *args, **kwargs))
        return composite
    if isinstance(metric, EvalMetric):
        return metric
    return _REG.create(metric, *args, **kwargs)


class EvalMetric:
    """Base metric accumulating (sum_metric, num_inst)."""

    def __init__(self, name, output_names=None, label_names=None, **kwargs):
        self.name = str(name)
        self.output_names = output_names
        self.label_names = label_names
        self._kwargs = kwargs
        self.reset()

    def __str__(self):
        return "EvalMetric: {}".format(dict(self.get_name_value()))

    def get_config(self):
        config = dict(self._kwargs)
        config.update({"metric": self.__class__.__name__, "name": self.name,
                       "output_names": self.output_names,
                       "label_names": self.label_names})
        return config

    def update_dict(self, label, pred):
        if self.output_names is not None:
            pred = [pred[name] for name in self.output_names if name in pred]
        else:
            pred = list(pred.values())
        if self.label_names is not None:
            label = [label[name] for name in self.label_names if name in label]
        else:
            label = list(label.values())
        self.update(label, pred)

    def update(self, labels, preds):
        raise NotImplementedError()

    def reset(self):
        self.num_inst = 0
        self.sum_metric = 0.0

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, self.sum_metric / self.num_inst)

    def get_name_value(self):
        name, value = self.get()
        if not isinstance(name, list):
            name = [name]
        if not isinstance(value, list):
            value = [value]
        return list(zip(name, value))


def check_label_shapes(labels, preds, shape=False):
    """Reference: metric.py:check_label_shapes."""
    if not shape:
        label_n, pred_n = len(labels), len(preds)
    else:
        label_n, pred_n = labels.shape[0], preds.shape[0]
    if label_n != pred_n:
        raise ValueError("Shape of labels {} does not match shape of "
                         "predictions {}".format(label_n, pred_n))


class CompositeEvalMetric(EvalMetric):
    """Manage multiple metrics as one (reference metric.py:CompositeEvalMetric)."""

    def __init__(self, metrics=None, name="composite", output_names=None,
                 label_names=None):
        super().__init__(name, output_names=output_names, label_names=label_names)
        self.metrics = [create(m) for m in (metrics or [])]

    def add(self, metric):
        self.metrics.append(create(metric))

    def get_metric(self, index):
        return self.metrics[index]

    def update_dict(self, labels, preds):
        for metric in self.metrics:
            metric.update_dict(labels, preds)

    def update(self, labels, preds):
        for metric in self.metrics:
            metric.update(labels, preds)

    def reset(self):
        for metric in getattr(self, "metrics", []):
            metric.reset()

    def get(self):
        names, values = [], []
        for metric in self.metrics:
            name, value = metric.get()
            names.extend(name if isinstance(name, list) else [name])
            values.extend(value if isinstance(value, list) else [value])
        return (names, values)


@register
class Accuracy(EvalMetric):
    """Classification accuracy; predictions may be class indices or
    one-hot/probability rows (argmax over `axis`)."""

    def __init__(self, axis=1, name="accuracy", output_names=None,
                 label_names=None):
        super().__init__(name, axis=axis, output_names=output_names,
                         label_names=label_names)
        self.axis = axis

    def update(self, labels, preds):
        labels, preds = _as_list(labels), _as_list(preds)
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            label = _as_numpy(label)
            pred = _as_numpy(pred)
            if pred.ndim > label.ndim:
                pred = numpy.argmax(pred, axis=self.axis)
            pred = pred.astype("int32").flat
            label = label.astype("int32").flat
            check_label_shapes(label, pred)
            self.sum_metric += (numpy.asarray(pred) == numpy.asarray(label)).sum()
            self.num_inst += len(numpy.asarray(label))


@register
class TopKAccuracy(EvalMetric):
    """Top-k accuracy (reference metric.py:TopKAccuracy)."""

    def __init__(self, top_k=1, name="top_k_accuracy", output_names=None,
                 label_names=None):
        super().__init__(name, top_k=top_k, output_names=output_names,
                         label_names=label_names)
        self.top_k = top_k
        assert self.top_k > 1, "Use Accuracy for top_k = 1"
        self.name += "_%d" % self.top_k

    def update(self, labels, preds):
        labels, preds = _as_list(labels), _as_list(preds)
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            pred = _as_numpy(pred)
            label = _as_numpy(label).astype("int32")
            assert pred.ndim == 2, "Predictions should be 2 dims"
            pred = numpy.argsort(pred, axis=1)
            num_samples, num_dims = pred.shape
            top_k = min(num_dims, self.top_k)
            for j in range(top_k):
                self.sum_metric += (pred[:, num_dims - 1 - j].flat ==
                                    label.flat).sum()
            self.num_inst += num_samples


class _BinaryClassificationStats:
    """Running TP/FP/TN/FN (reference metric.py:_BinClassificationMetrics)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.true_positives = 0
        self.false_positives = 0
        self.true_negatives = 0
        self.false_negatives = 0

    def update(self, label, pred):
        pred = _as_numpy(pred)
        label = _as_numpy(label).astype("int32")
        if pred.ndim == 2:
            pred_label = numpy.argmax(pred, axis=1)
        else:
            pred_label = (pred.ravel() > 0.5).astype("int32")
        label = label.ravel()
        if len(numpy.unique(label)) > 2:
            raise ValueError("%s currently only supports binary classification."
                             % self.__class__.__name__)
        self.true_positives += ((pred_label == 1) & (label == 1)).sum()
        self.false_positives += ((pred_label == 1) & (label == 0)).sum()
        self.true_negatives += ((pred_label == 0) & (label == 0)).sum()
        self.false_negatives += ((pred_label == 0) & (label == 1)).sum()

    @property
    def precision(self):
        denom = self.true_positives + self.false_positives
        return self.true_positives / denom if denom else 0.0

    @property
    def recall(self):
        denom = self.true_positives + self.false_negatives
        return self.true_positives / denom if denom else 0.0

    @property
    def fscore(self):
        if self.precision + self.recall > 0:
            return 2 * self.precision * self.recall / (self.precision + self.recall)
        return 0.0

    @property
    def matthewscc(self):
        terms = [(self.true_positives + self.false_positives),
                 (self.true_positives + self.false_negatives),
                 (self.true_negatives + self.false_positives),
                 (self.true_negatives + self.false_negatives)]
        denom = 1.0
        for t in terms:
            denom *= t
        if denom == 0:
            return 0.0
        return ((self.true_positives * self.true_negatives -
                 self.false_positives * self.false_negatives) / math.sqrt(denom))

    @property
    def total_examples(self):
        return (self.true_positives + self.false_positives +
                self.true_negatives + self.false_negatives)


@register
class F1(EvalMetric):
    """Binary F1 with 'macro'/'micro' averaging (reference metric.py:F1)."""

    def __init__(self, name="f1", output_names=None, label_names=None,
                 average="macro"):
        super().__init__(name, output_names=output_names,
                         label_names=label_names)
        self.average = average
        self.metrics = _BinaryClassificationStats()

    def update(self, labels, preds):
        labels, preds = _as_list(labels), _as_list(preds)
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            self.metrics.update(label, pred)
            if self.average == "macro":
                self.sum_metric += self.metrics.fscore
                self.num_inst += 1
                self.metrics.reset()
        if self.average != "macro":
            self.sum_metric = self.metrics.fscore * self.metrics.total_examples
            self.num_inst = self.metrics.total_examples

    def reset(self):
        self.sum_metric = 0.0
        self.num_inst = 0
        if hasattr(self, "metrics"):
            self.metrics.reset()


@register
class MCC(F1):
    """Matthews correlation coefficient (reference metric.py:MCC)."""

    def __init__(self, name="mcc", output_names=None, label_names=None,
                 average="macro"):
        super().__init__(name=name, output_names=output_names,
                         label_names=label_names, average=average)

    def update(self, labels, preds):
        labels, preds = _as_list(labels), _as_list(preds)
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            self.metrics.update(label, pred)
            if self.average == "macro":
                self.sum_metric += self.metrics.matthewscc
                self.num_inst += 1
                self.metrics.reset()
        if self.average != "macro":
            self.sum_metric = self.metrics.matthewscc * self.metrics.total_examples
            self.num_inst = self.metrics.total_examples


@register
class MAE(EvalMetric):
    def __init__(self, name="mae", output_names=None, label_names=None):
        super().__init__(name, output_names=output_names, label_names=label_names)

    def update(self, labels, preds):
        labels, preds = _as_list(labels), _as_list(preds)
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            label = _as_numpy(label)
            pred = _as_numpy(pred)
            if len(label.shape) == 1:
                label = label.reshape(label.shape[0], 1)
            if len(pred.shape) == 1:
                pred = pred.reshape(pred.shape[0], 1)
            self.sum_metric += numpy.abs(label - pred).mean()
            self.num_inst += 1


@register
class MSE(EvalMetric):
    def __init__(self, name="mse", output_names=None, label_names=None):
        super().__init__(name, output_names=output_names, label_names=label_names)

    def update(self, labels, preds):
        labels, preds = _as_list(labels), _as_list(preds)
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            label = _as_numpy(label)
            pred = _as_numpy(pred)
            if len(label.shape) == 1:
                label = label.reshape(label.shape[0], 1)
            if len(pred.shape) == 1:
                pred = pred.reshape(pred.shape[0], 1)
            self.sum_metric += ((label - pred) ** 2.0).mean()
            self.num_inst += 1


@register
class RMSE(MSE):
    def __init__(self, name="rmse", output_names=None, label_names=None):
        super().__init__(name=name, output_names=output_names,
                         label_names=label_names)

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, math.sqrt(self.sum_metric / self.num_inst))


@register
class CrossEntropy(EvalMetric):
    """CE of predicted probability at the true class (reference
    metric.py:CrossEntropy)."""

    def __init__(self, eps=1e-12, name="cross-entropy", output_names=None,
                 label_names=None):
        super().__init__(name, eps=eps, output_names=output_names,
                         label_names=label_names)
        self.eps = eps

    def update(self, labels, preds):
        labels, preds = _as_list(labels), _as_list(preds)
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            label = _as_numpy(label).ravel()
            pred = _as_numpy(pred)
            assert label.shape[0] == pred.shape[0]
            prob = pred[numpy.arange(label.shape[0]), numpy.int64(label)]
            self.sum_metric += (-numpy.log(prob + self.eps)).sum()
            self.num_inst += label.shape[0]


@register
class NegativeLogLikelihood(CrossEntropy):
    def __init__(self, eps=1e-12, name="nll-loss", output_names=None,
                 label_names=None):
        super().__init__(eps=eps, name=name, output_names=output_names,
                         label_names=label_names)


@register
class Perplexity(CrossEntropy):
    """exp(mean CE), optionally ignoring a padding label (reference
    metric.py:Perplexity)."""

    def __init__(self, ignore_label=None, axis=-1, name="perplexity",
                 output_names=None, label_names=None):
        super().__init__(name=name, output_names=output_names,
                         label_names=label_names)
        self.ignore_label = ignore_label
        self.axis = axis

    def update(self, labels, preds):
        loss = 0.0
        num = 0
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            label = _as_numpy(label)
            pred = _as_numpy(pred)
            assert label.size == pred.size / pred.shape[-1]
            label = label.reshape(-1).astype("int64")
            pred = pred.reshape(-1, pred.shape[-1])
            prob = pred[numpy.arange(label.shape[0]), label]
            if self.ignore_label is not None:
                ignore = (label == self.ignore_label)
                prob = prob * (1 - ignore) + ignore
                num -= ignore.sum()
            loss -= numpy.log(numpy.maximum(1e-10, prob)).sum()
            num += label.shape[0]
        self.sum_metric += loss
        self.num_inst += num

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, math.exp(self.sum_metric / self.num_inst))


@register
class PearsonCorrelation(EvalMetric):
    def __init__(self, name="pearsonr", output_names=None, label_names=None):
        super().__init__(name, output_names=output_names, label_names=label_names)

    def update(self, labels, preds):
        labels, preds = _as_list(labels), _as_list(preds)
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            label = _as_numpy(label).ravel()
            pred = _as_numpy(pred).ravel()
            self.sum_metric += numpy.corrcoef(pred, label)[0, 1]
            self.num_inst += 1


@register
class Loss(EvalMetric):
    """Mean of a loss output (reference metric.py:Loss)."""

    def __init__(self, name="loss", output_names=None, label_names=None):
        super().__init__(name, output_names=output_names, label_names=label_names)

    def update(self, _, preds):
        for pred in _as_list(preds):
            loss = _as_numpy(pred)
            self.sum_metric += loss.sum()
            self.num_inst += loss.size


@register
class Torch(Loss):
    def __init__(self, name="torch", output_names=None, label_names=None):
        super().__init__(name=name, output_names=output_names,
                         label_names=label_names)


@register
class Caffe(Loss):
    def __init__(self, name="caffe", output_names=None, label_names=None):
        super().__init__(name=name, output_names=output_names,
                         label_names=label_names)


@register
class CustomMetric(EvalMetric):
    """Wrap `feval(label, pred) -> value | (sum, num)` (reference
    metric.py:CustomMetric)."""

    def __init__(self, feval, name=None, allow_extra_outputs=False,
                 output_names=None, label_names=None):
        if name is None:
            name = feval.__name__
            if name.find("<") != -1:
                name = "custom(%s)" % name
        super().__init__(name, feval=feval,
                         allow_extra_outputs=allow_extra_outputs,
                         output_names=output_names, label_names=label_names)
        self._feval = feval
        self._allow_extra_outputs = allow_extra_outputs

    def update(self, labels, preds):
        labels, preds = _as_list(labels), _as_list(preds)
        if not self._allow_extra_outputs:
            check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            label = _as_numpy(label)
            pred = _as_numpy(pred)
            reval = self._feval(label, pred)
            if isinstance(reval, tuple):
                sum_metric, num_inst = reval
                self.sum_metric += sum_metric
                self.num_inst += num_inst
            else:
                self.sum_metric += reval
                self.num_inst += 1


# Short aliases matching the reference registry (metric.py registers
# these via the `@register.alias` decorator there).
for _alias, _cls in [("acc", Accuracy), ("top_k_acc", TopKAccuracy),
                     ("ce", CrossEntropy), ("nll_loss", NegativeLogLikelihood),
                     ("pearsonr", PearsonCorrelation)]:
    _REG.register(_alias)(_cls)
del _alias, _cls


def np(numpy_feval, name=None, allow_extra_outputs=False):
    """Turn a numpy feval into a CustomMetric (reference metric.py:np)."""

    def feval(label, pred):
        return numpy_feval(label, pred)

    feval.__name__ = numpy_feval.__name__
    return CustomMetric(feval, name, allow_extra_outputs)
