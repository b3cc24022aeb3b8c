"""The operators of ``mxnet_tpu/ops/{elementwise,matrix,reduce,nn}.py``
in the port against the JAX package's.

One case per registered name (aliases included; some names have more
than one case, for other attrs). The same numpy inputs, made from a
seed, go through each package's imperative dispatch (``_invoke``: the
JAX package's on the CPU, the port's with ``ctx=mx.cpu()``); forward
outputs are compared, and for a differentiable op the gradients of
every float input under ``autograd.record()`` and ``backward`` with a
random head gradient. The RNG operators of ``random_ops.py`` are held
to their laws in ``test_torch_random.py``; the coverage test here holds
the port's registry to all five files.

Tolerances (fp32): rtol 1e-5 / atol 1e-6 by default; rtol 1e-4 for the
transcendental functions whose two libraries differ in their last bits
(gamma, gammaln, erfinv, the cube roots) and for the ops that sum in
other orders (Deconvolution, LRN, resampling), each stated in its spec.

Inputs avoid the points where the two packages may legitimately differ:
halves for the roundings (``round``/``rint`` follow the reference there,
tested in ``test_torch_core_surface.py``), kinks, ties in orderings and
out-of-range indices.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu.ndarray.ndarray import _invoke as j_invoke
from mxnet_tpu.ops import registry as jreg

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.ndarray.ndarray import _invoke as t_invoke
from mxnet_tpu_torch.ops import registry as treg

torch.set_num_threads(2)

RTOL, ATOL = 1e-5, 1e-6
LOOSE = {"rtol": 1e-4, "atol": 1e-5}

FILES = ("elementwise", "matrix", "reduce", "nn", "random_ops")

R = np.random.RandomState(11)


def _sym(*s):
    return (R.rand(*s) * 2 - 1).astype(np.float32)


def _pos(*s):
    return (R.rand(*s) + 0.5).astype(np.float32)


def _away(*s):
    """Values in [-1, 1] at least 0.15 from 0 (no kink of relu, abs,
    leaky ops nearby)."""
    x = _sym(*s)
    x[np.abs(x) < 0.15] += 0.3
    return x


def _distinct(*s):
    """A permutation of spread values: no ties in any ordering."""
    n = int(np.prod(s))
    return (R.permutation(n).astype(np.float32) * 0.37 - n * 0.1) \
        .reshape(s)


def _off_half(*s):
    """Values in [-3, 3] at least 0.05 from any half-integer."""
    x = (R.rand(*s) * 6 - 3).astype(np.float32)
    frac = x - np.floor(x)
    x[np.abs(frac - 0.5) < 0.05] += 0.1
    return x


def _ints(*vals):
    return np.array(vals, np.float32)


# name -> list of (id suffix, inputs maker, attrs, mode, tol, wrt)
# mode: "grad" (forward and gradients), "fwd" (forward only: no
# gradient), "compose" (gradient of op(x) * x: the op's own output
# carries none), "loss" (gradients under a head of ones, the head a loss
# is differentiated with: MakeLoss ignores its head gradient, as the
# reference does, where the JAX package passes it through).
SPECS = {}


def spec(name, make, attrs=None, mode="grad", tol=None, wrt=None, tag=""):
    SPECS.setdefault(name, []).append(
        (tag, make, attrs or {}, mode, tol or {}, wrt))


# -- elementwise --------------------------------------------------------------
for op in ["broadcast_maximum", "broadcast_minimum", "broadcast_hypot"]:
    spec(op, lambda: [_away(3, 4), _away(1, 4) + 0.05])
for op in ["_maximum", "_minimum", "maximum", "minimum", "_hypot"]:
    spec(op, lambda: [_away(3, 4), _away(3, 4) + 0.05])
for op in ["arctan2", "_arctan2"]:
    spec(op, lambda: [_sym(3, 4), _pos(3, 4)])
# a % b: floor modulo; the gradient to b is -floor(a / b).
spec("broadcast_mod", lambda: [_sym(3, 4) * 5, _pos(1, 4)])
spec("_mod", lambda: [_sym(3, 4) * 5, -_pos(3, 4)])
for op in ["broadcast_logical_and", "broadcast_logical_or",
           "broadcast_logical_xor", "_logical_and", "_logical_or",
           "_logical_xor"]:
    spec(op, lambda: [np.round(_sym(3, 4)), np.round(_sym(3, 4))],
         mode="fwd")
spec("_maximum_scalar", lambda: [_away(3, 4)], {"scalar": 0.0})
spec("_minimum_scalar", lambda: [_away(3, 4)], {"scalar": 0.0})
spec("_mod_scalar", lambda: [_sym(3, 4) * 5], {"scalar": 1.7})
spec("_rmod_scalar", lambda: [_pos(3, 4)], {"scalar": 2.3})
spec("_rpower_scalar", lambda: [_sym(3, 4)], {"scalar": 1.7})
for op in ["reciprocal", "rsqrt", "log10", "log2", "log1p"]:
    spec(op, lambda: [_pos(3, 4)])
for op in ["cbrt", "rcbrt"]:
    spec(op, lambda: [_away(3, 4) * 3], tol=LOOSE)
for op in ["expm1", "sin", "cos", "arctan", "degrees", "radians", "sinh",
           "cosh", "arcsinh", "erf", "softsign", "_copy",
           "identity_with_attr_like_rhs"]:
    spec(op, lambda: [_sym(3, 4)])
spec("tan", lambda: [_sym(3, 4) * 0.5])
for op in ["arcsin", "arccos", "arctanh"]:
    spec(op, lambda: [_sym(3, 4) * 0.8])
spec("arccosh", lambda: [_pos(3, 4) + 1.0])
for op in ["gamma", "gammaln"]:
    spec(op, lambda: [_pos(3, 4) * 3], tol=LOOSE)
spec("erfinv", lambda: [_sym(3, 4) * 0.9], tol=LOOSE)
spec("smooth_l1", lambda: [_away(3, 4) * 2], {"scalar": 1.0})
spec("smooth_l1", lambda: [_away(3, 4) * 2], {"scalar": 2.0}, tag="s2")
for op in ["round", "rint", "ceil", "floor", "trunc", "fix"]:
    spec(op, lambda: [_off_half(4, 5)], mode="fwd")
spec("logical_not", lambda: [np.round(_sym(3, 4))], mode="fwd")
for op in ["isnan", "isinf"]:
    spec(op, lambda: [np.array([[0.0, np.nan, np.inf], [-np.inf, 1.0,
                                                          -2.0]],
                               np.float32)], mode="fwd")
for op in ["stop_gradient", "BlockGrad", "make_loss_grad_block"]:
    spec(op, lambda: [_sym(3, 4)], mode="compose")
spec("_scatter_set_nd", lambda: [_sym(4, 5),
                                 np.array([[0, 2, 3], [1, 4, 0]], np.int32)],
     {"value": 2.5}, mode="fwd")

# -- reductions and orderings -------------------------------------------------
for op in ["argmax", "argmin"]:
    spec(op, lambda: [_distinct(3, 4, 5)], {"axis": 1}, "fwd")
    spec(op, lambda: [_distinct(3, 4, 5)], {"axis": 2, "keepdims": True},
         "fwd", tag="keepdims")
    spec(op, lambda: [_distinct(3, 4)], {}, "fwd", tag="flat")
spec("argmax_channel", lambda: [_distinct(3, 4)], mode="fwd")
for op in ["max", "min"]:
    spec(op, lambda: [_distinct(3, 4, 5)], {"axis": (0, 2)})
    spec(op, lambda: [_distinct(3, 4, 5)], {"axis": 1, "exclude": True,
                                            "keepdims": True}, tag="exclude")
spec("prod", lambda: [_pos(3, 4, 2)], {"axis": (1, 2)})
spec("prod", lambda: [_pos(3, 4)], {}, tag="all")
spec("nansum", lambda: [np.where(R.rand(3, 4) < 0.2, np.nan, _sym(3, 4))
                        .astype(np.float32)], {"axis": 1})
spec("nanprod", lambda: [np.where(R.rand(3, 4) < 0.2, np.nan, _pos(3, 4))
                         .astype(np.float32)], {"axis": 1})
for op in ["sum_axis", "sum_mid_internal"]:
    spec(op, lambda: [_sym(3, 4, 2)], {"axis": 1})
spec("sort", lambda: [_distinct(3, 6)], {"axis": 1})
spec("sort", lambda: [_distinct(3, 6)], {"axis": 0, "is_ascend": False},
     tag="descending")
spec("argsort", lambda: [_distinct(3, 6)], {"axis": 1}, "fwd")
spec("argsort", lambda: [_distinct(3, 6)], {"axis": 0, "is_ascend": False},
     "fwd", tag="descending")
for ret in ["indices", "value", "both", "mask"]:
    spec("topk", lambda: [_distinct(4, 7)], {"k": 3, "ret_typ": ret},
         "fwd", tag=ret)
spec("topk", lambda: [_distinct(4, 7, 2)], {"k": 2, "axis": 1,
                                            "ret_typ": "both",
                                            "is_ascend": True},
     "fwd", tag="ascending-axis1")
spec("cumsum", lambda: [_sym(3, 4)], {"axis": 1})
spec("cumsum", lambda: [_sym(3, 4)], {}, tag="flat")
spec("histogram", lambda: [_sym(50)], {"bin_cnt": 7, "range": (-1, 1)},
     "fwd")
spec("histogram", lambda: [np.array([0.0, 0.25, 0.5, 1.0, 1.5, -0.1, 0.99],
                                    np.float32)], {"bin_cnt": 4}, "fwd",
     tag="edges")

# -- shape, indexing and creation ---------------------------------------------
for op in ["arange", "_arange"]:
    spec(op, lambda: [], {"start": 1.0, "stop": 4.0, "step": 0.3}, "fwd")
spec("arange", lambda: [], {"start": 0.0, "stop": 7.0, "repeat": 2,
                            "dtype": "int32"}, "fwd", tag="repeat")
for op in ["zeros", "_zeros", "ones", "_ones"]:
    spec(op, lambda: [], {"shape": (2, 3)}, "fwd")
for op in ["full", "_full"]:
    spec(op, lambda: [], {"shape": (2, 3), "value": 1.5}, "fwd")
spec("one_hot", lambda: [_ints(0, 2, 1, 3)], {"depth": 4}, "fwd")
spec("one_hot", lambda: [_ints(0, 2, -1, 5)], {"depth": 4, "on_value": 2.0,
                                               "off_value": -1.0},
     "fwd", tag="out-of-range")
spec("slice", lambda: [_sym(5, 6)], {"begin": (1, 0), "end": (4, 5)})
spec("slice", lambda: [_sym(5, 6)], {"begin": (4, None), "end": (0, None),
                                     "step": (-2, 2)}, tag="steps")
spec("crop", lambda: [_sym(4, 5)], {"begin": (0, 1), "end": (2, 4)})
spec("slice_like", lambda: [_sym(4, 5), _sym(2, 3)], wrt=(0,))
spec("slice_like", lambda: [_sym(4, 5), _sym(2, 3)], {"axes": (1,)},
     wrt=(0,), tag="axes")
spec("tile", lambda: [_sym(2, 3)], {"reps": (2, 1, 2)})
spec("repeat", lambda: [_sym(2, 3)], {"repeats": 2, "axis": 1})
spec("repeat", lambda: [_sym(2, 3)], {"repeats": 3}, tag="flat")
for op, mode_ in [("pad", "constant"), ("Pad", "edge"), ("pad", "reflect")]:
    spec(op, lambda: [_sym(1, 2, 4, 5)],
         {"mode": mode_, "pad_width": (0, 0, 0, 0, 1, 2, 2, 1),
          "constant_value": 0.5}, tag=mode_)
spec("squeeze", lambda: [_sym(3, 1, 4, 1)], {"axis": 1})
spec("squeeze", lambda: [_sym(3, 1, 4, 1)], {}, tag="all")
for op in ["flip", "reverse"]:
    spec(op, lambda: [_sym(3, 4)], {"axis": 1})
for op in ["swapaxes", "SwapAxis"]:
    spec(op, lambda: [_sym(2, 3, 4)], {"dim1": 0, "dim2": 2})
spec("moveaxis", lambda: [_sym(2, 3, 4)], {"source": 0, "destination": 2})
spec("broadcast_to", lambda: [_sym(1, 4)], {"shape": (3, 4)})
spec("broadcast_to", lambda: [_sym(2, 1)], {"shape": (0, 5)}, tag="keep")
spec("broadcast_like", lambda: [_sym(1, 4), _sym(3, 4)], wrt=(0,))
spec("reshape_like", lambda: [_sym(3, 4), _sym(2, 6)], wrt=(0,))
spec("batch_dot", lambda: [_sym(2, 3, 4), _sym(2, 4, 5)])
spec("batch_dot", lambda: [_sym(2, 4, 3), _sym(2, 5, 4)],
     {"transpose_a": True, "transpose_b": True}, tag="transposed")
spec("batch_take", lambda: [_sym(3, 4), _ints(0, 3, 1)], wrt=(0,))
spec("gather_nd", lambda: [_sym(4, 5, 2), _ints(*[0, 3, 2, 1]).reshape(2, 2)],
     wrt=(0,))
spec("scatter_nd", lambda: [_sym(3), _ints(0, 3, 1).reshape(1, 3)],
     {"shape": (5,)}, wrt=(0,))
spec("_scatter_nd_add", lambda: [_sym(4), _ints(1, 3, 1, 0, 2, 0, 2, 2)
                                 .reshape(2, 4)], {"shape": (4, 3)},
     wrt=(0,))
spec("diag", lambda: [_sym(4, 4)])
spec("diag", lambda: [_sym(4)], {"k": 1}, tag="vector")
spec("depth_to_space", lambda: [_sym(1, 8, 2, 3)], {"block_size": 2})
spec("space_to_depth", lambda: [_sym(1, 2, 4, 6)], {"block_size": 2})
spec("ravel_multi_index", lambda: [_ints(1, 2, 0, 1, 1, 3).reshape(2, 3)],
     {"shape": (3, 4)}, "fwd")
spec("unravel_index", lambda: [_ints(3, 7, 11, 0)], {"shape": (3, 4)},
     "fwd")
for op in ["shape_array", "size_array"]:
    spec(op, lambda: [_sym(3, 4, 2)], mode="fwd")

# -- neural network -----------------------------------------------------------
for op in ["Deconvolution", "deconvolution"]:
    spec(op, lambda: [_sym(2, 4, 3, 3), _sym(4, 3, 3, 3), _sym(3)],
         {"kernel": (3, 3), "num_filter": 3}, tol=LOOSE)
spec("Deconvolution", lambda: [_sym(2, 4, 3, 4), _sym(4, 1, 4, 4), _sym(2)],
     {"kernel": (4, 4), "stride": (2, 2), "pad": (1, 1), "adj": (1, 0),
      "num_filter": 2, "num_group": 2}, tol=LOOSE, tag="strided-grouped")
spec("Deconvolution", lambda: [_sym(1, 2, 5), _sym(2, 3, 3)],
     {"kernel": (3,), "stride": (2,), "dilate": (2,), "num_filter": 3,
      "no_bias": True}, tol=LOOSE, tag="1d-dilated")
for op in ["LayerNorm", "layer_norm"]:
    spec(op, lambda: [_sym(3, 6), _pos(6), _sym(6)])
spec("LayerNorm", lambda: [_sym(3, 5, 4), _pos(5), _sym(5)],
     {"axis": 1, "output_mean_var": True}, tag="mean-var")
for op in ["InstanceNorm", "instance_norm"]:
    spec(op, lambda: [_sym(2, 3, 5), _pos(3), _sym(3)])
for mode_ in ["instance", "channel", "spatial"]:
    spec("L2Normalization", lambda: [_pos(2, 3, 4)], {"mode": mode_},
         tag=mode_)
spec("l2_normalization", lambda: [_pos(3, 4)])
for op in ["LRN", "lrn"]:
    spec(op, lambda: [_pos(2, 5, 3, 3)], {"nsize": 3}, tol=LOOSE)
for act in ["leaky", "elu", "selu", "gelu", "rrelu"]:
    spec("LeakyReLU", lambda: [_away(3, 4)], {"act_type": act, "slope": 0.3},
         tag=act)
spec("LeakyReLU", lambda: [_away(2, 3, 4), _pos(3)], {"act_type": "prelu"},
     tag="prelu")
spec("leaky_relu", lambda: [_away(3, 4)], {"act_type": "leaky"})
for op in ["SoftmaxActivation", "softmax_activation"]:
    spec(op, lambda: [_sym(2, 3, 4)])
spec("SoftmaxActivation", lambda: [_sym(2, 3, 4)], {"mode": "channel"},
     tag="channel")
spec("softmin", lambda: [_sym(3, 4)], {"axis": 0})
spec("softmax_cross_entropy", lambda: [_sym(3, 4), _ints(0, 2, 3)],
     wrt=(0,))
for op in ["UpSampling", "upsampling"]:
    spec(op, lambda: [_sym(1, 2, 3, 3)], {"scale": 2,
                                          "sample_type": "nearest"})
spec("UpSampling", lambda: [_sym(2, 2, 3, 4)], {"scale": 3,
                                                "sample_type": "bilinear"},
     tol=LOOSE, tag="bilinear")
for op in ["GridGenerator", "grid_generator"]:
    spec(op, lambda: [_sym(2, 6)], {"transform_type": "affine",
                                    "target_shape": (4, 5)})
for op in ["BilinearSampler", "bilinear_sampler"]:
    spec(op, lambda: [_sym(2, 3, 5, 6), _sym(2, 2, 4, 3) * 1.1],
         tol=LOOSE)
for op in ["SpatialTransformer", "spatial_transformer"]:
    spec(op, lambda: [_sym(2, 3, 5, 6),
                      (np.array([[0.9, 0.1, 0.05, -0.1, 0.8, 0.1]]) +
                       _sym(2, 6) * 0.1).astype(np.float32)],
         {"target_shape": (4, 4)}, tol=LOOSE)
for op in ["MakeLoss", "make_loss"]:
    spec(op, lambda: [_sym(3, 4)], mode="loss")
for op in ["LinearRegressionOutput", "linear_regression_output",
           "LogisticRegressionOutput", "logistic_regression_output",
           "MAERegressionOutput", "mae_regression_output"]:
    spec(op, lambda: [_sym(3, 4), _sym(3, 4)], {"grad_scale": 0.5},
         wrt=(0,))


# -- the names of the five files that earlier slices ported -------------------
for op in ["broadcast_add", "broadcast_plus", "broadcast_sub",
           "broadcast_minus", "broadcast_mul"]:
    spec(op, lambda: [_sym(3, 4), _sym(1, 4)])
for op in ["elemwise_add", "elemwise_sub", "elemwise_mul", "_add", "_plus",
           "_sub", "_minus", "_mul"]:
    spec(op, lambda: [_sym(3, 4), _sym(3, 4)])
for op in ["broadcast_div", "elemwise_div", "_div"]:
    spec(op, lambda: [_sym(3, 4), _pos(3, 4)])
for op in ["broadcast_power", "_power", "pow"]:
    spec(op, lambda: [_pos(3, 4), _sym(3, 4)])
for op in ["broadcast_equal", "broadcast_not_equal", "broadcast_greater",
           "broadcast_greater_equal", "broadcast_lesser",
           "broadcast_lesser_equal", "_equal", "_not_equal", "_greater",
           "_greater_equal", "_lesser", "_lesser_equal"]:
    spec(op, lambda: [np.round(_sym(3, 4)), np.round(_sym(1, 4))], mode="fwd")
for op in ["_equal_scalar", "_not_equal_scalar", "_greater_scalar",
           "_greater_equal_scalar", "_lesser_scalar", "_lesser_equal_scalar"]:
    spec(op, lambda: [np.round(_sym(3, 4) * 2)], {"scalar": 1.0}, "fwd")
for op in ["_plus_scalar", "_minus_scalar", "_rminus_scalar", "_mul_scalar",
           "_div_scalar", "_rdiv_scalar", "_power_scalar"]:
    spec(op, lambda: [_pos(3, 4)], {"scalar": 1.7})
for op in ["exp", "identity", "negative", "square", "tanh", "sigmoid",
           "sign"]:
    spec(op, lambda: [_sym(3, 4)])
for op in ["log", "sqrt"]:
    spec(op, lambda: [_pos(3, 4)])
for op in ["abs", "relu"]:
    spec(op, lambda: [_away(3, 4)])
spec("clip", lambda: [_away(3, 4) * 3], {"a_min": -1.1, "a_max": 1.3})
for op, dt in [("cast", "int32"), ("Cast", "float16")]:
    spec(op, lambda: [_sym(3, 4) * 5], {"dtype": dt}, "fwd")
    spec(op, lambda: [_sym(3, 4)], {"dtype": "float32"}, tag="grad")
spec("where", lambda: [np.round(R.rand(3, 4)).astype(np.float32),
                       _sym(3, 4), _sym(3, 4)], wrt=(1, 2))
for op in ["zeros_like", "ones_like"]:
    spec(op, lambda: [_sym(3, 4)], mode="compose")
for op in ["sum", "mean"]:
    spec(op, lambda: [_sym(3, 4, 2)], {"axis": (0, 2), "keepdims": True})
spec("norm", lambda: [_pos(3, 4)], {"axis": 1})
spec("norm", lambda: [_sym(3, 4)], {"ord": 1}, tag="l1")
for op in ["reshape", "Reshape"]:
    spec(op, lambda: [_sym(2, 3, 4)], {"shape": (0, -1)})
spec("transpose", lambda: [_sym(2, 3, 4)], {"axes": (2, 0, 1)})
for op in ["flatten", "Flatten"]:
    spec(op, lambda: [_sym(2, 3, 4)])
spec("expand_dims", lambda: [_sym(3, 4)], {"axis": 1})
for op in ["broadcast_axis", "broadcast_axes"]:
    spec(op, lambda: [_sym(1, 4, 1)], {"axis": (0, 2), "size": (3, 2)})
for op in ["concat", "Concat"]:
    spec(op, lambda: [_sym(2, 3), _sym(2, 2)], {"dim": 1})
spec("stack", lambda: [_sym(2, 3), _sym(2, 3)], {"axis": 1})
for op in ["split", "SliceChannel", "slice_channel"]:
    spec(op, lambda: [_sym(4, 6)], {"num_outputs": 3, "axis": 1})
spec("slice_axis", lambda: [_sym(4, 5)], {"axis": 1, "begin": 1, "end": -1})
spec("dot", lambda: [_sym(3, 4), _sym(4, 2)])
spec("dot", lambda: [_sym(4, 3), _sym(2, 4)], {"transpose_a": True,
                                               "transpose_b": True},
     tag="transposed")
spec("pick", lambda: [_sym(3, 4), _ints(0, 3, 1)], {"axis": 1}, wrt=(0,))
spec("take", lambda: [_sym(5, 3), _ints(0, 4, 2, 4)], wrt=(0,))
for op in ["FullyConnected", "fully_connected"]:
    spec(op, lambda: [_sym(2, 5), _sym(4, 5), _sym(4)], {"num_hidden": 4})
for op in ["Convolution", "convolution"]:
    spec(op, lambda: [_sym(2, 3, 6, 5), _sym(4, 3, 3, 3), _sym(4)],
         {"kernel": (3, 3), "pad": (1, 1), "num_filter": 4}, tol=LOOSE)
for op, pool in [("Pooling", "avg"), ("pooling", "max")]:
    spec(op, lambda: [_distinct(1, 2, 4, 6)],
         {"kernel": (2, 2), "stride": (2, 2), "pool_type": pool})
for op in ["Activation", "activation"]:
    for act in ["relu", "sigmoid", "tanh", "softrelu", "softsign", "relu6"]:
        spec(op, lambda: [_away(3, 4) * 4], {"act_type": act}, tag=act)
for op in ["softmax", "log_softmax"]:
    spec(op, lambda: [_sym(3, 4)], {"axis": 0})
for op in ["BatchNorm", "batch_norm"]:
    spec(op, lambda: [_sym(4, 3, 2, 2), _pos(3), _sym(3), _sym(3), _pos(3)],
         {"fix_gamma": False}, wrt=(0, 1, 2), tol=LOOSE)
    spec(op, lambda: [_sym(4, 3, 2, 2), _pos(3), _sym(3), _sym(3), _pos(3)],
         {"fix_gamma": False}, "fwd", tag="inference")
for op in ["Embedding", "embedding"]:
    spec(op, lambda: [_ints(0, 4, 2, 2), _sym(5, 3)],
         {"input_dim": 5, "output_dim": 3}, wrt=(1,))
for op in ["SoftmaxOutput", "softmax_output", "Softmax"]:
    spec(op, lambda: [_sym(3, 4), _ints(0, 3, 1)], {"grad_scale": 0.5},
         wrt=(0,))


class _Key:
    """The JAX package's ``_index`` reads ``key.key``."""

    def __init__(self, key):
        self.key = key


CASES = [(name, i) for name in sorted(SPECS) for i in range(len(SPECS[name]))]


def _case_id(case):
    name, i = case
    tag = SPECS[name][i][0]
    return name + ("-" + tag if tag else "")


def _run(pkg, invoke, name, inputs, attrs, mode, wrt, head, ctx):
    """Forward (and gradients of the inputs in `wrt`) of one op in one
    package; numpy results."""
    arrays = [pkg.nd.array(x, ctx=ctx, dtype=x.dtype) if ctx is not None
              else pkg.nd.array(x, dtype=x.dtype) for x in inputs]
    if mode == "fwd":
        out = invoke(name, arrays, **attrs)
        outs = out if isinstance(out, tuple) else (out,)
        return [o.asnumpy() for o in outs], []
    idx = range(len(arrays)) if wrt is None else wrt
    for i in idx:
        arrays[i].attach_grad()
    with pkg.autograd.record():
        out = invoke(name, arrays, **attrs)
        outs = out if isinstance(out, tuple) else (out,)
        first = outs[0] * arrays[0] if mode == "compose" else outs[0]
    h = np.ones(first.shape, np.float32) if mode == "loss" \
        else head(first.shape)
    first.backward(pkg.nd.array(h, ctx=ctx) if ctx is not None
                   else pkg.nd.array(h))
    return ([o.asnumpy() for o in outs],
            [arrays[i].grad.asnumpy() for i in idx])


@pytest.mark.parametrize("case", CASES, ids=[_case_id(c) for c in CASES])
def test_op_equals_jax(case):
    name, i = case
    _, make, attrs, mode, tol, wrt = SPECS[name][i]
    inputs = make()
    rng = np.random.RandomState(5)

    def head(shape):
        return rng.uniform(0.5, 1.5, shape).astype(np.float32)

    if name == "_index":
        raise AssertionError("covered by test_index")
    want, want_g = _run(jmx, j_invoke, name, inputs, attrs, mode, wrt, head,
                        None)
    rng = np.random.RandomState(5)
    with mx.cpu():
        got, got_g = _run(mx, t_invoke, name, inputs, attrs, mode, wrt, head,
                          mx.cpu())
    rtol, atol = tol.get("rtol", RTOL), tol.get("atol", ATOL)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape, (g.shape, w.shape)
        # The port keeps 64-bit results where the JAX package, x64 off,
        # narrows them (shape_array, size_array; ROADMAP Queue 3).
        assert g.dtype == w.dtype or (g.dtype, w.dtype) == (
            np.dtype(np.int64), np.dtype(np.int32)), (g.dtype, w.dtype)
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)
    for g, w in zip(got_g, want_g):
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)


def test_index():
    """``_index`` reads a key or the JAX package's wrapper of one."""
    x = _sym(4, 5)
    key = (slice(1, 3), np.array([0, 4, 2]))
    want = np.asarray(jreg.get("_index").fn(jmx.nd.array(x)._data,
                                            key=_Key(key)))
    got = treg.get("_index").fn(torch.from_numpy(x), key=_Key(key))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        treg.get("_index").fn(torch.from_numpy(x), key=key).numpy(), want)


def _jax_names():
    return {n for n, op in jreg.OP_REGISTRY.items()
            if op.fn.__module__.rsplit(".", 1)[-1] in FILES}


def test_every_name_of_the_five_files_is_registered():
    names = _jax_names()
    # 101 names ported by earlier slices, 186 by this one.
    assert len(names) == 287
    missing = sorted(n for n in names if n not in treg.OP_REGISTRY)
    assert not missing, missing
    # The other files' names came with later slices (ctc_loss and its 3
    # aliases; detection's 33; serving's 6 quantization names; linalg's
    # 27 and the contrib tail's 12): the port's registry holds every name
    # of the JAX package's, and none besides.
    assert len(jreg.OP_REGISTRY) == len(treg.OP_REGISTRY) == 397
    assert set(jreg.OP_REGISTRY) == set(treg.OP_REGISTRY)


def test_every_deterministic_name_has_a_case_here():
    rng_names = {n for n in _jax_names() if jreg.get(n).needs_rng}
    assert all(treg.get(n).needs_rng for n in rng_names)
    uncovered = sorted(_jax_names() - rng_names - set(SPECS) - {"_index"})
    assert not uncovered, uncovered
    # Each differentiable op has a gradient case.
    for name, cases in SPECS.items():
        if treg.get(name).differentiable:
            assert any(c[3] != "fwd" for c in cases), name


def test_chip_smoke_sweeps_every_operator_of_the_surface():
    """``chip_smoke.py`` phase 17's tables cover every operator that its
    CORE_SURFACE_NAMES registers, each name one of the five files'."""
    import chip_smoke

    names = set(chip_smoke.CORE_SURFACE_NAMES)
    assert len(names) == len(chip_smoke.CORE_SURFACE_NAMES) == 186
    assert names <= _jax_names()
    ops = {treg.get(n).name for n in names}
    assert len(ops) == 130
    swept = {c.op for c in chip_smoke._surface_cases()}
    drawn = {c[0] for c in chip_smoke._law_cases()}
    assert swept | drawn == ops and not swept & drawn
    assert drawn == {o for o in ops if treg.get(o).needs_rng}
