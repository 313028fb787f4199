"""The O1 cast policy's op tables, the port's own copy of
``apex_tpu/amp/lists/op_categories.py``, under the same names and with the
same entries.  The names are the JAX package's op vocabulary (the ops of
its ``nn/functional.py`` and its tape's operators); the port maps
each torch callable onto one of them (``amp/policy.py``, ``TORCH_OPS``).

* ``FP16_FUNCS``: convolutions and matmul-shaped ops, run in the half
  dtype;
* ``FP32_FUNCS``: softmax, normalisation, losses, transcendental
  pointwise ops and reductions, run in fp32;
* ``CASTS``: multi-argument ops, run in the widest float type among
  their arguments;
* ``SEQUENCE_CASTS``: ``cat`` and ``stack``, likewise over their list;
* ``BANNED_FUNCS``: ``binary_cross_entropy`` raises under O1 unless
  ``allow_banned``.
"""

FP16_FUNCS = [
    "conv1d", "conv2d", "conv3d",
    "conv_transpose1d", "conv_transpose2d", "conv_transpose3d",
    "linear", "matmul", "mm", "bmm", "addmm", "einsum", "dot_general",
    "prelu",
    "mlp",
]

FP32_FUNCS = [
    # pointwise transcendentals
    "softplus", "softmin", "log_softmax", "softmax", "gelu",
    "acos", "asin", "cosh", "erfinv", "exp", "expm1",
    "log", "log10", "log2", "reciprocal", "rsqrt", "sinh", "tan", "pow",
    # normalization
    "layer_norm", "group_norm", "instance_norm", "batch_norm",
    "local_response_norm", "normalize", "cosine_similarity",
    # losses
    "cross_entropy", "nll_loss", "l1_loss", "mse_loss", "smooth_l1_loss",
    "kl_div", "poisson_nll_loss", "cosine_embedding_loss",
    "hinge_embedding_loss", "margin_ranking_loss", "multilabel_margin_loss",
    "multilabel_soft_margin_loss", "multi_margin_loss",
    "binary_cross_entropy_with_logits", "soft_margin_loss",
    "triplet_margin_loss", "ctc_loss",
    # reductions
    "cumprod", "cumsum", "dist", "norm", "prod", "std", "sum", "var",
    "renorm",
]

CASTS = [
    "addcdiv", "addcmul", "atan2", "cross", "bilinear", "dot",
    "add", "div", "mul",
    "eq", "equal", "ge", "gt", "le", "lt", "ne",
]

SEQUENCE_CASTS = ["cat", "stack", "concatenate"]

BANNED_FUNCS = [
    ("binary_cross_entropy",
     ("\namp does not work out-of-the-box with `binary_cross_entropy`. "
      "It requires that the output of the previous function be already a "
      "float tensor. \n\nMost models have a Sigmoid right before BCELoss. "
      "In that case, you can use\n    binary_cross_entropy_with_logits\nto "
      "combine Sigmoid+BCELoss into a single layer that is compatible with "
      "amp.\nAnother option is to add\n    amp.register_float_function(...)\n"
      "before calling `amp.init()`.\nIf you _really_ know what you are "
      "doing, you can disable this error by passing allow_banned=True to "
      "`amp.init()`.")),
]
