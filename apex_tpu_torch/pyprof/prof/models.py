"""Per-op FLOP / byte / tensor-core models, the port's copy of
``apex_tpu/pyprof/prof/models.py`` (reference: apex/pyprof/prof/*.py, one
file per op family, collapsed into one registry).

Each model maps an enriched row (shapes/dtypes/params) to (flops, bytes,
mxu_info).  The FLOP and byte counts are the JAX package's, unchanged.
The third column keeps its key, ``mxu``, and models the H100's tensor
cores instead of the TPU's MXU: a matmul-shaped op in bf16 or fp16 is
eligible (fp32 runs outside the tensor cores unless TF32 is allowed,
which the port's comparisons keep off), and its utilisation is the useful
share of the multiply-adds once the output is padded to the 128 x 128
tiles and the contraction to the 64-deep steps (128 bytes of bf16, one
TMA row) in which a Hopper ``wgmma`` GEMM works.
"""
from __future__ import annotations

import math

_DSIZE = {"float32": 4, "bfloat16": 2, "float16": 2, "float64": 8,
          "int32": 4, "int64": 8, "uint8": 1, "int8": 1, "bool": 1}


def _ds(dtype):
    return _DSIZE.get(dtype, 4)


def _numel(shape):
    n = 1
    for d in shape:
        n *= int(d)
    return n


def _pair(v, n=2):
    if isinstance(v, (list, tuple)):
        return list(v) + [v[-1]] * (n - len(v))
    return [v] * n


def _mxu(m, k, n, dtype):
    """Hopper tensor-core tiling model: the (m, n) output padded to 128 x
    128 tiles, the contraction to 64-deep steps.  util = useful MACs /
    padded MACs; 'eligible' is the reference's TC dtype gate (bf16, fp16)."""
    pm = max(128, math.ceil(m / 128) * 128)
    pk = max(64, math.ceil(k / 64) * 64)
    pn = max(128, math.ceil(n / 128) * 128)
    util = (m * k * n) / (pm * pk * pn)
    return {"eligible": dtype in ("bfloat16", "float16"),
            "util": round(util, 3)}


def _gemm_family(row):
    shapes = row["shapes"]
    dtype = (row["dtypes"] or ["float32"])[0]
    op = row["op"]
    if len(shapes) < 2:
        # tape matmul against a non-array operand (plain list rhs lifted by
        # the tape): the rhs shape was not recorded, so no gemm dims exist
        # — degrade to a coarse elementwise estimate instead of crashing
        return _elemwise(row, 2)
    if op == "linear":
        x, w = shapes[0], shapes[1]
        m = _numel(x[:-1])
        k = x[-1]
        n = w[0]
        flops = 2 * m * k * n + (m * n if len(shapes) > 2 else 0)
        bytes_ = (m * k + k * n + m * n) * _ds(dtype)
        return flops, bytes_, _mxu(m, k, n, dtype)
    # matmul: (..., M, K) @ (..., K, N), with matmul's 1-D promotion
    # rules (vector operands gain/drop a unit dim) — reachable with
    # arbitrary ranks now that Tensor.__matmul__ flows through the hook
    a, b = list(shapes[0]), list(shapes[1])
    if len(a) == 1:
        a = [1] + a
    if len(b) == 1:
        b = b + [1]
    # batch dims broadcast between the operands; either side may carry them
    try:
        import numpy as _np
        batch = _numel(_np.broadcast_shapes(tuple(a[:-2]), tuple(b[:-2])))
    except ValueError:
        batch = max(_numel(a[:-2]), _numel(b[:-2]))
    m, k, n = a[-2], a[-1], b[-1]
    flops = 2 * batch * m * k * n
    bytes_ = batch * (m * k + k * n + m * n) * _ds(dtype)
    return flops, bytes_, _mxu(m, k, n, dtype)


def _conv_out(sz, k, s, p, d):
    return (sz + 2 * p - d * (k - 1) - 1) // s + 1


def _conv_family(row):
    shapes = row["shapes"]
    dtype = (row["dtypes"] or ["float32"])[0]
    x, w = shapes[0], shapes[1]
    nd = len(x) - 2
    params = row.get("params", {})
    stride = _pair(params.get("stride", 1), nd)
    pad = _pair(params.get("padding", 0), nd)
    dil = _pair(params.get("dilation", 1), nd)
    groups = int(params.get("groups", 1))
    n = x[0]
    if row["op"] == "conv_transpose2d":
        cin, cout_g = w[0], w[1]
        cout = cout_g * groups
        spatial_out = [s_ * st for s_, st in zip(x[2:], stride)]
        kprod = _numel(w[2:])
        macs = n * cin * _numel(x[2:]) * cout_g * kprod
    else:
        cout, cin_g = w[0], w[1]
        spatial_out = [_conv_out(s_, k_, st, p_, d_) for s_, k_, st, p_, d_
                       in zip(x[2:], w[2:], stride, pad, dil)]
        kprod = _numel(w[2:])
        macs = n * cout * _numel(spatial_out) * cin_g * kprod
        cout_g = cout // groups
        cin = cin_g * groups
    flops = 2 * macs
    out_elems = n * cout * _numel(spatial_out)
    bytes_ = (_numel(x) + _numel(w) + out_elems) * _ds(dtype)
    # im2col view: M = N·prod(out), K = Cin/g·prod(kernel), N = Cout/g
    k_dim = (cin_g if row["op"] != "conv_transpose2d" else cin) * kprod
    n_dim = cout_g if row["op"] == "conv_transpose2d" else cout // groups
    mxu = _mxu(n * _numel(spatial_out), k_dim, n_dim, dtype)
    return flops, bytes_, mxu


_POINTWISE_COST = {"relu": 1, "leaky_relu": 2, "tanh": 4, "sigmoid": 4,
                   "gelu": 8, "dropout": 2, "pad": 1, "flatten": 0,
                   "silu": 5}
_NORM_COST = {"batch_norm": 8, "layer_norm": 8, "group_norm": 8,
              "instance_norm": 8, "fused_layer_norm": 8,
              "fused_layer_norm_affine": 8,
              "fused_rms_norm": 6, "fused_rms_norm_affine": 6}
_SOFTMAX_COST = {"softmax": 5, "log_softmax": 6}
_LOSS_COST = {"cross_entropy": 7, "nll_loss": 2, "mse_loss": 3,
              "l1_loss": 3, "binary_cross_entropy": 6,
              "binary_cross_entropy_with_logits": 8,
              "softmax_cross_entropy_loss": 7}
_OPT_COST = {"FusedAdam": 12, "FusedLAMB": 16, "FusedNovoGrad": 12,
             "FusedSGD": 4, "LARC": 6}

# tape-level Tensor ops (reference prof/{pointwise,reduction,convert,
# index_slice_join_mutate}.py): elementwise arithmetic by cost, reductions
# read-dominated, views free (no data moves), data movement at two passes
_ARITH_COST = {"add": 1, "sub": 1, "rsub": 1, "mul": 1, "div": 1,
               "rdiv": 1, "neg": 1, "abs": 1, "pow": 10, "exp": 8,
               "log": 8, "sqrt": 2}
_REDUCTION_OPS = ("sum", "mean", "max", "min")
_VIEW_OPS = ("reshape", "squeeze")              # a view: free
_MOVE_OPS = ("transpose", "getitem", "getitem_dyn", "astype")


def _broadcast_shape(row):
    """Elementwise broadcast of all recorded operand shapes — the result
    (and the work) follows the broadcast, not either single operand
    (outer-product-style [N,1]*[1,M] produces N*M elements).  Scalars
    broadcast to shape ()."""
    import numpy as _np
    shapes = [tuple(s) for s in row["shapes"] if s is not None]
    if not shapes:
        return []
    try:
        return list(_np.broadcast_shapes(*shapes))
    except ValueError:           # incompatible (shouldn't happen): max side
        return max(shapes, key=_numel)


def _binary_elemwise(row, cost, passes=3):
    n = _numel(_broadcast_shape(row))
    dtype = (row["dtypes"] or ["float32"])[0]
    return cost * n, passes * n * _ds(dtype), None


def _movement(row):
    # bytes follow what actually moves: the output when recorded (getitem
    # of one row out of a big tensor moves the row, not the tensor)
    dtype = (row["dtypes"] or ["float32"])[0]
    out = row.get("out_shape")
    n = _numel(out) if out is not None else _numel(_first_shape(row))
    if row["op"] == "astype":
        ds_out = _ds(row.get("params", {}).get("dtype", dtype))
        return 0, n * (_ds(dtype) + ds_out), None
    return 0, 2 * n * _ds(dtype), None


def _first_shape(row):
    return row["shapes"][0] if row["shapes"] else [0]


def _elemwise(row, cost, passes=2):
    x = _first_shape(row)
    dtype = (row["dtypes"] or ["float32"])[0]
    n = _numel(x)
    return cost * n, passes * n * _ds(dtype), None


def _pool_family(row):
    x = _first_shape(row)
    dtype = (row["dtypes"] or ["float32"])[0]
    k = _pair(row.get("params", {}).get("kernel_size", 2), 2)
    n = _numel(x)
    return _numel(k) * n, 2 * n * _ds(dtype), None


def _embedding(row):
    ids, w = row["shapes"][0], row["shapes"][1]
    dtype = (row["dtypes"] or [None, "float32"])[-1]
    out = _numel(ids) * w[-1]
    return 0, out * _ds(dtype) * 2, None


def _attention_family(row):
    """Fused (flash) attention, (B, H, S, D) operands: QK^T and PV matmuls
    dominate; causal halves the useful area.  Bytes model the flash
    property — q/k/v/out move through HBM, the S^2 score matrix never
    does (the flash kernels keep it on chip)."""
    q, k = row["shapes"][0], row["shapes"][1]
    dtype = (row["dtypes"] or ["float32"])[0]
    b, h, sq, d = q[-4], q[-3], q[-2], q[-1]
    sk = k[-2]
    area = b * h * sq * sk * (0.5 if row.get("params", {}).get("causal")
                              else 1.0)
    flops = 2 * 2 * area * d + 5 * area          # two matmuls + softmax
    bytes_ = b * h * (2 * sq + 2 * sk) * d * _ds(dtype)
    return flops, bytes_, _mxu(sq, d, sk, dtype)


def _optimizer(row):
    name = row["op"].split(".")[1] if "." in row["op"] else row["op"]
    cost = _OPT_COST.get(name, 10)
    numel = _numel(_first_shape(row))
    # read p/g/m(/v), write p/m(/v): ~5 array passes fp32
    return cost * numel, 5 * numel * 4, None


def model_row(row):
    """→ (flops, bytes, mxu_info|None).  Backward rows get the family
    factor: matmul/conv backward = dgrad + wgrad ≈ 2× forward."""
    op = row["op"]
    if op.startswith("optimizer."):
        f, b, m = _optimizer(row)
    elif op in ("linear", "matmul"):
        f, b, m = _gemm_family(row)
    elif op == "flash_attention":
        f, b, m = _attention_family(row)
    elif op.startswith("conv"):
        f, b, m = _conv_family(row)
    elif op in _POINTWISE_COST:
        f, b, m = _elemwise(row, _POINTWISE_COST[op])
    elif op in _NORM_COST:
        f, b, m = _elemwise(row, _NORM_COST[op], passes=3)
    elif op in _SOFTMAX_COST:
        f, b, m = _elemwise(row, _SOFTMAX_COST[op], passes=3)
    elif op in _LOSS_COST:
        f, b, m = _elemwise(row, _LOSS_COST[op], passes=2)
    elif op.endswith("pool2d"):
        f, b, m = _pool_family(row)
    elif op == "embedding":
        f, b, m = _embedding(row)
    elif op in _ARITH_COST:
        f, b, m = _binary_elemwise(row, _ARITH_COST[op])
    elif op in _REDUCTION_OPS:
        f, b, m = _elemwise(row, 1, passes=1)
    elif op in _VIEW_OPS:
        f, b, m = 0, 0, None
    elif op in _MOVE_OPS:
        f, b, m = _movement(row)
    else:
        f, b, m = _elemwise(row, 1)
    if row.get("dir") == "bwd":
        if op == "flash_attention":
            # dq + dk + dv plus the in-kernel score recompute
            factor = 2.5
        elif op in ("linear", "matmul") or op.startswith("conv"):
            factor = 2
        else:
            factor = 1
        f, b = f * factor, b * factor
    return f, b, m
