"""The port's callables take the JAX package's keyword arguments.

For each callable of the port that has a JAX twin on this slice's paths
(the models, the attention module and functions, the flash kernels'
wrappers, the LAMB optimizer and op, the data-parallel surface, the legacy
amp and fp16_utils API, O1's registry, the GAN step, NovoGrad, the contrib
optimizers, the MLP, the reparameterizations, encoder-decoder attention,
the seq2seq and ViT families, ``checkpoint_forward``, the RNNs, the HF
converters, the runtime's executor and prefetcher, ``amp.initialize``,
the observe runtime, the kernel ledger and tier decision and pyprof,
cluster membership, the elastic serve fleet, the rollout loop, tensor
parallelism and ring / Ulysses attention),
every parameter of the JAX signature exists in the port's with the same default
(a dtype default by its name); the port may add ``device``, ``dtype`` and
``generator`` parameters, a JAX PRNG ``key`` is the port's ``generator``,
and the kernels' ``interpret`` switch and the JAX modules' ``ctx`` have no
counterpart.  A value other than the default of an argument that asks for
something not ported yet (experts, sharded decode, a mesh axis no entered
mesh names, the planner) raises ``NotImplementedError`` naming the ROADMAP
item that owns it; ``remat=True`` and the tensor- and sequence-parallel
arguments build.
"""
import inspect

import pytest
import torch

import apex_tpu.RNN as jax_rnn
import apex_tpu.contrib.multihead_attn as jax_mha
import apex_tpu.contrib.multihead_attn.attn_funcs as jax_attn_funcs
import apex_tpu.kernels.attention as jax_attention
import apex_tpu.models.bert as jax_bert
import apex_tpu.models.gpt as jax_gpt
import apex_tpu.models.llama as jax_llama
import apex_tpu.models.seq2seq as jax_seq2seq
import apex_tpu.models.vit as jax_vit
import apex_tpu.contrib.groupbn as jax_groupbn
import apex_tpu.contrib.optimizers as jax_contrib_optimizers
import apex_tpu.mlp as jax_mlp
import apex_tpu.reparameterization as jax_reparam
import apex_tpu.nn as jax_nn
import apex_tpu.nn.functional as jax_F
import apex_tpu.ops.multi_tensor as jax_ops
import apex_tpu.optimizers as jax_optimizers
import apex_tpu.amp as jax_amp
import apex_tpu.amp.handle as jax_handle
import apex_tpu.amp.opt as jax_opt
import apex_tpu.amp.policy as jax_policy
import apex_tpu.fp16_utils as jax_fp16_utils
import apex_tpu.parallel as jax_parallel
import apex_tpu.parallel.distributed as jax_distributed
import apex_tpu.parallel.tensor_parallel as jax_tensor_parallel
import apex_tpu.training as jax_training
import apex_tpu.models.hf as jax_hf
import apex_tpu.runtime as jax_runtime
import apex_tpu.runtime.executor as jax_executor
import apex_tpu.inference as jax_inference
import apex_tpu.inference.draft as jax_draft
import apex_tpu.inference.rolling as jax_rolling
import apex_tpu.utils.jit_cache as jax_jit_cache
import apex_tpu.serve as jax_serve
import apex_tpu.serve.kernels as jax_serve_kernels
import apex_tpu.serve.pool as jax_serve_pool
import apex_tpu.kernels.spec_verify as jax_spec_verify
import apex_tpu.observe.registry as jax_registry
import apex_tpu.observe as jax_observe
import apex_tpu.kernels.dispatch as jax_dispatch
import apex_tpu.kernels.ledger as jax_ledger
import apex_tpu.pyprof as jax_pyprof
import apex_tpu.pyprof.parse.trace as jax_pp_trace
import apex_tpu.runtime.step_cache as jax_step_cache
import apex_tpu.cluster as jax_cluster
import apex_tpu.rollout as jax_rollout

import apex_tpu_torch.RNN as rnn
import apex_tpu_torch.amp as amp
import apex_tpu_torch.amp.handle as handle
import apex_tpu_torch.amp.opt as opt
import apex_tpu_torch.amp.policy as policy
import apex_tpu_torch.contrib.multihead_attn as mha
import apex_tpu_torch.fp16_utils as fp16_utils
import apex_tpu_torch.training as training
import apex_tpu_torch.contrib.multihead_attn.attn_funcs as attn_funcs
import apex_tpu_torch.kernels.attention as attention
import apex_tpu_torch.models.bert as bert
import apex_tpu_torch.models.gpt as gpt
import apex_tpu_torch.models.llama as llama
import apex_tpu_torch.models.seq2seq as seq2seq
import apex_tpu_torch.models.vit as vit
import apex_tpu_torch.contrib.groupbn as groupbn
import apex_tpu_torch.contrib.optimizers as contrib_optimizers
import apex_tpu_torch.mlp as mlp
import apex_tpu_torch.reparameterization as reparam
import apex_tpu_torch.nn as nn
import apex_tpu_torch.nn.functional as F
import apex_tpu_torch.ops.multi_tensor as ops
import apex_tpu_torch.optimizers as optimizers
import apex_tpu_torch.parallel as parallel
import apex_tpu_torch.parallel.distributed as distributed
import apex_tpu_torch.parallel.tensor_parallel as tensor_parallel
from apex_tpu_torch.training import make_train_step
import apex_tpu_torch.models.hf as hf
import apex_tpu_torch.runtime as runtime
import apex_tpu_torch.runtime.executor as executor
import apex_tpu_torch.inference as inference
import apex_tpu_torch.inference.draft as draft
import apex_tpu_torch.inference.rolling as rolling
import apex_tpu_torch.utils.jit_cache as jit_cache
import apex_tpu_torch.serve as serve
import apex_tpu_torch.serve.kernels as serve_kernels
import apex_tpu_torch.serve.pool as serve_pool
import apex_tpu_torch.kernels.spec_verify as spec_verify
import apex_tpu_torch.observe as observe
import apex_tpu_torch.observe.registry as registry
import apex_tpu_torch.kernels.dispatch as dispatch
import apex_tpu_torch.kernels.ledger as ledger
import apex_tpu_torch.pyprof as pyprof
import apex_tpu_torch.pyprof.parse.trace as pp_trace
import apex_tpu_torch.runtime.step_cache as step_cache
import apex_tpu_torch.cluster as cluster
import apex_tpu_torch.rollout as rollout

torch.set_num_threads(2)

PAIRS = [
    (jax_gpt, gpt, "GptModel"), (jax_gpt, gpt, "GptBlock"),
    (jax_llama, llama, "LlamaModel"), (jax_llama, llama, "LlamaBlock"),
    (jax_bert, bert, "BertLayer"), (jax_bert, bert, "BertModel"),
    (jax_bert, bert, "bert_base"), (jax_bert, bert, "bert_large"),
    (jax_mha, mha, "SelfMultiheadAttn"),
    (jax_attn_funcs, attn_funcs, "flash_attention"),
    (jax_attn_funcs, attn_funcs, "attention_reference"),
    (jax_attention, attention, "flash_attention_fwd"),
    (jax_attention, attention, "flash_attention_bwd"),
    (jax_attention, attention, "dropout_keep_reference"),
    (jax_optimizers, optimizers, "FusedLAMB"),
    (jax_ops, ops, "multi_tensor_lamb"),
    (jax_distributed, distributed, "DistributedDataParallel"),
    (jax_distributed, distributed, "Reducer"),
    (jax_distributed, distributed, "all_reduce_mean"),
    (jax_parallel, parallel, "SyncBatchNorm"),
    (jax_parallel, parallel, "convert_syncbn_model"),
    (jax_parallel, parallel, "ZeroTrainStep"),
    (jax_parallel, parallel, "zero_state_sharding"),
    *((jax_parallel, parallel, f)
      for f in ("ColumnParallelLinear", "RowParallelLinear",
                "column_parallel_linear", "row_parallel_linear",
                "vocab_parallel_cross_entropy", "vocab_parallel_embedding",
                "vocab_parallel_logits", "ring_attention",
                "ulysses_attention")),
    *((jax_tensor_parallel, tensor_parallel, f)
      for f in ("copy_to_tp_region", "reduce_from_tp_region", "tp_ffn",
                "tp_attn_begin")),
    (jax_attn_funcs, attn_funcs, "self_attn_func"),
    (jax_F, F, "batch_norm"), (jax_F, F, "conv2d"), (jax_F, F, "max_pool2d"),
    (jax_F, F, "avg_pool2d"), (jax_F, F, "adaptive_avg_pool2d"),
    (jax_nn, nn, "to_channels_last"),
    (jax_groupbn, groupbn, "BatchNorm2d_NHWC"),
    (jax_amp, amp, "init"), (jax_handle, handle, "AmpHandle"),
    (jax_opt, opt, "OptimWrapper"), (jax_policy, policy, "CastPolicy"),
    (jax_policy, policy, "register_half_function"),
    (jax_policy, policy, "register_float_function"),
    (jax_policy, policy, "register_promote_function"),
    (jax_fp16_utils, fp16_utils, "FP16_Optimizer"),
    (jax_fp16_utils, fp16_utils, "network_to_half"),
    (jax_fp16_utils, fp16_utils, "prep_param_lists"),
    (jax_training, training, "make_gan_train_step"),
    (jax_optimizers, optimizers, "FusedNovoGrad"),
    (jax_ops, ops, "multi_tensor_novograd"),
    (jax_contrib_optimizers, contrib_optimizers, "FusedAdam"),
    (jax_contrib_optimizers, contrib_optimizers, "FusedLAMB"),
    (jax_contrib_optimizers, contrib_optimizers, "FP16_Optimizer"),
    (jax_contrib_optimizers.FusedAdam, contrib_optimizers.FusedAdam, "step"),
    (jax_mlp, mlp, "MLP"), (jax_mlp, mlp, "mlp_function"),
    (jax_reparam, reparam, "apply_weight_norm"),
    (jax_reparam, reparam, "remove_weight_norm"),
    (jax_reparam, reparam, "apply_reparameterization"),
    (jax_reparam, reparam, "remove_reparameterization"),
    (jax_reparam, reparam, "apply_lora"),
    (jax_reparam, reparam, "lora_parameters"),
    (jax_reparam, reparam, "WeightNorm"), (jax_reparam, reparam, "LoRA"),
    (jax_reparam.Reparameterization, reparam.Reparameterization, "apply"),
    (jax_reparam.Reparameterization, reparam.Reparameterization,
     "get_module_and_name"),
    (jax_reparam.Reparameterization, reparam.Reparameterization, "remove"),
    (jax_mha, mha, "EncdecMultiheadAttn"),
    (jax_attn_funcs, attn_funcs, "encdec_attn_func"),
    (jax_seq2seq, seq2seq, "Seq2SeqDecoderLayer"),
    (jax_seq2seq, seq2seq, "TransformerSeq2Seq"),
    (jax_seq2seq, seq2seq, "transformer_seq2seq"),
    (jax_seq2seq, seq2seq, "seq2seq_generate"),
    (jax_vit, vit, "VitBlock"), (jax_vit, vit, "VitModel"),
    (jax_vit, vit, "vit_small"), (jax_vit, vit, "vit_base"),
    (jax_nn, nn, "checkpoint_forward"),
    (jax_rnn, rnn, "LSTM"), (jax_rnn, rnn, "GRU"), (jax_rnn, rnn, "ReLU"),
    (jax_rnn, rnn, "Tanh"), (jax_rnn, rnn, "mLSTM"),
    (jax_rnn, rnn, "mLSTMRNNCell"), (jax_rnn, rnn, "RNNCell"),
    (jax_rnn, rnn, "stackedRNN"), (jax_rnn, rnn, "bidirectionalRNN"),
    (jax_rnn.models, rnn.models, "toRNNBackend"),
    (jax_hf, hf, "gpt2_from_hf"), (jax_hf, hf, "llama_from_hf"),
    (jax_hf, hf, "gpt2_to_hf_state_dict"),
    (jax_hf, hf, "llama_to_hf_state_dict"), (jax_hf, hf, "mixtral_from_hf"),
    (jax_hf, hf, "resnet_from_torch"),
    (jax_runtime, runtime, "DataPrefetcher"),
    (jax_runtime, runtime, "Program"),
    (jax_runtime, runtime, "set_overlap"),
    (jax_runtime, runtime, "overlap_enabled"),
    (jax_runtime.Executor, runtime.Executor, "submit"),
    (jax_runtime.Executor, runtime.Executor, "compile"),
    (jax_runtime.Executor, runtime.Executor, "drive"),
    (jax_executor, executor, "DonationPolicy"),
    (jax_executor, executor, "drain_telemetry"),
    (jax_amp, amp, "initialize"),
    (jax_gpt, gpt, "generate"), (jax_gpt, gpt, "make_sampler"),
    (jax_inference, inference, "beam_generate"),
    (jax_inference, inference, "speculative_generate"),
    (jax_inference, inference, "DecodeSession"),
    (jax_inference.DecodeSession, inference.DecodeSession, "generate"),
    (jax_inference.DecodeSession, inference.DecodeSession, "append"),
    (jax_inference, inference, "PagedSession"),
    (jax_inference, inference, "make_self_draft"),
    (jax_inference, inference, "train_draft"),
    (jax_draft, draft, "make_distill_step"),
    (jax_draft, draft, "DistillStep"),
    (jax_inference, inference, "quantize_int8"),
    (jax_inference, inference, "quantize_tensor_int8"),
    (jax_inference, inference, "absmax_int8"),
    (jax_inference, inference, "gather_rows"),
    (jax_inference, inference, "make_kv_cache"),
    (jax_inference, inference, "kv_write"),
    (jax_inference, inference, "kv_value"),
    (jax_rolling, rolling, "rolling_slot_positions"),
    (jax_rolling, rolling, "window_retired_blocks"),
    (jax_rolling, rolling, "rolling_kv_write"),
    (jax_jit_cache, jit_cache, "compiled_run_cache"),
    (jax_serve, serve, "ServeEngine"),
    *((jax_serve.ServeEngine, serve.ServeEngine, m)
      for m in ("run", "step", "submit", "submit_recompute", "evict_session",
                "publish_weights", "ingest_handoff", "harvest_ready",
                "release_handoff", "metrics", "close")),
    (jax_serve, serve, "DisaggregatedEngine"),
    (jax_serve.DisaggregatedEngine, serve.DisaggregatedEngine, "run"),
    (jax_serve, serve, "ServeFleet"), (jax_serve, serve, "FleetMember"),
    (jax_serve, serve, "Scheduler"), (jax_serve, serve, "Request"),
    *((jax_serve.Scheduler, serve.Scheduler, m)
      for m in ("submit_recompute", "admit", "grow", "evict", "preempt_for",
                "note_commit", "retire_window_blocks", "pack_decode",
                "pack_spec")),
    (jax_serve, serve, "BlockPool"),
    *((jax_serve.BlockPool, serve.BlockPool, m)
      for m in ("alloc", "free", "acquire_prefix")),
    (jax_serve, serve, "init_pool_buffer"), (jax_serve, serve, "blocks_for"),
    (jax_serve, serve, "bucket"),
    (jax_serve_pool, serve_pool, "chain_key"),
    (jax_serve_pool, serve_pool, "chain_keys"),
    *((jax_serve_kernels, serve_kernels, f)
      for f in ("gather_pool", "scatter_pool", "insert_row",
                "build_block_copy_fn", "build_decode_fn", "build_prefill_fn",
                "build_spec_verify_fn")),
    (jax_spec_verify, spec_verify, "spec_verify_fp"),
    (jax_inference.PagedSession, inference.PagedSession, "append"),
    (jax_inference.PagedSession, inference.PagedSession, "generate"),
    (jax_registry, registry, "MetricsRegistry"),
    (jax_registry.MetricsRegistry, registry.MetricsRegistry, "event"),
    (jax_registry.MetricsRegistry, registry.MetricsRegistry, "events"),
    (jax_registry, registry, "event"), (jax_registry, registry, "events"),
    (jax_training, training, "make_train_step"),
    (jax_training.TrainStep, training.TrainStep, "drain_telemetry"),
    *((jax_observe, observe, f)
      for f in ("span", "last_span", "StallWatchdog", "heartbeat",
                "last_heartbeat", "init_telemetry", "accumulate",
                "describe", "catalog_names")),
    (jax_step_cache, step_cache, "set_dispatch_spans"),
    (jax_ledger, ledger, "Ledger"), (jax_ledger, ledger, "default_path"),
    (jax_ledger, ledger, "chip_name"), (jax_ledger, ledger, "set_path"),
    *((jax_ledger.Ledger, ledger.Ledger, m)
      for m in ("record_kernel", "lookup_kernel", "kernel_entries",
                "record_plan", "plan_measurements", "ingest_events")),
    *((jax_dispatch, dispatch, f)
      for f in ("decide", "register_kernel", "measured_threshold",
                "attention_fp", "multi_tensor_fp", "vocab_chain_fp",
                "KernelSpec", "Decision")),
    *((jax_pyprof, pyprof, f)
      for f in ("profile_step", "capture", "save", "analyze")),
    (jax_pp_trace, pp_trace, "merge_measurements"),
    *((jax_serve.ServeFleet, serve.ServeFleet, m)
      for m in ("join", "submit", "step", "run", "assignments", "slo_of",
                "metrics", "close")),
    *((jax_cluster, cluster, f)
      for f in ("MemoryKV", "FileKV", "JaxCoordinatorKV", "default_kv",
                "Member", "MembershipView", "current_view", "current_epoch",
                "Coordinator", "ClusterTrainer", "SimClock", "SimHost",
                "beat_and_scan", "fleet_for_members",
                "spawn_member_process")),
    *((jax_cluster.Member, cluster.Member, m)
      for m in ("join", "leave", "beat", "ack", "latest_view")),
    *((jax_cluster.Coordinator, cluster.Coordinator, m)
      for m in ("registered", "scan", "acked")),
    *((jax_rollout, rollout, f)
      for f in ("RolloutBuffer", "RolloutSample", "OnlineDistiller",
                "WeightPublisher", "master_leaves", "RolloutRuntime")),
    *((jax_rollout.RolloutBuffer, rollout.RolloutBuffer, m)
      for m in ("push", "ages", "staleness_p50", "evict_stale",
                "sample_batch", "state_dict", "load_state_dict")),
    *((jax_rollout.WeightPublisher, rollout.WeightPublisher, m)
      for m in ("publish", "restore")),
    *((jax_rollout.OnlineDistiller, rollout.OnlineDistiller, m)
      for m in ("train_on", "publish")),
    *((jax_rollout.RolloutRuntime, rollout.RolloutRuntime, m)
      for m in ("run_round", "run", "save", "restore")),
]
NO_COUNTERPART = {"interpret", "ctx"}
# a JAX parameter the port takes under another name, with the same default
RENAMED = {"key": "generator"}


def _default_key(value):
    """A default as compared across the packages: a dtype by its name
    (``jnp.bfloat16`` is ``torch.bfloat16``), a class of either package
    by its name, a bare ``object()`` sentinel as one, anything else as it
    is."""
    if isinstance(value, torch.dtype):
        return ("dtype", str(value).replace("torch.", ""))
    if type(value) is object:
        # a module's own "not given" sentinel (the executor's _UNSET)
        return ("unset",)
    if isinstance(value, type) and hasattr(value, "dtype"):
        import jax.numpy as jnp
        return ("dtype", jnp.dtype(value).name)
    if isinstance(value, type) and value.__module__.split(".")[0] in (
            "apex_tpu", "apex_tpu_torch"):
        # a class of either package by its name (Reparameterization)
        return ("class", value.__qualname__)
    return value


def _ids(pairs):
    """``module.name``, with the module's path in the port where two
    modules share their last name (``optimizers`` and
    ``contrib.optimizers``)."""
    out = []
    for _, mod, name in pairs:
        short = f"{mod.__name__.split('.')[-1]}.{name}"
        out.append(short if short not in out else
                   f"{mod.__name__.replace('apex_tpu_torch.', '')}.{name}")
    return out


@pytest.mark.parametrize("jax_mod,port_mod,name", PAIRS, ids=_ids(PAIRS))
def test_every_jax_parameter_exists_with_its_default(jax_mod, port_mod, name):
    want = inspect.signature(getattr(jax_mod, name)).parameters
    got = inspect.signature(getattr(port_mod, name)).parameters
    for pname, param in want.items():
        if pname in NO_COUNTERPART or pname.startswith("_"):
            continue
        pname = RENAMED.get(pname, pname)
        assert pname in got, f"{name}: no parameter {pname!r}"
        assert _default_key(got[pname].default) == _default_key(
            param.default), \
            f"{name}({pname}=...): default {got[pname].default!r} != " \
            f"{param.default!r}"


SMALL_GPT = dict(vocab_size=16, hidden=16, layers=1, heads=2,
                 max_positions=8, device="cpu")
SMALL_BERT = dict(vocab_size=16, hidden=16, layers=1, heads=2,
                  intermediate=32, max_positions=8, device="cpu")
A9 = "ROADMAP A9"

REFUSED = [
    (lambda **kw: gpt.GptModel(**SMALL_GPT, **kw).init_caches(1, 8),
     dict(tp_axis="model"), A9),
    (lambda **kw: gpt.GptModel(**SMALL_GPT, **kw).init_caches(1, 8),
     dict(sp_axis="seq"), A9),
    (lambda **kw: gpt.GptModel(**SMALL_GPT, **kw), dict(moe_axis="data"),
     A9),
    (lambda **kw: gpt.GptModel(**SMALL_GPT, **kw), dict(moe_num_experts=4),
     A9),
    (lambda **kw: gpt.GptModel(**SMALL_GPT, **kw), dict(moe_every=1), A9),
    (lambda **kw: gpt.GptModel(**SMALL_GPT, **kw),
     dict(moe_capacity_factor=2.0), A9),
    (lambda **kw: gpt.GptModel(**SMALL_GPT, **kw), dict(moe_top_k=2), A9),
    (lambda **kw: gpt.GptModel(**SMALL_GPT, **kw), dict(moe_aux_weight=0.1),
     A9),
    (lambda **kw: seq2seq.seq2seq_generate(
        seq2seq.TransformerSeq2Seq(vocab_size=16, hidden=16, enc_layers=1,
                                   dec_layers=1, heads=2, max_positions=8,
                                   device="cpu", **kw),
        torch.zeros((1, 4), dtype=torch.long), 2), dict(tp_axis="model"),
     A9),
    (lambda **kw: llama.LlamaModel(**SMALL_GPT, **kw).init_caches(1, 8),
     dict(tp_axis="model"), A9),
    (lambda **kw: llama.LlamaModel(**SMALL_GPT, **kw),
     dict(moe_num_experts=4), A9),
    (lambda **kw: llama.LlamaModel(**SMALL_GPT, **kw), dict(moe_every=1),
     A9),
    (lambda **kw: llama.LlamaModel(**SMALL_GPT, **kw),
     dict(moe_capacity_factor=2.0), A9),
    (lambda **kw: llama.LlamaModel(**SMALL_GPT, **kw), dict(moe_top_k=2),
     A9),
    (lambda **kw: llama.LlamaModel(**SMALL_GPT, **kw),
     dict(moe_aux_weight=0.1), A9),
    (lambda **kw: llama.LlamaModel(**SMALL_GPT, **kw).init_caches(1, 8),
     dict(sp_axis="seq"), A9),
    (lambda **kw: distributed.all_reduce_mean([torch.zeros(2)], **kw),
     dict(mesh="a mesh"), A9),
    (lambda **kw: distributed.Reducer([torch.zeros(2)], **kw),
     dict(mesh="a mesh"), A9),
    (lambda **kw: distributed.DistributedDataParallel(
        torch.nn.Linear(2, 2), **kw), dict(mesh="a mesh"), A9),
    (lambda **kw: parallel.SyncBatchNorm(4, **kw), dict(axis_name="batch"),
     A9),
    (lambda **kw: parallel.convert_syncbn_model(torch.nn.BatchNorm2d(4),
                                                **kw),
     dict(axis_name="batch"), A9),
    (lambda **kw: F.batch_norm(torch.zeros(2, 3, 4), None, None,
                               training=True, **kw),
     dict(axis_name="data"), A9),
    (lambda **kw: F.batch_norm(torch.zeros(2, 3, 4), None, None,
                               training=True, **kw),
     dict(axis_index_groups=[[0]]), A9),
    (lambda **kw: groupbn.BatchNorm2d_NHWC(4, device="cpu", **kw),
     dict(axis_name="batch"), A9),
    (lambda **kw: seq2seq.seq2seq_generate(
        seq2seq.TransformerSeq2Seq(vocab_size=16, hidden=16, enc_layers=1,
                                   dec_layers=1, heads=2, max_positions=8,
                                   device="cpu"),
        torch.zeros((1, 4), dtype=torch.long), 2, **kw),
     dict(mesh="a mesh"), A9),
    (lambda **kw: gpt.generate(
        gpt.GptModel(**SMALL_GPT), torch.zeros((1, 2), dtype=torch.long), 2,
        **kw), dict(mesh="a mesh"), A9),
    (lambda **kw: inference.beam_generate(
        gpt.GptModel(**SMALL_GPT), torch.zeros((1, 2), dtype=torch.long), 2,
        2, **kw), dict(mesh="a mesh"), A9),
    (lambda **kw: inference.speculative_generate(
        gpt.GptModel(**SMALL_GPT), gpt.GptModel(**SMALL_GPT),
        torch.zeros((1, 2), dtype=torch.long), 2, k=1, **kw),
     dict(mesh="a mesh"), A9),
    (lambda **kw: parallel.ZeroTrainStep(_linear_step(), None, **kw),
     dict(plan="a plan"), A9),
    (lambda **kw: runtime.Program("train_step", (), lambda: None, **kw),
     dict(wrap=lambda f: f), A9),
    (lambda **kw: runtime.Program("train_step", (), lambda: None, **kw),
     dict(in_shardings=None), A9),
    (lambda **kw: training.make_train_step(*_linear_parts(), **kw),
     dict(axis_name="model"), A9),
    (lambda **kw: observe.accumulate(
        observe.init_telemetry(device="cpu"), loss=None, master_grads=[],
        flag=None, loss_scale=1.0, **kw), dict(mean_axes=("model",)), A9),
]


def _linear_parts():
    lin = torch.nn.Linear(2, 2)
    return lin, optimizers.FusedAdam(list(lin.parameters())), \
        lambda out, *_: out.float().mean()


def _linear_step():
    return training.make_train_step(*_linear_parts())


@pytest.mark.parametrize("make,kw,owner", REFUSED,
                         ids=[f"{i}-{next(iter(r[1]))}"
                              for i, r in enumerate(REFUSED)])
def test_non_default_values_are_refused_naming_their_owner(make, kw, owner):
    with pytest.raises(NotImplementedError, match=owner) as info:
        make(**kw)
    assert next(iter(kw)) in str(info.value)


WATCHED = [
    lambda: serve.ServeEngine(gpt.GptModel(**SMALL_GPT), num_blocks=4,
                              block_size=4),
    lambda: serve.DisaggregatedEngine(gpt.GptModel(**SMALL_GPT),
                                      num_blocks=4, block_size=4),
]


@pytest.mark.parametrize("make", WATCHED, ids=["ServeEngine",
                                               "DisaggregatedEngine"])
def test_engines_run_under_the_stall_watchdog(make):
    """``run(watchdog_deadline_s=...)``, once refused naming A8, arms a
    stall watchdog over the loop (``apex_tpu_torch.observe``) and stops it
    after: an empty trace serves nothing and reports no stall."""
    obs = observe.get_registry()
    obs.clear_events()
    assert make().run([], watchdog_deadline_s=1.0) == {}
    assert obs.events("watchdog.stall") == []


def test_defaults_are_accepted():
    """The JAX package's own calls at the defaults (the bench's GPT build
    passes ``remat=remat``) construct the port's modules."""
    jax_kw = dict(remat=False, sp_axis=None, tp_axis=None, tp_vocab=False,
                  moe_axis=None, moe_num_experts=None, moe_every=2,
                  moe_capacity_factor=1.25, moe_top_k=1, moe_aux_weight=0.01)
    assert isinstance(gpt.GptModel(**SMALL_GPT, **jax_kw), gpt.GptModel)
    llama_kw = {k: v for k, v in jax_kw.items() if k != "tp_vocab"}
    assert isinstance(llama.LlamaModel(**SMALL_GPT, **llama_kw),
                      llama.LlamaModel)
    assert isinstance(bert.BertModel(**SMALL_BERT, remat=False, sp_axis=None,
                                     tp_axis=None), bert.BertModel)
    mha.SelfMultiheadAttn(16, 2, seq_parallel_axis=None,
                          seq_parallel_impl="ring",
                          tensor_parallel_axis=None, device="cpu")
    for axis_name in ("data", None):
        parallel.SyncBatchNorm(4, axis_name=axis_name)
        parallel.convert_syncbn_model(torch.nn.BatchNorm1d(4),
                                      axis_name=axis_name)
    x = torch.randn(4, 3, 5)
    y, _, _ = F.batch_norm(x, None, None, training=True, axis_name=None,
                           axis_index_groups=None, return_stats=False,
                           channel_axis=-2)
    torch.testing.assert_close(y, torch.nn.functional.batch_norm(
        x, None, None, training=True))


def test_refusal_messages_name_the_current_roadmap_items():
    """The owners named in the refusals follow ROADMAP's queue A as it is
    numbered now (parallelism, the planner and elastic training A9); remat,
    once A4's, inference, once A5's, the serve engine, once A6's, observe
    and telemetry, once A8's, and the elastic serve fleet and cluster
    membership, once A10's, are ported and build."""
    small = dict(SMALL_GPT)
    with pytest.raises(NotImplementedError,
                       match="ROADMAP A9, second part: decode under a mesh"):
        llama.LlamaModel(**small, tp_axis="model").init_caches(1, 8)
    with pytest.raises(NotImplementedError,
                       match="mixture of experts.*ROADMAP A9, second part: "
                             "experts"):
        llama.LlamaModel(**small, moe_axis="data")
    for call in (lambda: gpt.generate(gpt.GptModel(**small), torch.zeros(
            (1, 2), dtype=torch.long), 2, mesh="a mesh"),
                 lambda: seq2seq.seq2seq_generate(
                     seq2seq.TransformerSeq2Seq(
                         vocab_size=16, hidden=16, enc_layers=1,
                         dec_layers=1, heads=2, max_positions=8,
                         device="cpu"),
                     torch.zeros((1, 4), dtype=torch.long), 2,
                     mesh="a mesh")):
        with pytest.raises(NotImplementedError,
                           match="ROADMAP A9, second part: decode under a "
                                 "mesh"):
            call()
    with pytest.raises(NotImplementedError,
                       match="ROADMAP A9, second part: experts"):
        hf.mixtral_from_hf({})
    # A9's second part's first half is ported: the tensor- and
    # sequence-parallel arguments build, and their axes resolve through an
    # entered mesh (an axis no mesh names raises)
    for kw in (dict(tp_axis="model"), dict(sp_axis="seq"),
               dict(tp_axis="model", tp_vocab=True)):
        assert gpt.GptModel(**small, **kw).tp_sharded_params()
    for kw in (dict(tp_axis="model"), dict(sp_axis="seq")):
        assert llama.LlamaModel(**small, **kw).tp_sharded_params()
    assert bert.BertModel(**SMALL_BERT, tp_axis="model",
                          sp_axis="seq").tp_sharded_params()
    assert mha.SelfMultiheadAttn(16, 2, seq_parallel_axis="seq",
                                 seq_parallel_impl="ulysses",
                                 tensor_parallel_axis="model",
                                 device="cpu").tensor_parallel_axis \
        == "model"
    with pytest.raises(NotImplementedError, match="no entered mesh"):
        gpt.GptModel(**small, tp_axis="model")(
            torch.zeros((1, 4), dtype=torch.long))
    assert llama.LlamaModel(**small, remat=True).remat
    # cached decode with the band is ported (A5): rolling caches, no
    # refusal; the paged session over the serve engine is ported (A6)
    banded = llama.LlamaModel(**small, sliding_window=4)
    assert banded.init_caches(1, 8)[0][0].shape[2] == 8
    eng = serve.ServeEngine(gpt.GptModel(**small), num_blocks=4,
                            block_size=4)
    assert inference.PagedSession(eng).block_table == ()
    # the elastic serve fleet and the cluster are ported (A10); the
    # cluster trainer and the planner's fleet are A9's; observe is ported
    # (A8)
    with serve.ServeFleet(gpt.GptModel(**small), n_engines=2,
                          num_blocks=8, block_size=4) as fleet:
        assert fleet.join().members == ("serve0", "serve1")
        member = fleet.members["serve0"]
        assert isinstance(member, serve.FleetMember)
        assert serve.FleetMember(member.member, eng).engine is eng
    with pytest.raises(NotImplementedError, match="ROADMAP A9"):
        cluster.ClusterTrainer("/nonexistent", None, None, None,
                               example_batch=None)
    with pytest.raises(NotImplementedError, match="ROADMAP A9"):
        cluster.fleet_for_members(cluster.MemoryKV(), ["host0"])
    assert issubclass(serve.StaleEpochError, RuntimeError)
    for name in ("span", "last_span", "StepTelemetry", "init_telemetry",
                 "accumulate", "StallWatchdog", "heartbeat",
                 "last_heartbeat", "describe", "catalog_names"):
        assert callable(getattr(observe, name)), name
    assert isinstance(observe.CATALOG, dict)
    assert isinstance(observe.STALL_HINT, str)
    assert observe.init_telemetry(device="cpu").windows.item() == 0
    tm = gpt.GptModel(**small)
    opt = optimizers.FusedAdam(list(tm.parameters()))
    loss = lambda out, y: out.float().mean()  # noqa: E731
    for kw, owner in ((dict(axis_name="model"), A9),
                      (dict(axis_name=("data", "model")), A9),
                      (dict(tp_axis="model"), A9),
                      (dict(parallel="auto"), A9)):
        with pytest.raises(NotImplementedError, match=owner):
            make_train_step(tm, opt, loss, **kw)
    # A9's first part is ported: the data axis, its knobs and ZeRO build
    for kw in (dict(axis_name="data"), dict(gradient_predivide_factor=2.0),
               dict(zero_sharding=True)):
        assert make_train_step(tm, opt, loss, **kw).state.step == 0
    assert make_train_step(tm, opt, loss, telemetry=True).state.telem \
        is not None
