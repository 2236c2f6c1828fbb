"""Command line of the port: `preprocess` (BAMs -> TFRecord examples),
`run` (BAMs -> polished FASTQ), `train`, `evaluate`, `validate`
(preflight checks of the inputs), `trace` (summary of a `run --trace`
span file), `serve` (a resident service on one card), and the fleet's
front tier: `route` and `featurize-worker`.

  python -m deepconsensus_tpu_torch.cli preprocess \\
      --subreads_to_ccs subreads_to_ccs.bam --ccs_bam ccs.bam \\
      --truth_to_ccs truth_to_ccs.bam --truth_bed truth.bed \\
      --truth_split truth_split.tsv \\
      --output 'examples/@split/@split.tfrecord.gz' --cpus 4

writes examples/{train,eval,test}/ and examples/summary/ (without the
truth flags: unlabelled examples for inference).

  python -m deepconsensus_tpu_torch.cli run \\
      --subreads_to_ccs subreads_to_ccs.bam --ccs_bam ccs.bam \\
      --weights weights.npz --params params.json --output out.fastq

Mixed-width windows from the CCS `wl` tag: add --use_ccs_smart_windows
--window_buckets 100,200 (each bucket in its own packs), and
--use_ragged_kernel to pack them into ragged slots instead.

  python -m deepconsensus_tpu_torch.cli train \\
      --config transformer_learn_values+custom --out_dir model_out \\
      --train_path 'train/*.tfrecord.gz' --eval_path 'eval/*.tfrecord.gz'

writes model_out/params.json, checkpoints/checkpoint-<step>/ (each with
a manifest under checkpoints/.manifests/), checkpoint_metrics.tsv,
best_checkpoint.txt and weights.npz; `run` takes --checkpoint
model_out/checkpoints/checkpoint-<step> or the --weights/--params pair.
A rerun resumes from the newest valid checkpoint (a truncated one is
quarantined), SIGTERM saves and exits cleanly, transient errors (CUDA
out of memory among them) restart from the last checkpoint, and a
non-finite step rolls back (training.failed.jsonl says which windows);
--checkpoint <dir> warm-starts from another run's weights.
--window_buckets 100,200 trains on windows of both widths (width-pure
batches, one step each); --set streaming=true --set n_examples_train=N
streams the shards (--set loader_workers=2 decodes them in two
processes; --on_shard_error skip reads past a bad shard); --set
augment=true augments training batches; --set remat=true recomputes
each encoder sublayer in the backward pass; --set embed_onehot=true
looks bases and strand up as one-hot products.

Inference levers, on `run` and `evaluate`: --inference_dtype bfloat16
casts the weights once at load and runs the model in bfloat16;
--quantize_matmuls int8 quantizes the encoder matmuls per output
channel (K2's int8 variant on the card).

  python -m deepconsensus_tpu_torch.cli evaluate \\
      --checkpoint model_out/checkpoints/checkpoint-4 \\
      --eval_path 'eval/*.tfrecord.gz' --out_dir eval_out \\
      [--quantize_matmuls int8]

writes eval_out/inference.csv (loss, alignment_identity, ...); it also
takes `run`'s --weights/--params pair in place of --checkpoint.

The fault surface of `run`: --on_zmw_error skip or ccs-fallback
quarantines a failing ZMW to <output>.failed.jsonl instead of aborting;
--resume continues an interrupted run from <output>.progress.json and
<output>.tmp; --shard I/N keeps the ZMWs with zm % N == I;
--on_device_error degrade bisects a pack that ran out of device memory;
--dispatch_timeout bounds each pack's wait on the card; --batch_timeout
and --batch_retries supervise the --cpus pool; --trace t.jsonl writes
trace spans, which

  python -m deepconsensus_tpu_torch.cli trace t.jsonl [--json]

summarizes (exit 2 on a corrupt trace), and

  python -m deepconsensus_tpu_torch.cli validate \\
      --subreads_to_ccs subreads_to_ccs.bam --ccs_bam ccs.bam

checks a BAM pair or TFRecord shards end to end (exit 1 on a failed
check, the JSON report on stdout).

  python -m deepconsensus_tpu_torch.cli serve \\
      --weights weights.npz --params params.json --port 0

loads the model as `run` does (or --checkpoint, or --random_init for a
seeded model of --config), warms one pack of each shape on the card and
prints one JSON ready line ({"event": "ready", "host", "port",
"warmup_s"}); POST /v1/polish takes one molecule's windows
(serve/protocol.py, serve/client.py's ServeClient) and answers with its
polished read, byte-identical to the read `run` writes for it. SIGTERM
drains: admitted requests finish, the process prints {"event":
"drained", "drained": true, ...} and exits 0. Multi-card serving
(--dp, --tp) is not ported yet.

  python -m deepconsensus_tpu_torch.cli featurize-worker --port 0
  python -m deepconsensus_tpu_torch.cli route --replica HOST:PORT \\
      --featurize_worker HOST:PORT --port 0

`route` balances /v1/polish over `serve` replicas and sends bam/1
bodies (one molecule's raw BAM bytes) through a featurize worker first;
neither touches the card.

`run`, `train`, `evaluate`, `serve` and `preprocess` run on the card unless
--device cpu is given; without a card the default raises (`preprocess`
does no work on the card, and still asks for it, as the others do). Weights are a
`models/weights.save_npz` file (see the README for the one-liner that
writes one from a JAX checkpoint).
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional


def _parse_window_buckets(text):
  try:
    buckets = tuple(int(x) for x in text.split(',') if x.strip())
  except ValueError:
    raise argparse.ArgumentTypeError(
        f'--window_buckets must be comma-separated ints, got {text!r}')
  if not buckets:
    raise argparse.ArgumentTypeError('--window_buckets is empty')
  return buckets


def _parse_shard(value):
  """argparse type: 'I/N' -> (i, n) with 0 <= i < n."""
  try:
    i_str, n_str = value.split('/')
    i, n = int(i_str), int(n_str)
  except ValueError:
    raise argparse.ArgumentTypeError(
        f'expected I/N (e.g. 3/500), got {value!r}')
  if not 0 <= i < n:
    raise argparse.ArgumentTypeError(f'need 0 <= I < N, got {value!r}')
  return (i, n)


def _coerce_override(raw: str, current):
  """Parses a --set value against the config entry's current type."""
  if raw.lower() in ('none', 'null'):
    return None
  if isinstance(current, bool):
    if raw.lower() in ('true', '1', 'yes'):
      return True
    if raw.lower() in ('false', '0', 'no'):
      return False
    raise ValueError(f'expected a boolean, got {raw!r}')
  for cast in (int, float):
    if isinstance(current, cast):
      return cast(raw)
  if current is None:
    if raw.lower() in ('true', 'yes'):
      return True
    if raw.lower() in ('false', 'no'):
      return False
    for cast in (int, float):
      try:
        return cast(raw)
      except ValueError:
        continue
  return raw


def _apply_overrides(params, overrides: List[str]) -> None:
  """Applies --set KEY=VALUE items before finalize_params, so derived
  values (total_rows, hidden_size) see them. Transformer size keys
  (num_hidden_layers, num_heads, filter_size) may be set although
  finalize_params only adds them later."""
  from deepconsensus_tpu_torch.models import config as config_lib

  late_keys = frozenset(
      k for preset in config_lib.TRANSFORMER_SIZE_PARAMS.values()
      for k in preset)
  for item in overrides:
    key, eq, raw = item.partition('=')
    if not eq or not (key in params or key in late_keys):
      raise ValueError(f'unknown config override {item!r}')
    params[key] = _coerce_override(raw, params.get(key))


def _add_preprocess(sub) -> None:
  p = sub.add_parser('preprocess', help='Generate examples from BAMs.')
  p.add_argument('--subreads_to_ccs', required=True)
  p.add_argument('--ccs_bam', required=True)
  p.add_argument('--output', required=True,
                 help="Output path; '@split' expands per split.")
  p.add_argument('--max_passes', type=int, default=20)
  p.add_argument('--example_width', type=int, default=100)
  p.add_argument('--use_ccs_bq', action='store_true')
  p.add_argument('--ins_trim', type=int, default=5)
  p.add_argument('--use_ccs_smart_windows', action='store_true')
  p.add_argument('--truth_bed')
  p.add_argument('--truth_to_ccs')
  p.add_argument('--truth_split')
  p.add_argument('--limit', type=int, default=0)
  p.add_argument('--cpus', type=int, default=0)
  p.add_argument('--shard', default=None, metavar='I/N',
                 type=_parse_shard,
                 help='Process only ZMWs with zm %% N == I (shard the '
                 'output paths too).')
  p.add_argument('--compression', choices=['bgzf', 'gzip'], default='bgzf',
                 help='.gz shard framing: bgzf (default; valid gzip, '
                 'parallel-decodable blocks) or single-member gzip.')
  p.add_argument('--device', default=None, help='cuda (default) or cpu.')


def _preprocess(args) -> int:
  from deepconsensus_tpu_torch.devices import resolve_device
  from deepconsensus_tpu_torch.preprocess.driver import run_preprocess

  resolve_device(args.device)
  summary = run_preprocess(
      subreads_to_ccs=args.subreads_to_ccs,
      ccs_bam=args.ccs_bam,
      output=args.output,
      max_passes=args.max_passes,
      example_width=args.example_width,
      use_ccs_bq=args.use_ccs_bq,
      ins_trim=args.ins_trim,
      use_ccs_smart_windows=args.use_ccs_smart_windows,
      truth_bed=args.truth_bed,
      truth_to_ccs=args.truth_to_ccs,
      truth_split=args.truth_split,
      limit=args.limit,
      cpus=args.cpus,
      shard=args.shard,
      compression=args.compression.upper(),
  )
  print(json.dumps({k: v for k, v in summary.items()
                    if k.startswith(('n_zmw', 'n_examples'))}))
  return 0


def _add_train(sub) -> None:
  p = sub.add_parser('train', help='Train a model on TFRecord shards.')
  p.add_argument('--config', default='transformer_learn_values+custom',
                 help='{model}+{dataset} preset name.')
  p.add_argument('--out_dir', required=True)
  p.add_argument('--train_path', nargs='*')
  p.add_argument('--eval_path', nargs='*')
  p.add_argument('--num_epochs', type=int)
  p.add_argument('--batch_size', type=int)
  p.add_argument('--set', action='append', default=[], metavar='KEY=VALUE',
                 dest='overrides',
                 help='Config override, repeatable (e.g. --set '
                 'loss_reg=0.5 --set dtype=float32).')
  p.add_argument('--on_shard_error', choices=('fail', 'skip'),
                 help='Streaming-loader policy for an undecodable shard: '
                 'fail (default) aborts, skip counts and logs the shard '
                 'and keeps training.')
  p.add_argument('--checkpoint', default=None,
                 help='Warm start: a checkpoint directory of another run '
                 '(checkpoints/checkpoint-<step>) whose weights seed this '
                 'run; LAMB starts fresh at step 0. Ignored (with a '
                 'warning) once --out_dir has a checkpoint of its own.')
  p.add_argument('--window_buckets', default=None,
                 type=_parse_window_buckets, metavar='L1,L2,...',
                 help='Bucketed training, e.g. 100,200: each window pads '
                 'to the smallest bucket that fits, batches hold one '
                 'width, and each takes its own step over the one set '
                 'of parameters (n_train_forward_shapes == number of '
                 'buckets). The smallest bucket must equal max_length. '
                 'Default: one width, max_length.')
  p.add_argument('--device', default=None, help='cuda (default) or cpu.')


def _train(args) -> int:
  from deepconsensus_tpu_torch.devices import resolve_device
  from deepconsensus_tpu_torch.models import config as config_lib
  from deepconsensus_tpu_torch.models import train as train_lib

  device = resolve_device(args.device)
  params = config_lib.get_config(args.config)
  _apply_overrides(params, args.overrides)
  config_lib.finalize_params(params)
  if args.batch_size:
    params.batch_size = args.batch_size
  if args.on_shard_error:
    params.on_shard_error = args.on_shard_error
  if args.window_buckets:
    params.window_buckets = args.window_buckets
  metrics = train_lib.run_training_with_retry(
      params=params, out_dir=args.out_dir, train_patterns=args.train_path,
      eval_patterns=args.eval_path, num_epochs=args.num_epochs,
      device=device, warm_start=args.checkpoint)
  print(json.dumps(metrics))
  return 0


def _add_quant_flags(p) -> None:
  p.add_argument('--inference_dtype', default=None,
                 choices=['float32', 'bfloat16'],
                 help='bfloat16: cast the weights once at load and run the '
                 'model in bfloat16 (softmax accumulation stays float32). '
                 'Default keeps the float32 weights.')
  p.add_argument('--quantize_matmuls', default=None,
                 choices=['none', 'int8'],
                 help='int8: per-output-channel symmetric quantization of '
                 'the encoder attention/FFN matmul weights at load; the '
                 'dequantization runs in the GEMM epilogue.')


def _add_evaluate(sub) -> None:
  p = sub.add_parser(
      'evaluate', help='Offline eval over labeled TFRecords -> '
      'inference.csv.')
  source = p.add_mutually_exclusive_group(required=True)
  source.add_argument('--checkpoint',
                      help='A `train` checkpoint directory '
                      '(checkpoints/checkpoint-<step>); params.json is read '
                      'from beside its checkpoints directory.')
  source.add_argument('--weights', help='Params tree as .npz (with '
                      '--params), as `run` takes it.')
  p.add_argument('--params', help='params.json of the model (with '
                 '--weights).')
  p.add_argument('--eval_path', nargs='+', required=True)
  p.add_argument('--out_dir', required=True)
  p.add_argument('--limit', type=int, default=-1,
                 help='Max eval examples (-1 = all).')
  p.add_argument('--batch_size', type=int)
  _add_quant_flags(p)
  p.add_argument('--device', default=None, help='cuda (default) or cpu.')


def _evaluate(args) -> int:
  from deepconsensus_tpu_torch.devices import resolve_device
  from deepconsensus_tpu_torch.models import config as config_lib
  from deepconsensus_tpu_torch.models import evaluate as evaluate_lib
  from deepconsensus_tpu_torch.models import quantize as quantize_lib
  from deepconsensus_tpu_torch.models import weights as weights_lib

  device = resolve_device(args.device)
  if args.weights and not args.params:
    raise ValueError('--weights needs --params')
  params = config_lib.read_params_from_json(args.params or args.checkpoint)
  if args.batch_size:
    params.batch_size = args.batch_size
  if args.inference_dtype:
    params.inference_dtype = params.dtype = args.inference_dtype
  if args.quantize_matmuls and args.quantize_matmuls != 'none':
    params.quantize_matmuls = args.quantize_matmuls
  if args.checkpoint:
    state = evaluate_lib.load_checkpoint_state(args.checkpoint)
  else:
    state = weights_lib.from_flax_params(
        weights_lib.load_npz(args.weights), params)
  state, _ = quantize_lib.prepare_inference_variables(state, params)
  metrics = evaluate_lib.run_evaluation(
      params, args.checkpoint, args.eval_path, args.out_dir, state=state,
      limit=args.limit, device=device)
  print(' '.join(f'{k}={v:.5f}' for k, v in sorted(metrics.items())))
  return 0


def _add_run(sub) -> None:
  p = sub.add_parser('run', help='Run inference: BAMs -> polished FASTQ '
                     '(or BAM, for an --output ending in .bam).')
  p.add_argument('--subreads_to_ccs', required=True)
  p.add_argument('--ccs_bam', required=True)
  source = p.add_mutually_exclusive_group(required=True)
  source.add_argument('--checkpoint',
                      help='A `train` checkpoint directory '
                      '(checkpoints/checkpoint-<step>), validated by its '
                      'manifest; params.json is read from beside its '
                      'checkpoints directory.')
  source.add_argument('--weights',
                      help='Params tree as .npz with "/"-joined keys (with '
                      '--params).')
  p.add_argument('--params', help='params.json of the model (with '
                 '--weights; optional with --checkpoint).')
  p.add_argument('--output', required=True)
  p.add_argument('--batch_size', type=int, default=1024)
  p.add_argument('--batch_zmws', type=int, default=100)
  p.add_argument('--min_length', type=int, default=0)
  p.add_argument('--min_quality', type=int, default=20)
  p.add_argument('--skip_windows_above', type=int, default=45)
  p.add_argument('--ins_trim', type=int, default=5)
  p.add_argument('--use_ccs_smart_windows', action='store_true',
                 help='Window widths from the CCS record\'s wl tag.')
  _add_window_flags(p)
  p.add_argument('--max_base_quality', type=int, default=93)
  p.add_argument('--dc_calibration', default=None)
  p.add_argument('--ccs_calibration', default='skip')
  p.add_argument('--limit', type=int, default=0)
  p.add_argument('--dtype', default=None, choices=['float32', 'bfloat16'],
                 help='Compute dtype (default: params.json "dtype").')
  p.add_argument('--end_after_stage', default='full',
                 choices=['dc_input', 'tf_examples', 'run_model', 'full'],
                 help='Stop the pipeline early to time its stages: after '
                 'BAM decode, featurize or the model.')
  p.add_argument('--cpus', type=int, default=0,
                 help='Featurization worker processes (0 or 1 = in the '
                 'pipeline\'s producer thread; tensors travel through '
                 'shared memory).')
  p.add_argument('--dispatch_depth', type=int, default=8,
                 help='Model packs kept in flight on the card before the '
                 'oldest is drained; also the pinned host buffers per '
                 'pack shape.')
  p.add_argument('--emit_queue_depth', type=int, default=4,
                 help='Featurize batches buffered between the model '
                 'stage and the stitch/emit thread before the model '
                 'stage blocks.')
  p.add_argument('--no_cross_batch_packing', action='store_true',
                 help='Pad out each featurize batch\'s model tail '
                 'instead of packing windows across batches into full '
                 'packs.')
  p.add_argument('--shard', default=None, metavar='I/N', type=_parse_shard,
                 help='Process only ZMWs with zm %% N == I, e.g. 3/500.')
  p.add_argument('--on_zmw_error', default='fail',
                 choices=['fail', 'skip', 'ccs-fallback'],
                 help='Per-ZMW fault policy: fail aborts the run; skip '
                 'quarantines the ZMW to <output>.failed.jsonl; '
                 'ccs-fallback also emits its draft CCS read with its '
                 'base qualities.')
  p.add_argument('--batch_timeout', type=float, default=0.0,
                 help='Watchdog timeout (s) per featurization batch with '
                 '--cpus > 1; a hung or killed worker re-spawns the pool '
                 'and retries the batch (0 disables).')
  p.add_argument('--batch_retries', type=int, default=2,
                 help='Watchdog retries per featurization batch before the '
                 'batch is quarantined.')
  p.add_argument('--resume', action='store_true',
                 help='Resume an interrupted run from '
                 '<output>.progress.json and <output>.tmp, skipping the '
                 'committed ZMWs.')
  p.add_argument('--max_record_bytes', type=int, default=64 << 20,
                 help='Per-record allocation cap of the BAM decoders: a '
                 'record claiming more is corrupt (quarantined under '
                 '--on_zmw_error skip), never allocated.')
  _add_device_fault_flags(p)
  _add_trace_flag(p)
  _add_quant_flags(p)
  p.add_argument('--device', default=None,
                 help='cuda (default) or cpu.')


def _add_window_flags(p) -> None:
  p.add_argument('--window_buckets', default=None,
                 type=_parse_window_buckets, metavar='L1,L2,...',
                 help='Window length buckets, e.g. 100,200: each window '
                 'pads to the smallest bucket that fits; wider ones '
                 'adopt the CCS. The smallest must equal max_length. '
                 'Each bucket runs in its own packs of --batch_size. '
                 'Default: params.json "window_buckets" (one bucket when '
                 'unset).')
  p.add_argument('--use_ragged_kernel', action='store_true',
                 help='Pack windows of every bucket back to back into '
                 'slots of the largest bucket with a per-slot lengths '
                 'vector, and run the ragged forward (K4, K2 with '
                 'lengths). Needs buckets that form a divisibility '
                 'chain.')


def _add_device_fault_flags(p) -> None:
  p.add_argument('--on_device_error', default='fail',
                 choices=['fail', 'degrade'],
                 help='Device fault policy: fail hands a failed pack to '
                 'the per-ZMW (or per-request) policy; degrade retries a '
                 'pack that ran out of device memory as halves at half '
                 'the batch.')
  p.add_argument('--dispatch_timeout', type=float, default=0.0,
                 help='Bound each pack\'s wait on the card to this many '
                 'seconds; a hung pack fails with DispatchTimeoutError '
                 'instead of wedging the run (0 disables).')


def _add_trace_flag(p) -> None:
  p.add_argument('--trace', default=None, metavar='TRACE.jsonl',
                 help='Append Chrome-trace-event spans to this file (the '
                 'same as setting DCTPU_TRACE); summarize it with `trace`.')


def _add_serve(sub) -> None:
  p = sub.add_parser(
      'serve', help='Resident consensus service: keep the model on the '
      'card and polish molecules over a local HTTP endpoint.')
  p.add_argument('--checkpoint', default=None,
                 help='A `train` checkpoint directory, as `run` takes it '
                 '(an exported artifact is refused: `cli export` is not '
                 'ported yet).')
  p.add_argument('--weights', default=None,
                 help='Params tree as .npz (with --params), as `run` '
                 'takes it.')
  p.add_argument('--params', default=None, help='params.json of the model.')
  p.add_argument('--random_init', action='store_true',
                 help='Serve a model of --config initialized from a '
                 'torch.Generator seeded 0 instead of trained weights '
                 '(tests, demos).')
  p.add_argument('--config', default='transformer_learn_values+test',
                 help='Model preset for --random_init.')
  p.add_argument('--dtype', default=None, choices=['float32', 'bfloat16'],
                 help='Compute dtype (default: params.json "dtype").')
  p.add_argument('--host', default='127.0.0.1')
  p.add_argument('--port', type=int, default=8764,
                 help='Listen port (0 = pick a free port; the bound port '
                 'is printed in the ready line).')
  p.add_argument('--batch_size', type=int, default=1024)
  p.add_argument('--dispatch_depth', type=int, default=8)
  p.add_argument('--min_length', type=int, default=0)
  p.add_argument('--min_quality', type=int, default=20)
  p.add_argument('--skip_windows_above', type=int, default=45)
  p.add_argument('--max_base_quality', type=int, default=93)
  p.add_argument('--dc_calibration', default=None)
  p.add_argument('--ccs_calibration', default='skip')
  p.add_argument('--max_pending', type=int, default=64,
                 help='Outstanding admitted requests before new ones are '
                 'shed with 429 backpressure.')
  p.add_argument('--admit_queue_depth', type=int, default=32,
                 help='Requests queued ahead of the model loop before '
                 'admission sheds with 429.')
  p.add_argument('--max_windows_per_request', type=int, default=512)
  p.add_argument('--max_body_mb', type=int, default=64,
                 help='Request bodies above this are rejected (413) '
                 'before any bytes are read.')
  p.add_argument('--default_deadline_s', type=float, default=120.0,
                 help='Per-request deadline when the client sends no '
                 'X-Dctpu-Deadline-S header; expiry cancels the request '
                 '(504).')
  p.add_argument('--max_deadline_s', type=float, default=600.0)
  p.add_argument('--io_timeout_s', type=float, default=20.0,
                 help='Per-request read deadline; a slow-drip or '
                 'half-dead client is cut after this long.')
  p.add_argument('--on_request_error', default='ccs-fallback',
                 choices=['skip', 'ccs-fallback'],
                 help='Policy for a request whose windows fail the model '
                 'stage twice (shared pack and isolation retry).')
  p.add_argument('--dead_letter', default=None,
                 help='Append quarantined-request records (with request '
                 'attribution) to this JSONL sidecar.')
  p.add_argument('--dp', type=int, default=0,
                 help='Data-parallel cards. Not ported yet: above 0 it '
                 'raises; the port serves on one card.')
  p.add_argument('--tp', type=int, default=1,
                 help='Tensor-parallel cards. Not ported yet: above 1 it '
                 'raises.')
  _add_quant_flags(p)
  _add_window_flags(p)
  _add_device_fault_flags(p)
  _add_trace_flag(p)
  p.add_argument('--device', default=None, help='cuda (default) or cpu.')


def _serve_setup(args):
  """(runner, options, serve_options) of a `serve` command line: the
  model loaded as `run` loads it, on the card unless --device cpu."""
  from deepconsensus_tpu_torch import faults
  from deepconsensus_tpu_torch.calibration import lib as calibration_lib
  from deepconsensus_tpu_torch.devices import resolve_device
  from deepconsensus_tpu_torch.inference import runner as runner_lib
  from deepconsensus_tpu_torch.serve.service import ServeOptions

  if args.dp or args.tp > 1:
    raise faults.NotPortedError(
        f'--dp {args.dp} --tp {args.tp}: multi-card serving is not ported '
        'yet; the port serves on one card (--dp 0 --tp 1)')
  if not (args.random_init or args.checkpoint or args.weights):
    raise ValueError('serve needs --checkpoint, --weights/--params or '
                     '--random_init')
  if args.trace:
    import os

    os.environ['DCTPU_TRACE'] = args.trace
  device = resolve_device(args.device)
  params, state = runner_lib.load_model(
      checkpoint=args.checkpoint, weights=args.weights,
      params_path=args.params, dtype=args.dtype,
      random_init_config=args.config if args.random_init else None)
  dc_cal = args.dc_calibration or params.get('dc_calibration') or 'skip'
  options = runner_lib.InferenceOptions(
      batch_size=args.batch_size,
      dispatch_depth=args.dispatch_depth,
      min_length=args.min_length,
      min_quality=args.min_quality,
      skip_windows_above=args.skip_windows_above,
      max_base_quality=args.max_base_quality,
      on_device_error=args.on_device_error,
      dispatch_timeout=args.dispatch_timeout,
      inference_dtype=args.inference_dtype,
      quantize_matmuls=args.quantize_matmuls,
      window_buckets=args.window_buckets,
      use_ragged_kernel=args.use_ragged_kernel,
      dc_calibration_values=calibration_lib.parse_calibration_string(dc_cal),
      ccs_calibration_values=calibration_lib.parse_calibration_string(
          args.ccs_calibration),
  )
  runner = runner_lib.ModelRunner(params, state, options, device=device)
  options.max_passes = runner.params.max_passes
  options.max_length = runner.params.max_length
  options.use_ccs_bq = runner.params.use_ccs_bq
  serve_options = ServeOptions(
      max_pending=args.max_pending,
      admit_queue_depth=args.admit_queue_depth,
      max_windows_per_request=args.max_windows_per_request,
      max_body_bytes=args.max_body_mb << 20,
      default_deadline_s=args.default_deadline_s,
      max_deadline_s=args.max_deadline_s,
      io_timeout_s=args.io_timeout_s,
      on_request_error=args.on_request_error,
      dead_letter_path=args.dead_letter,
  )
  return runner, options, serve_options


def serve_setup(argv: List[str]):
  """(runner, options, serve_options, host, port) that `serve` runs with
  these flags, for a caller that runs serve.server.serve_main itself
  (in a thread, stopped by its stop_event)."""
  args = _parser().parse_args(['serve', *argv])
  return (*_serve_setup(args), args.host, args.port)


def _serve(args) -> int:
  from deepconsensus_tpu_torch.serve import server as server_lib

  runner, options, serve_options = _serve_setup(args)
  stats = server_lib.serve_main(
      runner, options, serve_options, host=args.host, port=args.port,
      ready_fn=lambda info: print(json.dumps(info), flush=True))
  print(json.dumps({'event': 'drained', **stats}, default=str), flush=True)
  return 0 if stats.get('drained') else 1


def _add_route(sub) -> None:
  p = sub.add_parser(
      'route', help='Fleet front tier: balance /v1/polish over `serve` '
      'replicas, sending bam/1 bodies through featurize workers first.')
  p.add_argument('--replica', action='append', default=[],
                 metavar='HOST:PORT',
                 help='Model replica address; repeatable. Replicas join '
                 'health-gated (no traffic until /readyz passes); more '
                 'can join at run time via POST /v1/register.')
  p.add_argument('--featurize_worker', action='append', default=[],
                 metavar='HOST:PORT',
                 help='Featurize worker address; repeatable.')
  p.add_argument('--host', default='127.0.0.1')
  p.add_argument('--port', type=int, default=8765)
  p.add_argument('--probe_interval_s', type=float, default=0.5,
                 help='Health probe cadence per replica (/readyz and '
                 '/metricz).')
  p.add_argument('--max_inflight', type=int, default=8,
                 help='Bounded in-flight requests per replica; when every '
                 'ready replica is at its bound the router sheds with a '
                 'typed 503.')
  p.add_argument('--max_attempts', type=int, default=3,
                 help='Distinct replicas tried per request; only requests '
                 'a replica provably never accepted are retried.')
  p.add_argument('--io_timeout_s', type=float, default=20.0)
  p.add_argument('--upstream_timeout_s', type=float, default=300.0,
                 help='End-to-end budget for one forwarded request.')
  p.add_argument('--max_body_mb', type=int, default=64)
  p.add_argument('--default_class', default='interactive',
                 help='Priority class of requests without an '
                 'X-Dctpu-Class header.')
  p.add_argument('--class_weight', action='append', default=[],
                 metavar='CLASS=WEIGHT',
                 help='Weighted-fair admission share of a priority class; '
                 'repeatable (default: interactive=4 bulk=1).')
  p.add_argument('--client_quota', type=int, default=0,
                 help='Max concurrent requests per client id (429 above '
                 'it); 0 = unlimited.')
  p.add_argument('--queue_wait_s', type=float, default=0.0,
                 help='How long a saturated request may wait its '
                 'weighted-fair turn before it is shed (0 = at once).')
  p.add_argument('--max_queued_per_class', type=int, default=16,
                 help='Waiting requests per class before that class (and '
                 'only that class) sheds.')
  _add_trace_flag(p)


def _route(args) -> int:
  from deepconsensus_tpu_torch.fleet import router as router_lib

  if not args.replica and not args.featurize_worker:
    raise ValueError('route needs at least one --replica or '
                     '--featurize_worker')
  if args.trace:
    import os

    os.environ['DCTPU_TRACE'] = args.trace
  class_weights = None
  if args.class_weight:
    class_weights = {}
    for spec in args.class_weight:
      name, sep, weight = spec.partition('=')
      if not sep:
        raise ValueError(f'--class_weight expects CLASS=WEIGHT, got {spec!r}')
      class_weights[name] = float(weight)
  options = router_lib.RouterOptions(
      max_body_bytes=args.max_body_mb << 20,
      io_timeout_s=args.io_timeout_s,
      upstream_timeout_s=args.upstream_timeout_s,
      probe_interval_s=args.probe_interval_s,
      max_inflight=args.max_inflight,
      max_attempts=args.max_attempts,
      class_weights=class_weights,
      default_class=args.default_class,
      client_quota=args.client_quota,
      queue_wait_s=args.queue_wait_s,
      max_queued_per_class=args.max_queued_per_class,
  )
  stats = router_lib.route_main(
      replicas=args.replica, featurize_workers=args.featurize_worker,
      options=options, host=args.host, port=args.port,
      ready_fn=lambda info: print(json.dumps(info), flush=True))
  print(json.dumps({'event': 'drained', **stats}, default=str), flush=True)
  return 0 if stats.get('drained') else 1


def _add_featurize_worker(sub) -> None:
  p = sub.add_parser(
      'featurize-worker', help='Disaggregated featurize tier: BAM decode '
      'and pileup on the CPU, shipping compact uint8 window packs to '
      'model replicas.')
  p.add_argument('--host', default='127.0.0.1')
  p.add_argument('--port', type=int, default=8766)
  p.add_argument('--config', default='transformer_learn_values+test',
                 help='Model preset naming the feature layout (max_passes, '
                 'max_length, use_ccs_bq) this worker produces; it must '
                 'match the replicas behind the same router.')
  p.add_argument('--ins_trim', type=int, default=0)
  p.add_argument('--use_ccs_smart_windows', action='store_true')
  p.add_argument('--work_dir', default=None,
                 help='Scratch directory for per-request BAMs.')
  p.add_argument('--no_compact', action='store_true',
                 help='Always ship the float32 request frame instead of '
                 'features/1 uint8 packs.')
  p.add_argument('--io_timeout_s', type=float, default=20.0)
  p.add_argument('--max_body_mb', type=int, default=64)
  p.add_argument('--window_buckets', default=None,
                 type=_parse_window_buckets, metavar='L1,L2,...',
                 help='Window length buckets the windows pad to (default: '
                 'the preset\'s, one bucket when unset).')
  _add_trace_flag(p)


def _featurize_worker(args) -> int:
  from deepconsensus_tpu_torch.fleet import featurize_worker as worker_lib
  from deepconsensus_tpu_torch.models import config as config_lib

  if args.trace:
    import os

    os.environ['DCTPU_TRACE'] = args.trace
  params = config_lib.get_config(args.config)
  config_lib.finalize_params(params)
  buckets = config_lib.normalize_window_buckets(
      args.window_buckets or params.get('window_buckets'), params.max_length)
  options = worker_lib.FeaturizeWorkerOptions(
      max_passes=params.max_passes,
      max_length=params.max_length,
      use_ccs_bq=params.use_ccs_bq,
      window_buckets=tuple(buckets or ()),
      ins_trim=args.ins_trim,
      use_ccs_smart_windows=args.use_ccs_smart_windows,
      work_dir=args.work_dir,
      compact=not args.no_compact,
      max_body_bytes=args.max_body_mb << 20,
      io_timeout_s=args.io_timeout_s,
  )
  stats = worker_lib.worker_main(
      options, host=args.host, port=args.port,
      ready_fn=lambda info: print(json.dumps(info), flush=True))
  print(json.dumps({'event': 'drained', **stats}, default=str), flush=True)
  return 0 if stats.get('drained') else 1


def _add_validate(sub) -> None:
  p = sub.add_parser(
      'validate', help='Preflight-check inputs before spending card time '
      'on them.')
  p.add_argument('--subreads_to_ccs', default=None,
                 help='actc output BAM (subreads aligned to ccs).')
  p.add_argument('--ccs_bam', default=None,
                 help='ccs BAM; with --subreads_to_ccs also checks the '
                 'pair\'s names and order.')
  p.add_argument('--tfrecord', action='append', default=[], metavar='GLOB',
                 help='TFRecord path or glob (repeatable); every matching '
                 'shard is CRC-checked end to end.')
  p.add_argument('--max_record_bytes', type=int, default=None,
                 help='Per-record allocation cap (default 64 MiB).')
  p.add_argument('--report', default=None,
                 help='Also write the JSON report to this path.')


def _validate(args) -> int:
  from deepconsensus_tpu_torch.io import validate as validate_lib

  if (args.subreads_to_ccs is None and args.ccs_bam is None
      and not args.tfrecord):
    raise ValueError('validate needs at least one of --subreads_to_ccs, '
                     '--ccs_bam, --tfrecord')
  report = validate_lib.validate_inputs(
      subreads_to_ccs=args.subreads_to_ccs, ccs_bam=args.ccs_bam,
      tfrecords=args.tfrecord, max_record_bytes=args.max_record_bytes)
  text = json.dumps(report, indent=2)
  print(text)
  if args.report:
    with open(args.report, 'w') as f:
      f.write(text + '\n')
  return 0 if report['ok'] else 1


def _add_trace(sub) -> None:
  p = sub.add_parser(
      'trace', help='Summarize a --trace span file: per-stage breakdown, '
      'critical path, straggler packs, transfer overlap, device gaps.')
  p.add_argument('trace_file', metavar='TRACE.jsonl')
  p.add_argument('--json', action='store_true', dest='trace_json',
                 help='Print the summary as JSON.')
  p.add_argument('--top', type=int, default=10,
                 help='Max straggler packs listed (default 10).')


def _trace(args) -> int:
  from deepconsensus_tpu_torch import faults
  from deepconsensus_tpu_torch.obs import summarize as summarize_lib

  try:
    summary = summarize_lib.summarize(
        summarize_lib.load_trace(args.trace_file))
  except faults.CorruptInputError as e:
    print(f'deepconsensus_tpu_torch: {e}', file=sys.stderr)
    return 2
  summary['stragglers'] = summary['stragglers'][:max(args.top, 0)]
  if args.trace_json:
    print(json.dumps(summary, indent=2))
  else:
    print(summarize_lib.format_summary(summary))
  return 0


def _parser() -> argparse.ArgumentParser:
  parser = argparse.ArgumentParser(prog='deepconsensus_tpu_torch')
  sub = parser.add_subparsers(dest='command', required=True)
  _add_preprocess(sub)
  _add_run(sub)
  _add_train(sub)
  _add_evaluate(sub)
  _add_validate(sub)
  _add_trace(sub)
  _add_serve(sub)
  _add_route(sub)
  _add_featurize_worker(sub)
  return parser


def main(argv: Optional[List[str]] = None) -> int:
  args = _parser().parse_args(argv)
  if args.command == 'preprocess':
    return _preprocess(args)
  if args.command == 'train':
    return _train(args)
  if args.command == 'evaluate':
    return _evaluate(args)
  if args.command == 'validate':
    return _validate(args)
  if args.command == 'trace':
    return _trace(args)
  if args.command == 'serve':
    return _serve(args)
  if args.command == 'route':
    return _route(args)
  if args.command == 'featurize-worker':
    return _featurize_worker(args)
  if args.trace:
    # --trace is DCTPU_TRACE, which run_inference reads.
    import os

    os.environ['DCTPU_TRACE'] = args.trace

  from deepconsensus_tpu_torch.calibration import lib as calibration_lib
  from deepconsensus_tpu_torch.devices import resolve_device
  from deepconsensus_tpu_torch.inference import runner as runner_lib
  device = resolve_device(args.device)
  params, state = runner_lib.load_model(
      checkpoint=args.checkpoint, weights=args.weights,
      params_path=args.params, dtype=args.dtype)
  dc_cal = args.dc_calibration or params.get('dc_calibration') or 'skip'
  options = runner_lib.InferenceOptions(
      batch_size=args.batch_size,
      batch_zmws=args.batch_zmws,
      min_length=args.min_length,
      min_quality=args.min_quality,
      skip_windows_above=args.skip_windows_above,
      inference_dtype=args.inference_dtype,
      quantize_matmuls=args.quantize_matmuls,
      ins_trim=args.ins_trim,
      use_ccs_smart_windows=args.use_ccs_smart_windows,
      window_buckets=args.window_buckets,
      use_ragged_kernel=args.use_ragged_kernel,
      max_base_quality=args.max_base_quality,
      limit=args.limit,
      end_after_stage=args.end_after_stage,
      cpus=args.cpus,
      dispatch_depth=args.dispatch_depth,
      emit_queue_depth=args.emit_queue_depth,
      pack_across_batches=not args.no_cross_batch_packing,
      shard=args.shard,
      on_zmw_error=args.on_zmw_error,
      max_record_bytes=args.max_record_bytes,
      batch_timeout=args.batch_timeout,
      batch_retries=args.batch_retries,
      on_device_error=args.on_device_error,
      dispatch_timeout=args.dispatch_timeout,
      resume=args.resume,
      dc_calibration_values=calibration_lib.parse_calibration_string(dc_cal),
      ccs_calibration_values=calibration_lib.parse_calibration_string(
          args.ccs_calibration),
  )
  runner = runner_lib.ModelRunner(params, state, options, device=device)
  counters = runner_lib.run_inference(
      args.subreads_to_ccs, args.ccs_bam, args.output, runner)
  print(json.dumps({k: counters[k] for k in (
      'success', 'n_windows_to_model', 'n_model_packs', 'model_seconds',
      'total_seconds') if k in counters}))
  if args.end_after_stage != 'full':
    return 0  # a truncated run writes no reads
  # ccs-fallback reads count as yield: the dead letters say what failed.
  return 0 if (counters.get('success', 0) > 0
               or counters.get('n_fallback_emitted', 0) > 0) else 1


if __name__ == '__main__':
  sys.exit(main())
