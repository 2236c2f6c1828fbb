"""Command line of the port: `run` (BAMs -> polished FASTQ), `train` and
`evaluate`.

  python -m deepconsensus_tpu_torch.cli run \\
      --subreads_to_ccs subreads_to_ccs.bam --ccs_bam ccs.bam \\
      --weights weights.npz --params params.json --output out.fastq

Mixed-width windows from the CCS `wl` tag: add --use_ccs_smart_windows
--window_buckets 100,200 (each bucket in its own packs), and
--use_ragged_kernel to pack them into ragged slots instead.

  python -m deepconsensus_tpu_torch.cli train \\
      --config transformer_learn_values+custom --out_dir model_out \\
      --train_path 'train/*.tfrecord.gz' --eval_path 'eval/*.tfrecord.gz'

writes model_out/params.json, checkpoints and weights.npz, which `run`
takes as --params and --weights.

Inference levers, on `run` and `evaluate`: --inference_dtype bfloat16
casts the weights once at load and runs the model in bfloat16;
--quantize_matmuls int8 quantizes the encoder matmuls per output
channel (K2's int8 variant on the card).

  python -m deepconsensus_tpu_torch.cli evaluate \\
      --checkpoint model_out/checkpoints/checkpoint-4.pt \\
      --eval_path 'eval/*.tfrecord.gz' --out_dir eval_out \\
      [--quantize_matmuls int8]

writes eval_out/inference.csv (loss, alignment_identity, ...); it also
takes `run`'s --weights/--params pair in place of --checkpoint.

Each runs on the card unless --device cpu is given; without a card the
default raises. Weights are a `models/weights.save_npz` file (see the
README for the one-liner that writes one from a JAX checkpoint).
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
  metrics = train_lib.run_training(
      params, args.out_dir, train_patterns=args.train_path,
      eval_patterns=args.eval_path, num_epochs=args.num_epochs,
      device=device)
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
                      help='A `train` checkpoint-<step>.pt; params.json '
                      'is read from beside its checkpoints directory.')
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
  p.add_argument('--weights', required=True,
                 help='Params tree as .npz with "/"-joined keys.')
  p.add_argument('--params', required=True, help='params.json of the model.')
  p.add_argument('--output', required=True)
  p.add_argument('--batch_size', type=int, default=1024)
  p.add_argument('--batch_zmws', type=int, default=100)
  p.add_argument('--min_length', type=int, default=0)
  p.add_argument('--min_quality', type=int, default=20)
  p.add_argument('--skip_windows_above', type=int, default=45)
  p.add_argument('--ins_trim', type=int, default=5)
  p.add_argument('--use_ccs_smart_windows', action='store_true',
                 help='Window widths from the CCS record\'s wl tag.')
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
  _add_quant_flags(p)
  p.add_argument('--device', default=None,
                 help='cuda (default) or cpu.')


def main(argv: Optional[List[str]] = None) -> int:
  parser = argparse.ArgumentParser(prog='deepconsensus_tpu_torch')
  sub = parser.add_subparsers(dest='command', required=True)
  _add_run(sub)
  _add_train(sub)
  _add_evaluate(sub)
  args = parser.parse_args(argv)
  if args.command == 'train':
    return _train(args)
  if args.command == 'evaluate':
    return _evaluate(args)

  from deepconsensus_tpu_torch.calibration import lib as calibration_lib
  from deepconsensus_tpu_torch.devices import resolve_device
  from deepconsensus_tpu_torch.inference import runner as runner_lib
  from deepconsensus_tpu_torch.models import config as config_lib
  from deepconsensus_tpu_torch.models import weights as weights_lib

  device = resolve_device(args.device)
  params = config_lib.read_params_from_json(args.params)
  if args.dtype:
    params.dtype = args.dtype
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
      dc_calibration_values=calibration_lib.parse_calibration_string(dc_cal),
      ccs_calibration_values=calibration_lib.parse_calibration_string(
          args.ccs_calibration),
  )
  state = weights_lib.from_flax_params(
      weights_lib.load_npz(args.weights), params)
  runner = runner_lib.ModelRunner(params, state, options, device=device)
  counters = runner_lib.run_inference(
      args.subreads_to_ccs, args.ccs_bam, args.output, runner)
  print(json.dumps({k: counters[k] for k in (
      'success', 'n_windows_to_model', 'n_model_packs', 'model_seconds',
      'total_seconds') if k in counters}))
  if args.end_after_stage != 'full':
    return 0  # a truncated run writes no reads
  return 0 if counters.get('success', 0) > 0 else 1


if __name__ == '__main__':
  sys.exit(main())
