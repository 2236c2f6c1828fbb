"""Command line of the port: `run` (BAMs -> polished FASTQ) and `train`.

  python -m deepconsensus_tpu_torch.cli run \\
      --subreads_to_ccs subreads_to_ccs.bam --ccs_bam ccs.bam \\
      --weights weights.npz --params params.json --output out.fastq

Mixed-width windows from the CCS `wl` tag: add --use_ccs_smart_windows
--window_buckets 100,200 --use_ragged_kernel.

  python -m deepconsensus_tpu_torch.cli train \\
      --config transformer_learn_values+custom --out_dir model_out \\
      --train_path 'train/*.tfrecord.gz' --eval_path 'eval/*.tfrecord.gz'

writes model_out/params.json, checkpoints and weights.npz, which `run`
takes as --params and --weights.

Both run on the card unless --device cpu is given; without a card the
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


def _add_run(sub) -> None:
  p = sub.add_parser('run', help='Run inference: BAMs -> polished FASTQ.')
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
                 'Several buckets need --use_ragged_kernel. Default: '
                 'params.json "window_buckets" (one bucket when unset).')
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
  p.add_argument('--device', default=None,
                 help='cuda (default) or cpu.')


def main(argv: Optional[List[str]] = None) -> int:
  parser = argparse.ArgumentParser(prog='deepconsensus_tpu_torch')
  sub = parser.add_subparsers(dest='command', required=True)
  _add_run(sub)
  _add_train(sub)
  args = parser.parse_args(argv)
  if args.command == 'train':
    return _train(args)

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
      ins_trim=args.ins_trim,
      use_ccs_smart_windows=args.use_ccs_smart_windows,
      window_buckets=args.window_buckets,
      use_ragged_kernel=args.use_ragged_kernel,
      max_base_quality=args.max_base_quality,
      limit=args.limit,
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
  return 0 if counters.get('success', 0) > 0 else 1


if __name__ == '__main__':
  sys.exit(main())
