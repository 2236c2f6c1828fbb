#!/usr/bin/env python3
"""Whether a `cli train` step is bit for bit repeatable on the card.

  python3 scripts/probe_train_repeatable.py [--passes 3] [--deterministic]

Runs chip_smoke.py's train_ckpt `cli train` (train's config at full
width, float32, batch 256, 8 steps over its synthetic shards). Before
each step it runs the forward and backward `--passes` times from the
same parameters, batch and dropout generator state, and compares each
pass with the first bit for bit: the predictions, the loss, every
parameter's gradient, and the gradient at every module's output (where
a difference first appears, walking back from the loss, names the
operation that adds in another order from run to run). Then the step
itself runs as usual.

--deterministic sets `torch.use_deterministic_algorithms(True)` (and
CUBLAS_WORKSPACE_CONFIG) first: the control that puts PyTorch's own
operations on their deterministic implementations; the port's kernels
are unaffected by it.

Prints one JSON line a step and pass, then a summary line. Exits 1 when
any pass differed, 2 without a CUDA device.
"""
import argparse
import json
import os
import shutil
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as c  # noqa: E402


def main() -> int:
  parser = argparse.ArgumentParser()
  parser.add_argument('--passes', type=int, default=3)
  parser.add_argument('--deterministic', action='store_true')
  args = parser.parse_args()
  if args.deterministic:
    os.environ['CUBLAS_WORKSPACE_CONFIG'] = ':4096:8'
  import torch

  if not torch.cuda.is_available():
    print('no CUDA device', file=sys.stderr)
    return 2
  if args.deterministic:
    torch.use_deterministic_algorithms(True)
  print(c.card_line(), flush=True)
  from deepconsensus_tpu_torch import cli
  from deepconsensus_tpu_torch.models import train as train_lib
  from deepconsensus_tpu_torch.ops import _build
  from deepconsensus_tpu_torch.testing import synthetic

  _build.build_all()
  shards = []
  for split, count, seed in (('train', c.TRAIN_EXAMPLES, c.SEED),
                             ('eval', c.EVAL_EXAMPLES, c.SEED + 1)):
    out = os.path.join(c.WORK, f'shards_{split}')
    shutil.rmtree(out, ignore_errors=True)
    synthetic.write_synthetic_tfrecords(
        out, n_shards=4, n_examples=count, max_passes=20,
        max_length=c.LENGTH, seed=seed)
    shards.append(os.path.join(out, '*.tfrecord.gz'))
  step_fn = train_lib.train_step
  lines = []

  def one_pass(model, loss_fn, batch, generator):
    """Forward and backward from the generator's state, which is then
    set back: preds, loss, parameter and module-output gradients."""
    state = generator.get_state()
    outputs = {}
    handles = []
    for name, module in model.named_modules():
      def hook(mod, inputs, out, name=name):
        if isinstance(out, torch.Tensor) and out.requires_grad:
          out.register_hook(lambda g, name=name: outputs.__setitem__(
              name, g.detach().clone()))
      handles.append(module.register_forward_hook(hook))
    try:
      for p in model.parameters():
        p.grad = None
      preds = model.forward_train(batch['rows'], generator)
      loss = loss_fn(batch['label'], preds)
      loss.backward()
    finally:
      for h in handles:
        h.remove()
      generator.set_state(state)
    grads = {n: p.grad.detach().clone()
             for n, p in model.named_parameters() if p.grad is not None}
    for p in model.parameters():
      p.grad = None
    return preds.detach(), loss.detach(), grads, outputs

  def compared(model, optimizer, loss_fn, batch, generator):
    passes = [one_pass(model, loss_fn, batch, generator)
              for _ in range(args.passes)]
    p0, l0, g0, o0 = passes[0]
    for k, (p1, l1, g1, o1) in enumerate(passes[1:], 1):
      lines.append({
          'step': optimizer.count + 1, 'pass': k,
          'preds_equal': torch.equal(p0, p1),
          'loss_equal': torch.equal(l0, l1),
          'grads_differ': {
              n: [float((g0[n] - g1[n]).abs().max()),
                  float(g0[n].abs().max()), int((g0[n] != g1[n]).sum())]
              for n in g0 if not torch.equal(g0[n], g1[n])},
          'module_grads_differ': {
              n: [float((o0[n] - o1[n]).abs().max()),
                  float(o0[n].abs().max())]
              for n in o0 if n in o1 and not torch.equal(o0[n], o1[n])},
          'n_modules': len(o0)})
      print(json.dumps(lines[-1]), flush=True)
    return step_fn(model, optimizer, loss_fn, batch, generator)

  out = os.path.join(c.WORK, 'probe_train_repeatable')
  shutil.rmtree(out, ignore_errors=True)
  train_lib.train_step = compared
  try:
    rc = cli.main(c.ckpt_argv(shards, out, {}))
  finally:
    train_lib.train_step = step_fn
  repeatable = all(x['preds_equal'] and x['loss_equal']
                   and not x['grads_differ']
                   and not x['module_grads_differ'] for x in lines)
  print(json.dumps({'summary': True, 'cli_rc': rc,
                    'deterministic': args.deterministic,
                    'steps': len(lines) // max(args.passes - 1, 1),
                    'repeatable': repeatable,
                    'steps_differing': sorted({
                        x['step'] for x in lines
                        if x['grads_differ'] or x['module_grads_differ']
                        or not (x['preds_equal'] and x['loss_equal'])})}),
        flush=True)
  print(c.card_line(), flush=True)
  return 0 if rc == 0 and repeatable else 1


if __name__ == '__main__':
  sys.exit(main())
