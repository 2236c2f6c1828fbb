"""Which stage of the inference forward changes its bits with the batch
size, as OOM bisection's half packs would see it: the model's encode
(K1, K2, output normalization), its logits (a torch matmul) and the
softmax, run on all rows at once and on two halves, at 16 vs 8 and
1,024 vs 512 windows, on the +test config (2 layers) and at full width,
in float32 and bfloat16. One JSON line per case.

  python3 scripts/probe_batch_bits.py        # on the card
  python3 scripts/probe_batch_bits.py cpu    # a quick CPU rehearsal
"""
import json
import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEVICE = sys.argv[1] if len(sys.argv) > 1 else 'cuda'
sys.path.insert(0, REPO)


def main():
  import chip_smoke as c
  from deepconsensus_tpu_torch.models import config
  from deepconsensus_tpu_torch.models import model as model_lib

  configs = (('test', 'float32'), ('test', 'bfloat16'),
             ('full', 'float32'), ('full', 'bfloat16'))
  for name, dtype in configs[:1] if DEVICE == 'cpu' else configs:
    if name == 'test':
      params = config.get_config('transformer_learn_values+test')
      config.finalize_params(params)
      params.update(dtype=dtype, num_hidden_layers=2, filter_size=64)
    else:
      params = c.make_params(dtype)
    model = model_lib.DeepConsensusModel(params, device=DEVICE)
    model.init_weights(torch.Generator().manual_seed(0), alpha_range=(0.5, 1))
    model.eval()
    for full, half in ((16, 8),) if DEVICE == 'cpu' else ((16, 8),
                                                          (1024, 512)):
      rows = torch.from_numpy(c.fake_rows(
          params, np.random.default_rng(3), batch=full)).to(DEVICE)
      with torch.no_grad():
        enc = model.encode(rows)
        enc_h = torch.cat([model.encode(rows[:half]),
                           model.encode(rows[half:])])
        log = model.logits(enc, 1, torch.float32)
        log_h = model.logits(enc_h, 1, torch.float32)
        out = model(rows)
        out_h = torch.cat([model(rows[:half]), model(rows[half:])])
      print(json.dumps({
          'config': name, 'dtype': dtype, 'batch': [full, half],
          'encode_equal': bool(torch.equal(enc, enc_h)),
          'encode_max': float((enc.float() - enc_h.float()).abs().max()),
          'logits_from_same_encode_equal': bool(torch.equal(
              log, torch.cat([model.logits(enc[:half], 1, torch.float32),
                              model.logits(enc[half:], 1, torch.float32)]))),
          'logits_equal': bool(torch.equal(log, log_h)),
          'probs_equal': bool(torch.equal(out, out_h)),
          'probs_max': float((out - out_h).abs().max())}), flush=True)


if __name__ == '__main__':
  main()
